// mesh_bm25_rerank: the exact tier of every shard of a co-located fan-out
// in one launch.
//
// Replaces elasticsearch_tpu/parallel/mesh.py:335 `mesh_bm25_rerank` (a
// shard_map of ops/bm25.py `bm25_rerank_body` over the `shard` mesh
// axis): for every slot, bm25_rerank on that slot's f32 plane ([S, NB,
// 128] tfs, [S, n_docs_pad] doc lengths and live mask) with the slot's
// flat operands ([S, FB]) and coarse candidates ([S, n_q, k']). Outputs:
// scores and plane docs [S, n_q, k], eps [S, n_q].
//
// What bounds it on the H100: memory, as bm25_rerank summed over the
// slots: the gathered f32 blocks, and a [S * n_q, k'] accumulator.
//
// Why the simple design: bm25_common.cuh's `rerank_tier` with the slot
// axis: the candidate sort and the selection run over all S * n_q rows,
// the candidate scatter's grid is (FB, S) with each slot reading its own
// store. Each slot's output is bitwise bm25_rerank's on that slot. The
// plain PyTorch version is elasticsearch_tpu_torch/parallel/mesh.py
// `mesh_bm25_rerank_plain`.
#include "bm25_common.cuh"

extern "C" int mesh_bm25_rerank_launch(
    const int* block_docs, const float* block_tfs, const int* flat_idx,
    const float* flat_w, const int* flat_q, const float* flat_avgdl,
    const float* doc_lens, const uint8_t* live, const int* cand,
    const float* coarse_s, int n_slots, long long nb, int fb,
    long long n_docs_pad, int n_q, int kprime, int k, float k1, float omb,
    float b, float k1p1, int* cand_s, float* cs_s, long long* acc,
    float* out_s, int* out_d, float* eps, void* stream) {
    if (n_slots < 1 || nb < 1) return (int)cudaErrorInvalidValue;
    bm25::Consts c{k1, omb, b, k1p1};
    const bm25::Slots sl{n_slots, 1, nb * bm25::BLOCK, n_docs_pad};
    return bm25::rerank_tier(block_docs, block_tfs, flat_idx, flat_w, flat_q,
                             doc_lens, flat_avgdl, live, cand, coarse_s, fb,
                             n_q, kprime, k, c, cand_s, cs_s, acc, out_s,
                             out_d, eps, (cudaStream_t)stream, sl);
}
