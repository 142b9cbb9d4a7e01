// mesh_bm25_coarse: the quantized coarse tier of every shard of a
// co-located fan-out in one launch.
//
// Replaces elasticsearch_tpu/parallel/mesh.py:297 `mesh_bm25_coarse` (a
// shard_map of ops/bm25.py `bm25_coarse_body` over the `shard` mesh
// axis): for every slot, bm25_coarse on that slot's bf16 mirrors --
// [S, NB, 128] bf16 tfs, [S, n_docs_pad] bf16 doc lengths -- with the
// slot's [FB] flat operands (stacked [S, FB]). Outputs: coarse scores and
// candidates [S, n_q, k'], exact per-segment counts [S, n_q, n_segs].
//
// What bounds it on the H100: memory, as bm25_coarse summed over the
// slots: the gathered bf16 blocks and the [S * n_q, n_docs_pad]
// fixed-point accumulator with its chunked top-k' pass.
//
// Why the simple design: bm25_common.cuh's dense pipeline with the slot
// axis (one group a slot) and the bf16 contribution, so each slot's
// output is bitwise bm25_coarse's on that slot, the last quotient left
// unrounded as there. The plain PyTorch version is
// elasticsearch_tpu_torch/parallel/mesh.py `mesh_bm25_coarse_plain`.
#include "bm25_common.cuh"

// k1, omb, b, k1p1 must be bf16-representable (rounded by the caller).
extern "C" int mesh_bm25_coarse_launch(
    const int* block_docs, const void* block_tfs_q, const void* doc_lens_q,
    const int* flat_idx, const float* flat_w, const int* flat_q,
    const float* flat_avgdl, const uint8_t* live, const int* seg_ids,
    int n_slots, long long nb, int fb, long long n_docs_pad, int n_q,
    int n_segs, int kprime, float k1, float omb, float b, float k1p1,
    long long* acc, float* chunk_s, int* chunk_i, float* out_cs,
    int* out_cand, int* hits, void* stream) {
    if (n_slots < 1 || nb < 1) return (int)cudaErrorInvalidValue;
    bm25::Consts c{k1, omb, b, k1p1};
    const bm25::Slots sl{n_slots, 1, nb * bm25::BLOCK, n_docs_pad};
    return bm25::dense_topk<true>(
        block_docs, block_tfs_q, flat_idx, flat_w, flat_q, doc_lens_q,
        flat_avgdl, live, seg_ids, fb, n_docs_pad, n_q, kprime,
        bm25::COUNT_SEGS, n_segs, c, acc, chunk_s, chunk_i, out_cs, out_cand,
        hits, (cudaStream_t)stream, sl);
}
