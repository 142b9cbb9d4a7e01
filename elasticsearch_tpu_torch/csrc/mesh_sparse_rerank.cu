// mesh_sparse_rerank: the exact tier of the rank_features path for every
// shard of a co-located fan-out in one launch.
//
// Replaces elasticsearch_tpu/parallel/mesh.py:403 `mesh_sparse_rerank` (a
// shard_map of ops/sparse.py `sparse_rerank_body` over the `shard` mesh
// axis): for every slot, sparse_rerank (K17) on that slot's f32 plane
// ([S, NB, 128] block docs and weights, [S, n_docs_pad] live mask) with
// the slot's [Q, QB] block lists and weights and its coarse candidates and
// scores ([S, Q, k']): the exact f32 re-score of the candidates, top-k,
// and eps = the largest |exact - coarse| over the matched candidates with
// a finite coarse score. Outputs: scores and plane docs [S, Q, k], eps
// [S, Q].
//
// What bounds it on the H100: memory, K17's bound summed over the slots,
// and far less of it than mesh_sparse_topk: the same gathered f32 blocks
// are read, but only an [S * Q, k'] accumulator is written.
//
// Why the simple design: sparse_common.cuh's `rerank_tier` with the slot
// axis: the candidate sort and the mask + top-k + eps pass run over all
// S * Q rows, and the re-scoring grid (QB, S * Q rows) reads each row's
// own slot store. Each slot's output is bitwise K17's on that slot. The
// plain PyTorch version is elasticsearch_tpu_torch/parallel/mesh.py
// `mesh_sparse_rerank_plain`.
#include "sparse_common.cuh"

extern "C" int mesh_sparse_rerank_launch(
    const int* block_docs, const float* block_weights, const int* block_idx,
    const float* query_weight, const uint8_t* live, const int* cand,
    const float* coarse_s, int n_slots, long long nb, int qb,
    long long n_docs_pad, int n_q, int kprime, int k, int* cand_s,
    float* cs_s, long long* acc, float* out_s, int* out_d, float* eps,
    void* stream) {
    if (n_slots < 1 || nb < 1) return (int)cudaErrorInvalidValue;
    const sparse::Slots sl{n_slots, 1, nb * sparse::BLOCK, n_docs_pad};
    return sparse::rerank_tier(block_docs, block_weights, block_idx,
                               query_weight, live, cand, coarse_s, qb, n_q,
                               kprime, k, cand_s, cs_s, acc, out_s, out_d,
                               eps, (cudaStream_t)stream, sl);
}
