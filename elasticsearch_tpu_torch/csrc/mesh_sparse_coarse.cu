// mesh_sparse_coarse: the bf16 coarse tier of every shard of a
// co-located fan-out in one launch.
//
// Replaces elasticsearch_tpu/parallel/mesh.py:373 `mesh_sparse_coarse` (a
// shard_map of ops/sparse.py `sparse_coarse_body` over the `shard` mesh
// axis): for every slot, sparse_coarse (K16) on that slot's bf16 weight
// mirror -- [S, NB, 128] bf16 beside the [S, NB, 128] block docs -- with
// the slot's [Q, QB] block lists and weights (stacked [S, Q, QB]): each
// contribution f32(bf16(qw)) * f32(w_bf16), exact in f32 and left
// unrounded, summed wider, then the top-k' candidates and the exact match
// count per (slot, query). Outputs: coarse scores and candidates
// [S, Q, k'], counts [S, Q].
//
// What bounds it on the H100: memory, K16's bound summed over the slots:
// the mirror halves the weight bytes of the gather against
// mesh_sparse_topk; the [S * Q, n_docs_pad] accumulator and the chunked
// top-k' pass are the same and dominate.
//
// Why the simple design: sparse_common.cuh's `scored_topk` with the slot
// axis (one group a slot) and the bf16 contribution, so each slot's output
// is bitwise K16's on that slot. The counts are exact, as in K16. The
// plain PyTorch version is elasticsearch_tpu_torch/parallel/mesh.py
// `mesh_sparse_coarse_plain`.
#include "sparse_common.cuh"

extern "C" int mesh_sparse_coarse_launch(
    const int* block_docs, const void* block_weights_q, const int* block_idx,
    const float* query_weight, const uint8_t* live, int n_slots, long long nb,
    int qb, long long n_docs_pad, int n_q, int kprime, long long* acc,
    float* chunk_s, int* chunk_i, float* out_cs, int* out_cand, int* hits,
    void* stream) {
    if (n_slots < 1 || nb < 1) return (int)cudaErrorInvalidValue;
    const sparse::Params p{sparse::LINEAR, 1.f, 1.f, 1.f};
    const sparse::Slots sl{n_slots, 1, nb * sparse::BLOCK, n_docs_pad};
    return sparse::scored_topk<true>(
        block_docs, block_weights_q, block_idx, query_weight, live, qb,
        n_docs_pad, n_q, kprime, 1, p, acc, chunk_s, chunk_i, out_cs,
        out_cand, hits, (cudaStream_t)stream, sl);
}
