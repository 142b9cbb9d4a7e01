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
// What bounds it on the H100: memory, K16's bound summed over the slots
// (the mirror halves the weight bytes against mesh_sparse_topk), plus the
// fixed cost of each (row, tile) pair.
//
// Design: tiles.cuh (FeaturePolicy, bf16) with the slot axis, one group a
// slot, so each slot's output is bitwise K16's on that slot. The counts
// are exact, as in K16. The plain PyTorch version is
// elasticsearch_tpu_torch/parallel/mesh.py `mesh_sparse_coarse_plain`.
#include "tiles.cuh"

// The C entry (tiles.cuh ``features_launch`` and ``scratch_bytes``).
extern "C" long long mesh_sparse_coarse_bytes(
    int which, long long x, long long y, long long z, int k,
    long long n_docs_pad, long long rows) {
    return tiles::scratch_bytes(which, x, y, z, k, n_docs_pad, rows, true);
}

extern "C" int mesh_sparse_coarse_launch(
    int phase, const int* block_docs, const void* block_weights,
    const int* ranges, const int* block_idx, const float* query_weight,
    const uint8_t* live, int groups, int groups_per_slot, long long nb,
    int qb, long long n_docs_pad, int n_q, int k, int mode, int fn,
    float pivot, float exponent, float pivot_pow, void* ws_a, void* ws_b,
    long long b_bytes, long long* host, float* out_s, int* out_d, int* hits,
    float* split_ms, void* stream) {
    if (groups < 1 || groups_per_slot < 1 || nb < 1)
        return (int)cudaErrorInvalidValue;
    const bm25::Slots sl{groups, groups_per_slot, nb * bm25::BLOCK,
                         n_docs_pad};
    return tiles::features_launch<true>(
        phase, block_docs, block_weights, ranges, block_idx, query_weight,
        live, sl, nb, qb, n_docs_pad, n_q, k, mode,
        sparse::Params{fn, pivot, exponent, pivot_pow}, ws_a, ws_b, b_bytes,
        host, out_s, out_d, hits, split_ms, (cudaStream_t)stream);
}
