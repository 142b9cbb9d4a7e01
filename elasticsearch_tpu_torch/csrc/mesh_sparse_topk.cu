// mesh_sparse_topk: the exact rank_features top-k of every shard of a
// co-located fan-out, with exact match counts, in one launch.
//
// Replaces elasticsearch_tpu/parallel/mesh.py:523 `mesh_sparse_topk` (a
// shard_map of ops/sparse.py `sparse_topk_body` with linear scoring over
// the `shard` and `dp` mesh axes): for every (slot, dp row) it is
// sparse_flat (K15, counted, linear) on that slot's plane with that row's
// Q queries -- gather the listed blocks, qw * w, sum per doc, mask to the
// slot's live docs with score > 0, top-k, hits = matches. The stacked
// planes are [S, NB, 128] block docs and weights and [S, n_docs_pad] live
// masks; the query operands [S, DP, Q, QB] block ids (local to the slot's
// store) and weights; the outputs [S, DP, Q, k] scores and plane docs and
// [S, DP, Q] counts. Any 1 <= k <= n_docs_pad: one selection for any k.
//
// What bounds it on the H100: memory, K15's bound summed over the slots:
// the gathered blocks (8 bytes a posting) and live masks must be read and
// the top-k written, plus the fixed cost of each (row, tile) pair.
//
// Design: tiles.cuh (FeaturePolicy) with bm25_common.cuh's slot axis:
// group g = (slot, dp row) of the block lists reads slot g / DP's store,
// block ranges and live mask, and owns rows g * Q ...; its (row, tile)
// pairs are binned, summed and selected with every other group's in the
// same launches. Every slot therefore runs K15's arithmetic on its own
// plane, and the 64-bit integer sums make each slot's output bitwise
// K15's on that slot. The plain PyTorch version is
// elasticsearch_tpu_torch/parallel/mesh.py `mesh_sparse_topk_plain`.
#include "tiles.cuh"

// The C entry (tiles.cuh ``features_launch`` and ``scratch_bytes``).
extern "C" long long mesh_sparse_topk_bytes(
    int which, long long x, long long y, long long z, int k,
    long long n_docs_pad, long long rows) {
    return tiles::scratch_bytes(which, x, y, z, k, n_docs_pad, rows, true);
}

extern "C" int mesh_sparse_topk_launch(
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
    return tiles::features_launch<false>(
        phase, block_docs, block_weights, ranges, block_idx, query_weight,
        live, sl, nb, qb, n_docs_pad, n_q, k, mode,
        sparse::Params{fn, pivot, exponent, pivot_pow}, ws_a, ws_b, b_bytes,
        host, out_s, out_d, hits, split_ms, (cudaStream_t)stream);
}
