// sparse_coarse: the bf16 coarse tier of the two-tier rank_features path.
//
// Replaces elasticsearch_tpu/ops/sparse.py:184 `sparse_coarse_kernel`
// (body `sparse_coarse_body`, ops/sparse.py:115): sparse_flat's gather
// (linear) over the plane's bf16 weight mirror, each contribution the
// product of the bf16-rounded query weight and the bf16 doc weight --
// exact in f32, and left unrounded as the JAX program computes it --
// summed wider, then the top-k' candidates (cs, cand) and the exact match
// count per query.
//
// What bounds it on the H100: memory. The mirror halves the weight bytes
// of the gather against sparse_flat; at one query (the solo tier) the
// call's one synchronisation (the plan's sizes) and the tiles a query's
// rare features reach add to it.
//
// Design: sparse_flat's (tiles.cuh, FeaturePolicy) with the bf16
// contribution, counted, k' <= 4,096. The count is exact: a positive
// contribution never rounds to 0 in fixed point, and a positive weight
// stays positive in bf16, so score > 0 flags the same docs as the f32
// kernel. The plain PyTorch version is
// elasticsearch_tpu_torch/ops/sparse.py `sparse_coarse_plain`.
#include "tiles.cuh"

// The C entry (tiles.cuh ``features_launch`` and ``scratch_bytes``).
extern "C" long long sparse_coarse_bytes(
    int which, long long x, long long y, long long z, int k,
    long long n_docs_pad, long long rows) {
    return tiles::scratch_bytes(which, x, y, z, k, n_docs_pad, rows, true);
}

extern "C" int sparse_coarse_launch(
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
