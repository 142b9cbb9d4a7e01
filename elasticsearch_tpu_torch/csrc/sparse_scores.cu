// sparse_scores: the dense rank_features score row of one query over one
// segment.
//
// Replaces elasticsearch_tpu/ops/sparse.py:42 `sparse_scores`, with the
// `where(live, s, 0)` of `SparseExecutor.scores` (ops/sparse.py:232)
// fused into its last pass: gather the query's QB blocks, form qw * f(w),
// sum per doc, and write the [n_docs_pad] f32 row, 0 where no posting
// lands (or the doc is dead). The dense collector's rank_feature and
// text_expansion nodes compose these rows (bool, filters) before its
// top-k.
//
// What bounds it on the H100: memory. It must read the gathered blocks
// (8 bytes a posting) and write the f32 row; the [n_docs_pad] int64
// accumulator is zeroed, scattered into and read back besides (3x the
// row's bytes).
//
// Design: sparse_flat's scatter at one query (sparse_common.cuh), so a
// doc's score has sparse_flat's bits for the same blocks, then
// bm25_common.cuh's convert pass to f32 masked by live -- the
// bm25_scores pattern. The plain PyTorch version is
// elasticsearch_tpu_torch/ops/sparse.py `sparse_scores_plain`.
#include "sparse_common.cuh"

// acc: [n_docs_pad] int64 scratch; out: [n_docs_pad] f32; live may be
// null (every doc live).
extern "C" int sparse_scores_launch(
    const int* block_docs, const float* block_weights, const int* block_idx,
    const float* query_weight, const uint8_t* live, int qb,
    long long n_docs_pad, int fn, float pivot, float exponent,
    float pivot_pow, long long* acc, float* out, void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    sparse::Params p{fn, pivot, exponent, pivot_pow};
    int err = sparse::scatter_plane<false>(block_docs, block_weights,
                                           block_idx, query_weight, qb,
                                           n_docs_pad, 1, p, acc, stream);
    if (err != 0) return err;
    return bm25::convert_row(acc, live, n_docs_pad, out, stream);
}
