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
// (8 bytes a posting) and write the f32 row.
//
// Design: tiles.cuh's dense row (section 5) under its FeaturePolicy, K15's
// sums at one query: each gathered block of non-zero query weight is
// listed under the 8,192-doc tiles holding its docs with the run of its
// positions there (a rare feature's block spans many tiles and adds a
// posting or a few to each; a block whose docs are out of order is read
// whole in each), each tile sums qw * f(w) (feature_fn.cuh) in shared
// memory as 64-bit fixed point, so a doc's score has K15's bits for the
// same blocks, and writes its slice of the row once, masked by live. No
// int64 row and no global 64-bit atomic; a call never waits on the host.
// The plain PyTorch version is elasticsearch_tpu_torch/ops/sparse.py
// `sparse_scores_plain`, and `sparse_dense_mirror` runs this algorithm on
// the CPU.
#include "tiles.cuh"

// Scratch bytes of a call (tiles.cuh ``dense_bytes``).
extern "C" long long sparse_scores_bytes(long long qb, long long n_docs_pad) {
    return tiles::dense_bytes(qb, n_docs_pad, true);
}

// ranges: the store's [nb, 2] block doc ranges; live may be null (every
// doc live); ws: sparse_scores_bytes of scratch; out: [n_docs_pad] f32.
extern "C" int sparse_scores_launch(
    const int* block_docs, const float* block_weights, const int* ranges,
    const int* block_idx, const float* query_weight, const uint8_t* live,
    long long nb, int qb, long long n_docs_pad, int fn, float pivot,
    float exponent, float pivot_pow, void* ws, long long* host, float* out,
    float* split_ms, void* stream) {
    tiles::Tiles a{};
    a.block_docs = block_docs;
    a.block_tfs = block_weights;
    a.ranges = ranges;
    a.flat_idx = block_idx;
    a.flat_w = query_weight;
    a.live = live;
    a.nb = nb;
    a.qb = qb;
    a.n_docs_pad = n_docs_pad;
    a.fp = sparse::Params{fn, pivot, exponent, pivot_pow};
    return tiles::dense_run<tiles::FeaturePolicy<false>>(
        a, ws, out, host, split_ms, (cudaStream_t)stream);
}
