// sparse_flat: the exact rank_features top-k of Q queries, with an
// optional per-query match count.
//
// Replaces elasticsearch_tpu/ops/sparse.py:72 `sparse_topk_batch` (body
// `sparse_topk_body`, ops/sparse.py:97) and, at one query,
// ops/sparse.py:31 `sparse_topk`: per query, gather the listed blocks,
// form qw * f(w) (saturation, log, sigmoid or linear), sum per doc, mask
// to live docs with score > 0, top-k and, when counted, hits[q] = matches.
//
// What bounds it on the H100: memory. It must read the gathered blocks
// (8 bytes a posting: doc id and weight) and the live mask and write the
// top-k. With many queries over a wide plane the (query, tile) pairs add a
// fixed cost each (64 KB of shared sums zeroed, 8,192 keys masked): rare
// features spread their few postings over every tile, so at 64 queries
// over the 16,777,216-doc plane most of a row's tiles are pairs.
//
// Design: tiles.cuh with its FeaturePolicy. The [Q, QB] block list is the
// pipeline's entry list as it stands (an entry's query is its position
// over QB); each (query, 8,192-doc tile) that a listed block reaches is
// summed in shared memory in 64-bit fixed point (the sum does not depend
// on the order of the adds), masked, counted and reduced to its best
// entries in one CTA, a block spanning tiles read one run of positions a
// tile; a threshold from those entries and one row-batched selection
// (rows_select.cuh, any k) give the top-k, and a rule fills the -inf
// slots. No [Q, n_docs_pad] plane is written. The plain PyTorch version is
// elasticsearch_tpu_torch/ops/sparse.py `sparse_flat_plain`.
#include "tiles.cuh"

// The C entry (tiles.cuh ``features_launch`` and ``scratch_bytes``).
extern "C" long long sparse_flat_bytes(
    int which, long long x, long long y, long long z, int k,
    long long n_docs_pad, long long rows) {
    return tiles::scratch_bytes(which, x, y, z, k, n_docs_pad, rows, true);
}

extern "C" int sparse_flat_launch(
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
