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
// top-k; here it also zeroes, scatters into and reads back the
// [n_q, n_docs_pad] int64 accumulator (8.6 GB at 64 queries over a
// 16,777,216-doc plane), which dominates for selective queries, as in
// bm25_flat.
//
// Why the simple design: bm25_flat's, with the rank_features
// contribution (sparse_common.cuh `scored_topk`, entered with ONE_SLOT as
// mesh_sparse_topk enters it with S): one CTA per (gathered block, query),
// one thread per posting, 64-bit fixed-point integer atomics, then
// bm25_common.cuh's chunked mask + count + top-k. Padding positions
// (weight 0) leave at once. A sparse accumulator would move fewer bytes; that is
// later work. The plain PyTorch version is
// elasticsearch_tpu_torch/ops/sparse.py `sparse_flat_plain`.
#include "sparse_common.cuh"

extern "C" int sparse_flat_launch(
    const int* block_docs, const float* block_weights, const int* block_idx,
    const float* query_weight, const uint8_t* live, int qb,
    long long n_docs_pad, int n_q, int k, int counted, int fn, float pivot,
    float exponent, float pivot_pow, long long* acc, float* chunk_s,
    int* chunk_i, float* out_s, int* out_d, int* hits, void* stream) {
    sparse::Params p{fn, pivot, exponent, pivot_pow};
    return sparse::scored_topk<false>(
        block_docs, block_weights, block_idx, query_weight, live, qb,
        n_docs_pad, n_q, k, counted, p, acc, chunk_s, chunk_i, out_s, out_d,
        hits, (cudaStream_t)stream, sparse::ONE_SLOT);
}
