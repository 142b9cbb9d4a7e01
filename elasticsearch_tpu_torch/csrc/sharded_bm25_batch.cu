// sharded_bm25_batch: Q queries' BM25 over a corpus cut round-robin into
// S slots, with each query's global top-k in original ids and, counted,
// its match count, in one launch.
//
// Replaces elasticsearch_tpu/parallel/sharded_search.py:265
// `make_sharded_bm25_batch` (a shard_map of `_local_bm25_scores` vmapped
// over the queries, a local top-k per slot, an all_gather over `shard`,
// and a two-key lax.sort by (score descending, original id ascending)):
// the operands of sharded_bm25 with block lists and weights [S, Q, QB] ->
// scores [Q, k], original ids local * S + slot [Q, k] (-1 where not
// finite) and, counted, hits [Q], the docs whose sum is > 0 over every
// slot. This is the program the mesh data plane serves `match` with, in
// two launches a request when pruning pays (a theta pass over the
// P1_BUCKET highest-bound blocks, then the survivors).
//
// What bounds it on the H100: memory, as sharded_bm25: the gathered
// blocks, and here the [S, Q, N] int64 accumulator zeroed, scattered into
// and read back (S * Q * N * 8 bytes three times).
//
// Why the simple design: sharded_bm25's scatter with one group a (slot,
// query) row, then sharded_common.cuh's selection in original-id order:
// the slots interleaved, so the flat index IS the original id and the
// JAX program's tie order needs no second key. The count rides the
// selection's first round. The plain PyTorch version is
// elasticsearch_tpu_torch/parallel/sharded_search.py
// `sharded_bm25_batch_plain`.
#include "sharded_common.cuh"

// acc: [n_slots, n_q, n_docs_pad] int64 scratch; chunk_s / chunk_i:
// sharded::select_scratch entries; sel_s / sel_i: [n_q, min(k, S * N)];
// out_s / out_i: [n_q, k]; hits: [n_q] (read only when counted).
extern "C" int sharded_bm25_batch_launch(
    const int* block_docs, const float* block_tfs, const float* doc_lens,
    const float* avgdl, const int* block_idx, const float* block_w,
    int n_slots, long long nb, int qb, long long n_docs_pad, int n_q, int k,
    int counted, float k1, float omb, float b, float k1p1, long long* acc,
    float* chunk_s, int* chunk_i, float* sel_s, int* sel_i, float* out_s,
    int* out_i, int* hits, void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    const bm25::Consts c{k1, omb, b, k1p1};
    int rc = sharded::bm25_plane(block_docs, block_tfs, doc_lens, avgdl,
                                 block_idx, block_w, n_slots, nb, qb,
                                 n_docs_pad, n_q, c, acc, stream);
    if (rc != 0) return rc;
    const sharded::SelScratch sc{chunk_s, chunk_i, sel_s, sel_i};
    return sharded::global_topk<true, true>(acc, n_slots, n_docs_pad, n_q, k,
                                            sc, out_s, out_i,
                                            counted ? hits : nullptr, stream);
}
