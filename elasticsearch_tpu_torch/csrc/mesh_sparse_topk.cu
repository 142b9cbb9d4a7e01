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
// [S, DP, Q] counts. Any 1 <= k <= n_docs_pad: windows above 4,096 take
// topk_common.cuh's rounds, as in K15.
//
// What bounds it on the H100: memory, K15's bound summed over the slots:
// the gathered blocks (8 bytes a posting) and live masks must be read and
// the top-k written; here the [S * DP * Q, n_docs_pad] int64 accumulator
// is also zeroed, scattered into and read back by the chunked selection
// (2.1 GB at S 4, Q 16 and n_docs_pad 4,194,304), which dominates.
//
// Why the simple design: sparse_common.cuh's `scored_topk` with the slot
// axis, the design mesh_bm25_flat documents. The scatter's grid is (QB,
// S * DP * Q rows); each row reads its own slot's store (slot * NB * 128
// elements in) and writes a row of its own, and 64-bit fixed-point integer
// atomics make every sum independent of the order they land. The
// selection's grid covers all rows, each masking and counting with its
// slot's live row. Each slot's output is therefore bitwise K15's on that
// slot's plane. A sparse or tiled accumulator would move far fewer bytes;
// that is later work. The plain PyTorch version is
// elasticsearch_tpu_torch/parallel/mesh.py `mesh_sparse_topk_plain`.
#include "sparse_common.cuh"

// chunk_s / chunk_i: S * DP * Q * ceil(n_docs_pad / CHUNK) * min(k, KMAX)
// entries; acc: [S * DP * Q, n_docs_pad] int64 scratch.
extern "C" int mesh_sparse_topk_launch(
    const int* block_docs, const float* block_weights, const int* block_idx,
    const float* query_weight, const uint8_t* live, int n_slots, int dp,
    long long nb, int qb, long long n_docs_pad, int n_q, int k,
    long long* acc, float* chunk_s, int* chunk_i, float* out_s, int* out_d,
    int* hits, void* stream) {
    if (n_slots < 1 || dp < 1 || nb < 1) return (int)cudaErrorInvalidValue;
    const sparse::Params p{sparse::LINEAR, 1.f, 1.f, 1.f};
    const sparse::Slots sl{n_slots * dp, dp, nb * sparse::BLOCK, n_docs_pad};
    return sparse::scored_topk<false>(
        block_docs, block_weights, block_idx, query_weight, live, qb,
        n_docs_pad, n_q, k, 1, p, acc, chunk_s, chunk_i, out_s, out_d, hits,
        (cudaStream_t)stream, sl);
}
