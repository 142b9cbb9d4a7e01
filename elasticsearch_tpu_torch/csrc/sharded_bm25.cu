// sharded_bm25: one query's BM25 over a corpus cut round-robin into S
// slots, with the global top-k, in one launch.
//
// Replaces elasticsearch_tpu/parallel/sharded_search.py:240
// `make_sharded_bm25` (a shard_map of `_local_bm25_scores` (:66) and
// `_global_topk_1d` (:134)): block_docs / block_tfs [S, NB, 128], doc_lens
// [S, N], one corpus avgdl, block lists and weights [S, QB] (block ids
// local to the slot's store; block 0 / weight 0 as padding) -> scores [k]
// and mesh-global ids slot * N + local [k], -1 where not finite. A
// posting adds w * tf * (k1 + 1) / (tf + k1 * (1 - b + b * dl / avgdl));
// a doc whose sum is not > 0 scores -inf.
//
// What bounds it on the H100: memory. The gathered blocks must be read
// (8 bytes a posting, plus a doc length) and k pairs written; here the
// [S, N] int64 accumulator is also zeroed, scattered into and read back
// by the selection (S * N * 8 bytes three times: 268 MB at S 8 and N
// 4,194,304), which dominates.
//
// Why the simple design: bm25_common.cuh's scatter (SCALAR: the one
// avgdl), 64-bit fixed point with integer atomics, so the sums are
// rounded once and are order-free; then sharded_common.cuh's one-pass
// selection over the flat mesh-global space. A sparse or tiled
// accumulator fused with the selection would move far fewer bytes; that
// is later work. The plain PyTorch version is
// elasticsearch_tpu_torch/parallel/sharded_search.py `sharded_bm25_plain`.
#include "sharded_common.cuh"

// avgdl: one f32 on the card; acc: [n_slots, n_docs_pad] int64 scratch;
// chunk_s / chunk_i: sharded::select_scratch entries; sel_s / sel_i:
// [min(k, S * N)]; out_s / out_i: [k].
extern "C" int sharded_bm25_launch(
    const int* block_docs, const float* block_tfs, const float* doc_lens,
    const float* avgdl, const int* block_idx, const float* block_w,
    int n_slots, long long nb, int qb, long long n_docs_pad, int k,
    float k1, float omb, float b, float k1p1, long long* acc, float* chunk_s,
    int* chunk_i, float* sel_s, int* sel_i, float* out_s, int* out_i,
    void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    const bm25::Consts c{k1, omb, b, k1p1};
    int rc = sharded::bm25_plane(block_docs, block_tfs, doc_lens, avgdl,
                                 block_idx, block_w, n_slots, nb, qb,
                                 n_docs_pad, 1, c, acc, stream);
    if (rc != 0) return rc;
    const sharded::SelScratch sc{chunk_s, chunk_i, sel_s, sel_i};
    return sharded::global_topk<true, false>(acc, n_slots, n_docs_pad, 1, k,
                                             sc, out_s, out_i, nullptr,
                                             stream);
}
