// bm25_flat_seg: the exact flat BM25 top-k with per-segment match counts.
//
// Replaces elasticsearch_tpu/ops/bm25.py:299 `_bm25_flat_kernel_seg`: the
// bm25_flat computation, with hits[q, s] = matches of query q among plane
// docs whose seg_ids entry is s (the totals-disabled contract, where each
// segment's count is clipped at the collection window on the host).
//
// What bounds it on the H100: memory, as bm25_flat, plus one 4-byte
// seg_ids read per plane doc in the counting pass.
//
// Why the simple design: the same scatter and chunked top-k as bm25_flat
// (bm25_common.cuh); the count goes to a shared [n_segs] array per CTA.
// Each thread keeps a run of matches in one segment and flushes it with
// one shared atomic when the segment changes, so a contiguous segment
// layout costs a handful of atomics per thread; integer adds keep the
// counts exact in any order. The plain PyTorch version is
// elasticsearch_tpu_torch/ops/bm25.py `bm25_flat_seg_plain`.
#include "bm25_common.cuh"

extern "C" int bm25_flat_seg_launch(
    const int* block_docs, const float* block_tfs, const int* flat_idx,
    const float* flat_w, const int* flat_q, const float* doc_lens,
    const float* flat_avgdl, const uint8_t* live, const int* seg_ids,
    int fb, long long n_docs_pad, int n_q, int k, int n_segs, float k1,
    float omb, float b, float k1p1, long long* acc, float* chunk_s,
    int* chunk_i, float* out_s, int* out_d, int* hits, void* stream) {
    bm25::Consts c{k1, omb, b, k1p1};
    return bm25::dense_topk<false>(
        block_docs, block_tfs, flat_idx, flat_w, flat_q, doc_lens,
        flat_avgdl, live, seg_ids, fb, n_docs_pad, n_q, k, bm25::COUNT_SEGS,
        n_segs, c, acc, chunk_s, chunk_i, out_s, out_d, hits,
        (cudaStream_t)stream);
}
