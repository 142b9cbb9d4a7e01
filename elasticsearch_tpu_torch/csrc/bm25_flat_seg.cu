// bm25_flat_seg: the exact flat BM25 top-k with per-segment match counts.
//
// Replaces elasticsearch_tpu/ops/bm25.py:299 `_bm25_flat_kernel_seg`: the
// bm25_flat computation, with hits[q, s] = matches of query q among plane
// docs whose seg_ids entry is s (the totals-disabled contract, where each
// segment's count is clipped at the collection window on the host).
//
// What bounds it on the H100: memory, as bm25_flat, plus the seg_ids of
// the matched docs.
//
// Design: bm25_flat's (tiles.cuh) with the count per segment: each
// tile CTA counts its matches in a shared [n_segs] array (a run of
// matches in one segment costs one shared atomic) and adds its non-zero
// counts to the row's. Integer adds keep the counts exact in any order.
// The plain PyTorch version is elasticsearch_tpu_torch/ops/bm25.py
// `bm25_flat_seg_plain`.
#include "tiles.cuh"

// The C entry (tiles.cuh ``bm25_launch`` and ``scratch_bytes``).
extern "C" long long bm25_flat_seg_bytes(
    int which, long long x, long long y, long long z, int k,
    long long n_docs_pad, long long rows) {
    return tiles::scratch_bytes(which, x, y, z, k, n_docs_pad, rows,
                                false);
}

extern "C" int bm25_flat_seg_launch(
    int phase, const int* block_docs, const void* block_tfs,
    const int* ranges, const void* doc_lens, const int* flat_idx,
    const float* flat_w, const int* flat_q, const float* flat_avgdl,
    const uint8_t* live, const int* seg_ids, int groups,
    int groups_per_slot, long long nb, int fb, long long n_docs_pad, int n_q,
    int k, int mode, int n_segs, float k1, float omb, float b, float k1p1,
    void* ws_a, void* ws_b, long long b_bytes, long long* host,
    float* out_s, int* out_d, int* hits, float* split_ms, void* stream) {
    if (groups < 1 || groups_per_slot < 1 || nb < 1)
        return (int)cudaErrorInvalidValue;
    const bm25::Slots sl{groups, groups_per_slot, nb * bm25::BLOCK,
                         n_docs_pad};
    return tiles::bm25_launch<false>(
        phase, block_docs, block_tfs, ranges, doc_lens, flat_idx, flat_w,
        flat_q, flat_avgdl, live, seg_ids, sl, nb, fb, n_docs_pad, n_q, k,
        mode, n_segs, bm25::Consts{k1, omb, b, k1p1}, ws_a, ws_b, b_bytes,
        host, out_s, out_d, hits, split_ms, (cudaStream_t)stream);
}
