// bm25_coarse: the quantized coarse tier of the two-tier text path.
//
// Replaces elasticsearch_tpu/ops/bm25.py:235 `_bm25_coarse_kernel` (body
// `bm25_coarse_body`, ops/bm25.py:139): the bm25_flat gather over the
// plane's bf16 mirrors of block_tfs and doc_lens, the contribution
// computed in bf16 in the body's operation order and accumulated wider,
// then the top-k' candidates (cs, cand) and exact per-segment counts.
//
// What bounds it on the H100: memory. The bf16 mirrors halve the tf and
// doc-length gather bytes against bm25_flat.
//
// Design: bm25_flat_seg's (tiles.cuh) with contrib_bf16 in place of
// contrib_f32 (bm25_common.cuh). The counts are exact because a positive
// bf16 contribution is never rounded to 0 in fixed point, so score > 0
// flags the same docs as the f32 kernels. The plain PyTorch version is
// elasticsearch_tpu_torch/ops/bm25.py `bm25_coarse_plain`.
#include "tiles.cuh"

// The C entry (tiles.cuh ``bm25_launch`` and ``scratch_bytes``).
extern "C" long long bm25_coarse_bytes(
    int which, long long x, long long y, long long z, int k,
    long long n_docs_pad, long long rows) {
    return tiles::scratch_bytes(which, x, y, z, k, n_docs_pad, rows,
                                false);
}

extern "C" int bm25_coarse_launch(
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
    return tiles::bm25_launch<true>(
        phase, block_docs, block_tfs, ranges, doc_lens, flat_idx, flat_w,
        flat_q, flat_avgdl, live, seg_ids, sl, nb, fb, n_docs_pad, n_q, k,
        mode, n_segs, bm25::Consts{k1, omb, b, k1p1}, ws_a, ws_b, b_bytes,
        host, out_s, out_d, hits, split_ms, (cudaStream_t)stream);
}
