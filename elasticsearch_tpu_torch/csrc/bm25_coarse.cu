// bm25_coarse: the quantized coarse tier of the two-tier text path.
//
// Replaces elasticsearch_tpu/ops/bm25.py:235 `_bm25_coarse_kernel` (body
// `bm25_coarse_body`, ops/bm25.py:139): the bm25_flat gather over the
// plane's bf16 mirrors of block_tfs and doc_lens, the contribution
// computed in bf16 in the body's operation order and accumulated wider,
// then the top-k' candidates (cs, cand) and exact per-segment counts.
//
// What bounds it on the H100: memory. The bf16 mirrors halve the tf and
// doc-length gather bytes against bm25_flat; the [n_q, n_docs_pad]
// accumulator and the chunked top-k' pass are the same.
//
// Why the simple design: it is bm25_flat_seg with contrib_bf16 in place
// of contrib_f32 (bm25_common.cuh). The counts are exact because a
// positive bf16 contribution is never rounded to 0 in fixed point, so
// score > 0 flags the same docs as the f32 kernels. The plain PyTorch
// version is elasticsearch_tpu_torch/ops/bm25.py `bm25_coarse_plain`.
#include "bm25_common.cuh"

// k1, omb, b, k1p1 must be bf16-representable (rounded by the caller).
extern "C" int bm25_coarse_launch(
    const int* block_docs, const void* block_tfs_q, const int* flat_idx,
    const float* flat_w, const int* flat_q, const void* doc_lens_q,
    const float* flat_avgdl, const uint8_t* live, const int* seg_ids,
    int fb, long long n_docs_pad, int n_q, int n_segs, int kprime,
    float k1, float omb, float b, float k1p1, long long* acc,
    float* chunk_s, int* chunk_i, float* out_cs, int* out_cand, int* hits,
    void* stream) {
    bm25::Consts c{k1, omb, b, k1p1};
    return bm25::dense_topk<true>(
        block_docs, block_tfs_q, flat_idx, flat_w, flat_q, doc_lens_q,
        flat_avgdl, live, seg_ids, fb, n_docs_pad, n_q, kprime,
        bm25::COUNT_SEGS, n_segs, c, acc, chunk_s, chunk_i, out_cs, out_cand,
        hits, (cudaStream_t)stream);
}
