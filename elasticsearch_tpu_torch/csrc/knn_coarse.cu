// knn_coarse: the int8 coarse pass of the quantized kNN tier.
//
// Replaces elasticsearch_tpu/ops/knn.py:184 `knn_coarse_candidates` and
// :199 `knn_coarse_candidates_masked` (body `_coarse_plane`,
// ops/knn.py:169): the queries, quantized per row to symmetric int8 on
// the host (qq, qscale), times the plane's int8 mirror q8 [N_pad, D] with
// an int32 sum, rescaled as dots * (qscale * scales), then the similarity
// transform with the f32 queries' qn / q2, the mask allowed = live &
// exists (ANDed with the query's filter row masks[b, :] when a [B, N_pad]
// stack is given), and the top-k' candidates (coarse scores, doc ids) per
// query under (score desc, index asc).
//
// What bounds it on the H100: memory. It reads the int8 mirror once
// (134.2 MB at 1,048,576 x 128) plus scales, norms and the mask: 0.043 ms
// at 3.35 TB/s. The product is 2 * B * N_pad * D integer operations, 17.2
// GOP at B = 64, 0.009 ms on the tensor cores at 1,979 TOPS.
//
// Design: knn_tc.cuh's coarse_topk with one slot. int8 wgmma (m64nNk32,
// docs on M, the queries on N padded to 8 .. 64) over the mirror staged by
// cp.async in the 128-byte swizzle; the sums are exact, so the epilogue
// (convert once, rescale, transform, mask) gives the plain version's bits.
// The epilogue writes the [B, N_pad] f32 plane and each 128-doc tile's
// largest scores; a row-batched radix select (rows_select.cuh) takes a
// threshold from the tile tops, only the tiles that reach it are listed,
// and a second selection takes the best k' of the list (or of the whole
// row where the list cannot hold it). The plain PyTorch version is
// elasticsearch_tpu_torch/ops/knn.py `knn_coarse_plain`.
#include "knn_tc.cuh"

// Bytes of knn_coarse_launch's scratch.
extern "C" long long knn_coarse_scratch(int n_q, int dims,
                                        long long n_docs_pad, int kprime) {
    return knntc::layout(1, n_q, dims, n_docs_pad, kprime, false).total;
}

// masks: [n_q, n_docs_pad] per-query filter rows, or nullptr; scratch:
// knn_coarse_scratch bytes; full: a device counter of the rows selected
// over their whole plane row; out_s/out_d: [n_q, kprime]; split_ms:
// nullptr, or 5 host floats for the stages' milliseconds (the launch then
// synchronises).
extern "C" int knn_coarse_launch(
    const int8_t* q8, const float* scales, const float* norms,
    const uint8_t* allowed, const uint8_t* masks, const int8_t* qq,
    const float* qscale, const float* qn, const float* q2, int n_q, int dims,
    long long n_docs_pad, int kprime, int sim, void* scratch,
    unsigned* full, float* out_s, int* out_d, float* split_ms,
    void* stream_ptr) {
    return knntc::coarse_topk(q8, scales, norms, allowed, masks, qq, qscale,
                              qn, q2, 1, n_q, dims, n_docs_pad, kprime, sim,
                              scratch, full, out_s, out_d, split_ms,
                              (cudaStream_t)stream_ptr);
}
