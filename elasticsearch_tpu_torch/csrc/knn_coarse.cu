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
// at 3.35 TB/s. The product is 2 * B * N_pad * D integer operations, at
// B = 1 (the solo queries this tier serves) a few hundred MOP.
//
// Design: knn_common.cuh's coarse_topk with one slot: knn_flat's tiling
// over packed int8 (a CTA scores 512 docs against QB queries, staging 32
// dims at a time as 8 words of 4 packed int8 values; __dp4a adds four
// products at a time to int32 sums). Integer sums are exact in any order,
// so kernel and plain version agree bit for bit. The epilogue converts
// once (round to nearest), rescales, transforms and masks into a [B, N_pad]
// f32 plane, and topk_common.cuh's chunked top-k selects k'. The plain
// PyTorch version is elasticsearch_tpu_torch/ops/knn.py `knn_coarse_plain`.
#include "knn_common.cuh"

using namespace knn;

// masks: [n_q, n_docs_pad] per-query filter rows, or nullptr; plane:
// [n_q, n_docs_pad] f32 scratch; chunk_s/chunk_i: n_q *
// ceil(n_docs_pad / CHUNK) * kprime entries; out_s/out_d: [n_q, kprime].
extern "C" int knn_coarse_launch(
    const int8_t* q8, const float* scales, const float* norms,
    const uint8_t* allowed, const uint8_t* masks, const int8_t* qq,
    const float* qscale, const float* qn, const float* q2, int n_q, int dims,
    long long n_docs_pad,
    int kprime, int sim, float* plane, float* chunk_s, int* chunk_i,
    float* out_s, int* out_d, void* stream_ptr) {
    return coarse_topk(q8, scales, norms, allowed, masks, qq, qscale, qn, q2,
                       1, n_q, dims, n_docs_pad, kprime, sim, plane, chunk_s,
                       chunk_i, out_s, out_d, (cudaStream_t)stream_ptr);
}
