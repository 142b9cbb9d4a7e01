// knn_flat: exact batched kNN top-k over one vector matrix.
//
// Replaces elasticsearch_tpu/ops/knn.py:101 `knn_topk_batch` and :113
// `knn_topk_batch_masked` (body `knn_topk_body`, ops/knn.py:84): queries
// [B, D] and the matrix [N_pad, D] rounded to bf16, their [B, D] x
// [D, N_pad] product summed in f32, the similarity transform, the mask
// allowed = live & exists, ANDed with the query's own filter row
// masks[b, :] when a [B, N_pad] stack is given (-inf elsewhere), and the
// top-k per query under (score desc, index asc). A masked row therefore
// has the bits of the unmasked kernel run on allowed & masks[b].
//
// What bounds it on the H100: memory at the tensor cores' rate -- the f32
// matrix is read once (536.9 MB at SIFT1M's 1,048,576 x 128), 0.16 ms at
// 3.35 TB/s, while the product is 2 * B * N_pad * D flops (17.2 GFLOP at
// B = 64), 0.017 ms in bf16 on the tensor cores. On the CUDA cores, as
// here, the product itself takes at least 0.26 ms at B = 64 (67 TFLOP/s
// f32), so this kernel is bound by operations; moving the product onto
// the tensor cores (mma.sync / wgmma with TMA) is later work.
//
// Design: knn_common.cuh's flat_topk with one slot. Its scores pass (one
// CTA per tile of 512 docs and group of QB queries, QB = 1 .. 16, f32 sums
// in dimension order, so a row's sums never depend on the batch) writes
// the masked scores into a [B, N_pad] f32 plane (the score plane is
// written, not fused: 4 bytes a cell, 256 MB at B = 64), which
// topk_common.cuh's chunked top-k then reads. The plain PyTorch version is
// elasticsearch_tpu_torch/ops/knn.py `knn_flat_plain`.
#include "knn_common.cuh"

using namespace knn;

// masks: [n_q, n_docs_pad] per-query filter rows, or nullptr; plane:
// [n_q, n_docs_pad] f32 scratch; chunk_s/chunk_i:
// n_q * ceil(n_docs_pad / CHUNK) * min(k, KMAX) entries; out_s/out_d:
// [n_q, k].
extern "C" int knn_flat_launch(
    const float* matrix, const float* norms, const uint8_t* allowed,
    const uint8_t* masks, const float* queries, const float* qn,
    const float* q2, int n_q, int dims, long long n_docs_pad, int k, int sim,
    float* plane,
    float* chunk_s, int* chunk_i, float* out_s, int* out_d, void* stream_ptr) {
    return flat_topk(matrix, norms, allowed, masks, queries, qn, q2, 1, n_q,
                     dims, n_docs_pad, k, sim, plane, chunk_s, chunk_i, out_s,
                     out_d, (cudaStream_t)stream_ptr);
}
