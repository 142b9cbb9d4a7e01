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
// What bounds it on the H100: memory -- the f32 matrix is read once
// (536.9 MB at SIFT1M's 1,048,576 x 128), 0.16 ms at 3.35 TB/s, while the
// product is 2 * B * N_pad * D flops (17.2 GFLOP at B = 64), 0.017 ms in
// bf16 on the tensor cores.
//
// Design: knn_tc.cuh's flat_topk with one slot, a screen and an exact
// re-score (ivf_assign.cu's method carried from argmin to top-k; the proof
// is knn_tc.cuh section 4). bf16 wgmma over the matrix rounded while
// staged gives each dot within a proven bound, so each doc gets a lower
// and an upper bound on its exact score; the epilogue writes the upper
// bounds and each 128-doc tile's largest lower bounds, a row-batched
// radix select takes a threshold tau no higher than the k-th largest
// lower bound, the docs of the tiles that reach tau whose upper bound
// reaches it are re-scored with this kernel's plain arithmetic (f32 FMAs
// over bf16 operands in dimension order), and a second selection takes the
// best k of them. A row the screen cannot decide (fewer than k finite
// lower bounds, or more candidates than the list holds) is scored exactly
// over every doc instead, counted in ``full``. The plain PyTorch version
// is elasticsearch_tpu_torch/ops/knn.py `knn_flat_plain`.
#include "knn_tc.cuh"

// Bytes of knn_flat_launch's scratch.
extern "C" long long knn_flat_scratch(int n_q, int dims, long long n_docs_pad,
                                      int k) {
    return knntc::layout(1, n_q, dims, n_docs_pad, k, true).total;
}

// masks: [n_q, n_docs_pad] per-query filter rows, or nullptr; scratch:
// knn_flat_scratch bytes; full: a device counter of the rows that took
// the exact branch; out_s/out_d: [n_q, k]; probe: nullptr, or [n_q,
// n_docs_pad] f32 for the tensor cores' raw dots; split_ms: nullptr, or 5
// host floats for the stages' milliseconds (the launch then synchronises).
extern "C" int knn_flat_launch(
    const float* matrix, const float* norms, const uint8_t* allowed,
    const uint8_t* masks, const float* queries, const float* qn,
    const float* q2, int n_q, int dims, long long n_docs_pad, int k, int sim,
    void* scratch, unsigned* full, float* out_s, int* out_d, float* probe,
    float* split_ms, void* stream_ptr) {
    return knntc::flat_topk(matrix, norms, allowed, masks, queries, qn, q2, 1,
                            n_q, dims, n_docs_pad, k, sim, scratch, full,
                            out_s, out_d, probe, split_ms,
                            (cudaStream_t)stream_ptr);
}
