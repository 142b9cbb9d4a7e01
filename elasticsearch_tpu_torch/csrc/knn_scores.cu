// knn_scores: one query's dense similarity row over one vector matrix.
//
// Replaces elasticsearch_tpu/ops/knn.py:33 `vector_scores`: the query [D]
// and the matrix [N_pad, D] rounded to bf16, each doc's dot product summed
// in f32, the similarity transform, and 0 where the doc has no vector
// (exists false; not -inf: the row is a score plane that a caller masks,
// as `script_score` and `KnnExecutor.scores` do).
//
// What bounds it on the H100: memory. It reads the f32 matrix once
// (134 MB at 262,144 x 128: 0.040 ms at 3.35 TB/s) and does 2 * N_pad * D
// flops (67 MFLOP: 0.001 ms even on the CUDA cores at 67 TFLOP/s), half a
// flop a byte.
//
// Design: knn_stream.cuh's streaming pass at one query with the dense
// epilogue: persistent CTAs, TMA copies of 256-row tiles (a 2-D tensor
// map with the 128-byte swizzle, so no bank conflicts; cp.async for rows
// that are not 16-byte aligned) into a three-stage ring in shared memory,
// a thread a doc adding its products in dimension order while the next
// tiles are in flight; the same per-pair arithmetic as knn_flat (K5) --
// bf16 operands, f32 sums in dimension order, the shared similarity
// transform with the once-rounded l2 norm * norm + q2 -- so a doc's score
// has K5's bits before K5 masks it. No top-k. The plain PyTorch version
// is elasticsearch_tpu_torch/ops/knn.py `vector_scores_plain`.
#include "knn_stream.cuh"

using namespace knn;

// out: [n_docs_pad] f32; qn/q2: the query's norm terms, [1] f32.
extern "C" int knn_scores_launch(
    const float* matrix, const float* norms, const uint8_t* exists,
    const float* query, const float* qn, const float* q2, int dims,
    long long n_docs_pad, int sim, float* out, void* stream_ptr) {
    return kstream::scores<true>(matrix, norms, exists, query, qn, q2, 1,
                                 dims, n_docs_pad, sim, out,
                                 (cudaStream_t)stream_ptr);
}
