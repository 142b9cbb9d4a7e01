// knn_rerank: the exact re-rank of the quantized kNN tier.
//
// Replaces elasticsearch_tpu/ops/knn.py:261 `knn_rerank_exact` and :274
// `knn_rerank_exact_masked` (body `knn_rerank_body`, ops/knn.py:230):
// sort each row's k' coarse candidates by doc id (carrying their coarse
// scores), score each exactly with knn_flat's arithmetic (bf16 operands,
// f32 sums in dim order, the same transform), mask to allowed docs (and,
// with a [B, N_pad] filter stack, to masks[b, cand] -- the JAX body's
// take_along_axis(masks, cand_s)), take the top-k under (score
// desc, position asc) -- after the sort, position order is doc-id order,
// so a tie resolves to the lower doc exactly as in knn_flat -- with doc
// id -1 where the score is -inf, and eps = max |exact - coarse| over the
// candidates that are allowed and whose coarse score is finite (0 when
// there are none).
//
// What bounds it on the H100: memory, and little of it: the k' gathered
// rows (B * k' * D * 4 bytes, 0.5 MB for a solo query at k' = 1024,
// D = 128), microseconds.
//
// Design: knn_common.cuh's rerank_topk with one slot: one CTA per query
// row (k' <= KMAX). The row's candidates are bitonic-sorted by id in
// shared memory, the bf16-rounded query sits in shared memory, and each
// thread scores whole candidates, reading the candidate's row in dim order
// while the warp reads the same query dim (a broadcast). The top-k is
// topk_common.cuh's cta_select over the candidates' positions. The plain
// PyTorch version is elasticsearch_tpu_torch/ops/knn.py `knn_rerank_plain`.
#include "knn_common.cuh"

using namespace knn;

// masks: [n_q, n_docs_pad] per-query filter rows, or nullptr; cand,
// coarse_s: [n_q, kprime]; out_s/out_d: [n_q, k]; eps: [n_q].
extern "C" int knn_rerank_launch(
    const float* matrix, const float* norms, const uint8_t* allowed,
    const uint8_t* masks, const float* queries, const float* qn,
    const float* q2, const int* cand, const float* coarse_s, int n_q,
    long long n_docs_pad, int dims, int kprime, int k, int sim,
    float* out_s, int* out_d, float* eps, void* stream_ptr) {
    return rerank_topk(matrix, norms, allowed, masks, queries, qn, q2, cand,
                       coarse_s, 1, n_q, n_docs_pad, dims, kprime, k, sim,
                       out_s, out_d, eps, (cudaStream_t)stream_ptr);
}
