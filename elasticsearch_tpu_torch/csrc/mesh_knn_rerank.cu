// mesh_knn_rerank: the exact re-rank of the quantized kNN tier for every
// shard of a co-located fan-out in one launch.
//
// Replaces elasticsearch_tpu/parallel/mesh.py:479 `mesh_knn_rerank` (a
// shard_map of ops/knn.py `knn_rerank_body` over the `shard` and `dp`
// mesh axes): for every (slot, query) row, knn_rerank (K7) on that slot's
// f32 plane -- the row's k' coarse candidates sorted by doc id, scored
// exactly with knn_flat's arithmetic, masked to allowed[s] (and to
// masks[s, q, cand] with a [S, Q, N_pad] filter stack), the top-k with
// doc -1 where the score is -inf, and eps = max |exact - coarse|. Inputs:
// the [S, N_pad, D] f32 stack, [S, N_pad] norms and allowed masks, the
// queries [Q, D], candidates and coarse scores [S, Q, k']. Outputs:
// scores and plane docs [S, Q, k], eps [S, Q].
//
// What bounds it on the H100: memory, and little of it: K7's bound summed
// over the slots, the S * Q * k' gathered rows (S * Q * k' * D * 4 bytes,
// 2 MB for a solo query on 4 slots at k' 1,024 and D 128).
//
// Why the simple design: knn_common.cuh's rerank_topk with the slot axis:
// one CTA per output row r = slot * Q + q, reading its slot's matrix,
// norms and masks at slot-strided offsets. Each slot's output is bitwise
// K7's on that slot. The plain PyTorch version is
// elasticsearch_tpu_torch/parallel/mesh.py `mesh_knn_rerank_plain`.
#include "knn_common.cuh"

using namespace knn;

// matrix: [n_slots, n_docs_pad, dims]; norms, allowed: [n_slots,
// n_docs_pad]; masks: [n_slots, n_q, n_docs_pad] or nullptr; queries:
// [n_q, dims]; cand, coarse_s: [n_slots, n_q, kprime]; out_s / out_d:
// [n_slots, n_q, k]; eps: [n_slots, n_q].
extern "C" int mesh_knn_rerank_launch(
    const float* matrix, const float* norms, const uint8_t* allowed,
    const uint8_t* masks, const float* queries, const float* qn,
    const float* q2, const int* cand, const float* coarse_s, int n_slots,
    int n_q, long long n_docs_pad, int dims, int kprime, int k, int sim,
    float* out_s, int* out_d, float* eps, void* stream_ptr) {
    return rerank_topk(matrix, norms, allowed, masks, queries, qn, q2, cand,
                       coarse_s, n_slots, n_q, n_docs_pad, dims, kprime, k,
                       sim, out_s, out_d, eps, (cudaStream_t)stream_ptr);
}
