// mesh_knn_topk: the exact kNN top-k of every shard of a co-located
// fan-out in one launch.
//
// Replaces elasticsearch_tpu/parallel/mesh.py:564 `mesh_knn_topk` (a
// shard_map of ops/knn.py `knn_topk_body` over the `shard` and `dp` mesh
// axes): for every slot, knn_flat (K5) on that slot's plane -- the
// queries [Q, D] and the slot's matrix rounded to bf16, f32 sums in
// dimension order, the similarity transform, the mask allowed[s] (live &
// exists, with a filter every member shares folded in), ANDed with the
// per-query filter rows masks[s, q, :] when a [S, Q, N_pad] stack is
// given, and the top-k per (slot, query) under (score desc, index asc),
// the selection's rounds above KMAX included. The stacked planes are
// [S, N_pad, D] f32 and [S, N_pad] norms and allowed masks; the outputs
// [S, Q, k] scores and plane docs.
//
// What bounds it on the H100: K5's bound summed over the slots. At S 4,
// N_pad 262,144 and D 128 the f32 stack is read once (536.9 MB, 0.160 ms
// at 3.35 TB/s); the product, 2 * Q * S * N_pad * D flops (17.2 GFLOP at
// Q 64), takes 0.017 ms on the tensor cores, so a full stack is bound by
// memory. On the CUDA cores, as here, the product itself takes at least
// 0.26 ms at Q 64 (67 TFLOP/s f32); moving it onto the tensor cores is
// later work.
//
// Why the simple design: knn_common.cuh's flat_topk with the slot axis.
// The scores pass puts the slots on grid z, each CTA reading its own
// slot's tile and writing its own rows of the [S, Q, N_pad] f32 plane,
// which is contiguous, so topk_common.cuh's plane_topk selects over its
// S * Q rows as they stand. Each slot runs K5's arithmetic on its own
// plane: its output is bitwise K5's there. The plain PyTorch version is
// elasticsearch_tpu_torch/parallel/mesh.py `mesh_knn_topk_plain`.
#include "knn_common.cuh"

using namespace knn;

// matrix: [n_slots, n_docs_pad, dims]; norms, allowed: [n_slots,
// n_docs_pad]; masks: [n_slots, n_q, n_docs_pad] or nullptr; queries:
// [n_q, dims]; plane: [n_slots, n_q, n_docs_pad] f32 scratch; chunk_s /
// chunk_i: n_slots * n_q * ceil(n_docs_pad / CHUNK) * min(k, KMAX)
// entries; out_s / out_d: [n_slots, n_q, k].
extern "C" int mesh_knn_topk_launch(
    const float* matrix, const float* norms, const uint8_t* allowed,
    const uint8_t* masks, const float* queries, const float* qn,
    const float* q2, int n_slots, int n_q, int dims, long long n_docs_pad,
    int k, int sim, float* plane, float* chunk_s, int* chunk_i, float* out_s,
    int* out_d, void* stream_ptr) {
    return flat_topk(matrix, norms, allowed, masks, queries, qn, q2, n_slots,
                     n_q, dims, n_docs_pad, k, sim, plane, chunk_s, chunk_i,
                     out_s, out_d, (cudaStream_t)stream_ptr);
}
