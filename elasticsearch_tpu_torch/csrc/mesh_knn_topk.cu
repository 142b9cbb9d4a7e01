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
// any k <= N_pad. The stacked planes are [S, N_pad, D] f32 and [S, N_pad]
// norms and allowed masks; the outputs [S, Q, k] scores and plane docs.
//
// What bounds it on the H100: K5's bound summed over the slots. At S 4,
// N_pad 262,144 and D 128 the f32 stack is read once (536.9 MB, 0.160 ms
// at 3.35 TB/s); the product, 2 * Q * S * N_pad * D flops (17.2 GFLOP at
// Q 64), takes 0.017 ms on the tensor cores, so a full stack is bound by
// memory.
//
// Design: knn_tc.cuh's flat_topk with the slot axis: the screen puts the
// slots on grid z, each CTA reading its own slot's tile and writing its own
// rows of the [S, Q, N_pad] bounds, and the selections, the list pass and
// the re-score run over the S * Q rows as they stand. Each slot runs K5's
// arithmetic on its own plane: its output is bitwise K5's there. The plain
// PyTorch version is elasticsearch_tpu_torch/parallel/mesh.py
// `mesh_knn_topk_plain`.
#include "knn_tc.cuh"

// Bytes of mesh_knn_topk_launch's scratch.
extern "C" long long mesh_knn_topk_scratch(int n_slots, int n_q, int dims,
                                           long long n_docs_pad, int k) {
    return knntc::layout(n_slots, n_q, dims, n_docs_pad, k, true).total;
}

// matrix: [n_slots, n_docs_pad, dims]; norms, allowed: [n_slots,
// n_docs_pad]; masks: [n_slots, n_q, n_docs_pad] or nullptr; queries:
// [n_q, dims]; scratch: mesh_knn_topk_scratch bytes; full: a device
// counter of the rows that took the exact branch; out_s / out_d:
// [n_slots, n_q, k]; probe, split_ms: as knn_flat_launch's.
extern "C" int mesh_knn_topk_launch(
    const float* matrix, const float* norms, const uint8_t* allowed,
    const uint8_t* masks, const float* queries, const float* qn,
    const float* q2, int n_slots, int n_q, int dims, long long n_docs_pad,
    int k, int sim, void* scratch, unsigned* full, float* out_s, int* out_d,
    float* probe, float* split_ms, void* stream_ptr) {
    return knntc::flat_topk(matrix, norms, allowed, masks, queries, qn, q2,
                            n_slots, n_q, dims, n_docs_pad, k, sim, scratch,
                            full, out_s, out_d, probe, split_ms,
                            (cudaStream_t)stream_ptr);
}
