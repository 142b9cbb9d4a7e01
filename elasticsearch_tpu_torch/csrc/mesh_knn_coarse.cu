// mesh_knn_coarse: the int8 coarse pass of the quantized kNN tier for
// every shard of a co-located fan-out in one launch.
//
// Replaces elasticsearch_tpu/parallel/mesh.py:433 `mesh_knn_coarse` (a
// shard_map of ops/knn.py `_coarse_plane` + mask + `lax.top_k` over the
// `shard` and `dp` mesh axes): for every slot, knn_coarse (K6) on that
// slot's int8 mirror -- the queries quantized once on the host for all
// slots (qq int8 [Q, D], qscale [Q]) times the slot's mirror q8 [N_pad, D]
// with an int32 sum, rescaled as dots * (qscale * scales), the similarity
// transform with the f32 queries' qn / q2, the mask allowed[s] (and the
// per-query filter rows masks[s, q, :] when a [S, Q, N_pad] stack is
// given), and the top-k' candidates per (slot, query). Outputs: coarse
// scores and candidate plane docs [S, Q, k'].
//
// What bounds it on the H100: memory, K6's bound summed over the slots:
// the int8 stack once (134.2 MB at S 4, N_pad 262,144, D 128) plus scales,
// norms and masks, 0.043 ms at 3.35 TB/s.
//
// Design: knn_tc.cuh's coarse_topk with the slot axis (slots on grid z of
// the int8 wgmma scores pass; the threshold, the list and the final
// selection over the S * Q rows of the contiguous [S, Q, N_pad] plane).
// Integer sums are exact in any order, so each slot's output is bitwise
// K6's on that slot. The plain PyTorch version is
// elasticsearch_tpu_torch/parallel/mesh.py `mesh_knn_coarse_plain`.
#include "knn_tc.cuh"

// Bytes of mesh_knn_coarse_launch's scratch.
extern "C" long long mesh_knn_coarse_scratch(int n_slots, int n_q, int dims,
                                             long long n_docs_pad,
                                             int kprime) {
    return knntc::layout(n_slots, n_q, dims, n_docs_pad, kprime, false)
        .total;
}

// q8: [n_slots, n_docs_pad, dims] int8; scales, norms, allowed:
// [n_slots, n_docs_pad]; masks: [n_slots, n_q, n_docs_pad] or nullptr;
// qq: [n_q, dims] int8; qscale, qn, q2: [n_q]; scratch:
// mesh_knn_coarse_scratch bytes; full: a device counter of the rows
// selected over their whole plane row; out_s / out_d: [n_slots, n_q,
// kprime]; split_ms: as knn_coarse_launch's.
extern "C" int mesh_knn_coarse_launch(
    const int8_t* q8, const float* scales, const float* norms,
    const uint8_t* allowed, const uint8_t* masks, const int8_t* qq,
    const float* qscale, const float* qn, const float* q2, int n_slots,
    int n_q, int dims, long long n_docs_pad, int kprime, int sim,
    void* scratch, unsigned* full, float* out_s, int* out_d,
    float* split_ms, void* stream_ptr) {
    return knntc::coarse_topk(q8, scales, norms, allowed, masks, qq, qscale,
                              qn, q2, n_slots, n_q, dims, n_docs_pad, kprime,
                              sim, scratch, full, out_s, out_d, split_ms,
                              (cudaStream_t)stream_ptr);
}
