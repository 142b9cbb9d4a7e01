// sharded_knn: exact kNN over a corpus cut round-robin into S slots, with
// the global top-k, in one launch.
//
// Replaces elasticsearch_tpu/parallel/sharded_search.py:151
// `make_sharded_knn` (a shard_map of `_local_knn_scores` (:84), a local
// lax.top_k per slot, an all_gather of the S winner lists over `shard`
// and a global lax.top_k): matrix [S, N, D] f32, norms / valid [S, N],
// queries [B, D] -> scores [B, k] and mesh-global ids slot * N + local
// [B, k], -1 where the score is not finite. cosine and dot_product dot
// bf16-rounded operands with f32 sums in dimension order (K5's
// arithmetic), l2_norm f32 operands, each product rounded before it is
// added; a slot row without a vector scores -inf.
//
// What bounds it on the H100: memory. The f32 matrix is read once (S * N
// * D * 4 bytes: 512 MB for SIFT1M's 1,000,000 x 128 at S 8, 0.153 ms at
// 3.35 TB/s); the product, 2 * B * S * N * D flops, is small at the
// served B 1. Here the [S, B, N] f32 score plane is also written and read
// back by the selection (B * S * N * 8 bytes).
//
// Why the simple design: knn_common.cuh's scores pass with its slot axis
// on grid z writes the [S, B, N] plane, and sharded_common.cuh selects
// each query's top-k over the flat [S * N] mesh-global space in one pass
// (why that equals the JAX program's two-level selection is set out
// there). The plain PyTorch version is
// elasticsearch_tpu_torch/parallel/sharded_search.py `sharded_knn_plain`.
#include "sharded_common.cuh"
#include "sharded_scores.cuh"

// plane: [n_slots, n_q, n_docs_pad] f32 scratch; chunk_s / chunk_i:
// sharded::select_scratch entries; sel_s / sel_i: [n_q, min(k, S * N)];
// out_s / out_i: [n_q, k].
extern "C" int sharded_knn_launch(
    const float* matrix, const float* norms, const uint8_t* valid,
    const float* queries, const float* qn, const float* q2, int n_slots,
    int n_q, int dims, long long n_docs_pad, int k, int sim, float* plane,
    float* chunk_s, int* chunk_i, float* sel_s, int* sel_i, float* out_s,
    int* out_i, void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    int rc = knn::sharded_scores(matrix, norms, valid, queries, qn, q2,
                                n_slots, n_q, dims, n_docs_pad, sim, plane,
                                stream);
    if (rc != 0) return rc;
    const sharded::SelScratch sc{chunk_s, chunk_i, sel_s, sel_i};
    return sharded::global_topk<false, false>(plane, n_slots, n_docs_pad,
                                              n_q, k, sc, out_s, out_i,
                                              nullptr, stream);
}
