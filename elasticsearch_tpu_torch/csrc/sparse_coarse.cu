// sparse_coarse: the bf16 coarse tier of the two-tier rank_features path.
//
// Replaces elasticsearch_tpu/ops/sparse.py:184 `sparse_coarse_kernel`
// (body `sparse_coarse_body`, ops/sparse.py:115): sparse_flat's gather
// (linear) over the plane's bf16 weight mirror, each contribution the
// product of the bf16-rounded query weight and the bf16 doc weight --
// exact in f32, and left unrounded as the JAX program computes it --
// summed wider, then the top-k' candidates (cs, cand) and the exact match
// count per query.
//
// What bounds it on the H100: memory. The mirror halves the weight bytes
// of the gather against sparse_flat; the [n_q, n_docs_pad] accumulator
// and the chunked top-k' pass are the same.
//
// Why the simple design: it is sparse_flat (counted) with the bf16
// contribution (sparse_common.cuh `scored_topk`, entered with ONE_SLOT). The count is exact: a positive
// contribution never rounds to 0 in fixed point, and a positive weight
// stays positive in bf16, so score > 0 flags the same docs as the f32
// kernel. The plain PyTorch version is
// elasticsearch_tpu_torch/ops/sparse.py `sparse_coarse_plain`.
#include "sparse_common.cuh"

extern "C" int sparse_coarse_launch(
    const int* block_docs, const void* block_weights_q, const int* block_idx,
    const float* query_weight, const uint8_t* live, int qb,
    long long n_docs_pad, int n_q, int kprime, long long* acc,
    float* chunk_s, int* chunk_i, float* out_cs, int* out_cand, int* hits,
    void* stream) {
    sparse::Params p{sparse::LINEAR, 1.f, 1.f, 1.f};
    return sparse::scored_topk<true>(
        block_docs, block_weights_q, block_idx, query_weight, live, qb,
        n_docs_pad, n_q, kprime, 1, p, acc, chunk_s, chunk_i, out_cs,
        out_cand, hits, (cudaStream_t)stream, sparse::ONE_SLOT);
}
