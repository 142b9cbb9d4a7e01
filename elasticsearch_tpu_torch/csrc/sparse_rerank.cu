// sparse_rerank: the exact tier of the two-tier rank_features path.
//
// Replaces elasticsearch_tpu/ops/sparse.py:193 `sparse_rerank_kernel`
// (body `sparse_rerank_body`, ops/sparse.py:143): sort each row's k'
// coarse candidates by doc id, re-score only them with sparse_flat's f32
// linear contribution, drop every other posting (the JAX program sends
// them to an out-of-range slot, mode="drop"; here they are masked), mask
// to live docs with score > 0, top-k, and eps[q] = max |exact - coarse|
// over the matched candidates with a finite coarse score.
//
// What bounds it on the H100: memory, and far less of it than
// sparse_flat: it reads the same gathered blocks (8 bytes a posting) but
// writes only a [n_q, k'] accumulator.
//
// Why the simple design: bm25_rerank's three kernels with the
// rank_features layout and contribution (sparse_common.cuh `rerank_tier`,
// entered with ONE_SLOT as mesh_sparse_rerank enters it with S). (1) One
// CTA per row bitonic-sorts its candidates (bm25_common.cuh). (2) One CTA
// per (gathered block, query) finds each posting's candidate position by
// binary search in its row's sorted candidates and adds its fixed-point
// contribution there with a 64-bit integer atomic: the same sum, bit for
// bit, that sparse_flat forms for that doc. (3) One CTA per row masks,
// selects the top-k and reduces eps (bm25_common.cuh). The reference's
// [n_docs_pad] position map per query is not needed. The plain PyTorch
// version is elasticsearch_tpu_torch/ops/sparse.py `sparse_rerank_plain`.
#include "sparse_common.cuh"

extern "C" int sparse_rerank_launch(
    const int* block_docs, const float* block_weights, const int* block_idx,
    const float* query_weight, const uint8_t* live, const int* cand,
    const float* coarse_s, int qb, int n_q, int kprime, int k, int* cand_s,
    float* cs_s, long long* acc, float* out_s, int* out_d, float* eps,
    void* stream) {
    return sparse::rerank_tier(block_docs, block_weights, block_idx,
                               query_weight, live, cand, coarse_s, qb, n_q,
                               kprime, k, cand_s, cs_s, acc, out_s, out_d,
                               eps, (cudaStream_t)stream, sparse::ONE_SLOT);
}
