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
// rank_features layout and contribution. (1) One CTA per row
// bitonic-sorts its candidates (bm25_common.cuh). (2) One CTA per
// (gathered block, query) finds each posting's slot by binary search in
// its row's sorted candidates and adds its fixed-point contribution there
// with a 64-bit integer atomic: the same sum, bit for bit, that
// sparse_flat forms for that doc. (3) One CTA per row masks, selects the
// top-k and reduces eps (bm25_common.cuh). The reference's
// [n_docs_pad] slot map per query is not needed. The plain PyTorch
// version is elasticsearch_tpu_torch/ops/sparse.py `sparse_rerank_plain`.
#include "sparse_common.cuh"

using namespace bm25;

namespace {

// grid (qb, n_q), BLOCK threads: candidate postings add their
// contribution at their candidate's slot; all others are dropped.
__global__ void rescore_kernel(const int* __restrict__ block_docs,
                               const float* __restrict__ block_weights,
                               const int* __restrict__ block_idx,
                               const float* __restrict__ query_weight,
                               const int* __restrict__ cand_s, int kprime,
                               unsigned long long* __restrict__ acc) {
    const long long slot = (long long)blockIdx.y * gridDim.x + blockIdx.x;
    const float qw = query_weight[slot];
    if (qw == 0.f) return;
    const long long e = (long long)block_idx[slot] * BLOCK + threadIdx.x;
    const int doc = block_docs[e];
    if (doc < 0) return;
    const long long row = (long long)blockIdx.y * kprime;
    const int at = candidate_slot(cand_s + row, kprime, doc);
    if (at < 0) return;
    const long long fx = to_fixed(__fmul_rn(qw, block_weights[e]));
    if (fx == 0) return;
    atomicAdd(acc + row + at, (unsigned long long)fx);
}

}  // namespace

extern "C" int sparse_rerank_launch(
    const int* block_docs, const float* block_weights, const int* block_idx,
    const float* query_weight, const uint8_t* live, const int* cand,
    const float* coarse_s, int qb, int n_q, int kprime, int k, int* cand_s,
    float* cs_s, long long* acc, float* out_s, int* out_d, float* eps,
    void* stream_ptr) {
    if (kprime < 1 || kprime > KMAX || k < 1 || k > kprime || n_q < 1 ||
        n_q > 65535 || qb < 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    int err = sort_candidates(cand, coarse_s, n_q, kprime, cand_s, cs_s, acc,
                              stream);
    if (err != 0) return err;
    if (qb > 0) {
        rescore_kernel<<<dim3(qb, n_q), BLOCK, 0, stream>>>(
            block_docs, block_weights, block_idx, query_weight, cand_s,
            kprime, (unsigned long long*)acc);
        err = (int)cudaGetLastError();
        if (err != 0) return err;
    }
    return rerank_finish(acc, cand_s, cs_s, live, n_q, kprime, k, out_s,
                         out_d, eps, stream);
}
