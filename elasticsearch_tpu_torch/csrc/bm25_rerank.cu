// bm25_rerank: the exact tier of the two-tier text path.
//
// Replaces elasticsearch_tpu/ops/bm25.py:248 `_bm25_rerank_kernel` (body
// `bm25_rerank_body`, ops/bm25.py:182): sort each row's k' coarse
// candidates by doc id, re-score only them with bm25_flat's f32
// contribution, drop every other posting, mask to live docs with
// score > 0, top-k, and eps[q] = max |exact - coarse| over the matched
// candidates.
//
// What bounds it on the H100: memory, and far less of it than bm25_flat.
// It reads the same gathered blocks (FB * 128 * 8 bytes) but writes only
// a [n_q, k'] accumulator, and reads doc_lens only for candidate
// postings.
//
// Why the simple design: three small kernels, (1) and (3) shared with
// sparse_rerank (bm25_common.cuh). (1) One CTA per row bitonic-sorts the
// row's candidates in shared memory and writes them back. (2) One CTA per gathered block finds each posting's slot by
// binary search in its row's sorted candidates (L1/L2 resident, k' <=
// 4096) and adds its fixed-point contribution there with a 64-bit integer
// atomic: the same sum, bit for bit, that bm25_flat forms for that doc.
// The reference's [n_q * n_docs_pad] slot map would be 4 GB at full
// size; the search needs none. Spreading step (2) over the gathered
// blocks keeps every SM busy even for a solo query, where one CTA per row
// would leave all but one idle. (3) One CTA per row masks, selects the
// top-k (bm25_common.cuh) and reduces eps. The plain PyTorch version is
// elasticsearch_tpu_torch/ops/bm25.py `bm25_rerank_plain`.
#include "bm25_common.cuh"

using namespace bm25;

namespace {

// grid (fb), BLOCK threads: candidate postings add their contribution at
// their candidate's slot; all others are dropped.
__global__ void rescore_kernel(const int* __restrict__ block_docs,
                               const float* __restrict__ block_tfs,
                               const int* __restrict__ flat_idx,
                               const float* __restrict__ flat_w,
                               const int* __restrict__ flat_q,
                               const float* __restrict__ doc_lens,
                               const float* __restrict__ flat_avgdl,
                               const int* __restrict__ cand_s, int kprime,
                               Consts c, unsigned long long* __restrict__ acc) {
    const long long f = blockIdx.x;
    const long long e = (long long)flat_idx[f] * BLOCK + threadIdx.x;
    const int doc = block_docs[e];
    if (doc < 0) return;
    const long long row = (long long)flat_q[f] * kprime;
    const int slot = candidate_slot(cand_s + row, kprime, doc);
    if (slot < 0) return;
    const long long fx = to_fixed(contrib_f32(flat_w[f], block_tfs[e],
                                              doc_lens[doc], flat_avgdl[f], c));
    if (fx == 0) return;
    atomicAdd(acc + row + slot, (unsigned long long)fx);
}

}  // namespace

extern "C" int bm25_rerank_launch(
    const int* block_docs, const float* block_tfs, const int* flat_idx,
    const float* flat_w, const int* flat_q, const float* doc_lens,
    const float* flat_avgdl, const uint8_t* live, const int* cand,
    const float* coarse_s, int fb, int n_q, int kprime, int k, float k1,
    float omb, float b, float k1p1, int* cand_s, float* cs_s, long long* acc,
    float* out_s, int* out_d, float* eps, void* stream_ptr) {
    if (kprime < 1 || kprime > KMAX || k < 1 || k > kprime || n_q < 1 ||
        fb < 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    Consts c{k1, omb, b, k1p1};
    int err = sort_candidates(cand, coarse_s, n_q, kprime, cand_s, cs_s, acc,
                              stream);
    if (err != 0) return err;
    if (fb > 0) {
        rescore_kernel<<<fb, BLOCK, 0, stream>>>(
            block_docs, block_tfs, flat_idx, flat_w, flat_q, doc_lens,
            flat_avgdl, cand_s, kprime, c, (unsigned long long*)acc);
        err = (int)cudaGetLastError();
        if (err != 0) return err;
    }
    return rerank_finish(acc, cand_s, cs_s, live, n_q, kprime, k, out_s,
                         out_d, eps, stream);
}
