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
// Why the simple design: three small kernels (bm25_common.cuh
// ``rerank_tier``, shared with mesh_bm25_rerank; (1) and (3) also with
// sparse_rerank). (1) One CTA per row bitonic-sorts the
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

extern "C" int bm25_rerank_launch(
    const int* block_docs, const float* block_tfs, const int* flat_idx,
    const float* flat_w, const int* flat_q, const float* doc_lens,
    const float* flat_avgdl, const uint8_t* live, const int* cand,
    const float* coarse_s, int fb, int n_q, int kprime, int k, float k1,
    float omb, float b, float k1p1, int* cand_s, float* cs_s, long long* acc,
    float* out_s, int* out_d, float* eps, void* stream) {
    bm25::Consts c{k1, omb, b, k1p1};
    return bm25::rerank_tier(block_docs, block_tfs, flat_idx, flat_w, flat_q,
                             doc_lens, flat_avgdl, live, cand, coarse_s, fb,
                             n_q, kprime, k, c, cand_s, cs_s, acc, out_s,
                             out_d, eps, (cudaStream_t)stream);
}
