// bm25_scores: the dense BM25 score row of one query over one segment.
//
// Replaces elasticsearch_tpu/ops/bm25.py:45 `bm25_block_scores`, with the
// `where(live, s, 0)` of `Bm25Executor.scores` (ops/bm25.py:632) fused
// into its last pass: gather the query's QB posting blocks, score every
// posting with the f32 BM25 contribution, sum per doc, and write the
// [n_docs_pad] f32 row, 0 where no posting lands (or the doc is dead).
// The dense collector composes these rows (bool, dis_max, phrase masks)
// before its top-k.
//
// What bounds it on the H100: memory. It must read the gathered blocks
// (QB * 128 * 8 bytes of doc ids and tfs, plus a doc length a posting)
// and write the f32 row (16.8 MB at 4,194,304 docs: 0.005 ms at
// 3.35 TB/s); the arithmetic is a few flops a posting. Here the row's
// int64 accumulator is also zeroed, scattered into and read back (3x the
// row's bytes), and stopword terms' postings land as scattered atomics.
//
// Design: bm25_common.cuh's scatter_kernel, the one K1 runs (one CTA per
// gathered block, one thread per posting, the contribution one rounded
// f32 op at a time, summed as 64-bit fixed point with integer atomics),
// at one query, so a doc's score has K1's bits for the same blocks in any
// order; then one convert pass to f32, masked by live (bm25_common.cuh
// convert_row, shared with sparse_scores). The plain PyTorch
// version is elasticsearch_tpu_torch/ops/bm25.py `bm25_block_scores_plain`.
#include "bm25_common.cuh"

// block_q: [qb] int32 zeros and block_avgdl: [qb] f32 avgdl (the flat
// rows of one query); acc: [n_docs_pad] int64 scratch; out:
// [n_docs_pad] f32.
extern "C" int bm25_scores_launch(
    const int* block_docs, const float* block_tfs, const int* block_idx,
    const float* block_w, const int* block_q, const float* doc_lens,
    const float* block_avgdl, const uint8_t* live, int qb,
    long long n_docs_pad, float k1, float omb, float b, float k1p1,
    long long* acc, float* out, void* stream_ptr) {
    if (qb < 0 || n_docs_pad < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    cudaError_t err = cudaMemsetAsync(
        acc, 0, sizeof(long long) * (size_t)n_docs_pad, stream);
    if (err != cudaSuccess) return (int)err;
    if (qb > 0) {
        bm25::Consts c{k1, omb, b, k1p1};
        bm25::scatter_kernel<false><<<qb, bm25::BLOCK, 0, stream>>>(
            block_docs, block_tfs, block_idx, block_w, block_q, doc_lens,
            block_avgdl, n_docs_pad, qb, 1, bm25::ONE_SLOT, c,
            (unsigned long long*)acc);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return bm25::convert_row(acc, live, n_docs_pad, out, stream);
}
