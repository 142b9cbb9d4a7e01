// bm25_flat: the exact flat BM25 top-k over a block store, with an
// optional per-query match count.
//
// Replaces elasticsearch_tpu/ops/bm25.py:261 `_bm25_flat_kernel` (body
// `bm25_flat_body`, ops/bm25.py:96): gather the batch's FB posting blocks,
// score each posting with the f32 BM25 contribution, accumulate per
// (query, doc), mask to live docs with score > 0, top-k per query and,
// when counted, hits[q] = matches.
//
// What bounds it on the H100: memory. Per dispatch it reads the gathered
// blocks (FB * 128 * 8 bytes of doc ids and tfs, plus a random doc_lens
// gather) and writes then reads back the [n_q, n_docs_pad] accumulator
// (8 bytes a cell); the arithmetic is a few flops a posting. The
// accumulator dominates for selective queries, the scattered atomics for
// stopword-heavy ones.
//
// Why the simple design: one CTA per gathered block scatters into a
// dense fixed-point plane with 64-bit integer atomics (deterministic: the
// sum does not depend on the order the atomics land), then
// bm25_common.cuh's chunked CTA top-k masks, counts and selects. A
// sparse accumulator or a fused scatter+select would move fewer bytes;
// that is later work. The plain PyTorch version is
// elasticsearch_tpu_torch/ops/bm25.py `bm25_flat_plain`.
#include "bm25_common.cuh"

extern "C" int bm25_flat_launch(
    const int* block_docs, const float* block_tfs, const int* flat_idx,
    const float* flat_w, const int* flat_q, const float* doc_lens,
    const float* flat_avgdl, const uint8_t* live, int fb,
    long long n_docs_pad, int n_q, int k, int counted, float k1, float omb,
    float b, float k1p1, long long* acc, float* chunk_s, int* chunk_i,
    float* out_s, int* out_d, int* hits, void* stream) {
    bm25::Consts c{k1, omb, b, k1p1};
    return bm25::dense_topk<false>(
        block_docs, block_tfs, flat_idx, flat_w, flat_q, doc_lens,
        flat_avgdl, live, nullptr, fb, n_docs_pad, n_q, k,
        counted ? bm25::COUNT_TOTAL : bm25::COUNT_NONE, 1, c, acc, chunk_s,
        chunk_i, out_s, out_d, counted ? hits : nullptr,
        (cudaStream_t)stream);
}
