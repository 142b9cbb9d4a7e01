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
// blocks (FB * 128 * 8 bytes of doc ids and tfs) and the doc lengths they
// gather; the arithmetic is a few flops a posting.
//
// Design: tiles.cuh. Each (query, 8,192-doc tile) that a gathered
// block reaches is summed in shared memory in 64-bit fixed point (the sum
// does not depend on the order of the adds), masked, counted and reduced
// to its best entries in one CTA; a threshold from those entries and one
// row-batched selection (rows_select.cuh) give the top-k, and a rule
// fills the -inf slots. No [n_q, n_docs_pad] plane is written. The plain
// PyTorch version is elasticsearch_tpu_torch/ops/bm25.py
// `bm25_flat_plain`.
#include "tiles.cuh"

// The C entry (tiles.cuh ``bm25_launch`` and ``scratch_bytes``).
extern "C" long long bm25_flat_bytes(
    int which, long long x, long long y, long long z, int k,
    long long n_docs_pad, long long rows) {
    return tiles::scratch_bytes(which, x, y, z, k, n_docs_pad, rows,
                                false);
}

extern "C" int bm25_flat_launch(
    int phase, const int* block_docs, const void* block_tfs,
    const int* ranges, const void* doc_lens, const int* flat_idx,
    const float* flat_w, const int* flat_q, const float* flat_avgdl,
    const uint8_t* live, const int* seg_ids, int groups,
    int groups_per_slot, long long nb, int fb, long long n_docs_pad, int n_q,
    int k, int mode, int n_segs, float k1, float omb, float b, float k1p1,
    void* ws_a, void* ws_b, long long b_bytes, long long* host,
    float* out_s, int* out_d, int* hits, float* split_ms, void* stream) {
    if (groups < 1 || groups_per_slot < 1 || nb < 1)
        return (int)cudaErrorInvalidValue;
    const bm25::Slots sl{groups, groups_per_slot, nb * bm25::BLOCK,
                         n_docs_pad};
    return tiles::bm25_launch<false>(
        phase, block_docs, block_tfs, ranges, doc_lens, flat_idx, flat_w,
        flat_q, flat_avgdl, live, seg_ids, sl, nb, fb, n_docs_pad, n_q, k,
        mode, n_segs, bm25::Consts{k1, omb, b, k1p1}, ws_a, ws_b, b_bytes,
        host, out_s, out_d, hits, split_ms, (cudaStream_t)stream);
}
