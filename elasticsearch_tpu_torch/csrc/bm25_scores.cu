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
// 3.35 TB/s); the arithmetic is a few flops a posting.
//
// Design: tiles.cuh's dense row (section 5) under its Bm25Policy: each
// gathered block of non-zero weight is listed under the 8,192-doc tiles
// holding its docs, each tile sums its blocks' contributions (K1's, one
// rounded f32 op at a time, the doc lengths staged once for a crowded
// tile) in shared memory as 64-bit fixed point, so a doc's score has K1's
// bits for the same blocks in any order, and writes its slice of the row
// once, masked by live. No int64 row is zeroed or read back and no global
// 64-bit atomic is issued; the lists are sized before the launch, so a
// call never waits on the host. The plain PyTorch version is
// elasticsearch_tpu_torch/ops/bm25.py `bm25_block_scores_plain`, and
// `bm25_dense_mirror` runs this algorithm on the CPU.
#include "tiles.cuh"

// Scratch bytes of a call (tiles.cuh ``dense_bytes``).
extern "C" long long bm25_scores_bytes(long long qb, long long n_docs_pad) {
    return tiles::dense_bytes(qb, n_docs_pad, false);
}

// ranges: the store's [nb, 2] block doc ranges; live may be null (every
// doc live); ws: bm25_scores_bytes of scratch; out: [n_docs_pad] f32.
extern "C" int bm25_scores_launch(
    const int* block_docs, const float* block_tfs, const int* ranges,
    const float* doc_lens, const int* block_idx, const float* block_w,
    const uint8_t* live, long long nb, int qb, long long n_docs_pad,
    float avgdl, float k1, float omb, float b, float k1p1, void* ws,
    long long* host, float* out, float* split_ms, void* stream) {
    tiles::Tiles a{};
    a.block_docs = block_docs;
    a.block_tfs = block_tfs;
    a.ranges = ranges;
    a.doc_lens = doc_lens;
    a.flat_idx = block_idx;
    a.flat_w = block_w;
    a.avg = avgdl;
    a.live = live;
    a.nb = nb;
    a.qb = qb;
    a.n_docs_pad = n_docs_pad;
    a.c = bm25::Consts{k1, omb, b, k1p1};
    return tiles::dense_run<tiles::Bm25Policy<false>>(
        a, ws, out, host, split_ms, (cudaStream_t)stream);
}
