// mesh_bm25_flat: the exact flat BM25 top-k of every shard of a co-located
// fan-out, with per-segment match counts, in one launch.
//
// Replaces elasticsearch_tpu/parallel/mesh.py:245 `mesh_bm25_flat` (a
// shard_map of ops/bm25.py `bm25_flat_body` + `lax.top_k` + the one-hot
// per-segment counts over the `shard` and `dp` mesh axes): for every
// (slot, dp row) it is bm25_flat_seg on that slot's plane, with that
// row's n_q queries. The stacked planes are [S, NB, 128] block stores and
// [S, n_docs_pad] doc lengths, live masks and seg ids; the flat operands
// are [S, DP, FB]; the outputs [S, DP, n_q, k] scores and plane docs and
// [S, DP, n_q, n_segs] counts.
//
// What bounds it on the H100: memory, as bm25_flat_seg, summed over the
// slots: the gathered blocks of every (slot, row) and their doc lengths.
//
// Design: tiles.cuh with bm25_common.cuh's slot axis: group g =
// (slot, dp row) of the flat operands reads slot g / DP's store, ranges,
// doc lengths, live mask and seg ids, and owns output rows g * n_q ...;
// its (row, tile) pairs are binned, summed and selected with every other
// group's in the same launches. Every slot therefore runs bm25_flat_seg's
// arithmetic on its own plane, and the 64-bit integer sums make each
// slot's output bitwise bm25_flat_seg's on that slot. The plain PyTorch
// version is elasticsearch_tpu_torch/parallel/mesh.py
// `mesh_bm25_flat_plain`.
#include "tiles.cuh"

// The C entry (tiles.cuh ``bm25_launch`` and ``scratch_bytes``).
extern "C" long long mesh_bm25_flat_bytes(
    int which, long long x, long long y, long long z, int k,
    long long n_docs_pad, long long rows) {
    return tiles::scratch_bytes(which, x, y, z, k, n_docs_pad, rows,
                                false);
}

extern "C" int mesh_bm25_flat_launch(
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
