// mesh_bm25_coarse: the quantized coarse tier of every shard of a
// co-located fan-out in one launch.
//
// Replaces elasticsearch_tpu/parallel/mesh.py:297 `mesh_bm25_coarse` (a
// shard_map of ops/bm25.py `bm25_coarse_body` over the `shard` mesh
// axis): for every slot, bm25_coarse on that slot's bf16 mirrors --
// [S, NB, 128] bf16 tfs, [S, n_docs_pad] bf16 doc lengths -- with the
// slot's [FB] flat operands (stacked [S, FB]). Outputs: coarse scores and
// candidates [S, n_q, k'], exact per-segment counts [S, n_q, n_segs].
//
// What bounds it on the H100: memory, as bm25_coarse summed over the
// slots.
//
// Design: tiles.cuh with the slot axis (one group a slot) and the
// bf16 contribution, so each slot's output is bitwise bm25_coarse's on
// that slot, the last quotient left unrounded as there. The plain PyTorch
// version is elasticsearch_tpu_torch/parallel/mesh.py
// `mesh_bm25_coarse_plain`.
#include "tiles.cuh"

// The C entry (tiles.cuh ``bm25_launch`` and ``scratch_bytes``).
extern "C" long long mesh_bm25_coarse_bytes(
    int which, long long x, long long y, long long z, int k,
    long long n_docs_pad, long long rows) {
    return tiles::scratch_bytes(which, x, y, z, k, n_docs_pad, rows,
                                false);
}

extern "C" int mesh_bm25_coarse_launch(
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
    return tiles::bm25_launch<true>(
        phase, block_docs, block_tfs, ranges, doc_lens, flat_idx, flat_w,
        flat_q, flat_avgdl, live, seg_ids, sl, nb, fb, n_docs_pad, n_q, k,
        mode, n_segs, bm25::Consts{k1, omb, b, k1p1}, ws_a, ws_b, b_bytes,
        host, out_s, out_d, hits, split_ms, (cudaStream_t)stream);
}
