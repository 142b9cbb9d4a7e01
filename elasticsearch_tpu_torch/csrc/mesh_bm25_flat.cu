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
// slots: the gathered blocks of every (slot, row) and the
// [S * DP * n_q, n_docs_pad] fixed-point accumulator, written, then read
// by the chunked selection.
//
// Why the simple design: bm25_common.cuh's dense pipeline with its slot
// axis. The scatter's grid is (FB, S * DP), and each group reads its own
// slot's store (slot * NB * 128 elements in) and writes rows of its own;
// the selection's grid covers all S * DP * n_q rows, each masking and
// counting with its slot's live mask and seg ids. Every slot therefore
// runs bm25_flat_seg's arithmetic on its own plane, and the 64-bit integer
// accumulation makes the sums independent of the order the atomics land:
// each slot's output is bitwise bm25_flat_seg's on that slot. The plain
// PyTorch version is elasticsearch_tpu_torch/parallel/mesh.py
// `mesh_bm25_flat_plain`.
#include "bm25_common.cuh"

extern "C" int mesh_bm25_flat_launch(
    const int* block_docs, const float* block_tfs, const float* doc_lens,
    const int* flat_idx, const float* flat_w, const int* flat_q,
    const float* flat_avgdl, const uint8_t* live, const int* seg_ids,
    int n_slots, int dp, long long nb, int fb, long long n_docs_pad, int n_q,
    int k, int n_segs, float k1, float omb, float b, float k1p1,
    long long* acc, float* chunk_s, int* chunk_i, float* out_s, int* out_d,
    int* hits, void* stream) {
    if (n_slots < 1 || dp < 1 || nb < 1) return (int)cudaErrorInvalidValue;
    bm25::Consts c{k1, omb, b, k1p1};
    const bm25::Slots sl{n_slots * dp, dp, nb * bm25::BLOCK, n_docs_pad};
    return bm25::dense_topk<false>(
        block_docs, block_tfs, flat_idx, flat_w, flat_q, doc_lens,
        flat_avgdl, live, seg_ids, fb, n_docs_pad, n_q, k, bm25::COUNT_SEGS,
        n_segs, c, acc, chunk_s, chunk_i, out_s, out_d, hits,
        (cudaStream_t)stream, sl);
}
