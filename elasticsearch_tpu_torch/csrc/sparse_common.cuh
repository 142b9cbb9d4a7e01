// Shared device code of the rank_features families that sum into a plane
// or into candidate slots: sparse_rerank (K17), mesh_sparse_rerank (row
// 35) and sharded_sparse (row 43). The top-k families (sparse_flat K15,
// sparse_coarse K16, mesh_sparse_topk row 38, mesh_sparse_coarse row 34)
// and the dense row (sparse_scores K19) sum in shared-memory tiles instead
// (tiles.cuh).
//
// The JAX package scores a rank_features query exactly as it scores BM25:
// gather each query's posting blocks, turn each posting into a
// contribution, scatter-add per (query, doc). So these families reuse
// bm25_common.cuh -- its 64-bit fixed-point sums with integer atomics
// (order-free, so the kernel, its plain version and every family give the
// same bits for the same doc), the exact tier's candidate sort and finish
// -- and add only what differs:
//
// - the layout: a [n_q, QB] block list and query weight per query (the
//   JAX programs' vmapped form), not BM25's flat (block, query) rows; a
//   list entry is a block-list position ("pos"), never a "slot", which
//   here, as in bm25_common.cuh, means one shard's plane of a stack;
// - the contribution: qw * f(w), f one of the rank_feature functions
//   (feature_fn.cuh), each op rounded once.
//
// Pads contribute nothing: doc -1 inside a block, and query weight 0 (the
// padding positions of a query's block list, which point at block 0).
//
// Every pipeline takes bm25_common.cuh's slot axis: the mesh families run
// S stacked [NB, 128] stores in one launch, each query row reading its own
// slot's store and live row, and the one-shard families pass ONE_SLOT, so
// each slot of a mesh launch runs exactly the one-shard arithmetic.
#pragma once

#include "bm25_common.cuh"
#include "feature_fn.cuh"

namespace sparse {

using namespace bm25;

// The slot axis (bm25_common.cuh's ``Slots``): a launch takes
// sl.groups * n_q query rows, row r of group r / n_q, whose postings index
// the block store of slot (r / n_q) / sl.groups_per_slot (slot_blocks
// elements apart) and whose mask is that slot's live row (slot_docs
// apart). The one-shard families pass ONE_SLOT.
inline long long rows_of(Slots sl, int n_q) {
    return (long long)sl.groups * n_q;
}

// grid (qb, n_rows), BLOCK threads: entry ``pos`` of query row r's [qb]
// block list names a block of the row's slot store; posting e of it adds
// fixed(qw * f(w)) to acc[r * n_docs_pad + doc].
__global__ void scatter_kernel(const int* __restrict__ block_docs,
                               const float* __restrict__ block_weights,
                               const int* __restrict__ block_idx,
                               const float* __restrict__ query_weight,
                               long long n_docs_pad, int rows_per_slot,
                               long long slot_blocks, Params p,
                               unsigned long long* __restrict__ acc) {
    const long long row = blockIdx.y;
    const long long pos = row * gridDim.x + blockIdx.x;
    const float qw = query_weight[pos];
    if (qw == 0.f) return;
    const long long e = (row / rows_per_slot) * slot_blocks +
                        (long long)block_idx[pos] * BLOCK + threadIdx.x;
    const int doc = block_docs[e];
    if (doc < 0) return;
    const float c = __fmul_rn(
        qw, transform(p.fn, block_weights[e], p.pivot, p.exponent,
                      p.pivot_pow));
    const long long fx = to_fixed(c);
    if (fx == 0) return;
    atomicAdd(acc + row * n_docs_pad + doc, (unsigned long long)fx);
}

// Zero the [n_rows, n_docs_pad] plane and scatter every gathered posting
// of every query row into it. Returns the first CUDA error, 0 on success.
inline int scatter_plane(const int* block_docs, const float* block_weights,
                  const int* block_idx, const float* query_weight, int qb,
                  long long n_docs_pad, int n_q, Params p, long long* acc,
                  cudaStream_t stream, Slots sl = ONE_SLOT) {
    const long long n_rows = rows_of(sl, n_q);
    if (qb < 0 || n_q < 1 || n_rows > 65535 || n_docs_pad < 1 ||
        !slots_ok(sl))
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaMemsetAsync(
        acc, 0, sizeof(long long) * (size_t)n_rows * (size_t)n_docs_pad,
        stream);
    if (err != cudaSuccess) return (int)err;
    if (qb == 0) return 0;
    scatter_kernel<<<dim3(qb, (unsigned)n_rows), BLOCK, 0, stream>>>(
        block_docs, block_weights, block_idx, query_weight, n_docs_pad,
        sl.groups_per_slot * n_q, sl.slot_blocks, p,
        (unsigned long long*)acc);
    return (int)cudaGetLastError();
}

// grid (qb, n_rows), BLOCK threads: the exact tier's re-scoring. A
// posting of row r's gathered blocks whose doc is one of the row's sorted
// candidates adds its f32 linear contribution (as fixed point) at that
// candidate's position in acc[r * kprime .. + kprime); all others are
// dropped.
__global__ void rescore_kernel(const int* __restrict__ block_docs,
                               const float* __restrict__ block_weights,
                               const int* __restrict__ block_idx,
                               const float* __restrict__ query_weight,
                               const int* __restrict__ cand_s, int kprime,
                               int rows_per_slot, long long slot_blocks,
                               unsigned long long* __restrict__ acc) {
    const long long row = blockIdx.y;
    const long long pos = row * gridDim.x + blockIdx.x;
    const float qw = query_weight[pos];
    if (qw == 0.f) return;
    const long long e = (row / rows_per_slot) * slot_blocks +
                        (long long)block_idx[pos] * BLOCK + threadIdx.x;
    const int doc = block_docs[e];
    if (doc < 0) return;
    const long long base = row * kprime;
    const int at = candidate_slot(cand_s + base, kprime, doc);
    if (at < 0) return;
    const long long fx = to_fixed(__fmul_rn(qw, block_weights[e]));
    if (fx == 0) return;
    atomicAdd(acc + base + at, (unsigned long long)fx);
}

// The whole exact tier of sparse_rerank and mesh_sparse_rerank: sort each
// row's k' candidates by doc id, re-score the candidate postings, then
// bm25_common.cuh's mask + top-k + eps pass, each row masking with its
// slot's live row. Returns the first CUDA error, 0 on success.
inline int rerank_tier(const int* block_docs, const float* block_weights,
                       const int* block_idx, const float* query_weight,
                       const uint8_t* live, const int* cand,
                       const float* coarse_s, int qb, int n_q, int kprime,
                       int k, int* cand_s, float* cs_s, long long* acc,
                       float* out_s, int* out_d, float* eps,
                       cudaStream_t stream, Slots sl = ONE_SLOT) {
    const long long n_rows = rows_of(sl, n_q);
    if (kprime < 1 || kprime > KMAX || k < 1 || k > kprime || n_q < 1 ||
        n_rows > 65535 || qb < 0 || !slots_ok(sl))
        return (int)cudaErrorInvalidValue;
    int err = sort_candidates(cand, coarse_s, (int)n_rows, kprime, cand_s,
                              cs_s, acc, stream);
    if (err != 0) return err;
    if (qb > 0) {
        rescore_kernel<<<dim3(qb, (unsigned)n_rows), BLOCK, 0, stream>>>(
            block_docs, block_weights, block_idx, query_weight, cand_s,
            kprime, sl.groups_per_slot * n_q, sl.slot_blocks,
            (unsigned long long*)acc);
        err = (int)cudaGetLastError();
        if (err != 0) return err;
    }
    return rerank_finish(acc, cand_s, cs_s, live, (int)n_rows, kprime, k,
                         out_s, out_d, eps, stream,
                         sl.groups_per_slot * n_q, sl.slot_docs);
}

}  // namespace sparse
