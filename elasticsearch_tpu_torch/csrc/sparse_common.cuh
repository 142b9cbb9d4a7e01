// Shared device code of the rank_features kernel families (sparse_flat,
// sparse_scores, sparse_coarse, sparse_rerank) and their mesh forms
// (mesh_sparse_topk, mesh_sparse_coarse, mesh_sparse_rerank).
//
// The JAX package scores a rank_features query exactly as it scores BM25:
// gather each query's posting blocks, turn each posting into a
// contribution, scatter-add per (query, doc), then mask, count and take
// the top-k. So these families reuse bm25_common.cuh whole -- its 64-bit
// fixed-point sums with integer atomics (order-free, so the kernel, its
// plain version and every family give the same bits for the same doc),
// the chunked mask + count + top-k, the exact tier's candidate sort and
// finish -- and add only what differs:
//
// - the layout: a [n_q, QB] block list and query weight per query (the
//   JAX programs' vmapped form), not BM25's flat (block, query) rows; a
//   list entry is a block-list position ("pos"), never a "slot", which
//   here, as in bm25_common.cuh, means one shard's plane of a stack;
// - the contribution: qw * f(w), with f one of the rank_feature functions
//   (saturation w / (w + pivot), log log(pivot + w), sigmoid
//   w^a / (w^a + pivot^a) on max(w, 0), linear w), each op rounded once;
//   in the coarse tier f32(bf16(qw)) * f32(w_bf16), the product of two
//   bf16 values, exact in f32 and never rounded to bf16 (the JAX program
//   widens it to f32 at once, and XLA drops the bf16 rounding there).
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

namespace sparse {

using namespace bm25;

enum Function { SATURATION = 0, LOG = 1, SIGMOID = 2, LINEAR = 3 };

// f(w), one rounded op at a time. pivot_pow = pivot^exponent in f32,
// computed once on the host (sigmoid only).
__device__ __forceinline__ float transform(int fn, float w, float pivot,
                                           float exponent, float pivot_pow) {
    switch (fn) {
        case SATURATION:
            return __fdiv_rn(w, __fadd_rn(w, pivot));
        case LOG:
            return logf(__fadd_rn(pivot, w));
        case SIGMOID: {
            const float wa = powf(fmaxf(w, 0.f), exponent);
            return __fdiv_rn(wa, __fadd_rn(wa, pivot_pow));
        }
        default:
            return w;
    }
}

struct Params {
    int fn;
    float pivot, exponent, pivot_pow;
};

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
// fixed(contribution) to acc[r * n_docs_pad + doc]. BF16 selects the
// coarse tier (bf16 weight mirror, linear).
template <bool BF16>
__global__ void scatter_kernel(const int* __restrict__ block_docs,
                               const void* __restrict__ block_weights,
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
    float c;
    if (BF16) {
        const __nv_bfloat16* w16 = (const __nv_bfloat16*)block_weights;
        c = __fmul_rn(bfr(qw), __bfloat162float(w16[e]));
    } else {
        const float w = ((const float*)block_weights)[e];
        c = __fmul_rn(qw, transform(p.fn, w, p.pivot, p.exponent,
                                    p.pivot_pow));
    }
    const long long fx = to_fixed(c);
    if (fx == 0) return;
    atomicAdd(acc + row * n_docs_pad + doc, (unsigned long long)fx);
}

// Zero the [n_rows, n_docs_pad] plane and scatter every gathered posting
// of every query row into it. Returns the first CUDA error, 0 on success.
template <bool BF16>
int scatter_plane(const int* block_docs, const void* block_weights,
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
    scatter_kernel<BF16><<<dim3(qb, (unsigned)n_rows), BLOCK, 0, stream>>>(
        block_docs, block_weights, block_idx, query_weight, n_docs_pad,
        sl.groups_per_slot * n_q, sl.slot_blocks, p,
        (unsigned long long*)acc);
    return (int)cudaGetLastError();
}

// The exact top-k (+ counts) pipeline of sparse_flat, sparse_coarse and
// their mesh forms: scatter_plane, then bm25_common.cuh's select_plane
// over all n_rows rows, each masked and counted with its slot's live row.
template <bool BF16>
int scored_topk(const int* block_docs, const void* block_weights,
               const int* block_idx, const float* query_weight,
               const uint8_t* live, int qb, long long n_docs_pad, int n_q,
               int k, int counted, Params p, long long* acc, float* chunk_s,
               int* chunk_i, float* out_s, int* out_d, int* hits,
               cudaStream_t stream, Slots sl = ONE_SLOT) {
    if (k < 1 || n_docs_pad < k) return (int)cudaErrorInvalidValue;
    int err = scatter_plane<BF16>(block_docs, block_weights, block_idx,
                                  query_weight, qb, n_docs_pad, n_q, p, acc,
                                  stream, sl);
    if (err != 0) return err;
    return select_plane(acc, live, nullptr, n_docs_pad,
                        (int)rows_of(sl, n_q), k,
                        counted ? COUNT_TOTAL : COUNT_NONE, 1, chunk_s,
                        chunk_i, out_s, out_d, counted ? hits : nullptr,
                        stream, sl.groups_per_slot * n_q, sl.slot_docs);
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
