// Shared device code of the rank_features kernel families (sparse_flat,
// sparse_scores, sparse_coarse, sparse_rerank).
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
//   JAX programs' vmapped form), not BM25's flat (block, query) rows;
// - the contribution: qw * f(w), with f one of the rank_feature functions
//   (saturation w / (w + pivot), log log(pivot + w), sigmoid
//   w^a / (w^a + pivot^a) on max(w, 0), linear w), each op rounded once;
//   in the coarse tier f32(bf16(qw)) * f32(w_bf16), the product of two
//   bf16 values, exact in f32 and never rounded to bf16 (the JAX program
//   widens it to f32 at once, and XLA drops the bf16 rounding there).
//
// Pads contribute nothing: doc -1 inside a block, and query weight 0 (the
// padding slots of a query's block list, which point at block 0).
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

// grid (qb, n_q), BLOCK threads: posting e of query q's gathered block f
// adds fixed(contribution) to acc[q * n_docs_pad + doc]. BF16 selects the
// coarse tier (bf16 weight mirror, linear).
template <bool BF16>
__global__ void scatter_kernel(const int* __restrict__ block_docs,
                               const void* __restrict__ block_weights,
                               const int* __restrict__ block_idx,
                               const float* __restrict__ query_weight,
                               long long n_docs_pad, Params p,
                               unsigned long long* __restrict__ acc) {
    const long long slot = (long long)blockIdx.y * gridDim.x + blockIdx.x;
    const float qw = query_weight[slot];
    if (qw == 0.f) return;
    const long long e = (long long)block_idx[slot] * BLOCK + threadIdx.x;
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
    atomicAdd(acc + (long long)blockIdx.y * n_docs_pad + doc,
              (unsigned long long)fx);
}

// Zero the [n_q, n_docs_pad] plane and scatter every gathered posting of
// every query into it. Returns the first CUDA error, 0 on success.
template <bool BF16>
int scatter_plane(const int* block_docs, const void* block_weights,
                  const int* block_idx, const float* query_weight, int qb,
                  long long n_docs_pad, int n_q, Params p, long long* acc,
                  cudaStream_t stream) {
    if (qb < 0 || n_q < 1 || n_q > 65535 || n_docs_pad < 1)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaMemsetAsync(
        acc, 0, sizeof(long long) * (size_t)n_q * (size_t)n_docs_pad, stream);
    if (err != cudaSuccess) return (int)err;
    if (qb == 0) return 0;
    scatter_kernel<BF16><<<dim3(qb, n_q), BLOCK, 0, stream>>>(
        block_docs, block_weights, block_idx, query_weight, n_docs_pad, p,
        (unsigned long long*)acc);
    return (int)cudaGetLastError();
}

// The exact top-k (+ counts) pipeline of sparse_flat and sparse_coarse:
// scatter_plane, then bm25_common.cuh's select_plane.
template <bool BF16>
int scored_topk(const int* block_docs, const void* block_weights,
               const int* block_idx, const float* query_weight,
               const uint8_t* live, int qb, long long n_docs_pad, int n_q,
               int k, int counted, Params p, long long* acc, float* chunk_s,
               int* chunk_i, float* out_s, int* out_d, int* hits,
               cudaStream_t stream) {
    if (k < 1 || n_docs_pad < k) return (int)cudaErrorInvalidValue;
    int err = scatter_plane<BF16>(block_docs, block_weights, block_idx,
                                  query_weight, qb, n_docs_pad, n_q, p, acc,
                                  stream);
    if (err != 0) return err;
    return select_plane(acc, live, nullptr, n_docs_pad, n_q, k,
                        counted ? COUNT_TOTAL : COUNT_NONE, 1, chunk_s,
                        chunk_i, out_s, out_d, counted ? hits : nullptr,
                        stream);
}

}  // namespace sparse
