// Shared device code of the four kNN kernel families (knn_flat,
// knn_coarse, knn_rerank, knn_scores).
//
// 1. The similarity transform (similarity below), the JAX package's
//    `_coarse_similarity` / `_rerank_scores` in their operation order:
//      cosine       (1 + dot / (norm * qn + 1e-30)) / 2
//      dot_product  0.5 + dot / 2
//      l2_norm      1 / (1 + sqrt(max(norm * norm + q2 - 2 * dot, 0)))
//    Every operation is an explicitly rounded intrinsic (__fmul_rn,
//    __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn), so nvcc contracts
//    nothing into an FMA and the kernel computes the same bits as the
//    plain PyTorch version, one rounded op at a time. One exception, on
//    purpose: XLA compiles the JAX program's norm * norm + q2 into one
//    fused multiply-add, so that sum is taken with the exact product and
//    rounded once -- here in double (the product of two f32 values is
//    exact there), then to f32, as the plain version does. qn (the
//    query's norm + 1e-30) and q2 (q . q) come from the host, computed
//    once per query.
// 2. The exact dot product: both operands rounded to bf16, products summed
//    in f32 in the order d = 0, 1, ..., D-1, one query-doc pair at a time.
//    The product of two bf16 values is exact in f32 (8 + 8 significant
//    bits), so an FMA rounds exactly where a multiply then an add would:
//    the sum has the bits of the plain version's column loop, with or
//    without FMA, in any batch. (Products below f32's normal range would
//    round; vectors whose coordinate products fall under 1e-38 are outside
//    that promise.)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace knn {

using namespace topk;

enum Similarity { SIM_COSINE = 0, SIM_DOT = 1, SIM_L2 = 2 };

constexpr int MAX_DIMS = 4096;  // mapping/mappers.py MAX_VECTOR_DIMS

// Round an f32 to the nearest bf16 and widen it back.
__device__ __forceinline__ float bfr(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float similarity(float dot, float norm, float qn,
                                            float q2, int sim) {
    if (sim == SIM_DOT) return __fadd_rn(0.5f, __fdiv_rn(dot, 2.f));
    if (sim == SIM_COSINE)
        return __fdiv_rn(
            __fadd_rn(1.f, __fdiv_rn(dot, __fadd_rn(__fmul_rn(norm, qn),
                                                    1e-30f))),
            2.f);
    const float n2q2 = __double2float_rn(
        __dadd_rn(__dmul_rn((double)norm, (double)norm), (double)q2));
    float d2 = __fsub_rn(n2q2, __fmul_rn(2.f, dot));
    d2 = d2 < 0.f ? 0.f : d2;
    return __fdiv_rn(1.f, __fadd_rn(1.f, __fsqrt_rn(d2)));
}

inline bool valid_sim(int sim) {
    return sim == SIM_COSINE || sim == SIM_DOT || sim == SIM_L2;
}

// 3. The scores pass shared by knn_flat (masked plane: -inf where the doc
//    is not allowed, or where the query's own filter row excludes it) and
//    knn_scores (dense row: 0 where the doc has no vector). One CTA scores a tile of TILE docs against a group of QB
//    queries (QB = 1 .. 16, a power of two), staging DT dims of the tile
//    at a time in shared memory; every thread owns RD docs x QB queries of
//    f32 sums in registers and adds the products d = 0, 1, ... in order,
//    so a row's sums never depend on the batch. The query groups of one
//    tile are adjacent block ids, so the tile is read from device memory
//    about once and from L2 by the other groups.

constexpr int SC_THREADS = 128;
constexpr int SC_RD = 4;                      // docs per thread
constexpr int SC_TILE = SC_THREADS * SC_RD;   // docs per CTA
constexpr int SC_DT = 16;                     // dims staged per step
constexpr int SC_MAX_TILES_Y = 65535;         // gridDim.y limit

// grid (query groups, doc tiles): plane[q, doc] for QB queries x TILE
// docs. DENSE: plane[doc] = mask[doc] ? similarity : 0 (mask = exists);
// else plane[q, doc] = mask[doc] & qmask[q, doc] ? similarity : -inf
// (mask = allowed; qmask = the per-query filter rows [n_q, n_docs_pad],
// nullptr when unfiltered).
template <int QB, bool DENSE>
__global__ void __launch_bounds__(SC_THREADS) vector_scores_kernel(
    const float* __restrict__ matrix, const float* __restrict__ norms,
    const uint8_t* __restrict__ mask, const uint8_t* __restrict__ qmask,
    const float* __restrict__ queries,
    const float* __restrict__ qn, const float* __restrict__ q2, int n_q,
    int dims, long long n_docs_pad, long long tile0, int sim,
    float* __restrict__ plane) {
    __shared__ float ms[SC_DT][SC_TILE + 1];
    __shared__ float qs[QB][SC_DT];
    const int t = threadIdx.x;
    const int q0 = blockIdx.x * QB;
    const long long doc0 = (tile0 + blockIdx.y) * (long long)SC_TILE;
    float acc[QB][SC_RD];
#pragma unroll
    for (int q = 0; q < QB; ++q)
#pragma unroll
        for (int r = 0; r < SC_RD; ++r) acc[q][r] = 0.f;

    for (int d0 = 0; d0 < dims; d0 += SC_DT) {
        const int dn = dims - d0 < SC_DT ? dims - d0 : SC_DT;
        for (int e = t; e < SC_TILE * SC_DT; e += SC_THREADS) {
            const int doc = e / SC_DT, dd = e % SC_DT;
            const long long g = doc0 + doc;
            float v = 0.f;
            if (dd < dn && g < n_docs_pad)
                v = bfr(matrix[g * dims + d0 + dd]);
            ms[dd][doc] = v;
        }
        for (int e = t; e < QB * SC_DT; e += SC_THREADS) {
            const int q = e / SC_DT, dd = e % SC_DT;
            float v = 0.f;
            if (dd < dn && q0 + q < n_q)
                v = bfr(queries[(long long)(q0 + q) * dims + d0 + dd]);
            qs[q][dd] = v;
        }
        __syncthreads();
        for (int dd = 0; dd < dn; ++dd) {
            float m[SC_RD];
#pragma unroll
            for (int r = 0; r < SC_RD; ++r) m[r] = ms[dd][t + r * SC_THREADS];
#pragma unroll
            for (int q = 0; q < QB; ++q) {
                const float qv = qs[q][dd];
#pragma unroll
                for (int r = 0; r < SC_RD; ++r)
                    acc[q][r] = __fmaf_rn(qv, m[r], acc[q][r]);
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int q = 0; q < QB; ++q) {
        const int qi = q0 + q;
        if (qi >= n_q) break;
        const float qnv = qn[qi], q2v = q2[qi];
#pragma unroll
        for (int r = 0; r < SC_RD; ++r) {
            const long long doc = doc0 + t + r * SC_THREADS;
            if (doc >= n_docs_pad) continue;
            const long long cell = (long long)qi * n_docs_pad + doc;
            const bool ok = mask[doc] && (qmask == nullptr || qmask[cell]);
            plane[cell] = ok ? similarity(acc[q][r], norms[doc], qnv, q2v, sim)
                             : (DENSE ? 0.f : -INFINITY);
        }
    }
}

template <int QB, bool DENSE>
int launch_vector_scores(const float* matrix, const float* norms,
                         const uint8_t* mask, const uint8_t* qmask,
                         const float* queries,
                         const float* qn, const float* q2, int n_q, int dims,
                         long long n_docs_pad, int sim, float* plane,
                         cudaStream_t stream) {
    const int groups = (n_q + QB - 1) / QB;
    const long long tiles = (n_docs_pad + SC_TILE - 1) / SC_TILE;
    for (long long tile0 = 0; tile0 < tiles; tile0 += SC_MAX_TILES_Y) {
        const long long nt =
            tiles - tile0 < SC_MAX_TILES_Y ? tiles - tile0 : SC_MAX_TILES_Y;
        vector_scores_kernel<QB, DENSE>
            <<<dim3(groups, (unsigned)nt), SC_THREADS, 0, stream>>>(
                matrix, norms, mask, qmask, queries, qn, q2, n_q, dims,
                n_docs_pad, tile0, sim, plane);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

}  // namespace knn
