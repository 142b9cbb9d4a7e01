// Shared device code of the kNN kernel families: the one-shard K5-K7 and
// K9 (knn_flat, knn_coarse, knn_rerank, knn_scores), the mesh's
// mesh_knn_topk, mesh_knn_coarse and mesh_knn_rerank, which run K5 / K6 /
// K7 for every slot of a stack of shards in one launch, and (through
// sharded_scores.cuh) the scores pass of the sharded data plane's
// sharded_knn and sharded_hybrid.
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

// ``fused`` false: norm * norm + q2 as a rounded product then a rounded
// add, the order the sharded kNN program (F32 below) takes it in.
__device__ __forceinline__ float similarity(float dot, float norm, float qn,
                                            float q2, int sim,
                                            bool fused = true) {
    if (sim == SIM_DOT) return __fadd_rn(0.5f, __fdiv_rn(dot, 2.f));
    if (sim == SIM_COSINE)
        return __fdiv_rn(
            __fadd_rn(1.f, __fdiv_rn(dot, __fadd_rn(__fmul_rn(norm, qn),
                                                    1e-30f))),
            2.f);
    const float n2q2 =
        fused ? __double2float_rn(__dadd_rn(__dmul_rn((double)norm,
                                                      (double)norm),
                                            (double)q2))
              : __fadd_rn(__fmul_rn(norm, norm), q2);
    float d2 = __fsub_rn(n2q2, __fmul_rn(2.f, dot));
    d2 = d2 < 0.f ? 0.f : d2;
    return __fdiv_rn(1.f, __fadd_rn(1.f, __fsqrt_rn(d2)));
}

inline bool valid_sim(int sim) {
    return sim == SIM_COSINE || sim == SIM_DOT || sim == SIM_L2;
}

// 3. The slot axis. Every pass below scores S stacked planes of one shape
//    in one launch (a co-located fan-out's shards, ops/device_segment.py
//    MeshPlanePart): slot s's doc arrays start s * n_docs_pad rows in
//    ([S, N_pad, D] matrices and int8 mirrors, [S, N_pad] norms, scales and
//    masks), its per-query filter rows and its score plane s * n_q *
//    n_docs_pad cells in ([S, n_q, N_pad]), its candidates and outputs
//    s * n_q rows in; the queries and their norm terms are shared. The
//    slots ride grid z (the scores passes) or the row index (the re-rank),
//    so the doc tiles keep grid y to themselves. The one-shard families
//    pass one slot, and each slot of a mesh launch runs exactly the
//    one-shard arithmetic on its own plane: bitwise K5 / K6 / K7 there.

// 4. The scores pass shared by knn_flat (masked plane: -inf where the doc
//    is not allowed, or where the query's own filter row excludes it) and
//    knn_scores (dense row: 0 where the doc has no vector). One CTA scores
//    a tile of TILE docs of one slot against a group of QB
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

// grid (query groups, doc tiles, slots): plane[q, doc] for QB queries x
// TILE docs of one slot. DENSE: plane[doc] = mask[doc] ? similarity : 0
// (mask = exists); else plane[q, doc] = mask[doc] & qmask[q, doc] ?
// similarity : -inf (mask = allowed; qmask = the per-query filter rows
// [n_q, n_docs_pad] of the slot, nullptr when unfiltered). F32: the
// sharded kNN's l2_norm (sharded_common.cuh), whose JAX program takes its
// dot in f32: the operands stay f32 (no bf16 rounding), each product is
// rounded before it is added (__fmul_rn then __fadd_rn, never an FMA),
// and the transform's norm * norm + q2 is a product then an add, as that
// program's served (S, 1) layouts compute it.
template <int QB, bool DENSE, bool F32 = false>
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
    // this slot's plane
    const long long sd = (long long)blockIdx.z * n_docs_pad;
    const long long scell = sd * n_q;
    const float* __restrict__ mat = matrix + sd * dims;
    const float* __restrict__ nrm = norms + sd;
    const uint8_t* __restrict__ msk = mask + sd;
    const uint8_t* __restrict__ qmk = qmask == nullptr ? nullptr
                                                       : qmask + scell;
    float* __restrict__ out = plane + scell;
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
            if (dd < dn && g < n_docs_pad) {
                v = mat[g * dims + d0 + dd];
                if (!F32) v = bfr(v);
            }
            ms[dd][doc] = v;
        }
        for (int e = t; e < QB * SC_DT; e += SC_THREADS) {
            const int q = e / SC_DT, dd = e % SC_DT;
            float v = 0.f;
            if (dd < dn && q0 + q < n_q) {
                v = queries[(long long)(q0 + q) * dims + d0 + dd];
                if (!F32) v = bfr(v);
            }
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
                    acc[q][r] = F32 ? __fadd_rn(acc[q][r], __fmul_rn(qv, m[r]))
                                    : __fmaf_rn(qv, m[r], acc[q][r]);
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
            const bool ok = msk[doc] && (qmk == nullptr || qmk[cell]);
            out[cell] = ok ? similarity(acc[q][r], nrm[doc], qnv, q2v, sim,
                                        !F32)
                           : (DENSE ? 0.f : -INFINITY);
        }
    }
}

template <int QB, bool DENSE, bool F32 = false>
int launch_vector_scores(const float* matrix, const float* norms,
                         const uint8_t* mask, const uint8_t* qmask,
                         const float* queries,
                         const float* qn, const float* q2, int n_q, int dims,
                         long long n_docs_pad, int sim, float* plane,
                         cudaStream_t stream, int n_slots = 1) {
    const int groups = (n_q + QB - 1) / QB;
    const long long tiles = (n_docs_pad + SC_TILE - 1) / SC_TILE;
    for (long long tile0 = 0; tile0 < tiles; tile0 += SC_MAX_TILES_Y) {
        const long long nt =
            tiles - tile0 < SC_MAX_TILES_Y ? tiles - tile0 : SC_MAX_TILES_Y;
        vector_scores_kernel<QB, DENSE, F32>
            <<<dim3(groups, (unsigned)nt, n_slots), SC_THREADS, 0,
               stream>>>(matrix, norms, mask, qmask, queries, qn, q2, n_q,
                         dims, n_docs_pad, tile0, sim, plane);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

// The scores pass at any query count: the widest query group (QB) that
// the batch fills.
template <bool DENSE, bool F32 = false>
int vector_scores(const float* matrix, const float* norms,
                  const uint8_t* mask, const uint8_t* qmask,
                  const float* queries, const float* qn, const float* q2,
                  int n_q, int dims, long long n_docs_pad, int sim,
                  float* plane, cudaStream_t stream, int n_slots = 1) {
#define KNN_SCORES(QB)                                                   \
    launch_vector_scores<QB, DENSE, F32>(matrix, norms, mask, qmask,     \
                                         queries, qn, q2, n_q, dims,     \
                                         n_docs_pad, sim, plane, stream, \
                                         n_slots)
    if (n_q >= 16) return KNN_SCORES(16);
    if (n_q > 4) return KNN_SCORES(8);
    if (n_q > 2) return KNN_SCORES(4);
    if (n_q == 2) return KNN_SCORES(2);
    return KNN_SCORES(1);
#undef KNN_SCORES
}

// The knn_flat pipeline (K5, and mesh_knn_topk over S slots): the masked
// score plane [S, n_q, N_pad] of every slot, then the top-k of each of its
// S * n_q rows (topk_common.cuh plane_topk, the rounds above KMAX
// included). Column indices are each slot's own plane docs.
inline int flat_topk(const float* matrix, const float* norms,
                     const uint8_t* allowed, const uint8_t* masks,
                     const float* queries, const float* qn, const float* q2,
                     int n_slots, int n_q, int dims, long long n_docs_pad,
                     int k, int sim, float* plane, float* chunk_s,
                     int* chunk_i, float* out_s, int* out_d,
                     cudaStream_t stream) {
    if (n_slots < 1 || n_slots > 65535 || n_q < 1 ||
        (long long)n_slots * n_q > INT_MAX || dims < 1 || dims > MAX_DIMS ||
        k < 1 || n_docs_pad < k || !valid_sim(sim))
        return (int)cudaErrorInvalidValue;
    const int rc = vector_scores<false>(matrix, norms, allowed, masks,
                                        queries, qn, q2, n_q, dims,
                                        n_docs_pad, sim, plane, stream,
                                        n_slots);
    if (rc != 0) return rc;
    return plane_topk(plane, n_slots * n_q, n_docs_pad, k, chunk_s, chunk_i,
                      out_s, out_d, stream);
}

// 5. The int8 coarse pass (K6, and mesh_knn_coarse over S slots):
//    knn_flat's tiling over packed int8. A CTA scores 512 docs of one slot
//    against QB queries, staging 32 dims at a time as 8 words of 4 packed
//    int8 values; __dp4a adds four products at a time to int32 sums.
//    Integer sums are exact in any order, so kernel and plain version
//    agree bit for bit. The epilogue converts once (round to nearest),
//    rescales as dot * (qscale * scale), transforms and masks into the
//    [S, n_q, N_pad] f32 plane, whose rows plane_topk selects k' from.

constexpr int CO_THREADS = 128;
constexpr int CO_RD = 4;                      // docs per thread
constexpr int CO_TILE = CO_THREADS * CO_RD;   // docs per CTA
constexpr int CO_DW = 8;                      // packed words staged per step
constexpr int CO_DT = CO_DW * 4;              // dims staged per step

// Four int8 values of row ``row`` from dim ``d`` on, packed little-endian
// into one word; dims at or past ``dims`` are 0.
__device__ __forceinline__ int pack4(const int8_t* __restrict__ row, int d,
                                     int dims, bool aligned) {
    if (aligned && d + 4 <= dims)
        return *reinterpret_cast<const int*>(row + d);
    unsigned w = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
        if (d + b < dims) w |= (unsigned)(uint8_t)row[d + b] << (8 * b);
    return (int)w;
}

// grid (query groups, doc tiles, slots).
template <int QB>
__global__ void __launch_bounds__(CO_THREADS) coarse_scores_kernel(
    const int8_t* __restrict__ q8, const float* __restrict__ scales,
    const float* __restrict__ norms, const uint8_t* __restrict__ allowed,
    const uint8_t* __restrict__ masks, const int8_t* __restrict__ qq,
    const float* __restrict__ qscale, const float* __restrict__ qn,
    const float* __restrict__ q2, int n_q, int dims, long long n_docs_pad,
    long long tile0, int sim, float* __restrict__ plane) {
    __shared__ int ms[CO_DW][CO_TILE + 1];
    __shared__ int qs[QB][CO_DW];
    const int t = threadIdx.x;
    const int q0 = blockIdx.x * QB;
    const long long doc0 = (tile0 + blockIdx.y) * (long long)CO_TILE;
    const bool aligned = (dims & 3) == 0;
    // this slot's plane
    const long long sd = (long long)blockIdx.z * n_docs_pad;
    const long long scell = sd * n_q;
    const int8_t* __restrict__ m8 = q8 + sd * dims;
    const float* __restrict__ scl = scales + sd;
    const float* __restrict__ nrm = norms + sd;
    const uint8_t* __restrict__ alw = allowed + sd;
    const uint8_t* __restrict__ qmk = masks == nullptr ? nullptr
                                                       : masks + scell;
    float* __restrict__ out = plane + scell;
    int acc[QB][CO_RD];
#pragma unroll
    for (int q = 0; q < QB; ++q)
#pragma unroll
        for (int r = 0; r < CO_RD; ++r) acc[q][r] = 0;

    for (int d0 = 0; d0 < dims; d0 += CO_DT) {
        const int wn = (dims - d0 < CO_DT ? dims - d0 + 3 : CO_DT) / 4;
        for (int e = t; e < CO_TILE * CO_DW; e += CO_THREADS) {
            const int doc = e / CO_DW, w = e % CO_DW;
            const long long g = doc0 + doc;
            int v = 0;
            if (w < wn && g < n_docs_pad)
                v = pack4(m8 + g * dims, d0 + 4 * w, dims, aligned);
            ms[w][doc] = v;
        }
        for (int e = t; e < QB * CO_DW; e += CO_THREADS) {
            const int q = e / CO_DW, w = e % CO_DW;
            int v = 0;
            if (w < wn && q0 + q < n_q)
                v = pack4(qq + (long long)(q0 + q) * dims, d0 + 4 * w, dims,
                          aligned);
            qs[q][w] = v;
        }
        __syncthreads();
        for (int w = 0; w < wn; ++w) {
            int m[CO_RD];
#pragma unroll
            for (int r = 0; r < CO_RD; ++r) m[r] = ms[w][t + r * CO_THREADS];
#pragma unroll
            for (int q = 0; q < QB; ++q) {
                const int qv = qs[q][w];
#pragma unroll
                for (int r = 0; r < CO_RD; ++r)
                    acc[q][r] = __dp4a(qv, m[r], acc[q][r]);
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int q = 0; q < QB; ++q) {
        const int qi = q0 + q;
        if (qi >= n_q) break;
        const float qsc = qscale[qi], qnv = qn[qi], q2v = q2[qi];
#pragma unroll
        for (int r = 0; r < CO_RD; ++r) {
            const long long doc = doc0 + t + r * CO_THREADS;
            if (doc >= n_docs_pad) continue;
            const long long cell = (long long)qi * n_docs_pad + doc;
            float s = -INFINITY;
            if (alw[doc] && (qmk == nullptr || qmk[cell])) {
                const float dot = __fmul_rn(__int2float_rn(acc[q][r]),
                                            __fmul_rn(qsc, scl[doc]));
                s = similarity(dot, nrm[doc], qnv, q2v, sim);
            }
            out[cell] = s;
        }
    }
}

template <int QB>
int launch_coarse_scores(const int8_t* q8, const float* scales,
                         const float* norms, const uint8_t* allowed,
                         const uint8_t* masks, const int8_t* qq,
                         const float* qscale, const float* qn,
                         const float* q2, int n_slots, int n_q, int dims,
                         long long n_docs_pad, int sim, float* plane,
                         cudaStream_t stream) {
    const int groups = (n_q + QB - 1) / QB;
    const long long tiles = (n_docs_pad + CO_TILE - 1) / CO_TILE;
    for (long long tile0 = 0; tile0 < tiles; tile0 += SC_MAX_TILES_Y) {
        const long long nt =
            tiles - tile0 < SC_MAX_TILES_Y ? tiles - tile0 : SC_MAX_TILES_Y;
        coarse_scores_kernel<QB>
            <<<dim3(groups, (unsigned)nt, n_slots), CO_THREADS, 0,
               stream>>>(q8, scales, norms, allowed, masks, qq, qscale, qn,
                         q2, n_q, dims, n_docs_pad, tile0, sim, plane);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

// The knn_coarse pipeline (K6, and mesh_knn_coarse over S slots): the
// coarse plane of every slot, then the top-k' of each of its S * n_q rows.
inline int coarse_topk(const int8_t* q8, const float* scales,
                       const float* norms, const uint8_t* allowed,
                       const uint8_t* masks, const int8_t* qq,
                       const float* qscale, const float* qn, const float* q2,
                       int n_slots, int n_q, int dims, long long n_docs_pad,
                       int kprime, int sim, float* plane, float* chunk_s,
                       int* chunk_i, float* out_s, int* out_d,
                       cudaStream_t stream) {
    if (n_slots < 1 || n_slots > 65535 || n_q < 1 ||
        (long long)n_slots * n_q > INT_MAX || dims < 1 || dims > MAX_DIMS ||
        kprime < 1 || kprime > KMAX || n_docs_pad < kprime ||
        !valid_sim(sim))
        return (int)cudaErrorInvalidValue;
    int rc;
#define KNN_COARSE_SCORES(QB)                                             \
    launch_coarse_scores<QB>(q8, scales, norms, allowed, masks, qq,       \
                             qscale, qn, q2, n_slots, n_q, dims,          \
                             n_docs_pad, sim, plane, stream)
    if (n_q >= 16)
        rc = KNN_COARSE_SCORES(16);
    else if (n_q > 4)
        rc = KNN_COARSE_SCORES(8);
    else if (n_q > 2)
        rc = KNN_COARSE_SCORES(4);
    else if (n_q == 2)
        rc = KNN_COARSE_SCORES(2);
    else
        rc = KNN_COARSE_SCORES(1);
#undef KNN_COARSE_SCORES
    if (rc != 0) return rc;
    return plane_topk(plane, n_slots * n_q, n_docs_pad, kprime, chunk_s,
                      chunk_i, out_s, out_d, stream);
}

// 6. The exact re-rank (K7, and mesh_knn_rerank over S slots): one CTA per
//    row r = slot * n_q + q. The row's k' candidates are bitonic-sorted by
//    id in shared memory (their coarse scores carried), the bf16-rounded
//    query sits in shared memory, and each thread scores whole candidates
//    of the slot's matrix with knn_flat's arithmetic, reading the
//    candidate's row in dim order while the warp reads the same query dim
//    (a broadcast); masked to the slot's allowed docs (and its filter row
//    masks[r, cand]), the top-k over the candidates' positions by
//    cta_select -- after the sort, position order is doc-id order, so a tie
//    resolves to the lower doc as in knn_flat -- doc -1 where the score is
//    -inf, and eps = max |exact - coarse| over the candidates that are
//    allowed and whose coarse score is finite (0 when there are none).

constexpr int RR_THREADS = 256;

// grid (n_slots * n_q). Dynamic shared memory: qv[dims] | sd[kp2] |
// sc[kp2] | ex[kprime] | bs[cap] | bi[cap].
__global__ void __launch_bounds__(RR_THREADS) rerank_kernel(
    const float* __restrict__ matrix, const float* __restrict__ norms,
    const uint8_t* __restrict__ allowed, const uint8_t* __restrict__ masks,
    const float* __restrict__ queries, const float* __restrict__ qn,
    const float* __restrict__ q2, const int* __restrict__ cand,
    const float* __restrict__ coarse_s, int n_q, long long n_docs_pad,
    int dims, int kprime, int kp2, int k, int cap, int sim,
    float* __restrict__ out_s, int* __restrict__ out_d,
    float* __restrict__ eps) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* qv = (float*)smem_raw;
    int* sd = (int*)(qv + dims);
    float* sc = (float*)(sd + kp2);
    float* ex = sc + kp2;
    float* bs = ex + kprime;
    int* bi = (int*)(bs + cap);
    __shared__ SelShared sh;
    __shared__ int eps_bits;

    const long long r = blockIdx.x;         // output row
    const int q = (int)(r % n_q);
    const long long slot0 = (r / n_q) * n_docs_pad;
    const float* __restrict__ mat = matrix + slot0 * dims;
    const float* __restrict__ nrm = norms + slot0;
    const uint8_t* __restrict__ alw = allowed + slot0;
    const long long base = r * kprime;
    if (threadIdx.x == 0) eps_bits = 0;
    for (int d = threadIdx.x; d < dims; d += blockDim.x)
        qv[d] = bfr(queries[(long long)q * dims + d]);
    for (int j = threadIdx.x; j < kp2; j += blockDim.x) {
        sd[j] = j < kprime ? cand[base + j] : INT_MAX;
        sc[j] = j < kprime ? coarse_s[base + j] : -INFINITY;
    }
    __syncthreads();
    // ascending by doc id (candidates are distinct), coarse scores carried
    for (int size = 2; size <= kp2; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            for (int t = threadIdx.x; t < (kp2 >> 1); t += blockDim.x) {
                const int lo = 2 * t - (t & (stride - 1));
                const int hi = lo + stride;
                const bool up = (lo & size) == 0;
                if ((sd[lo] > sd[hi]) == up) {
                    const int d = sd[lo]; sd[lo] = sd[hi]; sd[hi] = d;
                    const float s = sc[lo]; sc[lo] = sc[hi]; sc[hi] = s;
                }
            }
            __syncthreads();
        }
    }

    const float qnv = qn[q], q2v = q2[q];
    float my_eps = 0.f;
    for (int j = threadIdx.x; j < kprime; j += blockDim.x) {
        const long long doc = sd[j];
        const float* row = mat + doc * dims;
        float acc = 0.f;
        for (int d = 0; d < dims; ++d)
            acc = __fmaf_rn(qv[d], bfr(row[d]), acc);
        const float s = similarity(acc, nrm[doc], qnv, q2v, sim);
        const bool ok = alw[doc] != 0 &&
                        (masks == nullptr || masks[r * n_docs_pad + doc] != 0);
        ex[j] = ok ? s : -INFINITY;
        const float c = sc[j];
        if (ok && isfinite(c)) {
            const float e = fabsf(__fsub_rn(s, c));
            my_eps = e > my_eps ? e : my_eps;
        }
    }
    // eps >= 0: the order of non-negative floats is the order of their bits
    atomicMax(&eps_bits, __float_as_int(my_eps));
    __syncthreads();

    auto load = [&](long long j, float& s, int& i) {
        s = ex[j];
        i = (int)j;
    };
    cta_select(load, kprime, k, cap, bs, bi, &sh);
    if (threadIdx.x == 0) eps[r] = __int_as_float(eps_bits);
    for (int o = threadIdx.x; o < k; o += blockDim.x) {
        const float s = bs[o];
        out_s[r * k + o] = s;
        out_d[r * k + o] = isfinite(s) ? sd[bi[o]] : -1;
    }
}

// The knn_rerank pipeline: one launch over every (slot, query) row.
inline int rerank_topk(const float* matrix, const float* norms,
                       const uint8_t* allowed, const uint8_t* masks,
                       const float* queries, const float* qn, const float* q2,
                       const int* cand, const float* coarse_s, int n_slots,
                       int n_q, long long n_docs_pad, int dims, int kprime,
                       int k, int sim, float* out_s, int* out_d, float* eps,
                       cudaStream_t stream) {
    if (n_slots < 1 || n_q < 1 || (long long)n_slots * n_q > INT_MAX ||
        n_docs_pad < 1 || dims < 1 || dims > MAX_DIMS || kprime < 1 ||
        kprime > KMAX || k < 1 || k > kprime || !valid_sim(sim))
        return (int)cudaErrorInvalidValue;
    int kp2 = 1;
    while (kp2 < kprime) kp2 <<= 1;
    const int cap = select_cap(k, RR_THREADS);
    const size_t smem = (size_t)dims * 4 + (size_t)kp2 * 8 +
                        (size_t)kprime * 4 + (size_t)cap * 8;
    cudaError_t err = set_smem((const void*)rerank_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    rerank_kernel<<<n_slots * n_q, RR_THREADS, smem, stream>>>(
        matrix, norms, allowed, masks, queries, qn, q2, cand, coarse_s, n_q,
        n_docs_pad, dims, kprime, kp2, k, cap, sim, out_s, out_d, eps);
    return (int)cudaGetLastError();
}

}  // namespace knn
