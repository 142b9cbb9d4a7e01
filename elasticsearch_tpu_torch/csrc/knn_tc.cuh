// The tensor-core kNN pipelines: knn_coarse (K6) and knn_flat (K5), and
// the mesh's mesh_knn_coarse and mesh_knn_topk, which run them for every
// slot of a stack of shards in one launch (knn_common.cuh section 3: slot
// s's docs start s * n_pad rows in, its rows of queries s * n_q rows in).
//
// 1. Scores on the tensor cores. Persistent CTAs (as many as fit) each
//    take tiles of 128 docs (two warpgroups of 64, the M side of wgmma)
//    against up to 64 queries (the N side, padded to 8, 16, 32 or 64),
//    staging 128-byte slices of each row in the 128-byte swizzle
//    (hopper.cuh), the dims past D zero-filled, the next slice in flight
//    while one is multiplied. K6 runs int8 wgmma with int32 sums over the
//    plane's int8 mirror, copied in with cp.async (16-byte chunks where D
//    is a multiple of 16); its integer sums are exact in any order, so the
//    epilogue (the old one: __int2float_rn, the rescale by qscale * scale,
//    the transform, the masks) gives the plain version's bits. K5 rounds
//    the f32 matrix and the queries to bf16 on their way through
//    registers, runs bf16 wgmma with f32 sums, and bounds each dot (the
//    screen below). The transform is similarity() with the similarity
//    fixed at compile time and its halving taken as a multiplication by
//    0.5 (the same bits).
// 2. Tile tops. The epilogue transposes the tile through shared memory,
//    writes each query's 128 scores to its plane row with coalesced
//    stores, and keeps the t largest of them (t a power of two, at least
//    2 and at least 2k / tiles, so that the tops of a row hold twice k; at
//    most 32, else every row is selected whole) in a [rows, tiles, t]
//    array. The k-th largest of a row's tile tops, tau, is never above the
//    row's k-th largest score: it stands for k distinct docs scoring at
//    least tau.
// 3. Selection (rows_select.cuh, one cooperative launch each): tau of every
//    row from its tile tops; the list pass then reads only the tiles whose
//    largest value reaches tau and appends every doc of those that reaches
//    it (at most ``cap`` a row); the final selection takes the best k of
//    each row's list under (score desc, index asc). Every doc of the true
//    top k (ties at the k-th score included) scores at least tau, so the
//    list holds them all. A row whose tau is -inf (fewer than k finite
//    tops: a filter leaving fewer than k docs, a padded all-false row) or
//    whose list overflowed (2k + 2,048 entries; a zero query ties every
//    doc) is selected over its whole plane row instead, counted in
//    ``full``. One memset a call clears the list counts and both
//    selections' states.
// 4. K5's screen and re-score. The plain dot sums the exact products p_d
//    of the bf16-rounded operands in f32, in dimension order, rounding once
//    a step: |dot_plain - sum p| <= gamma_p * sum |p|, gamma_p = D 2^-24 /
//    (1 - D 2^-24). The tensor cores align each group's products to the
//    largest exponent and truncate: |dot_tc - sum p| <= gamma_tc * sum |p|
//    with gamma_tc = 2 D 2^-23, and may flush products below f32's normal
//    range, at most D 2^-126 <= 2^-114 in all. By Cauchy-Schwarz sum |p| <=
//    |x^| |q^|, so
//        |dot_tc - dot_plain| <= gamma |x^| |q^| + 2^-114,
//        gamma = 5 D 2^-24 (1 + 2^-8)
//    (D padded to a multiple of 64; ivf_assign.cu's derivation). |x^| and
//    |q^| are computed while staging, from the bf16 values: an f32 sum of
//    squares (positive terms, within D 2^-24 <= 2^-12 of the exact sum in
//    any order), its root inflated by 2^-10. The screen takes
//        e = fma(fl(|x^| |q^|), gamma (1 + 2^-8), 2^-100)  >= the bound
//    (the factor 1 + 2^-8 covers the two roundings of e), and
//        lo = T(fl(dot_tc - e)),  hi = T(fl(dot_tc + e)),
//    T = similarity() for the doc and query, -inf at both ends where the
//    doc is masked. dot_tc - e <= dot_plain <= dot_tc + e, rounding is
//    monotone and dot_plain is an f32, so fl(dot_tc - e) <= dot_plain <=
//    fl(dot_tc + e); every transform is nondecreasing in dot for a fixed
//    doc and query (cosine's denominator norm * qn + 1e-30 is positive,
//    l2's clamp and root are monotone) and every op is correctly rounded,
//    hence lo <= T(dot_plain) <= hi bit for bit. The tile tops are taken
//    over lo and the plane holds hi, so tau <= L_k, the row's k-th largest
//    lower bound: at least k docs have lo >= tau, so the exact k-th score
//    is >= tau, and every exact winner, a tied lower-index one included,
//    has hi >= tau and is listed. The listed docs are re-scored with
//    knn_flat's arithmetic (__fmaf_rn over the bf16 operands in dimension
//    order, as knn_common.cuh's rerank_kernel), and a row that took the
//    exact branch (section 3) is scored that way over every doc it
//    allows. chip_smoke.py measures max |dot_tc - dot_plain| / (|x^| |q^|)
//    on the card and fails unless it stays under gamma.
// The plain PyTorch versions are ops/knn.py knn_flat_plain and
// knn_coarse_plain; ops/knn.py screen_* and tile_threshold mirror the
// screen and the threshold on the CPU.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "knn_common.cuh"
#include "rows_select.cuh"

namespace knntc {

using knn::bfr;
using knn::MAX_DIMS;
using knn::similarity;
using knn::valid_sim;

constexpr int BM = 128;          // docs a CTA: one tile
constexpr int THREADS = 256;     // two warpgroups of 64 docs
constexpr int RB = 128;          // bytes of a row a stage
constexpr int LD = BM + 4;       // the epilogue's transposed tile, a row
constexpr int TOPS_MAX = 32;     // most tile tops a (row, tile)
constexpr int LIST_TILES = 256;  // tiles a CTA of the list pass
constexpr int EX_DOCS = 4096;    // docs a CTA of the exact branch
constexpr unsigned FULL = 0xffffffffu;
constexpr float SLACK = 7.888609052210118e-31f;   // 2^-100
constexpr float NORM_UP = 1.f + 0.0009765625f;    // 1 + 2^-10
constexpr int EMIT_NQ = 2;       // queries a warp's tops interleave
constexpr int COARSE_RING = 2;   // K6's cp.async stages

// Byte offset of 16-byte chunk q of row r in a tile of 128-byte rows with
// the 128-byte swizzle.
__device__ __forceinline__ int swz(int r, int q) {
    return r * RB + ((q ^ (r & 7)) << 4);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
    const uint32_t a = hopper::smem_addr(p);
    return p + ((1024 - (a & 1023)) & 1023);
}

template <class T, int N>
__device__ __forceinline__ void fence_operands(T (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// knn_common.cuh's similarity() for a similarity known at compile time,
// each division by 2 taken as the multiplication by 0.5 that gives the
// same bits (both round the one value x / 2).
template <int SIM>
__device__ __forceinline__ float similarity_k(float dot, float norm, float qn,
                                              float q2) {
    if (SIM == knn::SIM_DOT) return __fadd_rn(0.5f, __fmul_rn(dot, 0.5f));
    if (SIM == knn::SIM_COSINE)
        return __fmul_rn(
            __fadd_rn(1.f, __fdiv_rn(dot, __fadd_rn(__fmul_rn(norm, qn),
                                                    1e-30f))),
            0.5f);
    return similarity(dot, norm, qn, q2, knn::SIM_L2);
}

// The t <= 2 largest of each query's 128 values in the transposed tile S,
// largest first, to tops[(row * n_tiles + tile) * stride + i]: THREADS /
// BN threads a query each scan a segment of 128 * BN / THREADS docs
// (rotated by the segment so that a warp's loads fall in distinct banks)
// keeping the two largest, then merge them with shuffles.
template <int BN>
__device__ __forceinline__ void seg_tops(const float* S, int q0, int n_q,
                                         long long row0, long long tile,
                                         long long n_tiles, int t,
                                         int stride, float* tops) {
    constexpr int SEGS = THREADS / BN;
    constexpr int SEG = BM / SEGS;
    const int c = threadIdx.x / SEGS, seg = threadIdx.x % SEGS;
    float a = -INFINITY, b = -INFINITY;      // a >= b
#pragma unroll 8
    for (int i = 0; i < SEG; ++i) {
        const float v = S[c * LD + seg * SEG + (i + seg) % SEG];
        b = fmaxf(b, fminf(a, v));
        a = fmaxf(a, v);
    }
#pragma unroll
    for (int o = 1; o < SEGS; o <<= 1) {
        const float a2 = __shfl_xor_sync(FULL, a, o);
        const float b2 = __shfl_xor_sync(FULL, b, o);
        b = fmaxf(fminf(a, a2), fmaxf(b, b2));
        a = fmaxf(a, a2);
    }
    if (seg == 0 && q0 + c < n_q) {
        float* out = tops + ((row0 + q0 + c) * n_tiles + tile) * stride;
        out[0] = a;
        if (t == 2) out[1] = b;
    }
}

// Warp w takes the queries c = w + 8 q of the transposed tile S, NQ at a
// time: each query's 128 values go to its plane row (when ``plane`` is
// set), and its t largest, largest first, to tops[(row * n_tiles + tile)
// * stride + i] -- a value is taken once however often it occurs. The NQ
// queries' shuffle chains are independent, so they overlap.
template <int BN>
__device__ __forceinline__ void emit_tile(const float* S, int q0, int n_q,
                                          long long row0, long long n_pad,
                                          long long doc0, long long tile,
                                          long long n_tiles, int t,
                                          int stride, float* plane,
                                          float* tops) {
    constexpr int NQ = BN / 8 < EMIT_NQ ? BN / 8 : EMIT_NQ;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int c0 = warp; c0 < BN; c0 += 8 * NQ) {
        float v[NQ][4];
#pragma unroll
        for (int q = 0; q < NQ; ++q)
#pragma unroll
            for (int i = 0; i < 4; ++i)
                v[q][i] = S[(c0 + 8 * q) * LD + lane + 32 * i];
        if (plane != nullptr) {
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
                const int qi = q0 + c0 + 8 * q;
                if (qi >= n_q) continue;
                float* prow = plane + (row0 + qi) * n_pad + doc0;
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    if (doc0 + lane + 32 * i < n_pad)
                        prow[lane + 32 * i] = v[q][i];
            }
        }
        for (int i = 0; i < t; ++i) {
            float b[NQ];
#pragma unroll
            for (int q = 0; q < NQ; ++q)
                b[q] = fmaxf(fmaxf(v[q][0], v[q][1]), fmaxf(v[q][2], v[q][3]));
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
#pragma unroll
                for (int q = 0; q < NQ; ++q)
                    b[q] = fmaxf(b[q], __shfl_xor_sync(FULL, b[q], o));
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
                const bool mine = v[q][0] == b[q] || v[q][1] == b[q] ||
                                  v[q][2] == b[q] || v[q][3] == b[q];
                const unsigned has = __ballot_sync(FULL, mine);
                if (has != 0u && lane == __ffs(has) - 1) {
                    if (v[q][0] == b[q]) v[q][0] = -INFINITY;
                    else if (v[q][1] == b[q]) v[q][1] = -INFINITY;
                    else if (v[q][2] == b[q]) v[q][2] = -INFINITY;
                    else v[q][3] = -INFINITY;
                }
                const int qi = q0 + c0 + 8 * q;
                if (lane == 0 && qi < n_q)
                    tops[((row0 + qi) * n_tiles + tile) * stride + i] = b[q];
            }
        }
    }
}

// ---------------------------------------------------------------------------
// the scores passes: persistent CTAs over (tile, 128-byte slice) steps
// ---------------------------------------------------------------------------

// A CTA of grid x = G takes tiles blockIdx.x, blockIdx.x + G, ... of its
// (query tile, slot), each in kbs steps of one 128-byte slice of the rows;
// step j + 1's operands are in flight while step j is multiplied and, at
// a tile's last slice, its epilogue runs.
struct Steps {
    long long first, stride, n_tiles;
    int kbs;
    __device__ long long count() const {
        if (first >= n_tiles) return 0;
        return ((n_tiles - 1 - first) / stride + 1) * kbs;
    }
    __device__ long long tile(long long j) const {
        return first + (j / kbs) * stride;
    }
    __device__ int kb(long long j) const { return (int)(j % kbs); }
};

// The per-query values of a query tile, staged once a CTA.
struct QueryTerms {
    float a[64], qn[64], q2[64];
};

// ---------------------------------------------------------------------------
// K6: int8 scores
// ---------------------------------------------------------------------------

template <int BN>
__host__ __device__ constexpr int coarse_stage_bytes() {
    return BM * RB + BN * RB;
}

// the ring of stages, the transposed tile, the query terms, alignment
// slack
template <int BN>
__host__ __device__ constexpr int coarse_smem() {
    return COARSE_RING * coarse_stage_bytes<BN>() + BN * LD * 4 +
           (int)sizeof(QueryTerms) + 1024;
}

// grid (CTAs, query tiles, slots). plane [S * n_q, n_pad] f32: the masked
// coarse scores; tops [S * n_q, n_tiles, t].
template <int BN>
__global__ void __launch_bounds__(THREADS) coarse_kernel(
    const int8_t* __restrict__ q8, const float* __restrict__ scales,
    const float* __restrict__ norms, const uint8_t* __restrict__ allowed,
    const uint8_t* __restrict__ masks, const int8_t* __restrict__ qq,
    const float* __restrict__ qscale, const float* __restrict__ qn,
    const float* __restrict__ q2, int n_q, int dims, long long n_pad,
    int sim, int kbs, int aligned, long long n_tiles, int t,
    float* __restrict__ plane, float* __restrict__ tops) {
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    unsigned char* sm = align1024(smem_raw);
    constexpr int A_BYTES = BM * RB;
    constexpr int STAGE = coarse_stage_bytes<BN>();
    constexpr int RING = COARSE_RING;
    float* S = (float*)(sm + RING * STAGE);
    QueryTerms* qt = (QueryTerms*)(S + BN * LD);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int wg = warp >> 2;
    const int q0 = blockIdx.y * BN;
    const long long sd = (long long)blockIdx.z * n_pad;
    const long long row0 = (long long)blockIdx.z * n_q;
    const int8_t* __restrict__ m8 = q8 + sd * dims;
    const Steps st{blockIdx.x, gridDim.x, n_tiles, kbs};
    const long long steps = st.count();
    for (int c = tid; c < BN; c += THREADS) {
        const bool ok = q0 + c < n_q;
        qt->a[c] = ok ? qscale[q0 + c] : 0.f;
        qt->qn[c] = ok ? qn[q0 + c] : 0.f;
        qt->q2[c] = ok ? q2[q0 + c] : 0.f;
    }

    auto load = [&](long long j) {
        unsigned char* base = sm + (j % RING) * STAGE;
        const long long doc0 = st.tile(j) * BM;
        const int d0 = st.kb(j) * RB;
        for (int c = tid; c < (BM + BN) * 8; c += THREADS) {
            const int row = c >> 3, q = c & 7, d = d0 + q * 16;
            const bool is_a = row < BM;
            const int rr = is_a ? row : row - BM;
            const long long g = is_a ? doc0 + rr : (long long)(q0 + rr);
            const bool ok = is_a ? g < n_pad : g < n_q;
            const int8_t* src = (is_a ? m8 : qq) + (ok ? g : 0) * dims;
            unsigned char* dst = base + (is_a ? 0 : A_BYTES) + swz(rr, q);
            if (aligned) {
                const int nb = ok && d < dims ? 16 : 0;
                hopper::cp_async16(hopper::smem_addr(dst), src + (nb ? d : 0),
                                   nb);
            } else {
                uint32_t w[4] = {0u, 0u, 0u, 0u};
                if (ok)
                    for (int b = 0; b < 16 && d + b < dims; ++b)
                        w[b >> 2] |= (uint32_t)(uint8_t)src[d + b]
                                     << (8 * (b & 3));
                *(uint4*)dst = make_uint4(w[0], w[1], w[2], w[3]);
            }
        }
    };

    int acc[BN / 2];
    const int r0 = wg * 64 + (warp & 3) * 16 + (lane >> 2);
    // RING - 1 steps ahead in flight; every step commits one group (empty
    // past the last step), so waiting for all but the newest RING - 1
    // groups completes this step's
    for (int p = 0; p < RING - 1; ++p) {
        if (p < steps) load(p);
        hopper::cp_async_commit();
    }
    for (long long j = 0; j < steps; ++j) {
        if (j + RING - 1 < steps) load(j + RING - 1);
        hopper::cp_async_commit();
        hopper::cp_async_wait<RING - 1>();
        hopper::fence_async_shared();
        __syncthreads();
        const int kb = st.kb(j);
        if (kb == 0) {
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
        }
        const uint32_t a = hopper::smem_addr(sm + (j % RING) * STAGE) +
                           wg * 64 * RB;
        const uint32_t b =
            hopper::smem_addr(sm + (j % RING) * STAGE + A_BYTES);
        fence_operands(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < RB / 32; ++ks)
            hopper::Wgmma<BN>::s8(acc, hopper::sw128_desc(a + 32 * ks),
                                  hopper::sw128_desc(b + 32 * ks));
        hopper::wgmma_commit();
        hopper::wgmma_wait_all();
        fence_operands(acc);
        if (kb == kbs - 1) {
            // sum i: doc r0 (+ 8 when i % 4 >= 2), query 8 (i / 4) +
            // 2 (lane % 4) + i % 2; the masked scores go through S,
            // transposed
            const long long tile = st.tile(j), doc0 = tile * BM;
            // one copy of the cell loop per similarity, so that no cell
            // evaluates the transforms it does not use
            auto cells = [&](auto simc) {
                constexpr int SIMK = decltype(simc)::value;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int r = r0 + 8 * h;
                    const long long doc = doc0 + r;
                    const bool live = doc < n_pad && allowed[sd + doc];
                    const float sc = live ? scales[sd + doc] : 0.f;
                    const float nr = live ? norms[sd + doc] : 0.f;
#pragma unroll
                    for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const int c = 8 * jj + 2 * (lane & 3) + e;
                            const int qi = q0 + c;
                            float s = -INFINITY;
                            if (live && qi < n_q &&
                                (masks == nullptr ||
                                 masks[(row0 + qi) * n_pad + doc] != 0)) {
                                const float dot = __fmul_rn(
                                    __int2float_rn(acc[4 * jj + 2 * h + e]),
                                    __fmul_rn(qt->a[c], sc));
                                s = similarity_k<SIMK>(dot, nr, qt->qn[c],
                                                       qt->q2[c]);
                            }
                            S[c * LD + r] = s;
                        }
                }
            };
            if (sim == knn::SIM_COSINE)
                cells(std::integral_constant<int, knn::SIM_COSINE>{});
            else if (sim == knn::SIM_DOT)
                cells(std::integral_constant<int, knn::SIM_DOT>{});
            else
                cells(std::integral_constant<int, knn::SIM_L2>{});
            __syncthreads();
            const bool few = t <= 2;
            emit_tile<BN>(S, q0, n_q, row0, n_pad, doc0, tile, n_tiles,
                          few ? 0 : t, t, plane, tops);
            if (few)
                seg_tops<BN>(S, q0, n_q, row0, tile, n_tiles, t, t, tops);
        }
        __syncthreads();              // the stage and S are free again
    }
}

// ---------------------------------------------------------------------------
// K5: the bf16 screen
// ---------------------------------------------------------------------------

// the stage, the transposed upper and lower bounds, the doc norms, the
// query terms, alignment slack
template <int BN>
__host__ __device__ constexpr int screen_smem() {
    return BM * RB + BN * RB + 2 * BN * LD * 4 + BM * 4 +
           (int)sizeof(QueryTerms) + 1024;
}

// Eight f32 values (``f``), rounded to bf16 and packed; ss += the sum of
// their squares.
__device__ __forceinline__ uint4 bf16_pack(const float4 (&f)[2], float& ss) {
    const float v[8] = {f[0].x, f[0].y, f[0].z, f[0].w,
                        f[1].x, f[1].y, f[1].z, f[1].w};
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
        const float2 x = __bfloat1622float2(p);
        ss = fmaf(x.x, x.x, ss);
        ss = fmaf(x.y, x.y, ss);
        w[e] = *(const uint32_t*)&p;
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
}

// Eight f32 values of ``src`` from dim d (0 at or past ``dims``, or for
// a row that is not there).
__device__ __forceinline__ void load8(const float* __restrict__ src, bool ok,
                                      int d, int dims, bool vec,
                                      float4 (&f)[2]) {
    if (ok && vec && d + 8 <= dims) {
        f[0] = __ldg((const float4*)(src + d));
        f[1] = __ldg((const float4*)(src + d + 4));
        return;
    }
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = ok && d + e < dims ? src[d + e] : 0.f;
    f[0] = make_float4(v[0], v[1], v[2], v[3]);
    f[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// One warp a query: qnh[q] = |q^| (the bf16-rounded query's norm),
// inflated by 2^-10.
__global__ void qnorm_kernel(const float* __restrict__ queries, int n_q,
                             int dims, float* __restrict__ qnh) {
    const long long q = (long long)blockIdx.x * (blockDim.x >> 5) +
                        (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (q >= n_q) return;
    float ss = 0.f;
    for (int d = lane; d < dims; d += 32) {
        const float b = bfr(queries[q * dims + d]);
        ss = fmaf(b, b, ss);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(FULL, ss, o);
    if (lane == 0) qnh[q] = sqrtf(ss) * NORM_UP;
}

// grid (CTAs, query tiles, slots). hi [S * n_q, n_pad]: the upper bounds;
// thi [S * n_q, n_tiles]: each tile's largest; tops [S * n_q, n_tiles, t]:
// the t largest lower bounds of each tile; probe (may be null): the raw
// tensor-core dots [S * n_q, n_pad]. The docs are staged through
// registers (rounded to bf16 on the way), so one stage in shared memory
// serves: step j + 1's loads are issued before step j's product; the
// queries (a few KB, read from L2) are staged at each step. Two CTAs a SM
// (a ring of f32 slices in shared memory, filled by cp.async, left room
// for one, and ran 1.4x slower).
template <int BN>
__global__ void __launch_bounds__(THREADS, 2) screen_kernel(
    const float* __restrict__ matrix, const float* __restrict__ norms,
    const uint8_t* __restrict__ allowed, const uint8_t* __restrict__ masks,
    const float* __restrict__ queries, const float* __restrict__ qn,
    const float* __restrict__ q2, const float* __restrict__ qnh, int n_q,
    int dims, long long n_pad, int sim, int kbs, int vec, float g1,
    long long n_tiles, int t, float* __restrict__ hi,
    float* __restrict__ thi, float* __restrict__ tops,
    float* __restrict__ probe) {
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    unsigned char* sm = align1024(smem_raw);
    constexpr int A_BYTES = BM * RB;
    constexpr int QCH = (BN * 8 + THREADS - 1) / THREADS;  // query chunks
    unsigned char* stage = sm;
    float* S = (float*)(stage + A_BYTES + BN * RB);     // upper bounds
    float* S2 = S + BN * LD;                            // lower bounds
    float* xn_s = S2 + BN * LD;
    QueryTerms* qt = (QueryTerms*)(xn_s + BM);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int wg = warp >> 2;
    const int q0 = blockIdx.y * BN;
    const long long sd = (long long)blockIdx.z * n_pad;
    const long long row0 = (long long)blockIdx.z * n_q;
    const float* __restrict__ mat = matrix + sd * dims;
    const Steps st{blockIdx.x, gridDim.x, n_tiles, kbs};
    const long long steps = st.count();
    for (int c = tid; c < BN; c += THREADS) {
        const bool ok = q0 + c < n_q;
        qt->a[c] = ok ? qnh[q0 + c] : 0.f;
        qt->qn[c] = ok ? qn[q0 + c] : 0.f;
        qt->q2[c] = ok ? q2[q0 + c] : 0.f;
    }

    // thread tid stages chunk tid % 8 (eight dims) of docs tid / 8 + 32 i
    // and of queries (tid + THREADS i) / 8
    float4 fa[4][2];
    auto load = [&](long long j) {
        const long long doc0 = st.tile(j) * BM;
        const int d = st.kb(j) * 64 + (tid & 7) * 8;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const long long g = doc0 + (tid >> 3) + 32 * i;
            load8(mat + (g < n_pad ? g : 0) * dims, g < n_pad, d, dims, vec,
                  fa[i]);
        }
    };

    float ss[4] = {0.f, 0.f, 0.f, 0.f};
    float acc[BN / 2];
    const int r0 = wg * 64 + (warp & 3) * 16 + (lane >> 2);
    if (steps > 0) load(0);
    for (long long j = 0; j < steps; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
            *(uint4*)(stage + swz((tid >> 3) + 32 * i, tid & 7)) =
                bf16_pack(fa[i], ss[i]);
#pragma unroll
        for (int i = 0; i < QCH; ++i) {
            const int c = tid + THREADS * i;
            if (c < BN * 8) {
                const int qi = q0 + (c >> 3);
                float4 fq[2];
                float unused = 0.f;
                load8(queries + (long long)(qi < n_q ? qi : 0) * dims,
                      qi < n_q, st.kb(j) * 64 + (c & 7) * 8, dims, vec, fq);
                *(uint4*)(stage + A_BYTES + swz(c >> 3, c & 7)) =
                    bf16_pack(fq, unused);
            }
        }
        hopper::fence_async_shared();
        __syncthreads();
        if (j + 1 < steps) load(j + 1);   // in flight during the product
        const int kb = st.kb(j);
        if (kb == 0) {
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
        }
        const uint32_t a = hopper::smem_addr(stage) + wg * 64 * RB;
        const uint32_t b = hopper::smem_addr(stage + A_BYTES);
        fence_operands(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < RB / 32; ++ks)
            hopper::Wgmma<BN>::bf16(acc, hopper::sw128_desc(a + 32 * ks),
                                    hopper::sw128_desc(b + 32 * ks));
        hopper::wgmma_commit();
        hopper::wgmma_wait_all();
        fence_operands(acc);
        if (kb == kbs - 1) {
            // |x^| of the tile's docs: a doc's eight threads are lanes 8m
            // .. 8m + 7
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                float v = ss[i];
                v += __shfl_xor_sync(FULL, v, 1);
                v += __shfl_xor_sync(FULL, v, 2);
                v += __shfl_xor_sync(FULL, v, 4);
                if ((tid & 7) == 0)
                    xn_s[(tid >> 3) + 32 * i] = sqrtf(v) * NORM_UP;
                ss[i] = 0.f;
            }
            __syncthreads();
            const long long tile = st.tile(j), doc0 = tile * BM;
            // one copy of the cell loop per similarity (as in coarse_kernel)
            auto cells = [&](auto simc) {
                constexpr int SIMK = decltype(simc)::value;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int r = r0 + 8 * h;
                    const long long doc = doc0 + r;
                    const bool live = doc < n_pad && allowed[sd + doc];
                    const float nr = live ? norms[sd + doc] : 0.f;
                    const float xr = xn_s[r];
#pragma unroll
                    for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const int c = 8 * jj + 2 * (lane & 3) + e;
                            const int qi = q0 + c;
                            const int i = 4 * jj + 2 * h + e;
                            const float v = acc[i];
                            if (probe != nullptr && qi < n_q && doc < n_pad)
                                probe[(row0 + qi) * n_pad + doc] = v;
                            float lo = -INFINITY, up = -INFINITY;
                            if (live && qi < n_q &&
                                (masks == nullptr ||
                                 masks[(row0 + qi) * n_pad + doc] != 0)) {
                                const float eb = fmaf(
                                    __fmul_rn(xr, qt->a[c]), g1, SLACK);
                                up = similarity_k<SIMK>(__fadd_rn(v, eb), nr,
                                                        qt->qn[c], qt->q2[c]);
                                lo = similarity_k<SIMK>(__fsub_rn(v, eb), nr,
                                                        qt->qn[c], qt->q2[c]);
                            }
                            S[c * LD + r] = up;
                            S2[c * LD + r] = lo;
                        }
                }
            };
            if (sim == knn::SIM_COSINE)
                cells(std::integral_constant<int, knn::SIM_COSINE>{});
            else if (sim == knn::SIM_DOT)
                cells(std::integral_constant<int, knn::SIM_DOT>{});
            else
                cells(std::integral_constant<int, knn::SIM_L2>{});
            __syncthreads();
            emit_tile<BN>(S, q0, n_q, row0, n_pad, doc0, tile, n_tiles, 0, 1,
                          hi, thi);
            seg_tops<BN>(S, q0, n_q, row0, tile, n_tiles, 1, 1, thi);
            if (t <= 2)
                seg_tops<BN>(S2, q0, n_q, row0, tile, n_tiles, t, t, tops);
            else
                emit_tile<BN>(S2, q0, n_q, row0, n_pad, doc0, tile, n_tiles,
                              t, t, nullptr, tops);
        }
        __syncthreads();              // the stage and S are free again
    }
}

// ---------------------------------------------------------------------------
// the list pass, the re-score, the exact branch
// ---------------------------------------------------------------------------

__global__ void fill_kernel(float* __restrict__ p, long long n, float v) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) p[i] = v;
}

__device__ __forceinline__ bool screened(const float* tau, const int* cnt,
                                         long long r, int cap) {
    return tau[r] > -INFINITY && cnt[r] <= cap;
}

// grid (ceil(n_tiles / LIST_TILES), rows). Each warp reads the largest
// values of 32 tiles at once (tmax[(r * n_tiles + tile) * stride]); every
// tile whose largest reaches tau[r] then has each doc that reaches it
// appended to row r's list (at most cap are kept; cnt[r] counts them all).
__global__ void __launch_bounds__(THREADS) list_kernel(
    const float* __restrict__ plane, const float* __restrict__ tmax,
    int stride, const float* __restrict__ tau, long long n_pad,
    long long n_tiles, int cap, int* __restrict__ cnt,
    int* __restrict__ cand_d, float* __restrict__ cand_s) {
    const long long r = blockIdx.y;
    const float th = tau[r];
    if (!(th > -INFINITY)) return;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    long long end = ((long long)blockIdx.x + 1) * LIST_TILES;
    if (end > n_tiles) end = n_tiles;
    for (long long t0 = (long long)blockIdx.x * LIST_TILES + 32 * warp;
         t0 < end; t0 += 32 * (THREADS / 32)) {
        const long long mine = t0 + lane;
        const bool hit =
            mine < end && tmax[(r * n_tiles + mine) * stride] >= th;
        unsigned tiles = __ballot_sync(FULL, hit);
        while (tiles != 0u) {
            const long long tile = t0 + __ffs(tiles) - 1;
            tiles &= tiles - 1u;
            float v[4];
            unsigned b[4];
            int n = 0;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const long long doc = tile * BM + lane + 32 * i;
                v[i] = doc < n_pad ? plane[r * n_pad + doc] : -INFINITY;
                b[i] = __ballot_sync(FULL, v[i] >= th);
                n += __popc(b[i]);
            }
            int pos = 0;                  // one atomic a tile
            if (lane == 0) pos = atomicAdd(&cnt[r], n);
            pos = __shfl_sync(FULL, pos, 0);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int p = pos + __popc(b[i] & ((1u << lane) - 1u));
                if (v[i] >= th && p < cap) {
                    cand_d[r * cap + p] = (int)(tile * BM + lane + 32 * i);
                    if (cand_s != nullptr) cand_s[r * cap + p] = v[i];
                }
                pos += __popc(b[i]);
            }
        }
    }
}

// The exact score of doc ``doc`` of slot offset ``sd`` for query row r
// (knn_flat's arithmetic; -inf where it is masked); qv: the bf16-rounded
// query.
__device__ __forceinline__ float exact_score(
    const float* __restrict__ matrix, const float* __restrict__ norms,
    const uint8_t* __restrict__ allowed, const uint8_t* __restrict__ masks,
    const float* qv, float qnv, float q2v, int dims, long long n_pad,
    long long sd, long long r, long long doc, int sim) {
    if (!allowed[sd + doc] ||
        (masks != nullptr && masks[r * n_pad + doc] == 0))
        return -INFINITY;
    const float* row = matrix + (sd + doc) * dims;
    float acc = 0.f;
    int d = 0;
    if (((uintptr_t)row & 15) == 0) {  // four dims a load, in order
        for (; d + 4 <= dims; d += 4) {
            const float4 x = __ldg((const float4*)(row + d));
            acc = __fmaf_rn(qv[d], bfr(x.x), acc);
            acc = __fmaf_rn(qv[d + 1], bfr(x.y), acc);
            acc = __fmaf_rn(qv[d + 2], bfr(x.z), acc);
            acc = __fmaf_rn(qv[d + 3], bfr(x.w), acc);
        }
    }
    for (; d < dims; ++d) acc = __fmaf_rn(qv[d], bfr(row[d]), acc);
    return similarity(acc, norms[sd + doc], qnv, q2v, sim);
}

__device__ __forceinline__ void stage_query(const float* __restrict__ queries,
                                            int q, int dims, float* qv) {
    for (int d = threadIdx.x; d < dims; d += blockDim.x)
        qv[d] = bfr(queries[(long long)q * dims + d]);
    __syncthreads();
}

// grid (ceil(cap / THREADS), rows), dims floats of dynamic shared memory:
// the exact score of every listed doc of a screened row.
__global__ void __launch_bounds__(THREADS) rescore_kernel(
    const float* __restrict__ matrix, const float* __restrict__ norms,
    const uint8_t* __restrict__ allowed, const uint8_t* __restrict__ masks,
    const float* __restrict__ queries, const float* __restrict__ qn,
    const float* __restrict__ q2, int n_q, int dims, long long n_pad,
    int sim, const float* __restrict__ tau, const int* __restrict__ cnt,
    int cap, const int* __restrict__ cand_d, float* __restrict__ cand_s) {
    extern __shared__ float qv[];
    const long long r = blockIdx.y;
    if (!screened(tau, cnt, r, cap)) return;
    const long long j0 = (long long)blockIdx.x * THREADS;
    const int m = cnt[r];
    if (j0 >= m) return;
    const int q = (int)(r % n_q);
    stage_query(queries, q, dims, qv);
    const long long j = j0 + threadIdx.x;
    if (j >= m) return;
    cand_s[r * cap + j] =
        exact_score(matrix, norms, allowed, masks, qv, qn[q], q2[q], dims,
                    n_pad, (r / n_q) * n_pad, r, cand_d[r * cap + j], sim);
}

// grid (ceil(n_pad / EX_DOCS), rows): the exact branch, every doc of a
// row the screen could not decide, into its plane row.
__global__ void __launch_bounds__(THREADS) exact_kernel(
    const float* __restrict__ matrix, const float* __restrict__ norms,
    const uint8_t* __restrict__ allowed, const uint8_t* __restrict__ masks,
    const float* __restrict__ queries, const float* __restrict__ qn,
    const float* __restrict__ q2, int n_q, int dims, long long n_pad,
    int sim, const float* __restrict__ tau, const int* __restrict__ cnt,
    int cap, float* __restrict__ plane) {
    extern __shared__ float qv[];
    const long long r = blockIdx.y;
    if (screened(tau, cnt, r, cap)) return;
    const int q = (int)(r % n_q);
    stage_query(queries, q, dims, qv);
    const long long sd = (r / n_q) * n_pad;
    long long end = ((long long)blockIdx.x + 1) * EX_DOCS;
    if (end > n_pad) end = n_pad;
    for (long long doc = (long long)blockIdx.x * EX_DOCS + threadIdx.x;
         doc < end; doc += THREADS)
        plane[r * n_pad + doc] =
            exact_score(matrix, norms, allowed, masks, qv, qn[q], q2[q], dims,
                        n_pad, sd, r, doc, sim);
}

// ---------------------------------------------------------------------------
// the pipelines
// ---------------------------------------------------------------------------

inline long long up256(long long b) { return (b + 255) / 256 * 256; }

// The shapes of a launch and where its scratch goes (byte offsets).
struct Layout {
    long long rows, n_tiles;
    int t, cap, bn, q_tiles, kbs;
    long long plane, tops, thi, tau, cand_d, cand_s, qnh, keys, total;
    // one memset clears the list counts and both selections' states
    long long cnt, st1, st2, zero_bytes;
};

inline Layout layout(int n_slots, int n_q, int dims, long long n_pad, int k,
                     bool flat) {
    Layout L{};
    L.rows = (long long)n_slots * n_q;
    L.n_tiles = (n_pad + BM - 1) / BM;
    const long long need = (2LL * k + L.n_tiles - 1) / L.n_tiles;
    int t = 2;
    while (t < need) t <<= 1;
    L.t = t <= TOPS_MAX ? t : 0;     // 0: no threshold, every row whole
    L.cap = 2 * k + 2048;
    L.bn = n_q <= 8 ? 8 : n_q <= 16 ? 16 : n_q <= 32 ? 32 : 64;
    L.q_tiles = (n_q + L.bn - 1) / L.bn;
    L.kbs = (dims + (flat ? 63 : 127)) / (flat ? 64 : 128);
    const int tt = L.t > 0 ? L.t : 1;
    long long off = 0;
    L.plane = off;
    off += up256(L.rows * n_pad * 4);
    L.tops = off;
    off += up256(L.rows * L.n_tiles * tt * 4);
    L.thi = off;
    if (flat) off += up256(L.rows * L.n_tiles * 4);
    L.tau = off;
    off += up256(L.rows * 4);
    L.cnt = off;
    off += up256(L.rows * 4);
    L.st1 = off;
    off += up256(rows::state_bytes(L.rows));
    L.st2 = off;
    off += up256(rows::state_bytes(L.rows));
    L.zero_bytes = off - L.cnt;
    L.cand_d = off;
    off += up256(L.rows * L.cap * 4);
    L.cand_s = off;
    off += up256(L.rows * L.cap * 4);
    L.qnh = off;
    if (flat) off += up256((long long)n_q * 4);
    L.keys = off;
    off += up256(rows::keys_bytes(L.rows, k));
    L.total = off;
    return L;
}

inline bool valid_shape(int n_slots, int n_q, int dims, long long n_pad,
                        int k, int sim) {
    return n_slots >= 1 && n_slots <= 65535 && n_q >= 1 &&
           (long long)n_slots * n_q <= INT_MAX && dims >= 1 &&
           dims <= MAX_DIMS && k >= 1 && n_pad >= k &&
           n_pad <= 0x7fffffffLL && valid_sim(sim);
}

// CUDA events between the stages of a launch, when ``out`` is set:
// out[i] = the milliseconds of stage i (scores, threshold, list, re-score,
// final selection).
struct Stages {
    float* out;
    cudaStream_t stream;
    cudaEvent_t ev[6];
    int n = 0;
    Stages(float* o, cudaStream_t s) : out(o), stream(s) {
        if (out == nullptr) return;
        for (int i = 0; i < 6; ++i) cudaEventCreate(&ev[i]);
        cudaEventRecord(ev[n++], stream);
    }
    void mark() {
        if (out != nullptr && n < 6) cudaEventRecord(ev[n++], stream);
    }
    int finish() {
        if (out == nullptr) return 0;
        cudaError_t err = cudaEventSynchronize(ev[n - 1]);
        for (int i = 1; i < n && err == cudaSuccess; ++i)
            err = cudaEventElapsedTime(&out[i - 1], ev[i - 1], ev[i]);
        for (int i = 0; i < 6; ++i) cudaEventDestroy(ev[i]);
        return (int)err;
    }
};

template <class K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute((const void*)kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
}

// tau of every row (the k-th largest of its tile tops), or -inf for every
// row when the tops cannot hold k.
inline int threshold(const Layout& L, char* base, int k, cudaStream_t stream) {
    float* tau = (float*)(base + L.tau);
    if (L.t == 0) {
        fill_kernel<<<(unsigned)((L.rows + 255) / 256), 256, 0, stream>>>(
            tau, L.rows, -INFINITY);
        return (int)cudaGetLastError();
    }
    const long long m = L.n_tiles * L.t;
    rows::Src src{(const float*)(base + L.tops), m, nullptr, nullptr, 0,
                  nullptr, nullptr};
    return rows::select_rows(src, (int)L.rows, m, k, base + L.st1,
                             base + L.keys, 1, tau, nullptr, nullptr, stream);
}

inline int list(const Layout& L, char* base, const float* plane,
                const float* tmax, int stride, long long n_pad, bool copy,
                cudaStream_t stream) {
    int* cnt = (int*)(base + L.cnt);
    const dim3 grid((unsigned)((L.n_tiles + LIST_TILES - 1) / LIST_TILES),
                    (unsigned)L.rows);
    list_kernel<<<grid, THREADS, 0, stream>>>(
        plane, tmax, stride, (const float*)(base + L.tau), n_pad, L.n_tiles,
        L.cap, cnt, (int*)(base + L.cand_d),
        copy ? (float*)(base + L.cand_s) : nullptr);
    return (int)cudaGetLastError();
}

inline int final_select(const Layout& L, char* base, const float* plane,
                        long long n_pad, int k, unsigned* full, float* out_s,
                        int* out_d, cudaStream_t stream) {
    rows::Src src{plane, n_pad, (const float*)(base + L.cand_s),
                  (const int*)(base + L.cand_d), L.cap,
                  (const int*)(base + L.cnt), (const float*)(base + L.tau)};
    return rows::select_rows(src, (int)L.rows, n_pad, k, base + L.st2,
                             base + L.keys, 0, out_s, out_d, full, stream);
}

// Persistent CTAs for a scores pass: as many as fit on the card at once
// (``per_sm``: the kernel's occupancy, 0 until first asked), shared out
// over the (query tile, slot) pairs, at most one a tile.
template <class K>
inline int persistent_ctas(K kernel, size_t smem, int& per_sm,
                           const Layout& L, int n_slots, int* out) {
    if (per_sm == 0) {
        const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, THREADS, smem);
        if (err != cudaSuccess) return (int)err;
    }
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    long long n = (long long)per_sm * rows::n_sms() /
                  ((long long)L.q_tiles * n_slots);
    if (n < 1) n = 1;
    if (n > L.n_tiles) n = L.n_tiles;
    *out = (int)n;
    return 0;
}

// (static: its caches are this library's, see rows_select.cuh)
template <int BN>
static int launch_coarse(const Layout& L, const int8_t* q8,
                         const float* scales, const float* norms,
                         const uint8_t* allowed, const uint8_t* masks,
                         const int8_t* qq, const float* qscale,
                         const float* qn, const float* q2, int n_slots,
                         int n_q, int dims, long long n_pad, int sim,
                         char* base, cudaStream_t stream) {
    const size_t smem = coarse_smem<BN>();
    static bool smem_set = false;
    if (!smem_set) {
        const cudaError_t err = allow_smem(coarse_kernel<BN>, smem);
        if (err != cudaSuccess) return (int)err;
        smem_set = true;
    }
    static int per_sm = 0;
    int ctas = 0;
    int rc = persistent_ctas(coarse_kernel<BN>, smem, per_sm, L, n_slots,
                             &ctas);
    if (rc != 0) return rc;
    const int aligned = dims % 16 == 0 && ((uintptr_t)q8 & 15) == 0 &&
                        ((uintptr_t)qq & 15) == 0;
    const dim3 grid((unsigned)ctas, (unsigned)L.q_tiles, (unsigned)n_slots);
    coarse_kernel<BN><<<grid, THREADS, smem, stream>>>(
        q8, scales, norms, allowed, masks, qq, qscale, qn, q2, n_q, dims,
        n_pad, sim, L.kbs, aligned, L.n_tiles, L.t > 0 ? L.t : 1,
        (float*)(base + L.plane), (float*)(base + L.tops));
    return (int)cudaGetLastError();
}

// The knn_coarse pipeline (K6, and mesh_knn_coarse over S slots): the best
// k' of each of the S * n_q rows into out_s / out_d [S * n_q, k'].
inline int coarse_topk(const int8_t* q8, const float* scales,
                       const float* norms, const uint8_t* allowed,
                       const uint8_t* masks, const int8_t* qq,
                       const float* qscale, const float* qn, const float* q2,
                       int n_slots, int n_q, int dims, long long n_pad,
                       int kprime, int sim, void* scratch, unsigned* full,
                       float* out_s, int* out_d, float* split_ms,
                       cudaStream_t stream) {
    if (!valid_shape(n_slots, n_q, dims, n_pad, kprime, sim))
        return (int)cudaErrorInvalidValue;
    const Layout L = layout(n_slots, n_q, dims, n_pad, kprime, false);
    char* base = (char*)scratch;
    Stages st(split_ms, stream);
    int rc = (int)cudaMemsetAsync(base + L.cnt, 0, L.zero_bytes, stream);
    if (rc != 0) return rc;
#define KNN_COARSE(BN)                                                      \
    launch_coarse<BN>(L, q8, scales, norms, allowed, masks, qq, qscale, qn, \
                      q2, n_slots, n_q, dims, n_pad, sim, base, stream)
    if (L.bn == 8) rc = KNN_COARSE(8);
    else if (L.bn == 16) rc = KNN_COARSE(16);
    else if (L.bn == 32) rc = KNN_COARSE(32);
    else rc = KNN_COARSE(64);
#undef KNN_COARSE
    if (rc != 0) return rc;
    st.mark();
    rc = threshold(L, base, kprime, stream);
    if (rc != 0) return rc;
    st.mark();
    const float* plane = (const float*)(base + L.plane);
    rc = list(L, base, plane, (const float*)(base + L.tops),
              L.t > 0 ? L.t : 1, n_pad, true, stream);
    if (rc != 0) return rc;
    st.mark();
    st.mark();                        // no re-score: the plane is exact
    rc = final_select(L, base, plane, n_pad, kprime, full, out_s, out_d,
                      stream);
    if (rc != 0) return rc;
    st.mark();
    return st.finish();
}

template <int BN>
static int launch_screen(const Layout& L, const float* matrix,
                         const float* norms, const uint8_t* allowed,
                         const uint8_t* masks, const float* queries,
                         const float* qn, const float* q2, int n_slots,
                         int n_q, int dims, long long n_pad, int sim,
                         float g1, char* base, float* probe,
                         cudaStream_t stream) {
    const size_t smem = screen_smem<BN>();
    static bool smem_set = false;
    if (!smem_set) {
        const cudaError_t err = allow_smem(screen_kernel<BN>, smem);
        if (err != cudaSuccess) return (int)err;
        smem_set = true;
    }
    static int per_sm = 0;
    int ctas = 0;
    int rc = persistent_ctas(screen_kernel<BN>, smem, per_sm, L, n_slots,
                             &ctas);
    if (rc != 0) return rc;
    const int vec = dims % 4 == 0 && ((uintptr_t)matrix & 15) == 0 &&
                    ((uintptr_t)queries & 15) == 0;
    const dim3 grid((unsigned)ctas, (unsigned)L.q_tiles, (unsigned)n_slots);
    screen_kernel<BN><<<grid, THREADS, smem, stream>>>(
        matrix, norms, allowed, masks, queries, qn, q2,
        (const float*)(base + L.qnh), n_q, dims, n_pad, sim, L.kbs, vec, g1,
        L.n_tiles, L.t > 0 ? L.t : 1, (float*)(base + L.plane),
        (float*)(base + L.thi), (float*)(base + L.tops), probe);
    return (int)cudaGetLastError();
}

// The screen's gamma (section 4) at ``dims`` padded to the bf16 stage.
inline double screen_gamma(int dims) {
    const double u = 1.0 / (1 << 24);
    return 5.0 * ((dims + 63) / 64 * 64) * u * (1.0 + 1.0 / 256);
}

// The knn_flat pipeline (K5, and mesh_knn_topk over S slots): the best k of
// each of the S * n_q rows into out_s / out_d [S * n_q, k]. probe (may be
// null): the raw tensor-core dots [S * n_q, n_pad].
inline int flat_topk(const float* matrix, const float* norms,
                     const uint8_t* allowed, const uint8_t* masks,
                     const float* queries, const float* qn, const float* q2,
                     int n_slots, int n_q, int dims, long long n_pad, int k,
                     int sim, void* scratch, unsigned* full, float* out_s,
                     int* out_d, float* probe, float* split_ms,
                     cudaStream_t stream) {
    if (!valid_shape(n_slots, n_q, dims, n_pad, k, sim))
        return (int)cudaErrorInvalidValue;
    const Layout L = layout(n_slots, n_q, dims, n_pad, k, true);
    char* base = (char*)scratch;
    Stages st(split_ms, stream);
    int rc = (int)cudaMemsetAsync(base + L.cnt, 0, L.zero_bytes, stream);
    if (rc != 0) return rc;
    qnorm_kernel<<<(n_q + 7) / 8, 256, 0, stream>>>(
        queries, n_q, dims, (float*)(base + L.qnh));
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    const float g1 = (float)(screen_gamma(dims) * (1.0 + 1.0 / 256));
#define KNN_SCREEN(BN)                                                     \
    launch_screen<BN>(L, matrix, norms, allowed, masks, queries, qn, q2,   \
                      n_slots, n_q, dims, n_pad, sim, g1, base, probe,     \
                      stream)
    if (L.bn == 8) rc = KNN_SCREEN(8);
    else if (L.bn == 16) rc = KNN_SCREEN(16);
    else if (L.bn == 32) rc = KNN_SCREEN(32);
    else rc = KNN_SCREEN(64);
#undef KNN_SCREEN
    if (rc != 0) return rc;
    st.mark();
    rc = threshold(L, base, k, stream);
    if (rc != 0) return rc;
    st.mark();
    float* plane = (float*)(base + L.plane);
    rc = list(L, base, plane, (const float*)(base + L.thi), 1, n_pad, false,
              stream);
    if (rc != 0) return rc;
    st.mark();
    const float* tau = (const float*)(base + L.tau);
    const int* cnt = (const int*)(base + L.cnt);
    const size_t qsm = (size_t)dims * 4;
    rescore_kernel<<<dim3((unsigned)((L.cap + THREADS - 1) / THREADS),
                          (unsigned)L.rows),
                     THREADS, qsm, stream>>>(
        matrix, norms, allowed, masks, queries, qn, q2, n_q, dims, n_pad,
        sim, tau, cnt, L.cap, (const int*)(base + L.cand_d),
        (float*)(base + L.cand_s));
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    exact_kernel<<<dim3((unsigned)((n_pad + EX_DOCS - 1) / EX_DOCS),
                        (unsigned)L.rows),
                   THREADS, qsm, stream>>>(
        matrix, norms, allowed, masks, queries, qn, q2, n_q, dims, n_pad,
        sim, tau, cnt, L.cap, plane);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    st.mark();
    rc = final_select(L, base, plane, n_pad, k, full, out_s, out_d, stream);
    if (rc != 0) return rc;
    st.mark();
    return st.finish();
}

}  // namespace knntc
