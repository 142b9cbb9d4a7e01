// ivf_assign: the assignment step of the IVF build's k-means.
//
// Replaces elasticsearch_tpu/ops/ivf.py:37 `_assign`: for each row x of a
// chunk [n <= ASSIGN_CHUNK, D] f32, the centroid c of [nlist, D] f32 that
// minimises c2[c] - 2 * dot(bf16(x), bf16(c)), dots summed in f32 in
// dimension order and c2[c] = sum_d c[d] * c[d] over the f32 centroids;
// ties go to the lowest centroid index (jnp.argmin's first-index rule).
// -> int32 [n], bitwise the plain version's
// (elasticsearch_tpu_torch/ops/ivf.py `ivf_assign_plain`).
//
// What bounds it on the H100: operations. One chunk at a GIST1M-class
// build (n 131,072, nlist 4,096, D 960) is 2 * n * nlist * D = 1.03 TFLOP,
// 1.04 ms on the tensor cores at 989 TFLOP/s (bf16) and 15.4 ms on the
// CUDA cores at 67 TFLOP/s (f32); it reads 503 MB of rows (0.15 ms at
// 3.35 TB/s).
//
// Design: a screen on the tensor cores, then an exact re-score.
// 1. tile_swizzled rounds the rows and the centroids to bf16 once, into
//    tiles of 64 dims in the 128-byte swizzle that wgmma reads
//    (hopper.cuh), zero-padded, and writes each bf16 row's and centroid's
//    L2 norm, inflated by 2^-10 (the f32 sum of squares is within D * 2^-24
//    of the exact one, D <= 4,096, and the root halves that).
// 2. screen_kernel: one CTA owns 128 rows and sweeps every centroid tile
//    of BN in ascending order. A producer warp keeps TMA bulk copies of
//    the row tile and the centroid tile, 64 dims at a time, in flight into
//    a ring of shared-memory stages; two consumer warpgroups (64 rows each)
//    run wgmma (bf16 in, f32 sums) on each stage as it lands. No [n, nlist]
//    plane is written: after a tile the consumers turn each sum into
//        t(c) = c2[c] - 2 * dot_tc,
//        E(c) = g1 * |x^| * |c^| + g2 * c2[c] + 2^-100,
//    keep U = min_c (t(c) + E(c)) for their rows, and keep the centroids
//    with t(c) - E(c) <= U in a list of CAND a row, pruned as U falls. A
//    row whose list overflows is marked.
// 3. rescore_listed: a thread a row re-scores its listed centroids from
//    the bf16 tiles with the plain version's arithmetic -- the dot as
//    __fmaf_rn in dimension order, __fsub_rn(c2, __fmul_rn(2, dot)) -- and
//    takes the argmin, first index on ties; rescore_all does the same with
//    a warp for each marked row over every centroid, counted in
//    ``overflow``. (A thread a row keeps some 2,000 dot chains in flight
//    on an SM; a warp a row, with one or two listed centroids, kept 64.)
//
// Why the argmin is the plain version's, bit for bit. Let v(c) be the plain
// value and p_d the exact products of the bf16 operands (exact in f32).
// Both dots sum the same p_d: the plain one rounds to nearest once a step,
// |dot_plain - sum p| <= gamma_p * sum |p|, gamma_p = D * 2^-24 / (1 -
// D * 2^-24); the tensor cores align each group's products to the largest
// exponent and truncate, |dot_tc - sum p| <= gamma_tc * sum |p| with
// gamma_tc = 2 * D * 2^-23 (twice the truncation bound, for the alignment).
// By Cauchy-Schwarz sum |p| <= |x^| |c^|, so
//     |dot_tc - dot_plain| <= gamma |x^| |c^|,
//     gamma = 5 * D * 2^-24 (1 + 2^-8)
// (D the padded width; 1 / (1 - 5 D 2^-24) < 1 + 2^-8 for D <= 4,096).
// t and v each round c2 - 2 dot once, and t -/+ E round once more, each
// by at most 2^-24 (c2 + 2 |x^| |c^|), so with
//     g1 = (2 gamma + 6 * 2^-24) (1 + 2^-8),  g2 = 3 * 2^-24 (1 + 2^-8)
// the computed t - E <= v(c) <= t + E for every c (the factor 1 + 2^-8
// also covers the roundings of E itself and of |x^| |c^|; the 2^-100 any
// product the tensor cores flush below f32's normal range, at most
// 4,096 * 2^-126 in all). Hence U >= min_c v(c) = v(c*) >= t(c*) - E(c*):
// every minimiser c* is listed at every step and never pruned (tied
// minimisers too, so the first index is among them), and a centroid that
// is dropped has v > U >= v(c*). chip_smoke.py measures the largest
// |dot_tc - dot_plain| / (|x^| |c^|) on the card and fails unless it stays
// under gamma.
#include <cuda_bf16.h>

#include "hopper.cuh"
#include "ivf_common.cuh"

using namespace ivf;

namespace {

constexpr int BM = 128;              // rows a CTA (two warpgroups of 64)
constexpr int BN = 128;              // centroids a tile
constexpr int BK = 64;               // dims a stage: one 128-byte row
constexpr int STAGES = 5;            // the shared-memory ring
constexpr int CAND = 32;             // listed centroids a row
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 128;   // + the producer warpgroup
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BN * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int RING = STAGES * STAGE_BYTES;
// ring, full and empty barriers, counts, overflow marks, the lists
constexpr int SMEM = RING + 2 * STAGES * 8 + 2 * BM * 4 + BM * CAND * 8 +
                     1024;                        // + alignment
constexpr float ABS_SLACK = 7.888609052210118e-31f;   // 2^-100

__device__ __forceinline__ bool lower(float v1, int i1, float v2, int i2) {
    return v1 < v2 || (v1 == v2 && i1 < i2);
}

// src [rows, dims] f32 -> dst: tiles of tile_rows x 64 bf16 (rows padded to
// rows_pad, dims to kbs * 64, zeros), tile (rb, kb) at element offset
// (rb * kbs + kb) * tile_rows * 64, in the 128-byte swizzle; norms[r]: the
// bf16 row's L2 norm, inflated. One warp a row.
__global__ void tile_swizzled(const float* __restrict__ src, int rows,
                              int dims, int rows_pad, int kbs, int tile_rows,
                              __nv_bfloat16* __restrict__ dst,
                              float* __restrict__ norms) {
    const long long r = (long long)blockIdx.x * (blockDim.x >> 5) +
                        (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (r >= rows_pad) return;
    const long long rb = r / tile_rows;
    const int rr = (int)(r % tile_rows);
    float ss = 0.f;
    for (int ch = lane; ch < kbs * 8; ch += 32) {    // 16-byte chunks
        const int kb = ch >> 3, q = ch & 7;
        __align__(16) __nv_bfloat16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            const int d = ch * 8 + e;
            const float f =
                (r < rows && d < dims) ? src[r * dims + d] : 0.f;
            v[e] = __float2bfloat16_rn(f);
            const float b = __bfloat162float(v[e]);
            ss = fmaf(b, b, ss);
        }
        const long long tile = (rb * kbs + kb) * (long long)tile_rows * 128;
        const int off = (rr * 128 + q * 16) ^ ((rr & 7) << 4);
        *(uint4*)((unsigned char*)dst + tile + off) = *(const uint4*)v;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) norms[r] = sqrtf(ss) * (1.f + 0.0009765625f);
}

struct Lists {
    int* cnt;      // [BM] listed centroids a row
    int* ovf;      // [BM] 1: the row overflowed
    int* idx;      // [BM][CAND]
    float* lo;     // [BM][CAND] t - E of each listed centroid
};

// Drop the listed centroids of row r whose t - E exceeds u.
__device__ __forceinline__ void prune(Lists l, int r, float u) {
    if (l.ovf[r]) return;
    const int m = l.cnt[r];
    int w = 0;
    for (int q = 0; q < m; ++q) {
        const float lo = l.lo[r * CAND + q];
        if (lo <= u) {
            l.lo[r * CAND + w] = lo;
            l.idx[r * CAND + w] = l.idx[r * CAND + q];
            ++w;
        }
    }
    l.cnt[r] = w;
}

__device__ __forceinline__ void add(Lists l, int r, int c, float lo) {
    if (l.ovf[r]) return;
    const int p = atomicAdd(&l.cnt[r], 1);
    if (p < CAND) {
        l.idx[r * CAND + p] = c;
        l.lo[r * CAND + p] = lo;
    } else {
        l.ovf[r] = 1;
    }
}

// One stage: a warpgroup's 64 rows against the tile's BN centroids, BK
// dims in four wgmma steps of 16.
__device__ __forceinline__ void mma_stage(float (&acc)[BN / 2], uint32_t a,
                                          uint32_t b) {
#pragma unroll
    for (int k = 0; k < BK / 16; ++k)
        hopper::wgmma_n128(acc, hopper::sw128_desc(a + 32 * k),
                           hopper::sw128_desc(b + 32 * k));
}

// grid (rows_pad / BM). xa / ca: tile_swizzled's row tiles (BM rows) and
// centroid tiles (BN centroids); xn / cn their norms; c2 the f32 centroid
// norms. Writes cand_n[row] (the listed count, -1 when the row
// overflowed) and cand_i[row * CAND + q]; probe (may be null): the raw
// tensor-core dots [n, nlist].
__global__ void __launch_bounds__(THREADS, 1) screen_kernel(
    const __nv_bfloat16* __restrict__ xa, const __nv_bfloat16* __restrict__ ca,
    const float* __restrict__ xn, const float* __restrict__ cn,
    const float* __restrict__ c2, int n, int nlist, int kbs, float g1,
    float g2, int* __restrict__ cand_n, int* __restrict__ cand_i,
    float* __restrict__ probe) {
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    const uint32_t raw = hopper::smem_addr(smem_raw);
    unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
    const uint32_t ring = hopper::smem_addr(smem);
    uint64_t* bars = (uint64_t*)(smem + RING);
    const uint32_t full0 = hopper::smem_addr(bars);
    const uint32_t empty0 = full0 + 8 * STAGES;
    Lists l;
    l.cnt = (int*)(bars + 2 * STAGES);
    l.ovf = l.cnt + BM;
    l.idx = l.ovf + BM;
    l.lo = (float*)(l.idx + BM * CAND);
    const int tid = threadIdx.x;
    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            hopper::mbar_init(full0 + 8 * s, 1);
            hopper::mbar_init(empty0 + 8 * s, CONSUMERS);
        }
        hopper::mbar_init_fence();
    }
    if (tid < BM) {
        l.cnt[tid] = 0;
        l.ovf[tid] = 0;
    }
    __syncthreads();
    const int n_ct = (nlist + BN - 1) / BN;
    const long long rb = blockIdx.x;

    if (tid >= CONSUMERS) {
        // the producer warpgroup: one thread keeps the ring full
        hopper::set_max_regs_dec<40>();
        if (tid == CONSUMERS) {
            int stage = 0;
            uint32_t phase = 0;
            for (int ct = 0; ct < n_ct; ++ct) {
                for (int kb = 0; kb < kbs; ++kb) {
                    hopper::mbar_wait(empty0 + 8 * stage, phase ^ 1);
                    const uint32_t full = full0 + 8 * stage;
                    hopper::mbar_expect_tx(full, STAGE_BYTES);
                    const uint32_t dst = ring + stage * STAGE_BYTES;
                    hopper::bulk_load(
                        dst, xa + (rb * kbs + kb) * (long long)(BM * BK),
                        A_BYTES, full);
                    hopper::bulk_load(
                        dst + A_BYTES,
                        ca + ((long long)ct * kbs + kb) * (BN * BK),
                        B_BYTES, full);
                    if (++stage == STAGES) {
                        stage = 0;
                        phase ^= 1;
                    }
                }
            }
        }
    } else {
        hopper::set_max_regs_inc<232>();
        const int wg = tid >> 7;             // rows wg * 64 .. + 63
        const int lane = tid & 31;
        const int r0 = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
        const int r1 = r0 + 8;
        const long long g0 = rb * BM + r0, g1r = rb * BM + r1;
        const float xn0 = xn[g0], xn1 = xn[g1r];
        float u0 = INFINITY, u1 = INFINITY;
        int stage = 0;
        uint32_t phase = 0;
        float acc[BN / 2];
        for (int ct = 0; ct < n_ct; ++ct) {
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
            // one stage's products stay in flight while the next stage's
            // are issued; a stage is released once its group completes
            int prev = 0;
            for (int kb = 0; kb < kbs; ++kb) {
                hopper::mbar_wait(full0 + 8 * stage, phase);
                const uint32_t a = ring + stage * STAGE_BYTES;
                hopper::wgmma_fence();
                mma_stage(acc, a + wg * (64 * BK * 2), a + A_BYTES);
                hopper::wgmma_commit();
                if (kb > 0) {
                    hopper::wgmma_wait_one();
                    hopper::mbar_arrive(empty0 + 8 * prev);
                }
                prev = stage;
                if (++stage == STAGES) {
                    stage = 0;
                    phase ^= 1;
                }
            }
            hopper::wgmma_wait_all();
            hopper::mbar_arrive(empty0 + 8 * prev);
            // accumulator i: row r0 (i % 4 < 2) or r1, centroid
            // ct * BN + 8 * (i / 4) + 2 * (lane % 4) + i % 2
            const int cbase = ct * BN + 2 * (lane & 3);
            if (probe != nullptr) {
#pragma unroll
                for (int i = 0; i < BN / 2; ++i) {
                    const int c = cbase + 8 * (i >> 2) + (i & 1);
                    const long long g = (i & 2) ? g1r : g0;
                    if (g < n && c < nlist) probe[g * nlist + c] = acc[i];
                }
            }
            float m0 = INFINITY, m1 = INFINITY;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int c = cbase + 8 * j + e;
                    float lo0 = INFINITY, lo1 = INFINITY;
                    if (c < nlist) {
                        const float cc2 = c2[c], ccn = cn[c];
                        const float base = fmaf(cc2, g2, ABS_SLACK);
                        const float t0 =
                            __fsub_rn(cc2, __fmul_rn(2.f, acc[4 * j + e]));
                        const float t1 =
                            __fsub_rn(cc2, __fmul_rn(2.f, acc[4 * j + 2 + e]));
                        const float e0 = fmaf(xn0 * ccn, g1, base);
                        const float e1 = fmaf(xn1 * ccn, g1, base);
                        lo0 = t0 - e0;
                        lo1 = t1 - e1;
                        m0 = fminf(m0, t0 + e0);
                        m1 = fminf(m1, t1 + e1);
                    }
                    acc[4 * j + e] = lo0;
                    acc[4 * j + 2 + e] = lo1;
                }
            }
            // the four threads of a quad share rows r0 and r1
            m0 = fminf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
            m0 = fminf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
            m1 = fminf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
            m1 = fminf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
            u0 = fminf(u0, m0);
            u1 = fminf(u1, m1);
            if ((lane & 3) == 0) {
                prune(l, r0, u0);
                prune(l, r1, u1);
            }
            __syncwarp();
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int c = cbase + 8 * j + e;
                    if (c < nlist && acc[4 * j + e] <= u0)
                        add(l, r0, c, acc[4 * j + e]);
                    if (c < nlist && acc[4 * j + 2 + e] <= u1)
                        add(l, r1, c, acc[4 * j + 2 + e]);
                }
            }
            __syncwarp();
        }
        if ((lane & 3) == 0) {
            prune(l, r0, u0);
            prune(l, r1, u1);
            const int rows[2] = {r0, r1};
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = rows[h];
                const long long g = rb * BM + r;
                if (g >= n) continue;
                const int m = l.ovf[r] ? -1 : l.cnt[r];
                cand_n[g] = m;
                for (int q = 0; q < m; ++q)
                    cand_i[g * CAND + q] = l.idx[r * CAND + q];
            }
        }
    }
}

// The plain value of row r against centroid c from the bf16 tiles (the
// values bfr gives the f32 inputs): the dot summed in dimension order with
// one rounding a step, then c2 - 2 * dot. The padded dims add exact zeros
// (an FMA of 0 * 0 leaves a sum that starts at +0.0 unchanged).
__device__ __forceinline__ float tile_value(
    const unsigned char* __restrict__ xa, long long r,
    const unsigned char* __restrict__ ca, int c, int kbs, float cc2) {
    const int rr = (int)(r % BM), cc = c % BN;
    const unsigned char* xt = xa + (r / BM) * kbs * (long long)(BM * 128);
    const unsigned char* ct = ca + (long long)(c / BN) * kbs * (BN * 128);
    float acc = 0.f;
    for (int kb = 0; kb < kbs; ++kb) {
#pragma unroll 4
        for (int q = 0; q < 8; ++q) {
            const uint4 xv = __ldg((const uint4*)(
                xt + (long long)kb * (BM * 128) +
                ((rr * 128 + q * 16) ^ ((rr & 7) << 4))));
            const uint4 cv = __ldg((const uint4*)(
                ct + (long long)kb * (BN * 128) +
                ((cc * 128 + q * 16) ^ ((cc & 7) << 4))));
            const __nv_bfloat162* xp = (const __nv_bfloat162*)&xv;
            const __nv_bfloat162* cp = (const __nv_bfloat162*)&cv;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float2 a = __bfloat1622float2(xp[e]);
                const float2 b = __bfloat1622float2(cp[e]);
                acc = __fmaf_rn(a.x, b.x, acc);
                acc = __fmaf_rn(a.y, b.y, acc);
            }
        }
    }
    return __fsub_rn(cc2, __fmul_rn(2.f, acc));
}

// One thread a row: the exact argmin over the row's listed centroids. A
// row whose list overflowed is left to rescore_all.
__global__ void rescore_listed(const unsigned char* __restrict__ xa,
                               const unsigned char* __restrict__ ca,
                               const float* __restrict__ c2, int n,
                               int kbs, const int* __restrict__ cand_n,
                               const int* __restrict__ cand_i,
                               int* __restrict__ out) {
    const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (row >= n) return;
    const int m = cand_n[row];
    if (m <= 0) return;
    float bv = INFINITY;
    int bi = INT_MAX;
    for (int q = 0; q < m; ++q) {
        const int c = cand_i[row * CAND + q];
        const float v = tile_value(xa, row, ca, c, kbs, c2[c]);
        if (lower(v, c, bv, bi)) {
            bv = v;
            bi = c;
        }
    }
    out[row] = bi;
}

// One warp a row whose list overflowed: the exact argmin over every
// centroid, counted in *overflow.
__global__ void rescore_all(const unsigned char* __restrict__ xa,
                            const unsigned char* __restrict__ ca,
                            const float* __restrict__ c2, int n, int nlist,
                            int kbs, const int* __restrict__ cand_n,
                            int* __restrict__ overflow,
                            int* __restrict__ out) {
    const long long row = (long long)blockIdx.x * (blockDim.x >> 5) +
                          (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= n || cand_n[row] > 0) return;
    if (lane == 0) atomicAdd(overflow, 1);
    float bv = INFINITY;
    int bi = INT_MAX;
    for (int c = lane; c < nlist; c += 32) {
        const float v = tile_value(xa, row, ca, c, kbs, c2[c]);
        if (lower(v, c, bv, bi)) {
            bv = v;
            bi = c;
        }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (lower(ov, oi, bv, bi)) {
            bv = ov;
            bi = oi;
        }
    }
    if (lane == 0) out[row] = bi;
}

struct Dims {
    int kbs, rows_pad, cents_pad;
};

inline Dims dims_of(int n, int nlist, int dims) {
    return {(dims + BK - 1) / BK, (n + BM - 1) / BM * BM,
            (nlist + BN - 1) / BN * BN};
}

int launch(const float* x, const float* cents, int n, int nlist, int dims,
           float* c2, __nv_bfloat16* xa, __nv_bfloat16* ca, float* xn,
           float* cn, int* cand_n, int* cand_i, int* overflow, float* probe,
           int* out, cudaStream_t stream) {
    const Dims dm = dims_of(n, nlist, dims);
    static bool smem_set = false;
    if (!smem_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            (const void*)screen_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
        if (e != cudaSuccess) return (int)e;
        smem_set = true;
    }
    cudaError_t err = cudaMemsetAsync(overflow, 0, sizeof(int), stream);
    if (err != cudaSuccess) return (int)err;
    int rc = launch_centroid_norms(cents, nlist, dims, c2, stream);
    if (rc != 0) return rc;
    tile_swizzled<<<(dm.rows_pad + 7) / 8, 256, 0, stream>>>(
        x, n, dims, dm.rows_pad, dm.kbs, BM, xa, xn);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    tile_swizzled<<<(dm.cents_pad + 7) / 8, 256, 0, stream>>>(
        cents, nlist, dims, dm.cents_pad, dm.kbs, BN, ca, cn);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // the screen's bound (the derivation above), D the padded width;
    // ops/ivf.py screen_gamma / screen_bound compute the same numbers
    const double u = 1.0 / (1 << 24);
    const double gamma = 5.0 * dm.kbs * BK * u * (1.0 + 1.0 / 256);
    const float g1 = (float)((2.0 * gamma + 6.0 * u) * (1.0 + 1.0 / 256));
    const float g2 = (float)(3.0 * u * (1.0 + 1.0 / 256));
    screen_kernel<<<dm.rows_pad / BM, THREADS, SMEM, stream>>>(
        xa, ca, xn, cn, c2, n, nlist, dm.kbs, g1, g2, cand_n, cand_i, probe);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const unsigned char* xb = (const unsigned char*)xa;
    const unsigned char* cb = (const unsigned char*)ca;
    rescore_listed<<<(n + 255) / 256, 256, 0, stream>>>(
        xb, cb, c2, n, dm.kbs, cand_n, cand_i, out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    rescore_all<<<(n + 7) / 8, 256, 0, stream>>>(
        xb, cb, c2, n, nlist, dm.kbs, cand_n, overflow, out);
    return (int)cudaGetLastError();
}

}  // namespace

// sizes: [0] bf16 entries of the row tiles, [1] of the centroid tiles,
// [2] row norms, [3] centroid norms, [4] candidate entries (n * CAND).
extern "C" int ivf_assign_scratch(int n, int nlist, int dims,
                                  long long* sizes) {
    const Dims dm = dims_of(n, nlist, dims);
    const long long dp = (long long)dm.kbs * BK;
    sizes[0] = (long long)dm.rows_pad * dp;
    sizes[1] = (long long)dm.cents_pad * dp;
    sizes[2] = dm.rows_pad;
    sizes[3] = dm.cents_pad;
    sizes[4] = (long long)n * CAND;
    return 0;
}

// x: [n, dims] f32; cents: [nlist, dims] f32; c2: [nlist] f32 scratch;
// xa, ca, xn, cn, cand_i: ivf_assign_scratch's sizes; cand_n: [n] int32
// (the listed count a row, -1 where it overflowed); overflow: one int32,
// the rows re-scored against every centroid; probe: null, or [n, nlist]
// f32 for the tensor cores' raw dots; out: [n] int32.
extern "C" int ivf_assign_launch(const float* x, const float* cents, int n,
                                 int nlist, int dims, float* c2,
                                 void* xa, void* ca, float* xn, float* cn,
                                 int* cand_n, int* cand_i, int* overflow,
                                 float* probe, int* out, void* stream_ptr) {
    if (n < 1 || nlist < 1 || dims < 1 || dims > MAX_DIMS)
        return (int)cudaErrorInvalidValue;
    return launch(x, cents, n, nlist, dims, c2, (__nv_bfloat16*)xa,
                  (__nv_bfloat16*)ca, xn, cn, cand_n, cand_i, overflow, probe,
                  out, (cudaStream_t)stream_ptr);
}
