// ivf_init: the farthest-point seeding of the IVF build's k-means.
//
// Replaces elasticsearch_tpu/ops/ivf.py:85 `_farthest_point_init`: over the
// sampled rows x [n, D] f32, cents[0] = x[first]; then for i = 1 .. nlist-1,
// with d2 the squared distance of every row to its nearest centroid so
// far, cents[i] = x[argmax d2] (the first index on ties, jnp.argmax's rule)
// and d2 = min(d2, |x - cents[i]|^2). -> [nlist, D] f32.
//
// What bounds it on the H100: memory. A step that reads every row reads
// the whole sample (393 MB at 102,400 x 960: 0.117 ms at 3.35 TB/s), some
// 0.48 s for the 4,095 steps of a GIST1M-class build; the steps are
// sequential. So the kernel reads fewer rows.
//
// The distance, as the plain version takes it: lane l of a warp adds
// (x[d] - c[d])^2 for d = l, l + 32, l + 64, ... in order (the dims padded
// with zeros to a multiple of 32; a zero term changes no sum), then the 32
// lane sums are added as a halving tree (lane j + 16 into lane j, then + 8,
// + 4, + 2, + 1), every subtraction, product and sum rounded on its own.
// elasticsearch_tpu_torch/ops/ivf.py `ivf_init_plain` computes the same
// order with tensor ops, and stays the reference.
//
// Pruning. Every centroid is an exact copy of a row. Each row keeps d2 and
// its owner a, a centroid whose plain distance to the row is d2. A new
// centroid c_i can lower d2 only if it lies within twice the row's
// distance to c_a; a row for which a conservative test rules that out
// keeps d2 bit for bit (fminf(d2, t) == d2 for any t >= d2), so its
// distance is not computed. The test, with u = 2^-24 and K = ceil(D/32) + 8:
//   * The plain f32 distance S' of a true squared distance S: each term
//     (x - c)^2 takes a rounded subtraction and product (3 factors of
//     (1 + e), |e| <= u, with the squared difference), at most ceil(D/32)
//     rounded lane additions and 5 tree additions; all terms are >= 0, so
//     S (1 - u)^K - A <= S' <= S (1 + u)^K + A, where A = 2^-100 covers
//     the underflow of D squares (each <= 2^-150; a subtraction or an add
//     whose result is subnormal is exact).
//   * With s = d2[r] = S'(x_r, c_a): the true distance rho_a <= R, where
//     R^2 = (s + A) / (1 - u)^K. If the true distance delta(c_i, c_a) >=
//     2R, the triangle inequality gives delta(x_r, c_i) >= R, so the plain
//     S'(x_r, c_i) >= R^2 (1 - u)^K - A = s: the row keeps d2.
//   * delta(c_i, c_a)^2 is summed in f64 here (cd; each difference of two
//     f32 values, square and add rounds at most 2^-53 relative, all terms
//     >= 0, so cd <= delta^2 (1 + 2^-53)^(D + 1)): delta^2 >= cd * lo with
//     lo = 1 - (D + 4) 2^-52.
//   * So a row is skipped when s == 0, or when cd * lo > F (s + A) with
//     F = 4 / (1 - u)^K (1 + 2^-30) (the pad covers this comparison's own
//     f64 roundings). ops/ivf.py `init_margin`, `init_skip` and
//     `ivf_init_pruned_plain` mirror it; the CPU tests hold the mirror
//     against the plain distances on rows at the midpoint of two
//     centroids, where a zero margin fails.
// On clustered data (GIST-shaped) a step after the first round of
// clusters computes only the new centroid's own cluster.
//
// Design: one cooperative launch of about one CTA per SM, resident for all
// nlist - 1 steps (radix_select.cuh's grid barrier; the launch fails
// rather than hangs if they cannot all be resident). CTA b owns a
// contiguous slice of rows (one stream a SM; interleaving 32-row blocks
// over the CTAs instead measured 3-55 % slower on the H100) and writes
// each step's (max d2, first index) of its slice. A step:
//   A. every CTA reduces the CTAs' partials to the grid's argmax (the
//      first index on ties) and stages that row, the new centroid, in
//      shared memory; CTA 0 copies it into cents[i];
//   B. when the step prunes, the grid computes cd[j] = |c_i - cents[j]|^2
//      in f64 for j < i, one warp a centroid;        -- grid barrier
//   C. each CTA tests its rows (one thread a row: d2, owner, cd[owner]),
//      lists the rows the test cannot clear, and computes their distances
//      one warp a row in the order above (16 loads of each lane in
//      flight); a lower distance sets d2 and the
//      owner; a step that does not prune computes every row unlisted;
//   D. every row's d2 folds into the CTA's partial. -- grid barrier
// A step prunes when it is the first, every 16th, or when the step before
// computed under 15/16 of the rows; on data where nothing prunes a step
// is one scan, one reduction and one barrier. Data other CTAs wrote
// (partials, cd, cents, the step counts) is read with ld.global.cg, past
// the SM's L1.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "radix_select.cuh"

namespace {

constexpr int MAX_DIMS = 4096;
constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int LIST = 4 * THREADS;        // rows tested per listing round
constexpr int UNROLL = 16;               // loads of a lane in flight
constexpr double ABS = 0x1p-100;
constexpr int MAX_GRID = 1024;

__device__ __forceinline__ bool higher(float v1, int i1, float v2, int i2) {
    return v1 > v2 || (v1 == v2 && i1 < i2);
}

// The plain distance of one row to the staged centroid cs (valid in lane
// 0): lanes sum dims lane, lane + 32, ... in order, then the halving tree.
// A lane's loads of up to UNROLL dims are all in flight before it sums
// them.
__device__ __forceinline__ float lane_dist(const float* __restrict__ row,
                                           const float* cs, int dims,
                                           int lane) {
    float acc = 0.f;
    for (int d0 = lane; d0 < dims; d0 += 32 * UNROLL) {
        float v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int d = d0 + 32 * u;
            v[u] = d < dims ? __ldg(row + d) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int d = d0 + 32 * u;
            if (d < dims) {
                const float diff = __fsub_rn(v[u], cs[d]);
                acc = __fadd_rn(acc, __fmul_rn(diff, diff));
            }
        }
    }
#pragma unroll
    for (int h = 16; h >= 1; h >>= 1)
        acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, h));
    return acc;
}

struct Red {
    float v[WARPS];
    int i[WARPS];
};

__device__ __forceinline__ void fold(float v, int i, float& bv, int& bi) {
    if (higher(v, i, bv, bi)) {
        bv = v;
        bi = i;
    }
}

// Row r's distance dist to centroid i: a lower one sets d2 and the owner
// (fminf(d2, dist) otherwise keeps d2); the row's d2 folds into (bv, bi).
__device__ __forceinline__ void update(float* d2, int* owner, long long r,
                                       float dist, int i, float& bv,
                                       int& bi) {
    float s = d2[r];
    if (dist < s) {
        d2[r] = dist;
        owner[r] = i;
        s = dist;
    }
    fold(s, (int)r, bv, bi);
}

// The CTA's (max, first index) of the threads' (bv, bi), into (*pv, *pi)
// in shared memory.
__device__ void cta_reduce(float bv, int bi, Red* red, float* pv, int* pi) {
#pragma unroll
    for (int h = 16; h >= 1; h >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, h);
        const int oi = __shfl_down_sync(0xffffffffu, bi, h);
        fold(ov, oi, bv, bi);
    }
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (lane == 0) {
        red->v[warp] = bv;
        red->i[warp] = bi;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < WARPS; ++w) fold(red->v[w], red->i[w], bv, bi);
        *pv = bv;
        *pi = bi;
    }
    __syncthreads();
}

// The grid's (max, first index) over the CTAs' partials, in every CTA.
__device__ int grid_argmax(const float* part_v, const int* part_i,
                           int* winner) {
    if (threadIdx.x < 32) {
        float bv = -INFINITY;
        int bi = INT_MAX;
        for (int p = threadIdx.x; p < (int)gridDim.x; p += 32) {
            const float v = __ldcg(part_v + p);
            const int i = __ldcg(part_i + p);
            if (higher(v, i, bv, bi)) {
                bv = v;
                bi = i;
            }
        }
#pragma unroll
        for (int h = 16; h >= 1; h >>= 1) {
            const float ov = __shfl_down_sync(0xffffffffu, bv, h);
            const int oi = __shfl_down_sync(0xffffffffu, bi, h);
            if (higher(ov, oi, bv, bi)) {
                bv = ov;
                bi = oi;
            }
        }
        if (threadIdx.x == 0) *winner = bi;
    }
    __syncthreads();
    return *winner;
}

struct Shared {
    Red red;
    float pv;                    // the CTA's partial
    int pi;
    int winner;
    int n_list;
    unsigned long long computed;
    int list[LIST];
};

// The CTAs' partials are double-buffered by step (part_v / part_i hold
// 2 * grid entries): step i reads step i - 1's and writes its own, so a
// step that skips B (and its barrier) cannot overwrite a partial another
// CTA is still reading. All CTAs read the pruning decision's count after a
// barrier, so they agree. step_rows [nlist] (zeroed here) counts the rows
// each step computed; cycles (nullable, [grid, 3]) the SM cycles each CTA
// spent scanning (C, D), on cd (B) and at the barriers and argmax (A and
// the waits).
__global__ void __launch_bounds__(THREADS, 1) init_kernel(
    const float* __restrict__ x, long long n, int dims, long long first,
    int nlist, double f_margin, double lo_margin,
    float* __restrict__ d2, int* __restrict__ owner, double* cd,
    float* part_v, int* part_i, float* cents, unsigned* bar,
    unsigned long long* step_rows, long long* cycles) {
    extern __shared__ __align__(16) float cs[];     // the new centroid
    __shared__ Shared sh;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int grid = (int)gridDim.x;
    // CTA b's rows: the slice [b * slice, b * slice + span)
    const long long slice = (n + grid - 1) / grid;
    const long long lo = blockIdx.x * slice;
    const long long span = lo < n ? (n - lo < slice ? n - lo : slice) : 0;
    const int gwarps = grid * WARPS;
    const int gwarp = (int)blockIdx.x * WARPS + warp;
    unsigned target = 0;
    long long t_scan = 0, t_cd = 0, t_sync = 0;
    long long t0 = clock64();

    // the first centroid; every row's distance to it
    for (int d = threadIdx.x; d < dims; d += THREADS) {
        const float v = x[first * dims + d];
        cs[d] = v;
        if (blockIdx.x == 0) cents[d] = v;
    }
    for (int i = (int)blockIdx.x * THREADS + threadIdx.x; i < nlist;
         i += grid * THREADS)
        step_rows[i] = i == 0 ? (unsigned long long)n : 0ull;
    __syncthreads();
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (long long e = warp; e < span; e += WARPS) {
        const long long r = lo + e;
        const float dist = lane_dist(x + r * dims, cs, dims, lane);
        if (lane == 0) {
            d2[r] = dist;
            owner[r] = 0;
            fold(dist, (int)r, bv, bi);
        }
    }
    cta_reduce(bv, bi, &sh.red, &sh.pv, &sh.pi);
    if (threadIdx.x == 0) {
        part_v[blockIdx.x] = sh.pv;
        part_i[blockIdx.x] = sh.pi;
    }
    long long t1 = clock64();
    t_scan += t1 - t0;
    rsel::grid_sync(bar, target);

    for (int i = 1; i < nlist; ++i) {
        // A. the argmax of step i - 1's partials, staged; CTA 0 records it
        t0 = clock64();
        const int rd = ((i - 1) & 1) * grid, wr = (i & 1) * grid;
        const long long idx =
            grid_argmax(part_v + rd, part_i + rd, &sh.winner);
        for (int d = threadIdx.x; d < dims; d += THREADS) {
            const float v = x[idx * dims + d];
            cs[d] = v;
            if (blockIdx.x == 0) cents[(long long)i * dims + d] = v;
        }
        if (threadIdx.x == 0) sh.computed = 0;
        __syncthreads();
        t1 = clock64();
        t_sync += t1 - t0;
        if (i + 1 == nlist) break;
        const bool prune = i == 1 || i % 16 == 0 ||
                           16 * __ldcg(step_rows + i - 1) <
                               15 * (unsigned long long)n;
        if (prune) {
            // B. cd[j] = |c_i - cents[j]|^2 in f64, one warp a centroid
            for (int j = gwarp; j < i; j += gwarps) {
                const float* cj = cents + (long long)j * dims;
                double acc = 0.0;
#pragma unroll 8
                for (int d = lane; d < dims; d += 32) {
                    const double diff =
                        (double)cs[d] - (double)__ldcg(cj + d);
                    acc += diff * diff;
                }
#pragma unroll
                for (int h = 16; h >= 1; h >>= 1)
                    acc += __shfl_down_sync(0xffffffffu, acc, h);
                if (lane == 0) cd[j] = acc;
            }
            t0 = clock64();
            t_cd += t0 - t1;
            rsel::grid_sync(bar, target);
            t1 = clock64();
            t_sync += t1 - t0;
        }
        // C. every row's d2 folds into its thread's (max, first index):
        // without pruning each warp computes its rows one at a time; with
        // it, the rows the test clears fold as they are and the rest are
        // listed and computed
        bv = -INFINITY;
        bi = INT_MAX;
        if (!prune) {
            unsigned long long rows = 0;
            for (long long e = warp; e < span; e += WARPS) {
                const long long r = lo + e;
                const float dist = lane_dist(x + r * dims, cs, dims, lane);
                if (lane == 0) {
                    update(d2, owner, r, dist, i, bv, bi);
                    ++rows;
                }
            }
            if (lane == 0 && rows) atomicAdd(&sh.computed, rows);
        } else {
            for (long long base = 0; base < span; base += LIST) {
                if (threadIdx.x == 0) sh.n_list = 0;
                __syncthreads();
                for (int e = threadIdx.x; e < LIST; e += THREADS) {
                    const long long r = lo + base + e;
                    bool need = false;
                    if (base + e < span) {
                        const float s = d2[r];
                        need = s != 0.f;
                        if (need) {
                            const double c = __ldcg(cd + owner[r]);
                            need = !(c * lo_margin >
                                     f_margin * ((double)s + ABS));
                        }
                        if (!need) fold(s, (int)r, bv, bi);
                    }
                    const unsigned ballot = __ballot_sync(0xffffffffu, need);
                    int slot = 0;
                    if (lane == 0 && ballot)
                        slot = atomicAdd(&sh.n_list, __popc(ballot));
                    slot = __shfl_sync(0xffffffffu, slot, 0);
                    if (need)
                        sh.list[slot + __popc(ballot & ((1u << lane) - 1))] =
                            (int)r;
                }
                __syncthreads();
                const int m = sh.n_list;
                for (int e = warp; e < m; e += WARPS) {
                    const long long r = sh.list[e];
                    const float dist = lane_dist(x + r * dims, cs, dims, lane);
                    if (lane == 0) update(d2, owner, r, dist, i, bv, bi);
                }
                if (threadIdx.x == 0) sh.computed += (unsigned)m;
                __syncthreads();
            }
        }
        // D. the CTA's partial; every CTA writes step i's
        cta_reduce(bv, bi, &sh.red, &sh.pv, &sh.pi);
        if (threadIdx.x == 0) {
            part_v[wr + blockIdx.x] = sh.pv;
            part_i[wr + blockIdx.x] = sh.pi;
            if (sh.computed)
                atomicAdd(step_rows + i, sh.computed);
        }
        t0 = clock64();
        t_scan += t0 - t1;
        rsel::grid_sync(bar, target);
        t_sync += clock64() - t0;
    }
    if (cycles != nullptr && threadIdx.x == 0) {
        cycles[3 * blockIdx.x] = t_scan;
        cycles[3 * blockIdx.x + 1] = t_cd;
        cycles[3 * blockIdx.x + 2] = t_sync;
    }
}

int grid_for(long long n, int dims, size_t* smem) {
    *smem = sizeof(float) * (size_t)dims;
    static int per_sm = 0;
    if (per_sm == 0) {
        cudaError_t err = cudaFuncSetAttribute(
            (const void*)init_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)(sizeof(float) * MAX_DIMS));
        if (err != cudaSuccess) return -(int)err;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, init_kernel, THREADS, sizeof(float) * MAX_DIMS);
        if (err != cudaSuccess) return -(int)err;
        if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
    }
    long long grid = (long long)per_sm * rsel::n_sms();
    // at least 64 rows a CTA: a smaller slice spends its step at barriers
    const long long useful = (n + 63) / 64;
    if (grid > useful) grid = useful;
    if (grid > MAX_GRID) grid = MAX_GRID;
    return grid < 1 ? 1 : (int)grid;
}

}  // namespace

// *grid: the CTAs of a launch over n rows (the partials hold 2 * grid
// entries); the skip test's constants are the caller's (ops/ivf.py
// init_margin).
extern "C" int ivf_init_grid(long long n, int dims, int* grid) {
    size_t smem = 0;
    const int g = grid_for(n, dims, &smem);
    if (g < 0) return -g;
    *grid = g;
    return 0;
}

// x: [n, dims] f32 (the sampled rows); first: the first centroid's row;
// f_margin / lo_margin: init_margin(dims); scratch: d2 [n] f32, owner [n]
// int32, cd [nlist] f64, part_v / part_i [2 * grid] (ivf_init_grid), bar:
// one unsigned (zeroed here); cents: [nlist, dims] f32; step_rows [nlist]
// int64: the rows each step computed (written here); cycles [grid, 3]
// int64 or null.
extern "C" int ivf_init_launch(const float* x, long long n, int dims,
                               long long first, int nlist, double f_margin,
                               double lo_margin, float* d2, int* owner,
                               double* cd, float* part_v, int* part_i,
                               unsigned* bar, float* cents,
                               long long* step_rows, long long* cycles,
                               void* stream_ptr) {
    if (n < 1 || n > 0x7fffffffLL || dims < 1 || dims > MAX_DIMS ||
        first < 0 || first >= n || nlist < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    size_t smem = 0;
    int grid = grid_for(n, dims, &smem);
    if (grid < 0) return -grid;
    cudaError_t err = cudaMemsetAsync(bar, 0, sizeof(unsigned), stream);
    if (err != cudaSuccess) return (int)err;
    void* args[] = {(void*)&x,        (void*)&n,         (void*)&dims,
                    (void*)&first,    (void*)&nlist,
                    (void*)&f_margin, (void*)&lo_margin, (void*)&d2,
                    (void*)&owner,    (void*)&cd,        (void*)&part_v,
                    (void*)&part_i,   (void*)&cents,     (void*)&bar,
                    (void*)&step_rows, (void*)&cycles};
    err = cudaLaunchCooperativeKernel((const void*)init_kernel, dim3(grid),
                                      dim3(THREADS), args, smem, stream);
    return (int)err;
}
