// Shared device code of the histogram-aggregation families
// (aggs_histogram, aggs_histogram_plane): per bucket of P plans, the
// count (int32) and the sum, min and max (f32) of an int32 column's
// values, where bucket = floor_div(value, interval[p]) - base[p] and a row
// counts when exists[row] and masks[p, row] hold and the bucket is in
// [0, n_buckets) (others are dropped, as mode="drop" drops them). The
// per-segment family is P = 1.
//
// What bounds it on the H100: memory for the counts, mins and maxs (the
// column, its exists bytes and each plan's mask row read once: about
// 9 bytes a row a plan). The sums are bound by latency instead: see below.
//
// Design. Counts, mins and maxs do not depend on the order of their
// terms; an f32 sum does, once a bucket's running sum passes 2^24. The JAX
// package's scatter-add on the CPU adds each bucket's terms in row order,
// so the sums here do too, with no float atomics: a stable counting sort
// of each plan's rows by bucket (per-chunk integer counts, a column scan
// over the chunks, an exclusive scan over the buckets, then one warp per
// chunk placing its values in row order with __match_any_sync ranks, as
// ivf_update.cu does), after which one warp per (plan, bucket) adds the
// bucket's values in row order, one rounded add at a time, and takes their
// min and max on the way. That serial add chain is the kernel's critical
// path: the largest bucket's row count times one dependent f32 add.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace aggs {

constexpr int HIST_THREADS = 256;
constexpr int HIST_SCAN_THREADS = 1024;
constexpr int HIST_SUM_THREADS = 128;
constexpr int HIST_SMEM_BUCKETS = 12288;   // 48 KB of int counts

// floor(v / d) for d > 0, as jnp.floor_divide rounds (CUDA's / truncates
// toward zero).
__device__ __forceinline__ int floor_div(int v, int d) {
    const int q = v / d;
    return (q * d != v && (v < 0) != (d < 0)) ? q - 1 : q;
}

// The bucket of row r under plan (base, interval), or -1 when the row does
// not count.
__device__ __forceinline__ int bucket_of(const int* __restrict__ values,
                                         const uint8_t* __restrict__ exists,
                                         const uint8_t* __restrict__ mask,
                                         long long r, int base, int interval,
                                         int n_buckets) {
    if (interval <= 0 || !exists[r] || !mask[r]) return -1;
    const int b = floor_div(values[r], interval) - base;
    return (b >= 0 && b < n_buckets) ? b : -1;
}

struct Plan {
    const uint8_t* mask;
    int base, interval;
};

__device__ __forceinline__ Plan plan_of(const uint8_t* masks,
                                        const int* bases,
                                        const int* intervals, long long n,
                                        int p) {
    return Plan{masks + (long long)p * n, bases[p], intervals[p]};
}

// grid (n_chunks, P): cc[p, g, b] = rows of chunk g in bucket b under plan
// p. cc must start zeroed.
__global__ void __launch_bounds__(HIST_THREADS) hist_count_kernel(
    const int* __restrict__ values, const uint8_t* __restrict__ exists,
    const uint8_t* __restrict__ masks, const int* __restrict__ bases,
    const int* __restrict__ intervals, long long n, int rows_per_chunk,
    int n_buckets, int* __restrict__ cc) {
    extern __shared__ int hist[];
    const bool smem = n_buckets <= HIST_SMEM_BUCKETS;
    const Plan pl = plan_of(masks, bases, intervals, n, blockIdx.y);
    int* row = cc + ((long long)blockIdx.y * gridDim.x + blockIdx.x) *
                        n_buckets;
    if (smem) {
        for (int b = threadIdx.x; b < n_buckets; b += blockDim.x) hist[b] = 0;
        __syncthreads();
    }
    const long long r0 = (long long)blockIdx.x * rows_per_chunk;
    for (int t = threadIdx.x; t < rows_per_chunk; t += blockDim.x) {
        const long long r = r0 + t;
        if (r >= n) break;
        const int b = bucket_of(values, exists, pl.mask, r, pl.base,
                                pl.interval, n_buckets);
        if (b >= 0) atomicAdd(smem ? hist + b : row + b, 1);
    }
    if (smem) {
        __syncthreads();
        for (int b = threadIdx.x; b < n_buckets; b += blockDim.x)
            row[b] = hist[b];
    }
}

// one thread per (p, b): cc[p, g, b] becomes the count of b's rows in the
// chunks before g; counts[p, b] the total.
__global__ void hist_column_scan_kernel(int* cc, int n_plans, int n_chunks,
                                        int n_buckets,
                                        int* __restrict__ counts) {
    const long long pb = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (pb >= (long long)n_plans * n_buckets) return;
    const long long p = pb / n_buckets;
    const int b = (int)(pb % n_buckets);
    int* col = cc + p * n_chunks * n_buckets + b;
    int run = 0;
    for (int g = 0; g < n_chunks; ++g) {
        const int t = col[(long long)g * n_buckets];
        col[(long long)g * n_buckets] = run;
        run += t;
    }
    counts[pb] = run;
}

// grid (P), one CTA a plan: offsets[p, :] = exclusive prefix sum of
// counts[p, :].
__global__ void __launch_bounds__(HIST_SCAN_THREADS) hist_offsets_kernel(
    const int* __restrict__ counts, int n_buckets, int* __restrict__ offsets) {
    __shared__ int buf[HIST_SCAN_THREADS];
    __shared__ int carry;
    const int t = threadIdx.x;
    const int* in = counts + (long long)blockIdx.x * n_buckets;
    int* out = offsets + (long long)blockIdx.x * n_buckets;
    if (t == 0) carry = 0;
    __syncthreads();
    for (int base = 0; base < n_buckets; base += HIST_SCAN_THREADS) {
        const int i = base + t;
        const int v = i < n_buckets ? in[i] : 0;
        buf[t] = v;
        __syncthreads();
        for (int off = 1; off < HIST_SCAN_THREADS; off <<= 1) {
            const int add = t >= off ? buf[t - off] : 0;
            __syncthreads();
            buf[t] += add;
            __syncthreads();
        }
        if (i < n_buckets) out[i] = carry + buf[t] - v;
        __syncthreads();
        if (t == HIST_SCAN_THREADS - 1) carry += buf[t];
        __syncthreads();
    }
}

// grid (n_chunks, P), one warp each: place the chunk's values, in row
// order, at sorted[p * n + offsets[p, b] + cc[p, g, b] + rank].
__global__ void hist_place_kernel(const int* __restrict__ values,
                                  const uint8_t* __restrict__ exists,
                                  const uint8_t* __restrict__ masks,
                                  const int* __restrict__ bases,
                                  const int* __restrict__ intervals,
                                  long long n, int rows_per_chunk,
                                  int n_buckets, int* cc,
                                  const int* __restrict__ offsets,
                                  float* __restrict__ sorted) {
    const int lane = threadIdx.x;
    const Plan pl = plan_of(masks, bases, intervals, n, blockIdx.y);
    int* base = cc + ((long long)blockIdx.y * gridDim.x + blockIdx.x) *
                         n_buckets;
    const int* off = offsets + (long long)blockIdx.y * n_buckets;
    float* out = sorted + (long long)blockIdx.y * n;
    const long long r0 = (long long)blockIdx.x * rows_per_chunk;
    for (int t = 0; t < rows_per_chunk; t += 32) {
        const long long r = r0 + t + lane;
        int b = r < n ? bucket_of(values, exists, pl.mask, r, pl.base,
                                  pl.interval, n_buckets)
                      : -1;
        const bool ok = b >= 0;
        if (!ok) b = -1 - lane;       // a key no other lane holds
        const unsigned peers = __match_any_sync(0xffffffffu, b);
        const int rank = __popc(peers & ((1u << lane) - 1u));
        const long long pos = ok ? (long long)off[b] + base[b] + rank : 0;
        __syncwarp();
        if (ok) {
            out[pos] = __int2float_rn(values[r]);
            if (lane == __ffs(peers) - 1) base[b] += __popc(peers);
        }
        __syncwarp();
    }
}

// one warp per (p, b): the bucket's values in row order, added one
// rounded f32 add at a time from 0, with their min and max (+inf / -inf
// for an empty bucket). The chain itself is serial; the warp keeps it fed:
// its lanes load SUM_DEPTH lines of 32 consecutive values at once
// (coalesced, many loads in flight), and every lane then runs the same
// chain over them in row order, each value broadcast by a shuffle. An
// add's latency, not the load's, sets the pace.
constexpr int SUM_DEPTH = 8;

__global__ void __launch_bounds__(HIST_SUM_THREADS) hist_sums_kernel(
    const float* __restrict__ sorted, const int* __restrict__ offsets,
    const int* __restrict__ counts, int n_plans, long long n, int n_buckets,
    float* __restrict__ sums, float* __restrict__ mins,
    float* __restrict__ maxs) {
    const long long pb =
        ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (pb >= (long long)n_plans * n_buckets) return;   // whole warps
    const long long p = pb / n_buckets;
    const float* v = sorted + p * n + offsets[pb];
    const int cnt = counts[pb];
    float acc = 0.f, lo = INFINITY, hi = -INFINITY;
    for (int base = 0; base < cnt; base += 32 * SUM_DEPTH) {
        float x[SUM_DEPTH];
#pragma unroll
        for (int j = 0; j < SUM_DEPTH; ++j) {
            const int i = base + 32 * j + lane;
            x[j] = i < cnt ? v[i] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < SUM_DEPTH; ++j) {
            const int m = cnt - (base + 32 * j);   // values left in line j
#pragma unroll
            for (int src = 0; src < 32; ++src) {
                const float y = __shfl_sync(0xffffffffu, x[j], src);
                if (src < m) {
                    acc = __fadd_rn(acc, y);
                    lo = fminf(lo, y);
                    hi = fmaxf(hi, y);
                }
            }
        }
    }
    if (lane == 0) {
        sums[pb] = acc;
        mins[pb] = lo;
        maxs[pb] = hi;
    }
}

// values: [n] int32; exists: [n] bool; masks: [P, n] bool; bases,
// intervals: [P] int32. Scratch: cc [P * n_chunks * n_buckets] int32
// (n_chunks = ceil(n / rows_per_chunk); rows_per_chunk a multiple of 32),
// offsets [P * n_buckets] int32, sorted [P * n] f32. Out: counts
// [P, n_buckets] int32; sums, mins, maxs [P, n_buckets] f32. Returns the
// first CUDA error, 0 on success.
inline int histogram(const int* values, const uint8_t* exists,
                     const uint8_t* masks, const int* bases,
                     const int* intervals, long long n, int n_plans,
                     int n_buckets, int rows_per_chunk, int* cc,
                     int* offsets, float* sorted, int* counts, float* sums,
                     float* mins, float* maxs, cudaStream_t stream) {
    if (n < 1 || n > 0x7fffffffLL || n_plans < 1 || n_plans > 65535 ||
        n_buckets < 1 || rows_per_chunk < 32 || rows_per_chunk % 32 != 0)
        return (int)cudaErrorInvalidValue;
    const long long n_chunks = (n + rows_per_chunk - 1) / rows_per_chunk;
    if (n_chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const long long cells = (long long)n_plans * n_buckets;
    cudaError_t err = cudaMemsetAsync(
        cc, 0, sizeof(int) * (size_t)(cells * n_chunks), stream);
    if (err != cudaSuccess) return (int)err;
    const size_t smem =
        n_buckets <= HIST_SMEM_BUCKETS ? sizeof(int) * (size_t)n_buckets : 0;
    const dim3 grid((unsigned)n_chunks, n_plans);
    hist_count_kernel<<<grid, HIST_THREADS, smem, stream>>>(
        values, exists, masks, bases, intervals, n, rows_per_chunk, n_buckets,
        cc);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    hist_column_scan_kernel<<<(unsigned)((cells + 255) / 256), 256, 0,
                              stream>>>(cc, n_plans, (int)n_chunks, n_buckets,
                                        counts);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    hist_offsets_kernel<<<n_plans, HIST_SCAN_THREADS, 0, stream>>>(
        counts, n_buckets, offsets);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    hist_place_kernel<<<grid, 32, 0, stream>>>(
        values, exists, masks, bases, intervals, n, rows_per_chunk, n_buckets,
        cc, offsets, sorted);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    hist_sums_kernel<<<(unsigned)((cells * 32 + HIST_SUM_THREADS - 1) /
                                  HIST_SUM_THREADS),
                       HIST_SUM_THREADS, 0, stream>>>(
        sorted, offsets, counts, n_plans, n, n_buckets, sums, mins, maxs);
    return (int)cudaGetLastError();
}

}  // namespace aggs
