// rrf_fuse.cuh: reciprocal rank fusion of R ranked lists, B rows at a time
// (K24; entered by rrf_fuse_batch.cu and, at B = 1, rrf_fuse.cu).
//
// Replaces elasticsearch_tpu/ops/fusion.py:46 `rrf_fuse_batch` (the
// coordinator's RrfFusionBatcher drain, action/search_action.py) and, at
// B = 1 with `tail` set, elasticsearch_tpu/ops/fusion.py:26 `rrf_fuse`.
// Row b of lists [B, R, K] int32 holds R ranked lists of doc ids in the
// row's own id space (-1 pads, ids >= n_docs_pad dropped, never indexed).
// Each valid entry at slot j = r * K + kk adds 1 / (rank_constant + kk + 1)
// (an f32 add, then an IEEE f32 division: the source is built without
// --use_fast_math) to its doc; a doc's total starts from 0.0 and adds its
// entries in slot order, the order the JAX package's CPU scatter-add takes,
// and an id listed twice in one list counts twice. Output: the k best docs
// by (score descending, doc ascending), the order lax.top_k gives over the
// JAX package's dense row. Past the matches a batch row holds (-inf, -1);
// with `tail` (rrf_fuse), the lowest-numbered unscored doc ids ascending at
// -inf, as lax.top_k returns them from the dense row's -inf slots.
//
// What bounds it on the H100: a row's work is R * K slots, a few KB on the
// main path (B 64, R 2, K 128), so launch latency, not bytes (the bound is
// the lists read once and the outputs written once at 3.35 TB/s).
//
// Design: the JAX program's dense [n_docs_pad] row is not carried over --
// the candidate pool is at most R * K slots. One CTA a row:
//   1. key1 = (doc << 32 | slot) for each valid slot, sentinel ~0 else;
//      a bitonic sort groups each doc's slots in slot order (the slot in the
//      low bits makes the sort stable by construction);
//   2. the first slot of each doc's run sums the run in order; a block scan
//      compacts the runs into key2 = (~bits(score) << 32 | doc) -- the
//      scores are positive, so their bits order like the values -- and,
//      in doc order, into the distinct-doc list `ud`;
//   3. a second bitonic sort orders key2 by (score desc, doc asc); the
//      first k are the answer, any k (no selection rounds needed).
// The tail: the m-th unscored doc is m + #{i : ud[i] - i <= m}, a binary
// search over the ascending distinct docs. The work arrays (two u64 keys
// and one int a padded slot) live in shared memory while they fit (the
// wrapper's RRF_SMEM_BYTES), else in global scratch, slower but right.
// The plain PyTorch version is elasticsearch_tpu_torch/ops/fusion.py
// `rrf_fuse_batch_plain` / `rrf_fuse_plain` (index_add_ over a dense row,
// then a stable sort).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rrf {

constexpr int THREADS = 512;
constexpr unsigned FULL = 0xffffffffu;
constexpr uint64_t NONE = ~0ull;

__device__ void bitonic_u64(uint64_t* a, int n) {
    for (int size = 2; size <= n; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            for (int t = threadIdx.x; t < (n >> 1); t += blockDim.x) {
                const int lo = 2 * t - (t & (stride - 1));
                const int hi = lo + stride;
                const bool up = (lo & size) == 0;
                const uint64_t x = a[lo], y = a[hi];
                if ((x > y) == up) {
                    a[lo] = y;
                    a[hi] = x;
                }
            }
            __syncthreads();
        }
    }
}

// Exclusive block-wide prefix sum of v (0 or 1); *total gets the sum.
// Every thread of the CTA must call it.
__device__ int block_scan(int v, int* warp_sums, int* total) {
    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[w] = x;
    __syncthreads();
    if (w == 0) {
        const int s = lane < n_warps ? warp_sums[lane] : 0;
        int inc = s;
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(FULL, inc, o);
            if (lane >= o) inc += y;
        }
        if (lane < n_warps) warp_sums[lane] = inc - s;
        if (lane == 31) warp_sums[32] = inc;
    }
    __syncthreads();
    const int out = warp_sums[w] + x - v;
    *total = warp_sums[32];
    __syncthreads();
    return out;
}

__global__ void __launch_bounds__(THREADS)
rrf_fuse_kernel(const int* __restrict__ lists, int R, int K,
                long long n_docs_pad, int k, int rank_constant, int tail,
                int P, unsigned char* gscratch, float* __restrict__ out_s,
                int* __restrict__ out_d) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ int warp_sums[33];
    unsigned char* base = gscratch != nullptr
        ? gscratch + (size_t)blockIdx.x * (size_t)P * 20
        : smem_raw;
    uint64_t* key1 = (uint64_t*)base;
    uint64_t* key2 = key1 + P;
    int* ud = (int*)(key2 + P);
    const int n = R * K;
    const int* row = lists + (long long)blockIdx.x * n;

    for (int j = threadIdx.x; j < P; j += blockDim.x) {
        uint64_t key = NONE;
        if (j < n) {
            const int d = row[j];
            if (d >= 0 && (long long)d < n_docs_pad)
                key = ((uint64_t)(uint32_t)d << 32) | (uint32_t)j;
        }
        key1[j] = key;
        key2[j] = NONE;
    }
    __syncthreads();
    bitonic_u64(key1, P);

    const float rc = (float)rank_constant;
    int groups = 0;
    for (int tile = 0; tile < P; tile += blockDim.x) {
        const int j = tile + threadIdx.x;
        int head = 0;
        uint32_t doc = 0;
        float sum = 0.0f;
        if (j < P && key1[j] != NONE) {
            doc = (uint32_t)(key1[j] >> 32);
            head = j == 0 || (uint32_t)(key1[j - 1] >> 32) != doc;
            if (head) {
                for (int q = j; q < P && key1[q] != NONE &&
                                (uint32_t)(key1[q] >> 32) == doc;
                     ++q) {
                    const int slot = (int)(uint32_t)key1[q];
                    const float den = __fadd_rn(rc, (float)(slot % K + 1));
                    sum = __fadd_rn(sum, __fdiv_rn(1.0f, den));
                }
            }
        }
        int total = 0;
        const int pos = groups + block_scan(head, warp_sums, &total);
        if (head) {
            key2[pos] = ((uint64_t)(~__float_as_uint(sum)) << 32) | doc;
            ud[pos] = (int)doc;
        }
        groups += total;
    }
    __syncthreads();
    bitonic_u64(key2, P);

    const long long o = (long long)blockIdx.x * k;
    for (int t = threadIdx.x; t < k; t += blockDim.x) {
        if (t < groups) {
            out_s[o + t] = __uint_as_float(~(uint32_t)(key2[t] >> 32));
            out_d[o + t] = (int)(uint32_t)key2[t];
        } else if (tail) {
            const int m = t - groups;
            int lo = 0, hi = groups;
            while (lo < hi) {
                const int mid = (lo + hi) >> 1;
                if (ud[mid] - mid <= m) lo = mid + 1;
                else hi = mid;
            }
            out_s[o + t] = -INFINITY;
            out_d[o + t] = m + lo;
        } else {
            out_s[o + t] = -INFINITY;
            out_d[o + t] = -1;
        }
    }
}


// lists: [B, R, K] int32; gscratch: NULL (work arrays in shared memory) or
// B * P * 20 bytes, P the power of two >= max(R * K, 2); out_s/out_d:
// [B, k]. Returns the first CUDA error, 0 on success.
inline int launch(const int* lists, int B, int R, int K, long long n_docs_pad,
                  int k, int rank_constant, int tail,
                  unsigned char* gscratch, float* out_s, int* out_d,
                  cudaStream_t stream) {
    if (B < 1 || R < 0 || K < 0 || k < 1) return (int)cudaErrorInvalidValue;
    const long long n = (long long)R * K;
    if (n >= (1LL << 30)) return (int)cudaErrorInvalidValue;
    int P = 2;
    while (P < n) P <<= 1;
    const size_t smem = gscratch != nullptr ? 0 : (size_t)P * 20;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            (const void*)rrf_fuse_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    rrf_fuse_kernel<<<B, THREADS, smem, stream>>>(
        lists, R, K, n_docs_pad, k, rank_constant, tail, P, gscratch, out_s,
        out_d);
    return (int)cudaGetLastError();
}

}  // namespace rrf
