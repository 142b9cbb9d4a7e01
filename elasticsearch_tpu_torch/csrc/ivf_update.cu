// ivf_update: the centroid update step of the IVF build's k-means.
//
// Replaces elasticsearch_tpu/ops/ivf.py:74 `_update`: per-cluster sums
// and counts of the rows x [n, D] f32 under their assignment [n] int32
// (jax.ops.segment_sum, which drops ids outside [0, nlist)), then
// sums / max(counts, 1), keeping the previous centroid where a cluster is
// empty. -> [nlist, D] f32.
//
// What bounds it on the H100: memory. It reads the rows once (4.03 GB at
// 1,048,576 x 960: 1.2 ms at 3.35 TB/s) and does one add per value.
//
// Design: no float atomics, whose order changes from run to run. A stable
// counting sort of the row ids by cluster (per-chunk integer counts, a
// column scan over the chunks, an exclusive scan over the clusters, then
// one warp per chunk of 4,096 rows placing its rows in order with
// __match_any_sync ranks), after which one thread per (cluster, dim) adds
// the cluster's rows in ascending row order -- the order in which the
// JAX package's segment_sum adds them on the CPU -- and divides once. The
// centroids therefore have the plain version's bits, and the JAX
// package's on the CPU. The plain PyTorch version is
// elasticsearch_tpu_torch/ops/ivf.py `ivf_update_plain`.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_DIMS = 4096;
constexpr int ROWS_PER_CHUNK = 4096;
constexpr int SCAN_THREADS = 1024;
constexpr int SUM_THREADS = 128;

__device__ __forceinline__ bool in_range(int c, int nlist) {
    return c >= 0 && c < nlist;
}

// grid (chunks): cc[g, c] = rows of chunk g assigned to c (integer
// atomics: the counts do not depend on their order).
__global__ void chunk_count_kernel(const int* __restrict__ assign,
                                   long long n, int nlist, int* cc) {
    const long long r0 = (long long)blockIdx.x * ROWS_PER_CHUNK;
    int* row = cc + (long long)blockIdx.x * nlist;
    for (int t = threadIdx.x; t < ROWS_PER_CHUNK; t += blockDim.x) {
        const long long r = r0 + t;
        if (r >= n) break;
        const int c = assign[r];
        if (in_range(c, nlist)) atomicAdd(row + c, 1);
    }
}

// one thread per cluster: cc[g, c] becomes the count of c's rows in the
// chunks before g; counts[c] the total.
__global__ void column_scan_kernel(int* cc, int n_chunks, int nlist,
                                   int* __restrict__ counts) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= nlist) return;
    int run = 0;
    for (int g = 0; g < n_chunks; ++g) {
        int* p = cc + (long long)g * nlist + c;
        const int t = *p;
        *p = run;
        run += t;
    }
    counts[c] = run;
}

// one CTA: offsets = exclusive prefix sum of counts.
__global__ void __launch_bounds__(SCAN_THREADS) exclusive_scan_kernel(
    const int* __restrict__ counts, int nlist, int* __restrict__ offsets) {
    __shared__ int buf[SCAN_THREADS];
    __shared__ int carry;
    const int t = threadIdx.x;
    if (t == 0) carry = 0;
    __syncthreads();
    for (int base = 0; base < nlist; base += SCAN_THREADS) {
        const int i = base + t;
        const int v = i < nlist ? counts[i] : 0;
        buf[t] = v;
        __syncthreads();
        for (int off = 1; off < SCAN_THREADS; off <<= 1) {
            const int add = t >= off ? buf[t - off] : 0;
            __syncthreads();
            buf[t] += add;
            __syncthreads();
        }
        if (i < nlist) offsets[i] = carry + buf[t] - v;
        __syncthreads();
        if (t == SCAN_THREADS - 1) carry += buf[t];
        __syncthreads();
    }
}

// grid (chunks), one warp each: place the chunk's rows, in row order, at
// offsets[c] + cc[g, c] + (rank among the earlier rows of c in the chunk).
__global__ void place_kernel(const int* __restrict__ assign, long long n,
                             int nlist, int* cc,
                             const int* __restrict__ offsets,
                             int* __restrict__ perm) {
    const int lane = threadIdx.x;
    int* base = cc + (long long)blockIdx.x * nlist;
    const long long r0 = (long long)blockIdx.x * ROWS_PER_CHUNK;
    for (int t = 0; t < ROWS_PER_CHUNK; t += 32) {
        const long long r = r0 + t + lane;
        int c = r < n ? assign[r] : -1;
        const bool ok = r < n && in_range(c, nlist);
        if (!ok) c = -1 - lane;       // a key no other lane holds
        const unsigned peers = __match_any_sync(0xffffffffu, c);
        const int rank = __popc(peers & ((1u << lane) - 1u));
        const int pos = ok ? offsets[c] + base[c] + rank : 0;
        __syncwarp();
        if (ok) {
            perm[pos] = (int)r;
            if (lane == __ffs(peers) - 1) base[c] += __popc(peers);
        }
        __syncwarp();
    }
}

// grid (nlist, ceil(dims / SUM_THREADS)): out[c, d] = the sum of the
// cluster's rows at d, in ascending row order, over their count; the
// previous centroid where the cluster is empty.
__global__ void __launch_bounds__(SUM_THREADS) sums_kernel(
    const float* __restrict__ x, const int* __restrict__ perm,
    const int* __restrict__ offsets, const int* __restrict__ counts,
    const float* __restrict__ prev, int dims, float* __restrict__ out) {
    const int c = blockIdx.x;
    const int d = blockIdx.y * SUM_THREADS + threadIdx.x;
    if (d >= dims) return;
    const int start = offsets[c], cnt = counts[c];
    float acc = 0.f;
    for (int i = 0; i < cnt; ++i) {
        const long long r = perm[start + i];
        acc = __fadd_rn(acc, x[r * dims + d]);
    }
    const long long o = (long long)c * dims + d;
    out[o] = cnt > 0 ? __fdiv_rn(acc, (float)cnt) : prev[o];
}

}  // namespace

// x: [n, dims] f32; assign: [n] int32; prev: [nlist, dims] f32; scratch:
// cc [ceil(n / 4096) * nlist], counts [nlist], offsets [nlist], perm [n]
// int32; out: [nlist, dims] f32.
extern "C" int ivf_update_launch(const float* x, const int* assign,
                                 const float* prev, long long n, int nlist,
                                 int dims, int* cc, int* counts, int* offsets,
                                 int* perm, float* out, void* stream_ptr) {
    if (n < 1 || n > 0x7fffffffLL || nlist < 1 || dims < 1 ||
        dims > MAX_DIMS)
        return (int)cudaErrorInvalidValue;
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    const int n_chunks = (int)((n + ROWS_PER_CHUNK - 1) / ROWS_PER_CHUNK);
    cudaError_t err = cudaMemsetAsync(
        cc, 0, sizeof(int) * (size_t)n_chunks * (size_t)nlist, stream);
    if (err != cudaSuccess) return (int)err;
    chunk_count_kernel<<<n_chunks, 256, 0, stream>>>(assign, n, nlist, cc);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    column_scan_kernel<<<(nlist + 255) / 256, 256, 0, stream>>>(
        cc, n_chunks, nlist, counts);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    exclusive_scan_kernel<<<1, SCAN_THREADS, 0, stream>>>(counts, nlist,
                                                          offsets);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    place_kernel<<<n_chunks, 32, 0, stream>>>(assign, n, nlist, cc, offsets,
                                              perm);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    sums_kernel<<<dim3(nlist, (dims + SUM_THREADS - 1) / SUM_THREADS),
                  SUM_THREADS, 0, stream>>>(x, perm, offsets, counts, prev,
                                            dims, out);
    return (int)cudaGetLastError();
}
