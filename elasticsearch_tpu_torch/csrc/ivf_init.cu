// ivf_init: the farthest-point seeding of the IVF build's k-means.
//
// Replaces elasticsearch_tpu/ops/ivf.py:85 `_farthest_point_init`: over the
// sampled rows x [n, D] f32, cents[0] = x[first]; then for i = 1 .. nlist-1,
// with d2 the squared distance of every row to its nearest centroid so
// far, cents[i] = x[argmax d2] (the first index on ties, jnp.argmax's rule)
// and d2 = min(d2, |x - cents[i]|^2). -> [nlist, D] f32.
//
// What bounds it on the H100: memory. Each of the nlist - 1 steps reads
// every row once (393 MB at 102,400 x 960: 0.117 ms at 3.35 TB/s), some
// 0.48 s for the 4,095 steps of a GIST1M-class build; the steps are
// sequential, so the launches (two a step) are a floor as well.
//
// Design: one warp per row. Lane l adds (x[d] - c[d])^2 for d = l, l + 32,
// l + 64, ... in order (the dims padded with zeros to a multiple of 32;
// a zero term changes no sum), then the 32 lane sums are added as a
// halving tree (lane j + 16 into lane j, then + 8, + 4, + 2, + 1), every
// subtraction, product and sum rounded on its own: the plain version
// computes the same order with tensor ops, a [rows, 32] slice a step. The
// step kernel updates d2 and writes each CTA's (max, first index); a
// one-CTA kernel reduces those and copies the chosen row into cents[i].
// The loop over the steps runs here, on the host side of the launch, so a
// build is one wrapper call. The plain PyTorch version is
// elasticsearch_tpu_torch/ops/ivf.py `ivf_init_plain`.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_DIMS = 4096;
constexpr int WARPS = 8;                 // rows per step CTA
constexpr int PICK_THREADS = 1024;

__device__ __forceinline__ bool higher(float v1, int i1, float v2, int i2) {
    return v1 > v2 || (v1 == v2 && i1 < i2);
}

// grid (ceil(n / WARPS)): d2[r] = (init ? dist : min(d2[r], dist)) with
// dist = |x[r] - c|^2 in the order above; part_v/part_i[cta] = the CTA's
// (max d2, first index).
__global__ void __launch_bounds__(WARPS * 32) step_kernel(
    const float* __restrict__ x, const float* __restrict__ c, long long n,
    int dims, int init, float* __restrict__ d2, float* __restrict__ part_v,
    int* __restrict__ part_i) {
    __shared__ float sv[WARPS];
    __shared__ int si[WARPS];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const long long r = (long long)blockIdx.x * WARPS + warp;
    float v = -INFINITY;
    int vi = INT_MAX;
    if (r < n) {
        const float* row = x + r * dims;
        float acc = 0.f;
        for (int d = lane; d < dims; d += 32) {
            const float diff = __fsub_rn(row[d], c[d]);
            acc = __fadd_rn(acc, __fmul_rn(diff, diff));
        }
        // the padded dims (d >= dims) add exact zeros: skipped
#pragma unroll
        for (int h = 16; h >= 1; h >>= 1)
            acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, h));
        if (lane == 0) {
            const float nv = init ? acc : fminf(d2[r], acc);
            d2[r] = nv;
            v = nv;
            vi = (int)r;
        }
    }
    if (lane == 0) {
        sv[warp] = v;
        si[warp] = vi;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        float bv = sv[0];
        int bi = si[0];
        for (int w = 1; w < WARPS; ++w)
            if (higher(sv[w], si[w], bv, bi)) {
                bv = sv[w];
                bi = si[w];
            }
        part_v[blockIdx.x] = bv;
        part_i[blockIdx.x] = bi;
    }
}

// one CTA: the (max, first index) of the n_parts partials; copies that row
// of x into out_row.
__global__ void __launch_bounds__(PICK_THREADS) pick_kernel(
    const float* __restrict__ part_v, const int* __restrict__ part_i,
    int n_parts, const float* __restrict__ x, int dims,
    float* __restrict__ out_row) {
    __shared__ float sv[PICK_THREADS];
    __shared__ int si[PICK_THREADS];
    const int t = threadIdx.x;
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int p = t; p < n_parts; p += PICK_THREADS)
        if (higher(part_v[p], part_i[p], bv, bi)) {
            bv = part_v[p];
            bi = part_i[p];
        }
    sv[t] = bv;
    si[t] = bi;
    __syncthreads();
    for (int h = PICK_THREADS / 2; h >= 1; h >>= 1) {
        if (t < h && higher(sv[t + h], si[t + h], sv[t], si[t])) {
            sv[t] = sv[t + h];
            si[t] = si[t + h];
        }
        __syncthreads();
    }
    const long long idx = si[0];
    for (int d = t; d < dims; d += PICK_THREADS)
        out_row[d] = x[idx * dims + d];
}

}  // namespace

// x: [n, dims] f32 (the sampled rows); first: the first centroid's row;
// scratch: d2 [n] f32, part_v [ceil(n / 8)] f32, part_i [ceil(n / 8)]
// int32; cents: [nlist, dims] f32.
extern "C" int ivf_init_launch(const float* x, long long n, int dims,
                               long long first, int nlist, float* d2,
                               float* part_v, int* part_i, float* cents,
                               void* stream_ptr) {
    if (n < 1 || n > 0x7fffffffLL || dims < 1 || dims > MAX_DIMS ||
        first < 0 || first >= n || nlist < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    cudaError_t err = cudaMemcpyAsync(cents, x + first * dims,
                                      sizeof(float) * (size_t)dims,
                                      cudaMemcpyDeviceToDevice, stream);
    if (err != cudaSuccess) return (int)err;
    const int n_parts = (int)((n + WARPS - 1) / WARPS);
    for (int i = 1; i < nlist; ++i) {
        step_kernel<<<n_parts, WARPS * 32, 0, stream>>>(
            x, cents + (long long)(i - 1) * dims, n, dims, i == 1, d2, part_v,
            part_i);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        pick_kernel<<<1, PICK_THREADS, 0, stream>>>(
            part_v, part_i, n_parts, x, dims, cents + (long long)i * dims);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    return 0;
}
