// ivf_assign: the assignment step of the IVF build's k-means.
//
// Replaces elasticsearch_tpu/ops/ivf.py:37 `_assign`: for each row x of a
// chunk [n <= ASSIGN_CHUNK, D] f32, the centroid c of [nlist, D] f32 that
// minimises c2[c] - 2 * dot(bf16(x), bf16(c)), dots summed in f32 and
// c2[c] = sum_d c[d] * c[d] over the f32 centroids; ties go to the lowest
// centroid index (jnp.argmin's first-index rule). -> int32 [n].
//
// What bounds it on the H100: operations. One chunk at a GIST1M-class
// build (n 131,072, nlist 4,096, D 960) is 2 * n * nlist * D = 1.03 TFLOP,
// 1.04 ms on the tensor cores at 989 TFLOP/s (bf16) and 15.4 ms on the
// CUDA cores at 67 TFLOP/s (f32); it reads 503 MB of rows (0.15 ms at
// 3.35 TB/s).
//
// Design: a register-tiled CUDA-core product, so that every dot is summed
// in dimension order and the kernel has the plain version's bits (the
// product of two bf16 values is exact in f32, so the FMA rounds where a
// multiply-then-add would). One CTA owns 128 rows and sweeps every
// centroid tile of 128 in ascending order; it stages 16 dims of the row
// tile and the centroid tile (rounded to bf16) in shared memory per step,
// and each of its 256 threads keeps an 8 x 8 block of f32 sums in
// registers. After a tile's last dim the threads of a row reduce their
// (value, index) candidates by shuffles under (value asc, index asc) and
// fold them into the row's running best, so the first-index rule holds
// across tiles. The tensor cores (mma.sync / wgmma) would be some 15 times
// faster but sum in another order; that is later work. The plain PyTorch
// version is elasticsearch_tpu_torch/ops/ivf.py `ivf_assign_plain`.
#include "ivf_common.cuh"

using namespace ivf;

namespace {

constexpr int BM = 128;              // rows per CTA
constexpr int BN = 128;              // centroids per tile
constexpr int BK = 16;               // dims staged per step
constexpr int TX = 16;               // threads across a tile's centroids
constexpr int TY = 16;               // threads across the rows
constexpr int TM = BM / TY;          // rows per thread
constexpr int TN = BN / TX;          // centroids per thread
constexpr int THREADS = TX * TY;

__device__ __forceinline__ bool lower(float v1, int i1, float v2, int i2) {
    return v1 < v2 || (v1 == v2 && i1 < i2);
}

// grid (ceil(n / BM)): out[row] = argmin_c (c2[c] - 2 * dot(row, c)).
// Thread (ty, tx) owns rows ty + TY * i and centroids tx + TX * j of a
// tile, so its shared-memory reads are conflict-free.
__global__ void __launch_bounds__(THREADS) assign_kernel(
    const float* __restrict__ x, const float* __restrict__ cents,
    const float* __restrict__ c2, int n, int nlist, int dims,
    int* __restrict__ out) {
    __shared__ float as[BK][BM + 1];
    __shared__ float bs[BK][BN + 1];
    const int tid = threadIdx.x;
    const int tx = tid % TX, ty = tid / TX;
    const long long row0 = (long long)blockIdx.x * BM;
    float best_v[TM];
    int best_i[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        best_v[i] = INFINITY;
        best_i[i] = INT_MAX;
    }
    for (int c0 = 0; c0 < nlist; c0 += BN) {
        float acc[TM][TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
        for (int k0 = 0; k0 < dims; k0 += BK) {
            for (int e = tid; e < BM * BK; e += THREADS) {
                const int r = e / BK, kk = e % BK;
                const int d = k0 + kk;
                const long long g = row0 + r;
                const int c = c0 + r;
                as[kk][r] = (g < n && d < dims) ? bfr(x[g * dims + d]) : 0.f;
                bs[kk][r] = (c < nlist && d < dims)
                                ? bfr(cents[(long long)c * dims + d])
                                : 0.f;
            }
            __syncthreads();
#pragma unroll
            for (int kk = 0; kk < BK; ++kk) {
                float a[TM], b[TN];
#pragma unroll
                for (int i = 0; i < TM; ++i) a[i] = as[kk][ty + TY * i];
#pragma unroll
                for (int j = 0; j < TN; ++j) b[j] = bs[kk][tx + TX * j];
#pragma unroll
                for (int i = 0; i < TM; ++i)
#pragma unroll
                    for (int j = 0; j < TN; ++j)
                        acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
            }
            __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            float bv = INFINITY;
            int bi = INT_MAX;
#pragma unroll
            for (int j = 0; j < TN; ++j) {
                const int c = c0 + tx + TX * j;
                if (c < nlist) {
                    const float v = __fsub_rn(c2[c], __fmul_rn(2.f, acc[i][j]));
                    if (lower(v, c, bv, bi)) {
                        bv = v;
                        bi = c;
                    }
                }
            }
            // the 16 threads of one row are lanes tx = 0..15 of one half-warp
#pragma unroll
            for (int off = 1; off < TX; off <<= 1) {
                const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
                const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
                if (lower(ov, oi, bv, bi)) {
                    bv = ov;
                    bi = oi;
                }
            }
            if (lower(bv, bi, best_v[i], best_i[i])) {
                best_v[i] = bv;
                best_i[i] = bi;
            }
        }
    }
    if (tx == 0) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            const long long g = row0 + ty + TY * i;
            if (g < n) out[g] = best_i[i];
        }
    }
}

}  // namespace

// x: [n, dims] f32; cents: [nlist, dims] f32; c2: [nlist] f32 scratch;
// out: [n] int32.
extern "C" int ivf_assign_launch(const float* x, const float* cents, int n,
                                 int nlist, int dims, float* c2, int* out,
                                 void* stream_ptr) {
    if (n < 1 || nlist < 1 || dims < 1 || dims > MAX_DIMS)
        return (int)cudaErrorInvalidValue;
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    const int rc = launch_centroid_norms(cents, nlist, dims, c2, stream);
    if (rc != 0) return rc;
    assign_kernel<<<(n + BM - 1) / BM, THREADS, 0, stream>>>(
        x, cents, c2, n, nlist, dims, out);
    return (int)cudaGetLastError();
}
