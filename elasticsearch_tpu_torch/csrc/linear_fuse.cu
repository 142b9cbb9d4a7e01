// linear_fuse: weighted linear fusion of R retrievers' dense score rows.
//
// Replaces elasticsearch_tpu/ops/fusion.py:67 `linear_fuse`: scores
// [R, N_pad] f32, weights [R] f32, live [N_pad] bool, k ->
// (s [k] f32, d [k] int32). With `normalize`, each retriever's row is
// min-max normalised first: mx its max over all entries, mn its min over
// the positive entries (0 where none is positive), rng = max(mx - mn,
// 1e-9), s > 0 -> (s - mn) / rng, else 0. The fused score adds s * w over
// r in r order from 0, one rounded f32 op at a time (__fmul_rn /
// __fadd_rn, so no FMA contracts them), and is -inf where the doc is not
// live or the sum is not above 0. The top-k is taken in lax.top_k's order
// (score descending, index ascending), any 1 <= k <= N_pad.
//
// What bounds it on the H100: memory -- the [R, N_pad] rows read once and
// the live mask once (R 2, N_pad 4,194,304: 37.7 MB, 0.011 ms at
// 3.35 TB/s). This kernel reads the rows twice when normalising (bounds
// pass, then fusion) and writes and re-reads the fused row once.
//
// Design: min and max are exact in any order, so the bounds pass is a
// grid reduction on an order-preserving int encoding of the floats
// (atomicMax / atomicMin); the fusion pass writes the fused row, and
// topk_common.cuh's plane_topk selects from it (chunk winners, then one
// merge CTA, in rounds of at most 4,096 for a wider k). The plain PyTorch
// version is elasticsearch_tpu_torch/ops/fusion.py `linear_fuse_plain`.
#include "topk_common.cuh"

namespace {

constexpr int THREADS = 256;

// Order-preserving int image of a float: a < b <=> enc(a) < enc(b).
__device__ __forceinline__ int enc(float f) {
    const int i = __float_as_int(f);
    return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float dec(int i) {
    return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

__global__ void bounds_init_kernel(int R, int* bounds) {
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
        bounds[2 * r] = enc(-INFINITY);       // max over all entries
        bounds[2 * r + 1] = enc(INFINITY);    // min over positive entries
    }
}

// grid (blocks, R)
__global__ void __launch_bounds__(THREADS)
bounds_kernel(const float* __restrict__ scores, long long n,
              int* __restrict__ bounds) {
    const float* row = scores + (long long)blockIdx.y * n;
    int mx = enc(-INFINITY), mn = enc(INFINITY);
    for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         j < n; j += (long long)gridDim.x * blockDim.x) {
        const float v = row[j];
        const int e = enc(v);
        mx = max(mx, e);
        if (v > 0.0f) mn = min(mn, e);
    }
    for (int o = 16; o > 0; o >>= 1) {
        mx = max(mx, __shfl_down_sync(0xffffffffu, mx, o));
        mn = min(mn, __shfl_down_sync(0xffffffffu, mn, o));
    }
    if ((threadIdx.x & 31) == 0) {
        atomicMax(&bounds[2 * blockIdx.y], mx);
        atomicMin(&bounds[2 * blockIdx.y + 1], mn);
    }
}

__global__ void __launch_bounds__(THREADS)
fuse_kernel(const float* __restrict__ scores,
            const float* __restrict__ weights,
            const unsigned char* __restrict__ live, int R, long long n,
            int normalize, const int* __restrict__ bounds,
            float* __restrict__ fused) {
    for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         j < n; j += (long long)gridDim.x * blockDim.x) {
        float acc = 0.0f;
        for (int r = 0; r < R; ++r) {
            float v = scores[(long long)r * n + j];
            if (normalize) {
                const float mx = dec(bounds[2 * r]);
                const int mn_e = bounds[2 * r + 1];
                const float mn = mn_e == enc(INFINITY) ? 0.0f : dec(mn_e);
                const float rng = fmaxf(__fsub_rn(mx, mn), 1e-9f);
                v = v > 0.0f ? __fdiv_rn(__fsub_rn(v, mn), rng) : 0.0f;
            }
            acc = __fadd_rn(acc, __fmul_rn(v, weights[r]));
        }
        fused[j] = (live[j] && acc > 0.0f) ? acc : -INFINITY;
    }
}

}  // namespace

// scores [R, n] f32, weights [R] f32, live [n] bool; bounds: 2R ints of
// scratch; fused: [n] f32 scratch; chunk_s/chunk_i: plane_topk's chunk
// winners (ceil(n / CHUNK) * min(k, KMAX) entries, unused for one chunk);
// out_s/out_d: [k]. Returns the first CUDA error, 0 on success.
extern "C" int linear_fuse_launch(const float* scores, const float* weights,
                                  const unsigned char* live, int R,
                                  long long n, int k, int normalize,
                                  int* bounds, float* fused, float* chunk_s,
                                  int* chunk_i, float* out_s, int* out_d,
                                  void* stream) {
    if (R < 1 || n < 1 || k < 1 || k > n) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    long long blocks = (n + THREADS - 1) / THREADS;
    if (blocks > 4096) blocks = 4096;
    if (normalize) {
        bounds_init_kernel<<<1, 32, 0, st>>>(R, bounds);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        bounds_kernel<<<dim3((unsigned)blocks, R), THREADS, 0, st>>>(
            scores, n, bounds);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    fuse_kernel<<<(unsigned)blocks, THREADS, 0, st>>>(
        scores, weights, live, R, n, normalize, bounds, fused);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return topk::plane_topk(fused, 1, n, k, chunk_s, chunk_i, out_s, out_d,
                            st);
}
