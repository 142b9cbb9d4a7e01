// text_expansion_forward: the expansion model's whole forward pass, one
// call per batch of texts.
//
// Replaces elasticsearch_tpu/ml/text_expansion.py:111
// `text_expansion_forward` (the jitted `topm(forward(ids, direct))`):
// per text, the sum of the embedding rows of its L hashed ids (row 0 is
// the zero padding row), h = gelu(x @ W1) (tanh approximation, as
// jax.nn.gelu computes it), out = relu(h @ W2), out / (1e-6 + row max),
// plus 2.0 for each occurrence of a token among the text's direct
// vocabulary ids (-1 = padding), and the top-m (weight, feature id) in
// lax.top_k's order (weight descending, id ascending).
//
// What bounds it on the H100: at B texts, H hidden and V vocabulary it
// does 2 B H (H + V) f32 operations (B 64, H 256, V 8192: 277 MFLOP,
// 4.1 us at the 67 TFLOP/s f32 rate) and must read W2 (H V f32: 8 MiB),
// W1 and B L embedding rows (12 MB at B 64: 3.7 us at 3.35 TB/s). Every
// CTA of the second product reads its W2 tile from L2 (W2 fits in the
// 50 MB L2), so the L2 traffic is W2 times the number of row groups.
//
// Design: three kernels, the products on the CUDA cores (no library).
// (1) One CTA per group of ROWS texts sums the embedding rows in token
// order and forms x @ W1 and the gelu, one column of W1 a thread, every
// sum in k order with each product and sum rounded once (no FMA), so the
// plain PyTorch version gives the same bits. (2) One CTA per (group of
// ROWS texts, tile of TILE vocabulary columns) forms h @ W2 the same way:
// each W2 value read serves ROWS texts; it writes relu(out) and the
// tile's row maxima. (3) One CTA per text reduces the row max, counts the
// anchors in shared memory, and streams anchor + out / (1e-6 + max)
// through topk_common.cuh's CTA-wide top-k. A tensor-core product would
// sum in another order (and in TF32 unless split); that is later work.
// The plain PyTorch version is
// elasticsearch_tpu_torch/ml/text_expansion.py `text_expansion_forward_plain`.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk_common.cuh"

using namespace topk;

namespace {

constexpr int ROWS = 8;          // texts per CTA in the two products
constexpr int THREADS = 256;     // threads of a product CTA
constexpr int COLS = 4;          // vocabulary columns a thread accumulates
constexpr int TILE = THREADS * COLS;

// jax.nn.gelu's constants, rounded to f32 on the host: 0.044715,
// sqrt(2 / pi), 0.5 and 1.0.
struct Gelu {
    float cube, sqrt2pi, half, one;
};

// x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * ((x * x) * x))))),
// each op rounded once.
__device__ __forceinline__ float gelu(float x, Gelu g) {
    const float x3 = __fmul_rn(__fmul_rn(x, x), x);
    const float inner = __fadd_rn(x, __fmul_rn(g.cube, x3));
    const float t = tanhf(__fmul_rn(g.sqrt2pi, inner));
    return __fmul_rn(x, __fmul_rn(g.half, __fadd_rn(g.one, t)));
}

// grid (ceil(B / ROWS)): hid[b] = gelu(sum_l emb[ids[b, l]] @ W1).
__global__ void hidden_kernel(const int* __restrict__ ids,
                              const float* __restrict__ emb,
                              const float* __restrict__ w1, int n_rows,
                              int L, int H, Gelu g, float* __restrict__ hid) {
    extern __shared__ __align__(16) float xs[];       // [ROWS][H]
    const int row0 = blockIdx.x * ROWS;
    for (int i = threadIdx.x; i < ROWS * H; i += blockDim.x) {
        const int r = i / H;
        const int h = i - r * H;
        float acc = 0.f;
        if (row0 + r < n_rows) {
            const int* rid = ids + (long long)(row0 + r) * L;
            for (int l = 0; l < L; ++l)
                acc = __fadd_rn(acc, emb[(long long)rid[l] * H + h]);
        }
        xs[i] = acc;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
        float acc[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
        for (int k = 0; k < H; ++k) {
            const float w = w1[(long long)k * H + j];
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
                acc[r] = __fadd_rn(acc[r], __fmul_rn(xs[r * H + k], w));
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
            if (row0 + r < n_rows)
                hid[(long long)(row0 + r) * H + j] = gelu(acc[r], g);
    }
}

// grid (ceil(B / ROWS), ceil(V / TILE)): out[b, tile] = relu(hid[b] @ W2)
// and tile_max[b, tile] = the tile's max of out[b] (>= 0).
__global__ void output_kernel(const float* __restrict__ hid,
                              const float* __restrict__ w2, int n_rows,
                              int H, int V, float* __restrict__ out,
                              float* __restrict__ tile_max) {
    extern __shared__ __align__(16) float hs[];       // [ROWS][H]
    __shared__ float red[ROWS][THREADS / 32];
    const int row0 = blockIdx.x * ROWS;
    for (int i = threadIdx.x; i < ROWS * H; i += blockDim.x) {
        const int r = i / H;
        hs[i] = row0 + r < n_rows ? hid[(long long)row0 * H + i] : 0.f;
    }
    __syncthreads();
    const int c0 = blockIdx.y * TILE + threadIdx.x;
    float acc[ROWS][COLS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[r][c] = 0.f;
    for (int k = 0; k < H; ++k) {
        float w[COLS];
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
            const int col = c0 + c * THREADS;
            w[c] = col < V ? w2[(long long)k * V + col] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
            const float hk = hs[r * H + k];
#pragma unroll
            for (int c = 0; c < COLS; ++c)
                acc[r][c] = __fadd_rn(acc[r][c], __fmul_rn(hk, w[c]));
        }
    }
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        float m = 0.f;
        const bool row_ok = row0 + r < n_rows;
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
            const int col = c0 + c * THREADS;
            if (col < V) {
                const float v = fmaxf(acc[r][c], 0.f);
                if (row_ok) out[(long long)(row0 + r) * V + col] = v;
                m = fmaxf(m, v);
            }
        }
        for (int off = 16; off > 0; off >>= 1)
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        if (lane == 0) red[r][warp] = m;
    }
    __syncthreads();
    if (threadIdx.x < ROWS && row0 + threadIdx.x < n_rows) {
        float m = 0.f;
        for (int w = 0; w < THREADS / 32; ++w) m = fmaxf(m, red[threadIdx.x][w]);
        tile_max[(long long)(row0 + threadIdx.x) * gridDim.y + blockIdx.y] = m;
    }
}

// grid (B), SEL_THREADS: the row's max, its anchors, anchor + out / (eps +
// max), and its top-m.
__global__ void finish_kernel(const float* __restrict__ out,
                              const float* __restrict__ tile_max,
                              const int* __restrict__ direct, int L, int V,
                              int n_tiles, int top_m, int cap, float eps_c,
                              float* __restrict__ out_w,
                              int* __restrict__ out_i) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* bs = (float*)smem_raw;
    int* bi = (int*)(bs + cap);
    int* cnt = bi + cap;                                 // [V]
    __shared__ SelShared sh;
    __shared__ float denom;
    const long long row = blockIdx.x;
    for (int j = threadIdx.x; j < V; j += blockDim.x) cnt[j] = 0;
    __syncthreads();
    for (int l = threadIdx.x; l < L; l += blockDim.x) {
        const int d = direct[row * L + l];
        if (d >= 0 && d < V) atomicAdd(&cnt[d], 1);
    }
    if (threadIdx.x == 0) {
        float m = 0.f;
        for (int t = 0; t < n_tiles; ++t)
            m = fmaxf(m, tile_max[row * n_tiles + t]);
        denom = __fadd_rn(eps_c, m);
    }
    __syncthreads();
    const float* orow = out + row * V;
    auto load = [&](long long j, float& s, int& i) {
        const float anchor = __fmul_rn(2.f, (float)cnt[j]);
        s = __fadd_rn(anchor, __fdiv_rn(orow[j], denom));
        i = (int)j;
    };
    cta_select(load, V, top_m, cap, bs, bi, &sh);
    for (int r = threadIdx.x; r < top_m; r += blockDim.x) {
        out_w[row * top_m + r] = bs[r];
        out_i[row * top_m + r] = bi[r];
    }
}

}  // namespace

// ids, direct: [B, L] int32; emb [n_hash, H], w1 [H, H], w2 [H, V] f32.
// Scratch: hid [B, H], out [B, V], tile_max [B, ceil(V / TILE)] f32.
// Output: out_w [B, top_m] f32, out_i [B, top_m] int32.
extern "C" int text_expansion_forward_launch(
    const int* ids, const int* direct, const float* emb, const float* w1,
    const float* w2, int B, int L, int H, int V, int top_m, float cube,
    float sqrt2pi, float half, float one, float eps_c, float* hid,
    float* out, float* tile_max, float* out_w, int* out_i,
    void* stream_ptr) {
    if (B < 1 || L < 1 || H < 1 || V < 1 || top_m < 1 || top_m > KMAX ||
        top_m > V)
        return (int)cudaErrorInvalidValue;
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    const int groups = (B + ROWS - 1) / ROWS;
    const int n_tiles = (V + TILE - 1) / TILE;
    const size_t psmem = (size_t)ROWS * H * 4;
    cudaError_t err = set_smem((const void*)hidden_kernel, psmem);
    if (err != cudaSuccess) return (int)err;
    Gelu g{cube, sqrt2pi, half, one};
    hidden_kernel<<<groups, THREADS, psmem, stream>>>(ids, emb, w1, B, L, H,
                                                       g, hid);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = set_smem((const void*)output_kernel, psmem);
    if (err != cudaSuccess) return (int)err;
    output_kernel<<<dim3(groups, n_tiles), THREADS, psmem, stream>>>(
        hid, w2, B, H, V, out, tile_max);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int cap = select_cap(top_m, SEL_THREADS);
    const size_t fsmem = (size_t)cap * 8 + (size_t)V * 4;
    err = set_smem((const void*)finish_kernel, fsmem);
    if (err != cudaSuccess) return (int)err;
    finish_kernel<<<B, SEL_THREADS, fsmem, stream>>>(
        out, tile_max, direct, L, V, n_tiles, top_m, cap, eps_c, out_w,
        out_i);
    return (int)cudaGetLastError();
}
