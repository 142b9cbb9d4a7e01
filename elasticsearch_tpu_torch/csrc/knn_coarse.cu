// knn_coarse: the int8 coarse pass of the quantized kNN tier.
//
// Replaces elasticsearch_tpu/ops/knn.py:184 `knn_coarse_candidates` and
// :199 `knn_coarse_candidates_masked` (body `_coarse_plane`,
// ops/knn.py:169): the queries, quantized per row to symmetric int8 on
// the host (qq, qscale), times the plane's int8 mirror q8 [N_pad, D] with
// an int32 sum, rescaled as dots * (qscale * scales), then the similarity
// transform with the f32 queries' qn / q2, the mask allowed = live &
// exists (ANDed with the query's filter row masks[b, :] when a [B, N_pad]
// stack is given), and the top-k' candidates (coarse scores, doc ids) per
// query under (score desc, index asc).
//
// What bounds it on the H100: memory. It reads the int8 mirror once
// (134.2 MB at 1,048,576 x 128) plus scales, norms and the mask: 0.043 ms
// at 3.35 TB/s. The product is 2 * B * N_pad * D integer operations, at
// B = 1 (the solo queries this tier serves) a few hundred MOP.
//
// Design: knn_flat's tiling (knn_flat.cu) over packed int8: a CTA scores
// 512 docs against QB queries, staging 32 dims at a time as 8 words of 4
// packed int8 values; __dp4a adds four products at a time to int32 sums.
// Integer sums are exact in any order, so kernel and plain version agree
// bit for bit. The epilogue converts once (round to nearest), rescales,
// transforms and masks into a [B, N_pad] f32 plane, and topk_common.cuh's
// chunked top-k selects k'. The plain PyTorch version is
// elasticsearch_tpu_torch/ops/knn.py `knn_coarse_plain`.
#include "knn_common.cuh"

using namespace knn;

namespace {

constexpr int THREADS = 128;
constexpr int RD = 4;                 // docs per thread
constexpr int TILE = THREADS * RD;    // docs per CTA
constexpr int DW = 8;                 // packed words staged per step
constexpr int DT = DW * 4;            // dims staged per step
constexpr int MAX_TILES_Y = 65535;

// Four int8 values of row ``row`` from dim ``d`` on, packed little-endian
// into one word; dims at or past ``dims`` are 0.
__device__ __forceinline__ int pack4(const int8_t* __restrict__ row, int d,
                                     int dims, bool aligned) {
    if (aligned && d + 4 <= dims)
        return *reinterpret_cast<const int*>(row + d);
    unsigned w = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
        if (d + b < dims) w |= (unsigned)(uint8_t)row[d + b] << (8 * b);
    return (int)w;
}

template <int QB>
__global__ void __launch_bounds__(THREADS) coarse_scores_kernel(
    const int8_t* __restrict__ q8, const float* __restrict__ scales,
    const float* __restrict__ norms, const uint8_t* __restrict__ allowed,
    const uint8_t* __restrict__ masks, const int8_t* __restrict__ qq,
    const float* __restrict__ qscale, const float* __restrict__ qn,
    const float* __restrict__ q2, int n_q, int dims, long long n_docs_pad,
    long long tile0, int sim, float* __restrict__ plane) {
    __shared__ int ms[DW][TILE + 1];
    __shared__ int qs[QB][DW];
    const int t = threadIdx.x;
    const int q0 = blockIdx.x * QB;
    const long long doc0 = (tile0 + blockIdx.y) * (long long)TILE;
    const bool aligned = (dims & 3) == 0;
    int acc[QB][RD];
#pragma unroll
    for (int q = 0; q < QB; ++q)
#pragma unroll
        for (int r = 0; r < RD; ++r) acc[q][r] = 0;

    for (int d0 = 0; d0 < dims; d0 += DT) {
        const int wn = (dims - d0 < DT ? dims - d0 + 3 : DT) / 4;
        for (int e = t; e < TILE * DW; e += THREADS) {
            const int doc = e / DW, w = e % DW;
            const long long g = doc0 + doc;
            int v = 0;
            if (w < wn && g < n_docs_pad)
                v = pack4(q8 + g * dims, d0 + 4 * w, dims, aligned);
            ms[w][doc] = v;
        }
        for (int e = t; e < QB * DW; e += THREADS) {
            const int q = e / DW, w = e % DW;
            int v = 0;
            if (w < wn && q0 + q < n_q)
                v = pack4(qq + (long long)(q0 + q) * dims, d0 + 4 * w, dims,
                          aligned);
            qs[q][w] = v;
        }
        __syncthreads();
        for (int w = 0; w < wn; ++w) {
            int m[RD];
#pragma unroll
            for (int r = 0; r < RD; ++r) m[r] = ms[w][t + r * THREADS];
#pragma unroll
            for (int q = 0; q < QB; ++q) {
                const int qv = qs[q][w];
#pragma unroll
                for (int r = 0; r < RD; ++r)
                    acc[q][r] = __dp4a(qv, m[r], acc[q][r]);
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int q = 0; q < QB; ++q) {
        const int qi = q0 + q;
        if (qi >= n_q) break;
        const float qsc = qscale[qi], qnv = qn[qi], q2v = q2[qi];
#pragma unroll
        for (int r = 0; r < RD; ++r) {
            const long long doc = doc0 + t + r * THREADS;
            if (doc >= n_docs_pad) continue;
            const long long cell = (long long)qi * n_docs_pad + doc;
            float s = -INFINITY;
            if (allowed[doc] && (masks == nullptr || masks[cell])) {
                const float dot = __fmul_rn(__int2float_rn(acc[q][r]),
                                            __fmul_rn(qsc, scales[doc]));
                s = similarity(dot, norms[doc], qnv, q2v, sim);
            }
            plane[cell] = s;
        }
    }
}

template <int QB>
int launch_scores(const int8_t* q8, const float* scales, const float* norms,
                  const uint8_t* allowed, const uint8_t* masks,
                  const int8_t* qq,
                  const float* qscale, const float* qn, const float* q2,
                  int n_q, int dims, long long n_docs_pad, int sim,
                  float* plane, cudaStream_t stream) {
    const int groups = (n_q + QB - 1) / QB;
    const long long tiles = (n_docs_pad + TILE - 1) / TILE;
    for (long long tile0 = 0; tile0 < tiles; tile0 += MAX_TILES_Y) {
        const long long nt =
            tiles - tile0 < MAX_TILES_Y ? tiles - tile0 : MAX_TILES_Y;
        coarse_scores_kernel<QB><<<dim3(groups, (unsigned)nt), THREADS, 0,
                                   stream>>>(q8, scales, norms, allowed,
                                             masks, qq, qscale, qn, q2, n_q,
                                             dims, n_docs_pad, tile0, sim,
                                             plane);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

}  // namespace

// masks: [n_q, n_docs_pad] per-query filter rows, or nullptr; plane:
// [n_q, n_docs_pad] f32 scratch; chunk_s/chunk_i: n_q *
// ceil(n_docs_pad / CHUNK) * kprime entries; out_s/out_d: [n_q, kprime].
extern "C" int knn_coarse_launch(
    const int8_t* q8, const float* scales, const float* norms,
    const uint8_t* allowed, const uint8_t* masks, const int8_t* qq,
    const float* qscale, const float* qn, const float* q2, int n_q, int dims,
    long long n_docs_pad,
    int kprime, int sim, float* plane, float* chunk_s, int* chunk_i,
    float* out_s, int* out_d, void* stream_ptr) {
    if (n_q < 1 || dims < 1 || dims > MAX_DIMS || kprime < 1 ||
        kprime > KMAX || n_docs_pad < kprime || !valid_sim(sim))
        return (int)cudaErrorInvalidValue;
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    int rc;
#define KNN_COARSE_SCORES(QB)                                            \
    launch_scores<QB>(q8, scales, norms, allowed, masks, qq, qscale, qn, \
                      q2, n_q, dims, n_docs_pad, sim, plane, stream)
    if (n_q >= 16)
        rc = KNN_COARSE_SCORES(16);
    else if (n_q > 4)
        rc = KNN_COARSE_SCORES(8);
    else if (n_q > 2)
        rc = KNN_COARSE_SCORES(4);
    else if (n_q == 2)
        rc = KNN_COARSE_SCORES(2);
    else
        rc = KNN_COARSE_SCORES(1);
#undef KNN_COARSE_SCORES
    if (rc != 0) return rc;
    return plane_topk(plane, n_q, n_docs_pad, kprime, chunk_s, chunk_i, out_s,
                      out_d, stream);
}
