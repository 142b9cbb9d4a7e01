// knn_flat: exact batched kNN top-k over one vector matrix.
//
// Replaces elasticsearch_tpu/ops/knn.py:101 `knn_topk_batch` (body
// `knn_topk_body`, ops/knn.py:84): queries [B, D] and the matrix
// [N_pad, D] rounded to bf16, their [B, D] x [D, N_pad] product summed in
// f32, the similarity transform, the mask allowed = live & exists (-inf
// elsewhere), and the top-k per query under (score desc, index asc).
//
// What bounds it on the H100: memory at the tensor cores' rate -- the f32
// matrix is read once (536.9 MB at SIFT1M's 1,048,576 x 128), 0.16 ms at
// 3.35 TB/s, while the product is 2 * B * N_pad * D flops (17.2 GFLOP at
// B = 64), 0.017 ms in bf16 on the tensor cores. On the CUDA cores, as
// here, the product itself takes at least 0.26 ms at B = 64 (67 TFLOP/s
// f32), so this kernel is bound by operations; moving the product onto
// the tensor cores (mma.sync / wgmma with TMA) is later work.
//
// Design: one CTA scores a tile of 512 docs against a group of QB
// queries (QB = 1 .. 16, a power of two), staging 16 dims of the tile at
// a time in shared memory; every thread owns 4 docs x QB queries of f32
// sums in registers and adds the products d = 0, 1, ... in order (see
// knn_common.cuh), so a row's sums never depend on the batch. The query
// groups of one tile are adjacent block ids, so the tile is read from
// device memory about once and from L2 by the other groups. The epilogue
// writes the masked scores into a [B, N_pad] f32 plane (the score plane
// is written, not fused: 4 bytes a cell, 256 MB at B = 64), which
// topk_common.cuh's chunked top-k then reads. The plain PyTorch version is
// elasticsearch_tpu_torch/ops/knn.py `knn_flat_plain`.
#include "knn_common.cuh"

using namespace knn;

namespace {

constexpr int THREADS = 128;
constexpr int RD = 4;                 // docs per thread
constexpr int TILE = THREADS * RD;    // docs per CTA
constexpr int DT = 16;                // dims staged per step
constexpr int MAX_TILES_Y = 65535;    // gridDim.y limit

// grid (query groups, doc tiles): plane[q, doc] for QB queries x TILE docs.
template <int QB>
__global__ void __launch_bounds__(THREADS) flat_scores_kernel(
    const float* __restrict__ matrix, const float* __restrict__ norms,
    const uint8_t* __restrict__ allowed, const float* __restrict__ queries,
    const float* __restrict__ qn, const float* __restrict__ q2, int n_q,
    int dims, long long n_docs_pad, long long tile0, int sim,
    float* __restrict__ plane) {
    __shared__ float ms[DT][TILE + 1];
    __shared__ float qs[QB][DT];
    const int t = threadIdx.x;
    const int q0 = blockIdx.x * QB;
    const long long doc0 = (tile0 + blockIdx.y) * (long long)TILE;
    float acc[QB][RD];
#pragma unroll
    for (int q = 0; q < QB; ++q)
#pragma unroll
        for (int r = 0; r < RD; ++r) acc[q][r] = 0.f;

    for (int d0 = 0; d0 < dims; d0 += DT) {
        const int dn = dims - d0 < DT ? dims - d0 : DT;
        for (int e = t; e < TILE * DT; e += THREADS) {
            const int doc = e / DT, dd = e % DT;
            const long long g = doc0 + doc;
            float v = 0.f;
            if (dd < dn && g < n_docs_pad)
                v = bfr(matrix[g * dims + d0 + dd]);
            ms[dd][doc] = v;
        }
        for (int e = t; e < QB * DT; e += THREADS) {
            const int q = e / DT, dd = e % DT;
            float v = 0.f;
            if (dd < dn && q0 + q < n_q)
                v = bfr(queries[(long long)(q0 + q) * dims + d0 + dd]);
            qs[q][dd] = v;
        }
        __syncthreads();
        for (int dd = 0; dd < dn; ++dd) {
            float m[RD];
#pragma unroll
            for (int r = 0; r < RD; ++r) m[r] = ms[dd][t + r * THREADS];
#pragma unroll
            for (int q = 0; q < QB; ++q) {
                const float qv = qs[q][dd];
#pragma unroll
                for (int r = 0; r < RD; ++r)
                    acc[q][r] = __fmaf_rn(qv, m[r], acc[q][r]);
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int q = 0; q < QB; ++q) {
        const int qi = q0 + q;
        if (qi >= n_q) break;
        const float qnv = qn[qi], q2v = q2[qi];
#pragma unroll
        for (int r = 0; r < RD; ++r) {
            const long long doc = doc0 + t + r * THREADS;
            if (doc >= n_docs_pad) continue;
            plane[(long long)qi * n_docs_pad + doc] =
                allowed[doc] ? similarity(acc[q][r], norms[doc], qnv, q2v,
                                          sim)
                             : -INFINITY;
        }
    }
}

template <int QB>
int launch_scores(const float* matrix, const float* norms,
                  const uint8_t* allowed, const float* queries,
                  const float* qn, const float* q2, int n_q, int dims,
                  long long n_docs_pad, int sim, float* plane,
                  cudaStream_t stream) {
    const int groups = (n_q + QB - 1) / QB;
    const long long tiles = (n_docs_pad + TILE - 1) / TILE;
    for (long long tile0 = 0; tile0 < tiles; tile0 += MAX_TILES_Y) {
        const long long nt =
            tiles - tile0 < MAX_TILES_Y ? tiles - tile0 : MAX_TILES_Y;
        flat_scores_kernel<QB><<<dim3(groups, (unsigned)nt), THREADS, 0,
                                 stream>>>(matrix, norms, allowed, queries,
                                           qn, q2, n_q, dims, n_docs_pad,
                                           tile0, sim, plane);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

}  // namespace

// plane: [n_q, n_docs_pad] f32 scratch; chunk_s/chunk_i: n_q *
// ceil(n_docs_pad / CHUNK) * k entries; out_s/out_d: [n_q, k].
extern "C" int knn_flat_launch(
    const float* matrix, const float* norms, const uint8_t* allowed,
    const float* queries, const float* qn, const float* q2, int n_q,
    int dims, long long n_docs_pad, int k, int sim, float* plane,
    float* chunk_s, int* chunk_i, float* out_s, int* out_d, void* stream_ptr) {
    if (n_q < 1 || dims < 1 || dims > MAX_DIMS || k < 1 || k > KMAX ||
        n_docs_pad < k || !valid_sim(sim))
        return (int)cudaErrorInvalidValue;
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    int rc;
    if (n_q >= 16)
        rc = launch_scores<16>(matrix, norms, allowed, queries, qn, q2, n_q,
                               dims, n_docs_pad, sim, plane, stream);
    else if (n_q > 4)
        rc = launch_scores<8>(matrix, norms, allowed, queries, qn, q2, n_q,
                              dims, n_docs_pad, sim, plane, stream);
    else if (n_q > 2)
        rc = launch_scores<4>(matrix, norms, allowed, queries, qn, q2, n_q,
                              dims, n_docs_pad, sim, plane, stream);
    else if (n_q == 2)
        rc = launch_scores<2>(matrix, norms, allowed, queries, qn, q2, n_q,
                              dims, n_docs_pad, sim, plane, stream);
    else
        rc = launch_scores<1>(matrix, norms, allowed, queries, qn, q2, n_q,
                              dims, n_docs_pad, sim, plane, stream);
    if (rc != 0) return rc;
    return plane_topk(plane, n_q, n_docs_pad, k, chunk_s, chunk_i, out_s,
                      out_d, stream);
}
