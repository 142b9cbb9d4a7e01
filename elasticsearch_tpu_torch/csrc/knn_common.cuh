// Shared device code of the kNN kernel families: the one-shard K5-K7 and
// K9 (knn_flat, knn_coarse, knn_rerank, knn_scores), the mesh's
// mesh_knn_topk, mesh_knn_coarse and mesh_knn_rerank, which run K5 / K6 /
// K7 for every slot of a stack of shards in one launch, and the sharded
// data plane's sharded_knn and sharded_hybrid. K5's and K6's pipelines
// are in knn_tc.cuh, K9's and the sharded scores' streaming pass in
// knn_stream.cuh; the similarity transform and the slot axis below are
// theirs too.
//
// 1. The similarity transform (similarity below), the JAX package's
//    `_coarse_similarity` / `_rerank_scores` in their operation order:
//      cosine       (1 + dot / (norm * qn + 1e-30)) / 2
//      dot_product  0.5 + dot / 2
//      l2_norm      1 / (1 + sqrt(max(norm * norm + q2 - 2 * dot, 0)))
//    Every operation is an explicitly rounded intrinsic (__fmul_rn,
//    __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn), so nvcc contracts
//    nothing into an FMA and the kernel computes the same bits as the
//    plain PyTorch version, one rounded op at a time. One exception, on
//    purpose: XLA compiles the JAX program's norm * norm + q2 into one
//    fused multiply-add, so that sum is taken with the exact product and
//    rounded once -- here in double (the product of two f32 values is
//    exact there), then to f32, as the plain version does. qn (the
//    query's norm + 1e-30) and q2 (q . q) come from the host, computed
//    once per query.
// 2. The exact dot product: both operands rounded to bf16, products summed
//    in f32 in the order d = 0, 1, ..., D-1, one query-doc pair at a time.
//    The product of two bf16 values is exact in f32 (8 + 8 significant
//    bits), so an FMA rounds exactly where a multiply then an add would:
//    the sum has the bits of the plain version's column loop, with or
//    without FMA, in any batch. (Products below f32's normal range would
//    round; vectors whose coordinate products fall under 1e-38 are outside
//    that promise.)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace knn {

using namespace topk;

enum Similarity { SIM_COSINE = 0, SIM_DOT = 1, SIM_L2 = 2 };

constexpr int MAX_DIMS = 4096;  // mapping/mappers.py MAX_VECTOR_DIMS

// Round an f32 to the nearest bf16 and widen it back.
__device__ __forceinline__ float bfr(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

// ``fused`` false: norm * norm + q2 as a rounded product then a rounded
// add, the order the sharded kNN program (F32 below) takes it in.
__device__ __forceinline__ float similarity(float dot, float norm, float qn,
                                            float q2, int sim,
                                            bool fused = true) {
    if (sim == SIM_DOT) return __fadd_rn(0.5f, __fdiv_rn(dot, 2.f));
    if (sim == SIM_COSINE)
        return __fdiv_rn(
            __fadd_rn(1.f, __fdiv_rn(dot, __fadd_rn(__fmul_rn(norm, qn),
                                                    1e-30f))),
            2.f);
    const float n2q2 =
        fused ? __double2float_rn(__dadd_rn(__dmul_rn((double)norm,
                                                      (double)norm),
                                            (double)q2))
              : __fadd_rn(__fmul_rn(norm, norm), q2);
    float d2 = __fsub_rn(n2q2, __fmul_rn(2.f, dot));
    d2 = d2 < 0.f ? 0.f : d2;
    return __fdiv_rn(1.f, __fadd_rn(1.f, __fsqrt_rn(d2)));
}

inline bool valid_sim(int sim) {
    return sim == SIM_COSINE || sim == SIM_DOT || sim == SIM_L2;
}

// 3. The slot axis. Every pass below scores S stacked planes of one shape
//    in one launch (a co-located fan-out's shards, ops/device_segment.py
//    MeshPlanePart): slot s's doc arrays start s * n_docs_pad rows in
//    ([S, N_pad, D] matrices and int8 mirrors, [S, N_pad] norms, scales and
//    masks), its per-query filter rows and its score plane s * n_q *
//    n_docs_pad cells in ([S, n_q, N_pad]), its candidates and outputs
//    s * n_q rows in; the queries and their norm terms are shared. The
//    slots ride the work items (knn_tc.cuh, knn_stream.cuh) or the row
//    index (the re-rank). The one-shard families
//    pass one slot, and each slot of a mesh launch runs exactly the
//    one-shard arithmetic on its own plane: bitwise K5 / K6 / K7 there.

// 4. The exact re-rank (K7, and mesh_knn_rerank over S slots): one CTA per
//    row r = slot * n_q + q. The row's k' candidates are bitonic-sorted by
//    id in shared memory (their coarse scores carried), the bf16-rounded
//    query sits in shared memory, and each thread scores whole candidates
//    of the slot's matrix with knn_flat's arithmetic, reading the
//    candidate's row in dim order while the warp reads the same query dim
//    (a broadcast); masked to the slot's allowed docs (and its filter row
//    masks[r, cand]), the top-k over the candidates' positions by
//    cta_select -- after the sort, position order is doc-id order, so a tie
//    resolves to the lower doc as in knn_flat -- doc -1 where the score is
//    -inf, and eps = max |exact - coarse| over the candidates that are
//    allowed and whose coarse score is finite (0 when there are none).

constexpr int RR_THREADS = 256;

// grid (n_slots * n_q). Dynamic shared memory: qv[dims] | sd[kp2] |
// sc[kp2] | ex[kprime] | bs[cap] | bi[cap].
__global__ void __launch_bounds__(RR_THREADS) rerank_kernel(
    const float* __restrict__ matrix, const float* __restrict__ norms,
    const uint8_t* __restrict__ allowed, const uint8_t* __restrict__ masks,
    const float* __restrict__ queries, const float* __restrict__ qn,
    const float* __restrict__ q2, const int* __restrict__ cand,
    const float* __restrict__ coarse_s, int n_q, long long n_docs_pad,
    int dims, int kprime, int kp2, int k, int cap, int sim,
    float* __restrict__ out_s, int* __restrict__ out_d,
    float* __restrict__ eps) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* qv = (float*)smem_raw;
    int* sd = (int*)(qv + dims);
    float* sc = (float*)(sd + kp2);
    float* ex = sc + kp2;
    float* bs = ex + kprime;
    int* bi = (int*)(bs + cap);
    __shared__ SelShared sh;
    __shared__ int eps_bits;

    const long long r = blockIdx.x;         // output row
    const int q = (int)(r % n_q);
    const long long slot0 = (r / n_q) * n_docs_pad;
    const float* __restrict__ mat = matrix + slot0 * dims;
    const float* __restrict__ nrm = norms + slot0;
    const uint8_t* __restrict__ alw = allowed + slot0;
    const long long base = r * kprime;
    if (threadIdx.x == 0) eps_bits = 0;
    for (int d = threadIdx.x; d < dims; d += blockDim.x)
        qv[d] = bfr(queries[(long long)q * dims + d]);
    for (int j = threadIdx.x; j < kp2; j += blockDim.x) {
        sd[j] = j < kprime ? cand[base + j] : INT_MAX;
        sc[j] = j < kprime ? coarse_s[base + j] : -INFINITY;
    }
    __syncthreads();
    // ascending by doc id (candidates are distinct), coarse scores carried
    for (int size = 2; size <= kp2; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            for (int t = threadIdx.x; t < (kp2 >> 1); t += blockDim.x) {
                const int lo = 2 * t - (t & (stride - 1));
                const int hi = lo + stride;
                const bool up = (lo & size) == 0;
                if ((sd[lo] > sd[hi]) == up) {
                    const int d = sd[lo]; sd[lo] = sd[hi]; sd[hi] = d;
                    const float s = sc[lo]; sc[lo] = sc[hi]; sc[hi] = s;
                }
            }
            __syncthreads();
        }
    }

    const float qnv = qn[q], q2v = q2[q];
    float my_eps = 0.f;
    for (int j = threadIdx.x; j < kprime; j += blockDim.x) {
        const long long doc = sd[j];
        const float* row = mat + doc * dims;
        float acc = 0.f;
        for (int d = 0; d < dims; ++d)
            acc = __fmaf_rn(qv[d], bfr(row[d]), acc);
        const float s = similarity(acc, nrm[doc], qnv, q2v, sim);
        const bool ok = alw[doc] != 0 &&
                        (masks == nullptr || masks[r * n_docs_pad + doc] != 0);
        ex[j] = ok ? s : -INFINITY;
        const float c = sc[j];
        if (ok && isfinite(c)) {
            const float e = fabsf(__fsub_rn(s, c));
            my_eps = e > my_eps ? e : my_eps;
        }
    }
    // eps >= 0: the order of non-negative floats is the order of their bits
    atomicMax(&eps_bits, __float_as_int(my_eps));
    __syncthreads();

    auto load = [&](long long j, float& s, int& i) {
        s = ex[j];
        i = (int)j;
    };
    cta_select(load, kprime, k, cap, bs, bi, &sh);
    if (threadIdx.x == 0) eps[r] = __int_as_float(eps_bits);
    for (int o = threadIdx.x; o < k; o += blockDim.x) {
        const float s = bs[o];
        out_s[r * k + o] = s;
        out_d[r * k + o] = isfinite(s) ? sd[bi[o]] : -1;
    }
}

// The knn_rerank pipeline: one launch over every (slot, query) row.
inline int rerank_topk(const float* matrix, const float* norms,
                       const uint8_t* allowed, const uint8_t* masks,
                       const float* queries, const float* qn, const float* q2,
                       const int* cand, const float* coarse_s, int n_slots,
                       int n_q, long long n_docs_pad, int dims, int kprime,
                       int k, int sim, float* out_s, int* out_d, float* eps,
                       cudaStream_t stream) {
    if (n_slots < 1 || n_q < 1 || (long long)n_slots * n_q > INT_MAX ||
        n_docs_pad < 1 || dims < 1 || dims > MAX_DIMS || kprime < 1 ||
        kprime > KMAX || k < 1 || k > kprime || !valid_sim(sim))
        return (int)cudaErrorInvalidValue;
    int kp2 = 1;
    while (kp2 < kprime) kp2 <<= 1;
    const int cap = select_cap(k, RR_THREADS);
    const size_t smem = (size_t)dims * 4 + (size_t)kp2 * 8 +
                        (size_t)kprime * 4 + (size_t)cap * 8;
    cudaError_t err = set_smem((const void*)rerank_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    rerank_kernel<<<n_slots * n_q, RR_THREADS, smem, stream>>>(
        matrix, norms, allowed, masks, queries, qn, q2, cand, coarse_s, n_q,
        n_docs_pad, dims, kprime, kp2, k, cap, sim, out_s, out_d, eps);
    return (int)cudaGetLastError();
}

}  // namespace knn
