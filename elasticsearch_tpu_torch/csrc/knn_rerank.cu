// knn_rerank: the exact re-rank of the quantized kNN tier.
//
// Replaces elasticsearch_tpu/ops/knn.py:261 `knn_rerank_exact` and :274
// `knn_rerank_exact_masked` (body `knn_rerank_body`, ops/knn.py:230):
// sort each row's k' coarse candidates by doc id (carrying their coarse
// scores), score each exactly with knn_flat's arithmetic (bf16 operands,
// f32 sums in dim order, the same transform), mask to allowed docs (and,
// with a [B, N_pad] filter stack, to masks[b, cand] -- the JAX body's
// take_along_axis(masks, cand_s)), take the top-k under (score
// desc, position asc) -- after the sort, position order is doc-id order,
// so a tie resolves to the lower doc exactly as in knn_flat -- with doc
// id -1 where the score is -inf, and eps = max |exact - coarse| over the
// candidates that are allowed and whose coarse score is finite (0 when
// there are none).
//
// What bounds it on the H100: memory, and little of it: the k' gathered
// rows (B * k' * D * 4 bytes, 0.5 MB for a solo query at k' = 1024,
// D = 128), microseconds.
//
// Design: one CTA per query row (k' <= KMAX). The row's candidates are
// bitonic-sorted by id in shared memory, the bf16-rounded query sits in
// shared memory, and each thread scores whole candidates, reading the
// candidate's row in dim order while the warp reads the same query dim
// (a broadcast). The top-k is topk_common.cuh's cta_select over the
// candidates' positions. The plain PyTorch version is
// elasticsearch_tpu_torch/ops/knn.py `knn_rerank_plain`.
#include "knn_common.cuh"

using namespace knn;

namespace {

constexpr int THREADS = 256;

// grid (n_q). Dynamic shared memory: qv[dims] | sd[kp2] | sc[kp2] |
// ex[kprime] | bs[cap] | bi[cap].
__global__ void __launch_bounds__(THREADS) rerank_kernel(
    const float* __restrict__ matrix, const float* __restrict__ norms,
    const uint8_t* __restrict__ allowed, const uint8_t* __restrict__ masks,
    const float* __restrict__ queries, const float* __restrict__ qn,
    const float* __restrict__ q2, const int* __restrict__ cand,
    const float* __restrict__ coarse_s, long long n_docs_pad, int dims,
    int kprime, int kp2, int k, int cap, int sim,
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

    const int q = blockIdx.x;
    const long long base = (long long)q * kprime;
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
        const float* row = matrix + doc * dims;
        float acc = 0.f;
        for (int d = 0; d < dims; ++d)
            acc = __fmaf_rn(qv[d], bfr(row[d]), acc);
        const float s = similarity(acc, norms[doc], qnv, q2v, sim);
        const bool ok = allowed[doc] != 0 &&
                        (masks == nullptr ||
                         masks[(long long)q * n_docs_pad + doc] != 0);
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
    if (threadIdx.x == 0) eps[q] = __int_as_float(eps_bits);
    for (int r = threadIdx.x; r < k; r += blockDim.x) {
        const float s = bs[r];
        out_s[(long long)q * k + r] = s;
        out_d[(long long)q * k + r] = isfinite(s) ? sd[bi[r]] : -1;
    }
}

}  // namespace

// masks: [n_q, n_docs_pad] per-query filter rows, or nullptr; cand,
// coarse_s: [n_q, kprime]; out_s/out_d: [n_q, k]; eps: [n_q].
extern "C" int knn_rerank_launch(
    const float* matrix, const float* norms, const uint8_t* allowed,
    const uint8_t* masks, const float* queries, const float* qn,
    const float* q2, const int* cand, const float* coarse_s, int n_q,
    long long n_docs_pad, int dims, int kprime, int k, int sim,
    float* out_s, int* out_d, float* eps, void* stream_ptr) {
    if (n_q < 1 || n_docs_pad < 1 || dims < 1 || dims > MAX_DIMS ||
        kprime < 1 || kprime > KMAX || k < 1 || k > kprime ||
        !valid_sim(sim))
        return (int)cudaErrorInvalidValue;
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    int kp2 = 1;
    while (kp2 < kprime) kp2 <<= 1;
    const int cap = select_cap(k, THREADS);
    const size_t smem = (size_t)dims * 4 + (size_t)kp2 * 8 +
                        (size_t)kprime * 4 + (size_t)cap * 8;
    cudaError_t err = set_smem((const void*)rerank_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    rerank_kernel<<<n_q, THREADS, smem, stream>>>(
        matrix, norms, allowed, masks, queries, qn, q2, cand, coarse_s,
        n_docs_pad, dims, kprime, kp2, k, cap, sim, out_s, out_d, eps);
    return (int)cudaGetLastError();
}
