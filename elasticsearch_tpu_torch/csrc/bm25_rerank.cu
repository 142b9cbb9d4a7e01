// bm25_rerank: the exact tier of the two-tier text path.
//
// Replaces elasticsearch_tpu/ops/bm25.py:248 `_bm25_rerank_kernel` (body
// `bm25_rerank_body`, ops/bm25.py:182): sort each row's k' coarse
// candidates by doc id, re-score only them with bm25_flat's f32
// contribution, drop every other posting, mask to live docs with
// score > 0, top-k, and eps[q] = max |exact - coarse| over the matched
// candidates.
//
// What bounds it on the H100: memory, and far less of it than bm25_flat.
// It reads the same gathered blocks (FB * 128 * 8 bytes) but writes only
// a [n_q, k'] accumulator, and reads doc_lens only for candidate
// postings.
//
// Why the simple design: three small kernels. (1) One CTA per row
// bitonic-sorts the row's candidates in shared memory and writes them
// back. (2) One CTA per gathered block finds each posting's slot by
// binary search in its row's sorted candidates (L1/L2 resident, k' <=
// 4096) and adds its fixed-point contribution there with a 64-bit integer
// atomic: the same sum, bit for bit, that bm25_flat forms for that doc.
// The reference's [n_q * n_docs_pad] slot map would be 4 GB at full
// size; the search needs none. Spreading step (2) over the gathered
// blocks keeps every SM busy even for a solo query, where one CTA per row
// would leave all but one idle. (3) One CTA per row masks, selects the
// top-k (bm25_common.cuh) and reduces eps. The plain PyTorch version is
// elasticsearch_tpu_torch/ops/bm25.py `bm25_rerank_plain`.
#include "bm25_common.cuh"

using namespace bm25;

namespace {

// grid (n_q): sort row q's candidates ascending by doc id, carrying the
// coarse scores; zero the row's accumulator.
__global__ void sort_candidates_kernel(const int* __restrict__ cand,
                                       const float* __restrict__ coarse_s,
                                       int kprime, int kp2,
                                       int* __restrict__ cand_s,
                                       float* __restrict__ cs_s,
                                       long long* __restrict__ acc) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    int* sd = (int*)smem_raw;
    float* sc = (float*)(sd + kp2);
    const long long base = (long long)blockIdx.x * kprime;
    for (int j = threadIdx.x; j < kp2; j += blockDim.x) {
        sd[j] = j < kprime ? cand[base + j] : INT_MAX;
        sc[j] = j < kprime ? coarse_s[base + j] : -INFINITY;
    }
    __syncthreads();
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
    for (int j = threadIdx.x; j < kprime; j += blockDim.x) {
        cand_s[base + j] = sd[j];
        cs_s[base + j] = sc[j];
        acc[base + j] = 0;
    }
}

// grid (fb), BLOCK threads: candidate postings add their contribution at
// their candidate's slot; all others are dropped.
__global__ void rescore_kernel(const int* __restrict__ block_docs,
                               const float* __restrict__ block_tfs,
                               const int* __restrict__ flat_idx,
                               const float* __restrict__ flat_w,
                               const int* __restrict__ flat_q,
                               const float* __restrict__ doc_lens,
                               const float* __restrict__ flat_avgdl,
                               const int* __restrict__ cand_s, int kprime,
                               Consts c, unsigned long long* __restrict__ acc) {
    const long long f = blockIdx.x;
    const long long e = (long long)flat_idx[f] * BLOCK + threadIdx.x;
    const int doc = block_docs[e];
    if (doc < 0) return;
    const long long row = (long long)flat_q[f] * kprime;
    const int* cs = cand_s + row;
    int lo = 0, hi = kprime;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (cs[mid] < doc) lo = mid + 1; else hi = mid;
    }
    if (lo >= kprime || cs[lo] != doc) return;
    const long long fx = to_fixed(contrib_f32(flat_w[f], block_tfs[e],
                                              doc_lens[doc], flat_avgdl[f], c));
    if (fx == 0) return;
    atomicAdd(acc + row + lo, (unsigned long long)fx);
}

// grid (n_q): mask, top-k over the row's k' slots, eps.
__global__ void finish_kernel(const long long* __restrict__ acc,
                              const int* __restrict__ cand_s,
                              const float* __restrict__ cs_s,
                              const uint8_t* __restrict__ live, int kprime,
                              int k, int cap, float* __restrict__ out_s,
                              int* __restrict__ out_d,
                              float* __restrict__ eps) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* bs = (float*)smem_raw;
    int* bi = (int*)(bs + cap);
    __shared__ SelShared sh;
    __shared__ int eps_bits;
    if (threadIdx.x == 0) eps_bits = 0;
    const long long base = (long long)blockIdx.x * kprime;
    float my_eps = 0.f;
    auto load = [&](long long j, float& s, int& i) {
        const long long v = acc[base + j];
        const bool ok = live[cand_s[base + j]] && v > 0;
        const float exact = from_fixed(v);
        s = ok ? exact : -INFINITY;
        i = (int)j;
        const float coarse = cs_s[base + j];
        if (ok && isfinite(coarse)) {
            const float d = fabsf(__fsub_rn(exact, coarse));
            my_eps = d > my_eps ? d : my_eps;
        }
    };
    cta_select(load, kprime, k, cap, bs, bi, &sh);
    // eps >= 0: the order of non-negative floats is the order of their bits
    atomicMax(&eps_bits, __float_as_int(my_eps));
    __syncthreads();
    if (threadIdx.x == 0) eps[blockIdx.x] = __int_as_float(eps_bits);
    for (int r = threadIdx.x; r < k; r += blockDim.x) {
        out_s[(long long)blockIdx.x * k + r] = bs[r];
        out_d[(long long)blockIdx.x * k + r] = cand_s[base + bi[r]];
    }
}

}  // namespace

extern "C" int bm25_rerank_launch(
    const int* block_docs, const float* block_tfs, const int* flat_idx,
    const float* flat_w, const int* flat_q, const float* doc_lens,
    const float* flat_avgdl, const uint8_t* live, const int* cand,
    const float* coarse_s, int fb, int n_q, int kprime, int k, float k1,
    float omb, float b, float k1p1, int* cand_s, float* cs_s, long long* acc,
    float* out_s, int* out_d, float* eps, void* stream_ptr) {
    if (kprime < 1 || kprime > KMAX || k < 1 || k > kprime || n_q < 1 ||
        fb < 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    Consts c{k1, omb, b, k1p1};
    int kp2 = 1;
    while (kp2 < kprime) kp2 <<= 1;
    const size_t ssmem = (size_t)kp2 * 8;
    cudaError_t err = set_smem((const void*)sort_candidates_kernel, ssmem);
    if (err != cudaSuccess) return (int)err;
    sort_candidates_kernel<<<n_q, SEL_THREADS, ssmem, stream>>>(
        cand, coarse_s, kprime, kp2, cand_s, cs_s, acc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (fb > 0) {
        rescore_kernel<<<fb, BLOCK, 0, stream>>>(
            block_docs, block_tfs, flat_idx, flat_w, flat_q, doc_lens,
            flat_avgdl, cand_s, kprime, c, (unsigned long long*)acc);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    const int cap = select_cap(k, SEL_THREADS);
    const size_t fsmem = (size_t)cap * 8;
    err = set_smem((const void*)finish_kernel, fsmem);
    if (err != cudaSuccess) return (int)err;
    finish_kernel<<<n_q, SEL_THREADS, fsmem, stream>>>(
        acc, cand_s, cs_s, live, kprime, k, cap, out_s, out_d, eps);
    err = cudaGetLastError();
    return (int)err;
}
