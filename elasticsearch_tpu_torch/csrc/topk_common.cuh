// The CTA-wide top-k shared by every kernel family (the BM25 kernels and
// the kNN kernels).
//
// Order: score descending, then index ascending, -inf slots included --
// the order lax.top_k returns. Threads stream candidates past a threshold
// (the current k-th best) into a shared buffer; when the buffer fills, a
// bitonic sort keeps the best k and raises the threshold. The result
// depends only on the candidates, never on the order threads inserted
// them.
//
// Over a whole row of n_docs_pad scores the selection runs in chunks of
// CHUNK docs, one CTA each, whose winners a second kernel merges per row
// (plane_topk below; the BM25 kernels run their own chunk pass, which also
// masks and counts).
//
// A CTA holds at most KMAX winners. A wider k (any k <= n) runs in rounds
// of at most KMAX: round r selects the best entries strictly after a
// cursor, the last entry that round r - 1 wrote (read back from the
// output row), so the rounds together give the first k entries in the
// same total order, and the first KMAX of a wider window equal the KMAX
// window. An entry that is not after the cursor loads as the sentinel
// (-inf, INT_MAX), which the selection never takes. Each round rescans the
// row: ceil(k / KMAX) passes over the same data.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace topk {

constexpr int SEL_THREADS = 512;    // threads of a selecting CTA
constexpr int KMAX = 4096;          // largest k one round takes
constexpr long long CHUNK = 65536;  // docs per CTA in the chunked top-k

struct SelShared {
    int cnt;
    float thr_s;
    int thr_i;
};

__device__ __forceinline__ bool better(float s1, int i1, float s2, int i2) {
    return s1 > s2 || (s1 == s2 && i1 < i2);
}

// The cursor of a wide round: the last entry the previous round wrote to
// row ``row`` of an output with row stride ``ld``, or none (off == 0).
struct Cursor {
    const float* s;
    const int* i;
    long long ld, off;
};

// Replace (s, i) by the sentinel (-inf, INT_MAX) unless it comes strictly
// after the cursor (cs, ci) in the selection order.
__device__ __forceinline__ void past_cursor(bool has, float cs, int ci,
                                            float& s, int& i) {
    if (has && !better(cs, ci, s, i)) {
        s = -INFINITY;
        i = INT_MAX;
    }
}

__device__ __forceinline__ bool read_cursor(Cursor c, long long row,
                                            float& cs, int& ci) {
    if (c.off <= 0) return false;
    cs = c.s[row * c.ld + c.off - 1];
    ci = c.i[row * c.ld + c.off - 1];
    return true;
}

// Sort bs/bi[0, n) best-first; n is a power of two.
__device__ void bitonic_best_first(float* bs, int* bi, int n) {
    for (int size = 2; size <= n; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            for (int t = threadIdx.x; t < (n >> 1); t += blockDim.x) {
                const int lo = 2 * t - (t & (stride - 1));
                const int hi = lo + stride;
                const bool up = (lo & size) == 0;
                const float s_lo = bs[lo], s_hi = bs[hi];
                const int i_lo = bi[lo], i_hi = bi[hi];
                if (better(s_hi, i_hi, s_lo, i_lo) == up) {
                    bs[lo] = s_hi; bs[hi] = s_lo;
                    bi[lo] = i_hi; bi[hi] = i_lo;
                }
            }
            __syncthreads();
        }
    }
}

// Keep the best k of the c buffered entries at bs/bi[0, min(c, k)),
// best-first, and raise the threshold to the k-th once there are k.
__device__ void select_compact(float* bs, int* bi, int cap, int& c, int k,
                               SelShared* sh) {
    for (int j = c + threadIdx.x; j < cap; j += blockDim.x) {
        bs[j] = -INFINITY;
        bi[j] = INT_MAX;
    }
    __syncthreads();
    bitonic_best_first(bs, bi, cap);
    c = c < k ? c : k;
    if (threadIdx.x == 0) {
        sh->cnt = c;
        if (c >= k) {
            sh->thr_s = bs[k - 1];
            sh->thr_i = bi[k - 1];
        }
    }
    __syncthreads();
}

// Top-k of the n entries load(j, s, i), j in [0, n). On return bs/bi[0, k)
// hold them best-first (sentinels (-inf, INT_MAX) past the n-th when
// n < k). ``cap`` is the buffer size: a power of two >= 2k and >=
// 2 * blockDim.x. Every thread of the CTA must call it.
template <class Load>
__device__ void cta_select(Load load, long long n, int k, int cap, float* bs,
                           int* bi, SelShared* sh) {
    if (threadIdx.x == 0) {
        sh->cnt = 0;
        sh->thr_s = -INFINITY;
        sh->thr_i = INT_MAX;
    }
    __syncthreads();
    int c = 0;
    for (long long base = 0; base < n; base += blockDim.x) {
        const long long j = base + threadIdx.x;
        int take = 0;
        float s = 0.f;
        int i = 0;
        if (j < n) {
            load(j, s, i);
            take = better(s, i, sh->thr_s, sh->thr_i);
        }
        if (take) {
            const int p = atomicAdd(&sh->cnt, 1);
            bs[p] = s;
            bi[p] = i;
        }
        c += __syncthreads_count(take);
        if (c > cap - (int)blockDim.x) select_compact(bs, bi, cap, c, k, sh);
    }
    select_compact(bs, bi, cap, c, k, sh);
}

// Buffer size for a top-k: a power of two >= 4k and >= 2 * threads.
inline int select_cap(int k, int threads) {
    int kp = 1;
    while (kp < k) kp <<= 1;
    int cap = 4 * kp;
    if (cap < 2 * threads) cap = 2 * threads;
    return cap;
}

inline cudaError_t set_smem(const void* fn, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
}

// grid (n_rows): top-k of each row's n_in chunk winners, written to
// out_s/out_i[row * out_ld + out_off + r].
__global__ void merge_select_kernel(const float* __restrict__ in_s,
                                    const int* __restrict__ in_i, int n_in,
                                    int k, int cap,
                                    float* __restrict__ out_s,
                                    int* __restrict__ out_i, long long out_ld,
                                    long long out_off) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* bs = (float*)smem_raw;
    int* bi = (int*)(bs + cap);
    __shared__ SelShared sh;
    const long long base = (long long)blockIdx.x * n_in;
    auto load = [&](long long j, float& s, int& i) {
        s = in_s[base + j];
        i = in_i[base + j];
    };
    cta_select(load, n_in, k, cap, bs, bi, &sh);
    const long long o = (long long)blockIdx.x * out_ld + out_off;
    for (int r = threadIdx.x; r < k; r += blockDim.x) {
        out_s[o + r] = bs[r];
        out_i[o + r] = bi[r];
    }
}

// grid (n_chunks, n_rows): the top-k of one CHUNK of one row of a
// [n_rows, n_cols] f32 plane (already masked: excluded slots hold -inf),
// indexed by column, among the entries after the row's cursor, to
// out_s/out_i[row * out_ld + out_off + chunk * k + r].
__global__ void plane_chunk_select_kernel(const float* __restrict__ plane,
                                          long long n_cols, int k, int cap,
                                          Cursor cur,
                                          float* __restrict__ out_s,
                                          int* __restrict__ out_i,
                                          long long out_ld,
                                          long long out_off) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* bs = (float*)smem_raw;
    int* bi = (int*)(bs + cap);
    __shared__ SelShared sh;
    const long long start = (long long)blockIdx.x * CHUNK;
    long long end = start + CHUNK;
    if (end > n_cols) end = n_cols;
    const long long n = end > start ? end - start : 0;
    const float* row = plane + (long long)blockIdx.y * n_cols + start;
    float cs = 0.f;
    int ci = 0;
    const bool has = read_cursor(cur, blockIdx.y, cs, ci);
    auto load = [&](long long j, float& s, int& i) {
        s = row[j];
        i = (int)(start + j);
        past_cursor(has, cs, ci, s, i);
    };
    cta_select(load, n, k, cap, bs, bi, &sh);
    const long long o = (long long)blockIdx.y * out_ld + out_off +
                        (long long)blockIdx.x * k;
    for (int r = threadIdx.x; r < k; r += blockDim.x) {
        out_s[o + r] = bs[r];
        out_i[o + r] = bi[r];
    }
}

// Entries a round takes: at most KMAX.
inline int round_k(int k, int done) {
    return k - done < KMAX ? k - done : KMAX;
}

// One round's merge of the chunk winners (n_chunks * kr a row) into
// out[row * k + done, + kr).
inline int merge_round(const float* chunk_s, const int* chunk_i,
                       int n_chunks, int n_rows, int kr, int k, int done,
                       float* out_s, int* out_i, cudaStream_t stream) {
    const int cap = select_cap(kr, SEL_THREADS);
    const size_t smem = (size_t)cap * 8;
    cudaError_t err = set_smem((const void*)merge_select_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    merge_select_kernel<<<n_rows, SEL_THREADS, smem, stream>>>(
        chunk_s, chunk_i, n_chunks * kr, kr, cap, out_s, out_i, k, done);
    return (int)cudaGetLastError();
}

// Row-wise top-k of a [n_rows, n_cols] f32 plane, any 1 <= k <= n_cols:
// per round, chunk winners, then one merge CTA per row (skipped when a
// row is one chunk). chunk_s/chunk_i hold the chunk winners of one round:
// n_rows * ceil(n_cols / CHUNK) * min(k, KMAX) entries (unused when a row
// is one chunk). Returns the first CUDA error, 0 on success.
inline int plane_topk(const float* plane, int n_rows, long long n_cols,
                      int k, float* chunk_s, int* chunk_i, float* out_s,
                      int* out_i, cudaStream_t stream) {
    if (k < 1 || n_rows < 1 || n_cols < k) return (int)cudaErrorInvalidValue;
    const int n_chunks = (int)((n_cols + CHUNK - 1) / CHUNK);
    cudaError_t err = set_smem((const void*)plane_chunk_select_kernel,
                               (size_t)select_cap(round_k(k, 0), SEL_THREADS) *
                                   8);
    if (err != cudaSuccess) return (int)err;
    for (int done = 0; done < k; done += KMAX) {
        const int kr = round_k(k, done);
        const int cap = select_cap(kr, SEL_THREADS);
        const Cursor cur{out_s, out_i, k, done};
        if (n_chunks == 1) {
            plane_chunk_select_kernel<<<dim3(1, n_rows), SEL_THREADS,
                                        (size_t)cap * 8, stream>>>(
                plane, n_cols, kr, cap, cur, out_s, out_i, k, done);
            err = cudaGetLastError();
            if (err != cudaSuccess) return (int)err;
            continue;
        }
        plane_chunk_select_kernel<<<dim3(n_chunks, n_rows), SEL_THREADS,
                                    (size_t)cap * 8, stream>>>(
            plane, n_cols, kr, cap, cur, chunk_s, chunk_i,
            (long long)n_chunks * kr, 0);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        const int rc = merge_round(chunk_s, chunk_i, n_chunks, n_rows, kr, k,
                                   done, out_s, out_i, stream);
        if (rc != 0) return rc;
    }
    return 0;
}

}  // namespace topk
