// Shared device code of the BM25 kernel families (bm25_flat,
// bm25_flat_seg, bm25_coarse, bm25_rerank, bm25_scores), which the
// rank_features families (sparse_common.cuh, tiles.cuh) reuse.
//
// Three pieces, each written once and used by every family:
//
// 1. The per-posting BM25 contribution, in f32 (contrib_f32) and in the
//    bf16 arithmetic of the coarse tier (contrib_bf16). Every operation is
//    an explicitly rounded intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn), so
//    nvcc cannot contract a multiply-add into an FMA: the kernel computes
//    the same bits as the plain PyTorch version, one rounded op at a time.
// 2. Deterministic accumulation. Float atomics add in no fixed order, so
//    each f32 contribution becomes a signed 64-bit fixed-point value
//    (scale 2^32) and is summed with integer atomics, which commute. The
//    sum is converted to f32 once. The same contributions therefore give
//    the same bits in any order, any batch and any family.
// 3. The exact tier's candidate handling: each row's k' coarse candidates
//    sorted by doc id (so a posting finds its slot by binary search), the
//    re-scoring of candidate postings, and the mask + top-k + eps pass over
//    the re-scored slots.
//
// Every piece takes a slot axis (``Slots``): S block stores of one shape
// stacked as [S, NB, BLOCK] with [S, n_docs_pad] doc arrays, the flat
// operands as G = S * groups_per_slot groups of fb entries, and G * n_q
// output rows. The mesh families (mesh_bm25_flat, mesh_bm25_coarse,
// mesh_bm25_rerank) run every slot in one launch this way (the first two
// through tiles.cuh, which takes the same axis); the one-shard
// families pass ONE_SLOT (one group, strides 0), so each slot of a mesh
// launch runs exactly the one-shard arithmetic on its own plane.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace bm25 {

using namespace topk;

constexpr int BLOCK = 128;          // postings per block (index/segment.py)
constexpr int MAX_SEGS = 4096;      // largest per-segment count channel
constexpr double FIX_SCALE = 4294967296.0;        // 2^32
constexpr double FIX_INV = 1.0 / 4294967296.0;

// The slot axis. Group g of the flat operands belongs to slot
// g / groups_per_slot; its postings index that slot's block store
// (slot * slot_blocks elements in) and doc arrays (slot * slot_docs), and
// its query ids are local to the group: output row g * n_q + q.
struct Slots {
    int groups;             // flat groups (the scatter's grid y)
    int groups_per_slot;    // consecutive groups sharing one slot's plane
    long long slot_blocks;  // elements of one slot's [NB, BLOCK] store
    long long slot_docs;    // elements of one slot's [n_docs_pad] arrays
};
constexpr Slots ONE_SLOT{1, 1, 0, 0};

inline bool slots_ok(Slots sl) {
    return sl.groups >= 1 && sl.groups_per_slot >= 1 &&
           sl.groups % sl.groups_per_slot == 0 && sl.slot_blocks >= 0 &&
           sl.slot_docs >= 0;
}

// BM25 constants, rounded once on the host exactly as PyTorch rounds a
// Python float scalar: k1, (1 - b), b, (k1 + 1).
struct Consts {
    float k1, omb, b, k1p1;
};

__device__ __forceinline__ float contrib_f32(float w, float tf, float dl,
                                             float avg, Consts c) {
    // norm = k1 * ((1 - b) + (b * dl) / avg)
    float norm = __fmul_rn(c.k1, __fadd_rn(c.omb,
                                           __fdiv_rn(__fmul_rn(c.b, dl),
                                                     avg)));
    // ((w * tf) * (k1 + 1)) / (tf + norm)
    return __fdiv_rn(__fmul_rn(__fmul_rn(w, tf), c.k1p1),
                     __fadd_rn(tf, norm));
}

// Round an f32 to the nearest bf16 and widen it back.
__device__ __forceinline__ float bfr(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

// The coarse tier's contribution: every operand is a bf16 value and every
// operation but the last is rounded to bf16 (computed in f32, rounded
// once: the rounding PyTorch's bf16 elementwise ops apply, and for
// products and sums of bf16 values exactly __hmul / __hadd). The final
// quotient stays f32, as the JAX program computes it: XLA drops the bf16
// rounding of a value that is widened to f32 right after. ``c`` must hold
// bf16-representable constants.
__device__ __forceinline__ float contrib_bf16(float w_h, float tf_h,
                                              float dl_h, float avg_h,
                                              Consts c) {
    float t = bfr(__fmul_rn(c.b, dl_h));
    t = bfr(__fdiv_rn(t, avg_h));
    t = bfr(__fadd_rn(c.omb, t));
    float norm = bfr(__fmul_rn(c.k1, t));
    float num = bfr(__fmul_rn(w_h, tf_h));
    num = bfr(__fmul_rn(num, c.k1p1));
    float den = bfr(__fadd_rn(tf_h, norm));
    return __fdiv_rn(num, den);
}

// f32 contribution -> fixed point. A strictly positive contribution never
// rounds to 0, so "score > 0" flags exactly the docs some posting reached.
__device__ __forceinline__ long long to_fixed(float c) {
    long long v = __double2ll_rn((double)c * FIX_SCALE);
    return (c > 0.f && v < 1) ? 1 : v;
}

__device__ __forceinline__ float from_fixed(long long v) {
    return __double2float_rn((double)v * FIX_INV);
}

// --------------------------------------------------------------------------
// scatter: one CTA per gathered posting block, one thread per posting
// --------------------------------------------------------------------------

// grid (fb, sl.groups): acc[(g * n_q + q) * n_docs_pad + doc] +=
// fixed(f32 contribution) for the postings of group g's fb gathered
// blocks (the sharded programs; K1-K3 and K8 sum in tiles.cuh's
// shared-memory tiles). SCALAR: one avgdl for every entry (flat_avgdl[0])
// and q = 0 for every entry (flat_q unread), the sharded programs'
// operands (sharded_common.cuh).
template <bool SCALAR = false>
__global__ void scatter_kernel(const int* __restrict__ block_docs,
                               const float* __restrict__ block_tfs,
                               const int* __restrict__ flat_idx,
                               const float* __restrict__ flat_w,
                               const int* __restrict__ flat_q,
                               const float* __restrict__ doc_lens,
                               const float* __restrict__ flat_avgdl,
                               long long n_docs_pad, int fb, int n_q,
                               Slots sl, Consts c,
                               unsigned long long* __restrict__ acc) {
    const long long g = blockIdx.y;
    const long long f = g * fb + blockIdx.x;
    const long long slot = g / sl.groups_per_slot;
    const long long e = slot * sl.slot_blocks +
                        (long long)flat_idx[f] * BLOCK + threadIdx.x;
    const int doc = block_docs[e];
    if (doc < 0) return;
    const float avg = SCALAR ? flat_avgdl[0] : flat_avgdl[f];
    const float v = contrib_f32(flat_w[f], block_tfs[e],
                                doc_lens[slot * sl.slot_docs + doc], avg, c);
    const long long fx = to_fixed(v);
    if (fx == 0) return;
    atomicAdd(acc + (g * n_q + (SCALAR ? 0 : flat_q[f])) * n_docs_pad + doc,
              (unsigned long long)fx);
}

// How a top-k launch counts its matches (tiles.cuh): not at all, per row,
// or per row and segment.
enum CountMode { COUNT_NONE = 0, COUNT_TOTAL = 1, COUNT_SEGS = 2 };

// --------------------------------------------------------------------------
// the exact tier: sorted candidates, re-scored slots, mask + top-k + eps
// --------------------------------------------------------------------------

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

inline int sort_candidates(const int* cand, const float* coarse_s, int n_q,
                           int kprime, int* cand_s, float* cs_s,
                           long long* acc, cudaStream_t stream) {
    int kp2 = 1;
    while (kp2 < kprime) kp2 <<= 1;
    const size_t ssmem = (size_t)kp2 * 8;
    cudaError_t err = set_smem((const void*)sort_candidates_kernel, ssmem);
    if (err != cudaSuccess) return (int)err;
    sort_candidates_kernel<<<n_q, SEL_THREADS, ssmem, stream>>>(
        cand, coarse_s, kprime, kp2, cand_s, cs_s, acc);
    return (int)cudaGetLastError();
}

// Slot of ``doc`` in one row's kprime sorted candidates, or -1.
__device__ __forceinline__ int candidate_slot(const int* cs, int kprime,
                                              int doc) {
    int lo = 0, hi = kprime;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (cs[mid] < doc) lo = mid + 1; else hi = mid;
    }
    return (lo < kprime && cs[lo] == doc) ? lo : -1;
}

// grid (n_rows): mask, top-k over the row's k' slots, eps. Row q reads
// the live mask of slot q / rows_per_slot (0 when rows_per_slot is 0).
__global__ void rerank_finish_kernel(const long long* __restrict__ acc,
                                     const int* __restrict__ cand_s,
                                     const float* __restrict__ cs_s,
                                     const uint8_t* __restrict__ live,
                                     int kprime, int k, int cap,
                                     int rows_per_slot, long long slot_docs,
                                     float* __restrict__ out_s,
                                     int* __restrict__ out_d,
                                     float* __restrict__ eps) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* bs = (float*)smem_raw;
    int* bi = (int*)(bs + cap);
    __shared__ SelShared sh;
    __shared__ int eps_bits;
    if (threadIdx.x == 0) eps_bits = 0;
    const long long base = (long long)blockIdx.x * kprime;
    if (rows_per_slot > 0) live += (blockIdx.x / rows_per_slot) * slot_docs;
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

inline int rerank_finish(const long long* acc, const int* cand_s,
                         const float* cs_s, const uint8_t* live, int n_q,
                         int kprime, int k, float* out_s, int* out_d,
                         float* eps, cudaStream_t stream,
                         int rows_per_slot = 0, long long slot_docs = 0) {
    const int cap = select_cap(k, SEL_THREADS);
    const size_t fsmem = (size_t)cap * 8;
    cudaError_t err = set_smem((const void*)rerank_finish_kernel, fsmem);
    if (err != cudaSuccess) return (int)err;
    rerank_finish_kernel<<<n_q, SEL_THREADS, fsmem, stream>>>(
        acc, cand_s, cs_s, live, kprime, k, cap, rows_per_slot, slot_docs,
        out_s, out_d, eps);
    return (int)cudaGetLastError();
}

// grid (fb, sl.groups), BLOCK threads: a posting of group g's gathered
// blocks whose doc is one of its row's sorted candidates adds its f32
// contribution (as fixed point) at that candidate's slot of
// acc[(g * n_q + q) * kprime]; all other postings are dropped. The sum
// each candidate gets is, bit for bit, the one bm25_flat forms for it.
__global__ void candidate_scatter_kernel(
    const int* __restrict__ block_docs, const float* __restrict__ block_tfs,
    const int* __restrict__ flat_idx, const float* __restrict__ flat_w,
    const int* __restrict__ flat_q, const float* __restrict__ doc_lens,
    const float* __restrict__ flat_avgdl, const int* __restrict__ cand_s,
    int kprime, int fb, int n_q, Slots sl, Consts c,
    unsigned long long* __restrict__ acc) {
    const long long g = blockIdx.y;
    const long long f = g * fb + blockIdx.x;
    const long long slot = g / sl.groups_per_slot;
    const long long e = slot * sl.slot_blocks +
                        (long long)flat_idx[f] * BLOCK + threadIdx.x;
    const int doc = block_docs[e];
    if (doc < 0) return;
    const long long row = (g * n_q + flat_q[f]) * kprime;
    const int at = candidate_slot(cand_s + row, kprime, doc);
    if (at < 0) return;
    const long long fx = to_fixed(contrib_f32(
        flat_w[f], block_tfs[e], doc_lens[slot * sl.slot_docs + doc],
        flat_avgdl[f], c));
    if (fx == 0) return;
    atomicAdd(acc + row + at, (unsigned long long)fx);
}

// The whole exact tier shared by bm25_rerank and mesh_bm25_rerank: sort
// each row's k' candidates by doc id, re-score the candidate postings,
// then mask + top-k + eps. ``fb`` and ``n_q`` are per group (the flat
// operands hold sl.groups * fb entries); cand/coarse_s and the outputs
// hold sl.groups * n_q rows.
// Returns the first CUDA error, 0 on success.
inline int rerank_tier(const int* block_docs, const float* block_tfs,
                       const int* flat_idx, const float* flat_w,
                       const int* flat_q, const float* doc_lens,
                       const float* flat_avgdl, const uint8_t* live,
                       const int* cand, const float* coarse_s, int fb,
                       int n_q, int kprime, int k, Consts c, int* cand_s,
                       float* cs_s, long long* acc, float* out_s, int* out_d,
                       float* eps, cudaStream_t stream,
                       Slots sl = ONE_SLOT) {
    if (kprime < 1 || kprime > KMAX || k < 1 || k > kprime || n_q < 1 ||
        fb < 0 || !slots_ok(sl))
        return (int)cudaErrorInvalidValue;
    const int n_rows = sl.groups * n_q;
    int err = sort_candidates(cand, coarse_s, n_rows, kprime, cand_s, cs_s,
                              acc, stream);
    if (err != 0) return err;
    if (fb > 0) {
        candidate_scatter_kernel<<<dim3(fb, sl.groups), BLOCK, 0, stream>>>(
            block_docs, block_tfs, flat_idx, flat_w, flat_q, doc_lens,
            flat_avgdl, cand_s, kprime, fb, n_q, sl, c,
            (unsigned long long*)acc);
        err = (int)cudaGetLastError();
        if (err != 0) return err;
    }
    return rerank_finish(acc, cand_s, cs_s, live, n_rows, kprime, k, out_s,
                         out_d, eps, stream, sl.groups_per_slot * n_q,
                         sl.slot_docs);
}

}  // namespace bm25
