// Shared device code of the BM25 kernel families (bm25_flat,
// bm25_flat_seg, bm25_coarse, bm25_rerank, bm25_scores), which the
// rank_features families (sparse_common.cuh) reuse.
//
// Four pieces, each written once and used by every family:
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
// 3. The chunked mask + count + top-k over the fixed-point plane, built on
//    the CTA-wide top-k of topk_common.cuh (score descending, index
//    ascending, -inf slots included: the order lax.top_k returns).
// 4. The exact tier's candidate handling: each row's k' coarse candidates
//    sorted by doc id (so a posting finds its slot by binary search), the
//    re-scoring of candidate postings, and the mask + top-k + eps pass over
//    the re-scored slots.
//
// Every piece takes a slot axis (``Slots``): S block stores of one shape
// stacked as [S, NB, BLOCK] with [S, n_docs_pad] doc arrays, the flat
// operands as G = S * groups_per_slot groups of fb entries, and G * n_q
// output rows. The mesh families (mesh_bm25_flat, mesh_bm25_coarse,
// mesh_bm25_rerank) run every slot in one launch this way; the one-shard
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
// fixed(contribution) for the postings of group g's fb gathered blocks.
// BF16 selects the coarse tier's operands (block_tfs and doc_lens as
// bf16). SCALAR: one avgdl for every entry (flat_avgdl[0]) and q = 0 for
// every entry (flat_q unread), the sharded programs' operands
// (sharded_common.cuh).
template <bool BF16, bool SCALAR = false>
__global__ void scatter_kernel(const int* __restrict__ block_docs,
                               const void* __restrict__ block_tfs,
                               const int* __restrict__ flat_idx,
                               const float* __restrict__ flat_w,
                               const int* __restrict__ flat_q,
                               const void* __restrict__ doc_lens,
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
    const long long at = slot * sl.slot_docs + doc;
    const float avg = SCALAR ? flat_avgdl[0] : flat_avgdl[f];
    float v;
    if (BF16) {
        const __nv_bfloat16* tfs = (const __nv_bfloat16*)block_tfs;
        const __nv_bfloat16* dls = (const __nv_bfloat16*)doc_lens;
        v = contrib_bf16(bfr(flat_w[f]), __bfloat162float(tfs[e]),
                         __bfloat162float(dls[at]), bfr(avg), c);
    } else {
        v = contrib_f32(flat_w[f], ((const float*)block_tfs)[e],
                        ((const float*)doc_lens)[at], avg, c);
    }
    const long long fx = to_fixed(v);
    if (fx == 0) return;
    atomicAdd(acc + (g * n_q + (SCALAR ? 0 : flat_q[f])) * n_docs_pad + doc,
              (unsigned long long)fx);
}

// --------------------------------------------------------------------------
// chunked mask + count + top-k over a [n_q, n_docs_pad] fixed-point plane
// --------------------------------------------------------------------------

enum CountMode { COUNT_NONE = 0, COUNT_TOTAL = 1, COUNT_SEGS = 2 };

// grid (n_chunks, n_rows). Each CTA masks its chunk of one row to live
// docs with score > 0 (others -inf), counts the matches (per row, or per
// segment through seg_ids: an id outside [0, n_segs) counts nowhere), and
// writes its chunk's top-k among the entries after the row's cursor to
// out_s/out_i[q * out_ld + out_off + chunk * k + r]. Row q reads the live
// mask and seg ids of slot q / rows_per_slot (0 when rows_per_slot is 0).
// hits must start zeroed.
__global__ void chunk_select_kernel(const long long* __restrict__ acc,
                                    const uint8_t* __restrict__ live,
                                    const int* __restrict__ seg_ids,
                                    long long n_docs_pad, long long chunk,
                                    int k, int cap, int mode, int n_segs,
                                    int rows_per_slot, long long slot_docs,
                                    Cursor cur,
                                    float* __restrict__ out_s,
                                    int* __restrict__ out_i,
                                    long long out_ld, long long out_off,
                                    int* __restrict__ hits) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* bs = (float*)smem_raw;
    int* bi = (int*)(bs + cap);
    int* seg_cnt = bi + cap;
    __shared__ SelShared sh;
    __shared__ int total;

    const int q = blockIdx.y;
    const long long start = (long long)blockIdx.x * chunk;
    long long end = start + chunk;
    if (end > n_docs_pad) end = n_docs_pad;
    const long long n = end > start ? end - start : 0;
    const long long* row = acc + (long long)q * n_docs_pad;
    const long long slot = rows_per_slot > 0 ? q / rows_per_slot : 0;
    live += slot * slot_docs;
    if (seg_ids != nullptr) seg_ids += slot * slot_docs;

    if (mode == COUNT_SEGS)
        for (int s = threadIdx.x; s < n_segs; s += blockDim.x) seg_cnt[s] = 0;
    if (threadIdx.x == 0) total = 0;
    // (cta_select's first barrier orders these writes before any use)

    float cs = 0.f;
    int ci = 0;
    const bool has = read_cursor(cur, q, cs, ci);
    int my = 0;          // matches this thread saw (COUNT_TOTAL)
    int cur_seg = -1;    // run of matches in one segment (COUNT_SEGS)
    int cur_n = 0;
    auto load = [&](long long j, float& s, int& i) {
        const long long doc = start + j;
        const long long v = row[doc];
        const bool m = live[doc] && v > 0;
        s = m ? from_fixed(v) : -INFINITY;
        i = (int)doc;
        past_cursor(has, cs, ci, s, i);
        if (m) {
            if (mode == COUNT_TOTAL) {
                ++my;
            } else if (mode == COUNT_SEGS) {
                const int sg = seg_ids[doc];
                if (sg >= 0 && sg < n_segs) {
                    if (sg != cur_seg) {
                        if (cur_n) atomicAdd(&seg_cnt[cur_seg], cur_n);
                        cur_seg = sg;
                        cur_n = 0;
                    }
                    ++cur_n;
                }
            }
        }
    };
    cta_select(load, n, k, cap, bs, bi, &sh);

    if (mode == COUNT_TOTAL) {
        if (my) atomicAdd(&total, my);
        __syncthreads();
        if (threadIdx.x == 0 && total) atomicAdd(hits + q, total);
    } else if (mode == COUNT_SEGS) {
        if (cur_n) atomicAdd(&seg_cnt[cur_seg], cur_n);
        __syncthreads();
        for (int s = threadIdx.x; s < n_segs; s += blockDim.x)
            if (seg_cnt[s]) atomicAdd(hits + (long long)q * n_segs + s,
                                      seg_cnt[s]);
    }
    const long long o = (long long)q * out_ld + out_off +
                        (long long)blockIdx.x * k;
    for (int r = threadIdx.x; r < k; r += blockDim.x) {
        out_s[o + r] = bs[r];
        out_i[o + r] = bi[r];
    }
}

// Mask + count + top-k of a zeroed-then-scattered [n_q, n_docs_pad]
// fixed-point plane, any 1 <= k <= n_docs_pad: per round of at most KMAX
// (topk_common.cuh), chunk winners, then one merge CTA per row (skipped
// when a row is one chunk); the first round also counts. chunk_s/chunk_i
// hold n_q * ceil(n_docs_pad / CHUNK) * min(k, KMAX) entries. hits (may be null)
// is zeroed here. With rows_per_slot > 0, row q masks and counts with slot
// q / rows_per_slot's live and seg_ids (slot_docs elements apart).
// Returns the first CUDA error, 0 on success.
inline int select_plane(const long long* acc, const uint8_t* live,
                        const int* seg_ids, long long n_docs_pad, int n_q,
                        int k, int mode, int n_segs, float* chunk_s,
                        int* chunk_i, float* out_s, int* out_i, int* hits,
                        cudaStream_t stream, int rows_per_slot = 0,
                        long long slot_docs = 0) {
    cudaError_t err;
    if (hits != nullptr) {
        const size_t nh = (size_t)n_q * (mode == COUNT_SEGS ? n_segs : 1);
        err = cudaMemsetAsync(hits, 0, sizeof(int) * nh, stream);
        if (err != cudaSuccess) return (int)err;
    }
    const int n_chunks = (int)((n_docs_pad + CHUNK - 1) / CHUNK);
    const size_t seg_smem = mode == COUNT_SEGS ? (size_t)n_segs * 4 : 0;
    err = set_smem((const void*)chunk_select_kernel,
                   (size_t)select_cap(round_k(k, 0), SEL_THREADS) * 8 +
                       seg_smem);
    if (err != cudaSuccess) return (int)err;
    for (int done = 0; done < k; done += KMAX) {
        const int kr = round_k(k, done);
        const int cap = select_cap(kr, SEL_THREADS);
        const int m = done == 0 ? mode : COUNT_NONE;
        const size_t smem = (size_t)cap * 8 + (m == COUNT_SEGS ? seg_smem : 0);
        const Cursor cur{out_s, out_i, k, done};
        const bool direct = n_chunks == 1;
        chunk_select_kernel<<<dim3(n_chunks, n_q), SEL_THREADS, smem,
                              stream>>>(
            acc, live, seg_ids, n_docs_pad, CHUNK, kr, cap, m, n_segs,
            rows_per_slot, slot_docs, cur,
            direct ? out_s : chunk_s, direct ? out_i : chunk_i,
            direct ? (long long)k : (long long)n_chunks * kr,
            direct ? (long long)done : 0, done == 0 ? hits : nullptr);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        if (!direct) {
            const int rc = merge_round(chunk_s, chunk_i, n_chunks, n_q, kr, k,
                                       done, out_s, out_i, stream);
            if (rc != 0) return rc;
        }
    }
    return 0;
}

// The whole dense pipeline shared by bm25_flat, bm25_flat_seg, bm25_coarse
// and their mesh forms: zero the fixed-point plane, scatter every gathered
// posting into it, then select_plane. ``fb`` and ``n_q`` are per group:
// the flat operands hold sl.groups * fb entries and the outputs
// sl.groups * n_q rows. Scratch (acc, chunk winners) comes from the
// caller. Returns the first CUDA error, 0 on success.
template <bool BF16>
int dense_topk(const int* block_docs, const void* block_tfs,
               const int* flat_idx, const float* flat_w, const int* flat_q,
               const void* doc_lens, const float* flat_avgdl,
               const uint8_t* live, const int* seg_ids, int fb,
               long long n_docs_pad, int n_q, int k, int mode, int n_segs,
               Consts c, long long* acc, float* chunk_s, int* chunk_i,
               float* out_s, int* out_i, int* hits, cudaStream_t stream,
               Slots sl = ONE_SLOT) {
    if (k < 1 || n_q < 1 || fb < 0 || n_docs_pad < k || !slots_ok(sl) ||
        (mode == COUNT_SEGS && (n_segs < 1 || n_segs > MAX_SEGS)))
        return (int)cudaErrorInvalidValue;
    const int n_rows = sl.groups * n_q;
    cudaError_t err = cudaMemsetAsync(
        acc, 0, sizeof(long long) * (size_t)n_rows * (size_t)n_docs_pad,
        stream);
    if (err != cudaSuccess) return (int)err;
    if (fb > 0) {
        scatter_kernel<BF16><<<dim3(fb, sl.groups), BLOCK, 0, stream>>>(
            block_docs, block_tfs, flat_idx, flat_w, flat_q, doc_lens,
            flat_avgdl, n_docs_pad, fb, n_q, sl, c,
            (unsigned long long*)acc);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return select_plane(acc, live, seg_ids, n_docs_pad, n_rows, k, mode,
                        n_segs, chunk_s, chunk_i, out_s, out_i, hits, stream,
                        sl.groups_per_slot * n_q, sl.slot_docs);
}

// --------------------------------------------------------------------------
// one query's dense row: fixed point -> f32
// --------------------------------------------------------------------------

constexpr int CONVERT_THREADS = 256;

// out[doc] = live[doc] ? f32(acc[doc]) : 0 (live may be null: all live).
__global__ void convert_kernel(const long long* __restrict__ acc,
                               const uint8_t* __restrict__ live,
                               long long n, float* __restrict__ out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    out[i] = (live == nullptr || live[i]) ? from_fixed(acc[i]) : 0.f;
}

inline int convert_row(const long long* acc, const uint8_t* live,
                       long long n, float* out, cudaStream_t stream) {
    const long long blocks = (n + CONVERT_THREADS - 1) / CONVERT_THREADS;
    convert_kernel<<<(unsigned)blocks, CONVERT_THREADS, 0, stream>>>(
        acc, live, n, out);
    return (int)cudaGetLastError();
}

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
// then mask + top-k + eps. ``fb`` and ``n_q`` are per group, as in
// dense_topk; cand/coarse_s and the outputs hold sl.groups * n_q rows.
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
