// Shared device code of the sharded data plane's five kernel families
// (sharded_knn, sharded_bm25, sharded_bm25_batch, sharded_sparse,
// sharded_hybrid): the JAX package's parallel/sharded_search.py programs,
// whose corpus is cut round-robin into S slots (doc g -> slot g % S, local
// g / S) of N = n_per_shard docs each.
//
// Each JAX program scores every slot, takes a local top-k per slot,
// all-gathers the S slot-major winner lists over the `shard` axis and
// takes a global top-k of those S * k pairs. This port computes the same
// selection in one pass over the whole [S * N] score space:
//
// - Mesh-global order (rows 40, 41, 43 and both branches of 44). Each
//   slot's local top-k (lax.top_k) breaks ties by lower local index; the
//   global lax.top_k over the slot-major concatenation breaks ties by
//   lower position, that is by lower slot, then by the slot's own order.
//   Together: score descending, then mesh-global id slot * N + local
//   ascending. Every doc of the global top-k is in its slot's local top-k
//   (that list is the slot's best k in the same order), so the global
//   top-k is the top-k of the flat [S * N] row indexed by mesh-global id.
// - Original-id order (row 42). The JAX program sorts the gathered pairs
//   by (score descending, original id local * S + slot ascending). Within
//   one slot, original ids ascend with local ids, so each slot's local
//   top-k is its best k in that order too, and the global top-k is the
//   top-k of the flat row indexed by original id: the slots interleaved,
//   index local * S + slot.
//
// So one selection, topk_common.cuh's chunked CTA top-k (score
// descending, index ascending, the rounds above KMAX included), reads the
// [S, Q, N] score plane through an index map (select_slots below) and
// writes the flat index, which IS the answer's id. A score that is not
// finite gets id -1, and where k exceeds the S * N entries the output is
// padded with (-inf, -1), as the JAX program's `_topk_padded` pads each
// slot's list (finish_kernel).
//
// The scoring reuses the one-shard pipelines with their slot axis:
// knn_stream.cuh's streaming pass (``knn::sharded_scores`` in
// sharded_scores.cuh: bf16 operands for cosine and dot_product as K5;
// F32 for l2_norm, whose dot the JAX program takes in f32; -inf where a
// slot row holds no vector), bm25_common.cuh's scatter (SCALAR: one avgdl
// for the whole corpus; ``bm25_plane`` below) and sparse_common.cuh's
// linear scatter (in sharded_sparse.cu), both summing 64-bit fixed point
// with integer atomics, so every sum is rounded once and the kernel is
// bitwise its plain PyTorch version
// (elasticsearch_tpu_torch/parallel/sharded_search.py). A doc whose sum
// is not > 0 scores -inf.
#pragma once

#include "bm25_common.cuh"

namespace sharded {

using namespace topk;

// grid (n_chunks, n_q), SEL_THREADS threads: the top-k of one CHUNK of
// query row q's flat [n_slots * n_docs_pad] space, among the entries after
// the row's cursor, to out_s/out_i[q * out_ld + out_off + chunk * k + r].
// Flat index g reads cell (slot * n_q + q) * n_docs_pad + local of the
// [n_slots, n_q, n_docs_pad] plane, with (slot, local) = (g / N, g % N)
// (mesh-global order) or, ORIG, (g % S, g / S) (original-id order).
// FIXED: the plane is fixed-point sums, masked to score > 0 (else -inf),
// and the matches are counted into hits[q] (when hits is not null);
// otherwise it is an f32 plane taken as it is.
template <bool FIXED, bool ORIG>
__global__ void select_kernel(const void* __restrict__ plane, int n_slots,
                              long long n_docs_pad, int n_q, int k, int cap,
                              Cursor cur, float* __restrict__ out_s,
                              int* __restrict__ out_i, long long out_ld,
                              long long out_off, int* __restrict__ hits) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* bs = (float*)smem_raw;
    int* bi = (int*)(bs + cap);
    __shared__ SelShared sh;
    __shared__ int total;
    if (threadIdx.x == 0) total = 0;
    // (cta_select's first barrier orders this write before any use)

    const int q = blockIdx.y;
    const long long n_all = (long long)n_slots * n_docs_pad;
    const long long start = (long long)blockIdx.x * CHUNK;
    long long end = start + CHUNK;
    if (end > n_all) end = n_all;
    const long long n = end > start ? end - start : 0;
    float cs = 0.f;
    int ci = 0;
    const bool has = read_cursor(cur, q, cs, ci);
    int my = 0;
    auto load = [&](long long j, float& s, int& i) {
        const long long g = start + j;
        const long long slot = ORIG ? g % n_slots : g / n_docs_pad;
        const long long local = ORIG ? g / n_slots : g % n_docs_pad;
        const long long cell = (slot * n_q + q) * n_docs_pad + local;
        if (FIXED) {
            const long long v = ((const long long*)plane)[cell];
            const bool m = v > 0;
            s = m ? bm25::from_fixed(v) : -INFINITY;
            my += m;
        } else {
            s = ((const float*)plane)[cell];
        }
        i = (int)g;
        past_cursor(has, cs, ci, s, i);
    };
    cta_select(load, n, k, cap, bs, bi, &sh);
    if (FIXED && hits != nullptr) {
        if (my) atomicAdd(&total, my);
        __syncthreads();
        if (threadIdx.x == 0 && total) atomicAdd(hits + q, total);
    }
    const long long o = (long long)q * out_ld + out_off +
                        (long long)blockIdx.x * k;
    for (int r = threadIdx.x; r < k; r += blockDim.x) {
        out_s[o + r] = bs[r];
        out_i[o + r] = bi[r];
    }
}

// Chunk-winner scratch of a select_slots call: entries of chunk_s and
// chunk_i (at least 1; unused when a row is one chunk).
inline long long select_scratch(int n_slots, long long n_docs_pad, int n_q,
                                int kk) {
    const long long nc = ((long long)n_slots * n_docs_pad + CHUNK - 1) / CHUNK;
    return nc > 1 ? (long long)n_q * nc * (kk < KMAX ? kk : KMAX) : 1;
}

// The top-kk (1 <= kk <= n_slots * n_docs_pad) of each of the n_q rows of
// a [n_slots, n_q, n_docs_pad] plane in the order select_kernel reads it,
// into sel_s/sel_i [n_q, kk]: per round of at most KMAX, chunk winners,
// then one merge CTA a row (skipped when a row is one chunk). With FIXED
// and hits, the first round counts each row's matches into hits [n_q]
// (zeroed here). Returns the first CUDA error, 0 on success.
template <bool FIXED, bool ORIG>
int select_slots(const void* plane, int n_slots, long long n_docs_pad,
                 int n_q, int kk, float* chunk_s, int* chunk_i, float* sel_s,
                 int* sel_i, int* hits, cudaStream_t stream) {
    const long long n_all = (long long)n_slots * n_docs_pad;
    if (n_slots < 1 || n_docs_pad < 1 || n_q < 1 || n_q > 65535 || kk < 1 ||
        kk > n_all || n_all > INT_MAX)
        return (int)cudaErrorInvalidValue;
    cudaError_t err;
    if (hits != nullptr) {
        err = cudaMemsetAsync(hits, 0, sizeof(int) * (size_t)n_q, stream);
        if (err != cudaSuccess) return (int)err;
    }
    const int n_chunks = (int)((n_all + CHUNK - 1) / CHUNK);
    err = set_smem((const void*)select_kernel<FIXED, ORIG>,
                   (size_t)select_cap(round_k(kk, 0), SEL_THREADS) * 8);
    if (err != cudaSuccess) return (int)err;
    for (int done = 0; done < kk; done += KMAX) {
        const int kr = round_k(kk, done);
        const int cap = select_cap(kr, SEL_THREADS);
        const Cursor cur{sel_s, sel_i, kk, done};
        const bool direct = n_chunks == 1;
        select_kernel<FIXED, ORIG><<<dim3(n_chunks, n_q), SEL_THREADS,
                                     (size_t)cap * 8, stream>>>(
            plane, n_slots, n_docs_pad, n_q, kr, cap, cur,
            direct ? sel_s : chunk_s, direct ? sel_i : chunk_i,
            direct ? (long long)kk : (long long)n_chunks * kr,
            direct ? (long long)done : 0, done == 0 ? hits : nullptr);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        if (!direct) {
            const int rc = merge_round(chunk_s, chunk_i, n_chunks, n_q, kr,
                                       kk, done, sel_s, sel_i, stream);
            if (rc != 0) return rc;
        }
    }
    return 0;
}

constexpr int FINISH_THREADS = 256;

// out[row, r] = (sel_s[row, r], sel_i[row, r]) for r < kk, with id -1
// where the score is not finite; (-inf, -1) for kk <= r < k.
__global__ void finish_kernel(const float* __restrict__ sel_s,
                              const int* __restrict__ sel_i, long long n,
                              int kk, int k, float* __restrict__ out_s,
                              int* __restrict__ out_i) {
    const long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (x >= n) return;
    const long long row = x / k;
    const int r = (int)(x % k);
    float s = -INFINITY;
    int i = -1;
    if (r < kk) {
        s = sel_s[row * kk + r];
        if (isfinite(s)) i = sel_i[row * kk + r];
    }
    out_s[x] = s;
    out_i[x] = i;
}

inline int finish(const float* sel_s, const int* sel_i, int n_rows, int kk,
                  int k, float* out_s, int* out_i, cudaStream_t stream) {
    const long long n = (long long)n_rows * k;
    finish_kernel<<<(unsigned)((n + FINISH_THREADS - 1) / FINISH_THREADS),
                    FINISH_THREADS, 0, stream>>>(sel_s, sel_i, n, kk, k,
                                                 out_s, out_i);
    return (int)cudaGetLastError();
}

// Entries the selection takes for a k-wide answer over S * N docs.
inline int kept(int k, int n_slots, long long n_docs_pad) {
    const long long n_all = (long long)n_slots * n_docs_pad;
    return (long long)k < n_all ? k : (int)n_all;
}

// Scratch of one global selection, carved by the caller: the chunk
// winners (select_scratch entries) and the kept winners [n_q, kk].
struct SelScratch {
    float* chunk_s;
    int* chunk_i;
    float* sel_s;
    int* sel_i;
};

// select_slots then finish: the [n_q, k] answer of a plane.
template <bool FIXED, bool ORIG>
int global_topk(const void* plane, int n_slots, long long n_docs_pad,
                int n_q, int k, SelScratch sc, float* out_s, int* out_i,
                int* hits, cudaStream_t stream) {
    if (k < 1) return (int)cudaErrorInvalidValue;
    const int kk = kept(k, n_slots, n_docs_pad);
    int rc = select_slots<FIXED, ORIG>(plane, n_slots, n_docs_pad, n_q, kk,
                                       sc.chunk_s, sc.chunk_i, sc.sel_s,
                                       sc.sel_i, hits, stream);
    if (rc != 0) return rc;
    return finish(sc.sel_s, sc.sel_i, n_q, kk, k, out_s, out_i, stream);
}

// --------------------------------------------------------------------------
// the BM25 scoring pass (each entry file includes only the headers its
// passes need: knn_common.cuh and sparse_common.cuh compile every kernel
// they define into each file that includes them)
// --------------------------------------------------------------------------

// Rows 41 and 42's local scores (`_local_bm25_scores`): the [S, n_q, N]
// fixed-point plane of n_q queries' block lists [S, n_q, qb] (block ids
// local to the slot's store; block 0 / weight 0 as padding), every
// contribution with the one avgdl at avgdl[0]. bm25_common.cuh's scatter
// with one group per (slot, query) row. acc is zeroed here.
inline int bm25_plane(const int* block_docs, const float* block_tfs,
                      const float* doc_lens, const float* avgdl,
                      const int* block_idx, const float* block_w,
                      int n_slots, long long nb, int qb, long long n_docs_pad,
                      int n_q, bm25::Consts c, long long* acc,
                      cudaStream_t stream) {
    const long long rows = (long long)n_slots * n_q;
    if (n_slots < 1 || nb < 1 || qb < 0 || n_q < 1 || rows > 65535 ||
        n_docs_pad < 1)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaMemsetAsync(
        acc, 0, sizeof(long long) * (size_t)rows * (size_t)n_docs_pad,
        stream);
    if (err != cudaSuccess) return (int)err;
    if (qb == 0) return 0;
    const bm25::Slots sl{(int)rows, n_q, nb * bm25::BLOCK, n_docs_pad};
    bm25::scatter_kernel<true><<<dim3(qb, (unsigned)rows), bm25::BLOCK, 0,
                                 stream>>>(
        block_docs, block_tfs, block_idx, block_w, nullptr, doc_lens, avgdl,
        n_docs_pad, qb, 1, sl, c, (unsigned long long*)acc);
    return (int)cudaGetLastError();
}

// --------------------------------------------------------------------------
// row 44's fusion
// --------------------------------------------------------------------------

// One CTA, SEL_THREADS threads: RRF over ids [2k] (the BM25 branch's k
// global ids, then the kNN branch's). Position p earns 1 / (rank_constant
// + r), r = p % k + 1, or 0 where its id is -1; an id's fused score is the
// sum over its positions, kept at its first position only (-inf
// elsewhere and at -1). Each branch lists an id at most once, so an id has
// at most two non-zero terms: the sum is one rounded add in any order, as
// the JAX program's `eq @ contrib` gives it. Then the top-k by (fused
// descending, position ascending), id -1 where not finite.
__global__ void rrf_fuse_kernel(const int* __restrict__ ids, int k,
                                float rank_constant, int cap,
                                float* __restrict__ out_s,
                                int* __restrict__ out_i) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* bs = (float*)smem_raw;
    int* bi = (int*)(bs + cap);
    int* sid = bi + cap;
    __shared__ SelShared sh;
    for (int p = threadIdx.x; p < 2 * k; p += blockDim.x) sid[p] = ids[p];
    __syncthreads();
    auto contrib = [&](int p) {
        return __fdiv_rn(1.f, __fadd_rn(rank_constant, (float)(p % k + 1)));
    };
    auto load = [&](long long j, float& s, int& i) {
        const int p = (int)j;
        const int id = sid[p];
        i = p;
        s = -INFINITY;
        if (id < 0) return;
        const int other = p < k ? k : 0;
        int at = -1;
        for (int x = 0; x < k; ++x)
            if (sid[other + x] == id) {
                at = other + x;
                break;
            }
        if (p >= k) {
            if (at < 0) s = contrib(p);      // else a BM25 position is first
        } else {
            s = at < 0 ? contrib(p) : __fadd_rn(contrib(p), contrib(at));
        }
    };
    cta_select(load, 2 * k, k, cap, bs, bi, &sh);
    for (int r = threadIdx.x; r < k; r += blockDim.x) {
        out_s[r] = bs[r];
        out_i[r] = isfinite(bs[r]) ? sid[bi[r]] : -1;
    }
}

inline int rrf_fuse(const int* ids, int k, float rank_constant, float* out_s,
                    int* out_i, cudaStream_t stream) {
    if (k < 1 || k > KMAX) return (int)cudaErrorInvalidValue;
    const int cap = select_cap(k, SEL_THREADS);
    const size_t smem = (size_t)cap * 8 + (size_t)2 * k * 4;
    cudaError_t err = set_smem((const void*)rrf_fuse_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    rrf_fuse_kernel<<<1, SEL_THREADS, smem, stream>>>(ids, k, rank_constant,
                                                      cap, out_s, out_i);
    return (int)cudaGetLastError();
}

}  // namespace sharded
