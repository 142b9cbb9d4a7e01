// Shared device code of the histogram-aggregation families
// (aggs_histogram, aggs_histogram_plane): per bucket of P plans, the
// count (int32) and the sum, min and max (f32) of an int32 column's
// values, where bucket = floor_div(value, interval[p]) - base[p] and a row
// counts when exists[row] and masks[p, row] hold and the bucket is in
// [0, n_buckets) (others are dropped, as mode="drop" drops them). The
// per-segment family is P = 1.
//
// What bounds it on the H100: memory for the counts, mins and maxs (the
// column, its exists bytes and each plan's mask row read once: about
// 6 bytes a row a plan). The sums are bound by latency instead: a bucket
// whose sum needs the row order is a serial chain of rounded f32 adds.
//
// 1. Which sums need the chain. The JAX package adds each bucket's terms
//    in row order on the CPU (a scatter-add from +0.0). Let a bucket's
//    terms be the integers v_1 .. v_m (f32(v) is exact for |v| < 2^24,
//    the callers' gate; f32 is exact on every integer of magnitude at
//    most 2^24) and A = |v_1| + ... + |v_m| <= 2^24. Every partial sum
//    s_i = v_1 + ... + v_i is an integer with |s_i| <= A <= 2^24, so it
//    is an f32 value, and each rounded add s_(i-1) + v_i, whose exact
//    result s_i is representable, is exact. The chain's result is
//    therefore the exact integer sum s_m, converted once, exactly; the
//    signs agree too (+0.0 for s_m = 0, as x + (-x) rounds to +0.0, and an
//    empty bucket is +0.0 on both sides). Such a bucket ("exact") runs no
//    chain. Only the others ("chain buckets", A > 2^24) are added one
//    rounded add at a time, in row order. A bucket [k * I, (k + 1) * I) of
//    a floor division never holds values of both signs, so s_m = A or -A
//    (the sign of its max), and A is all the kernel sums: in 64 bits, each
//    |v| capped at 2^25 (a cap that changes A only where A > 2^24 anyway).
// 2. Mins and maxs do not depend on the order: int -> f32 rounding is
//    monotone, so min f32(v) = f32(min v). They are integer atomics on
//    the values (order-preserving unsigned codes, so zeroed memory means
//    "no value"), taken with the counts and the sums of |v|, a row at a
//    time into shared memory and once a plan into the totals.
//
// Design: three stream operations a call.
//   (1) a memset of the header, the statistics and the look-back words;
//   (2) hist_sort_kernel, one cooperative launch whose grid barriers part
//       A. the counting pass: per (plan, chunk) task, blocked over the
//          CTAs, the statistics in shared memory (global atomics above
//          HIST_SMEM_BUCKETS), added to the plan's totals once a plan;
//          each thread loads ROWS_IN_FLIGHT rows before using any;
//       B. one CTA a plan: the outputs of every exact or empty bucket,
//          and for the chain buckets their compact ids, their regions of
//          `sorted` (16-byte aligned) and the chain list, long chains
//          first;
//       C. the one-pass stable sort of the chain buckets' rows: per
//          (plan, chunk) task, strided over the CTAs in task order, each
//          warp counts its slice's rows per chain bucket (a ballot a
//          chain bucket present, no atomics), each bucket's exclusive
//          prefix over the chunks comes by decoupled look-back (a chunk
//          publishes its aggregate, then its inclusive prefix, in one
//          32-bit word a bucket; a warp reads 32 predecessors a step), and
//          the warps place their rows in row order with warp ranks, the
//          chunk's chain ids kept in shared memory from the count;
//   (3) hist_chain_kernel: each warp takes the next chain bucket (long
//       ones first) and adds its values in row order, one rounded add at
//       a time from +0.0, while its lanes keep the next groups' cp.async
//       copies in flight in a ring in shared memory, so an add's latency
//       is the only wait but one a 512-value group.
// No stage loops serially over the chunks. The critical path is the
// longest chain's row count times one dependent f32 add.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace aggs {

constexpr int HIST_THREADS = 256;
constexpr int HIST_WARPS = HIST_THREADS / 32;
constexpr int HIST_SMEM_BUCKETS = 2048;   // phase A's statistics in smem
constexpr int HIST_SWEEP = 1024;          // chain buckets a sort sweep ranks
constexpr int CHAIN_WARPS = 4;
constexpr int CHAIN_GROUP = 512;          // values a chain warp waits for once
constexpr int CHAIN_RING = 3;             // groups a chain warp's ring holds
constexpr int CHAIN_CTAS_PER_SM = 2;
constexpr unsigned long long EXACT_LIMIT = 1ull << 24;
constexpr int LONG_CHAIN = 16384;         // rows: such chains go first
// a look-back word: flag (2 bits) | value (30 bits)
constexpr unsigned LB_AGG = 1u << 30, LB_INC = 2u << 30,
                   LB_VALUE = LB_AGG - 1;
constexpr long long MAX_ROWS = LB_VALUE;

// floor(v / d) for d > 0, as jnp.floor_divide rounds (CUDA's / truncates
// toward zero).
__device__ __forceinline__ int floor_div(int v, int d) {
    const int q = v / d;
    return (q * d != v && (v < 0) != (d < 0)) ? q - 1 : q;
}

struct Plan {
    const uint8_t* mask;
    int base, interval;
};

constexpr int ROWS_IN_FLIGHT = 4;    // rows a thread loads before using any
constexpr int KEY_CACHE_ROWS = 8192; // a sort chunk's keys kept in smem

// The bucket of row r (-1 when it does not count or r >= r1), its value
// in v; the row's three loads are independent of each other.
__device__ __forceinline__ int row_bucket_of(const int* __restrict__ values,
                                             const uint8_t* __restrict__ exists,
                                             const Plan& pl, long long r,
                                             long long r1, int n_buckets,
                                             int& v) {
    const bool in = r < r1;
    const uint8_t m = in ? pl.mask[r] : 0;
    const uint8_t e = in ? exists[r] : 0;
    v = in ? values[r] : 0;
    if (!m || !e) return -1;
    const int b = floor_div(v, pl.interval) - pl.base;
    return (b >= 0 && b < n_buckets) ? b : -1;
}

// order-preserving unsigned codes: max of code = max of v (enc_max) or
// min of v (enc_min); 0 is below every code of a value
__device__ __forceinline__ unsigned enc_max(int v) {
    return (unsigned)v ^ 0x80000000u;
}
__device__ __forceinline__ unsigned enc_min(int v) { return ~enc_max(v); }
__device__ __forceinline__ int dec_max(unsigned e) {
    return (int)(e ^ 0x80000000u);
}
__device__ __forceinline__ int dec_min(unsigned e) { return dec_max(~e); }
__device__ __forceinline__ unsigned abs_u(int v) {
    return v < 0 ? 0u - (unsigned)v : (unsigned)v;
}

// The first part of the scratch, zeroed by the call's memset.
struct Hdr {
    unsigned barrier;   // hist_sort_kernel's grid barrier
    unsigned n_long;    // chain list: long chains from the front,
    unsigned n_short;   //   short ones from the back
    unsigned queue;     // hist_chain_kernel's next list entry
    int longest;        // rows of the longest chain
    int pad[3];
    // %globaltimer ns: the sort launch's start (CTA 0), the end of its
    // counting and offsets passes (CTA 0, after each barrier), the last
    // CTA's end of the sort pass
    unsigned long long t_start, t_count, t_offsets, t_place;
};

__device__ __forceinline__ unsigned long long global_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// Byte offsets of the scratch (host and device): [0, zero_end) is zeroed.
struct Layout {
    size_t tot, vmin, vmax, sabs, state, zero_end, cid_of, coff, ccnt,
        cbuck, nchain, list, sorted, total;
};

__host__ __device__ inline size_t up16(size_t x) { return (x + 15) / 16 * 16; }

// A plan's region of `sorted`: its chain buckets' rows, each bucket's
// start rounded up to 4 values.
__host__ __device__ inline long long plan_stride(long long n, int n_buckets) {
    return (n + 4LL * n_buckets + 3) / 4 * 4;
}

__host__ __device__ inline Layout layout(long long n, int n_plans,
                                         int n_buckets, long long n_chunks) {
    const size_t cells = (size_t)n_plans * n_buckets;
    Layout L;
    size_t o = up16(sizeof(Hdr));
    L.tot = o;    o = up16(o + 4 * cells);
    L.vmin = o;   o = up16(o + 4 * cells);
    L.vmax = o;   o = up16(o + 4 * cells);
    L.sabs = o;   o = up16(o + 8 * cells);
    L.state = o;  o = up16(o + 4 * cells * (size_t)n_chunks);
    L.zero_end = o;
    L.cid_of = o; o = up16(o + 4 * cells);
    L.coff = o;   o = up16(o + 8 * cells);
    L.ccnt = o;   o = up16(o + 4 * cells);
    L.cbuck = o;  o = up16(o + 4 * cells);
    L.nchain = o; o = up16(o + 4 * (size_t)n_plans);
    L.list = o;   o = up16(o + 4 * cells);
    L.sorted = o; o = up16(o + 4 * (size_t)n_plans * plan_stride(n, n_buckets));
    L.total = o;
    return L;
}

struct Hist {
    const int* values;
    const uint8_t* exists;
    const uint8_t* masks;
    const int* bases;       // [P], or nullptr: base0 / interval0 (P 1)
    const int* intervals;
    int base0, interval0;
    long long n, n_chunks, stride;
    int n_plans, n_buckets, rows_per_chunk;
    Hdr* hdr;
    int* tot;
    unsigned *vmin, *vmax;
    unsigned long long* sabs;
    unsigned* state;
    int* cid_of;            // [P, nb]: the bucket's chain id, -1 if exact
    long long* coff;        // [P, nb] by chain id: its region of sorted
    int* ccnt;              // [P, nb] by chain id: rows
    int* cbuck;             // [P, nb] by chain id: the bucket
    int* nchain;            // [P]
    int* list;              // [P * nb]: p * nb + chain id
    float* sorted;
    int* counts;
    float *sums, *mins, *maxs;
};

__device__ __forceinline__ Plan plan_of(const Hist& h, int p) {
    if (h.bases == nullptr) return Plan{h.masks, h.base0, h.interval0};
    return Plan{h.masks + (long long)p * h.n, h.bases[p], h.intervals[p]};
}

// Every CTA of the (cooperative) grid waits here for all the others;
// ``target`` counts the arrivals expected so far. A barrier that never
// opens traps instead of hanging the card.
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& target) {
    target += gridDim.x;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
        atomicAdd(bar, 1u);
        for (unsigned polls = 0; *(volatile unsigned*)bar < target; ++polls) {
            if (polls == (1u << 26)) __trap();
            __nanosleep(64);
        }
        __threadfence();
    }
    __syncthreads();
}

// A. the counting pass, a row at a time (shared memory: cnt | min | max |
// |v| low | |v| high, n_buckets unsigned each; global atomics without
// SMEM).
template <bool SMEM>
__device__ void count_pass(const Hist& h, unsigned* s) {
    const int nb = h.n_buckets;
    constexpr unsigned CAP = 1u << 25;
    unsigned *s_cnt = s, *s_min = s + nb, *s_max = s + 2 * nb,
             *s_lo = s + 3 * nb, *s_hi = s + 4 * nb;
    const long long tasks = (long long)h.n_plans * h.n_chunks;
    const long long per = (tasks + gridDim.x - 1) / gridDim.x;
    const long long t0 = blockIdx.x * per;
    const long long t1 = t0 + per < tasks ? t0 + per : tasks;
    int cur = -1;
    auto flush = [&]() {
        __syncthreads();
        for (int b = threadIdx.x; b < nb; b += blockDim.x) {
            if (s_cnt[b] == 0) continue;
            const long long i = (long long)cur * nb + b;
            atomicAdd(h.tot + i, (int)s_cnt[b]);
            atomicMax(h.vmin + i, s_min[b]);
            atomicMax(h.vmax + i, s_max[b]);
            atomicAdd(h.sabs + i, (unsigned long long)s_lo[b] +
                                      ((unsigned long long)s_hi[b] << 32));
        }
        __syncthreads();
    };
    for (long long c = t0; c < t1; ++c) {
        const int p = (int)(c / h.n_chunks);
        const long long g = c % h.n_chunks;
        if (SMEM && p != cur) {
            if (cur >= 0) flush();
            for (int j = threadIdx.x; j < 5 * nb; j += blockDim.x) s[j] = 0;
            __syncthreads();
            cur = p;
        }
        const Plan pl = plan_of(h, p);
        if (pl.interval <= 0) continue;
        const long long r0 = g * h.rows_per_chunk;
        const long long r1 =
            r0 + h.rows_per_chunk < h.n ? r0 + h.rows_per_chunk : h.n;
        // ROWS_IN_FLIGHT rows a thread a step, their loads independent
        for (long long r = r0 + threadIdx.x; r < r1;
             r += ROWS_IN_FLIGHT * blockDim.x) {
            int bs[ROWS_IN_FLIGHT], vs[ROWS_IN_FLIGHT];
#pragma unroll
            for (int u = 0; u < ROWS_IN_FLIGHT; ++u)
                bs[u] = row_bucket_of(h.values, h.exists, pl,
                                      r + u * blockDim.x, r1, nb, vs[u]);
#pragma unroll
            for (int u = 0; u < ROWS_IN_FLIGHT; ++u) {
                const int b = bs[u], v = vs[u];
                if (b < 0) continue;
                const unsigned mag = abs_u(v) < CAP ? abs_u(v) : CAP;
                if (SMEM) {
                    atomicAdd(s_cnt + b, 1u);
                    atomicMax(s_min + b, enc_min(v));
                    atomicMax(s_max + b, enc_max(v));
                    const unsigned old = atomicAdd(s_lo + b, mag);
                    if (old + mag < old) atomicAdd(s_hi + b, 1u);
                } else {
                    const long long i = (long long)p * nb + b;
                    atomicAdd(h.tot + i, 1);
                    atomicMax(h.vmin + i, enc_min(v));
                    atomicMax(h.vmax + i, enc_max(v));
                    atomicAdd(h.sabs + i, (unsigned long long)mag);
                }
            }
        }
    }
    if (SMEM && cur >= 0) flush();
}

// Exclusive CTA-wide prefix sum of v; ``total`` gets the sum of all.
template <class T>
__device__ __forceinline__ T cta_exclusive(T v, T* warp_sums, T& total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    T x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const T y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    T before = 0, all = 0;
    for (int w = 0; w < HIST_WARPS; ++w) {
        if (w < warp) before += warp_sums[w];
        all += warp_sums[w];
    }
    __syncthreads();
    total = all;
    return before + x - v;
}

// B. one CTA a plan: exact and empty buckets' outputs; chain ids,
// regions, the chain list.
__device__ void offsets_pass(const Hist& h) {
    __shared__ long long off_sums[HIST_WARPS];
    __shared__ int id_sums[HIST_WARPS];
    const int nb = h.n_buckets;
    const long long cap = (long long)h.n_plans * nb;
    for (int p = blockIdx.x; p < h.n_plans; p += gridDim.x) {
        long long run_off = 0;
        int run_id = 0;
        for (int b0 = 0; b0 < nb; b0 += blockDim.x) {
            const int b = b0 + threadIdx.x;
            const long long i = (long long)p * nb + b;
            int cnt = 0;
            bool chain = false;
            if (b < nb) {
                cnt = h.tot[i];
                chain = cnt > 0 && h.sabs[i] > EXACT_LIMIT;
                h.counts[i] = cnt;
                h.mins[i] = cnt ? __int2float_rn(dec_min(h.vmin[i])) : INFINITY;
                h.maxs[i] = cnt ? __int2float_rn(dec_max(h.vmax[i]))
                                : -INFINITY;
                if (!chain) {      // |sum| <= 2^24, the sign of the max
                    const int a = (int)h.sabs[i];
                    h.sums[i] = __int2float_rn(
                        cnt && dec_max(h.vmax[i]) <= 0 ? -a : a);
                    h.cid_of[i] = -1;
                }
            }
            long long off_all;
            int id_all;
            const long long off = cta_exclusive<long long>(
                chain ? (cnt + 3LL) / 4 * 4 : 0LL, off_sums, off_all);
            const int id = cta_exclusive<int>(chain ? 1 : 0, id_sums, id_all);
            if (chain) {
                const int cid = run_id + id;
                const long long j = (long long)p * nb + cid;
                h.cid_of[i] = cid;
                h.coff[j] = p * h.stride + run_off + off;
                h.ccnt[j] = cnt;
                h.cbuck[j] = b;
                if (cnt >= LONG_CHAIN)
                    h.list[atomicAdd(&h.hdr->n_long, 1u)] = (int)j;
                else
                    h.list[cap - 1 - atomicAdd(&h.hdr->n_short, 1u)] = (int)j;
                atomicMax(&h.hdr->longest, cnt);
            }
            run_off += off_all;
            run_id += id_all;
        }
        if (threadIdx.x == 0) h.nchain[p] = run_id;
    }
}

// The lanes of the warp holding ``key`` (key >= 0; 0 for key < 0): one
// ballot a distinct key present, fewer than __match_any_sync costs where
// a warp's 32 rows fall in a few chain buckets.
__device__ __forceinline__ unsigned peers_of(int key) {
    unsigned todo = __ballot_sync(0xffffffffu, key >= 0), mine = 0;
    while (todo) {
        const int k = __shfl_sync(0xffffffffu, key, __ffs(todo) - 1);
        const unsigned same = __ballot_sync(0xffffffffu, key == k);
        if (key == k) mine = same;
        todo &= ~same;
    }
    return mine;
}

// The exclusive prefix of chunk g's bucket word ``word`` over the chunks
// before it (words ``stride`` apart) by decoupled look-back, one warp:
// 32 predecessors a step, summed down to the nearest inclusive prefix
// (the words before an inclusive prefix are always published).
__device__ __forceinline__ unsigned look_back(const unsigned* word,
                                              long long g,
                                              long long stride) {
    const int lane = threadIdx.x & 31;
    unsigned excl = 0, polls = 0;
    for (long long j0 = g - 1;; j0 -= 32) {
        const long long j = j0 - lane;
        const volatile unsigned* w =
            (const volatile unsigned*)(word + (j - g) * stride);
        unsigned s = j >= 0 ? *w : LB_INC;    // before chunk 0: 0, final
        while (__any_sync(0xffffffffu, (s & ~LB_VALUE) == 0)) {
            if (++polls == (1u << 26)) __trap();
            if ((s & ~LB_VALUE) == 0) s = *w;
        }
        const unsigned inc = __ballot_sync(0xffffffffu, (s & LB_INC) != 0);
        const int stop = inc ? __ffs(inc) - 1 : 31;
        unsigned v = lane <= stop ? (s & LB_VALUE) : 0u;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, o);
        excl += v;
        if (inc) return excl;
    }
}

// C. the stable sort of the chain buckets' rows. Shared memory: wcnt
// [HIST_WARPS][sweep] unsigned | base [sweep] long long | the chunk's
// rows' chain ids [rows_per_chunk] short (when the chunk and the chain ids
// fit, KEY_CACHE_ROWS; the first sweep's count writes them, the placing
// and any later sweep read them instead of the rows).
__device__ void place_pass(const Hist& h, unsigned char* smem) {
    const int nb = h.n_buckets;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    unsigned* wcnt = (unsigned*)smem;
    const int sweep_cap = nb < HIST_SWEEP ? nb : HIST_SWEEP;
    long long* base = (long long*)(smem + up16(4 * (size_t)HIST_WARPS *
                                               sweep_cap));
    short* keys = (short*)(base + sweep_cap);
    const long long tasks = (long long)h.n_plans * h.n_chunks;
    const int seg = h.rows_per_chunk / HIST_WARPS;   // a multiple of 32
    for (long long c = blockIdx.x; c < tasks; c += gridDim.x) {
        const int p = (int)(c / h.n_chunks);
        const long long g = c % h.n_chunks;
        const int n_chain = h.nchain[p];
        if (n_chain == 0) continue;
        const bool cached =
            h.rows_per_chunk <= KEY_CACHE_ROWS && n_chain <= SHRT_MAX;
        const Plan pl = plan_of(h, p);
        const int* cid_of = h.cid_of + (long long)p * nb;
        const long long r0 = g * h.rows_per_chunk + (long long)warp * seg;
        const long long r1 = r0 + seg < h.n ? r0 + seg : h.n;
        short* wkeys = keys + warp * seg;     // this warp's rows' ids
        for (int lo = 0; lo < n_chain; lo += HIST_SWEEP) {
            const int w = n_chain - lo < HIST_SWEEP ? n_chain - lo
                                                    : HIST_SWEEP;
            unsigned* mine = wcnt + warp * w;
            for (int j = threadIdx.x; j < HIST_WARPS * w; j += blockDim.x)
                wcnt[j] = 0;
            __syncthreads();
            // the row's chain id (-1 for none), from the rows or the cache
            auto cid_at = [&](long long r, bool read_rows) {
                if (!read_rows) return (int)wkeys[r - r0];
                int v;
                const int b = row_bucket_of(h.values, h.exists, pl, r, r1,
                                            nb, v);
                return b >= 0 ? cid_of[b] : -1;
            };
            const bool read_rows = !cached || lo == 0;
            for (long long r = r0; r < r1; r += 32 * ROWS_IN_FLIGHT) {
                int ids[ROWS_IN_FLIGHT];
#pragma unroll
                for (int u = 0; u < ROWS_IN_FLIGHT; ++u)
                    ids[u] = r + 32 * u < r1
                                 ? cid_at(r + 32 * u + lane, read_rows)
                                 : -1;
#pragma unroll
                for (int u = 0; u < ROWS_IN_FLIGHT; ++u) {
                    if (cached && lo == 0 && r + 32 * u < r1)
                        wkeys[r + 32 * u + lane - r0] = (short)ids[u];
                    const int key =
                        ids[u] >= lo && ids[u] < lo + w ? ids[u] - lo : -1;
                    const unsigned peers = peers_of(key);
                    if (key >= 0 && lane == __ffs(peers) - 1)
                        mine[key] += __popc(peers);
                    __syncwarp();
                }
            }
            __syncthreads();
            // each bucket's aggregate (and the warps' exclusive prefixes),
            // published; then one warp a bucket looks back
            const long long row0 = ((long long)p * h.n_chunks + g) * nb + lo;
            for (int j = threadIdx.x; j < w; j += blockDim.x) {
                unsigned agg = 0;
                for (int wi = 0; wi < HIST_WARPS; ++wi) {
                    const unsigned x = wcnt[wi * w + j];
                    wcnt[wi * w + j] = agg;
                    agg += x;
                }
                *(volatile unsigned*)(h.state + row0 + j) =
                    (g == 0 ? LB_INC : LB_AGG) | agg;
                if (g == 0) base[j] = h.coff[(long long)p * nb + lo + j];
            }
            __syncthreads();
            if (g > 0) {
                for (int j = warp; j < w; j += HIST_WARPS) {
                    unsigned* word = h.state + row0 + j;
                    const unsigned excl = look_back(word, g, nb);
                    if (lane == 0) {
                        const unsigned agg = *(volatile unsigned*)word &
                                             LB_VALUE;
                        *(volatile unsigned*)word = LB_INC | (excl + agg);
                        base[j] = h.coff[(long long)p * nb + lo + j] + excl;
                    }
                }
                __syncthreads();
            }
            // placing: ROWS_IN_FLIGHT steps of 32 rows, their ids and
            // values loaded before any is placed
            for (long long r = r0; r < r1; r += 32 * ROWS_IN_FLIGHT) {
                int keys_u[ROWS_IN_FLIGHT], vals[ROWS_IN_FLIGHT];
#pragma unroll
                for (int u = 0; u < ROWS_IN_FLIGHT; ++u) {
                    const long long row = r + 32 * u + lane;
                    const int id =
                        r + 32 * u < r1 ? cid_at(row, !cached) : -1;
                    keys_u[u] = id >= lo && id < lo + w ? id - lo : -1;
                }
#pragma unroll
                for (int u = 0; u < ROWS_IN_FLIGHT; ++u)
                    vals[u] = keys_u[u] >= 0 ? h.values[r + 32 * u + lane]
                                             : 0;
#pragma unroll
                for (int u = 0; u < ROWS_IN_FLIGHT; ++u) {
                    const int key = keys_u[u];
                    const unsigned peers = peers_of(key);
                    if (key >= 0) {
                        const unsigned rank =
                            __popc(peers & ((1u << lane) - 1u));
                        h.sorted[base[key] + mine[key] + rank] =
                            __int2float_rn(vals[u]);
                    }
                    __syncwarp();
                    if (key >= 0 && lane == __ffs(peers) - 1)
                        mine[key] += __popc(peers);
                    __syncwarp();
                }
            }
            __syncthreads();
        }
    }
}

// The counting pass, the offsets and the sort in one cooperative launch.
template <bool SMEM>
__global__ void __launch_bounds__(HIST_THREADS, 4) hist_sort_kernel(
    const Hist h) {
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned target = 0;
    const bool stamp = blockIdx.x == 0 && threadIdx.x == 0;
    if (stamp) h.hdr->t_start = global_ns();
    count_pass<SMEM>(h, (unsigned*)smem);
    grid_sync(&h.hdr->barrier, target);
    if (stamp) h.hdr->t_count = global_ns();
    offsets_pass(h);
    grid_sync(&h.hdr->barrier, target);
    if (stamp) h.hdr->t_offsets = global_ns();
    place_pass(h, smem);
    __syncthreads();
    if (threadIdx.x == 0) atomicMax(&h.hdr->t_place, global_ns());
}

// (3) one warp a chain bucket at a time: its values in row order, added
// one rounded f32 add at a time from +0.0. The lanes copy the bucket's
// values into a ring of CHAIN_RING groups of CHAIN_GROUP values in shared
// memory (cp.async, 16 bytes a lane a 128-value line, zero-filled past the
// bucket), CHAIN_RING - 1 groups ahead of the group being added; every
// lane runs the same chain over the group (broadcast reads, no exchange),
// lane 0 writes it. One wait a group: the chain stalls only there.
__global__ void __launch_bounds__(CHAIN_WARPS * 32) hist_chain_kernel(
    const Hist h) {
    __shared__ __align__(16) float ring[CHAIN_WARPS][CHAIN_RING][CHAIN_GROUP];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned n_long = h.hdr->n_long, n_short = h.hdr->n_short;
    const long long cap = (long long)h.n_plans * h.n_buckets;
    for (;;) {
        unsigned q = 0;
        if (lane == 0) q = atomicAdd(&h.hdr->queue, 1u);
        q = __shfl_sync(0xffffffffu, q, 0);
        if (q >= n_long + n_short) break;
        const int j = q < n_long ? h.list[q] : h.list[cap - 1 - (q - n_long)];
        const int cnt = h.ccnt[j];
        const float* v = h.sorted + h.coff[j];
        const int n_groups = (cnt + CHAIN_GROUP - 1) / CHAIN_GROUP;
        auto copy = [&](int gi) {
            float* dst = ring[warp][gi % CHAIN_RING];
#pragma unroll
            for (int l = 0; l < CHAIN_GROUP / 128; ++l) {
                const int at = CHAIN_GROUP * gi + 128 * l + 4 * lane;
                const int left = cnt - at;
                const int bytes = left >= 4 ? 16 : (left > 0 ? 4 * left : 0);
                hopper::cp_async16(
                    hopper::smem_addr(dst + 128 * l + 4 * lane),
                    bytes > 0 ? (const void*)(v + at) : (const void*)v,
                    bytes);
            }
        };
        for (int gi = 0; gi < CHAIN_RING - 1; ++gi) {
            if (gi < n_groups) copy(gi);
            hopper::cp_async_commit();
        }
        float acc = 0.f;
        for (int gi = 0; gi < n_groups; ++gi) {
            if (gi + CHAIN_RING - 1 < n_groups) copy(gi + CHAIN_RING - 1);
            hopper::cp_async_commit();
            hopper::cp_async_wait<CHAIN_RING - 1>();
            __syncwarp();
            const float* x = ring[warp][gi % CHAIN_RING];
            const int m = cnt - CHAIN_GROUP * gi;
            if (m >= CHAIN_GROUP) {
#pragma unroll
                for (int k = 0; k < CHAIN_GROUP; k += 4) {
                    const float4 y = *(const float4*)(x + k);
                    acc = __fadd_rn(acc, y.x);
                    acc = __fadd_rn(acc, y.y);
                    acc = __fadd_rn(acc, y.z);
                    acc = __fadd_rn(acc, y.w);
                }
            } else {
                for (int k = 0; k < m; ++k) acc = __fadd_rn(acc, x[k]);
            }
            __syncwarp();
        }
        hopper::cp_async_wait<0>();
        if (lane == 0) {
            const int p = j / h.n_buckets;
            h.sums[(long long)p * h.n_buckets + h.cbuck[j]] = acc;
        }
    }
}

static int n_sms() {
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (sms < 1) sms = 1;
    }
    return sms;
}

// hist_sort_kernel's dynamic shared memory.
inline size_t sort_smem(int n_buckets, int rows_per_chunk, bool smem_stats) {
    const int sw = n_buckets < HIST_SWEEP ? n_buckets : HIST_SWEEP;
    const size_t place =
        up16(4 * (size_t)HIST_WARPS * sw) + 8 * (size_t)sw +
        (rows_per_chunk <= KEY_CACHE_ROWS ? 2 * (size_t)rows_per_chunk : 0);
    const size_t count = smem_stats ? 20 * (size_t)n_buckets : 0;
    return place > count ? place : count;
}

// The cooperative sort launch: every CTA resident (static: this
// library's occupancy cache).
template <bool SMEM>
static int launch_sort(const Hist& h, cudaStream_t stream) {
    const size_t smem = sort_smem(h.n_buckets, h.rows_per_chunk, SMEM);
    static size_t last_smem = 0;
    static int per_sm = 0;
    const void* fn = (const void*)hist_sort_kernel<SMEM>;
    cudaError_t err;
    if (smem != last_smem) {
        err = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, fn, HIST_THREADS, smem);
        if (err != cudaSuccess) return (int)err;
        if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
        last_smem = smem;
    }
    const int ctas = per_sm * n_sms();
    void* args[] = {(void*)&h};
    return (int)cudaLaunchCooperativeKernel(fn, dim3(ctas),
                                            dim3(HIST_THREADS), args, smem,
                                            stream);
}

inline bool hist_valid(long long n, int n_plans, int n_buckets,
                       int rows_per_chunk) {
    return n >= 1 && n <= MAX_ROWS && n_plans >= 1 && n_plans <= 65535 &&
           n_buckets >= 1 && (long long)n_plans * n_buckets <= INT_MAX &&
           rows_per_chunk >= HIST_THREADS &&
           rows_per_chunk % HIST_THREADS == 0;
}

inline long long hist_chunks(long long n, int rows_per_chunk) {
    return (n + rows_per_chunk - 1) / rows_per_chunk;
}

// values: [n] int32; exists: [n] bool; masks: [P, n] bool; bases,
// intervals: [P] int32 (nullptr at P 1: base0 / interval0); ws: the
// scratch, layout(n, P, n_buckets, hist_chunks(n, rows_per_chunk)).total
// bytes (ops/aggs.py histogram_scratch_bytes). Out: counts
// [P, n_buckets] int32; sums, mins, maxs [P, n_buckets] f32. host, when
// set, receives {chain buckets, longest chain rows, long chains, and the
// sort launch's passes in ns: counting, offsets, sort}
// after waiting for the call; split_ms, when set, the three operations'
// event ms. Returns the first CUDA error, 0 on success.
static int histogram(const int* values, const uint8_t* exists,
                     const uint8_t* masks, const int* bases,
                     const int* intervals, int base0, int interval0,
                     long long n, int n_plans,
                     int n_buckets, int rows_per_chunk, void* ws,
                     int* counts, float* sums, float* mins, float* maxs,
                     long long* host, float* split_ms, cudaStream_t stream) {
    if (!hist_valid(n, n_plans, n_buckets, rows_per_chunk) ||
        (bases == nullptr && n_plans != 1))
        return (int)cudaErrorInvalidValue;
    Hist h;
    h.values = values;
    h.exists = exists;
    h.masks = masks;
    h.bases = bases;
    h.intervals = intervals;
    h.base0 = base0;
    h.interval0 = interval0;
    h.n = n;
    h.n_chunks = hist_chunks(n, rows_per_chunk);
    h.stride = plan_stride(n, n_buckets);
    h.n_plans = n_plans;
    h.n_buckets = n_buckets;
    h.rows_per_chunk = rows_per_chunk;
    const Layout L = layout(n, n_plans, n_buckets, h.n_chunks);
    char* w = (char*)ws;
    h.hdr = (Hdr*)w;
    h.tot = (int*)(w + L.tot);
    h.vmin = (unsigned*)(w + L.vmin);
    h.vmax = (unsigned*)(w + L.vmax);
    h.sabs = (unsigned long long*)(w + L.sabs);
    h.state = (unsigned*)(w + L.state);
    h.cid_of = (int*)(w + L.cid_of);
    h.coff = (long long*)(w + L.coff);
    h.ccnt = (int*)(w + L.ccnt);
    h.cbuck = (int*)(w + L.cbuck);
    h.nchain = (int*)(w + L.nchain);
    h.list = (int*)(w + L.list);
    h.sorted = (float*)(w + L.sorted);
    h.counts = counts;
    h.sums = sums;
    h.mins = mins;
    h.maxs = maxs;
    cudaEvent_t ev[4];
    if (split_ms != nullptr) {
        for (int i = 0; i < 4; ++i) cudaEventCreate(&ev[i]);
        cudaEventRecord(ev[0], stream);
    }
    cudaError_t err = cudaMemsetAsync(ws, 0, L.zero_end, stream);
    if (err != cudaSuccess) return (int)err;
    if (split_ms != nullptr) cudaEventRecord(ev[1], stream);
    int rc = n_buckets <= HIST_SMEM_BUCKETS ? launch_sort<true>(h, stream)
                                            : launch_sort<false>(h, stream);
    if (rc != 0) return rc;
    if (split_ms != nullptr) cudaEventRecord(ev[2], stream);
    hist_chain_kernel<<<CHAIN_CTAS_PER_SM * n_sms(), CHAIN_WARPS * 32, 0,
                        stream>>>(h);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (split_ms != nullptr) {
        cudaEventRecord(ev[3], stream);
        err = cudaEventSynchronize(ev[3]);
        for (int i = 0; i < 3 && err == cudaSuccess; ++i)
            err = cudaEventElapsedTime(&split_ms[i], ev[i], ev[i + 1]);
        for (int i = 0; i < 4; ++i) cudaEventDestroy(ev[i]);
        if (err != cudaSuccess) return (int)err;
    }
    if (host != nullptr) {
        Hdr got;
        err = cudaMemcpyAsync(&got, ws, sizeof(Hdr), cudaMemcpyDeviceToHost,
                              stream);
        if (err == cudaSuccess) err = cudaStreamSynchronize(stream);
        if (err != cudaSuccess) return (int)err;
        host[0] = (long long)got.n_long + got.n_short;
        host[1] = got.longest;
        host[2] = got.n_long;
        host[3] = (long long)(got.t_count - got.t_start);
        host[4] = (long long)(got.t_offsets - got.t_count);
        host[5] = (long long)(got.t_place - got.t_offsets);
    }
    return 0;
}

}  // namespace aggs
