// A row-batched radix select: the k best entries of each of many f32 rows
// in one cooperative launch, in lax.top_k's order (score descending, then
// index ascending, -inf slots included), for any 1 <= k <= the row's
// length. K10's selection (radix_select.cuh) carried over to rows.
//
// 1. Keys. As K10's: the high 32 bits are the score's bits mapped so that
//    unsigned order is lax.top_k's total order (-0.0 just below +0.0, every
//    NaN above +inf), the low 32 bits n - 1 - index, so every key is
//    distinct and the k best entries are the k largest keys. A row is read
//    either from a plane (its column is the index) or from a list of
//    (value, index) pairs (``Src``); the index is a doc id either way, and
//    a key gives its score back exactly (``key_score``).
// 2. Groups. About one CTA a SM, every CTA resident (the launch fails
//    rather than hangs when they cannot all be). The grid splits into
//    groups of g CTAs, g = CTAs / rows when rows are few (one row on the
//    whole card, 64 rows on two CTAs each), else 1 (rows dealt out over
//    the CTAs). A group takes its rows one after the other; its CTAs share
//    each row in contiguous slices and meet at a barrier of their own, so
//    no group waits for another.
// 3. Per row, K10's passes: the k-th largest key is found digit by digit
//    from the top (the score word in 11, 11 and 10 bits, then the bits of
//    the index word that n - 1 uses), each CTA histogramming the digit of
//    the keys still in the chosen prefix in shared memory and adding its
//    bins to the row's histogram in device memory; after the group's
//    barrier every CTA picks the same digit. The passes stop once the keys
//    at or above the prefix are at most ``scap`` (2,048 for k up to 2,048,
//    else 16,384 or k) or exactly k; a row of at most scap entries runs
//    none.
// 4. The survivors are compacted into the row's key buffer, and after the
//    group's barrier each CTA of the group stages them in shared memory and
//    ranks a share of them (a key's place is the number of larger keys);
//    the keys placed below k are written there. For k > 16,384 exactly k
//    keys survive and the launcher sorts them after the launch, row by
//    row, with K10's run sort and merges.
// The launcher allocates and clears nothing: the caller passes a state of
// ``state_bytes`` it has zeroed and a key buffer of ``keys_bytes``.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "radix_select.cuh"

namespace rows {

using rsel::BINS;
using rsel::Key;
using rsel::MAX_BITS;
using rsel::MAX_PASSES;
using rsel::NO_BIN;
using rsel::Pick;
using rsel::Plan;

constexpr int THREADS = 512;
constexpr int UNROLL = 4;
constexpr int CHUNK = 4 * THREADS * UNROLL;   // entries a CTA step
constexpr int CAP = rsel::CAP;   // 16,384 keys in shared memory
constexpr int SMALL = 2048;   // the survivors ranked for k <= SMALL
constexpr int MAX_CTAS = 1024;   // group barriers set aside

struct RowState {
    unsigned count;                  // the compaction's write cursor
    unsigned pad[31];
    unsigned hist[MAX_PASSES][BINS];
};

struct GroupBar {
    unsigned arrivals;
    unsigned pad[31];
};

// Where row r's entries are. With no lists (lv null), or where the row's
// threshold tau[r] (when given) is not above -inf, or its list overflowed
// (cnt[r] > lld, lists at a fixed stride), the row is plane row r: n
// entries at plane + r * ld, each indexed by its column. Otherwise it is
// list r: cnt[r] values at lv + r * lld, indexed by li + r * lld -- or,
// with ``off``, at lv + off[r] and li + off[r], at most lim[r] of them
// when ``lim`` is given (lists of varying size; never a plane row).
struct Src {
    const float* plane;
    long long ld;
    const float* lv;
    const int* li;
    long long lld;
    const int* cnt;
    const float* tau;
    const long long* off;
    const long long* lim;
};

__device__ __forceinline__ bool full_row(const Src& s, long long r) {
    return s.lv == nullptr ||
           (s.tau != nullptr && !(s.tau[r] > -INFINITY)) ||
           (s.off == nullptr && (long long)s.cnt[r] > s.lld);
}

// The first entry and the entry count of list row r (not a plane row).
__device__ __forceinline__ long long list_at(const Src& s, long long r) {
    return s.off != nullptr ? s.off[r] : r * s.lld;
}

__device__ __forceinline__ long long list_len(const Src& s, long long r) {
    long long m = s.cnt[r];
    if (s.lim != nullptr && m > s.lim[r]) m = s.lim[r];
    return m;
}

__device__ __forceinline__ Key make_key(float v, long long id, long long n) {
    return ((Key)rsel::score_bits(v) << 32) | (Key)(n - 1 - id);
}

// The score a key was made from (score_bits inverted; a NaN comes back as
// the one quiet NaN).
__device__ __forceinline__ float key_score(Key key) {
    const unsigned w = (unsigned)(key >> 32);
    return __uint_as_float((w & 0x80000000u) ? (w & 0x7fffffffu) : ~w);
}

// The g CTAs of a group wait here for each other; ``target`` counts the
// arrivals expected so far. A barrier that never opens traps.
__device__ __forceinline__ void group_sync(unsigned* bar, unsigned& target,
                                           int g) {
    __threadfence();
    __syncthreads();
    if (g == 1) return;
    target += g;
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

// Call f(value, index, valid) for every entry of [start, end) of a row
// (``ids`` null: the index is the position), every thread of the CTA
// taking part in each call, four consecutive entries a thread, read with
// 16-byte loads where ``vec``.
template <class F>
__device__ __forceinline__ void for_each(const float* __restrict__ v,
                                         const int* __restrict__ ids,
                                         long long start, long long end,
                                         bool vec, F f) {
    for (long long it = start; it < end; it += CHUNK) {
        float x[UNROLL][4];
        int id[UNROLL][4];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long j = it + 4LL * (u * THREADS + threadIdx.x);
            if (vec && j + 3 < end) {
                const float4 q = __ldcg((const float4*)(v + j));
                x[u][0] = q.x;
                x[u][1] = q.y;
                x[u][2] = q.z;
                x[u][3] = q.w;
                if (ids != nullptr) {
                    const int4 p = __ldcg((const int4*)(ids + j));
                    id[u][0] = p.x;
                    id[u][1] = p.y;
                    id[u][2] = p.z;
                    id[u][3] = p.w;
                }
            } else {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const bool ok = j + e < end;
                    x[u][e] = ok ? __ldcg(v + j + e) : 0.f;
                    if (ids != nullptr)
                        id[u][e] = ok ? __ldcg(ids + j + e) : 0;
                }
            }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long j = it + 4LL * (u * THREADS + threadIdx.x);
#pragma unroll
            for (int e = 0; e < 4; ++e)
                f(x[u][e], ids != nullptr ? (long long)id[u][e] : j + e,
                  j + e < end);
        }
    }
}

// grid (cooperative: groups x g CTAs), THREADS threads, sort_bytes of
// dynamic shared memory when sort_here. Row r's best k go to out_s /
// out_d[r * k, + k) -- or, with kth_only, only the k-th score, to
// out_s[r] (and its index to out_d[r] when out_d is given). ``full`` (may
// be null) counts the rows that a source with lists read from the plane.
__global__ void __launch_bounds__(THREADS) select_kernel(
    Src src, int n_rows, long long n, int k, int scap, Plan plan, int g,
    RowState* __restrict__ rs, GroupBar* __restrict__ gb,
    Key* __restrict__ keys, long long kc, int sort_here, int kth_only,
    float* __restrict__ out_s, int* __restrict__ out_d,
    unsigned* __restrict__ full) {
    __shared__ unsigned h[BINS];
    __shared__ unsigned ws[32];
    __shared__ Pick pick;
    extern __shared__ __align__(16) unsigned char sort_raw[];
    const int lane = threadIdx.x & 31;
    const int group = blockIdx.x / g, mem = blockIdx.x % g;
    const int n_groups = gridDim.x / g;
    unsigned target = 0;
    for (long long r = group; r < n_rows; r += n_groups) {
        const bool whole = full_row(src, r);
        const float* vals =
            whole ? src.plane + r * src.ld : src.lv + list_at(src, r);
        const int* ids = whole ? nullptr : src.li + list_at(src, r);
        const long long m = whole ? n : list_len(src, r);
        if (whole && src.lv != nullptr && full != nullptr && mem == 0 &&
            threadIdx.x == 0)
            atomicAdd(full, 1u);
        long long slice = ((m + g - 1) / g + 3) / 4 * 4;
        const long long start = (long long)mem * slice < m ? mem * slice : m;
        const long long end = start + slice < m ? start + slice : m;
        const bool vec = ((uintptr_t)vals & 15) == 0 &&
                         ((uintptr_t)ids & 15) == 0;
        RowState* st = rs + r;
        Key* rk = keys + r * kc;
        if (threadIdx.x == 0) {
            pick.prefix = 0ull;
            pick.shift = 64;
            pick.done = m <= scap;
            pick.rank = (unsigned)k;
            pick.above = 0u;
        }
        __syncthreads();
        for (int p = 0; p < plan.n_passes && !pick.done; ++p) {
            const int shift = plan.shift[p], bits = plan.bits[p];
            const unsigned mask = (1u << bits) - 1u;
            const int nb = 1 << bits;
            const Key prefix = pick.prefix;
            const int pshift = pick.shift;
            for (int b = threadIdx.x; b < nb; b += THREADS) h[b] = 0u;
            __syncthreads();
            for_each(vals, ids, start, end, vec,
                     [&](float s, long long j, bool ok) {
                         unsigned d = NO_BIN;
                         if (ok) {
                             const Key key = make_key(s, j, n);
                             if (rsel::in_prefix(key, prefix, pshift, true))
                                 d = (unsigned)(key >> shift) & mask;
                         }
                         const unsigned d0 = __shfl_sync(0xffffffffu, d, 0);
                         if (__all_sync(0xffffffffu, d == d0)) {
                             if (lane == 0 && d0 != NO_BIN)
                                 atomicAdd(&h[d0], 32u);
                         } else if (d != NO_BIN) {
                             atomicAdd(&h[d], 1u);
                         }
                     });
            __syncthreads();
            unsigned* gh = st->hist[p];
            for (int b = threadIdx.x; b < nb; b += THREADS)
                if (h[b]) atomicAdd(&gh[b], h[b]);
            group_sync(&gb[group].arrivals, target, g);
            // every CTA of the group picks the same digit from the row's
            // complete histogram: bins from the top, BINS / THREADS a thread
            constexpr int PER = BINS / THREADS;
            const volatile unsigned* vh = gh;
            unsigned c[PER];
            unsigned sum = 0u;
#pragma unroll
            for (int i = 0; i < PER; ++i) {
                const int t = threadIdx.x * PER + i;
                c[i] = t < nb ? vh[nb - 1 - t] : 0u;
                sum += c[i];
            }
            const unsigned rank = pick.rank, above = pick.above;
            unsigned acc = rsel::block_excl_scan(sum, ws);
#pragma unroll
            for (int i = 0; i < PER; ++i) {
                const int t = threadIdx.x * PER + i;
                if (t < nb && acc < rank && acc + c[i] >= rank) {
                    const unsigned left = rank - acc;
                    pick.prefix = prefix | ((Key)(nb - 1 - t) << shift);
                    pick.shift = shift;
                    pick.above = above + acc;
                    pick.rank = left;
                    pick.done = above + acc + c[i] <= (unsigned)scap ||
                                c[i] == left;
                }
                acc += c[i];
            }
            __syncthreads();
        }
        const Key prefix = pick.prefix;
        const int pshift = pick.shift;
        for_each(vals, ids, start, end, vec,
                 [&](float s, long long j, bool ok) {
                     Key key = 0ull;
                     bool take = false;
                     if (ok) {
                         key = make_key(s, j, n);
                         take = rsel::in_prefix(key, prefix, pshift, false);
                     }
                     const unsigned ballot = __ballot_sync(0xffffffffu, take);
                     if (ballot == 0u) return;
                     unsigned pos = 0u;
                     if (lane == 0)
                         pos = atomicAdd(&st->count,
                                         (unsigned)__popc(ballot));
                     pos = __shfl_sync(0xffffffffu, pos, 0);
                     if (take)
                         rk[pos + __popc(ballot & ((1u << lane) - 1u))] = key;
                 });
        group_sync(&gb[group].arrivals, target, g);   // every survivor written
        if (sort_here) {
            // every CTA of the group stages the m' survivors; the group's
            // warps rank RANKED of them at a time
            Key* a = (Key*)sort_raw;
            const int ms = (int)*(volatile unsigned*)&st->count;
            for (int i = threadIdx.x; i < ms; i += THREADS)
                a[i] = __ldcg(rk + i);
            __syncthreads();
            constexpr int RANKED = 4;
            const long long n_warps = (long long)g * (THREADS / 32);
            for (long long i0 = ((long long)mem * (THREADS / 32) +
                                 (threadIdx.x >> 5)) * RANKED;
                 i0 < ms; i0 += n_warps * RANKED) {
                Key mine[RANKED];
                unsigned larger[RANKED];
#pragma unroll
                for (int q = 0; q < RANKED; ++q) {
                    mine[q] = i0 + q < ms ? a[i0 + q] : ~0ull;
                    larger[q] = 0u;
                }
                for (int j = lane; j < ms; j += 32) {
                    const Key b = a[j];
#pragma unroll
                    for (int q = 0; q < RANKED; ++q) larger[q] += b > mine[q];
                }
                unsigned place = 0u;
#pragma unroll
                for (int q = 0; q < RANKED; ++q) {
#pragma unroll
                    for (int o = 16; o > 0; o >>= 1)
                        larger[q] +=
                            __shfl_xor_sync(0xffffffffu, larger[q], o);
                    if (lane == q) place = larger[q];
                }
                if (lane < RANKED && i0 + lane < ms && place < (unsigned)k) {
                    Key key = 0ull;
#pragma unroll
                    for (int q = 0; q < RANKED; ++q)
                        if (lane == q) key = mine[q];
                    if (kth_only) {
                        if (place == (unsigned)k - 1) {
                            out_s[r] = key_score(key);
                            if (out_d != nullptr)
                                out_d[r] = (int)(n - 1 - (long long)(
                                                     key & 0xffffffffull));
                        }
                    } else {
                        out_s[r * k + place] = key_score(key);
                        out_d[r * k + place] =
                            (int)(n - 1 - (long long)(key & 0xffffffffull));
                    }
                }
            }
        }
        __syncthreads();              // pick and the staged keys are reused
    }
}

// k > CAP: keys [k] sorted descending -> row r's outputs.
__global__ void write_keys_kernel(const Key* __restrict__ keys, long long n,
                                  int k, long long r, int kth_only,
                                  float* __restrict__ out_s,
                                  int* __restrict__ out_d) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= k) return;
    if (kth_only) {
        if (i == k - 1) {
            out_s[r] = key_score(keys[i]);
            if (out_d != nullptr)
                out_d[r] =
                    (int)(n - 1 - (long long)(keys[i] & 0xffffffffull));
        }
        return;
    }
    out_s[r * k + i] = key_score(keys[i]);
    out_d[r * k + i] = (int)(n - 1 - (long long)(keys[i] & 0xffffffffull));
}

// The survivors a row's key buffer holds.
inline int sort_cap(int k) {
    if (k <= SMALL) return SMALL;
    return k <= CAP ? CAP : k;
}

// Bytes of a launch's state (zeroed by the caller) for n_rows rows.
inline long long state_bytes(long long n_rows) {
    return n_rows * (long long)sizeof(RowState) +
           (long long)MAX_CTAS * sizeof(GroupBar);
}

// Bytes of a launch's key buffer for n_rows rows and a given k.
inline long long keys_bytes(long long n_rows, int k) {
    return n_rows * (long long)sort_cap(k) * 8 +
           (k > CAP ? (long long)k * 8 : 0);
}

inline int n_sms() { return rsel::n_sms(); }

// Select the best k of each of n_rows rows of ``src`` (keys over an index
// space of n: a plane row's length, or the doc ids' bound), 1 <= k <= every
// row's length. Returns the first CUDA error, 0 on success. Static, so that
// each library keeps its own caches: a library's kernel attributes are its
// own, while an inline function's static locals are one copy in the
// process however many libraries hold it.
static inline int select_rows(const Src& src, int n_rows, long long n, int k,
                              void* state, void* key_buf, int kth_only,
                              float* out_s, int* out_d, unsigned* full,
                              cudaStream_t stream) {
    if (n_rows < 1 || n < 1 || k < 1 || (long long)k > n ||
        n > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    const int scap = sort_cap(k);
    const int sort_here = k <= CAP;
    long long sort_keys = 2;
    while (sort_here && sort_keys < scap) sort_keys <<= 1;
    const size_t sort_bytes = sort_here ? (size_t)sort_keys * 8 : 0;
    static int occupancy[3] = {0, 0, 0};      // SMALL, CAP, none
    const int slot = !sort_here ? 2 : (scap == SMALL ? 0 : 1);
    cudaError_t err;
    if (occupancy[slot] == 0) {
        err = cudaFuncSetAttribute((const void*)select_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   CAP * 8);
        if (err != cudaSuccess) return (int)err;
        err = cudaFuncSetAttribute((const void*)rsel::sort_runs_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   CAP * 8);
        if (err != cudaSuccess) return (int)err;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &occupancy[slot], select_kernel, THREADS, sort_bytes);
        if (err != cudaSuccess) return (int)err;
    }
    const int per_sm = occupancy[slot];
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    int ctas = per_sm * n_sms();
    if (ctas > MAX_CTAS) ctas = MAX_CTAS;
    const int groups = n_rows < ctas ? n_rows : ctas;
    const int g = ctas / groups;
    Plan plan{};
    // the score word in 11, 11, 10 bits, then the bits of the index word
    // that n - 1 uses, at most 11 a pass
    const int hi[3][2] = {{53, 11}, {42, 11}, {32, 10}};
    for (int p = 0; p < 3; ++p) {
        plan.shift[plan.n_passes] = hi[p][0];
        plan.bits[plan.n_passes++] = hi[p][1];
    }
    int low = n > 1 ? 64 - __builtin_clzll((unsigned long long)(n - 1)) : 0;
    while (low > 0) {
        const int w = low < MAX_BITS ? low : MAX_BITS;
        low -= w;
        plan.shift[plan.n_passes] = low;
        plan.bits[plan.n_passes++] = w;
    }
    RowState* rs = (RowState*)state;
    GroupBar* gb = (GroupBar*)(rs + n_rows);
    Key* keys = (Key*)key_buf;
    const long long kc = scap;
    Key* keys2 = keys + (long long)n_rows * kc;
    void* args[] = {(void*)&src,      (void*)&n_rows, (void*)&n,
                    (void*)&k,        (void*)&scap,   (void*)&plan,
                    (void*)&g,        (void*)&rs,     (void*)&gb,
                    (void*)&keys,     (void*)&kc,     (void*)&sort_here,
                    (void*)&kth_only, (void*)&out_s,  (void*)&out_d,
                    (void*)&full};
    err = cudaLaunchCooperativeKernel((const void*)select_kernel,
                                      dim3((unsigned)(groups * g)),
                                      dim3(THREADS), args, sort_bytes,
                                      stream);
    if (err != cudaSuccess) return (int)err;
    if (sort_here) return 0;
    // exactly k keys survived in each row: sort them row by row
    for (long long r = 0; r < n_rows; ++r) {
        Key* src_k = keys + r * kc;
        const int runs = (k + CAP - 1) / CAP;
        rsel::sort_runs_kernel<<<runs, 1024, (size_t)CAP * 8, stream>>>(src_k,
                                                                       k);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        Key* a = src_k;
        Key* b = keys2;
        for (long long run = CAP; run < k; run *= 2) {
            rsel::merge_kernel<<<(k + 255) / 256, 256, 0, stream>>>(a, b, k,
                                                                    run);
            err = cudaGetLastError();
            if (err != cudaSuccess) return (int)err;
            Key* t = a;
            a = b;
            b = t;
        }
        write_keys_kernel<<<(k + 255) / 256, 256, 0, stream>>>(
            a, n, k, r, kth_only, out_s, out_d);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

}  // namespace rows
