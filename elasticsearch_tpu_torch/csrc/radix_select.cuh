// A card-wide radix select: the k best entries of one f32 row, in
// lax.top_k's order (score descending, then index ascending, -inf slots
// included), for any 1 <= k <= n.
//
// 1. One 64-bit key per entry. The high 32 bits are the score's bits
//    mapped so that unsigned order is lax.top_k's total order (-0.0 just
//    below +0.0; every NaN keyed as the one positive quiet NaN, above
//    +inf, where torch.sort puts NaN); the low 32 bits are n - 1 - index,
//    so a lower index is a larger key.
//    Every key is distinct, so ties vanish from the selection: the k best
//    entries are the k largest keys, and their order is key order.
// 2. One cooperative launch of about one CTA per SM (every CTA resident,
//    so a grid-wide barrier is safe; the launch fails rather than hangs
//    when they cannot all be). Each CTA owns a contiguous slice of the row
//    and reads it with 16-byte loads. The k-th largest key is found digit
//    by digit from the top: the score word in digits of 11, 11 and 10
//    bits, then the index word in digits of at most 11 bits over the bits
//    that n - 1 uses. In a pass every CTA histograms the digit of the keys
//    that still match the chosen prefix in shared memory (a warp whose
//    lanes all hold one digit adds once, so a row of equal scores costs no
//    serialised atomics) and adds its non-zero bins to the pass's global
//    histogram; after a grid barrier every CTA reads that histogram and
//    picks the same digit, where the count from the top reaches the rank
//    still sought. A row of at most 16.8 MB stays in the 50 MB L2 between
//    passes, so only the first pass costs device-memory bytes.
// 3. The selection stops as soon as the keys at or above the prefix are
//    few enough to sort in one CTA (at most CAP) or are exactly k: a row
//    of spread scores stops after one pass, a row of at most CAP entries
//    runs none.
// 4. Each CTA then compacts its keys at or above the prefix into scratch
//    (warp-aggregated atomics; their order there does not matter). After a
//    grid barrier every CTA stages those m <= CAP keys (16,384, 128 KB) in
//    shared memory and the grid ranks them: a key's place is the number of
//    larger keys, counted by one warp for four keys at a time, and the keys
//    placed below k are written there. One CTA's bitonic sort of 16,384
//    keys took about 0.19 ms on the H100; the m^2 comparisons spread over
//    the card take a fraction of that.
// 5. Only when k > CAP (then exactly k keys survive) does the sort leave
//    the launch: CTAs sort runs of CAP, and merge passes double the runs;
//    each key's place in the merged run is its place in its own run plus
//    the number of larger keys in the other run (a binary search; keys are
//    distinct, so places never collide).
// The output score is read back from the row at the selected index, so a
// -0.0 comes out as the row holds it.
//
// The launcher allocates nothing: the caller passes a State (zeroed here
// with one memset), one key buffer of keys_entries() and, for k > CAP, a
// second of k entries.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rsel {

constexpr int THREADS = 512;         // threads of a selecting CTA
constexpr int CAP = 16384;           // keys one CTA sorts in shared memory
constexpr int MAX_BITS = 11;         // widest digit
constexpr int BINS = 1 << MAX_BITS;
constexpr int MAX_PASSES = 6;        // 3 for the score word, <= 3 for the index
constexpr int UNROLL = 4;            // 16-byte loads in flight per thread
constexpr int CHUNK = 4 * THREADS * UNROLL;   // entries a CTA step
constexpr unsigned NO_BIN = 0xffffffffu;

typedef unsigned long long Key;

struct State {
    unsigned barrier;     // arrivals at the grid barrier
    unsigned count;       // the compaction's write cursor
    unsigned pad[2];
    unsigned hist[MAX_PASSES][BINS];
};

// The digits of the passes: (shift, bits) from the top.
struct Plan {
    int n_passes;
    int shift[MAX_PASSES];
    int bits[MAX_PASSES];
};

__device__ __forceinline__ unsigned score_bits(float s) {
    unsigned u = __float_as_uint(s);    // -0.0 keys just below +0.0
    if (s != s) u = 0x7fc00000u;        // every NaN above +inf
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ Key make_key(float s, long long j, long long n) {
    return ((Key)score_bits(s) << 32) | (Key)(n - 1 - j);
}

// True when ``key`` lies in the chosen prefix's bucket (``exact``) or at
// or above it.
__device__ __forceinline__ bool in_prefix(Key key, Key prefix, int shift,
                                          bool exact) {
    if (shift >= 64) return true;
    const Key a = key >> shift, b = prefix >> shift;
    return exact ? a == b : a >= b;
}

// Exclusive prefix sum of v over the CTA; ws: shared scratch of 32 words.
__device__ unsigned block_excl_scan(unsigned v, unsigned* ws) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n_warps = (blockDim.x + 31) >> 5;
    unsigned x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) ws[warp] = x;
    __syncthreads();
    if (warp == 0) {
        unsigned w = lane < n_warps ? ws[lane] : 0u;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const unsigned y = __shfl_up_sync(0xffffffffu, w, o);
            if (lane >= o) w += y;
        }
        ws[lane] = w;
    }
    __syncthreads();
    const unsigned base = warp ? ws[warp - 1] : 0u;
    __syncthreads();
    return base + x - v;
}

// Sort a[0, p) descending; p is a power of two.
__device__ void bitonic_desc(Key* a, int p) {
    for (int size = 2; size <= p; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            for (int t = threadIdx.x; t < (p >> 1); t += blockDim.x) {
                const int lo = 2 * t - (t & (stride - 1));
                const int hi = lo + stride;
                const bool desc = (lo & size) == 0;
                const Key x = a[lo], y = a[hi];
                if ((x < y) == desc) {
                    a[lo] = y;
                    a[hi] = x;
                }
            }
            __syncthreads();
        }
    }
}

// Every CTA of the (cooperative) grid waits here for all the others.
// ``target`` counts the arrivals expected so far. A barrier that never
// opens traps instead of hanging the card.
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& target) {
    target += gridDim.x;
    __threadfence();                 // every thread's writes before arriving
    __syncthreads();
    if (threadIdx.x == 0) {
        atomicAdd(bar, 1u);
        for (unsigned polls = 0;
             *(volatile unsigned*)bar < target; ++polls) {
            if (polls == (1u << 26)) __trap();
            __nanosleep(64);
        }
        __threadfence();
    }
    __syncthreads();
}

// Call f(value, index, valid) for every entry of [start, end) with every
// thread of the CTA taking part in each call (valid false past the end),
// four consecutive entries a thread, read with one 16-byte load where
// ``vec`` (the row is 16-byte aligned and start a multiple of 4).
template <class F>
__device__ __forceinline__ void for_each(const float* __restrict__ row,
                                         long long start, long long end,
                                         bool vec, F f) {
    for (long long it = start; it < end; it += CHUNK) {
        float v[UNROLL][4];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long j = it + 4LL * (u * THREADS + threadIdx.x);
            if (vec && j + 3 < end) {
                const float4 q = __ldg((const float4*)(row + j));
                v[u][0] = q.x;
                v[u][1] = q.y;
                v[u][2] = q.z;
                v[u][3] = q.w;
            } else {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    v[u][e] = j + e < end ? row[j + e] : 0.f;
            }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long j = it + 4LL * (u * THREADS + threadIdx.x);
#pragma unroll
            for (int e = 0; e < 4; ++e) f(v[u][e], j + e, j + e < end);
        }
    }
}

struct Pick {
    Key prefix;
    int shift;
    int done;
    unsigned rank;       // rank still sought inside the prefix bucket
    unsigned above;      // keys strictly above the prefix bucket
};

// grid (cooperative, G CTAs), THREADS threads, ``sort_bytes`` of dynamic
// shared memory when ``sort_here``. Selects, compacts the survivors to
// keys[0, count) and, when sort_here, ranks them and writes the best k to
// out_s/out_d.
__global__ void __launch_bounds__(THREADS) select_kernel(
    const float* __restrict__ row, long long n, int k, long long slice,
    int vec, Plan plan, State* st, Key* __restrict__ keys, int sort_here,
    float* __restrict__ out_s, int* __restrict__ out_d) {
    __shared__ unsigned h[BINS];
    __shared__ unsigned ws[32];
    __shared__ Pick pick;
    extern __shared__ __align__(16) unsigned char sort_raw[];
    const int lane = threadIdx.x & 31;
    const long long start = (long long)blockIdx.x * slice;
    const long long end = start + slice < n ? start + slice : n;
    if (threadIdx.x == 0) {
        pick.prefix = 0ull;
        pick.shift = 64;
        pick.done = n <= CAP;
        pick.rank = (unsigned)k;
        pick.above = 0u;
    }
    __syncthreads();
    unsigned target = 0;
    for (int p = 0; p < plan.n_passes && !pick.done; ++p) {
        const int shift = plan.shift[p], bits = plan.bits[p];
        const unsigned mask = (1u << bits) - 1u;
        const int nb = 1 << bits;
        const Key prefix = pick.prefix;
        const int pshift = pick.shift;
        for (int b = threadIdx.x; b < nb; b += THREADS) h[b] = 0u;
        __syncthreads();
        for_each(row, start, end, vec, [&](float s, long long j, bool ok) {
            unsigned d = NO_BIN;
            if (ok) {
                const Key key = make_key(s, j, n);
                if (in_prefix(key, prefix, pshift, true))
                    d = (unsigned)(key >> shift) & mask;
            }
            const unsigned d0 = __shfl_sync(0xffffffffu, d, 0);
            if (__all_sync(0xffffffffu, d == d0)) {
                if (lane == 0 && d0 != NO_BIN) atomicAdd(&h[d0], 32u);
            } else if (d != NO_BIN) {
                atomicAdd(&h[d], 1u);
            }
        });
        __syncthreads();
        unsigned* gh = st->hist[p];
        for (int b = threadIdx.x; b < nb; b += THREADS)
            if (h[b]) atomicAdd(&gh[b], h[b]);
        grid_sync(&st->barrier, target);
        // every CTA picks the same digit from the complete histogram:
        // bins from the top, BINS / THREADS consecutive a thread
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
        unsigned acc = block_excl_scan(sum, ws);
#pragma unroll
        for (int i = 0; i < PER; ++i) {
            const int t = threadIdx.x * PER + i;
            if (t < nb && acc < rank && acc + c[i] >= rank) {
                const unsigned left = rank - acc;
                pick.prefix = prefix | ((Key)(nb - 1 - t) << shift);
                pick.shift = shift;
                pick.above = above + acc;
                pick.rank = left;
                pick.done =
                    above + acc + c[i] <= (unsigned)CAP || c[i] == left;
            }
            acc += c[i];
        }
        __syncthreads();
    }
    const Key prefix = pick.prefix;
    const int pshift = pick.shift;
    for_each(row, start, end, vec, [&](float s, long long j, bool ok) {
        Key key = 0ull;
        bool take = false;
        if (ok) {
            key = make_key(s, j, n);
            take = in_prefix(key, prefix, pshift, false);
        }
        const unsigned ballot = __ballot_sync(0xffffffffu, take);
        if (ballot == 0u) return;
        unsigned pos = 0u;
        if (lane == 0) pos = atomicAdd(&st->count, (unsigned)__popc(ballot));
        pos = __shfl_sync(0xffffffffu, pos, 0);
        if (take) keys[pos + __popc(ballot & ((1u << lane) - 1u))] = key;
    });
    if (!sort_here) return;
    grid_sync(&st->barrier, target);          // every survivor written
    // rank sort over the whole grid: every CTA stages the m (<= CAP)
    // survivors in shared memory, and a warp ranks RANKED of them at a time
    // (a key's rank is the number of larger keys: they are distinct); the
    // keys ranked below k go straight to their output slots
    Key* a = (Key*)sort_raw;
    const int m = (int)*(volatile unsigned*)&st->count;
    for (int i = threadIdx.x; i < m; i += THREADS) a[i] = __ldcg(keys + i);
    __syncthreads();
    constexpr int RANKED = 4;
    const long long n_warps = (long long)gridDim.x * (THREADS / 32);
    for (long long i0 = ((long long)blockIdx.x * (THREADS / 32) +
                         (threadIdx.x >> 5)) * RANKED;
         i0 < m; i0 += n_warps * RANKED) {
        Key mine[RANKED];
        unsigned larger[RANKED];
#pragma unroll
        for (int r = 0; r < RANKED; ++r) {
            mine[r] = i0 + r < m ? a[i0 + r] : ~0ull;
            larger[r] = 0u;
        }
        for (int j = lane; j < m; j += 32) {
            const Key b = a[j];
#pragma unroll
            for (int r = 0; r < RANKED; ++r) larger[r] += b > mine[r];
        }
        unsigned rank = 0u;
#pragma unroll
        for (int r = 0; r < RANKED; ++r) {
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
                larger[r] += __shfl_xor_sync(0xffffffffu, larger[r], o);
            if (lane == r) rank = larger[r];
        }
        if (lane < RANKED && i0 + lane < m && rank < (unsigned)k) {
            Key key = 0ull;
#pragma unroll
            for (int r = 0; r < RANKED; ++r)
                if (lane == r) key = mine[r];
            const long long j = n - 1 - (long long)(key & 0xffffffffull);
            out_d[rank] = (int)j;
            out_s[rank] = row[j];
        }
    }
}

// k > CAP: sort keys[b * CAP, min((b + 1) * CAP, m)) in place, descending.
__global__ void __launch_bounds__(1024) sort_runs_kernel(
    Key* __restrict__ keys, long long m) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Key* a = (Key*)smem_raw;
    const long long base = (long long)blockIdx.x * CAP;
    const int len = (int)(m - base < CAP ? m - base : CAP);
    int p = 2;
    while (p < len) p <<= 1;
    for (int i = threadIdx.x; i < p; i += blockDim.x)
        a[i] = i < len ? keys[base + i] : 0ull;
    __syncthreads();
    bitonic_desc(a, p);
    for (int i = threadIdx.x; i < len; i += blockDim.x) keys[base + i] = a[i];
}

// Merge runs of ``run`` keys pairwise (runs 2q and 2q + 1), descending.
__global__ void merge_kernel(const Key* __restrict__ in, Key* __restrict__ out,
                             long long m, long long run) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m) return;
    const long long r = i / run;
    const long long own = r * run;
    const long long other = (r ^ 1) * run;
    const Key key = in[i];
    if (other >= m) {
        out[i] = key;
        return;
    }
    const long long end = other + run < m ? other + run : m;
    long long lo = other, hi = end;
    while (lo < hi) {                    // the first partner key <= key
        const long long mid = (lo + hi) >> 1;
        if (in[mid] > key) lo = mid + 1;
        else hi = mid;
    }
    const long long first = own < other ? own : other;
    out[first + (i - own) + (lo - other)] = key;
}

__global__ void write_kernel(const float* __restrict__ row, long long n,
                             int k, const Key* __restrict__ keys,
                             float* __restrict__ out_s,
                             int* __restrict__ out_d) {
    const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= k) return;
    const long long j = n - 1 - (long long)(keys[r] & 0xffffffffull);
    out_d[r] = (int)j;
    out_s[r] = row[j];
}

// Entries of the first key buffer: every compacted key (<= min(n, CAP)
// when k <= CAP, exactly k above).
inline long long keys_entries(long long n, int k) {
    if (k > CAP) return k;
    return n < CAP ? n : CAP;
}

inline int n_sms() {
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (sms < 1) sms = 1;
    }
    return sms;
}

// The top-k of row[0, n) into out_s/out_d[0, k). keys: keys_entries(n, k)
// entries; keys2: k entries when k > CAP (else unused). Returns the first
// CUDA error, 0 on success.
inline int select_topk(const float* row, long long n, int k, State* st,
                       Key* keys, Key* keys2, float* out_s, int* out_d,
                       cudaStream_t stream) {
    if (n < 1 || k < 1 || (long long)k > n || n > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    static bool smem_set = false;
    if (!smem_set) {
        cudaError_t e = cudaFuncSetAttribute(
            (const void*)select_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, CAP * 8);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(
                (const void*)sort_runs_kernel,
                cudaFuncAttributeMaxDynamicSharedMemorySize, CAP * 8);
        if (e != cudaSuccess) return (int)e;
        smem_set = true;
    }
    Plan plan{};
    if (n > CAP) {
        // the score word in 11, 11, 10 bits, then the bits of the index
        // word that n - 1 uses, at most 11 a pass
        const int hi[3][2] = {{53, 11}, {42, 11}, {32, 10}};
        for (int p = 0; p < 3; ++p) {
            plan.shift[plan.n_passes] = hi[p][0];
            plan.bits[plan.n_passes++] = hi[p][1];
        }
        int low = 64 - __builtin_clzll((unsigned long long)(n - 1));
        while (low > 0) {
            const int w = low < MAX_BITS ? low : MAX_BITS;
            low -= w;
            plan.shift[plan.n_passes] = low;
            plan.bits[plan.n_passes++] = w;
        }
    }
    const int sort_here = k <= CAP;
    long long sort_keys = 2;
    while (sort_here && sort_keys < n && sort_keys < CAP) sort_keys <<= 1;
    const size_t sort_bytes = sort_here ? (size_t)sort_keys * 8 : 0;
    static int occupancy[20] = {0};     // by log2 of the sort's keys
    int slot = 0;
    while (sort_here && (1ll << slot) < sort_keys) ++slot;
    cudaError_t err = cudaSuccess;
    if (occupancy[slot] == 0) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &occupancy[slot], select_kernel, THREADS, sort_bytes);
        if (err != cudaSuccess) return (int)err;
    }
    const int per_sm = occupancy[slot];
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    long long grid = (n + CHUNK - 1) / CHUNK;
    const long long most = (long long)per_sm * n_sms();
    if (grid > most) grid = most;
    long long slice = (n + grid - 1) / grid;
    slice = (slice + 3) / 4 * 4;
    int vec = ((uintptr_t)row & 15) == 0;
    err = cudaMemsetAsync(st, 0, sizeof(State), stream);
    if (err != cudaSuccess) return (int)err;
    void* args[] = {(void*)&row, (void*)&n,     (void*)&k,
                    (void*)&slice, (void*)&vec, (void*)&plan,
                    (void*)&st,  (void*)&keys,  (void*)&sort_here,
                    (void*)&out_s, (void*)&out_d};
    err = cudaLaunchCooperativeKernel((const void*)select_kernel,
                                      dim3((unsigned)grid), dim3(THREADS),
                                      args, sort_bytes, stream);
    if (err != cudaSuccess) return (int)err;
    if (sort_here) return 0;
    const int runs = (int)((k + CAP - 1) / CAP);
    sort_runs_kernel<<<runs, 1024, (size_t)CAP * 8, stream>>>(keys, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    Key* src = keys;
    Key* dst = keys2;
    for (long long run = CAP; run < k; run *= 2) {
        merge_kernel<<<(int)((k + 255) / 256), 256, 0, stream>>>(src, dst, k,
                                                                 run);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        Key* t = src;
        src = dst;
        dst = t;
    }
    write_kernel<<<(k + 255) / 256, 256, 0, stream>>>(row, n, k, src, out_s,
                                                      out_d);
    return (int)cudaGetLastError();
}

}  // namespace rsel
