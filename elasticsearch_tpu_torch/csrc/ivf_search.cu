// ivf_search: the IVF probe -- centroid scoring, top-nprobe, an exact scan
// of the probed lists, top-k.
//
// Replaces elasticsearch_tpu/ops/ivf.py:328 `_ivf_search`: for each query
// q [Q, D] f32, centroid scores dot(bf16 q, bf16 c) summed in f32 (for
// l2_norm 2 * s - c2, c2 summed over the f32 centroids); the top-nprobe
// lists under (score desc, index asc); every slot of those lists scored
// with knn_flat's arithmetic (bf16 operands, f32 sums in dim order, the
// similarity transform of knn_common.cuh with the list's doc norms and the
// query's qn / q2), -inf where the slot is padding; the top-k over the
// flattened [nprobe, L] candidate order (so equal scores resolve by probe
// rank, then list position -- not by doc id, as in the JAX program); and
// the slots mapped through ids, with -1 and 0.0 where the score is not
// finite. -> (scores [Q, k] f32, ids [Q, k] int32).
//
// What bounds it on the H100: memory. A batch must read the centroids
// once (15.7 MB at 4,096 x 960) and each list some query probes once
// (1.47 MB at L 384, D 960; only its valid slots' vectors are needed):
// 377 MB for a solo query at nprobe 256, 0.11 ms at 3.35 TB/s.
//
// Design. Every dot is summed on CUDA cores in dim order, one query-row
// pair a thread, so the kernel has the plain version's bits; the design
// is about reading each byte once a launch.
//   1. cent_kernel: a CTA takes 32 centroids and 32 queries (Q <= 32) or
//      64 and streams 32-dim chunks of both through a 4-stage cp.async
//      ring; a thread sums 2 centroids x 2 or 4 queries (the 64-query
//      tile took 0.082 against 0.045 ms at Q 32 on an H100 80GB HBM3 at
//      700 W, so small batches keep the 32). With Q <= 64 (every launch
//      of the GIST-shaped index at nprobe >= 8: IVFIndex._chunk_for) every
//      centroid is read once; beyond, once per 64 queries. It also writes
//      the bf16-rounded queries the scan reads. (Writes the small
//      [Q, nlist] score plane.)
//   2. probe_kernel: one CTA a query selects its top-nprobe of nlist by a
//      radix select over 64-bit keys (cta_top_keys below).
//   3. invert_kernel: one CTA turns the [Q, nprobe] probes into, for each
//      probed list, the (query, probe rank) pairs that probe it -- one
//      group a list, cut only past PCAP pairs (a query probes a list at
//      most once, so a launch of Q <= PCAP queries, as IVFIndex's query
//      chunk always is, has one group a list).
//   4. scan_kernel: one CTA a (group, 128-row block of the list), one
//      thread a row: the thread reads its row once, in 32-dim chunks of
//      float4 loads (the next chunk in flight while this one is summed;
//      padding slots are not read), and adds each chunk's dot with every
//      query of the group to that pair's sum in shared memory. So each
//      probed list is streamed from memory once a launch, whatever the
//      number of queries probing it. Each warp then sorts one pair's 128
//      keys at a time and writes its best min(k, 128) -- the partials are
//      the only per-slot output: no [Q, nprobe * L] plane. (A ring of
//      per-row cp.async.bulk copies completing on mbarriers was measured
//      against thread loads and lost: 0.3733 against 0.1343 ms for a solo
//      query at nprobe 256 on an H100 80GB HBM3 at 700 W.)
//   5. merge_kernel: one CTA a query selects the top-k of its partials
//      under (score desc, probe rank, list position) -- cta_top_keys
//      again -- and maps the slots to ids.
// k above KCAP takes the wide path: the old per-query score plane
// (ivf_scores_kernel), topk_common.cuh's plane_topk and map_kernel, after
// passes 1 and 2 (its launches carry "/wide" in their shape label).
// Keys: the high word is the score's bits in torch.sort's descending
// order (-0.0 as +0.0, every NaN as one NaN above +inf -- a similarity
// never returns -0.0, so a score decodes from its key bit for bit), the
// low word 2^32 - 1 - index, so a lower index is a larger key and no two
// keys are equal. The plain PyTorch version is
// elasticsearch_tpu_torch/ops/ivf.py `ivf_search_plain`; `ivf_search_
// grouped_plain` there mirrors the list-grouped order of passes 3-5.
#include "ivf_common.cuh"
#include "radix_select.cuh"

using namespace ivf;

namespace {

typedef unsigned long long Key;

constexpr int THREADS = 128;
constexpr int DT = 16;                   // dims staged per step (wide path)
constexpr int MAX_TILES_Y = 65535;

// pass 1
constexpr int C_THREADS = 256;
constexpr int CT = 32;                   // centroids a CTA
constexpr int QT = 64;                   // queries a CTA at most
constexpr int CDC = 32;                  // dims a chunk
constexpr int C_STAGES = 4;

// passes 2 and 5
constexpr int PICK_THREADS = 512;

// pass 4
constexpr int R = 128;                   // rows a block, one thread each
constexpr int PCAP = 256;                // (query, probe) pairs a group
constexpr int KCAP = 256;                // k of the fused path at most

// the score's ordered word: unsigned order is torch.sort's descending order
__device__ __forceinline__ unsigned score_word(float s) {
    unsigned u = __float_as_uint(s);
    if (s == 0.f) u = 0u;
    if (s != s) u = 0x7fc00000u;
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float word_score(unsigned w) {
    return __uint_as_float((w & 0x80000000u) ? (w & 0x7fffffffu) : ~w);
}

__device__ __forceinline__ Key make_key(float s, unsigned index) {
    return ((Key)score_word(s) << 32) | (Key)(0xffffffffu - index);
}

__device__ __forceinline__ unsigned key_index(Key k) {
    return 0xffffffffu - (unsigned)(k & 0xffffffffull);
}

// ---------------------------------------------------------------------------
// the CTA's top-k of n distinct keys
// ---------------------------------------------------------------------------

struct SelSmem {
    unsigned hist[256];
    unsigned ws[32];
    int digit;
    unsigned cum;
    unsigned cnt;
    unsigned taken;
};

// The k largest of the n keys load(j), j in [0, n), sorted descending
// into buf[0, k). The keys are distinct but for zeros (empty slots), of
// which there are at most n - k, so the k-th largest key is not one. buf
// holds ``cap`` keys (a power of two >= 2k). The k-th key is found digit
// by digit from the top (8 bits a pass, each pass a histogram of the keys
// still matching the chosen prefix) until the keys at or above the prefix
// fit buf; those are compacted and sorted.
template <class Load>
__device__ void cta_top_keys(Load load, int n, int k, Key* buf, int cap,
                             SelSmem* sm) {
    Key prefix = 0;
    int shift = 64;
    unsigned above = 0, bucket = (unsigned)n;
    const int lane = threadIdx.x & 31;
    while (shift > 0 && above + bucket > (unsigned)cap) {
        shift -= 8;
        for (int b = threadIdx.x; b < 256; b += blockDim.x) sm->hist[b] = 0;
        __syncthreads();
        for (int j = threadIdx.x; j < n; j += blockDim.x) {
            const Key key = load(j);
            if (shift + 8 >= 64 ||
                (key >> (shift + 8)) == (prefix >> (shift + 8)))
                atomicAdd(&sm->hist[(unsigned)(key >> shift) & 255u], 1u);
        }
        __syncthreads();
        if (threadIdx.x < 32) {
            // lane l holds bins 255 - 8l down to 248 - 8l
            unsigned loc[8], sum = 0;
#pragma unroll
            for (int u = 0; u < 8; ++u) {
                loc[u] = sm->hist[255 - 8 * lane - u];
                sum += loc[u];
            }
            unsigned inc = sum;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const unsigned y = __shfl_up_sync(0xffffffffu, inc, o);
                if (lane >= o) inc += y;
            }
            const unsigned excl = inc - sum;
            const unsigned need = (unsigned)k - above;
            const unsigned mine =
                __ballot_sync(0xffffffffu, excl < need && need <= inc);
            if (lane == __ffs(mine) - 1) {
                unsigned c = excl;
                int b = 255 - 8 * lane;
#pragma unroll
                for (int u = 0; u < 8; ++u) {
                    if (c + loc[u] >= need) {
                        b = 255 - 8 * lane - u;
                        break;
                    }
                    c += loc[u];
                }
                sm->digit = b;
                sm->cum = c;
                sm->cnt = sm->hist[b];
            }
        }
        __syncthreads();
        above += sm->cum;
        bucket = sm->cnt;
        prefix |= (Key)sm->digit << shift;
    }
    if (threadIdx.x == 0) sm->taken = 0;
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
        const Key key = load(j);
        if (key >= prefix) {
            const unsigned slot = atomicAdd(&sm->taken, 1u);
            if (slot < (unsigned)cap) buf[slot] = key;
        }
    }
    __syncthreads();
    const int m = sm->taken < (unsigned)cap ? (int)sm->taken : cap;
    int p2 = 1;
    while (p2 < m) p2 <<= 1;
    for (int j = m + threadIdx.x; j < p2; j += blockDim.x) buf[j] = 0ull;
    __syncthreads();
    rsel::bitonic_desc(buf, p2);
}

inline int sel_cap(int k) {
    int p = 1;
    while (p < k) p <<= 1;
    return 2 * p < 512 ? 512 : 2 * p;
}

// ---------------------------------------------------------------------------
// pass 1: centroid scores
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    const int bytes = pred ? 4 : 0;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int QN>
struct CentStage {
    float c[CDC][CT + 1];
    float q[CDC][QN + 1];
};

// grid (ceil(nlist / CT), ceil(n_q / (16 NB))): scores[q, c] =
//   sum_d bf16(queries[q, d]) * bf16(cents[c, d]), dim order
//   (l2: 2 * that - c2[c], c2 = sum_d cents[c, d]^2 in f32, dim order);
// qb = bf16(queries), the grid's threads striding over its entries.
template <int NB>
__global__ void __launch_bounds__(C_THREADS) cent_kernel(
    const float* __restrict__ cents, const float* __restrict__ queries,
    int nlist, int n_q, int dims, int sim, float* __restrict__ scores,
    float* __restrict__ qb) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    constexpr int QN = 16 * NB;
    typedef CentStage<QN> Stage;
    Stage* st = (Stage*)smem_raw;
    __shared__ float c2s[CT];
    const int t = threadIdx.x;
    const int c0 = blockIdx.x * CT, q0 = blockIdx.y * QN;
    const int n_chunks = (dims + CDC - 1) / CDC;
    // a thread's copies: element e = t + 256 u of a tile, row e / 32, dim
    // e % 32 (a warp copies one row's 128 bytes)
    auto issue = [&](int chunk) {
        Stage* s = st + chunk % C_STAGES;
        const int d0 = chunk * CDC;
#pragma unroll
        for (int u = 0; u < CT * CDC / C_THREADS; ++u) {
            const int e = t + C_THREADS * u;
            const int r = e / CDC, dd = e % CDC;
            const int d = d0 + dd, c = c0 + r;
            const bool ok = c < nlist && d < dims;
            cp_async4(&s->c[dd][r], cents + (ok ? (long long)c * dims + d : 0),
                      ok);
        }
#pragma unroll
        for (int u = 0; u < QN * CDC / C_THREADS; ++u) {
            const int e = t + C_THREADS * u;
            const int r = e / CDC, dd = e % CDC;
            const int d = d0 + dd, q = q0 + r;
            const bool ok = q < n_q && d < dims;
            cp_async4(&s->q[dd][r],
                      queries + (ok ? (long long)q * dims + d : 0), ok);
        }
    };
    for (int s = 0; s < C_STAGES - 1; ++s) {
        if (s < n_chunks) issue(s);
        cp_async_commit();
    }
    {
        const long long n = (long long)n_q * dims;
        const long long step = (long long)gridDim.x * gridDim.y * C_THREADS;
        for (long long e = ((long long)blockIdx.y * gridDim.x + blockIdx.x) *
                               C_THREADS + t;
             e < n; e += step)
            qb[e] = bfr(queries[e]);
    }
    // thread: centroids ci, ci + 16; queries qi + 16 b, b < NB (a thread
    // whose queries are all past n_q -- a small batch -- sums nothing;
    // the zero-filled queries past n_q add up to unwritten zeros)
    const int ci = t % 16, qi = t / 16;
    const bool active = q0 + qi < n_q;
    float acc[2][NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[0][b] = acc[1][b] = 0.f;
    float c2 = 0.f;
    for (int chunk = 0; chunk < n_chunks; ++chunk) {
        if (chunk + C_STAGES - 1 < n_chunks) issue(chunk + C_STAGES - 1);
        cp_async_commit();
        cp_async_wait<C_STAGES - 1>();
        __syncthreads();
        const Stage* s = st + chunk % C_STAGES;
        // the chunk's zero-filled dims past D add exact zeros
#pragma unroll 8
        for (int dd = 0; active && dd < CDC; ++dd) {
            const float cv0 = bfr(s->c[dd][ci]), cv1 = bfr(s->c[dd][ci + 16]);
#pragma unroll
            for (int b = 0; b < NB; ++b) {
                const float qv = bfr(s->q[dd][qi + 16 * b]);
                acc[0][b] = __fmaf_rn(qv, cv0, acc[0][b]);
                acc[1][b] = __fmaf_rn(qv, cv1, acc[1][b]);
            }
        }
        if (sim == SIM_L2 && t < CT) {
            const int dn = dims - chunk * CDC < CDC ? dims - chunk * CDC : CDC;
            for (int dd = 0; dd < dn; ++dd) {
                const float v = s->c[dd][t];
                c2 = __fadd_rn(c2, __fmul_rn(v, v));
            }
        }
        __syncthreads();
    }
    if (t < CT) c2s[t] = c2;
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < NB; ++b) {
            const int c = c0 + ci + 16 * a, q = q0 + qi + 16 * b;
            if (c >= nlist || q >= n_q) continue;
            float v = acc[a][b];
            if (sim == SIM_L2)
                v = __fsub_rn(__fmul_rn(2.f, v), c2s[ci + 16 * a]);
            scores[(long long)q * nlist + c] = v;
        }
}

// ---------------------------------------------------------------------------
// pass 2: each query's top-nprobe lists
// ---------------------------------------------------------------------------

// grid (n_q): probes[q, r] = the r-th best list of scores[q, :].
__global__ void __launch_bounds__(PICK_THREADS) probe_kernel(
    const float* __restrict__ scores, int nlist, int nprobe, int cap,
    int* __restrict__ probes) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Key* buf = (Key*)smem_raw;
    __shared__ SelSmem sm;
    const float* row = scores + (long long)blockIdx.x * nlist;
    auto load = [&](int j) { return make_key(row[j], (unsigned)j); };
    cta_top_keys(load, nlist, nprobe, buf, cap, &sm);
    for (int r = threadIdx.x; r < nprobe; r += blockDim.x)
        probes[(long long)blockIdx.x * nprobe + r] = (int)key_index(buf[r]);
}

// ---------------------------------------------------------------------------
// pass 3: the probes inverted into work items
// ---------------------------------------------------------------------------

constexpr int INV_THREADS = 1024;

// One CTA. pairs p = q * nprobe + r; for each list, its pairs (in any
// order: each pair's partial has its own slot) from offs[list]; items[g]
// = (list, first pair's place in ``sorted``, pairs) for groups of <= pcap.
__global__ void __launch_bounds__(INV_THREADS) invert_kernel(
    const int* __restrict__ probes, int n_pairs, int nlist, int pcap,
    int* __restrict__ counts, int* __restrict__ offs, int* __restrict__ goffs,
    int* __restrict__ sorted, int* __restrict__ items,
    int* __restrict__ n_groups) {
    __shared__ unsigned ws[32];
    __shared__ unsigned carry[2];
    for (int c = threadIdx.x; c < nlist; c += INV_THREADS) counts[c] = 0;
    if (threadIdx.x == 0) carry[0] = carry[1] = 0;
    __syncthreads();
    for (int p = threadIdx.x; p < n_pairs; p += INV_THREADS)
        atomicAdd(&counts[probes[p]], 1);
    __syncthreads();
    for (int base = 0; base < nlist; base += INV_THREADS) {
        const int c = base + threadIdx.x;
        const unsigned v = c < nlist ? (unsigned)counts[c] : 0u;
        const unsigned g = (v + pcap - 1) / pcap;
        const unsigned ev = rsel::block_excl_scan(v, ws);
        const unsigned eg = rsel::block_excl_scan(g, ws);
        if (c < nlist) {
            offs[c] = (int)(carry[0] + ev);
            goffs[c] = (int)(carry[1] + eg);
        }
        __syncthreads();
        if (threadIdx.x == INV_THREADS - 1) {
            carry[0] += ev + v;
            carry[1] += eg + g;
        }
        __syncthreads();
    }
    for (int c = threadIdx.x; c < nlist; c += INV_THREADS) {
        const int v = counts[c];
        for (int g = 0; g * pcap < v; ++g) {
            int* it = items + 3 * (long long)(goffs[c] + g);
            it[0] = c;
            it[1] = offs[c] + g * pcap;
            it[2] = v - g * pcap < pcap ? v - g * pcap : pcap;
        }
    }
    __syncthreads();
    for (int p = threadIdx.x; p < n_pairs; p += INV_THREADS) {
        const int c = probes[p];
        sorted[offs[c] + atomicSub(&counts[c], 1) - 1] = p;
    }
    if (threadIdx.x == 0) *n_groups = (int)carry[1];
}

// ---------------------------------------------------------------------------
// pass 4: the list scan
// ---------------------------------------------------------------------------

struct ScanArgs {
    const float* lists;
    const uint8_t* valid;
    const float* norms;
    const float* qb;
    const float* qn;
    const float* q2;
    const int* sorted;
    const int* items;
    const int* n_groups;
    Key* part;
    int dims, list_len, nprobe, sim, n_rb, kk;
};

// Sort a[0, p) descending within one warp; p a power of two.
__device__ void warp_bitonic_desc(Key* a, int p) {
    const int lane = threadIdx.x & 31;
    for (int size = 2; size <= p; size <<= 1)
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            for (int t = lane; t < (p >> 1); t += 32) {
                const int lo = 2 * t - (t & (stride - 1));
                const int hi = lo + stride;
                const bool desc = (lo & size) == 0;
                const Key x = a[lo], y = a[hi];
                if ((x < y) == desc) {
                    a[lo] = y;
                    a[hi] = x;
                }
            }
            __syncwarp();
        }
}

// Row ``row``'s dots with the np queries qb[pq[j]] (bf16-rounded), added
// to acc[j * R] in dim order. The row is read once, 32 dims at a time
// (VEC: D % 4 == 0 and 16-byte aligned rows, in float4s with the next
// chunk in flight; else one float at a time), and each chunk is summed
// into every pair before the next.
template <bool VEC>
__device__ __forceinline__ void row_dots(const float* __restrict__ row,
                                         const float* __restrict__ qb,
                                         int D, int np, const int* pq,
                                         float* acc) {
    if (VEC) {
        const float4* p = (const float4*)row;
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        const int n4 = D / 4;
        float4 cur[8], nxt[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) cur[u] = u < n4 ? __ldg(p + u) : zero;
        for (int c = 0; c < n4; c += 8) {
#pragma unroll
            for (int u = 0; u < 8; ++u)
                nxt[u] = c + 8 + u < n4 ? __ldg(p + c + 8 + u) : zero;
#pragma unroll
            for (int u = 0; u < 8; ++u) {
                cur[u].x = bfr(cur[u].x);
                cur[u].y = bfr(cur[u].y);
                cur[u].z = bfr(cur[u].z);
                cur[u].w = bfr(cur[u].w);
            }
            const int nu = n4 - c < 8 ? n4 - c : 8;
            for (int j = 0; j < np; ++j) {
                const float4* q =
                    (const float4*)(qb + (long long)pq[j] * D) + c;
                float s = acc[j * R];
#pragma unroll
                for (int u = 0; u < 8; ++u) {
                    if (u >= nu) break;
                    const float4 q4 = __ldg(q + u);
                    s = __fmaf_rn(q4.x, cur[u].x, s);
                    s = __fmaf_rn(q4.y, cur[u].y, s);
                    s = __fmaf_rn(q4.z, cur[u].z, s);
                    s = __fmaf_rn(q4.w, cur[u].w, s);
                }
                acc[j * R] = s;
            }
#pragma unroll
            for (int u = 0; u < 8; ++u) cur[u] = nxt[u];
        }
    } else {
        for (int d0 = 0; d0 < D; d0 += 32) {
            const int nd = D - d0 < 32 ? D - d0 : 32;
            float xs[32];
#pragma unroll
            for (int u = 0; u < 32; ++u)
                xs[u] = u < nd ? bfr(__ldg(row + d0 + u)) : 0.f;
            for (int j = 0; j < np; ++j) {
                const float* q = qb + (long long)pq[j] * D + d0;
                float s = acc[j * R];
#pragma unroll
                for (int u = 0; u < 32; ++u) {
                    if (u >= nd) break;
                    s = __fmaf_rn(__ldg(q + u), xs[u], s);
                }
                acc[j * R] = s;
            }
        }
    }
}

// grid (groups x row blocks), R threads, one a row of the block. The
// group's pairs' sums are summed in shared memory (acc [pcap][R]), then
// each warp keys, sorts and writes one pair's partial at a time:
// part[(pair, block)] = its best kk of the block's rows, descending
// (zeros past the list's end).
template <bool VEC>
__global__ void __launch_bounds__(R) scan_kernel(ScanArgs a) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Key* keys = (Key*)smem_raw;                      // [R / 32][R]
    float* acc = (float*)(keys + R / 32 * R);        // [np][R]
    __shared__ int pq[PCAP], pp[PCAP];
    __shared__ float nrm[R];
    __shared__ unsigned char vl[R];
    const int g = blockIdx.x / a.n_rb, rb = blockIdx.x % a.n_rb;
    if (g >= *a.n_groups) return;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int list = a.items[3 * g], pair0 = a.items[3 * g + 1];
    const int np = a.items[3 * g + 2];
    const int L = a.list_len, D = a.dims;
    for (int j = t; j < np; j += R) {
        const int pid = a.sorted[pair0 + j];
        pq[j] = pid / a.nprobe;
        pp[j] = pid % a.nprobe;
    }
    const long long lbase = (long long)list * L;
    const int r = rb * R + t;
    const bool vld = r < L && a.valid[lbase + r];
    nrm[t] = vld ? a.norms[lbase + r] : 0.f;
    vl[t] = vld;
    for (int j = 0; j < np; ++j) acc[j * R + t] = 0.f;
    __syncthreads();
    if (vld)
        row_dots<VEC>(a.lists + (lbase + r) * D, a.qb, D, np, pq, acc + t);
    __syncthreads();
    Key* kb = keys + warp * R;
    for (int j = warp; j < np; j += R / 32) {
        const int q = pq[j];
        for (int i = lane; i < R; i += 32) {
            const int ri = rb * R + i;
            Key key = 0ull;
            if (ri < L)
                key = make_key(vl[i] ? similarity(acc[j * R + i], nrm[i],
                                                  a.qn[q], a.q2[q], a.sim)
                                     : -INFINITY,
                               (unsigned)ri);
            kb[i] = key;
        }
        __syncwarp();
        warp_bitonic_desc(kb, R);
        Key* out = a.part + ((long long)(q * a.nprobe + pp[j]) * a.n_rb + rb) *
                                a.kk;
        for (int e = lane; e < a.kk; e += 32) out[e] = kb[e];
        __syncwarp();
    }
}

// ---------------------------------------------------------------------------
// pass 5: each query's merge
// ---------------------------------------------------------------------------

// grid (n_q): the top-k of query q's nprobe * n_rb partials (kk keys
// each, list positions) under (score desc, flattened position asc), ids
// and scores out.
__global__ void __launch_bounds__(PICK_THREADS) merge_kernel(
    const Key* __restrict__ part, const int* __restrict__ probes,
    const int* __restrict__ ids, int nprobe, int n_rb, int kk,
    int list_len, int k, int cap, float* __restrict__ out_s,
    int* __restrict__ out_i) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Key* buf = (Key*)smem_raw;
    __shared__ SelSmem sm;
    const int q = blockIdx.x;
    const Key* mine = part + (long long)q * nprobe * n_rb * kk;
    const int per_probe = n_rb * kk;
    auto load = [&](int j) -> Key {
        const Key e = mine[j];
        if (e == 0ull) return 0ull;
        const unsigned flat =
            (unsigned)(j / per_probe) * (unsigned)list_len + key_index(e);
        return (e & 0xffffffff00000000ull) | (Key)(0xffffffffu - flat);
    };
    cta_top_keys(load, nprobe * per_probe, k, buf, cap, &sm);
    for (int r = threadIdx.x; r < k; r += blockDim.x) {
        const Key key = buf[r];
        const float s = word_score((unsigned)(key >> 32));
        const long long c = (long long)q * k + r;
        if (isfinite(s)) {
            const unsigned flat = key_index(key);
            const long long probe =
                probes[(long long)q * nprobe + flat / list_len];
            out_i[c] = ids[probe * list_len + flat % list_len];
            out_s[c] = s;
        } else {
            out_i[c] = -1;
            out_s[c] = 0.f;
        }
    }
}

// ---------------------------------------------------------------------------
// the wide path (k > KCAP): a per-query plane of the probed slots
// ---------------------------------------------------------------------------

// grid (n_q, candidate tiles): cell [q, j], j in [0, n_cand), row(j) =
// probes[q, j / L] * L + j % L: valid[row] ? similarity(dot, norms[row],
// qn[q], q2[q]) : -inf, the dot summed in dim order.
template <int RD>
__global__ void __launch_bounds__(THREADS) ivf_scores_kernel(
    const float* __restrict__ rows, const float* __restrict__ aux,
    const uint8_t* __restrict__ valid, const int* __restrict__ probes,
    int nprobe, int list_len, const float* __restrict__ queries,
    const float* __restrict__ qn, const float* __restrict__ q2, int dims,
    long long n_cand, long long tile0, int sim, float* __restrict__ plane) {
    constexpr int TILE = THREADS * RD;
    __shared__ float ms[DT][TILE + 1];
    __shared__ float qs[DT];
    __shared__ long long rid[TILE];
    const int t = threadIdx.x;
    const int q = blockIdx.x;
    const long long j0 = (tile0 + blockIdx.y) * (long long)TILE;
    for (int e = t; e < TILE; e += THREADS) {
        const long long j = j0 + e;
        long long r = -1;
        if (j < n_cand)
            r = (long long)probes[(long long)q * nprobe + j / list_len] *
                    list_len +
                j % list_len;
        rid[e] = r;
    }
    float acc[RD];
#pragma unroll
    for (int i = 0; i < RD; ++i) acc[i] = 0.f;
    __syncthreads();
    for (int d0 = 0; d0 < dims; d0 += DT) {
        const int dn = dims - d0 < DT ? dims - d0 : DT;
        for (int e = t; e < TILE * DT; e += THREADS) {
            const int cand = e / DT, dd = e % DT;
            const long long r = rid[cand];
            ms[dd][cand] = (dd < dn && r >= 0) ? bfr(rows[r * dims + d0 + dd])
                                               : 0.f;
        }
        if (t < DT)
            qs[t] = t < dn ? bfr(queries[(long long)q * dims + d0 + t]) : 0.f;
        __syncthreads();
        for (int dd = 0; dd < dn; ++dd) {
            const float qv = qs[dd];
#pragma unroll
            for (int i = 0; i < RD; ++i)
                acc[i] = __fmaf_rn(qv, ms[dd][t + i * THREADS], acc[i]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < RD; ++i) {
        const int e = t + i * THREADS;
        const long long j = j0 + e;
        if (j >= n_cand) continue;
        const long long r = rid[e];
        plane[(long long)q * n_cand + j] =
            valid[r] ? similarity(acc[i], aux[r], qn[q], q2[q], sim)
                     : -INFINITY;
    }
}

int launch_plane(const float* rows, const float* aux, const uint8_t* valid,
                 const int* probes, int nprobe, int list_len,
                 const float* queries, const float* qn, const float* q2,
                 int n_q, int dims, long long n_cand, int sim, float* plane,
                 cudaStream_t stream) {
    // small launches (a solo query) take 128-candidate tiles to spread
    // over more SMs; large ones 512
    const bool wide = (long long)n_q * ((n_cand + 511) / 512) >= 264;
    const int tile = wide ? THREADS * 4 : THREADS;
    const long long tiles = (n_cand + tile - 1) / tile;
    for (long long tile0 = 0; tile0 < tiles; tile0 += MAX_TILES_Y) {
        const long long nt =
            tiles - tile0 < MAX_TILES_Y ? tiles - tile0 : MAX_TILES_Y;
        const dim3 grid(n_q, (unsigned)nt);
        if (wide)
            ivf_scores_kernel<4><<<grid, THREADS, 0, stream>>>(
                rows, aux, valid, probes, nprobe, list_len, queries, qn, q2,
                dims, n_cand, tile0, sim, plane);
        else
            ivf_scores_kernel<1><<<grid, THREADS, 0, stream>>>(
                rows, aux, valid, probes, nprobe, list_len, queries, qn, q2,
                dims, n_cand, tile0, sim, plane);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

// one thread per (query, rank): the winner's slot -> its id.
__global__ void map_kernel(const float* __restrict__ top_s,
                           const int* __restrict__ top_pos,
                           const int* __restrict__ probes,
                           const int* __restrict__ ids, int n_q, int k,
                           int nprobe, int list_len, float* __restrict__ out_s,
                           int* __restrict__ out_i) {
    const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= (long long)n_q * k) return;
    const long long q = c / k;
    const float s = top_s[c];
    if (isfinite(s)) {
        const int pos = top_pos[c];
        const long long probe = probes[q * nprobe + pos / list_len];
        out_i[c] = ids[probe * list_len + pos % list_len];
        out_s[c] = s;
    } else {
        out_i[c] = -1;
        out_s[c] = 0.f;
    }
}

// ---------------------------------------------------------------------------
// the launch plan and its workspace
// ---------------------------------------------------------------------------

struct Plan {
    bool wide;
    int n_rb, kk, pcap, sel_cap_probe, sel_cap_merge;
    long long n_pairs, groups;
    // byte offsets into the workspace
    long long o_scores, o_qb, o_probes, o_counts, o_offs, o_goffs, o_sorted,
        o_items, o_ngroups, o_part, o_lplane, o_lchunk_s, o_lchunk_i,
        o_top_s, o_top_pos, bytes;
};

long long align256(long long b) { return (b + 255) / 256 * 256; }

Plan make_plan(int n_q, int dims, int nlist, int list_len, int nprobe,
               int k) {
    Plan p{};
    p.n_pairs = (long long)n_q * nprobe;
    p.wide = k > KCAP;
    p.n_rb = (list_len + R - 1) / R;
    const int rows = list_len < R ? list_len : R;
    p.kk = k < rows ? k : rows;
    // a list's pairs are at most n_q (a query probes it once)
    p.pcap = n_q < PCAP ? n_q : PCAP;
    const long long per_list = (n_q + p.pcap - 1) / p.pcap;
    p.groups = (long long)nlist * per_list < p.n_pairs
                   ? (long long)nlist * per_list
                   : p.n_pairs;
    p.sel_cap_probe = sel_cap(nprobe);
    p.sel_cap_merge = sel_cap(k);
    long long o = 0;
    auto take = [&](long long bytes) {
        const long long at = o;
        o += align256(bytes > 0 ? bytes : 1);
        return at;
    };
    const long long n_cand = (long long)nprobe * list_len;
    p.o_scores = take(4LL * n_q * nlist);
    p.o_qb = take(4LL * n_q * dims);
    p.o_probes = take(4LL * n_q * nprobe);
    if (!p.wide) {
        p.o_counts = take(4LL * nlist);
        p.o_offs = take(4LL * nlist);
        p.o_goffs = take(4LL * nlist);
        p.o_sorted = take(4LL * p.n_pairs);
        p.o_items = take(12LL * p.n_pairs);
        p.o_ngroups = take(4);
        p.o_part = take(8LL * p.n_pairs * p.n_rb * p.kk);
    } else {
        const long long nc = (n_cand + topk::CHUNK - 1) / topk::CHUNK;
        const long long ck =
            nc > 1 ? (long long)n_q * nc * (k < topk::KMAX ? k : topk::KMAX)
                   : 1;
        p.o_lplane = take(4LL * n_q * n_cand);
        p.o_lchunk_s = take(4LL * ck);
        p.o_lchunk_i = take(4LL * ck);
        p.o_top_s = take(4LL * n_q * k);
        p.o_top_pos = take(4LL * n_q * k);
    }
    p.bytes = o;
    return p;
}

size_t scan_smem(int pcap) {
    return sizeof(Key) * (R / 32) * R + sizeof(float) * pcap * R;
}

}  // namespace

// *bytes: the workspace a launch of this shape needs.
extern "C" int ivf_search_workspace(int n_q, int dims, int nlist,
                                    int list_len, int nprobe, int k,
                                    long long* bytes) {
    *bytes = make_plan(n_q, dims, nlist, list_len, nprobe, k).bytes;
    return 0;
}

// queries: [n_q, dims] f32 with qn/q2 [n_q]; cents: [nlist, dims] f32;
// lists: [nlist, list_len, dims] f32; valid: [nlist, list_len] bool; ids:
// [nlist, list_len] int32; norms: [nlist, list_len] f32; work: the
// workspace (ivf_search_workspace's bytes, 256-byte aligned); out_s /
// out_i: [n_q, k].
extern "C" int ivf_search_launch(
    const float* queries, const float* qn, const float* q2,
    const float* cents, const float* lists, const uint8_t* valid,
    const int* ids, const float* norms, int n_q, int dims, int nlist,
    int list_len, int nprobe, int k, int sim, void* work, float* out_s,
    int* out_i, void* stream_ptr) {
    const long long n_cand = (long long)nprobe * list_len;
    if (n_q < 1 || dims < 1 || dims > MAX_DIMS || nlist < 1 ||
        list_len < 1 || nprobe < 1 || nprobe > nlist || nprobe > KMAX ||
        k < 1 || k > n_cand || n_cand > 0x7fffffffLL || !valid_sim(sim) ||
        ((uintptr_t)work & 255) != 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    const Plan p = make_plan(n_q, dims, nlist, list_len, nprobe, k);
    char* w = (char*)work;
    float* scores = (float*)(w + p.o_scores);
    int* probes = (int*)(w + p.o_probes);
    cudaError_t err = cudaSuccess;
    static bool attrs = false;
    if (!attrs) {
        err = cudaFuncSetAttribute((const void*)cent_kernel<2>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)(sizeof(CentStage<32>) * C_STAGES));
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(
                (const void*)cent_kernel<4>,
                cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)(sizeof(CentStage<64>) * C_STAGES));
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(
                (const void*)probe_kernel,
                cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)(sizeof(Key) * 2 * KMAX));
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(
                (const void*)scan_kernel<true>,
                cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)scan_smem(PCAP));
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(
                (const void*)scan_kernel<false>,
                cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)scan_smem(PCAP));
        if (err != cudaSuccess) return (int)err;
        attrs = true;
    }
    // 1. centroid scores
    float* qb = (float*)(w + p.o_qb);
    if (n_q <= 32)
        cent_kernel<2><<<dim3((nlist + CT - 1) / CT, 1), C_THREADS,
                         sizeof(CentStage<32>) * C_STAGES, stream>>>(
            cents, queries, nlist, n_q, dims, sim, scores, qb);
    else
        cent_kernel<4><<<dim3((nlist + CT - 1) / CT, (n_q + QT - 1) / QT),
                         C_THREADS, sizeof(CentStage<64>) * C_STAGES,
                         stream>>>(cents, queries, nlist, n_q, dims, sim,
                                   scores, qb);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    // 2. the probes
    probe_kernel<<<n_q, PICK_THREADS, sizeof(Key) * p.sel_cap_probe,
                   stream>>>(scores, nlist, nprobe, p.sel_cap_probe, probes);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (p.wide) {
        float* lplane = (float*)(w + p.o_lplane);
        float* top_s = (float*)(w + p.o_top_s);
        int* top_pos = (int*)(w + p.o_top_pos);
        int rc = launch_plane(lists, norms, valid, probes, nprobe, list_len,
                              queries, qn, q2, n_q, dims, n_cand, sim,
                              lplane, stream);
        if (rc != 0) return rc;
        rc = plane_topk(lplane, n_q, n_cand, k, (float*)(w + p.o_lchunk_s),
                        (int*)(w + p.o_lchunk_i), top_s, top_pos, stream);
        if (rc != 0) return rc;
        const long long cells = (long long)n_q * k;
        map_kernel<<<(unsigned)((cells + 255) / 256), 256, 0, stream>>>(
            top_s, top_pos, probes, ids, n_q, k, nprobe, list_len, out_s,
            out_i);
        return (int)cudaGetLastError();
    }
    // 3. the probes inverted
    int* n_groups = (int*)(w + p.o_ngroups);
    invert_kernel<<<1, INV_THREADS, 0, stream>>>(
        probes, (int)p.n_pairs, nlist, p.pcap, (int*)(w + p.o_counts),
        (int*)(w + p.o_offs), (int*)(w + p.o_goffs), (int*)(w + p.o_sorted),
        (int*)(w + p.o_items), n_groups);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    // 4. the list scan: a CTA a (group, row block)
    ScanArgs a;
    a.lists = lists;
    a.valid = valid;
    a.norms = norms;
    a.qb = qb;
    a.qn = qn;
    a.q2 = q2;
    a.sorted = (const int*)(w + p.o_sorted);
    a.items = (const int*)(w + p.o_items);
    a.n_groups = n_groups;
    a.part = (Key*)(w + p.o_part);
    a.dims = dims;
    a.list_len = list_len;
    a.nprobe = nprobe;
    a.sim = sim;
    a.n_rb = p.n_rb;
    a.kk = p.kk;
    const long long blocks = p.groups * p.n_rb;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (dims % 4 == 0 && ((uintptr_t)lists & 15) == 0)
        scan_kernel<true><<<(unsigned)blocks, R, scan_smem(p.pcap), stream>>>(
            a);
    else
        scan_kernel<false><<<(unsigned)blocks, R, scan_smem(p.pcap),
                             stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    // 5. the merge
    merge_kernel<<<n_q, PICK_THREADS, sizeof(Key) * p.sel_cap_merge,
                   stream>>>((const Key*)(w + p.o_part), probes, ids, nprobe,
                             p.n_rb, p.kk, list_len, k, p.sel_cap_merge,
                             out_s, out_i);
    return (int)cudaGetLastError();
}
