// The tiled top-k shared by the BM25 families bm25_flat (K1),
// bm25_flat_seg (K2), bm25_coarse (K3) and the rank_features families
// sparse_flat (K15) and sparse_coarse (K16), and through bm25_common.cuh's
// slot axis by their mesh forms mesh_bm25_flat (row 31), mesh_bm25_coarse
// (row 32), mesh_sparse_topk (row 38) and mesh_sparse_coarse (row 34). No
// [rows, n_docs_pad] plane exists in device memory: each (row, tile of
// TILE docs) that a gathered block reaches is summed in shared memory,
// masked, counted and reduced to its best entries there.
//
// One pipeline, a compile-time contribution policy (``Bm25Policy``,
// ``FeaturePolicy``, each in f32 and in the coarse tier's bf16): what a
// listed entry carries (BM25: weight and avgdl, the doc lengths read per
// posting; rank_features: the query weight and the rank_feature
// function), how a posting becomes an f32 contribution, and whether the
// tile pass reads a block whole or only its postings in the tile.
//
// 0. Entries. BM25 takes flatten_plans' flat (block, weight, query, avgdl)
//    lists; rank_features takes each row's [QB] block list and query
//    weights (row q of group g holds entries (g * n_q + q) * QB ...), so
//    an entry's row is its position over QB, and no list is rebuilt.
// 1. Binning. Each block of a store has a doc range (the least and the
//    greatest valid doc, ops/device_segment.py ``block_ranges``). Every
//    gathered entry of non-zero weight is listed under each (row, tile)
//    its range reaches: one pass counts the entries of every pair, a scan
//    gives each pair its place, and a second pass writes the lists. A
//    zero-weight entry adds nothing (the padding of ``flatten_plans`` and
//    of the block lists) and is skipped. The launcher copies the number of
//    pairs and list entries to the host and waits for them (one
//    synchronisation a call) so that the lists are sized exactly; a block
//    whose range reaches m tiles is listed m times (the "extra block
//    reads" chip_smoke.py reports). Under ``FeaturePolicy`` each listing
//    of a block that spans tiles also carries the run of the block's
//    positions whose docs lie in that tile (docs ascend in a block, so
//    the runs partition it; a block whose docs do not ascend is listed
//    whole in every tile), and the tile pass reads only that run: a
//    rare feature's block spans up to a few hundred tiles and adds a
//    posting or a few to each. The count pass lists those spanning
//    entries, and a warp each lists them with their runs.
// 2. The tile pass. Persistent CTAs take the non-empty pairs from a queue.
//    A CTA zeroes TILE 64-bit accumulators in shared memory (two 32-bit
//    halves: the carry of the low word's atomic add goes into the high
//    word, so the sum is the exact 64-bit sum in any order), adds the
//    fixed-point contribution (bm25_common.cuh) of every posting of its
//    listed blocks that falls in the tile, and then, without leaving the
//    CTA: masks by ``live`` and score > 0, counts the matches (per row, or
//    per segment through ``seg_ids``), and keeps its best entries
//    ("tops"): the best one at t 1; at t 64 or 256 (by k) between t and
//    2t of them, every key at or above a bound that a radix select over
//    the tile's keys in shared memory stops at as soon as it holds at most
//    2t keys. Unused slots hold -inf entries at distinct docs.
//    Integer sums do not depend on the order of addition, so every score
//    has the bits the dense plane gave. Under ``FeaturePolicy`` the runs
//    of a pair are laid end to end and the CTA's threads take their
//    postings densely (``sum_runs``), and with no doc lengths to stage a
//    CTA needs 68 KB, so three run on an SM.
// 3. Selection. Keys are rows_select.cuh's (score bits high, n - 1 - doc
//    low; all distinct). tau, the k-th largest key among a row's tops,
//    stands for k distinct entries at or above it, so the row's true k-th
//    key is at least tau. A tile that left matches out of its tops while
//    its least top reaches tau may hold more entries at or above tau than
//    its tops: it is summed again ("rerun") and lists every entry at or
//    above tau; every other tile lists its tops at or above tau. The k
//    best of those lists are the row's k best (every entry at or above
//    the true k-th key is listed). A rerun tile has at least t tops at or
//    above tau, so at most floor(k / t) tiles of a row rerun and a row's
//    list holds at most k + floor(k / t) (TILE - t) entries. A row with
//    fewer than k finite tops has no tau: every tile that left matches out
//    reruns and the list is every match. The final selection is one
//    rows_select.cuh launch for all rows, any k.
// 4. The -inf fill. When a row matches m < k docs, lax.top_k fills
//    positions m..k-1 with -inf at the lowest-indexed docs that did not
//    match; those lie below k, so a CTA a row marks the matched docs below
//    k in a bitmap and writes the first k - m unmatched ones in order.
//
// 5. The dense row (bm25_scores K8, sparse_scores K19): one query's
//    [n_docs_pad] f32 row, no top-k. The same sums at one row, and an
//    ending that writes every tile once, masked by ``live``; section 5
//    below says how its lists are sized with no synchronisation.
//
// What bounds it: the gathered blocks (doc ids and tfs or weights) and,
// for BM25, the doc lengths they gather; the plane's memset and read-back
// (8 bytes a cell) are gone. With many rows over a wide plane, the fixed
// cost of each (row, tile) pair (64 KB of shared sums zeroed, TILE keys
// masked) adds to it. The plain PyTorch versions are ops/bm25.py
// bm25_flat_plain, bm25_flat_seg_plain, bm25_coarse_plain and
// bm25_block_scores_plain, ops/sparse.py sparse_flat_plain,
// sparse_coarse_plain and sparse_scores_plain; ops/bm25.py
// ``bm25_tiles_mirror`` / ``bm25_dense_mirror`` and ops/sparse.py
// ``sparse_tiles_mirror`` / ``sparse_dense_mirror`` mirror this algorithm
// on the CPU.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "bm25_common.cuh"
#include "feature_fn.cuh"
#include "rows_select.cuh"

namespace tiles {

using bm25::Consts;
using bm25::Slots;
using rsel::Key;

constexpr int TILE = 8192;           // docs a tile (64 KB of sums)
constexpr int TILE_SHIFT = 13;
constexpr int THREADS = 512;         // a tile CTA
constexpr int STAGE = 256;           // listed blocks staged at a time
constexpr int STAGED_BLOCKS = 16;    // a pair's blocks that stage doc_lens
constexpr int HBITS = 11;            // widest digit of the tile's select
constexpr int AUX_THREADS = 256;     // binning and copies
constexpr int SCAN_THREADS = 1024;

// Slots a tile's tops take: 1 at t 1, else 2t (a tile keeps between t
// and 2t of its best, tile_bound).
__host__ __device__ inline int tops_width(int t) { return t == 1 ? 1 : 2 * t; }

// t of a launch: a tile keeps at least t of its best entries. At most 4
// rows and k <= 16, t is 16 (>= k: the tops hold the answer, no
// threshold or rerun); else 1 for k <= 32 (the tile's best entry: a
// reduction, a few tiles a row rerun), 64 up to 4,096, 256 above. 1
// where a tile holds fewer docs than the tops' slots (a small or ragged
// last tile), so that pads stay distinct.
inline int tops_for(int k, long long n_docs_pad, long long rows) {
    int t = k <= 32 ? 1 : (k <= 4096 ? 64 : 256);
    if (k <= 16 && rows <= 4) t = 16;
    const long long last = n_docs_pad - (n_docs_pad - 1) / TILE * TILE;
    return last < tops_width(t) ? 1 : t;
}

inline long long up256(long long b) { return (b + 255) / 256 * 256; }

// Scratch before the host read-back (A: sized by rows, tiles and k) and
// after it (B: sized by the pairs, list entries and final entries found).
struct LayoutA {
    long long totals, queue, cnt, mcount, fcnt, st1, st2, keys1, keys2,
        zero_end;
    long long loc_e, loc_p, row_e, row_p, base_e, base_p, off_tops, tcnt,
        off_final, cap_final, tau_s, tau_d, bitmap, spans, total;
};

// totals: [0] pairs, [1] list entries, [2] final-list capacity, [3]
// entries binned, [4] tiles rerun, [5] final-list appends refused (0 by
// the bound above), [6] postings the tile pass reads beyond the gathered
// blocks' own (FeaturePolicy: a block whose docs do not ascend, read
// whole in every tile it spans), [7] entries that span tiles
// (FeaturePolicy: listed in ``spans``)
constexpr int N_TOTALS = 8;

// ``entries``: the entries a FeaturePolicy launch may list as spanning
// tiles (0 for Bm25Policy).
inline LayoutA layout_a(long long rows, long long n_tiles, int k,
                        long long entries) {
    LayoutA L{};
    long long off = 0;
    auto take = [&](long long bytes) {
        const long long at = off;
        off += up256(bytes);
        return at;
    };
    L.totals = take(N_TOTALS * 8);
    L.queue = take(4 * 4);
    L.cnt = take(rows * n_tiles * 4);
    L.mcount = take(rows * 4);
    L.fcnt = take(rows * 4);
    L.st1 = take(rows::state_bytes(rows));
    L.st2 = take(rows::state_bytes(rows));
    // rows_select leaves a row's keys past its survivors unwritten; above
    // CAP they are sorted with the rest, so they must start at zero (one
    // buffer a selection)
    L.keys1 = take(rows::keys_bytes(rows, k));
    L.keys2 = take(rows::keys_bytes(rows, k));
    L.zero_end = k > rows::CAP ? off : L.keys1;
    L.loc_e = take(rows * n_tiles * 8);
    L.loc_p = take(rows * n_tiles * 4);
    L.row_e = take(rows * 8);
    L.row_p = take(rows * 8);
    L.base_e = take(rows * 8);
    L.base_p = take(rows * 8);
    L.off_tops = take(rows * 8);
    L.tcnt = take(rows * 4);
    L.off_final = take(rows * 8);
    L.cap_final = take(rows * 8);
    L.tau_s = take(rows * 4);
    L.tau_d = take(rows * 4);
    L.bitmap = take(rows * ((k + 31LL) / 32) * 4);
    L.spans = take(entries * 4);
    L.total = off;
    return L;
}

struct LayoutB {
    long long pair_rt, pair_n, pair_e, c_p, tkey, rerun, elist, esub,
        tops_s, tops_d, final_s, final_d, total;
};

// ``runs``: each list entry also carries its run of block positions
// (FeaturePolicy).
inline LayoutB layout_b(long long pairs, long long entries, long long fin,
                        int t, bool runs) {
    LayoutB L{};
    long long off = 0;
    auto take = [&](long long bytes) {
        const long long at = off;
        off += up256(bytes);
        return at;
    };
    L.pair_rt = take(pairs * 4);
    L.pair_n = take(pairs * 4);
    L.pair_e = take(pairs * 8);
    L.c_p = take(pairs * 4);
    L.tkey = take(pairs * 8);
    L.rerun = take(pairs * 4);
    L.elist = take(entries * 4);
    L.esub = take(runs ? entries * 2 : 0);
    L.tops_s = take(pairs * tops_width(t) * 4);
    L.tops_d = take(pairs * tops_width(t) * 4);
    L.final_s = take(fin * 4);
    L.final_d = take(fin * 4);
    L.total = off;
    return L;
}

// Everything a launch's kernels read and write.
struct Tiles {
    // the problem
    const int* block_docs;
    const void* block_tfs;
    const int* ranges;          // [S, nb, 2]
    const void* doc_lens;
    const int* flat_idx;
    const float* flat_w;
    const int* flat_q;          // null: an entry's row is its place over qb
    const float* flat_avgdl;    // null: every entry's avgdl is ``avg``
    float avg;
    const uint8_t* live;
    const int* seg_ids;
    Slots sl;
    long long nb;               // blocks a slot
    int fb, qb, n_q, k, t, mode, n_segs;
    long long n_docs_pad, n_tiles, rows;
    Consts c;                   // Bm25Policy
    sparse::Params fp;          // FeaturePolicy
    // scratch A
    long long* totals;
    unsigned* queue;
    int* cnt;
    int* mcount;                // matches a row (hits itself for COUNT_TOTAL)
    int* hits;                  // COUNT_SEGS: [rows, n_segs]
    int* fcnt;
    long long* loc_e;
    int* loc_p;
    long long *row_e, *row_p, *base_e, *base_p, *off_tops, *off_final,
        *cap_final;
    int* tcnt;
    float* tau_s;
    int* tau_d;
    unsigned* bitmap;
    int* spans;                 // FeaturePolicy: the entries spanning tiles
    // scratch B
    int* pair_rt;
    int* pair_n;
    long long* pair_e;
    int* c_p;
    Key* tkey;
    int* rerun;
    int* elist;
    unsigned short* esub;       // an entry's run: first | (end << 8)
    float* tops_s;
    int* tops_d;
    float* final_s;
    int* final_d;
    // the dense row (section 5)
    float* row;                 // [n_docs_pad] out
    long long cap;              // list entries scratch holds
};

// --------------------------------------------------------------------------
// the contribution policies
// --------------------------------------------------------------------------

// BM25 (K1-K3, rows 31 / 32): an entry carries its term's weight (idf *
// boost) and avgdl; a posting's tf and its doc's length give contrib_f32,
// or contrib_bf16 over the bf16 mirrors (BF16). Blocks are read whole.
template <bool BF16_>
struct Bm25Policy {
    static constexpr bool BF16 = BF16_;   // block values, doc lengths bf16
    static constexpr bool RUNS = false;   // a spanning block's run a tile
    static constexpr int CTAS = 2;        // tile CTAs an SM
    __device__ static float value(const Tiles& a, float w, float avg,
                                  float tf, float dl) {
        return BF16 ? bm25::contrib_bf16(bm25::bfr(w), tf, dl,
                                         bm25::bfr(avg), a.c)
                    : bm25::contrib_f32(w, tf, dl, avg, a.c);
    }
};

// rank_features (K15, K16, rows 34 / 38): an entry carries its query
// weight qw; a posting's weight w gives qw * f(w) (feature_fn.cuh), or in
// the coarse tier (BF16) f32(bf16(qw)) * f32(w_bf16), the product of two
// bf16 values, exact in f32 and left unrounded as the JAX program leaves
// it. No doc lengths; a block spanning tiles is read one run a tile.
template <bool BF16_>
struct FeaturePolicy {
    static constexpr bool BF16 = BF16_;
    static constexpr bool RUNS = true;
    static constexpr int CTAS = 3;        // no doc lengths staged: 72 KB
    __device__ static float value(const Tiles& a, float qw, float, float w,
                                  float) {
        return BF16 ? __fmul_rn(bm25::bfr(qw), w)
                    : __fmul_rn(qw, sparse::transform(a.fp.fn, w, a.fp.pivot,
                                                      a.fp.exponent,
                                                      a.fp.pivot_pow));
    }
};

// --------------------------------------------------------------------------
// small CTA helpers
// --------------------------------------------------------------------------

// Exclusive prefix sum of v over the CTA, and the CTA's total; ws: 33
// shared words of T.
template <class T>
__device__ T cta_excl_scan(T v, T* ws, T& total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n_warps = (blockDim.x + 31) >> 5;
    T x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const T y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) ws[warp] = x;
    __syncthreads();
    if (warp == 0) {
        T w = lane < n_warps ? ws[lane] : T(0);
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const T y = __shfl_up_sync(0xffffffffu, w, o);
            if (lane >= o) w += y;
        }
        ws[lane] = w;
    }
    __syncthreads();
    const T base = warp ? ws[warp - 1] : T(0);
    total = ws[n_warps - 1];
    __syncthreads();
    return base + x - v;
}

// Append (s, d) to a list through a cursor, one atomic a warp; every lane
// of the warp calls it. Positions at or past ``cap`` are refused, counted
// in ``refused``.
__device__ __forceinline__ void warp_append(bool take, float s, int d,
                                            int* cursor, long long base,
                                            long long cap, float* out_s,
                                            int* out_d,
                                            long long* refused) {
    const unsigned ballot = __ballot_sync(0xffffffffu, take);
    if (ballot == 0u) return;
    const int lane = threadIdx.x & 31;
    int pos = 0;
    if (lane == __ffs(ballot) - 1) pos = atomicAdd(cursor, __popc(ballot));
    pos = __shfl_sync(0xffffffffu, pos, __ffs(ballot) - 1);
    pos += __popc(ballot & ((1u << lane) - 1u));
    if (!take) return;
    if (pos < cap) {
        out_s[base + pos] = s;
        out_d[base + pos] = d;
    } else {
        atomicAdd((unsigned long long*)refused, 1ull);
    }
}

// --------------------------------------------------------------------------
// 1. binning
// --------------------------------------------------------------------------

// Entry f's row and tile span; false for a zero-weight or empty block.
__device__ __forceinline__ bool entry_span(const Tiles& a, long long f,
                                           long long& r, long long& lo,
                                           long long& hi) {
    if (a.flat_w[f] == 0.f) return false;
    const long long g = f / a.fb;
    const long long slot = g / a.sl.groups_per_slot;
    const int2 rg =
        ((const int2*)a.ranges)[slot * a.nb + (long long)a.flat_idx[f]];
    if (rg.y < rg.x || rg.y < 0) return false;
    lo = rg.x > 0 ? (long long)rg.x >> TILE_SHIFT : 0;
    hi = (long long)rg.y >> TILE_SHIFT;
    if (hi >= a.n_tiles) hi = a.n_tiles - 1;
    if (lo > hi) return false;
    r = g * a.n_q +
        (a.flat_q != nullptr ? a.flat_q[f] : (int)((f % a.fb) / a.qb));
    return true;
}

// The lanes of a warp whose entries lie in one tile of one row: those
// with the same (row, tile) key form a group (a block of a term and the
// next block of it mostly share one), led by the group's lowest lane.
// Every lane of the warp must call it; ``single`` is false for a lane
// whose entry spans several tiles or none.
__device__ __forceinline__ unsigned tile_group(bool single, long long key) {
    return __match_any_sync(0xffffffffu, single ? key : -1LL);
}

// Count entry f into the entries of each (row, tile), one atomic a group
// of lanes for the entries within one tile; under FeaturePolicy list the
// entries that span tiles (``spans``, totals[7]). DENSE (section 5): list
// them under either policy and leave their counts to the dense binning.
// Every lane of the warp calls it (f past the entries counts nothing).
template <class P, bool DENSE>
__device__ void count_entry(const Tiles& a, long long f) {
    const int lane = threadIdx.x & 31;
    long long r = 0, lo = 0, hi = -1;
    const bool ok = f < (long long)a.sl.groups * a.fb &&
                    entry_span(a, f, r, lo, hi);
    const unsigned ballot = __ballot_sync(0xffffffffu, ok);
    if (lane == 0 && ballot)
        atomicAdd((unsigned long long*)&a.totals[3],
                  (unsigned long long)__popc(ballot));
    const bool single = ok && lo == hi;
    const unsigned grp = tile_group(single, r * a.n_tiles + lo);
    if (P::RUNS || DENSE) {
        const unsigned spanning = __ballot_sync(0xffffffffu, ok && !single);
        if (spanning) {
            const int leader = __ffs(spanning) - 1;
            unsigned long long base = 0;
            if (lane == leader)
                base = atomicAdd((unsigned long long*)&a.totals[7],
                                 (unsigned long long)__popc(spanning));
            base = __shfl_sync(0xffffffffu, base, leader);
            if (ok && !single)
                a.spans[base + __popc(spanning & ((1u << lane) - 1u))] =
                    (int)f;
        }
    }
    if (single) {
        if (lane == __ffs(grp) - 1)
            atomicAdd(&a.cnt[r * a.n_tiles + lo], __popc(grp));
        return;
    }
    if (DENSE) return;
    for (long long tile = lo; tile <= hi; ++tile)
        atomicAdd(&a.cnt[r * a.n_tiles + tile], 1);
}

// grid over every entry: count_entry.
template <class P>
__global__ void count_kernel(Tiles a) {
    count_entry<P, false>(a, (long long)blockIdx.x * blockDim.x +
                                 threadIdx.x);
}

// grid (rows): each row's exclusive prefix of entries and of non-empty
// pairs over its tiles, and the row's totals.
__global__ void scan_rows_kernel(Tiles a) {
    __shared__ long long ws_e[33];
    __shared__ int ws_p[33];
    const long long r = blockIdx.x;
    long long run_e = 0;
    int run_p = 0;
    for (long long base = 0; base < a.n_tiles; base += blockDim.x) {
        const long long i = base + threadIdx.x;
        const int v = i < a.n_tiles ? a.cnt[r * a.n_tiles + i] : 0;
        long long te;
        int tp;
        const long long xe = cta_excl_scan<long long>(v, ws_e, te);
        const int xp = cta_excl_scan<int>(v > 0, ws_p, tp);
        if (i < a.n_tiles) {
            a.loc_e[r * a.n_tiles + i] = run_e + xe;
            a.loc_p[r * a.n_tiles + i] = run_p + xp;
        }
        run_e += te;
        run_p += tp;
    }
    if (threadIdx.x == 0) {
        a.row_e[r] = run_e;
        a.row_p[r] = run_p;
    }
}

// one CTA: the rows' bases, each row's tops region and final-list
// capacity, tau cleared, and the totals the host reads back.
__global__ void scan_totals_kernel(Tiles a, int no_final) {
    __shared__ long long ws[33];
    long long run_p = 0, run_e = 0, run_f = 0;
    for (long long base = 0; base < a.rows; base += blockDim.x) {
        const long long r = base + threadIdx.x;
        const bool in = r < a.rows;
        const long long p = in ? a.row_p[r] : 0;
        const long long e = in ? a.row_e[r] : 0;
        long long cap = 0;
        if (in && !no_final && p > 0) {
            const long long reruns = (long long)(a.k / a.t) < p
                                         ? (long long)(a.k / a.t) : p;
            cap = a.k + reruns * (TILE - a.t);
            if (cap > p * TILE) cap = p * TILE;
        }
        long long tp, te, tf;
        const long long xp = cta_excl_scan<long long>(p, ws, tp);
        const long long xe = cta_excl_scan<long long>(e, ws, te);
        const long long xf = cta_excl_scan<long long>(cap, ws, tf);
        if (in) {
            a.base_p[r] = run_p + xp;
            a.base_e[r] = run_e + xe;
            a.off_tops[r] = (run_p + xp) * tops_width(a.t);
            a.tcnt[r] = (int)(p * tops_width(a.t));
            a.off_final[r] = run_f + xf;
            a.cap_final[r] = cap;
            a.tau_s[r] = -INFINITY;
            a.tau_d[r] = 0;
        }
        run_p += tp;
        run_e += te;
        run_f += tf;
    }
    if (threadIdx.x == 0) {
        a.totals[0] = run_p;
        a.totals[1] = run_e;
        a.totals[2] = run_f;
    }
}

// grid over (row, tile): each non-empty pair's place, tile and list.
__global__ void pairs_kernel(Tiles a) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= a.rows * a.n_tiles) return;
    const int v = a.cnt[i];
    if (v == 0) return;
    const long long r = i / a.n_tiles;
    const long long p = a.base_p[r] + a.loc_p[i];
    a.pair_rt[p] = (int)i;
    a.pair_n[p] = v;
    a.pair_e[p] = a.base_e[r] + a.loc_e[i];
}

// Entry f's place in the list of pair (r, tile), taken from the pair's
// cursor (cnt counts down to 0).
__device__ __forceinline__ long long list_slot(const Tiles& a, long long r,
                                               long long tile) {
    const long long i = r * a.n_tiles + tile;
    return a.base_e[r] + a.loc_e[i] + atomicSub(&a.cnt[i], 1) - 1;
}

// FeaturePolicy, one warp: list entry f (a block spanning tiles lo..hi of
// row r) under each tile with the run of the block's positions whose docs
// lie in it. Valid docs ascend in a block, so the runs are consecutive:
// tile t > lo starts at the first position of a doc in t or past it, tile
// lo at 0, and each run ends where the next starts (tile hi's at BLOCK):
// a position's prefix maximum of the tiles of the valid docs up to it
// (pm) is non-decreasing, and a run's start is a lower bound in it. A
// block whose docs do not ascend is listed whole in every tile (its reads
// beyond one pass counted in totals[6]). ``pm``: BLOCK shared ints of the
// warp's own.
__device__ void fill_runs(const Tiles& a, long long f, long long r,
                          long long lo, long long hi, int* pm) {
    const int lane = threadIdx.x & 31;
    const long long slot = (f / a.fb) / a.sl.groups_per_slot;
    const int4 v = ((const int4*)(a.block_docs + slot * a.sl.slot_blocks +
                                  (long long)a.flat_idx[f] *
                                      bm25::BLOCK))[lane];
    const int d[4] = {v.x, v.y, v.z, v.w};
    // the docs' running maximum: within the lane's 4, then over the lanes
    int run[4], m = -1;
    bool ascending = true;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
        ascending = ascending && (d[u] < 0 || d[u] >= m);
        m = d[u] > m ? d[u] : m;
        run[u] = m;
    }
    int before = m;             // the lanes' inclusive max-scan
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, before, o);
        if (lane >= o) before = y > before ? y : before;
    }
    before = __shfl_up_sync(0xffffffffu, before, 1);
    if (lane == 0) before = -1;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
        ascending = ascending && (d[u] < 0 || d[u] >= before);
        const int mx = run[u] > before ? run[u] : before;
        long long t = mx < 0 ? lo - 1 : (long long)mx >> TILE_SHIFT;
        pm[4 * lane + u] = (int)((t > hi ? hi : t) - lo);
    }
    ascending = __all_sync(0xffffffffu, ascending);
    __syncwarp();
    // start of tile lo + x (x >= 1): the first position whose pm >= x
    auto start = [&](int x) {
        int first = 0, n = bm25::BLOCK;
        while (n > 0) {
            const int half = n >> 1;
            if (pm[first + half] < x) {
                first += half + 1;
                n -= half + 1;
            } else {
                n = half;
            }
        }
        return first;
    };
    const int span = (int)(hi - lo);
    for (int x = lane; x <= span; x += 32) {
        const int p0 = !ascending || x == 0 ? 0 : start(x);
        const int p1 = !ascending || x == span ? bm25::BLOCK : start(x + 1);
        const long long at = list_slot(a, r, lo + x);
        a.elist[at] = (int)f;
        a.esub[at] = (unsigned short)(p0 | (p1 << 8));
    }
    if (!ascending && lane == 0)
        atomicAdd((unsigned long long*)&a.totals[6],
                  (unsigned long long)span * bm25::BLOCK);
    __syncwarp();
}

// grid over every entry: write each entry into the list of every pair it
// reaches (cnt counts down to 0 as the cursor; one atomic a group of
// lanes, as in count_kernel).
template <class P>
__global__ void fill_kernel(Tiles a) {
    const long long f = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const int lane = threadIdx.x & 31;
    long long r = 0, lo = 0, hi = -1;
    const bool ok = f < (long long)a.sl.groups * a.fb &&
                    entry_span(a, f, r, lo, hi);
    const bool single = ok && lo == hi;
    const unsigned grp = tile_group(single, r * a.n_tiles + lo);
    if (single) {
        const long long i = r * a.n_tiles + lo;
        const int leader = __ffs(grp) - 1;
        int end = 0;
        if (lane == leader) end = atomicSub(&a.cnt[i], __popc(grp));
        end = __shfl_sync(grp, end, leader);
        const int pos = end - __popc(grp) + __popc(grp & ((1u << lane) - 1u));
        const long long at = a.base_e[r] + a.loc_e[i] + pos;
        a.elist[at] = (int)f;
        if (P::RUNS) a.esub[at] = (unsigned short)(bm25::BLOCK << 8);
    }
    if (P::RUNS || !ok || single) return;   // runs_kernel lists the rest
    for (long long tile = lo; tile <= hi; ++tile)
        a.elist[list_slot(a, r, tile)] = (int)f;
}

// FeaturePolicy: a warp at a time takes a spanning entry from ``spans``
// (count_kernel's list, totals[7] long) and lists it with its runs.
__global__ void runs_kernel(Tiles a) {
    __shared__ int pm[AUX_THREADS / 32][bm25::BLOCK];
    const long long n = a.totals[7];
    const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
    for (long long w = (long long)blockIdx.x * (blockDim.x >> 5) +
                       (threadIdx.x >> 5);
         w < n; w += warps) {
        const long long f = a.spans[w];
        long long r = 0, lo = 0, hi = -1;
        entry_span(a, f, r, lo, hi);
        fill_runs(a, f, r, lo, hi, pm[threadIdx.x >> 5]);
    }
}

// --------------------------------------------------------------------------
// 2. the tile pass (MODE 0), the triage and the rerun pass (MODE 1)
// --------------------------------------------------------------------------

struct TileShared {
    int pair;
    int cursor;
    unsigned long long best;
    unsigned long long prefix;
    int rank;
    int above;
    int done;
    int ws_i[33];
    unsigned long long ws_k[32];
};

// Add fx to the 64-bit sum of slot i, kept as 32-bit halves.
__device__ __forceinline__ void add_fixed(unsigned* lo, unsigned* hi, int i,
                                          long long fx) {
    const unsigned l = (unsigned)fx;
    const unsigned h = (unsigned)((unsigned long long)fx >> 32);
    const unsigned old = atomicAdd(&lo[i], l);
    atomicAdd(&hi[i], h + (old + l < old ? 1u : 0u));
}

__device__ __forceinline__ float key_score32(unsigned w) {
    return __uint_as_float((w & 0x80000000u) ? (w & 0x7fffffffu) : ~w);
}

// Bm25Policy: sum the pair's listed blocks into lo/hi (zeroed here) for
// docs [doc0, doc0 + n) of its slot. 128 threads take a block, four
// blocks a CTA step, U steps a round; the doc ids and tfs of the next
// round are in flight while a round's doc lengths are read and its
// postings added. A pair of at least STAGED_BLOCKS blocks first copies
// the tile's doc lengths into s_dl (coalesced, once), any other gathers
// them from device memory.
template <class P>
__device__ void sum_tile(const Tiles& a, long long p, long long slot,
                         long long doc0, int n, unsigned* lo, unsigned* hi,
                         float* s_dl, long long* s_blk, float* s_w,
                         float* s_avg) {
    for (int j = threadIdx.x; j < TILE / 4; j += THREADS) {
        ((uint4*)lo)[j] = make_uint4(0u, 0u, 0u, 0u);
        ((uint4*)hi)[j] = make_uint4(0u, 0u, 0u, 0u);
    }
    const long long e0 = a.pair_e[p];
    const int ne = a.pair_n[p];
    const long long sd = slot * a.sl.slot_docs;
    const bool staged = ne >= STAGED_BLOCKS;
    if (staged)
        for (int j = threadIdx.x; j < n; j += THREADS)
            s_dl[j] = P::BF16 ? __bfloat162float(
                                    ((const __nv_bfloat16*)a.doc_lens)[sd +
                                                                       doc0 +
                                                                       j])
                              : ((const float*)a.doc_lens)[sd + doc0 + j];
    const int lane = threadIdx.x & (bm25::BLOCK - 1);
    constexpr int GROUPS = THREADS / bm25::BLOCK;   // blocks a CTA step
    constexpr int U = 4;                            // steps a round
    constexpr int ROUND = GROUPS * U;
    const int g = threadIdx.x / bm25::BLOCK;
    for (int j0 = 0; j0 < ne; j0 += STAGE) {
        const int m = ne - j0 < STAGE ? ne - j0 : STAGE;
        __syncthreads();   // the zeroing, or the previous stage, is done
        for (int j = threadIdx.x; j < m; j += THREADS) {
            const int f = a.elist[e0 + j0 + j];
            s_blk[j] = slot * a.sl.slot_blocks +
                       (long long)a.flat_idx[f] * bm25::BLOCK;
            s_w[j] = a.flat_w[f];
            s_avg[j] = a.flat_avgdl != nullptr ? a.flat_avgdl[f] : a.avg;
        }
        __syncthreads();
        auto fetch = [&](int j, int* doc, float* tf) {
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int jj = j + u * GROUPS;
                doc[u] = -1;
                tf[u] = 0.f;
                if (jj < m) {
                    const long long e = s_blk[jj] + lane;
                    doc[u] = a.block_docs[e];
                    tf[u] = P::BF16 ? __bfloat162float(
                                          ((const __nv_bfloat16*)a.block_tfs)
                                              [e])
                                    : ((const float*)a.block_tfs)[e];
                }
            }
        };
        int doc[U];
        float tf[U];
        fetch(g, doc, tf);
        for (int j = g; j < m; j += ROUND) {
            int doc_n[U];
            float tf_n[U];
            fetch(j + ROUND, doc_n, tf_n);
            float dl[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const bool in = (unsigned long long)((long long)doc[u] -
                                                     doc0) <
                                (unsigned long long)n;
                if (!in) doc[u] = -1;
                dl[u] = 0.f;
                if (in && staged)
                    dl[u] = s_dl[doc[u] - doc0];
                else if (in)
                    dl[u] = P::BF16 ? __bfloat162float(
                                          ((const __nv_bfloat16*)a.doc_lens)
                                              [sd + doc[u]])
                                    : ((const float*)a.doc_lens)[sd + doc[u]];
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                if (doc[u] >= 0) {
                    const int jj = j + u * GROUPS;
                    const float v = P::value(a, s_w[jj], s_avg[jj], tf[u],
                                             dl[u]);
                    const long long fx = bm25::to_fixed(v);
                    if (fx != 0) add_fixed(lo, hi, (int)(doc[u] - doc0), fx);
                }
                doc[u] = doc_n[u];
                tf[u] = tf_n[u];
            }
        }
    }
    __syncthreads();
}

// FeaturePolicy: sum the pair's listed runs into lo/hi (zeroed here) for
// docs [doc0, doc0 + n) of its slot. A run is often one posting or a few
// (a rare feature's block spread over many tiles), so a block a 128
// threads would leave most lanes idle: each stage's runs are laid end to
// end (an exclusive scan of their lengths in s_off) and the CTA's threads
// take their postings U at a time, each finding its run by a binary
// search over s_off.
template <class P>
__device__ void sum_runs(const Tiles& a, long long p, long long slot,
                         long long doc0, int n, unsigned* lo, unsigned* hi,
                         long long* s_blk, float* s_w, int* s_off) {
    __shared__ int ws[33];
    for (int j = threadIdx.x; j < TILE / 4; j += THREADS) {
        ((uint4*)lo)[j] = make_uint4(0u, 0u, 0u, 0u);
        ((uint4*)hi)[j] = make_uint4(0u, 0u, 0u, 0u);
    }
    const long long e0 = a.pair_e[p];
    const int ne = a.pair_n[p];
    constexpr int U = 4;
    for (int j0 = 0; j0 < ne; j0 += STAGE) {
        const int m = ne - j0 < STAGE ? ne - j0 : STAGE;
        __syncthreads();   // the zeroing, or the previous stage, is done
        int len = 0;
        if (threadIdx.x < m) {
            const int f = a.elist[e0 + j0 + threadIdx.x];
            const unsigned run = a.esub[e0 + j0 + threadIdx.x];
            s_blk[threadIdx.x] = slot * a.sl.slot_blocks +
                                 (long long)a.flat_idx[f] * bm25::BLOCK +
                                 (run & 0xffu);
            s_w[threadIdx.x] = a.flat_w[f];
            len = (int)(run >> 8) - (int)(run & 0xffu);
        }
        int total;
        const int off = cta_excl_scan<int>(len, ws, total);
        if (threadIdx.x < m) s_off[threadIdx.x] = off;
        __syncthreads();
        for (int i0 = 0; i0 < total; i0 += THREADS * U) {
            int doc[U], at[U];
            float w[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int i = i0 + u * THREADS + threadIdx.x;
                doc[u] = -1;
                w[u] = 0.f;
                at[u] = 0;
                if (i < total) {
                    int first = 0, cnt = m;    // the last run starting <= i
                    while (cnt > 1) {
                        const int half = cnt >> 1;
                        if (s_off[first + half] <= i) {
                            first += half;
                            cnt -= half;
                        } else {
                            cnt = half;
                        }
                    }
                    at[u] = first;
                    const long long e = s_blk[first] + (i - s_off[first]);
                    doc[u] = a.block_docs[e];
                    w[u] = P::BF16 ? __bfloat162float(
                                         ((const __nv_bfloat16*)a.block_tfs)
                                             [e])
                                   : ((const float*)a.block_tfs)[e];
                }
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const bool in = (unsigned long long)((long long)doc[u] -
                                                     doc0) <
                                (unsigned long long)n;
                if (!in) continue;
                const long long fx =
                    bm25::to_fixed(P::value(a, s_w[at[u]], 0.f, w[u], 0.f));
                if (fx != 0) add_fixed(lo, hi, (int)(doc[u] - doc0), fx);
            }
        }
    }
    __syncthreads();
}

// The pair's sums, by the policy.
template <class P>
__device__ __forceinline__ void sum_pair(const Tiles& a, long long p,
                                         long long slot, long long doc0,
                                         int n, unsigned* lo, unsigned* hi,
                                         float* s_dl, long long* s_blk,
                                         float* s_w, float* s_avg) {
    if constexpr (P::RUNS)
        sum_runs<P>(a, p, slot, doc0, n, lo, hi, s_blk, s_w, (int*)s_avg);
    else
        sum_tile<P>(a, p, slot, doc0, n, lo, hi, s_dl, s_blk, s_w, s_avg);
}

// The tile's local key of slot j: score bits, then the lower slot first.
__device__ __forceinline__ unsigned long long local_key(unsigned w, int j) {
    return ((unsigned long long)w << TILE_SHIFT) | (unsigned)(TILE - 1 - j);
}

// The sums -> 32-bit keys (score bits of a match, 0 otherwise), in
// place in lo when ``store`` (slots past n become 0); returns this
// thread's matches and sets ``best`` to its largest local key (0 for
// none).
__device__ int tile_keys(const Tiles& a, long long slot, long long doc0,
                         int n, unsigned* lo, const unsigned* hi,
                         bool count_segs, int* seg_cnt, bool store,
                         unsigned long long& best) {
    const uint8_t* live = a.live + slot * a.sl.slot_docs + doc0;
    const int* seg = a.seg_ids != nullptr
                         ? a.seg_ids + slot * a.sl.slot_docs + doc0
                         : nullptr;
    int mine = 0, cur_seg = -1, cur_n = 0;
    best = 0ull;
    for (int j = threadIdx.x; j < TILE; j += THREADS) {
        unsigned w = 0u;
        if (j < n) {
            const long long v =
                (long long)(((unsigned long long)hi[j] << 32) | lo[j]);
            if (v > 0 && live[j]) {
                w = rsel::score_bits(bm25::from_fixed(v));
                ++mine;
                const unsigned long long key = local_key(w, j);
                best = key > best ? key : best;
                if (count_segs) {
                    const int sg = seg[j];
                    if (sg >= 0 && sg < a.n_segs) {
                        if (sg != cur_seg) {
                            if (cur_n) atomicAdd(&seg_cnt[cur_seg], cur_n);
                            cur_seg = sg;
                            cur_n = 0;
                        }
                        ++cur_n;
                    }
                }
            }
        }
        if (store) lo[j] = w;
    }
    if (cur_n) atomicAdd(&seg_cnt[cur_seg], cur_n);
    return mine;
}

// The largest of the threads' ``best`` local keys.
__device__ unsigned long long tile_max(unsigned long long best,
                                       TileShared& sh) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long y = __shfl_xor_sync(0xffffffffu, best, o);
        best = y > best ? y : best;
    }
    if ((threadIdx.x & 31) == 0) sh.ws_k[threadIdx.x >> 5] = best;
    __syncthreads();
    if (threadIdx.x < 32) {
        unsigned long long b =
            threadIdx.x < THREADS / 32 ? sh.ws_k[threadIdx.x] : 0ull;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            const unsigned long long y = __shfl_xor_sync(0xffffffffu, b, o);
            b = y > b ? y : b;
        }
        if (threadIdx.x == 0) sh.best = b;
    }
    __syncthreads();
    return sh.best;
}

// A local-key bound lb with t <= (matches whose key >= lb) <= 2t, for a
// tile of more than 2t matches: a radix select for the t-th key over the
// key's 45 bits (the score word in 11, 11 and 10 bits, the slot in 7 and
// 6) that stops at the first digit whose bin, with every bin above it,
// holds at most 2t keys (at the last digit the bin is the t-th key
// itself); hist: 2^HBITS shared words.
__device__ unsigned long long tile_bound(const unsigned* lo, int t,
                                         unsigned* hist, TileShared& sh) {
    constexpr int N_PASSES = 5;
    const int shifts[N_PASSES] = {34, 23, 13, 6, 0};
    const int widths[N_PASSES] = {11, 11, 10, 7, 6};
    if (threadIdx.x == 0) {
        sh.prefix = 0ull;
        sh.rank = t;
        sh.above = 0;
        sh.done = 0;
    }
    __syncthreads();
    for (int ps = 0; ps < N_PASSES && !sh.done; ++ps) {
        const int shift = shifts[ps], bits = widths[ps];
        const int nbins = 1 << bits;
        const int top = shift + bits;     // bits above are the prefix
        const unsigned long long prefix = sh.prefix;
        for (int b = threadIdx.x; b < nbins; b += THREADS) hist[b] = 0u;
        __syncthreads();
        // a warp adds once for each digit its lanes share (scores of one
        // magnitude share their top digits)
        for (int j = threadIdx.x; j < TILE; j += THREADS) {
            unsigned d = 0xffffffffu;
            if (lo[j] != 0u) {
                const unsigned long long key = local_key(lo[j], j);
                if (top >= 45 || (key >> top) == (prefix >> top))
                    d = (unsigned)(key >> shift) & (nbins - 1);
            }
            const unsigned peers = __match_any_sync(0xffffffffu, d);
            if (d != 0xffffffffu && (threadIdx.x & 31) == __ffs(peers) - 1)
                atomicAdd(&hist[d], (unsigned)__popc(peers));
        }
        __syncthreads();
        // bins from the top, nbins / THREADS (at most 4) a thread
        constexpr int MAXB = (1 << HBITS) / THREADS;
        const int per = nbins > THREADS ? nbins / THREADS : 1;
        unsigned c[MAXB];
        unsigned sum = 0u;
#pragma unroll
        for (int i = 0; i < MAXB; ++i) {
            const int b = threadIdx.x * per + i;
            c[i] = (i < per && b < nbins) ? hist[nbins - 1 - b] : 0u;
            sum += c[i];
        }
        int tot;
        unsigned before = (unsigned)cta_excl_scan<int>((int)sum, sh.ws_i, tot);
        const unsigned rank = (unsigned)sh.rank;
        const unsigned above = (unsigned)sh.above;
        __syncthreads();
#pragma unroll
        for (int i = 0; i < MAXB; ++i) {
            const int b = threadIdx.x * per + i;
            if (i < per && b < nbins && before < rank &&
                before + c[i] >= rank) {
                sh.prefix = prefix | ((unsigned long long)(nbins - 1 - b)
                                      << shift);
                sh.rank = (int)(rank - before);
                sh.above = (int)(above + before);
                sh.done = above + before + c[i] <= 2u * (unsigned)t;
            }
            before += c[i];
        }
        __syncthreads();
    }
    return sh.prefix;
}

// A row's threshold key, or none (0, with has = false).
__device__ __forceinline__ Key row_tau(const Tiles& a, long long r,
                                       bool& has) {
    has = a.tau_s[r] > -INFINITY;
    return has ? rsel::make_key(a.tau_s[r], a.tau_d[r], a.n_docs_pad) : 0ull;
}

// grid over the pairs, a warp each: a pair that left matches out of its
// tops while its least top reaches tau (or any pair that left matches out,
// in a row without tau) goes to the rerun list (totals[4] counts it); any
// other lists its tops at or above tau.
__global__ void triage_kernel(Tiles a) {
    const long long p =
        ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (p >= a.totals[0]) return;
    const long long r = a.pair_rt[p] / a.n_tiles;
    bool has_tau;
    const Key tau = row_tau(a, r, has_tau);
    if (a.c_p[p] > 0 && (!has_tau || a.tkey[p] >= tau)) {
        if (lane == 0)
            a.rerun[atomicAdd((unsigned long long*)&a.totals[4], 1ull)] =
                (int)p;
        return;
    }
    const int tw = tops_width(a.t);
    for (int j0 = 0; j0 < tw; j0 += 32) {
        const int j = j0 + lane;
        bool take = false;
        float sc = -INFINITY;
        int d = 0;
        if (j < tw) {
            sc = a.tops_s[p * tw + j];
            d = a.tops_d[p * tw + j];
            take = sc > -INFINITY &&
                   (!has_tau || rsel::make_key(sc, d, a.n_docs_pad) >= tau);
        }
        warp_append(take, sc, d, &a.fcnt[r], a.off_final[r], a.cap_final[r],
                    a.final_s, a.final_d, &a.totals[5]);
    }
}

// The tile pass over one pair: sums, keys, counts, tops (MODE 0); or, for
// a pair on the rerun list, the sums again and every entry at or above
// tau into the row's final list (MODE 1). Persistent CTAs take the pairs
// (MODE 0) or the rerun list (MODE 1) from a queue.
template <class P, int MODE>
__global__ void __launch_bounds__(THREADS, P::CTAS) tile_kernel(Tiles a) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned* lo = (unsigned*)smem_raw;
    unsigned* hi = lo + TILE;
    float* s_dl = (float*)(hi + TILE);   // Bm25Policy only
    long long* s_blk = (long long*)(s_dl + (P::RUNS ? 0 : TILE));
    float* s_w = (float*)(s_blk + STAGE);
    float* s_avg = s_w + STAGE;
    int* seg_cnt = (int*)s_dl;   // once the sums are done
    __shared__ TileShared sh;
    const long long n_work = MODE == 0 ? a.totals[0] : a.totals[4];
    const bool count_segs = MODE == 0 && a.mode == bm25::COUNT_SEGS;
    for (;;) {
        if (threadIdx.x == 0) sh.pair = (int)atomicAdd(&a.queue[MODE], 1u);
        __syncthreads();
        const long long q = sh.pair;
        __syncthreads();
        if (q >= n_work) break;
        const long long p = MODE == 0 ? q : a.rerun[q];
        const long long rt = a.pair_rt[p];
        const long long r = rt / a.n_tiles;
        const long long tile = rt - r * a.n_tiles;
        const long long slot = (r / a.n_q) / a.sl.groups_per_slot;
        const long long doc0 = tile * TILE;
        const int n = (int)(a.n_docs_pad - doc0 < TILE ? a.n_docs_pad - doc0
                                                       : TILE);
        const int t = a.t;
        unsigned long long best;
        if (MODE == 1) {
            bool has_tau;
            const Key tau = row_tau(a, r, has_tau);
            sum_pair<P>(a, p, slot, doc0, n, lo, hi, s_dl, s_blk, s_w,
                        s_avg);
            tile_keys(a, slot, doc0, n, lo, hi, false, nullptr, true, best);
            __syncthreads();
            for (int j = threadIdx.x; j < TILE; j += THREADS) {
                const unsigned w = lo[j];
                bool take = false;
                float sc = 0.f;
                if (w != 0u) {
                    sc = key_score32(w);
                    take = !has_tau ||
                           rsel::make_key(sc, doc0 + j, a.n_docs_pad) >= tau;
                }
                warp_append(take, sc, (int)(doc0 + j), &a.fcnt[r],
                            a.off_final[r], a.cap_final[r], a.final_s,
                            a.final_d, &a.totals[5]);
            }
            __syncthreads();
            continue;
        }
        if (threadIdx.x == 0) sh.cursor = 0;
        sum_pair<P>(a, p, slot, doc0, n, lo, hi, s_dl, s_blk, s_w, s_avg);
        if (count_segs) {
            for (int s = threadIdx.x; s < a.n_segs; s += THREADS)
                seg_cnt[s] = 0;
            __syncthreads();
        }
        const int mine = tile_keys(a, slot, doc0, n, lo, hi, count_segs,
                                   seg_cnt, t > 1, best);
        int c;
        cta_excl_scan<int>(mine, sh.ws_i, c);
        if (threadIdx.x == 0 && c) atomicAdd(&a.mcount[r], c);
        if (count_segs)
            for (int s = threadIdx.x; s < a.n_segs; s += THREADS)
                if (seg_cnt[s])
                    atomicAdd(&a.hits[r * a.n_segs + s], seg_cnt[s]);
        const int tw = tops_width(t);
        float* ts = a.tops_s + p * tw;
        int* td = a.tops_d + p * tw;
        if (t == 1) {
            best = tile_max(best, sh);
            if (threadIdx.x == 0) {
                a.c_p[p] = c > 1 ? c - 1 : 0;   // the matches left out
                if (c > 0) {
                    const int j = TILE - 1 - (int)(best & (TILE - 1));
                    const float sc =
                        key_score32((unsigned)(best >> TILE_SHIFT));
                    ts[0] = sc;
                    td[0] = (int)(doc0 + j);
                    a.tkey[p] = rsel::make_key(sc, doc0 + j, a.n_docs_pad);
                } else {
                    ts[0] = -INFINITY;
                    td[0] = (int)doc0;
                }
            }
            __syncthreads();
            continue;
        }
        // t > 1: between t and 2t best (every match when at most 2t), their
        // least key, then pads
        const unsigned long long lb = c > 2 * t ? tile_bound(lo, t, hi, sh)
                                                : 0ull;
        Key least = ~0ull;
        for (int j0 = 0; j0 < TILE; j0 += THREADS) {
            const int j = j0 + threadIdx.x;
            const unsigned w = lo[j];
            const bool take = w != 0u && local_key(w, j) >= lb;
            const unsigned ballot = __ballot_sync(0xffffffffu, take);
            if (ballot == 0u) continue;
            const int lane = threadIdx.x & 31;
            int pos = 0;
            if (lane == __ffs(ballot) - 1)
                pos = atomicAdd(&sh.cursor, __popc(ballot));
            pos = __shfl_sync(0xffffffffu, pos, __ffs(ballot) - 1) +
                  __popc(ballot & ((1u << lane) - 1u));
            if (take) {
                const float sc = key_score32(w);
                ts[pos] = sc;
                td[pos] = (int)(doc0 + j);
                const Key key = rsel::make_key(sc, doc0 + j, a.n_docs_pad);
                least = key < least ? key : least;
            }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            const Key y = __shfl_xor_sync(0xffffffffu, least, o);
            least = y < least ? y : least;
        }
        if ((threadIdx.x & 31) == 0) sh.ws_k[threadIdx.x >> 5] = least;
        __syncthreads();
        const int kept = sh.cursor;
        if (threadIdx.x == 0) {
            Key m = ~0ull;
            for (int w = 0; w < THREADS / 32; ++w)
                m = sh.ws_k[w] < m ? sh.ws_k[w] : m;
            a.tkey[p] = m;
            a.c_p[p] = c - kept;
        }
        for (int j = kept + threadIdx.x; j < tw; j += THREADS) {
            ts[j] = -INFINITY;
            td[j] = (int)(doc0 + j);
        }
        __syncthreads();
    }
}

// --------------------------------------------------------------------------
// 4. the -inf fill
// --------------------------------------------------------------------------

// grid (rows), SCAN_THREADS: a row with m < k matches gets -inf at the
// k - m lowest-indexed docs that did not match, at positions m..k-1.
__global__ void fill_inf_kernel(Tiles a, float* __restrict__ out_s,
                                int* __restrict__ out_d) {
    __shared__ int ws[33];
    const long long r = blockIdx.x;
    const int k = a.k;
    const int m = a.mcount[r];
    if (m >= k) return;
    const long long words = (k + 31LL) / 32;
    unsigned* bits = a.bitmap + r * words;
    for (long long w = threadIdx.x; w < words; w += blockDim.x) bits[w] = 0u;
    __syncthreads();
    for (int j = threadIdx.x; j < m; j += blockDim.x) {
        const int d = out_d[r * k + j];
        if (d >= 0 && d < k) atomicOr(&bits[d >> 5], 1u << (d & 31));
    }
    __syncthreads();
    const int need = k - m;
    int done = 0;
    for (long long base = 0; base < words && done < need;
         base += blockDim.x) {
        const long long w = base + threadIdx.x;
        unsigned u = 0u;
        if (w < words) {
            u = ~bits[w];
            const long long first = w * 32;
            if (first + 32 > k) u &= (1u << (k - first)) - 1u;
        }
        int total;
        int rank = done + cta_excl_scan<int>(__popc(u), ws, total);
        while (u != 0u && rank < need) {
            const int b = __ffs(u) - 1;
            u &= u - 1u;
            out_s[r * k + m + rank] = -INFINITY;
            out_d[r * k + m + rank] = (int)(w * 32 + b);
            ++rank;
        }
        done += total;
    }
}

// --------------------------------------------------------------------------
// the launchers
// --------------------------------------------------------------------------

// CUDA events between the stages, when ``out`` is set: plan writes
// out[0] (count and scans), run out[1] (pair lists), out[2] (tile pass),
// out[3] (threshold), out[4] (triage and reruns), out[5] (final
// selection and fill).
struct Stages {
    float* out;
    int first;
    cudaStream_t stream;
    cudaEvent_t ev[8];
    int n = 0;
    Stages(float* o, int f, cudaStream_t s) : out(o), first(f), stream(s) {
        if (out == nullptr) return;
        for (int i = 0; i < 8; ++i) cudaEventCreate(&ev[i]);
        cudaEventRecord(ev[n++], stream);
    }
    void mark() {
        if (out != nullptr && n < 8) cudaEventRecord(ev[n++], stream);
    }
    int finish() {
        if (out == nullptr) return 0;
        cudaError_t err = cudaEventSynchronize(ev[n - 1]);
        for (int i = 1; i < n && err == cudaSuccess; ++i)
            err = cudaEventElapsedTime(&out[first + i - 1], ev[i - 1], ev[i]);
        for (int i = 0; i < 8; ++i) cudaEventDestroy(ev[i]);
        return (int)err;
    }
};

// The spanning entries' list capacity of a launch (FeaturePolicy).
template <class P>
long long span_cap(const Tiles& a) {
    return P::RUNS ? (long long)a.sl.groups * a.fb : 0;
}

inline bool valid(const Tiles& a) {
    return a.k >= 1 && a.n_q >= 1 && a.fb >= 0 && a.n_docs_pad >= a.k &&
           a.n_docs_pad <= 0x7fffffffLL && bm25::slots_ok(a.sl) &&
           a.nb >= 1 && (long long)a.sl.groups * a.fb <= INT_MAX &&
           a.rows * a.n_tiles <= INT_MAX &&
           (a.flat_q != nullptr || (a.qb >= 1 && a.fb == a.n_q * a.qb) ||
            a.fb == 0) &&
           (a.mode != bm25::COUNT_SEGS ||
            (a.n_segs >= 1 && a.n_segs <= bm25::MAX_SEGS));
}

// Point the Tiles at scratch A (and B when given).
template <class P>
void bind(Tiles& a, char* ws_a, char* ws_b, long long pairs,
          long long entries, long long fin, int* hits) {
    const LayoutA A = layout_a(a.rows, a.n_tiles, a.k, span_cap<P>(a));
    a.totals = (long long*)(ws_a + A.totals);
    a.queue = (unsigned*)(ws_a + A.queue);
    a.cnt = (int*)(ws_a + A.cnt);
    a.mcount = a.mode == bm25::COUNT_TOTAL ? hits : (int*)(ws_a + A.mcount);
    a.hits = hits;
    a.fcnt = (int*)(ws_a + A.fcnt);
    a.loc_e = (long long*)(ws_a + A.loc_e);
    a.loc_p = (int*)(ws_a + A.loc_p);
    a.row_e = (long long*)(ws_a + A.row_e);
    a.row_p = (long long*)(ws_a + A.row_p);
    a.base_e = (long long*)(ws_a + A.base_e);
    a.base_p = (long long*)(ws_a + A.base_p);
    a.off_tops = (long long*)(ws_a + A.off_tops);
    a.tcnt = (int*)(ws_a + A.tcnt);
    a.off_final = (long long*)(ws_a + A.off_final);
    a.cap_final = (long long*)(ws_a + A.cap_final);
    a.tau_s = (float*)(ws_a + A.tau_s);
    a.tau_d = (int*)(ws_a + A.tau_d);
    a.bitmap = (unsigned*)(ws_a + A.bitmap);
    a.spans = (int*)(ws_a + A.spans);
    if (ws_b == nullptr) return;
    const LayoutB B = layout_b(pairs, entries, fin, a.t, P::RUNS);
    a.pair_rt = (int*)(ws_b + B.pair_rt);
    a.pair_n = (int*)(ws_b + B.pair_n);
    a.pair_e = (long long*)(ws_b + B.pair_e);
    a.c_p = (int*)(ws_b + B.c_p);
    a.tkey = (Key*)(ws_b + B.tkey);
    a.rerun = (int*)(ws_b + B.rerun);
    a.elist = (int*)(ws_b + B.elist);
    a.esub = (unsigned short*)(ws_b + B.esub);
    a.tops_s = (float*)(ws_b + B.tops_s);
    a.tops_d = (int*)(ws_b + B.tops_d);
    a.final_s = (float*)(ws_b + B.final_s);
    a.final_d = (int*)(ws_b + B.final_d);
}

inline bool shortcut(const Tiles& a) { return a.t >= a.k; }

inline unsigned grid_of(long long n, int threads) {
    return (unsigned)((n + threads - 1) / threads);
}

// Phase 1: zero, count, scan, then copy totals[0..2] (pairs, list
// entries, final entries) to ``host`` and wait for them: the caller sizes
// scratch B by layout_b.
template <class P>
int plan(Tiles a, char* ws_a, long long* host, float* split_ms,
         cudaStream_t stream) {
    if (!valid(a)) return (int)cudaErrorInvalidValue;
    bind<P>(a, ws_a, nullptr, 0, 0, 0, a.hits);
    const LayoutA A = layout_a(a.rows, a.n_tiles, a.k, span_cap<P>(a));
    Stages st(split_ms, 0, stream);
    cudaError_t err = cudaMemsetAsync(ws_a, 0, A.zero_end, stream);
    if (err != cudaSuccess) return (int)err;
    if (a.hits != nullptr) {
        const long long nh =
            a.rows * (a.mode == bm25::COUNT_SEGS ? a.n_segs : 1);
        err = cudaMemsetAsync(a.hits, 0, nh * 4, stream);
        if (err != cudaSuccess) return (int)err;
    }
    const long long entries = (long long)a.sl.groups * a.fb;
    if (entries > 0) {
        count_kernel<P><<<grid_of(entries, AUX_THREADS), AUX_THREADS, 0,
                          stream>>>(a);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    scan_rows_kernel<<<(unsigned)a.rows, SCAN_THREADS, 0, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    scan_totals_kernel<<<1, SCAN_THREADS, 0, stream>>>(a, shortcut(a));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    st.mark();
    const int rc = st.finish();
    if (rc != 0) return rc;
    err = cudaMemcpyAsync(host, a.totals, 3 * sizeof(long long),
                          cudaMemcpyDeviceToHost, stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaStreamSynchronize(stream);
}

// lo, hi, the staged doc lengths (Bm25Policy; the segment counts after
// the sums), the staged blocks
template <class P>
size_t tile_smem() {
    return (size_t)TILE * (P::RUNS ? 8 : 12) + (size_t)STAGE * 16;
}

// Persistent CTAs of a tile pass (static: this library's caches, see
// rows_select.cuh).
template <class P, int MODE>
static int launch_tiles(const Tiles& a, long long pairs,
                        cudaStream_t stream) {
    if (pairs == 0) return 0;
    const size_t smem = tile_smem<P>();
    static int per_sm = 0;
    cudaError_t err;
    if (per_sm == 0) {
        err = cudaFuncSetAttribute((const void*)tile_kernel<P, MODE>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, tile_kernel<P, MODE>, THREADS, smem);
        if (err != cudaSuccess) return (int)err;
        if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    }
    long long ctas = (long long)per_sm * rows::n_sms();
    if (ctas > pairs) ctas = pairs;
    tile_kernel<P, MODE><<<(unsigned)ctas, THREADS, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

// Phase 2, after the read-back: the lists, the tile pass, the threshold,
// the reruns, the final selection and the fill, into out_s / out_d
// [rows, k].
template <class P>
int run(Tiles a, char* ws_a, char* ws_b, long long pairs, long long entries,
        long long fin, float* out_s, int* out_d, float* split_ms,
        cudaStream_t stream) {
    if (!valid(a)) return (int)cudaErrorInvalidValue;
    bind<P>(a, ws_a, ws_b, pairs, entries, fin, a.hits);
    const LayoutA A = layout_a(a.rows, a.n_tiles, a.k, span_cap<P>(a));
    Stages st(split_ms, 1, stream);
    cudaError_t err;
    if (pairs > 0) {
        pairs_kernel<<<grid_of(a.rows * a.n_tiles, AUX_THREADS), AUX_THREADS,
                       0, stream>>>(a);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        fill_kernel<P><<<grid_of((long long)a.sl.groups * a.fb, AUX_THREADS),
                         AUX_THREADS, 0, stream>>>(a);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        if (P::RUNS) {
            runs_kernel<<<(unsigned)(rows::n_sms() * 8), AUX_THREADS, 0,
                          stream>>>(a);
            err = cudaGetLastError();
            if (err != cudaSuccess) return (int)err;
        }
    }
    st.mark();
    int rc = launch_tiles<P, 0>(a, pairs, stream);
    if (rc != 0) return rc;
    st.mark();
    rows::Src src{nullptr, 0, a.tops_s, a.tops_d, LLONG_MAX, a.tcnt, nullptr,
                  a.off_tops, nullptr};
    if (!shortcut(a)) {
        rc = rows::select_rows(src, (int)a.rows, a.n_docs_pad, a.k,
                               ws_a + A.st1, ws_a + A.keys1, 1, a.tau_s,
                               a.tau_d, nullptr, stream);
        if (rc != 0) return rc;
        st.mark();
        if (pairs > 0) {
            triage_kernel<<<grid_of(pairs * 32, AUX_THREADS), AUX_THREADS, 0,
                            stream>>>(a);
            err = cudaGetLastError();
            if (err != cudaSuccess) return (int)err;
        }
        rc = launch_tiles<P, 1>(a, pairs, stream);
        if (rc != 0) return rc;
        st.mark();
        src = rows::Src{nullptr, 0, a.final_s, a.final_d, LLONG_MAX, a.fcnt,
                        nullptr, a.off_final, a.cap_final};
    } else {
        st.mark();
        st.mark();
    }
    rc = rows::select_rows(src, (int)a.rows, a.n_docs_pad, a.k, ws_a + A.st2,
                           ws_a + A.keys2, 0, out_s, out_d, nullptr, stream);
    if (rc != 0) return rc;
    fill_inf_kernel<<<(unsigned)a.rows, SCAN_THREADS, 0, stream>>>(a, out_s,
                                                                   out_d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    st.mark();
    return st.finish();
}

// Scratch bytes: which 0 -> A for (rows, n_tiles, entries of the launch)
// at k; which 1 -> B for (pairs, entries, final entries) of ``rows`` rows
// at k over n_docs_pad docs; ``runs``: FeaturePolicy's (the spanning
// entries' list in A, each list entry's run in B).
inline long long scratch_bytes(int which, long long x, long long y,
                               long long z, int k, long long n_docs_pad,
                               long long rows, bool runs) {
    if (which == 0) return layout_a(x, y, k, runs ? z : 0).total;
    return layout_b(x, y, z, tops_for(k, n_docs_pad, rows), runs).total;
}

// launch's answer when scratch B is too small for the lists the plan
// found (host[0..2] then hold their sizes).
constexpr int NEED_MORE = -1;

// The one C entry of every family, on a Tiles whose problem fields are
// set (bm25_launch, features_launch). Phase 0 plans and, when ws_b
// (b_bytes) holds the lists the plan found, runs; else it returns
// NEED_MORE, and the caller allocates scratch B for host[0..2] and calls
// phase 1, which runs with those sizes.
template <class P>
int launch(int phase, Tiles a, void* ws_a, void* ws_b, long long b_bytes,
           long long* host, float* out_s, int* out_d, int* hits,
           float* split_ms, cudaStream_t stream) {
    a.rows = (long long)a.sl.groups * a.n_q;
    a.t = tops_for(a.k, a.n_docs_pad, a.rows);
    a.n_segs = a.mode == bm25::COUNT_SEGS ? a.n_segs : 0;
    a.n_tiles = (a.n_docs_pad + TILE - 1) / TILE;
    a.hits = hits;
    if (phase == 0) {
        const int rc = plan<P>(a, (char*)ws_a, host, split_ms, stream);
        if (rc != 0) return rc;
        if (layout_b(host[0], host[1], host[2], a.t, P::RUNS).total > b_bytes)
            return NEED_MORE;
    }
    return run<P>(a, (char*)ws_a, (char*)ws_b, host[0], host[1], host[2],
                  out_s, out_d, split_ms, stream);
}

// The BM25 families' entry: flatten_plans' flat lists, fb entries a
// group.
template <bool BF16>
int bm25_launch(int phase, const int* block_docs, const void* block_tfs,
                const int* ranges, const void* doc_lens, const int* flat_idx,
                const float* flat_w, const int* flat_q,
                const float* flat_avgdl, const uint8_t* live,
                const int* seg_ids, Slots sl, long long nb, int fb,
                long long n_docs_pad, int n_q, int k, int mode, int n_segs,
                Consts c, void* ws_a, void* ws_b, long long b_bytes,
                long long* host, float* out_s, int* out_d, int* hits,
                float* split_ms, cudaStream_t stream) {
    Tiles a{};
    a.block_docs = block_docs;
    a.block_tfs = block_tfs;
    a.ranges = ranges;
    a.doc_lens = doc_lens;
    a.flat_idx = flat_idx;
    a.flat_w = flat_w;
    a.flat_q = flat_q;
    a.flat_avgdl = flat_avgdl;
    a.live = live;
    a.seg_ids = seg_ids;
    a.sl = sl;
    a.nb = nb;
    a.fb = fb;
    a.n_q = n_q;
    a.k = k;
    a.mode = mode;
    a.n_segs = n_segs;
    a.n_docs_pad = n_docs_pad;
    a.c = c;
    return launch<Bm25Policy<BF16>>(phase, a, ws_a, ws_b, b_bytes, host,
                                    out_s, out_d, hits, split_ms, stream);
}

// The rank_features families' entry: group g's [n_q, qb] block list
// (block ids local to its slot's store) and query weights, row g * n_q + q
// (no per-segment count: mode COUNT_NONE or COUNT_TOTAL).
template <bool BF16>
int features_launch(int phase, const int* block_docs,
                    const void* block_weights, const int* ranges,
                    const int* block_idx, const float* query_weight,
                    const uint8_t* live, Slots sl, long long nb, int qb,
                    long long n_docs_pad, int n_q, int k, int mode,
                    sparse::Params fp, void* ws_a, void* ws_b,
                    long long b_bytes, long long* host, float* out_s,
                    int* out_d, int* hits, float* split_ms,
                    cudaStream_t stream) {
    const long long fb = (long long)n_q * qb;
    if (mode == bm25::COUNT_SEGS || qb < 0 || fb > INT_MAX)
        return (int)cudaErrorInvalidValue;
    Tiles a{};
    a.block_docs = block_docs;
    a.block_tfs = block_weights;
    a.ranges = ranges;
    a.flat_idx = block_idx;
    a.flat_w = query_weight;
    a.live = live;
    a.sl = sl;
    a.nb = nb;
    a.qb = qb;
    a.fb = (int)fb;
    a.n_q = n_q;
    a.k = k;
    a.mode = mode;
    a.n_docs_pad = n_docs_pad;
    a.fp = fp;
    return launch<FeaturePolicy<BF16>>(phase, a, ws_a, ws_b, b_bytes, host,
                                       out_s, out_d, hits, split_ms, stream);
}

// --------------------------------------------------------------------------
// 5. the dense row (bm25_scores K8, sparse_scores K19)
// --------------------------------------------------------------------------
//
// One query's [n_docs_pad] f32 row over one store (ONE_SLOT, row 0): a
// doc's score is f32(the 64-bit fixed-point sum of its postings'
// contributions), 0 where no posting lands or the doc is dead. Every tile
// of the row is a pair, so the pairs are known before the launch; the
// lists are sized by a bound known before it too: an entry within one
// tile is listed once, an entry whose block spans tiles once in each tile
// holding one of its docs (at most min(BLOCK, n_tiles) tiles), so
// qb * min(BLOCK, n_tiles) list entries always hold them (``dense_cap``).
// A call is three stream-ordered operations with no synchronisation: a
// memset of the counts, the binning (one cooperative launch:
// dense_bin_kernel) and the tile pass. A spanning block is
// listed with the run of its positions in each tile (docs that ascend) or
// whole in each (docs out of order, totals[6] counting the postings read
// beyond one pass); Bm25Policy reads every listed block whole, as K1
// does, FeaturePolicy only its run. The tile pass sums a tile's lists as
// section 2 does, then writes the tile once: no memset of the row, no
// int64 row and no global 64-bit atomic; a tile no block reaches writes
// zeros without touching shared memory.

inline long long dense_tiles(long long n_docs_pad) {
    return (n_docs_pad + TILE - 1) / TILE;
}

inline long long dense_cap(long long qb, long long n_docs_pad) {
    const long long t = dense_tiles(n_docs_pad);
    return qb * (t < bm25::BLOCK ? t : bm25::BLOCK);
}

// Scratch of a dense call: [0, zero_end) is zeroed by its memset.
struct LayoutD {
    long long totals, barrier, cnt, zero_end, pair_n, pair_e, spans, elist,
        esub, total;
};

inline LayoutD layout_d(long long qb, long long n_docs_pad, bool runs) {
    LayoutD L{};
    long long off = 0;
    auto take = [&](long long bytes) {
        const long long at = off;
        off += up256(bytes);
        return at;
    };
    const long long n_tiles = dense_tiles(n_docs_pad);
    const long long cap = dense_cap(qb, n_docs_pad);
    L.totals = take(N_TOTALS * 8);
    L.barrier = take(4);
    L.cnt = take(n_tiles * 4);
    L.zero_end = off;
    L.pair_n = take(n_tiles * 4);
    L.pair_e = take(n_tiles * 8);
    L.spans = take(qb * 4);
    L.elist = take(cap * 4);
    L.esub = take(runs ? cap * 2 : 0);
    L.total = off;
    return L;
}

inline long long dense_bytes(long long qb, long long n_docs_pad, bool runs) {
    return layout_d(qb, n_docs_pad, runs).total;
}

// The tiles holding the docs of entry f's block, each visited once, from
// one lane, as visit(tile, p0, p1) with the run of block positions the
// tile pass reads there. Docs that ascend (each valid doc at or above the
// valid docs before it): a tile's run goes from its first doc's position
// to the next tile's first (the last tile's to BLOCK), so the runs
// partition the block from its first valid doc; docs out of order: every
// tile reads the whole block. Every lane of the warp calls it; it returns
// the tiles visited and sets ``ascending``.
template <class V>
__device__ int doc_tiles(const Tiles& a, long long f, bool& ascending,
                         V visit) {
    const int lane = threadIdx.x & 31;
    const int4 v = ((const int4*)(a.block_docs + (long long)a.flat_idx[f] *
                                                     bm25::BLOCK))[lane];
    const int d[4] = {v.x, v.y, v.z, v.w};
    auto tile_of = [&](int doc) {
        const long long t = (long long)doc >> TILE_SHIFT;
        return (int)(t < a.n_tiles ? t : a.n_tiles - 1);
    };
    // the largest valid doc before each position
    int before = -1;
#pragma unroll
    for (int u = 0; u < 4; ++u) before = d[u] > before ? d[u] : before;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, before, o);
        if (lane >= o) before = y > before ? y : before;
    }
    before = __shfl_up_sync(0xffffffffu, before, 1);
    if (lane == 0) before = -1;
    bool asc = true, start[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
        start[u] = false;
        if (d[u] >= 0) {
            asc = asc && d[u] >= before;
            start[u] = before < 0 || tile_of(d[u]) > tile_of(before);
            before = d[u] > before ? d[u] : before;
        }
    }
    ascending = __all_sync(0xffffffffu, asc);
    if (ascending) {
        // a start's run ends at the next start: this lane's, or the first
        // of a later lane's
        int first = bm25::BLOCK, mine = 0;
#pragma unroll
        for (int u = 3; u >= 0; --u)
            if (start[u]) {
                first = 4 * lane + u;
                ++mine;
            }
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_down_sync(0xffffffffu, first, o);
            first = y < first ? y : first;
        }
        int next = __shfl_down_sync(0xffffffffu, first, 1);
        if (lane == 31) next = bm25::BLOCK;
#pragma unroll
        for (int u = 3; u >= 0; --u)
            if (start[u]) {
                visit((long long)tile_of(d[u]), 4 * lane + u, next);
                next = 4 * lane + u;
            }
        return __reduce_add_sync(0xffffffffu, (unsigned)mine);
    }
    // out of order: each distinct tile once, the lowest lane's first
    bool left[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) left[u] = d[u] >= 0;
    int n = 0;
    for (;;) {
        int offer = -1;
#pragma unroll
        for (int u = 0; u < 4; ++u)
            if (left[u] && offer < 0) offer = tile_of(d[u]);
        const unsigned any = __ballot_sync(0xffffffffu, offer >= 0);
        if (any == 0u) break;
        const int tile = __shfl_sync(0xffffffffu, offer, __ffs(any) - 1);
#pragma unroll
        for (int u = 0; u < 4; ++u)
            if (left[u] && tile_of(d[u]) == tile) left[u] = false;
        if (lane == 0) visit((long long)tile, 0, bm25::BLOCK);
        ++n;
    }
    return n;
}

// The dense binning in one cooperative launch of AUX_THREADS CTAs (every
// CTA resident, so the grid barriers between its steps are safe; the
// launch fails rather than hangs when they cannot all be; the barrier
// counter is the zeroed ``queue``):
// 1. count_entry over the entries: those within one tile into cnt, those
//    spanning tiles into ``spans`` (totals[7]);
// 2. a warp at a time, each spanning entry's listings into cnt
//    (``doc_tiles``; FeaturePolicy: a block out of order adds the postings
//    it reads beyond one pass to totals[6]);
// 3. CTA 0 scans the tiles: pair_n each tile's listings, pair_e where its
//    list starts (cnt stays the lists' cursor), totals[0] the tiles
//    reached, totals[1] the listings;
// 4. every entry into the list of each tile it is listed in (cnt counts
//    down to 0; one atomic a group of lanes for entries within one tile).
//    A listing at or past ``cap`` is refused and counted in totals[5]
//    (none: dense_cap bounds them).
template <class P>
__global__ void dense_bin_kernel(Tiles a) {
    __shared__ long long ws_e[33];
    __shared__ int ws_p[33];
    unsigned target = 0;
    const int lane = threadIdx.x & 31;
    const long long threads = (long long)gridDim.x * blockDim.x;
    const long long warps = threads >> 5;
    const long long warp0 =
        ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    for (long long f0 = (long long)blockIdx.x * blockDim.x; f0 < a.fb;
         f0 += threads)
        count_entry<P, true>(a, f0 + threadIdx.x);
    rsel::grid_sync(a.queue, target);
    const long long n_spans = __ldcg(&a.totals[7]);
    for (long long w = warp0; w < n_spans; w += warps) {
        bool asc;
        const int listed = doc_tiles(
            a, a.spans[w], asc,
            [&](long long tile, int, int) { atomicAdd(&a.cnt[tile], 1); });
        if (P::RUNS && !asc && lane == 0)
            atomicAdd((unsigned long long*)&a.totals[6],
                      (unsigned long long)(listed - 1) * bm25::BLOCK);
    }
    rsel::grid_sync(a.queue, target);
    if (blockIdx.x == 0) {
        long long run_e = 0;
        int run_p = 0;
        for (long long base = 0; base < a.n_tiles; base += blockDim.x) {
            const long long i = base + threadIdx.x;
            const int v = i < a.n_tiles ? __ldcg(&a.cnt[i]) : 0;
            long long te;
            int tp;
            const long long xe = cta_excl_scan<long long>(v, ws_e, te);
            cta_excl_scan<int>(v > 0, ws_p, tp);
            if (i < a.n_tiles) {
                a.pair_n[i] = v;
                a.pair_e[i] = run_e + xe;
            }
            run_e += te;
            run_p += tp;
        }
        if (threadIdx.x == 0) {
            a.totals[0] = run_p;
            a.totals[1] = run_e;
        }
    }
    rsel::grid_sync(a.queue, target);
    auto put = [&](long long at, int f, int p0, int p1) {
        if (at < a.cap) {
            a.elist[at] = f;
            if (P::RUNS) a.esub[at] = (unsigned short)(p0 | (p1 << 8));
        } else {
            atomicAdd((unsigned long long*)&a.totals[5], 1ull);
        }
    };
    for (long long f0 = (long long)blockIdx.x * blockDim.x; f0 < a.fb;
         f0 += threads) {
        const long long f = f0 + threadIdx.x;
        long long r = 0, lo = 0, hi = -1;
        const bool ok = f < a.fb && entry_span(a, f, r, lo, hi);
        const bool single = ok && lo == hi;
        const unsigned grp = tile_group(single, lo);
        if (single) {
            const int leader = __ffs(grp) - 1;
            int end = 0;
            if (lane == leader) end = atomicSub(&a.cnt[lo], __popc(grp));
            end = __shfl_sync(grp, end, leader);
            put(__ldcg(&a.pair_e[lo]) + end - __popc(grp) +
                    __popc(grp & ((1u << lane) - 1u)),
                (int)f, 0, bm25::BLOCK);
        }
    }
    for (long long w = warp0; w < n_spans; w += warps) {
        const int f = a.spans[w];
        bool asc;
        doc_tiles(a, f, asc, [&](long long tile, int p0, int p1) {
            put(__ldcg(&a.pair_e[tile]) + atomicSub(&a.cnt[tile], 1) - 1, f,
                p0, p1);
        });
    }
}

// grid (n_tiles): a tile's sums (section 2's, by the policy), masked by
// live and written once as f32; a tile no block reaches writes zeros.
template <class P>
__global__ void __launch_bounds__(THREADS, P::CTAS)
    dense_tile_kernel(Tiles a) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned* lo = (unsigned*)smem_raw;
    unsigned* hi = lo + TILE;
    float* s_dl = (float*)(hi + TILE);   // Bm25Policy only
    long long* s_blk = (long long*)(s_dl + (P::RUNS ? 0 : TILE));
    float* s_w = (float*)(s_blk + STAGE);
    float* s_avg = s_w + STAGE;
    const long long tile = blockIdx.x;
    const long long doc0 = tile * TILE;
    const int n = (int)(a.n_docs_pad - doc0 < TILE ? a.n_docs_pad - doc0
                                                   : TILE);
    const int n4 = n >> 2;
    float* out = a.row + doc0;
    if (a.pair_n[tile] == 0) {
        for (int q = threadIdx.x; q < n4; q += THREADS)
            ((float4*)out)[q] = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int j = 4 * n4 + threadIdx.x; j < n; j += THREADS) out[j] = 0.f;
        return;
    }
    sum_pair<P>(a, tile, 0, doc0, n, lo, hi, s_dl, s_blk, s_w, s_avg);
    const uint8_t* live = a.live != nullptr ? a.live + doc0 : nullptr;
    auto score = [&](int j, unsigned l, unsigned h) {
        return live == nullptr || live[j]
                   ? bm25::from_fixed(
                         (long long)(((unsigned long long)h << 32) | l))
                   : 0.f;
    };
    for (int q = threadIdx.x; q < n4; q += THREADS) {
        const uint4 l = ((const uint4*)lo)[q];
        const uint4 h = ((const uint4*)hi)[q];
        const int j = 4 * q;
        ((float4*)out)[q] = make_float4(score(j, l.x, h.x),
                                        score(j + 1, l.y, h.y),
                                        score(j + 2, l.z, h.z),
                                        score(j + 3, l.w, h.w));
    }
    for (int j = 4 * n4 + threadIdx.x; j < n; j += THREADS)
        out[j] = score(j, lo[j], hi[j]);
}

// The dense row's C entry body, on a Tiles whose problem fields are set
// (block_docs, block_tfs, ranges, flat_idx, flat_w, live, nb, qb,
// n_docs_pad; Bm25Policy: doc_lens, avg, c; FeaturePolicy: fp): ``ws``
// holds dense_bytes, ``out`` the [n_docs_pad] row. host[0] receives the
// operations issued; split_ms, when set, the stages' event ms (binning:
// the memset and dense_bin_kernel; tiles), after waiting for them.
template <class P>
static int dense_run(Tiles a, void* ws, float* out, long long* host,
                     float* split_ms, cudaStream_t stream) {
    if (a.qb < 0 || a.nb < 1 || a.n_docs_pad < 1 ||
        a.n_docs_pad > 0x7fffffffLL ||
        dense_cap(a.qb, a.n_docs_pad) > INT_MAX)
        return (int)cudaErrorInvalidValue;
    a.sl = bm25::ONE_SLOT;
    a.n_q = 1;
    a.fb = a.qb;
    a.flat_q = nullptr;
    a.rows = 1;
    a.n_tiles = dense_tiles(a.n_docs_pad);
    a.row = out;
    a.cap = dense_cap(a.qb, a.n_docs_pad);
    const LayoutD L = layout_d(a.qb, a.n_docs_pad, P::RUNS);
    char* w = (char*)ws;
    a.totals = (long long*)(w + L.totals);
    a.queue = (unsigned*)(w + L.barrier);   // dense_bin_kernel's barrier
    a.cnt = (int*)(w + L.cnt);
    a.pair_n = (int*)(w + L.pair_n);
    a.pair_e = (long long*)(w + L.pair_e);
    a.spans = (int*)(w + L.spans);
    a.elist = (int*)(w + L.elist);
    a.esub = (unsigned short*)(w + L.esub);
    Stages st(split_ms, 0, stream);
    cudaError_t err = cudaMemsetAsync(ws, 0, L.zero_end, stream);
    if (err != cudaSuccess) return (int)err;
    static int bin_per_sm = 0;
    if (bin_per_sm == 0) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &bin_per_sm, dense_bin_kernel<P>, AUX_THREADS, 0);
        if (err != cudaSuccess) return (int)err;
        if (bin_per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    }
    // a warp an entry at most (the spanning entries' step), every CTA
    // resident
    long long ctas = (a.qb + AUX_THREADS / 32 - 1) / (AUX_THREADS / 32);
    if (ctas > (long long)bin_per_sm * rows::n_sms())
        ctas = (long long)bin_per_sm * rows::n_sms();
    if (ctas < 1) ctas = 1;
    void* args[] = {(void*)&a};
    err = cudaLaunchCooperativeKernel((const void*)dense_bin_kernel<P>,
                                      dim3((unsigned)ctas),
                                      dim3(AUX_THREADS), args, 0, stream);
    if (err != cudaSuccess) return (int)err;
    st.mark();
    const size_t smem = tile_smem<P>();
    static bool smem_set = false;
    if (!smem_set) {
        err = cudaFuncSetAttribute((const void*)dense_tile_kernel<P>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        smem_set = true;
    }
    dense_tile_kernel<P><<<(unsigned)a.n_tiles, THREADS, smem, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    st.mark();
    if (host != nullptr) host[0] = 3;   // the memset, the binning, the tiles
    return st.finish();
}

}  // namespace tiles
