// The streaming scores pass: knn_scores (K9, one query's dense row) and,
// through sharded_scores.cuh, the scores of the sharded data plane's
// sharded_knn (row 40) and sharded_hybrid (row 44). knn_flat and
// knn_coarse score on the tensor cores instead (knn_tc.cuh).
//
// What it computes: for every slot s, query q and doc d of the slot's
// [N_pad, D] f32 matrix, cell[s, q, d] = mask[s, d] ? similarity(dot) :
// (DENSE ? 0 : -inf), dot = sum over k = 0 .. D-1 of query[q, k] *
// matrix[s, d, k] added in that order, one rounding at a time:
// knn_common.cuh section 2 (bf16 operands, an FMA per product, exact) or,
// under F32 (the sharded l2_norm), f32 operands with each product rounded
// before it is added (__fmul_rn then __fadd_rn). The transform is
// knn_common.cuh section 1 (F32: norm * norm + q2 as a product then an
// add). A cell's bits depend on nothing else: not the batch, not the tile.
//
// What bounds it: memory. The matrix is read once (N_pad * D * 4 bytes a
// slot) and the arithmetic is half an operation a byte at one query.
//
// The design. Persistent CTAs, one a SM (a three-stage ring of 64 KB
// stages and 16 KB of queries), walk the work items (slot, doc tile of TD
// rows, query group of QB) in a static stride, query groups of one tile
// adjacent so that their reads of it meet in L2. One producer streams
// each tile into the ring, DC dims at a time (a "step"; D <= 64 is one
// step, the tile's whole contiguous span of the row-major matrix):
//   - 16-byte rows of at least 32 dims (D % 4 == 0, an aligned base): one
//     thread's TMA copies of a 2-D tensor map over the [S * N_pad, D]
//     matrix, a box of 32 dims x TD rows a "slab" (two a full step), with
//     the 128-byte swizzle: row r's 16-byte chunk q of a slab lies at
//     r * 128 + 16 * (q ^ (r % 8)), so a warp's reads of one chunk of 32
//     consecutive rows fall on 8 different 16-byte bank groups in each
//     quarter-warp (unswizzled, rows 128 bytes apart put 8 reads on one).
//     Rows and dims past the matrix read as zeros (a ragged last tile);
//   - any other D or base: the producer warp's cp.async of 4-byte values
//     into rows RS floats apart (the step's dims rounded up to 4, then to
//     an odd number of 16-byte chunks: conflict-free the same way), the
//     lanes' cp.async.mbarrier.arrive completing the stage.
// The 256 consumer threads (two warps a scheduler, so that one's adds
// cover the other's waits) each own one doc of the tile and QB sums, read
// its row 16 bytes at a time, round at the read, and add in dimension
// order while the copies of the next stages are in flight. A warp
// releases the stage (its empty barrier) once its lanes have read it: for
// a whole swizzled step each thread first takes its row into registers,
// so the stage refills while the thread adds. A batch of at most 16
// queries and 4,096 values is rounded into shared memory once a CTA; a
// doc's mask and norm are loaded before its sums, so the epilogue does
// not wait on memory. Both sides walk the same items and steps, so stage
// and parity advance in step without any other exchange.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "knn_common.cuh"

namespace kstream {

using knn::bfr;
using knn::similarity;

constexpr int CONSUMERS = 256;            // a thread a doc of the tile
constexpr int THREADS = CONSUMERS + 32;   // + the producer warp
constexpr int TD = CONSUMERS;             // docs a tile
constexpr int DC = 64;                    // dims a step at most
constexpr int SLAB = 32;                  // dims a TMA box (128 bytes)
constexpr int STAGES = 3;
constexpr int QCACHE = 4096;              // floats of rounded queries kept

// The padded row stride (floats) of a cp.async step of at most dc dims.
__host__ __device__ constexpr int row_stride(int dc) {
    return ((dc + 3) / 4) % 2 == 0 ? (dc + 3) / 4 * 4 + 4 : (dc + 3) / 4 * 4;
}

constexpr size_t ALIGN_SLACK = 1024;      // the swizzle wants 1 KB bases
constexpr size_t BARRIER_BYTES = 2 * STAGES * 8;
constexpr size_t MAX_STAGE =
    ((size_t)TD * row_stride(DC) * 4 + 1023) / 1024 * 1024;
constexpr size_t MAX_SMEM =
    STAGES * MAX_STAGE + QCACHE * 4 + ALIGN_SLACK + BARRIER_BYTES;

struct Args {
    const float* matrix;    // [S, N_pad, D]
    const float* norms;     // [S, N_pad]
    const uint8_t* mask;    // [S, N_pad]
    const float* queries;   // [n_q, D]
    const float* qn;        // [n_q]
    const float* q2;        // [n_q]
    float* out;             // [S, n_q, N_pad]
    long long n_docs_pad, tiles, items;
    int dims, n_q, groups, steps, sim;
    int tma;                // swizzled TMA slabs; else cp.async rows
    int rs;                 // cp.async: the row stride (floats)
    int stage_bytes;
    int qcache;             // one query group, QB * D <= QCACHE: rounded
                            // once into shared memory
};

// acc[q] += query row min(q, qmax) . m over dims k .. k+3 (add4) or k
// (add1) of the step, in dimension order; qp: the group's first query
// row at the step's first dim. Rows past the batch repeat its last row
// (their sums are never written).
template <int QB, bool F32>
__device__ __forceinline__ void add4(float (&acc)[QB], const float4 m,
                                     const float* __restrict__ qp, int ld,
                                     int qmax, int k) {
#pragma unroll
    for (int q = 0; q < QB; ++q) {
        const float* row = qp + (long long)min(q, qmax) * ld + k;
        const float4 v = ((uintptr_t)row & 15) != 0
                             ? make_float4(__ldg(row), __ldg(row + 1),
                                           __ldg(row + 2), __ldg(row + 3))
                             : __ldg((const float4*)row);
        if (F32) {
            acc[q] = __fadd_rn(acc[q], __fmul_rn(v.x, m.x));
            acc[q] = __fadd_rn(acc[q], __fmul_rn(v.y, m.y));
            acc[q] = __fadd_rn(acc[q], __fmul_rn(v.z, m.z));
            acc[q] = __fadd_rn(acc[q], __fmul_rn(v.w, m.w));
        } else {
            acc[q] = __fmaf_rn(bfr(v.x), m.x, acc[q]);
            acc[q] = __fmaf_rn(bfr(v.y), m.y, acc[q]);
            acc[q] = __fmaf_rn(bfr(v.z), m.z, acc[q]);
            acc[q] = __fmaf_rn(bfr(v.w), m.w, acc[q]);
        }
    }
}

// add4 with the group's queries already rounded in shared memory (qs: row
// q at q * ld, the step's first dim).
template <int QB, bool F32>
__device__ __forceinline__ void add4s(float (&acc)[QB], const float4 m,
                                      const float* qs, int ld, int qmax,
                                      int k) {
#pragma unroll
    for (int q = 0; q < QB; ++q) {
        const float4 v = *(const float4*)(qs + min(q, qmax) * ld + k);
        if (F32) {
            acc[q] = __fadd_rn(acc[q], __fmul_rn(v.x, m.x));
            acc[q] = __fadd_rn(acc[q], __fmul_rn(v.y, m.y));
            acc[q] = __fadd_rn(acc[q], __fmul_rn(v.z, m.z));
            acc[q] = __fadd_rn(acc[q], __fmul_rn(v.w, m.w));
        } else {
            acc[q] = __fmaf_rn(v.x, m.x, acc[q]);
            acc[q] = __fmaf_rn(v.y, m.y, acc[q]);
            acc[q] = __fmaf_rn(v.z, m.z, acc[q]);
            acc[q] = __fmaf_rn(v.w, m.w, acc[q]);
        }
    }
}

template <int QB, bool F32>
__device__ __forceinline__ void add1(float (&acc)[QB], float m,
                                     const float* __restrict__ qp, int ld,
                                     int qmax, int k) {
#pragma unroll
    for (int q = 0; q < QB; ++q) {
        const float v = __ldg(qp + (long long)min(q, qmax) * ld + k);
        acc[q] = F32 ? __fadd_rn(acc[q], __fmul_rn(v, m))
                     : __fmaf_rn(bfr(v), m, acc[q]);
    }
}

template <bool F32>
__device__ __forceinline__ float4 rounded(float4 m) {
    return F32 ? m : make_float4(bfr(m.x), bfr(m.y), bfr(m.z), bfr(m.w));
}

// Row t's 16-byte chunk c (dims 4c .. 4c+3 of the step) in a swizzled
// stage.
__device__ __forceinline__ const float4* chunk_of(const unsigned char* st,
                                                  int t, int c) {
    return (const float4*)(st + (c >> 3) * (TD * 128) + t * 128 +
                           16 * ((c & 7) ^ (t & 7)));
}

template <int QB, bool DENSE, bool F32>
__global__ void __launch_bounds__(THREADS, 1)
    stream_kernel(const Args a, const __grid_constant__ CUtensorMap map) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned char* smem =
        smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
    float* qcache = (float*)(smem + STAGES * a.stage_bytes);
    const uint32_t bar0 =
        hopper::smem_addr(smem + STAGES * a.stage_bytes + QCACHE * 4);
    auto full = [&](int s) { return bar0 + 8 * s; };
    auto empty = [&](int s) { return bar0 + 8 * (STAGES + s); };
    const int t = threadIdx.x, lane = t & 31;
    if (t == 0) {
        for (int s = 0; s < STAGES; ++s) {
            hopper::mbar_init(full(s), a.tma ? 1 : 32);
            hopper::mbar_init(empty(s), CONSUMERS / 32);
        }
        hopper::mbar_init_fence();
    }
    __syncthreads();
    int stage = 0;
    uint32_t phase = 0;
    auto advance = [&]() {
        if (++stage == STAGES) {
            stage = 0;
            phase ^= 1u;
        }
    };

    if (t >= CONSUMERS) {                          // the producer warp
        if (a.tma && lane != 0) return;
        for (long long it = blockIdx.x; it < a.items; it += gridDim.x) {
            const long long st = it / a.groups;    // slot * tiles + tile
            const long long slot = st / a.tiles, tile = st % a.tiles;
            const long long doc0 = tile * TD;
            const long long row0 = slot * a.n_docs_pad + doc0;
            const int rows = (int)min((long long)TD, a.n_docs_pad - doc0);
            for (int step = 0; step < a.steps; ++step) {
                const int d0 = step * DC, dn = min(DC, a.dims - d0);
                hopper::mbar_wait(empty(stage), phase ^ 1u);
                unsigned char* dst = smem + stage * a.stage_bytes;
                if (a.tma) {
                    const int slabs = (dn + SLAB - 1) / SLAB;
                    hopper::mbar_expect_tx(full(stage),
                                           (uint32_t)(slabs * TD * 128));
                    for (int sl = 0; sl < slabs; ++sl)
                        hopper::tma_load_2d(
                            hopper::smem_addr(dst + sl * TD * 128), &map,
                            d0 + SLAB * sl, (int)row0, full(stage));
                } else {
                    const float* src = a.matrix + row0 * a.dims + d0;
                    for (int e = lane; e < rows * dn; e += 32) {
                        const int r = e / dn, c = e % dn;
                        hopper::cp_async4(
                            hopper::smem_addr((float*)dst +
                                              (size_t)r * a.rs + c),
                            src + (long long)r * a.dims + c);
                    }
                    hopper::cp_async_mbar_arrive(full(stage));
                }
                advance();
            }
        }
        return;
    }

    if (a.qcache) {         // the one group's queries, rounded once
        for (int i = t; i < a.n_q * a.dims; i += CONSUMERS)
            qcache[i] = F32 ? a.queries[i] : bfr(a.queries[i]);
        asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
    }
    for (long long it = blockIdx.x; it < a.items; it += gridDim.x) {
        const long long st = it / a.groups;
        const int group = (int)(it % a.groups);
        const long long slot = st / a.tiles, tile = st % a.tiles;
        const long long doc = tile * TD + t;
        const bool mine = doc < a.n_docs_pad;
        const int qmax = a.n_q - 1 - group * QB;
        // the epilogue's operands, loaded before the sums so that their
        // latency hides behind them
        const long long cell0 = slot * a.n_docs_pad + doc;
        const bool ok = mine && a.mask[cell0] != 0;
        const float norm = mine ? a.norms[cell0] : 0.f;
        float acc[QB];
#pragma unroll
        for (int q = 0; q < QB; ++q) acc[q] = 0.f;
        for (int step = 0; step < a.steps; ++step) {
            const int d0 = step * DC, dn = min(DC, a.dims - d0);
            hopper::mbar_wait(full(stage), phase);
            const unsigned char* sb = smem + stage * a.stage_bytes;
            const float* qp =
                a.queries + (long long)group * QB * a.dims + d0;
            if (a.tma && dn == DC) {
                // a whole step: the row into registers, the stage released
                // at once, then the sums while the next copies land
                float4 buf[DC / 4];
                if (mine) {
#pragma unroll
                    for (int c = 0; c < DC / 4; ++c)
                        buf[c] = *chunk_of(sb, t, c);
                }
                __syncwarp();
                if (lane == 0) hopper::mbar_arrive(empty(stage));
                if (mine && a.qcache) {
#pragma unroll
                    for (int c = 0; c < DC / 4; ++c)
                        add4s<QB, F32>(acc, rounded<F32>(buf[c]),
                                       qcache + d0, a.dims, qmax, 4 * c);
                } else if (mine) {
#pragma unroll
                    for (int c = 0; c < DC / 4; ++c)
                        add4<QB, F32>(acc, rounded<F32>(buf[c]), qp, a.dims,
                                      qmax, 4 * c);
                }
            } else {
                if (mine && a.tma) {
                    for (int c = 0; c < dn / 4; ++c)
                        add4<QB, F32>(acc, rounded<F32>(*chunk_of(sb, t, c)),
                                      qp, a.dims, qmax, 4 * c);
                } else if (mine) {
                    const float* row = (const float*)sb + (size_t)t * a.rs;
                    for (int k = 0; k < dn; ++k)
                        add1<QB, F32>(acc, F32 ? row[k] : bfr(row[k]), qp,
                                      a.dims, qmax, k);
                }
                __syncwarp();
                if (lane == 0) hopper::mbar_arrive(empty(stage));
            }
            advance();
        }
        if (!mine) continue;
#pragma unroll
        for (int q = 0; q < QB; ++q) {
            const int qi = group * QB + q;
            if (qi >= a.n_q) break;
            const float s = ok ? similarity(acc[q], norm, a.qn[qi], a.q2[qi],
                                            a.sim, !F32)
                               : (DENSE ? 0.f : -INFINITY);
            a.out[(slot * a.n_q + qi) * a.n_docs_pad + doc] = s;
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

// The driver's cuTensorMapEncodeTiled (through the runtime, so nothing
// links against libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static EncodeTiled encoder() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                    cudaEnableDefault, &found) ==
                cudaSuccess &&
            found == cudaDriverEntryPointSuccess)
            fn = (EncodeTiled)p;
    }
    return fn;
}

// The [rows, dims] f32 matrix as boxes of 32 dims x TD rows, 128-byte
// swizzle.
static int encode_map(CUtensorMap* map, const float* matrix, long long rows,
                      int dims) {
    const EncodeTiled fn = encoder();
    if (fn == nullptr) return (int)cudaErrorNotSupported;
    const cuuint64_t size[2] = {(cuuint64_t)dims, (cuuint64_t)rows};
    const cuuint64_t stride[1] = {(cuuint64_t)dims * 4};
    const cuuint32_t box[2] = {SLAB, TD};
    const cuuint32_t step[2] = {1, 1};
    const CUresult rc = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                           (void*)matrix, size, stride, box, step,
                           CU_TENSOR_MAP_INTERLEAVE_NONE,
                           CU_TENSOR_MAP_SWIZZLE_128B,
                           CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// One launch of the pass (static: each library's own attribute and
// occupancy caches, see rows_select.cuh).
template <int QB, bool DENSE, bool F32>
static int launch(const Args& a, const CUtensorMap& map,
                  cudaStream_t stream) {
    static bool attr = false;
    static size_t last_smem = 0;
    static int per_sm = 0;
    const void* fn = (const void*)stream_kernel<QB, DENSE, F32>;
    cudaError_t err;
    if (!attr) {
        err = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
        if (err != cudaSuccess) return (int)err;
        attr = true;
    }
    const size_t smem = (size_t)STAGES * a.stage_bytes + QCACHE * 4 +
                        ALIGN_SLACK + BARRIER_BYTES;
    if (smem != last_smem) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                            THREADS, smem);
        if (err != cudaSuccess) return (int)err;
        if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
        last_smem = smem;
    }
    long long ctas = (long long)per_sm * n_sms();
    if (ctas > a.items) ctas = a.items;
    stream_kernel<QB, DENSE, F32>
        <<<(unsigned)ctas, THREADS, smem, stream>>>(a, map);
    return (int)cudaGetLastError();
}

// The pass over n_slots stacked planes for n_q queries, at the widest
// query group (QB) the batch fills: out [n_slots, n_q, n_docs_pad].
template <bool DENSE, bool F32 = false>
int scores(const float* matrix, const float* norms, const uint8_t* mask,
           const float* queries, const float* qn, const float* q2, int n_q,
           int dims, long long n_docs_pad, int sim, float* out,
           cudaStream_t stream, int n_slots = 1) {
    if (n_slots < 1 || n_q < 1 || dims < 1 || dims > knn::MAX_DIMS ||
        n_docs_pad < 1 || (long long)n_slots * n_docs_pad > INT_MAX ||
        !knn::valid_sim(sim))
        return (int)cudaErrorInvalidValue;
    Args a{matrix, norms, mask, queries, qn, q2, out};
    a.n_docs_pad = n_docs_pad;
    a.tiles = (n_docs_pad + TD - 1) / TD;
    a.dims = dims;
    a.n_q = n_q;
    a.steps = (dims + DC - 1) / DC;
    a.sim = sim;
    a.tma = dims % 4 == 0 && dims >= SLAB && ((uintptr_t)matrix & 15) == 0;
    const int dc = dims < DC ? dims : DC;
    a.rs = row_stride(dc);
    a.stage_bytes = a.tma ? (dc + SLAB - 1) / SLAB * TD * 128
                          : TD * a.rs * 4;
    a.stage_bytes = (a.stage_bytes + 1023) / 1024 * 1024;
    a.qcache = n_q <= 16 && n_q * dims <= QCACHE;
    CUtensorMap map = {};
    if (a.tma) {
        const int rc = encode_map(&map, matrix,
                                  (long long)n_slots * n_docs_pad, dims);
        if (rc != 0) return rc;
    }
#define KSTREAM(QB)                                                \
    (a.groups = (n_q + QB - 1) / QB,                               \
     a.items = (long long)n_slots * a.tiles * a.groups,            \
     launch<QB, DENSE, F32>(a, map, stream))
    if (n_q >= 16) return KSTREAM(16);
    if (n_q > 4) return KSTREAM(8);
    if (n_q > 2) return KSTREAM(4);
    if (n_q == 2) return KSTREAM(2);
    return KSTREAM(1);
#undef KSTREAM
}

}  // namespace kstream
