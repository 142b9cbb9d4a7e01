// Hopper (sm_90a) building blocks for a tensor-core kernel written by
// hand: mbarriers, TMA bulk copies and cp.async into shared memory, the
// shared-memory matrix descriptor of the 128-byte swizzle, and wgmma
// (bf16 with f32 sums, int8 with int32 sums).
//
// Operand layout (what tile_swizzled in ivf_assign.cu writes and the
// descriptor below reads): a tile of R rows x 64 bf16 values (128 bytes a
// row), K-major, row r's 16-byte chunk q at byte r * 128 + 16 * (q ^ (r %
// 8)) -- the layout TMA's CU_TENSOR_MAP_SWIZZLE_128B gives a box of 64 x
// R -- based at a 1024-byte boundary. wgmma reads 8-row groups 1024 bytes
// apart (SBO); the k-th step of 16 values starts 32 * k bytes in, and the
// hardware applies the swizzle to the address bits.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
                 "r"(count)
                 : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
                 : "memory");
}

// Arrive and announce ``bytes`` of TMA traffic that completes the phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                     "r"(bar),
                 "r"(bytes)
                 : "memory");
}

// Wait until the phase of parity ``parity`` has completed (the parity of
// the phase before the first one counts as completed). A wait that never
// ends (a fault in the pipeline) traps after 2^28 polls, seconds at least,
// so the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t ok = 0;
    for (uint32_t polls = 0; !ok; ++polls) {
        if (polls == (1u << 28)) __trap();
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(ok)
            : "r"(bar), "r"(parity)
            : "memory");
    }
}

// TMA bulk copy of ``bytes`` (a multiple of 16) from global memory to
// shared memory, completing on ``bar``.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(dst),
        "l"(src), "r"(bytes), "r"(bar)
        : "memory");
}

// TMA copy of one box of a 2-D tensor map (``map``: a __grid_constant__
// kernel parameter) at element coordinates (x inner, y outer) into shared
// memory, completing on ``bar`` with the box's bytes (elements outside the
// tensor read as zeros and count too).
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            int x, int y, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
        "l"(map), "r"(x), "r"(y), "r"(bar)
        : "memory");
}

// The descriptor of a K-major operand with the 128-byte swizzle at shared
// address ``addr`` (LBO 16 bytes, unused by this layout; SBO 1024 bytes).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)1 << 16) |
           ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void wgmma_wait_one() {
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void set_max_regs_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void set_max_regs_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// D[64 x 128] += A[64 x 16] * B[128 x 16]^T, bf16 in, f32 sums; both
// operands K-major in shared memory with the 128-byte swizzle.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                            uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
}


// cp.async of one 16-byte chunk into shared memory: ``bytes`` (16 or 0)
// are read from ``src`` and the rest of the chunk is zero-filled, so a
// chunk past the end of a row or of the matrix stages zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(bytes)
                 : "memory");
}

// cp.async of one 4-byte value (any 4-byte-aligned address) into shared
// memory.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
}

// An arrival on ``bar`` once every cp.async this thread issued before it
// has landed (the barrier's expected count includes this arrival).
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                     "r"(bar)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Make this thread's shared-memory writes (plain stores, or cp.async
// copies it has waited for) visible to the async proxy that wgmma reads
// through; a __syncthreads() after it publishes them to the warpgroup.
__device__ __forceinline__ void fence_async_shared() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D[64 x N] += A[64 x K] * B[N x K]^T for N = 8, 16, 32 and 64, both
// operands K-major in shared memory with the 128-byte swizzle (every
// step reads 32 bytes of each row: 16 bf16 values, or 32 int8 values):
// bf16 in with f32 sums, or int8 in with exact int32 sums. A thread
// holds N / 2 sums: sum i is row (warp % 4) * 16 + lane / 4 (+ 8 when
// i % 4 >= 2), column 8 * (i / 4) + 2 * (lane % 4) + i % 2.
template <int N>
struct Wgmma;
template <>
struct Wgmma<8> {
    static __device__ __forceinline__ void bf16(float (&d)[4], uint64_t da,
                                              uint64_t db) {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "setp.ne.b32 p, %6, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3}, "
            "%4, %5, p, 1, 1, 0, 0;\n"
            "}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "l"(da), "l"(db), "r"(1));
    }
    static __device__ __forceinline__ void s8(int (&d)[4], uint64_t da,
                                              uint64_t db) {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "setp.ne.b32 p, %6, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
            "{%0, %1, %2, %3}, "
            "%4, %5, p;\n"
            "}\n"
            : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
            : "l"(da), "l"(db), "r"(1));
    }
};
template <>
struct Wgmma<16> {
    static __device__ __forceinline__ void bf16(float (&d)[8], uint64_t da,
                                              uint64_t db) {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "setp.ne.b32 p, %10, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7}, "
            "%8, %9, p, 1, 1, 0, 0;\n"
            "}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
              "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
            : "l"(da), "l"(db), "r"(1));
    }
    static __device__ __forceinline__ void s8(int (&d)[8], uint64_t da,
                                              uint64_t db) {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "setp.ne.b32 p, %10, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
            "{%0, %1, %2, %3, %4, %5, %6, %7}, "
            "%8, %9, p;\n"
            "}\n"
            : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
              "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
            : "l"(da), "l"(db), "r"(1));
    }
};
template <>
struct Wgmma<32> {
    static __device__ __forceinline__ void bf16(float (&d)[16], uint64_t da,
                                              uint64_t db) {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "setp.ne.b32 p, %18, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7,"
            "%8, %9, %10, %11, %12, %13, %14, %15}, "
            "%16, %17, p, 1, 1, 0, 0;\n"
            "}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
              "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
              "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
              "+f"(d[14]), "+f"(d[15])
            : "l"(da), "l"(db), "r"(1));
    }
    static __device__ __forceinline__ void s8(int (&d)[16], uint64_t da,
                                              uint64_t db) {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "setp.ne.b32 p, %18, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
            "{%0, %1, %2, %3, %4, %5, %6, %7,"
            "%8, %9, %10, %11, %12, %13, %14, %15}, "
            "%16, %17, p;\n"
            "}\n"
            : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
              "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
              "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
              "+r"(d[14]), "+r"(d[15])
            : "l"(da), "l"(db), "r"(1));
    }
};
template <>
struct Wgmma<64> {
    static __device__ __forceinline__ void bf16(float (&d)[32], uint64_t da,
                                              uint64_t db) {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "setp.ne.b32 p, %34, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7,"
            "%8, %9, %10, %11, %12, %13, %14, %15,"
            "%16, %17, %18, %19, %20, %21, %22, %23,"
            "%24, %25, %26, %27, %28, %29, %30, %31}, "
            "%32, %33, p, 1, 1, 0, 0;\n"
            "}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
              "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
              "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
              "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
              "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
              "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
              "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31])
            : "l"(da), "l"(db), "r"(1));
    }
    static __device__ __forceinline__ void s8(int (&d)[32], uint64_t da,
                                              uint64_t db) {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "setp.ne.b32 p, %34, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
            "{%0, %1, %2, %3, %4, %5, %6, %7,"
            "%8, %9, %10, %11, %12, %13, %14, %15,"
            "%16, %17, %18, %19, %20, %21, %22, %23,"
            "%24, %25, %26, %27, %28, %29, %30, %31}, "
            "%32, %33, p;\n"
            "}\n"
            : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
              "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
              "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
              "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
              "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
              "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
              "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
              "+r"(d[30]), "+r"(d[31])
            : "l"(da), "l"(db), "r"(1));
    }
};

}  // namespace hopper
