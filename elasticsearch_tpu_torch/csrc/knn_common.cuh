// Shared device code of the three kNN kernel families (knn_flat,
// knn_coarse, knn_rerank).
//
// 1. The similarity transform (similarity below), the JAX package's
//    `_coarse_similarity` / `_rerank_scores` in their operation order:
//      cosine       (1 + dot / (norm * qn + 1e-30)) / 2
//      dot_product  0.5 + dot / 2
//      l2_norm      1 / (1 + sqrt(max(norm * norm + q2 - 2 * dot, 0)))
//    Every operation is an explicitly rounded intrinsic (__fmul_rn,
//    __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn), so nvcc contracts
//    nothing into an FMA and the kernel computes the same bits as the
//    plain PyTorch version, one rounded op at a time. One exception, on
//    purpose: XLA compiles the JAX program's norm * norm + q2 into one
//    fused multiply-add, so that sum is taken with the exact product and
//    rounded once -- here in double (the product of two f32 values is
//    exact there), then to f32, as the plain version does. qn (the
//    query's norm + 1e-30) and q2 (q . q) come from the host, computed
//    once per query.
// 2. The exact dot product: both operands rounded to bf16, products summed
//    in f32 in the order d = 0, 1, ..., D-1, one query-doc pair at a time.
//    The product of two bf16 values is exact in f32 (8 + 8 significant
//    bits), so an FMA rounds exactly where a multiply then an add would:
//    the sum has the bits of the plain version's column loop, with or
//    without FMA, in any batch. (Products below f32's normal range would
//    round; vectors whose coordinate products fall under 1e-38 are outside
//    that promise.)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace knn {

using namespace topk;

enum Similarity { SIM_COSINE = 0, SIM_DOT = 1, SIM_L2 = 2 };

constexpr int MAX_DIMS = 4096;  // mapping/mappers.py MAX_VECTOR_DIMS

// Round an f32 to the nearest bf16 and widen it back.
__device__ __forceinline__ float bfr(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float similarity(float dot, float norm, float qn,
                                            float q2, int sim) {
    if (sim == SIM_DOT) return __fadd_rn(0.5f, __fdiv_rn(dot, 2.f));
    if (sim == SIM_COSINE)
        return __fdiv_rn(
            __fadd_rn(1.f, __fdiv_rn(dot, __fadd_rn(__fmul_rn(norm, qn),
                                                    1e-30f))),
            2.f);
    const float n2q2 = __double2float_rn(
        __dadd_rn(__dmul_rn((double)norm, (double)norm), (double)q2));
    float d2 = __fsub_rn(n2q2, __fmul_rn(2.f, dot));
    d2 = d2 < 0.f ? 0.f : d2;
    return __fdiv_rn(1.f, __fadd_rn(1.f, __fsqrt_rn(d2)));
}

inline bool valid_sim(int sim) {
    return sim == SIM_COSINE || sim == SIM_DOT || sim == SIM_L2;
}

}  // namespace knn
