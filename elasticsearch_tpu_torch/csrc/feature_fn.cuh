// The rank_features contribution's function f(w), shared by the plane
// pipelines of sparse_common.cuh (K17, row 43) and the tile pipeline of
// tiles.cuh (K15, K16, K19, rows 34 and 38): saturation w / (w + pivot), log
// log(pivot + w), sigmoid w^a / (w^a + pivot^a) on max(w, 0), linear w.
// Every op is one explicitly rounded intrinsic, so nvcc cannot contract a
// multiply-add: the kernels compute the plain version's bits (log and
// sigmoid call logf / powf, which may differ from torch's by an ulp).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace sparse {

enum Function { SATURATION = 0, LOG = 1, SIGMOID = 2, LINEAR = 3 };

// f(w), one rounded op at a time. pivot_pow = pivot^exponent in f32,
// computed once on the host (sigmoid only).
__device__ __forceinline__ float transform(int fn, float w, float pivot,
                                           float exponent, float pivot_pow) {
    switch (fn) {
        case SATURATION:
            return __fdiv_rn(w, __fadd_rn(w, pivot));
        case LOG:
            return logf(__fadd_rn(pivot, w));
        case SIGMOID: {
            const float wa = powf(fmaxf(w, 0.f), exponent);
            return __fdiv_rn(wa, __fadd_rn(wa, pivot_pow));
        }
        default:
            return w;
    }
}

struct Params {
    int fn;
    float pivot, exponent, pivot_pow;
};

}  // namespace sparse
