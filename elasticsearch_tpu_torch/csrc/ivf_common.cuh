// Shared device code of the IVF kernel families (ivf_assign, ivf_search).
#pragma once

#include "knn_common.cuh"

namespace ivf {

using namespace knn;

// c2[c] = sum_d cents[c, d] * cents[c, d] in f32, d = 0, 1, ..., D-1, the
// product and the sum each rounded (the plain version's column loop).
__global__ void centroid_norms_kernel(const float* __restrict__ cents,
                                      int nlist, int dims,
                                      float* __restrict__ c2) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= nlist) return;
    const float* row = cents + (long long)c * dims;
    float acc = 0.f;
    for (int d = 0; d < dims; ++d)
        acc = __fadd_rn(acc, __fmul_rn(row[d], row[d]));
    c2[c] = acc;
}

inline int launch_centroid_norms(const float* cents, int nlist, int dims,
                                 float* c2, cudaStream_t stream) {
    centroid_norms_kernel<<<(nlist + 127) / 128, 128, 0, stream>>>(
        cents, nlist, dims, c2);
    return (int)cudaGetLastError();
}

}  // namespace ivf
