// The sharded data plane's kNN scores pass, for sharded_knn.cu and
// sharded_hybrid.cu only: kept out of knn_common.cuh, whose every other
// includer would otherwise compile its F32 instantiations too.
#pragma once

#include "knn_common.cuh"

namespace knn {

// The sharded kNN's local scores (row 40, `_local_knn_scores` of
// elasticsearch_tpu/parallel/sharded_search.py): the [S, n_q, N] f32 plane,
// -inf where the slot row holds no vector (valid false). cosine and
// dot_product take K5's bf16 operands; l2_norm keeps f32 operands.
inline int sharded_scores(const float* matrix, const float* norms,
                          const uint8_t* valid, const float* queries,
                          const float* qn, const float* q2, int n_slots,
                          int n_q, int dims, long long n_docs_pad, int sim,
                          float* plane, cudaStream_t stream) {
    if (n_slots < 1 || n_slots > 65535 || n_q < 1 ||
        (long long)n_slots * n_q > INT_MAX || dims < 1 ||
        dims > MAX_DIMS || n_docs_pad < 1 || !valid_sim(sim))
        return (int)cudaErrorInvalidValue;
    if (sim == SIM_L2)
        return vector_scores<false, true>(matrix, norms, valid, nullptr,
                                          queries, qn, q2, n_q, dims,
                                          n_docs_pad, sim, plane, stream,
                                          n_slots);
    return vector_scores<false>(matrix, norms, valid, nullptr, queries, qn,
                                q2, n_q, dims, n_docs_pad, sim, plane,
                                stream, n_slots);
}

}  // namespace knn
