// rrf_fuse_batch: K24 over B rows, docs -1 past each row's matches.
//
// Replaces elasticsearch_tpu/ops/fusion.py:46 `rrf_fuse_batch`, the
// coordinator's RrfFusionBatcher drain (action/search_action.py). The
// kernel, its bound and its design are in rrf_fuse.cuh; the plain PyTorch
// version is elasticsearch_tpu_torch/ops/fusion.py `rrf_fuse_batch_plain`.
#include "rrf_fuse.cuh"

extern "C" int rrf_fuse_batch_launch(const int* lists, int B, int R, int K,
                                     long long n_docs_pad, int k,
                                     int rank_constant,
                                     unsigned char* gscratch, float* out_s,
                                     int* out_d, void* stream) {
    return rrf::launch(lists, B, R, K, n_docs_pad, k, rank_constant, 0,
                       gscratch, out_s, out_d, (cudaStream_t)stream);
}
