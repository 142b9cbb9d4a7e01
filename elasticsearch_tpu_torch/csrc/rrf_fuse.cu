// rrf_fuse: K24 at B = 1, with the unscored tail.
//
// Replaces elasticsearch_tpu/ops/fusion.py:26 `rrf_fuse`: one row of R
// ranked lists; past the matches, the lowest-numbered unscored doc ids in
// ascending order at -inf, as lax.top_k returns them from the JAX
// package's dense row. The kernel, its bound and its design are in
// rrf_fuse.cuh; the plain PyTorch version is
// elasticsearch_tpu_torch/ops/fusion.py `rrf_fuse_plain`.
#include "rrf_fuse.cuh"

extern "C" int rrf_fuse_launch(const int* lists, int R, int K,
                               long long n_docs_pad, int k,
                               int rank_constant, unsigned char* gscratch,
                               float* out_s, int* out_d, void* stream) {
    return rrf::launch(lists, 1, R, K, n_docs_pad, k, rank_constant, 1,
                       gscratch, out_s, out_d, (cudaStream_t)stream);
}
