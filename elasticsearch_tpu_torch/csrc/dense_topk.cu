// dense_topk: the top-k of one dense score row.
//
// Replaces the eager `jax.lax.top_k(scores, k)` of the dense collector
// (elasticsearch_tpu/search/phase.py:806 `_topk`), run once per segment
// of every dense request: scores [n_docs_pad] f32 with -inf at the docs
// that do not match -> (s [k] f32, d [k] int32) in lax.top_k's order:
// score descending, then index ascending, -inf slots included. Ties
// matter here: match_all and constant_score give every match the same
// score, so their hits are decided by this order alone.
//
// What bounds it on the H100: memory, and at small rows launch latency.
// It must read the row once (1 MB at 262,144 docs: 0.0003 ms at
// 3.35 TB/s; 16.8 MB at 4,194,304: 0.005 ms).
//
// Design: topk_common.cuh's plane_topk with one row -- one CTA per
// 65,536-doc chunk keeps its chunk's best k in shared memory (threshold
// buffer + bitonic sort, k <= 4096), and one merge CTA selects the row's
// best k from the chunk winners (skipped for a one-chunk row). The plain
// PyTorch version is elasticsearch_tpu_torch/ops/topk.py
// `dense_topk_plain` (a stable sort).
#include "topk_common.cuh"

// chunk_s/chunk_i: ceil(n / CHUNK) * min(k, KMAX) entries (unused for one
// chunk);
// out_s/out_d: [k].
extern "C" int dense_topk_launch(const float* scores, long long n, int k,
                                 float* chunk_s, int* chunk_i, float* out_s,
                                 int* out_d, void* stream) {
    return topk::plane_topk(scores, 1, n, k, chunk_s, chunk_i, out_s, out_d,
                            (cudaStream_t)stream);
}
