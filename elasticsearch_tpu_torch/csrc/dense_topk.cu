// dense_topk: the top-k of one dense score row.
//
// Replaces the eager `jax.lax.top_k(scores, k)` of the dense collector
// (elasticsearch_tpu/search/phase.py:806 `_topk`), run once per segment
// of every dense request: scores [n_docs_pad] f32 with -inf at the docs
// that do not match -> (s [k] f32, d [k] int32) in lax.top_k's order:
// score descending (+0.0 above -0.0), then index ascending, -inf slots
// included, for any 1 <= k <= n. Ties matter here: match_all and
// constant_score give every match the same score, so their hits are
// decided by this order alone.
//
// What bounds it on the H100: memory, and at small rows launch latency.
// It must read the row once (1 MB at 262,144 docs: 0.0003 ms at
// 3.35 TB/s; 16.8 MB at 4,194,304: 0.005 ms).
//
// Design: radix_select.cuh's card-wide radix select over one 64-bit key
// per entry (score, then index), which spreads every pass over the whole
// card, stops once the survivors fit one CTA's sort, and sorts the
// survivors once. The plain PyTorch version is
// elasticsearch_tpu_torch/ops/topk.py `dense_topk_plain` (a stable sort
// of the scores' ordered bits).
#include "radix_select.cuh"

// sizes[0]: bytes of the State; sizes[1]: entries of the first key
// buffer; sizes[2]: entries of the second (k > CAP), else 0.
extern "C" int dense_topk_scratch(long long n, int k, long long* sizes) {
    sizes[0] = (long long)sizeof(rsel::State);
    sizes[1] = rsel::keys_entries(n, k);
    sizes[2] = k > rsel::CAP ? k : 0;
    return 0;
}

// scores: [n] f32; state: dense_topk_scratch's bytes; keys / keys2: its
// entries of 8 bytes (keys2 may be null when k <= CAP); out_s/out_d: [k].
extern "C" int dense_topk_launch(const float* scores, long long n, int k,
                                 void* state, void* keys, void* keys2,
                                 float* out_s, int* out_d, void* stream) {
    return rsel::select_topk(scores, n, k, (rsel::State*)state,
                             (rsel::Key*)keys, (rsel::Key*)keys2, out_s,
                             out_d, (cudaStream_t)stream);
}
