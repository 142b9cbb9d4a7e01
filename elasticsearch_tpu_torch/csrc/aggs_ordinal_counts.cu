// aggs_ordinal_counts: the terms aggregation's per-segment device half.
//
// Replaces elasticsearch_tpu/ops/aggs.py:30 `ordinal_counts`: int32
// counts per ordinal over one segment's deduped (owner, ord) occurrence
// table, an entry counting when its owner matched the query (the caller's
// dev_mask[owners] gather, fused here) and its ordinal is >= 0.
//
// What bounds it, and the design: aggs_counts.cuh at one plan. The plain
// PyTorch version is elasticsearch_tpu_torch/ops/aggs.py
// `ordinal_counts_plain`.
#include "aggs_counts.cuh"

// ords/owners: [e] int32; mask: [n_docs] bool; counts: [n_buckets] int32.
extern "C" int aggs_ordinal_counts_launch(const int* ords, const int* owners,
                                          const uint8_t* mask, long long e,
                                          long long n_docs, int n_buckets,
                                          int* counts, void* stream) {
    return aggs::ordinal_counts(ords, owners, mask, e, n_docs, 1, n_buckets,
                                counts, (cudaStream_t)stream);
}
