// aggs_ordinal_counts_plane: the terms aggregation over a shard's whole
// columns plane for P plans in one launch.
//
// Replaces elasticsearch_tpu/ops/aggs.py:90 `ordinal_counts_plane`: the
// [P, n_buckets] int32 counts per GLOBAL ordinal of the plane's deduped
// (owner, ord) table under each plan's [N_pad] query mask, gathered at the
// owners.
//
// What bounds it, and the design: aggs_counts.cuh, one grid row a plan.
// The plain PyTorch version is elasticsearch_tpu_torch/ops/aggs.py
// `ordinal_counts_plane_plain`.
#include "aggs_counts.cuh"

// ords/owners: [e] int32; masks: [P, n_docs] bool; counts: [P, n_buckets]
// int32.
extern "C" int aggs_ordinal_counts_plane_launch(
    const int* ords, const int* owners, const uint8_t* masks, long long e,
    long long n_docs, int n_plans, int n_buckets, int* counts, void* stream) {
    return aggs::ordinal_counts(ords, owners, masks, e, n_docs, n_plans,
                                n_buckets, counts, (cudaStream_t)stream);
}
