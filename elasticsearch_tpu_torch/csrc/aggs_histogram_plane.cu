// aggs_histogram_plane: the histogram aggregation over a shard's whole
// columns plane for P plans in one launch.
//
// Replaces elasticsearch_tpu/ops/aggs.py:112 `histogram_partials_plane`:
// the [P, n_buckets] counts (int32) and sums, mins and maxs (f32) of the
// plane's int32 column under each plan's [N_pad] mask, base and interval.
// The sums run over the whole plane in one f32 chain a bucket, in plane
// row order, as the JAX package's program adds them on the CPU.
//
// What bounds it, and the design: aggs_histogram.cuh, one grid row a
// plan. The plain PyTorch version is elasticsearch_tpu_torch/ops/aggs.py
// `histogram_plane_plain`.
#include "aggs_histogram.cuh"

extern "C" int aggs_histogram_plane_launch(
    const int* values, const uint8_t* exists, const uint8_t* masks,
    const int* bases, const int* intervals, long long n, int n_plans,
    int n_buckets, int rows_per_chunk, int* cc, int* offsets, float* sorted,
    int* counts, float* sums, float* mins, float* maxs, void* stream) {
    return aggs::histogram(values, exists, masks, bases, intervals, n,
                           n_plans, n_buckets, rows_per_chunk, cc, offsets,
                           sorted, counts, sums, mins, maxs,
                           (cudaStream_t)stream);
}
