// aggs_histogram_plane: the histogram aggregation over a shard's whole
// columns plane for P plans in one launch.
//
// Replaces elasticsearch_tpu/ops/aggs.py:112 `histogram_partials_plane`:
// the [P, n_buckets] counts (int32) and sums, mins and maxs (f32) of the
// plane's int32 column under each plan's [N_pad] mask, base and interval.
// The sums run over the whole plane in one f32 chain a bucket, in plane
// row order, as the JAX package's program adds them on the CPU.
//
// What bounds it, and the design: aggs_histogram.cuh over P plans (the
// counting and sorting tasks are (plan, chunk) pairs; one chain a chain
// bucket of any plan). The plain PyTorch version is
// elasticsearch_tpu_torch/ops/aggs.py `histogram_partials_plane_plain`.
#include "aggs_histogram.cuh"

// ws: the scratch (aggs::histogram); host, split_ms: see
// aggs::histogram (nullptr on the served path).
extern "C" int aggs_histogram_plane_launch(
    const int* values, const uint8_t* exists, const uint8_t* masks,
    const int* bases, const int* intervals, long long n, int n_plans,
    int n_buckets, int rows_per_chunk, void* ws, int* counts, float* sums,
    float* mins, float* maxs, long long* host, float* split_ms,
    void* stream) {
    return aggs::histogram(values, exists, masks, bases, intervals, 0, 0, n,
                           n_plans, n_buckets, rows_per_chunk, ws, counts,
                           sums, mins, maxs, host, split_ms,
                           (cudaStream_t)stream);
}
