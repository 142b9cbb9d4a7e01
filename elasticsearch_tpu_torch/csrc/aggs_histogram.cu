// aggs_histogram: the histogram aggregation's per-segment device half.
//
// Replaces elasticsearch_tpu/ops/aggs.py:42 `histogram_partials`: per
// bucket floor_div(value, interval) - base of one segment's int32 column,
// the int32 count and the f32 sum, min and max of the rows that exist and
// match the query (others, and buckets outside [0, n_buckets), dropped).
//
// What bounds it, and the design: aggs_histogram.cuh at one plan (a
// stable counting sort by bucket, then each bucket's values added in row
// order, as the JAX package adds them on the CPU). The plain PyTorch
// version is elasticsearch_tpu_torch/ops/aggs.py `histogram_plain`.
#include "aggs_histogram.cuh"

extern "C" int aggs_histogram_launch(
    const int* values, const uint8_t* exists, const uint8_t* mask,
    const int* base, const int* interval, long long n, int n_buckets,
    int rows_per_chunk, int* cc, int* offsets, float* sorted, int* counts,
    float* sums, float* mins, float* maxs, void* stream) {
    return aggs::histogram(values, exists, mask, base, interval, n, 1,
                           n_buckets, rows_per_chunk, cc, offsets, sorted,
                           counts, sums, mins, maxs, (cudaStream_t)stream);
}
