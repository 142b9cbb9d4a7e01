// aggs_histogram: the histogram aggregation's per-segment device half.
//
// Replaces elasticsearch_tpu/ops/aggs.py:42 `histogram_partials`: per
// bucket floor_div(value, interval) - base of one segment's int32 column,
// the int32 count and the f32 sum, min and max of the rows that exist and
// match the query (others, and buckets outside [0, n_buckets), dropped).
//
// What bounds it, and the design: aggs_histogram.cuh at one plan, its
// base and interval passed by value (no copy to the card a call): three
// operations (a memset; one cooperative launch counting, deciding which
// buckets' sums are exact integers and sorting the others' rows stably;
// the add chains of those buckets, in row order, as the JAX package adds
// them on the CPU). The plain PyTorch version is
// elasticsearch_tpu_torch/ops/aggs.py `histogram_partials_plain`.
#include "aggs_histogram.cuh"

// ws: the scratch (aggs::histogram); host, split_ms: see
// aggs::histogram (nullptr on the served path).
extern "C" int aggs_histogram_launch(
    const int* values, const uint8_t* exists, const uint8_t* mask, int base,
    int interval, long long n, int n_buckets, int rows_per_chunk, void* ws,
    int* counts, float* sums, float* mins, float* maxs, long long* host,
    float* split_ms, void* stream) {
    return aggs::histogram(values, exists, mask, nullptr, nullptr, base,
                           interval, n, 1, n_buckets, rows_per_chunk, ws,
                           counts, sums, mins, maxs, host, split_ms,
                           (cudaStream_t)stream);
}

// One thread's chain of n dependent f32 adds, each rounded (__fadd_rn), so
// that chip_smoke.py can time one dependent add on this card: the sums'
// latency bound is the longest chain's row count times one such add
// (aggs_histogram.cuh). A measurement aid; it replaces no TPU kernel and
// no wrapper calls it.
__global__ void add_chain_kernel(long long n, float step, float* out) {
    float x = 0.f;
    for (long long i = 0; i < n; ++i) x = __fadd_rn(x, step);
    *out = x;
}

extern "C" int aggs_histogram_add_chain(long long n, float step, float* out,
                                        void* stream) {
    add_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(n, step, out);
    return (int)cudaGetLastError();
}
