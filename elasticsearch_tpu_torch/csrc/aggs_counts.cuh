// Shared device code of the terms-aggregation counting families
// (aggs_ordinal_counts, aggs_ordinal_counts_plane): int32 counts per
// ordinal over a deduped (owner, ord) occurrence table, for P query masks
// at once (the per-segment family is P = 1).
//
// An entry counts for plan p when its ordinal is in [0, n_buckets) (the
// table pads ords with -1; ordinals past the buckets are dropped, as
// mode="drop" drops them) and masks[p, owner] holds: the gather
// dev_mask[owners] of the JAX package's caller is fused into the kernel.
//
// What bounds it on the H100: memory. It reads the table once a plan
// (8 bytes an entry) and gathers one mask byte an entry; the buckets are
// few and live in shared memory.
//
// Design: integer atomics, whose sums do not depend on their order, so the
// counts are exactly the plain version's (and the JAX package's). A CTA
// counts COUNT_ITEMS entries a thread into a shared-memory histogram and
// adds its nonzero bins to the plan's row once; above SMEM_BUCKETS buckets
// it adds to the row directly.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace aggs {

constexpr int COUNT_THREADS = 256;
constexpr int COUNT_ITEMS = 16;
constexpr int SMEM_BUCKETS = 12288;     // 48 KB of int counts

// grid (ceil(e / (COUNT_THREADS * COUNT_ITEMS)), P): counts[p, ord] +=
// 1 for every valid entry. counts must start zeroed.
__global__ void __launch_bounds__(COUNT_THREADS) ordinal_counts_kernel(
    const int* __restrict__ ords, const int* __restrict__ owners,
    const uint8_t* __restrict__ masks, long long e, long long n_docs,
    int n_buckets, int* __restrict__ counts) {
    extern __shared__ int hist[];
    const bool smem = n_buckets <= SMEM_BUCKETS;
    const uint8_t* mask = masks + (long long)blockIdx.y * n_docs;
    int* row = counts + (long long)blockIdx.y * n_buckets;
    if (smem) {
        for (int b = threadIdx.x; b < n_buckets; b += blockDim.x) hist[b] = 0;
        __syncthreads();
    }
    const long long base =
        (long long)blockIdx.x * (COUNT_THREADS * COUNT_ITEMS);
    for (int t = 0; t < COUNT_ITEMS; ++t) {
        const long long j = base + (long long)t * blockDim.x + threadIdx.x;
        if (j >= e) break;
        const int o = ords[j];
        if (o < 0 || o >= n_buckets || !mask[owners[j]]) continue;
        atomicAdd(smem ? hist + o : row + o, 1);
    }
    if (smem) {
        __syncthreads();
        for (int b = threadIdx.x; b < n_buckets; b += blockDim.x)
            if (hist[b]) atomicAdd(row + b, hist[b]);
    }
}

// ords/owners: [e] int32 (owners in [0, n_docs)); masks: [P, n_docs] bool;
// counts: [P, n_buckets] int32. Returns the first CUDA error, 0 on success.
inline int ordinal_counts(const int* ords, const int* owners,
                          const uint8_t* masks, long long e,
                          long long n_docs, int n_plans, int n_buckets,
                          int* counts, cudaStream_t stream) {
    if (e < 0 || n_docs < 1 || n_plans < 1 || n_plans > 65535 ||
        n_buckets < 1)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaMemsetAsync(
        counts, 0, sizeof(int) * (size_t)n_plans * (size_t)n_buckets, stream);
    if (err != cudaSuccess || e == 0) return (int)err;
    const long long per = (long long)COUNT_THREADS * COUNT_ITEMS;
    const long long blocks = (e + per - 1) / per;
    const size_t smem =
        n_buckets <= SMEM_BUCKETS ? sizeof(int) * (size_t)n_buckets : 0;
    ordinal_counts_kernel<<<dim3((unsigned)blocks, n_plans), COUNT_THREADS,
                            smem, stream>>>(ords, owners, masks, e, n_docs,
                                            n_buckets, counts);
    return (int)cudaGetLastError();
}

}  // namespace aggs
