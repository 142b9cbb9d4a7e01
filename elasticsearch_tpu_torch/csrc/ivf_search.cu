// ivf_search: the IVF probe -- centroid scoring, top-nprobe, an exact scan
// of the probed lists, top-k.
//
// Replaces elasticsearch_tpu/ops/ivf.py:328 `_ivf_search`: for each query
// q [Q, D] f32, centroid scores dot(bf16 q, bf16 c) summed in f32 (for
// l2_norm 2 * s - c2, c2 summed over the f32 centroids); the top-nprobe
// lists under (score desc, index asc); every slot of those lists scored
// with knn_flat's arithmetic (bf16 operands, f32 sums in dim order, the
// similarity transform of knn_common.cuh with the list's doc norms and the
// query's qn / q2), -inf where the slot is padding; the top-k over the
// flattened [nprobe, L] candidate order (so equal scores resolve by probe
// rank, then list position -- not by doc id, as in the JAX program); and
// the slots mapped through ids, with -1 and 0.0 where the score is not
// finite. -> (scores [Q, k] f32, ids [Q, k] int32).
//
// What bounds it on the H100: memory. A query reads its nprobe lists,
// nprobe * L * D * 4 bytes (23.6 MB at nprobe 16, L 384, D 960: 7 us at
// 3.35 TB/s; 377 MB at nprobe 256), plus the centroids once for the batch
// (15.7 MB at 4,096 x 960).
//
// Design: the lists are scanned in place; the JAX program's
// [Q, nprobe, L, D] gather is never formed. One scores kernel serves both
// passes: a CTA stages a tile of candidate rows (the centroids, or the
// probed lists' slots, addressed through probes) 16 dims at a time in
// shared memory and every thread sums its candidates in dimension order,
// so the kernel has the plain version's bits. Each pass writes a score
// plane ([Q, nlist], then [Q, nprobe * L]) that topk_common.cuh's chunked
// top-k reads; a last kernel maps the winners to ids. The plain PyTorch
// version is elasticsearch_tpu_torch/ops/ivf.py `ivf_search_plain`.
#include "ivf_common.cuh"

using namespace ivf;

namespace {

constexpr int THREADS = 128;
constexpr int DT = 16;                   // dims staged per step
constexpr int MAX_TILES_Y = 65535;

// grid (n_q, candidate tiles): cell [q, j], j in [0, n_cand):
//   row(j) = PROBED ? probes[q, j / L] * L + j % L : j
//   dot    = sum_d bf16(queries[q, d]) * bf16(rows[row(j), d]), dim order
//   PROBED: valid[row] ? similarity(dot, aux[row], qn[q], q2[q]) : -inf
//           (aux = the lists' doc norms)
//   else:   sim == l2 ? 2 * dot - aux[row] : dot  (aux = c2)
template <bool PROBED, int RD>
__global__ void __launch_bounds__(THREADS) ivf_scores_kernel(
    const float* __restrict__ rows, const float* __restrict__ aux,
    const uint8_t* __restrict__ valid, const int* __restrict__ probes,
    int nprobe, int list_len, const float* __restrict__ queries,
    const float* __restrict__ qn, const float* __restrict__ q2, int dims,
    long long n_cand, long long tile0, int sim, float* __restrict__ plane) {
    constexpr int TILE = THREADS * RD;
    __shared__ float ms[DT][TILE + 1];
    __shared__ float qs[DT];
    __shared__ long long rid[TILE];
    const int t = threadIdx.x;
    const int q = blockIdx.x;
    const long long j0 = (tile0 + blockIdx.y) * (long long)TILE;
    for (int e = t; e < TILE; e += THREADS) {
        const long long j = j0 + e;
        long long r = -1;
        if (j < n_cand)
            r = PROBED ? (long long)probes[(long long)q * nprobe +
                                           j / list_len] * list_len +
                             j % list_len
                       : j;
        rid[e] = r;
    }
    float acc[RD];
#pragma unroll
    for (int i = 0; i < RD; ++i) acc[i] = 0.f;
    __syncthreads();
    for (int d0 = 0; d0 < dims; d0 += DT) {
        const int dn = dims - d0 < DT ? dims - d0 : DT;
        for (int e = t; e < TILE * DT; e += THREADS) {
            const int cand = e / DT, dd = e % DT;
            const long long r = rid[cand];
            ms[dd][cand] = (dd < dn && r >= 0) ? bfr(rows[r * dims + d0 + dd])
                                               : 0.f;
        }
        if (t < DT)
            qs[t] = t < dn ? bfr(queries[(long long)q * dims + d0 + t]) : 0.f;
        __syncthreads();
        for (int dd = 0; dd < dn; ++dd) {
            const float qv = qs[dd];
#pragma unroll
            for (int i = 0; i < RD; ++i)
                acc[i] = __fmaf_rn(qv, ms[dd][t + i * THREADS], acc[i]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < RD; ++i) {
        const int e = t + i * THREADS;
        const long long j = j0 + e;
        if (j >= n_cand) continue;
        const long long r = rid[e];
        float s;
        if (PROBED)
            s = valid[r] ? similarity(acc[i], aux[r], qn[q], q2[q], sim)
                         : -INFINITY;
        else
            s = sim == SIM_L2 ? __fsub_rn(__fmul_rn(2.f, acc[i]), aux[r])
                              : acc[i];
        plane[(long long)q * n_cand + j] = s;
    }
}

template <bool PROBED>
int launch_scores(const float* rows, const float* aux, const uint8_t* valid,
                  const int* probes, int nprobe, int list_len,
                  const float* queries, const float* qn, const float* q2,
                  int n_q, int dims, long long n_cand, int sim, float* plane,
                  cudaStream_t stream) {
    // small launches (a solo query) take 128-candidate tiles to spread
    // over more SMs; large ones 512
    const bool wide = (long long)n_q * ((n_cand + 511) / 512) >= 264;
    const int tile = wide ? THREADS * 4 : THREADS;
    const long long tiles = (n_cand + tile - 1) / tile;
    for (long long tile0 = 0; tile0 < tiles; tile0 += MAX_TILES_Y) {
        const long long nt =
            tiles - tile0 < MAX_TILES_Y ? tiles - tile0 : MAX_TILES_Y;
        const dim3 grid(n_q, (unsigned)nt);
        if (wide)
            ivf_scores_kernel<PROBED, 4><<<grid, THREADS, 0, stream>>>(
                rows, aux, valid, probes, nprobe, list_len, queries, qn, q2,
                dims, n_cand, tile0, sim, plane);
        else
            ivf_scores_kernel<PROBED, 1><<<grid, THREADS, 0, stream>>>(
                rows, aux, valid, probes, nprobe, list_len, queries, qn, q2,
                dims, n_cand, tile0, sim, plane);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

// one thread per (query, rank): the winner's slot -> its id.
__global__ void map_kernel(const float* __restrict__ top_s,
                           const int* __restrict__ top_pos,
                           const int* __restrict__ probes,
                           const int* __restrict__ ids, int n_q, int k,
                           int nprobe, int list_len, float* __restrict__ out_s,
                           int* __restrict__ out_i) {
    const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= (long long)n_q * k) return;
    const long long q = c / k;
    const float s = top_s[c];
    if (isfinite(s)) {
        const int pos = top_pos[c];
        const long long probe = probes[q * nprobe + pos / list_len];
        out_i[c] = ids[probe * list_len + pos % list_len];
        out_s[c] = s;
    } else {
        out_i[c] = -1;
        out_s[c] = 0.f;
    }
}

}  // namespace

// queries: [n_q, dims] f32 with qn/q2 [n_q]; cents: [nlist, dims] f32;
// lists: [nlist, list_len, dims] f32; valid: [nlist, list_len] bool; ids:
// [nlist, list_len] int32; norms: [nlist, list_len] f32. Scratch: c2
// [nlist]; cplane [n_q, nlist]; cchunk_s/cchunk_i (plane_topk's chunk
// winners of the centroid pass); probe_s/probes [n_q, nprobe]; lplane
// [n_q, nprobe * list_len]; lchunk_s/lchunk_i; top_s/top_pos [n_q, k].
// out_s/out_i: [n_q, k].
extern "C" int ivf_search_launch(
    const float* queries, const float* qn, const float* q2,
    const float* cents, const float* lists, const uint8_t* valid,
    const int* ids, const float* norms, int n_q, int dims, int nlist,
    int list_len, int nprobe, int k, int sim, float* c2, float* cplane,
    float* cchunk_s, int* cchunk_i, float* probe_s, int* probes,
    float* lplane, float* lchunk_s, int* lchunk_i, float* top_s,
    int* top_pos, float* out_s, int* out_i, void* stream_ptr) {
    const long long n_cand = (long long)nprobe * list_len;
    if (n_q < 1 || dims < 1 || dims > MAX_DIMS || nlist < 1 ||
        list_len < 1 || nprobe < 1 || nprobe > nlist || nprobe > KMAX ||
        k < 1 || k > n_cand || !valid_sim(sim))
        return (int)cudaErrorInvalidValue;
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    int rc = 0;
    if (sim == SIM_L2) {
        rc = launch_centroid_norms(cents, nlist, dims, c2, stream);
        if (rc != 0) return rc;
    }
    rc = launch_scores<false>(cents, c2, nullptr, nullptr, 0, 1, queries, qn,
                              q2, n_q, dims, nlist, sim, cplane, stream);
    if (rc != 0) return rc;
    rc = plane_topk(cplane, n_q, nlist, nprobe, cchunk_s, cchunk_i, probe_s,
                    probes, stream);
    if (rc != 0) return rc;
    rc = launch_scores<true>(lists, norms, valid, probes, nprobe, list_len,
                             queries, qn, q2, n_q, dims, n_cand, sim, lplane,
                             stream);
    if (rc != 0) return rc;
    rc = plane_topk(lplane, n_q, n_cand, k, lchunk_s, lchunk_i, top_s,
                    top_pos, stream);
    if (rc != 0) return rc;
    const long long cells = (long long)n_q * k;
    map_kernel<<<(unsigned)((cells + 255) / 256), 256, 0, stream>>>(
        top_s, top_pos, probes, ids, n_q, k, nprobe, list_len, out_s, out_i);
    return (int)cudaGetLastError();
}
