// sharded_sparse: one text_expansion / rank_features query over a corpus
// cut round-robin into S slots, with the global top-k, in one launch.
//
// Replaces elasticsearch_tpu/parallel/sharded_search.py:634
// `make_sharded_sparse` (a shard_map of `_local_sparse_scores` (:617) and
// `_global_topk_1d` (:134)): block_docs / block_weights [S, NB, 128],
// block lists and query weights [S, QB] (block 0 / weight 0 as padding)
// -> scores [k] and mesh-global ids slot * N + local [k], -1 where not
// finite. A posting adds qw * w; a doc whose sum is not > 0 scores -inf.
// No live mask: the index drops tombstones when it is built.
//
// What bounds it on the H100: memory. The gathered blocks (8 bytes a
// posting) must be read and k pairs written; here the [S, N] int64
// accumulator is also zeroed, scattered into and read back (S * N * 8
// bytes three times), which dominates at the tens of blocks an expansion
// gathers.
//
// Why the simple design: sparse_common.cuh's linear scatter, one row a
// slot, in 64-bit fixed point with integer atomics (rounded once,
// order-free), then sharded_common.cuh's one-pass selection over the flat
// mesh-global space. The plain PyTorch version is
// elasticsearch_tpu_torch/parallel/sharded_search.py
// `sharded_sparse_plain`.
#include "sharded_common.cuh"
#include "sparse_common.cuh"

// Row 43's local scores (`_local_sparse_scores`): the [S, 1, N]
// fixed-point plane of one query's block lists and weights [S, qb],
// qw * w a posting: sparse_common.cuh's linear scatter, one row a slot.
static int sparse_plane(const int* block_docs, const float* block_weights,
                        const int* block_idx, const float* query_weight,
                        int n_slots, long long nb, int qb,
                        long long n_docs_pad, long long* acc,
                        cudaStream_t stream) {
    if (n_slots < 1 || nb < 1) return (int)cudaErrorInvalidValue;
    const sparse::Params p{sparse::LINEAR, 1.f, 1.f, 1.f};
    const bm25::Slots sl{n_slots, 1, nb * bm25::BLOCK, n_docs_pad};
    return sparse::scatter_plane<false>(block_docs, block_weights, block_idx,
                                        query_weight, qb, n_docs_pad, 1, p,
                                        acc, stream, sl);
}

// acc: [n_slots, n_docs_pad] int64 scratch; chunk_s / chunk_i:
// sharded::select_scratch entries; sel_s / sel_i: [min(k, S * N)];
// out_s / out_i: [k].
extern "C" int sharded_sparse_launch(
    const int* block_docs, const float* block_weights, const int* block_idx,
    const float* query_weight, int n_slots, long long nb, int qb,
    long long n_docs_pad, int k, long long* acc, float* chunk_s,
    int* chunk_i, float* sel_s, int* sel_i, float* out_s, int* out_i,
    void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    int rc = sparse_plane(block_docs, block_weights, block_idx,
                                   query_weight, n_slots, nb, qb, n_docs_pad,
                                   acc, stream);
    if (rc != 0) return rc;
    const sharded::SelScratch sc{chunk_s, chunk_i, sel_s, sel_i};
    return sharded::global_topk<true, false>(acc, n_slots, n_docs_pad, 1, k,
                                             sc, out_s, out_i, nullptr,
                                             stream);
}
