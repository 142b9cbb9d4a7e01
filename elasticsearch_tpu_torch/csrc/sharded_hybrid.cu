// sharded_hybrid: BM25 and kNN over one corpus cut round-robin into S
// slots, each branch's global top-k, fused by RRF, in one launch.
//
// Replaces elasticsearch_tpu/parallel/sharded_search.py:777
// `make_sharded_hybrid`: the BM25 branch (sharded_bm25's operands, one
// query) and the kNN branch (sharded_knn's, one query vector [D]) each
// take `_global_topk_1d`; then RRF over the 2k mesh-global ids (BM25
// first): 1 / (rank_constant + r) at rank r = 1..k, 0 for id -1, summed
// over equal ids, the first occurrence kept, the top-k of the fused
// scores with ties by lower position -> scores [k] and mesh-global ids
// [k], -1 where not finite. No served caller in either package.
//
// What bounds it on the H100: memory, the two branches' bytes together:
// the gathered posting blocks and the f32 matrix (S * N * D * 4 bytes),
// plus here each branch's [S, N] plane written and read back. The fusion
// touches 2k ids.
//
// Why the simple design: the branches are sharded_bm25's and
// sharded_knn's pipelines run back to back into one [2k] id list; the
// fusion is one CTA (sharded_common.cuh rrf_fuse). The plain PyTorch
// version is elasticsearch_tpu_torch/parallel/sharded_search.py
// `sharded_hybrid_plain`.
#include "sharded_common.cuh"
#include "sharded_scores.cuh"

// acc: [n_slots, n_docs_pad] int64 scratch; plane: [n_slots, n_docs_pad]
// f32 scratch; chunk_s / chunk_i: sharded::select_scratch entries (one
// row); sel_s / sel_i: [min(k, S * N)]; branch_s / branch_i: [2k]; out_s
// / out_i: [k].
extern "C" int sharded_hybrid_launch(
    const int* block_docs, const float* block_tfs, const float* doc_lens,
    const float* avgdl, const int* block_idx, const float* block_w,
    long long nb, int qb, const float* matrix, const float* norms,
    const uint8_t* valid, const float* qvec, const float* qn, const float* q2,
    int dims, int sim, int n_slots, long long n_docs_pad, int k,
    float rank_constant, float k1, float omb, float b, float k1p1,
    long long* acc, float* plane, float* chunk_s, int* chunk_i, float* sel_s,
    int* sel_i, float* branch_s, int* branch_i, float* out_s, int* out_i,
    void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    if (k < 1 || k > topk::KMAX) return (int)cudaErrorInvalidValue;
    const bm25::Consts c{k1, omb, b, k1p1};
    const sharded::SelScratch sc{chunk_s, chunk_i, sel_s, sel_i};
    int rc = sharded::bm25_plane(block_docs, block_tfs, doc_lens, avgdl,
                                 block_idx, block_w, n_slots, nb, qb,
                                 n_docs_pad, 1, c, acc, stream);
    if (rc != 0) return rc;
    rc = sharded::global_topk<true, false>(acc, n_slots, n_docs_pad, 1, k, sc,
                                           branch_s, branch_i, nullptr,
                                           stream);
    if (rc != 0) return rc;
    rc = knn::sharded_scores(matrix, norms, valid, qvec, qn, q2, n_slots, 1,
                            dims, n_docs_pad, sim, plane, stream);
    if (rc != 0) return rc;
    rc = sharded::global_topk<false, false>(plane, n_slots, n_docs_pad, 1, k,
                                            sc, branch_s + k, branch_i + k,
                                            nullptr, stream);
    if (rc != 0) return rc;
    return sharded::rrf_fuse(branch_i, k, rank_constant, out_s, out_i,
                             stream);
}
