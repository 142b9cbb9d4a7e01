"""The BM25, kNN (masked and not), dense-collector and IVF kernels on the
card, bitwise against their plain PyTorch versions. Needs a CUDA card and nvcc; skipped without
a card.

It imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda
"""

import pytest
import torch

from elasticsearch_tpu_torch.ops import bm25 as port
from elasticsearch_tpu_torch.ops import knn, topk
from elasticsearch_tpu_torch.ops.device_segment import quantize_rows
from torch_inputs import FLAT, make_inputs, make_knn_inputs, tx

K = 10


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    """On the card every family is bitwise equal to its plain version,
    at a shape that takes the chunked top-k's merge pass."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    inp = make_inputs(12, n_docs=150_000, nb=2048, n_q=8, per_q=200)
    cpu = tx(inp, *FLAT, "seg")
    dev = [t.cuda() for t in cpu]
    n_pad, n_q, n_segs = inp["n_pad"], inp["n_q"], inp["n_segs"]
    for counted in (False, True):
        got = port.bm25_flat(*dev[:8], n_pad, n_q, K, counted=counted)
        want = port.bm25_flat_plain(*dev[:8], n_pad, n_q, K, counted=counted)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    got = port.bm25_flat_seg(*dev, n_pad, n_q, K, n_segs=n_segs)
    want = port.bm25_flat_seg_plain(*dev, n_pad, n_q, K, n_segs=n_segs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    q16 = list(dev)
    q16[1] = q16[1].to(torch.bfloat16)
    q16[5] = q16[5].to(torch.bfloat16)
    got = port.bm25_coarse(*q16, n_pad, n_q, n_segs, 256)
    want = port.bm25_coarse_plain(*q16, n_pad, n_q, n_segs, 256)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    got = port.bm25_rerank(*dev[:8], want[1], want[0], n_pad, n_q, 256, K)
    want = port.bm25_rerank_plain(*dev[:8], want[1], want[0], n_pad, n_q,
                                  256, K)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dims,n_q", [(128, 8), (960, 3), (5, 1)])
@pytest.mark.parametrize("sim", ["cosine", "dot_product", "l2_norm"])
def test_knn_kernels_match_plain_versions_on_the_card(dims, n_q, sim):
    """knn_flat, knn_coarse and knn_rerank bitwise equal to their plain
    versions over 200,000 docs (four 65,536-doc chunks: the merge pass
    runs), with dead docs, missing vectors, ties and a zero query row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    m, norms, exists, live, q = make_knn_inputs(
        13, dims, n_q, "gauss", 200_000, 262_144)
    q8, scales = quantize_rows(m)
    T = lambda a: torch.as_tensor(a).cuda()  # noqa: E731
    m, norms, allowed = T(m), T(norms), T(live & exists)
    q8, scales = T(q8), T(scales)
    batch = knn.QueryBatch(q, "cuda")
    qq, qscale = batch.quantized()
    args = (m, norms, allowed, batch.queries, batch.qn, batch.q2)
    for g, w in zip(knn.knn_flat(*args, 100, sim),
                    knn.knn_flat_plain(*args, 100, sim)):
        assert torch.equal(g, w)
    cargs = (q8, scales, norms, allowed, qq, qscale, batch.qn, batch.q2)
    got = knn.knn_coarse(*cargs, 512, sim)
    want = knn.knn_coarse_plain(*cargs, 512, sim)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    cs, cand = want
    got = knn.knn_rerank(*args, cand, cs, 10, sim)
    want = knn.knn_rerank_plain(*args, cand, cs, 10, sim)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("sim", ["cosine", "dot_product", "l2_norm"])
def test_dense_kernels_match_plain_versions_on_the_card(sim):
    """bm25_scores (K8), knn_scores (K9) and dense_topk (K10) bitwise equal
    to their plain versions, at rows long enough for K10's merge pass,
    with -1 pads, dead docs, missing vectors and tied scores."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    inp = make_inputs(14, n_docs=150_000, nb=2048, n_q=1, per_q=900)
    docs, tfs, idx, w, _q, dl, _avg, live = [t.cuda() for t in tx(inp, *FLAT)]
    n_pad = inp["n_pad"]
    for lmask in (None, live):
        args = (docs, tfs, idx, w, dl, 47.5, n_pad, lmask)
        assert torch.equal(port.bm25_block_scores(*args),
                           port.bm25_block_scores_plain(*args))
    m, norms, exists, live_v, q = make_knn_inputs(
        15, 128, 1, "gauss", 200_000, 262_144)
    T = lambda a: torch.as_tensor(a).cuda()  # noqa: E731
    batch = knn.QueryBatch(q, "cuda")
    args = (T(m), T(norms), T(exists), batch.queries[0], batch.qn, batch.q2,
            sim)
    row = knn.vector_scores(*args)
    assert torch.equal(row, knn.vector_scores_plain(*args))
    scores = torch.where(T(live_v) & T(exists), row, -torch.inf)
    for x in (scores, torch.ones_like(scores), torch.full_like(
            scores, -torch.inf)):
        for k in (1, 10, 4096):
            for g, w_ in zip(topk.dense_topk(x, k),
                             topk.dense_topk_plain(x, k)):
                assert torch.equal(g, w_)


@pytest.mark.cuda
@pytest.mark.parametrize("sim", ["cosine", "dot_product", "l2_norm"])
def test_masked_knn_kernels_match_plain_versions_on_the_card(sim):
    """knn_flat, knn_coarse and knn_rerank with a per-query mask stack
    (an all-False row, pow2 padding rows) bitwise equal to their plain
    versions, and each masked row to the unmasked kernel on allowed &
    that row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    m, norms, exists, live, q = make_knn_inputs(
        16, 128, 5, "gauss", 200_000, 262_144)
    q8, scales = quantize_rows(m)
    T = lambda a: torch.as_tensor(a).cuda()  # noqa: E731
    m, norms, allowed = T(m), T(norms), T(live & exists)
    q8, scales = T(q8), T(scales)
    batch = knn.QueryBatch(q, "cuda")
    gen = torch.Generator().manual_seed(17)
    rows = torch.rand(5, 262_144, generator=gen) < 0.05
    rows[0] = False
    masks = T(knn.pad_mask_rows_pow2(rows.numpy(), 8))
    qq, qscale = batch.quantized()
    args = (m, norms, allowed, batch.queries, batch.qn, batch.q2)
    flat = knn.knn_flat(*args, 100, sim, masks)
    for g, w in zip(flat, knn.knn_flat_plain(*args, 100, sim, masks)):
        assert torch.equal(g, w)
    cargs = (q8, scales, norms, allowed, qq, qscale, batch.qn, batch.q2)
    coarse = knn.knn_coarse(*cargs, 512, sim, masks)
    for g, w in zip(coarse, knn.knn_coarse_plain(*cargs, 512, sim, masks)):
        assert torch.equal(g, w)
    cs, cand = coarse
    rerank = knn.knn_rerank(*args, cand, cs, 10, sim, masks)
    for g, w in zip(rerank, knn.knn_rerank_plain(*args, cand, cs, 10, sim,
                                                 masks)):
        assert torch.equal(g, w)
    for r in (0, 3, 7):
        one = (m, norms, allowed & masks[r], batch.queries[r:r + 1],
               batch.qn[r:r + 1], batch.q2[r:r + 1])
        for g, w in zip(knn.knn_flat(*one, 100, sim), flat):
            assert torch.equal(g, w[r:r + 1])
        for g, w in zip(knn.knn_rerank(*one, cand[r:r + 1], cs[r:r + 1], 10,
                                       sim), rerank):
            assert torch.equal(g, w[r:r + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [16, 100, 960])
def test_ivf_kernels_match_plain_versions_on_the_card(dims):
    """ivf_assign, ivf_update, ivf_init and ivf_search (three similarities,
    nprobe 1..nlist) bitwise equal to their plain versions, with tied
    rows and centroids, dropped ids and an empty cluster."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from elasticsearch_tpu_torch.ops import ivf
    gen = torch.Generator().manual_seed(18 + dims)
    x = torch.randn(6000, dims, generator=gen)
    x[7] = x[3]
    cents = x[torch.randperm(6000, generator=gen)[:90]].clone()
    cents[5] = cents[2]
    x, cents = x.cuda(), cents.cuda()
    a = ivf.ivf_assign(x, cents)
    assert torch.equal(a, ivf.ivf_assign_plain(x, cents))
    assert not (a == 5).any()
    a[:4] = -1
    assert torch.equal(ivf.ivf_update(x, a, cents),
                       ivf.ivf_update_plain(x, a, cents))
    assert torch.equal(ivf.ivf_init(x, 3, 70), ivf.ivf_init_plain(x, 3, 70))
    for sim in ("cosine", "dot_product", "l2_norm"):
        index = ivf.IVFIndex.build(x.cpu().numpy(), nlist=40, similarity=sim,
                                   device="cuda")
        batch = knn.QueryBatch(x[:9].cpu().numpy() + 0.1, "cuda")
        for nprobe in (1, 5, 40):
            k = min(50, nprobe * index.list_len)
            args = (batch.queries, batch.qn, batch.q2, index.centroids,
                    index.lists, index.valid, index.ids, index.norms)
            for g, w in zip(ivf.ivf_search(*args, k, nprobe, sim),
                            ivf.ivf_search_plain(*args, k, nprobe, sim)):
                assert torch.equal(g, w)
