"""The BM25, kNN (masked and not), dense-collector, IVF, rank_features,
expansion-model, mesh (text, kNN and sparse) and sharded data plane
(rows 40-44) kernels on the card against their
plain PyTorch versions: bitwise, except where a kernel calls ``logf`` /
``powf`` / ``tanhf`` and its plain version torch's ``log`` / ``pow`` /
``tanh`` (the stated ulp bounds below). Needs a CUDA card and nvcc;
skipped without a card.

It imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.ops import bm25 as port
from elasticsearch_tpu_torch.ops import knn, topk
from elasticsearch_tpu_torch.ops.device_segment import quantize_rows
from torch_inputs import (
    FLAT, FLAT_ORDER, N_SEGS, make_inputs, make_knn_inputs,
    make_sparse_inputs, mesh_inputs, mesh_knn_inputs, mesh_sparse_inputs,
    row0, sharded_inputs, tx,
)

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


SPARSE_FUNCTIONS = {"saturation": (0.7, 1.0), "log": (1.5, 1.0),
                    "sigmoid": (1.2, 0.6), "linear": (1.0, 1.0)}
# log and sigmoid: the kernel's logf / powf and torch's CUDA log / pow may
# differ by an ulp in a contribution; a fixed-point sum of positive
# contributions keeps the largest relative error of its terms, so a score
# stays within 4 ulps (2^-21 relative)
SPARSE_RTOL = 2.0 ** -21


def assert_sparse_equal(got, want, exact: bool):
    for g, w in zip(got, want):
        if exact or not g.dtype.is_floating_point:
            assert torch.equal(g, w)
        else:
            assert torch.equal(torch.isfinite(g), torch.isfinite(w))
            fin = torch.isfinite(w)
            assert ((g[fin] - w[fin]).abs()
                    <= SPARSE_RTOL * w[fin].abs()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("function", sorted(SPARSE_FUNCTIONS))
def test_sparse_kernels_match_plain_versions_on_the_card(function):
    """sparse_flat (K15, counted and not), sparse_scores (K19, with and
    without a live mask), sparse_coarse (K16) and sparse_rerank (K17)
    against their plain versions over 150,000 docs (three 65,536-doc
    chunks: the merge pass runs), with -1 pads, weight-0 padding slots,
    pow2 padding rows and duplicated blocks (tied scores): bitwise for
    linear and saturation, within SPARSE_RTOL (ids exact) for log and
    sigmoid."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from elasticsearch_tpu_torch.ops import sparse
    inp = make_sparse_inputs(19, n_docs=150_000, nb=2048, n_q=5, per_q=300,
                             q_pad=8)
    # block 7: block 3's weights on the next docs, in one query at the same
    # weight -- docs with only these postings tie in pairs
    inp["docs"][7] = np.where(inp["docs"][3] >= 0, inp["docs"][3] + 1, -1)
    inp["weights"][7] = inp["weights"][3]
    inp["idx"][1, :2] = (3, 7)
    inp["qw"][1, 1] = inp["qw"][1, 0]
    docs, weights, idx, qw, live = [t.cuda() for t in tx(
        inp, "docs", "weights", "idx", "qw", "live")]
    n_pad = inp["n_pad"]
    pivot, exponent = SPARSE_FUNCTIONS[function]
    exact = function in ("saturation", "linear")
    for counted in (False, True):
        args = (docs, weights, idx, qw, pivot, exponent, live, n_pad, 100,
                function)
        assert_sparse_equal(sparse.sparse_topk_batch(*args, counted=counted),
                            sparse.sparse_flat_plain(*args, counted=counted),
                            exact)
    for lmask in (None, live):
        args = (docs, weights, idx[1], qw[1], pivot, exponent, n_pad,
                function, lmask)
        assert_sparse_equal([sparse.sparse_scores(*args)],
                            [sparse.sparse_scores_plain(*args)], exact)
    w16 = weights.to(torch.bfloat16)
    got = sparse.sparse_coarse_kernel(docs, w16, idx, qw, live, n_pad, 512)
    want = sparse.sparse_coarse_plain(docs, w16, idx, qw, live, n_pad, 512)
    assert_sparse_equal(got, want, True)
    cs, cand, _ = want
    got = sparse.sparse_rerank_kernel(docs, weights, idx, qw, live, cand, cs,
                                      n_pad, 512, 10)
    want = sparse.sparse_rerank_plain(docs, weights, idx, qw, live, cand, cs,
                                      n_pad, 512, 10)
    assert_sparse_equal(got, want, True)


# the forward's weights are anchors (2.0 a token) plus a normalized
# activation in [0, 1]: an ulp of tanhf against torch's tanh moves them
# by far less than 2^-20 (4 ulps at [2, 4))
FORWARD_ATOL = 2.0 ** -20


@pytest.mark.cuda
@pytest.mark.parametrize("width", ["default", "ragged"])
def test_text_expansion_forward_matches_plain_version_on_the_card(width):
    """text_expansion_forward (K18) against its plain version on the card:
    the default model's widths at B 64 and at B 13 (a partial row group),
    and a ragged narrow model (hidden 48, vocab 1,500: a partial column
    tile); texts with repeated tokens (anchors of 4.0) and an empty one.
    Feature ids exact, weights within FORWARD_ATOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from elasticsearch_tpu_torch.ml import text_expansion as te
    kw = {} if width == "default" else dict(vocab_size=1500, hidden=48,
                                            n_hash=4096)
    model = te.TextExpansionModel(model_id="cuda-" + width, device="cuda",
                                  **kw)
    gen = torch.Generator().manual_seed(23)
    texts = [" ".join(f"word{int(i)}" for i in torch.randint(
        0, 400, (int(n),), generator=gen))
        for n in torch.randint(3, 8, (62,), generator=gen)]
    texts += ["fox fox fox dog dog", ""]
    for b in (64, 13, 1):
        ids = torch.as_tensor(np.stack([model._featurize(t)[0]
                                        for t in texts[:b]]))
        direct = torch.as_tensor(np.stack([model._featurize(t)[1]
                                           for t in texts[:b]]))
        args = (ids.cuda(), direct.cuda(), model._emb, model._w1, model._w2,
                model.top_m)
        w, f = te.text_expansion_forward(*args)
        pw, pf = te.text_expansion_forward_plain(*args)
        assert torch.equal(f, pf)
        assert ((w - pw).abs() <= FORWARD_ATOL).all()


def _agg_inputs(seed: int, n: int, n_plans: int, lo: int, hi: int):
    rng = np.random.default_rng(seed)
    values = rng.integers(lo, hi, n).astype(np.int32)
    exists = rng.random(n) > 0.1
    values[~exists] = 0
    masks = rng.random((n_plans, n)) < rng.uniform(0.05, 1.0, (n_plans, 1))
    return values, exists, masks, rng


@pytest.mark.cuda
@pytest.mark.parametrize("n_plans,n_buckets", [(1, 8), (5, 256),
                                               (3, 20_000)])
def test_aggs_kernels_match_plain_versions_on_the_card(n_plans, n_buckets):
    """K20-K23 bitwise equal to their plain versions: negative values
    (floor division), buckets dropped at both ends, -1 padded ordinals,
    ordinals past the buckets, an interval-0 plan, and bucket sums far
    past 2^24, whose bits depend on the order of the adds (row order in
    both). n_buckets 20,000 takes the global-atomic count path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from elasticsearch_tpu_torch.ops import aggs
    n = 300_000
    values, exists, masks, rng = _agg_inputs(n_plans + n_buckets, n,
                                             n_plans, -9999, 1 << 23)
    intervals = rng.integers(1, 5000, n_plans).astype(np.int32)
    # plan 0's buckets cover every value: their sums pass 2^24
    intervals[0] = -(-((1 << 23) + 10_000) // (n_buckets - 2))
    if n_plans > 2:
        intervals[1] = 0
    bases = np.array([(-9999 // max(int(i), 1)) + 1 for i in intervals],
                     np.int32)
    C = lambda a: torch.as_tensor(a).cuda()  # noqa: E731
    cols = (C(values), C(exists), C(masks), C(bases), C(intervals))
    got = aggs.histogram_partials_plane(*cols, n_buckets)
    want = aggs.histogram_partials_plane_plain(*cols, n_buckets)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert float(want[1][0].abs().max()) > 2 ** 24
    for p in range(n_plans):
        if intervals[p] <= 0:
            continue
        one = aggs.histogram_partials(cols[0], cols[1], cols[2][p],
                                      int(bases[p]), int(intervals[p]),
                                      n_buckets)
        for g, w in zip(one, want):
            assert torch.equal(g, w[p])
    e = 200_000
    owners = np.sort(rng.integers(0, n, e)).astype(np.int32)
    ords = rng.integers(-1, n_buckets + 5, e).astype(np.int32)
    got = aggs.ordinal_counts_plane(C(ords), C(owners), cols[2], n_buckets)
    want = aggs.ordinal_counts_plane_plain(C(ords), C(owners), cols[2],
                                           n_buckets)
    assert torch.equal(got, want)
    one = aggs.ordinal_counts(C(ords), C(owners), cols[2][0], n_buckets)
    assert torch.equal(one, want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows,n_cols,k", [(1, 5000, 4097),
                                             (3, 300_000, 10_000),
                                             (64, 70_000, 4096),
                                             (2, 200_000, 12_289)])
def test_wide_selection_matches_plain_version_on_the_card(n_rows, n_cols, k):
    """The wide selection (rounds of at most 4,096 after a cursor) through
    dense_topk (K10), row by row, bitwise equal to a stable sort, with many
    equal scores and -inf slots."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    rng = np.random.default_rng(k)
    x = rng.integers(0, 300, (n_rows, n_cols)).astype(np.float32)
    x[x < 30] = -np.inf
    t = torch.as_tensor(x).cuda()
    for row in range(n_rows):
        s, d = topk.dense_topk(t[row], k)
        ws, wd = topk.dense_topk_plain(t[row], k)
        assert torch.equal(s, ws) and torch.equal(d, wd)


@pytest.mark.cuda
def test_selecting_families_at_windows_above_4096_on_the_card():
    """K1, K2 (counts from the first round only), K15 and K5 at k 5,000
    and 10,000: the rounds inside each family's launch give its plain
    version's ids, scores and counts bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from elasticsearch_tpu_torch.ops import sparse
    inp = make_inputs(12, n_docs=150_000, nb=2048, n_q=8, per_q=200)
    dev = [t.cuda() for t in tx(inp, *FLAT, "seg")]
    n_pad, n_q, n_segs = inp["n_pad"], inp["n_q"], inp["n_segs"]
    sp = make_sparse_inputs(19, n_docs=150_000, nb=2048, n_q=5, per_q=300,
                            q_pad=8)
    sdev = [t.cuda() for t in tx(sp, "docs", "weights", "idx", "qw", "live")]
    m, norms, exists, live, q = make_knn_inputs(13, 16, 4, "int", 200_000,
                                                262_144)
    T = lambda a: torch.as_tensor(a).cuda()  # noqa: E731
    batch = knn.QueryBatch(q, "cuda")
    kargs = (T(m), T(norms), T(live & exists), batch.queries, batch.qn,
             batch.q2)
    for k in (5000, 10_000):
        pairs = [
            (port.bm25_flat(*dev[:8], n_pad, n_q, k, counted=True),
             port.bm25_flat_plain(*dev[:8], n_pad, n_q, k, counted=True)),
            (port.bm25_flat_seg(*dev, n_pad, n_q, k, n_segs=n_segs),
             port.bm25_flat_seg_plain(*dev, n_pad, n_q, k, n_segs=n_segs)),
            (sparse.sparse_topk_batch(*sdev[:4], 1.0, 1.0, sdev[4],
                                      sp["n_pad"], k, "saturation",
                                      counted=True),
             sparse.sparse_flat_plain(*sdev[:4], 1.0, 1.0, sdev[4],
                                      sp["n_pad"], k, "saturation",
                                      counted=True)),
            (knn.knn_flat(*kargs, k, "cosine"),
             knn.knn_flat_plain(*kargs, k, "cosine")),
        ]
        for got, want in pairs:
            for g, w in zip(got, want):
                assert torch.equal(g, w)


def _rrf_lists(seed: int, b: int, r: int, k: int, n_docs: int):
    rng = np.random.default_rng(seed)
    out = rng.integers(0, n_docs, (b, r, k)).astype(np.int32)
    out[rng.random((b, r, k)) < 0.15] = -1
    out[rng.random((b, r, k)) < 0.03] = n_docs + 5     # dropped
    out[:, 0, 3] = out[:, 0, 4] = 2                   # repeated in a list
    return torch.as_tensor(out)


@pytest.mark.cuda
@pytest.mark.parametrize("b,r,k_list,n_pad,k", [
    (1, 2, 8, 16, 16), (64, 2, 128, 256, 256), (7, 3, 64, 128, 100),
    (3, 4, 4096, 16384, 2000)],
    ids=["tiny", "main_path", "r3", "global_scratch"])
def test_rrf_fuse_batch_matches_plain_version_on_the_card(b, r, k_list,
                                                          n_pad, k):
    """K24 bitwise equal to its plain version: ids, -1 past the matches,
    score bits; the last case's work arrays live in global scratch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from elasticsearch_tpu_torch.ops import fusion
    lists = _rrf_lists(b * r + k, b, r, k_list, n_pad - 8).cuda()
    got = fusion.rrf_fuse_batch(lists, n_pad, k, 60)
    want = fusion.rrf_fuse_batch_plain(lists, n_pad, k, 60)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n_pad,k", [(64, 64), (4_194_304, 300)],
                         ids=["whole_row", "wide_pad"])
def test_rrf_fuse_tail_matches_plain_version_on_the_card(n_pad, k):
    """K24 at B 1 with row 28's unscored tail."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from elasticsearch_tpu_torch.ops import fusion
    lists = _rrf_lists(n_pad, 1, 2, 128, min(n_pad, 50_000) - 8)[0].cuda()
    got = fusion.rrf_fuse(lists, n_pad, k, 60)
    want = fusion.rrf_fuse_plain(lists, n_pad, k, 60)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("r,n,k,normalize", [
    (2, 1000, 10, True), (3, 200_000, 4097, True), (2, 65_537, 10, False)],
    ids=["small", "wide_k", "raw"])
def test_linear_fuse_matches_plain_version_on_the_card(r, n, k, normalize):
    """K25 bitwise equal to its plain version (one rounded f32 op at a
    time on both sides), any k."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from elasticsearch_tpu_torch.ops import fusion
    rng = np.random.default_rng(r * n + k)
    scores = rng.gamma(2.0, 1.5, (r, n)).astype(np.float32)
    scores[rng.random((r, n)) < 0.3] = 0.0
    scores[rng.random((r, n)) < 0.05] *= -1.0
    args = (torch.as_tensor(scores).cuda(),
            torch.as_tensor(rng.uniform(0.1, 2, r).astype(np.float32)).cuda(),
            torch.as_tensor(rng.random(n) > 0.1).cuda())
    got = fusion.linear_fuse(*args, k, normalize)
    want = fusion.linear_fuse_plain(*args, k, normalize)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


RERANK_ORDER = ("docs", "tfs", "idx", "w", "q", "avg", "dl", "live")


def _on_card(inp, names, bf16=()):
    out = []
    for n in names:
        t = torch.as_tensor(inp[n]).cuda()
        out.append(t.to(torch.bfloat16) if n in bf16 else t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("n_slots,dp,empty,one_seg,n_docs",
                         [(2, 1, -1, -1, 3000), (4, 2, 2, 1, 3000),
                          (4, 1, 3, 0, 150_000)],
                         ids=["s2", "s4_dp2_empty_one_segment",
                              "s4_chunked"])
def test_mesh_kernels_match_plain_versions_on_the_card(n_slots, dp, empty,
                                                       one_seg, n_docs):
    """mesh_bm25_flat / _coarse / _rerank bitwise equal to their plain
    versions, and each slot bitwise equal to K2 / K3 / K4 launched on that
    slot's plane (the chunked case takes the top-k's merge pass)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from elasticsearch_tpu_torch.parallel import mesh
    n_q, kprime = 4, 256
    inp = mesh_inputs(90 + n_slots + dp, n_slots, dp, n_q, empty=empty,
                      one_seg=one_seg, n_docs=n_docs)
    n_pad = inp["n_pad"]
    flat = _on_card(inp, FLAT_ORDER)
    got = mesh.mesh_bm25_flat(*flat, n_pad, n_q, K, N_SEGS)
    want = mesh.mesh_bm25_flat_plain(*flat, n_pad, n_q, K, N_SEGS)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    r0 = row0(inp)
    q16 = _on_card(r0, FLAT_ORDER, bf16=("tfs", "dl"))
    cgot = mesh.mesh_bm25_coarse(*q16, n_pad, n_q, kprime, N_SEGS)
    cwant = mesh.mesh_bm25_coarse_plain(*q16, n_pad, n_q, kprime, N_SEGS)
    for g, w in zip(cgot, cwant):
        assert torch.equal(g, w)
    rr = _on_card(r0, RERANK_ORDER)
    rgot = mesh.mesh_bm25_rerank(*rr, cgot[1], cgot[0], n_pad, n_q, kprime,
                                 K)
    rwant = mesh.mesh_bm25_rerank_plain(*rr, cgot[1], cgot[0], n_pad, n_q,
                                        kprime, K)
    for g, w in zip(rgot, rwant):
        assert torch.equal(g, w)
    f = dict(zip(FLAT_ORDER, flat))
    c = dict(zip(FLAT_ORDER, q16))
    r = dict(zip(RERANK_ORDER, rr))
    for si in range(n_slots):
        for row in range(dp):
            k2 = port.bm25_flat_seg(
                f["docs"][si], f["tfs"][si], f["idx"][si, row],
                f["w"][si, row], f["q"][si, row], f["dl"][si],
                f["avg"][si, row], f["live"][si], f["seg"][si], n_pad, n_q,
                K, n_segs=N_SEGS)
            for g, w in zip((x[si, row] for x in got), k2):
                assert torch.equal(g, w)
        k3 = port.bm25_coarse(
            c["docs"][si], c["tfs"][si], c["idx"][si], c["w"][si],
            c["q"][si], c["dl"][si], c["avg"][si], c["live"][si],
            c["seg"][si], n_pad, n_q, N_SEGS, kprime)
        for g, w in zip((x[si] for x in cgot), k3):
            assert torch.equal(g, w)
        k4 = port.bm25_rerank(
            r["docs"][si], r["tfs"][si], r["idx"][si], r["w"][si],
            r["q"][si], r["dl"][si], r["avg"][si], r["live"][si],
            cgot[1][si].contiguous(), cgot[0][si].contiguous(), n_pad, n_q,
            kprime, K)
        for g, w in zip((x[si] for x in rgot), k4):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("sim", ["cosine", "dot_product", "l2_norm"])
@pytest.mark.parametrize("n_slots,empty,n_docs,k",
                         [(2, -1, 900, K), (4, 2, 150_000, K),
                          (2, -1, 9000, 5000)],
                         ids=["s2", "s4_empty_chunked", "s2_wide_k"])
def test_mesh_knn_kernels_match_plain_versions_on_the_card(n_slots, empty,
                                                           n_docs, k, sim,
                                                           masked):
    """mesh_knn_topk / _coarse / _rerank bitwise equal to their plain
    versions, and each slot bitwise equal to K5 / K6 / K7 launched on that
    slot's plane (chunked planes take the top-k's merge pass, k 5,000 its
    rounds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from elasticsearch_tpu_torch.parallel import mesh
    n_q, kprime = 4, 256
    inp = mesh_knn_inputs(70 + n_slots, n_slots, n_q, kind="gauss",
                          empty=empty, n_docs=n_docs)
    m, nr, al, qs = (torch.as_tensor(inp[x]).cuda()
                     for x in ("matrix", "norms", "allowed", "queries"))
    mk = torch.as_tensor(inp["masks"]).cuda() if masked else None
    s_, n_pad, dims = m.shape
    q8, scales = quantize_rows(inp["matrix"].reshape(s_ * n_pad, dims))
    q8 = torch.as_tensor(q8.reshape(s_, n_pad, dims)).cuda()
    scales = torch.as_tensor(scales.reshape(s_, n_pad)).cuda()
    batch = knn.QueryBatch(inp["queries"], "cuda")
    qq, qscale = batch.quantized()
    qn, q2 = batch.qn, batch.q2
    got = mesh.mesh_knn_topk(m, nr, al, qs, qn, q2, k, sim, mk)
    want = mesh.mesh_knn_topk_plain(m, nr, al, qs, qn, q2, k, sim, mk)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    cgot = mesh.mesh_knn_coarse(q8, scales, nr, al, qq, qscale, qn, q2,
                                kprime, sim, mk)
    cwant = mesh.mesh_knn_coarse_plain(q8, scales, nr, al, qq, qscale, qn,
                                       q2, kprime, sim, mk)
    for g, w in zip(cgot, cwant):
        assert torch.equal(g, w)
    rgot = mesh.mesh_knn_rerank(m, nr, al, qs, qn, q2, cgot[1], cgot[0], K,
                                sim, mk)
    rwant = mesh.mesh_knn_rerank_plain(m, nr, al, qs, qn, q2, cgot[1],
                                       cgot[0], K, sim, mk)
    for g, w in zip(rgot, rwant):
        assert torch.equal(g, w)
    for si in range(n_slots):
        mks = None if mk is None else mk[si]
        k5 = knn.knn_flat(m[si], nr[si], al[si], qs, qn, q2, k, sim, mks)
        for g, w in zip((x[si] for x in got), k5):
            assert torch.equal(g, w)
        k6 = knn.knn_coarse(q8[si], scales[si], nr[si], al[si], qq, qscale,
                            qn, q2, kprime, sim, mks)
        for g, w in zip((x[si] for x in cgot), k6):
            assert torch.equal(g, w)
        k7 = knn.knn_rerank(m[si], nr[si], al[si], qs, qn, q2,
                            cgot[1][si].contiguous(),
                            cgot[0][si].contiguous(), K, sim, mks)
        for g, w in zip((x[si] for x in rgot), k7):
            assert torch.equal(g, w)
    if empty >= 0:
        assert not torch.isfinite(got[0][empty]).any()
        assert (rgot[1][empty] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n_slots,dp,empty,n_docs,k",
                         [(2, 1, -1, 3000, K), (4, 2, 2, 150_000, K),
                          (2, 1, -1, 12_000, 5000)],
                         ids=["s2", "s4_dp2_empty_chunked", "s2_wide_k"])
def test_mesh_sparse_kernels_match_plain_versions_on_the_card(n_slots, dp,
                                                              empty, n_docs,
                                                              k):
    """mesh_sparse_topk / _coarse / _rerank bitwise equal to their plain
    versions, and each slot bitwise equal to K15 / K16 / K17 launched on
    that slot's plane (chunked planes take the top-k's merge pass, k 5,000
    its rounds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from elasticsearch_tpu_torch.ops import sparse
    from elasticsearch_tpu_torch.parallel import mesh
    n_q, kprime = 4, 256
    inp = mesh_sparse_inputs(90 + n_slots, n_slots, dp, n_q, per_q=40,
                             empty=empty, n_docs=n_docs)
    n_pad = inp["n_pad"]
    docs, w, live, idx4, qw4 = (torch.as_tensor(inp[x]).cuda() for x in (
        "docs", "weights", "live", "idx", "qw"))
    w16 = w.to(torch.bfloat16)
    idx, qw = idx4[:, 0].contiguous(), qw4[:, 0].contiguous()
    got = mesh.mesh_sparse_topk(docs, w, idx4, qw4, live, n_pad, k)
    want = mesh.mesh_sparse_topk_plain(docs, w, idx4, qw4, live, n_pad, k)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    cgot = mesh.mesh_sparse_coarse(docs, w16, idx, qw, live, n_pad, kprime)
    cwant = mesh.mesh_sparse_coarse_plain(docs, w16, idx, qw, live, n_pad,
                                          kprime)
    for g, x in zip(cgot, cwant):
        assert torch.equal(g, x)
    rgot = mesh.mesh_sparse_rerank(docs, w, idx, qw, live, cgot[1], cgot[0],
                                   n_pad, kprime, K)
    rwant = mesh.mesh_sparse_rerank_plain(docs, w, idx, qw, live, cgot[1],
                                          cgot[0], n_pad, kprime, K)
    for g, x in zip(rgot, rwant):
        assert torch.equal(g, x)
    for si in range(n_slots):
        for r in range(dp):
            k15 = sparse.sparse_topk_batch(
                docs[si], w[si], idx4[si, r].contiguous(),
                qw4[si, r].contiguous(), 1.0, 1.0, live[si], n_pad, k,
                "linear", counted=True)
            for g, x in zip((t[si, r] for t in got), k15):
                assert torch.equal(g, x)
        k16 = sparse.sparse_coarse_kernel(docs[si], w16[si], idx[si],
                                          qw[si], live[si], n_pad, kprime)
        for g, x in zip((t[si] for t in cgot), k16):
            assert torch.equal(g, x)
        k17 = sparse.sparse_rerank_kernel(
            docs[si], w[si], idx[si], qw[si], live[si],
            cgot[1][si].contiguous(), cgot[0][si].contiguous(), n_pad,
            kprime, K)
        for g, x in zip((t[si] for t in rgot), k17):
            assert torch.equal(g, x)
    if empty >= 0:
        assert not torch.isfinite(got[0][empty]).any()
        assert int(got[2][empty].sum()) == 0


def _sharded_on_card(inp):
    names = ("block_docs", "block_tfs", "doc_lens", "bm25_idx", "bm25_w",
             "matrix", "norms", "valid", "queries", "qn", "q2",
             "block_weights", "sparse_idx", "sparse_w")
    return {n: torch.as_tensor(np.ascontiguousarray(inp[n])).cuda()
            for n in names}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int", "gauss"])
@pytest.mark.parametrize("n_slots,n_docs", [(2, 600), (4, 900), (8, 70_000)],
                         ids=["s2", "s4", "s8_two_chunks"])
def test_sharded_kernels_match_plain_versions_on_the_card(n_slots, n_docs,
                                                          kind):
    """Rows 40-44 (parallel/sharded_search.py) bitwise against their plain
    versions on the card: the three similarities, Q 1 and 4, counted and
    not, k 10 and k past the whole slot space (padding), a few matches
    (-1 ids in the fusion)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from elasticsearch_tpu_torch.parallel import sharded_search as sh
    inp = sharded_inputs(60 + n_slots, n_slots, n_docs=n_docs, kind=kind)
    d = _sharded_on_card(inp)
    n = inp["n_per_shard"]
    avg = inp["avgdl"]

    def same(got, want):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    for k in (10, n_slots * n + 5):
        for sim in ("cosine", "dot_product", "l2_norm"):
            args = (d["matrix"], d["norms"], d["valid"], d["queries"],
                    d["qn"], d["q2"], k, sim)
            same(sh.sharded_knn(*args), sh.sharded_knn_plain(*args))
        idx0 = d["bm25_idx"][:, 0].contiguous()
        w0 = d["bm25_w"][:, 0].contiguous()
        args = (d["block_docs"], d["block_tfs"], d["doc_lens"], avg, idx0,
                w0, k)
        same(sh.sharded_bm25(*args), sh.sharded_bm25_plain(*args))
        for counted in (False, True):
            args = (d["block_docs"], d["block_tfs"], d["doc_lens"], avg,
                    d["bm25_idx"], d["bm25_w"], k)
            same(sh.sharded_bm25_batch(*args, counted=counted),
                 sh.sharded_bm25_batch_plain(*args, counted=counted))
        args = (d["block_docs"], d["block_weights"], d["sparse_idx"],
                d["sparse_w"], n, k)
        same(sh.sharded_sparse(*args), sh.sharded_sparse_plain(*args))
    few = torch.zeros_like(w0)
    few[0, 0] = w0[0, 0]
    for w in (w0, few):
        for sim in ("cosine", "l2_norm"):
            args = (d["block_docs"], d["block_tfs"], d["doc_lens"], avg,
                    idx0, w, d["matrix"], d["norms"], d["valid"],
                    d["queries"][0], d["qn"][:1], d["q2"][:1], 10)
            same(sh.sharded_hybrid(*args, similarity=sim),
                 sh.sharded_hybrid_plain(*args, similarity=sim))
