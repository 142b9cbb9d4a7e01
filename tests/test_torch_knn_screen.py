"""The card's K5 / K6 method in plain PyTorch, on the CPU: K5's bf16
screen with its proven bound and exact re-score (``ops/knn.py``
``screen_bounds`` / ``screen_candidates`` / ``knn_flat_screened``), K6's
listing over its exact coarse plane (``knn_coarse_listed``), the tile
threshold both take (``tile_threshold``) and the row-batched selection's
keys (``ops/topk.py`` ``rows_topk_by_keys``).

The screen is fed dots summed in other orders than the plain version's
(reversed, pairwise, f32 partials of 16, and a simulated tensor-core
accumulation that aligns each group of 16 products and the running sum
to the largest exponent, truncates them to 24 bits and truncates the sum
to f32): every plain score must lie in [lo, hi] bit for bit, and the
answer must be ``knn_flat_plain``'s bits (and the JAX ``knn_topk_batch``'s
ids: equal on integer vectors, where every sum is exact; on Gaussian
ones wherever neighbouring scores are further apart than rtol 4e-6, the
tolerance of ``test_torch_knn.py`` and ROADMAP queue 3 item 1). Inputs:
Gaussian rows; SIFT-like integers 0-255 with duplicated rows (exact ties
across docs); a zero query; zero-norm docs; masks leaving fewer than k
docs and an all-false padded row. D 5, 100, 128 and 960; k 10, 100,
1,024 and 4,500 (above 4,096, at small N).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elasticsearch_tpu.ops import knn as ref

from elasticsearch_tpu_torch.ops import knn as port
from elasticsearch_tpu_torch.ops import topk
from elasticsearch_tpu_torch.ops.bm25 import stable_topk
from elasticsearch_tpu_torch.ops.device_segment import quantize_rows
from torch_inputs import close_ids

RTOL = 4e-6
SIMS = ("cosine", "dot_product", "l2_norm")
ORDERS = ("reversed", "pairwise", "partials16", "truncating")
T = torch.as_tensor


def inputs(seed: int, kind: str, dims: int, n_docs: int, n_pad: int,
           n_q: int):
    """(matrix, norms, allowed, queries): Gaussian or SIFT-like rows
    (integers 0-255, every seventh row a copy of the one before: exact
    ties), ~10 % of docs not allowed, two zero-norm docs (allowed), padded
    rows past n_docs, and a zero last query."""
    rng = np.random.default_rng(seed)
    if kind == "sift":
        m = rng.integers(0, 256, (n_pad, dims)).astype(np.float32)
        q = rng.integers(0, 256, (n_q, dims)).astype(np.float32)
        m[1::7] = m[0::7][: len(m[1::7])]
    else:
        m = rng.standard_normal((n_pad, dims)).astype(np.float32)
        q = rng.standard_normal((n_q, dims)).astype(np.float32)
    m[n_docs:] = 0.0
    m[[3, 9]] = 0.0
    allowed = np.zeros(n_pad, bool)
    allowed[:n_docs] = rng.random(n_docs) > 0.1
    allowed[[3, 9]] = True
    q[-1] = 0.0
    norms = np.linalg.norm(m, axis=1).astype(np.float32)
    return m, norms, allowed, q


def _truncate_f32(s: np.ndarray) -> np.ndarray:
    """f64 -> the f32 nearest zero (truncation)."""
    r = s.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(s)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def dots_in_order(matrix, queries, order: str) -> torch.Tensor:
    """[B, N] f32 dots of the bf16-rounded operands summed in ``order``."""
    qb = port._bf16(queries)
    mb = port._bf16(matrix)
    p = qb[:, None, :] * mb[None, :, :]         # exact products, [B, N, D]
    dims = p.shape[2]
    if order == "reversed":
        acc = torch.zeros(p.shape[:2])
        for d in reversed(range(dims)):
            acc = acc + p[:, :, d]
        return acc
    if order == "pairwise":
        x = p
        while x.shape[2] > 1:
            if x.shape[2] % 2:
                x = torch.cat([x, torch.zeros(*x.shape[:2], 1)], dim=2)
            x = x[:, :, 0::2] + x[:, :, 1::2]
        return x[:, :, 0].contiguous()
    if order == "partials16":
        acc = torch.zeros(p.shape[:2])
        for g in range(0, dims, 16):
            part = torch.zeros(p.shape[:2])
            for d in range(g, min(g + 16, dims)):
                part = part + p[:, :, d]
            acc = acc + part
        return acc
    # the tensor cores: a group of 16 products and the running sum aligned
    # to the largest exponent, truncated to 24 bits, summed, truncated
    p64 = p.double().numpy()
    acc = np.zeros(p.shape[:2])
    for g in range(0, dims, 16):
        terms = np.concatenate([acc[:, :, None], p64[:, :, g:g + 16]], axis=2)
        _, ex = np.frexp(np.abs(terms).max(axis=2))
        ulp = np.ldexp(1.0, ex - 24)[:, :, None]
        acc = _truncate_f32((np.trunc(terms / ulp) * ulp).sum(axis=2))
        acc = acc.astype(np.float64)
    return T(acc.astype(np.float32))


def batch_of(q):
    b = port.QueryBatch(q, "cpu")
    assert b.n_real == b.queries.shape[0], "pick a pow2 query count"
    return b


def exact_scores(m, norms, allowed, batch, sim, masks=None):
    s = port._similarity(port._flat_dots(m, batch.queries), norms[None, :],
                         batch.qn, batch.q2, sim)
    return torch.where(port._row_mask(allowed, masks), s, port._neg_inf(s))


def same_bits(got, want):
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


SCREEN_CASES = [(kind, dims, order) for kind in ("gauss", "sift")
                for dims in (5, 100, 128, 960) for order in ORDERS]


@pytest.mark.parametrize("kind,dims,order", SCREEN_CASES,
                         ids=["-".join(map(str, c)) for c in SCREEN_CASES])
def test_screen_keeps_every_winner(kind, dims, order):
    """Every plain score lies within the screen's [lo, hi] for dots summed
    in another order (the observed error under gamma), and the screened
    answer is ``knn_flat_plain``'s, bit for bit, at k 10 and 100."""
    m, norms, allowed, q = inputs(1, kind, dims, 1900, 2048, 8)
    m, norms, allowed = T(m), T(norms), T(allowed)
    b = batch_of(q)
    dots = dots_in_order(m, b.queries, order)
    plain = port._flat_dots(m, b.queries)
    err = (dots - plain).abs() / (port.screen_norms(b.queries)[:, None]
                                  * port.screen_norms(m)[None, :])
    assert float(err.nan_to_num(0.0).max()) <= port.screen_gamma(dims)
    for sim in SIMS:
        lo, hi = port.screen_bounds(dots, m, norms, allowed, b.queries, b.qn,
                                    b.q2, sim)
        exact = exact_scores(m, norms, allowed, b, sim)
        assert bool(((lo <= exact) & (exact <= hi)).all())
        for k in (10, 100):
            got = port.knn_flat_screened(dots, m, norms, allowed, b.queries,
                                         b.qn, b.q2, k, sim)
            want = port.knn_flat_plain(m, norms, allowed, b.queries, b.qn,
                                       b.q2, k, sim)
            same_bits(got[:2], want)
            # only the zero query's rows may need the whole row (its
            # scores tie across every doc)
            assert not bool(got[2][:-1].any())


REF_CASES = [(kind, dims, sim) for kind in ("gauss", "sift")
             for dims in (5, 100, 128, 960) for sim in SIMS]


@pytest.mark.parametrize("kind,dims,sim", REF_CASES,
                         ids=["-".join(map(str, c)) for c in REF_CASES])
def test_screen_matches_knn_topk_batch(kind, dims, sim):
    """The screened answer (tensor-core-like dots) against the JAX
    ``knn_topk_batch``: ids and scores equal on integer vectors whose sums
    stay below 2^24 (exact in any order); elsewhere scores within RTOL
    scaled by D / 128 and ids equal wherever neighbours are further apart
    than that."""
    m, norms, allowed, q = inputs(2, kind, dims, 1500, 1536, 4)
    b = batch_of(q)
    exists = np.ones(len(m), bool)
    rs, rd = ref.knn_topk_batch(jnp.asarray(m), jnp.asarray(norms),
                                jnp.asarray(exists), jnp.asarray(allowed),
                                jnp.asarray(b.host), 10, sim)
    mt, nt, at = T(m), T(norms), T(allowed)
    dots = dots_in_order(mt, b.queries, "truncating")
    ps, pd, _ = port.knn_flat_screened(dots, mt, nt, at, b.queries, b.qn,
                                       b.q2, 10, sim)
    rs, rd, ps, pd = map(np.asarray, (rs, rd, ps, pd))
    np.testing.assert_array_equal(np.isfinite(ps), np.isfinite(rs))
    if kind == "sift" and dims <= 128:
        # integer products summing below 2^24: exact in any order
        np.testing.assert_array_equal(ps, rs)
        np.testing.assert_array_equal(pd, rd)
    else:
        # RTOL is the re-association bound of 128 terms; it grows with D
        rtol = RTOL * max(1.0, dims / 128)
        fin = np.isfinite(rs)
        np.testing.assert_allclose(ps[fin], rs[fin], rtol=rtol)
        close_ids(rs, rd, pd, rtol)


@pytest.mark.parametrize("sim", SIMS)
def test_screen_masks_take_the_exact_branch(sim):
    """A mask row leaving fewer than k docs and an all-false padded row
    go to the exact branch (tau is -inf), a 1-in-5 filter and an
    unfiltered row do not; every row is the masked plain version's, and
    its ids are the JAX ``knn_topk_batch_masked``'s (integer vectors)."""
    m, norms, allowed, q = inputs(3, "sift", 100, 3000, 3072, 4)
    rng = np.random.default_rng(4)
    masks = np.ones((4, len(m)), bool)
    masks[0] = False
    masks[0, [5, 70, 900]] = True          # fewer than k allowed
    masks[1] = False                       # the padded all-false row
    masks[2] = rng.random(len(m)) < 0.2
    b = batch_of(q)
    mt, nt, at, mk = T(m), T(norms), T(allowed), T(masks)
    dots = dots_in_order(mt, b.queries, "pairwise")
    got = port.knn_flat_screened(dots, mt, nt, at, b.queries, b.qn, b.q2,
                                 10, sim, mk)
    want = port.knn_flat_plain(mt, nt, at, b.queries, b.qn, b.q2, 10, sim,
                               mk)
    same_bits(got[:2], want)
    assert got[2].tolist()[:3] == [True, True, False]
    rs, rd = ref.knn_topk_batch_masked(
        jnp.asarray(m), jnp.asarray(norms), jnp.ones(len(m), bool),
        jnp.asarray(allowed), jnp.asarray(b.host), jnp.asarray(masks), 10,
        sim)
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(rd))
    assert np.isneginf(np.asarray(got[0])[1]).all()


@pytest.mark.parametrize("kind", ["gauss", "sift"])
@pytest.mark.parametrize("k,n_pad,dims", [(1024, 8192, 5),
                                          (4500, 65536, 100)])
def test_screen_wide_k(kind, k, n_pad, dims):
    """k 1,024 and 4,500 (above 4,096) at small N: the tile threshold
    still serves (t 32), and the answer is the plain version's."""
    m, norms, allowed, q = inputs(5, kind, dims, n_pad - 100, n_pad, 2)
    assert port.tile_tops_per(n_pad, k) > 0
    mt, nt, at = T(m), T(norms), T(allowed)
    b = batch_of(q)
    dots = dots_in_order(mt, b.queries, "reversed")
    got = port.knn_flat_screened(dots, mt, nt, at, b.queries, b.qn, b.q2, k,
                                 "cosine")
    same_bits(got[:2], port.knn_flat_plain(mt, nt, at, b.queries, b.qn, b.q2,
                                           k, "cosine"))
    assert not bool(got[2][0])


COARSE_CASES = [(kind, dims, masked) for kind in ("gauss", "sift")
                for dims in (5, 100, 128) for masked in (False, True)]


@pytest.mark.parametrize("kind,dims,masked", COARSE_CASES,
                         ids=["-".join(map(str, c)) for c in COARSE_CASES])
def test_coarse_listing_matches_plain_and_reference(kind, dims, masked):
    """K6's selection (tile threshold, listed tiles, best k') over its
    exact coarse plane is ``knn_coarse_plain``'s bit for bit at k' 10,
    100 and 1,024, and with dot_product (int8 sums are exact, and no query
    norm is read) its scores and candidates are the JAX
    ``knn_coarse_candidates(_masked)``'s."""
    m, norms, allowed, q = inputs(6, kind, dims, 16000, 16384, 4)
    q8, scales = quantize_rows(m)
    masks = None
    if masked:
        rng = np.random.default_rng(7)
        masks = rng.random((4, len(m))) < 0.3
        masks[1] = False
        masks[1, :50] = True    # allowed docs in one tile: tops < k'
    b = batch_of(q)
    qq, qscale = b.quantized()
    args = (T(q8), T(scales), T(norms), T(allowed), qq, qscale, b.qn, b.q2)
    mk = None if masks is None else T(masks)
    plane = port.coarse_scores_plain(*args, "l2_norm", mk)
    for kp in (10, 100, 1024):
        want = port.knn_coarse_plain(*args, kp, "l2_norm", mk)
        got = port.knn_coarse_listed(plane, kp)
        same_bits(got[:2], want)
        if masked:
            # row 1's allowed docs sit in one tile, whose t tops are fewer
            # than k': tau is -inf and the row is selected whole
            assert bool(got[2][1]) and not bool(got[2][0])
    # against the reference where its scores are exact too (no query norm)
    plane = port.coarse_scores_plain(*args, "dot_product", mk)
    got = port.knn_coarse_listed(plane, 100)
    jargs = (jnp.asarray(q8), jnp.asarray(scales), jnp.asarray(norms),
             jnp.asarray(allowed), jnp.asarray(b.host))
    if masks is None:
        rs, rd = ref.knn_coarse_candidates(*jargs, 100, "dot_product")
    else:
        rs, rd = ref.knn_coarse_candidates_masked(
            *jargs, jnp.asarray(masks), 100, "dot_product")
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(rs))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(rd))


@pytest.mark.parametrize("k", [1, 7, 128, 1000])
def test_tile_threshold_never_exceeds_the_kth(k):
    """tau is at most each row's k-th largest value, on rows of many ties
    and -inf slots, and -inf where fewer than k values are finite."""
    rng = np.random.default_rng(k)
    x = rng.integers(0, 40, (5, 4000)).astype(np.float32)
    x[x < 8] = -np.inf
    x[3] = -np.inf
    x[3, :5] = 1.0
    t = T(x)
    tau = port.tile_threshold(t, k)
    kth = torch.sort(t, dim=1, descending=True).values[:, k - 1]
    assert bool((tau <= kth).all())
    if k > 5:
        assert float(tau[3]) == -np.inf
    s, d, whole = port.knn_coarse_listed(t, k)
    same_bits((s, d), stable_topk(t, k))


@pytest.mark.parametrize("listed", [False, True])
def test_rows_select_keys_match_stable_topk(listed):
    """The row-batched selection's keys (score high, n - 1 - id low) give
    ``lax.top_k``'s order: over whole rows, and over lists whose entries
    come in any order with their doc ids."""
    rng = np.random.default_rng(11)
    x = rng.integers(0, 60, (6, 5000)).astype(np.float32) / 7.0
    x[x < 1] = -np.inf
    t = T(x)
    want = stable_topk(t, 300)
    ids = torch.arange(5000).expand(6, 5000)
    if listed:
        perm = T(np.stack([rng.permutation(5000) for _ in range(6)]))
        t = torch.gather(t, 1, perm)
        ids = perm
    got = topk.rows_topk_by_keys(t, ids, 5000, 300)
    same_bits(got, want)
