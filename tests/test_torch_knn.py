"""The three kNN kernels' plain PyTorch versions (elasticsearch_tpu_torch
ops/knn.py) against the JAX programs they replace, on the CPU, on the
same seeded numpy inputs.

- ``knn_flat`` (K5) against ``knn_topk_batch``,
- ``knn_coarse`` (K6) against ``knn_coarse_candidates``,
- ``knn_rerank`` (K7) against ``knn_rerank_exact``,

over the three similarities, batches of 1, 3 (padded to 4) and 8 rows,
D = 16 and 128, with dead docs, missing vectors, duplicate rows (score
ties) and an all-zero query row.

Tolerance. With integer-valued vectors every product and every partial
sum is an integer below 2^24, so the sums are exact in any order and the
outputs must be equal bit for bit. With Gaussian vectors the two packages
sum the D products in a different order (the port in dimension order, XLA
in its own), and so the query's norm: scores agree to rtol 4e-6 (f32
re-association of a 128-term dot product, about D * 2^-24 of the sum of
|products| over the score, with headroom), and ids wherever neighbouring
scores are further apart than that; K7's eps, a difference of scores,
to the same tolerance times the scores' scale. K6's int32 sums are exact
in any order: its candidates are equal, and its scores too where the
transform reads no query norm (dot_product).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elasticsearch_tpu.ops import knn as ref

from elasticsearch_tpu_torch.ops import knn as port
from elasticsearch_tpu_torch.ops.device_segment import quantize_rows
from torch_inputs import close_ids, make_knn_inputs

RTOL = 4e-6
SIMS = ("cosine", "dot_product", "l2_norm")
N_DOCS, N_PAD = 900, 1024


def make_inputs(seed: int, dims: int, n_q: int, kind: str):
    return make_knn_inputs(seed, dims, n_q, kind, N_DOCS, N_PAD)


def assert_scores(got, want, exact: bool):
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL)


CASES = [(kind, dims, n_q, sim) for kind in ("int", "gauss")
         for dims in (16, 128) for n_q in (1, 3, 8) for sim in SIMS]


def _ids(c):
    return "-".join(map(str, c))


@pytest.mark.parametrize("kind,dims,n_q,sim", CASES, ids=map(_ids, CASES))
def test_knn_flat_matches_knn_topk_batch(kind, dims, n_q, sim):
    m, norms, exists, live, q = make_inputs(1, dims, n_q, kind)
    batch = port.QueryBatch(q, "cpu")
    q_pad = batch.host
    assert q_pad.shape[0] == {1: 1, 3: 4, 8: 8}[n_q]
    rs, rd = ref.knn_topk_batch(jnp.asarray(m), jnp.asarray(norms),
                                jnp.asarray(exists), jnp.asarray(live),
                                jnp.asarray(q_pad), 24, sim)
    ps, pd = port.knn_topk_batch(torch.as_tensor(m), torch.as_tensor(norms),
                                 torch.as_tensor(exists),
                                 torch.as_tensor(live), batch, 24, sim)
    rs, rd, ps, pd = map(np.asarray, (rs, rd, ps, pd))
    assert pd.dtype == np.int32 and ps.dtype == np.float32
    assert_scores(ps, rs, exact=kind == "int")
    if kind == "int":
        np.testing.assert_array_equal(pd, rd)
    else:
        close_ids(rs, rd, pd, RTOL)
    # the all-zero query row still ranks every eligible doc
    assert np.isfinite(ps[n_q - 1]).all()


@pytest.mark.parametrize("kind,dims,n_q,sim", CASES, ids=map(_ids, CASES))
def test_knn_coarse_matches_knn_coarse_candidates(kind, dims, n_q, sim):
    m, norms, exists, live, q = make_inputs(2, dims, n_q, kind)
    q8, scales = quantize_rows(m)
    allowed = live & exists
    batch = port.QueryBatch(q, "cpu")
    kprime = 64
    rcs, rcand = ref.knn_coarse_candidates(
        jnp.asarray(q8), jnp.asarray(scales), jnp.asarray(norms),
        jnp.asarray(allowed), jnp.asarray(batch.host), kprime, sim)
    pcs, pcand = port.knn_coarse_candidates(
        torch.as_tensor(q8), torch.as_tensor(scales), torch.as_tensor(norms),
        torch.as_tensor(allowed), batch, kprime, sim)
    rcs, rcand, pcs, pcand = map(np.asarray, (rcs, rcand, pcs, pcand))
    exact = kind == "int" or sim == "dot_product"
    assert_scores(pcs, rcs, exact=exact)
    if exact:
        np.testing.assert_array_equal(pcand, rcand)
    else:
        close_ids(rcs, rcand, pcand, RTOL)


@pytest.mark.parametrize("kind,dims,n_q,sim", CASES, ids=map(_ids, CASES))
def test_knn_rerank_matches_knn_rerank_exact(kind, dims, n_q, sim):
    m, norms, exists, live, q = make_inputs(3, dims, n_q, kind)
    q8, scales = quantize_rows(m)
    allowed = live & exists
    batch = port.QueryBatch(q, "cpu")
    kprime, k = 64, 10
    cs, cand = port.knn_coarse_candidates(
        torch.as_tensor(q8), torch.as_tensor(scales), torch.as_tensor(norms),
        torch.as_tensor(allowed), batch, kprime, sim)
    rts, rtd, reps = ref.knn_rerank_exact(
        jnp.asarray(m), jnp.asarray(norms), jnp.asarray(allowed),
        jnp.asarray(batch.host), jnp.asarray(cand.numpy()),
        jnp.asarray(cs.numpy()), k, sim)
    pts, ptd, peps = port.knn_rerank_exact(
        torch.as_tensor(m), torch.as_tensor(norms), torch.as_tensor(allowed),
        batch, cand, cs, k, sim)
    rts, rtd, reps, pts, ptd, peps = map(
        np.asarray, (rts, rtd, reps, pts, ptd, peps))
    exact = kind == "int"
    assert_scores(pts, rts, exact=exact)
    if exact:
        np.testing.assert_array_equal(ptd, rtd)
        np.testing.assert_array_equal(peps, reps)
    else:
        close_ids(rts, rtd, ptd, RTOL)
        # eps is a difference of scores: it moves by their tolerance
        c = cs.numpy()
        scale = 1.0 + np.abs(c[np.isfinite(c)]).max()
        np.testing.assert_allclose(peps, reps, rtol=0, atol=RTOL * scale)


@pytest.mark.parametrize("sim", SIMS)
def test_rerank_equals_flat_and_batch_does_not_change_a_row(sim):
    """The port's own identities, bit for bit: a candidate's re-rank score
    is knn_flat's score for that doc, ties resolve to the lower doc in
    both, and a row's answer does not depend on the batch it rides in."""
    m, norms, exists, live, q = make_inputs(4, 128, 8, "gauss")
    allowed = live & exists
    T = torch.as_tensor
    batch = port.QueryBatch(q, "cpu")
    s8, d8 = port.knn_topk_batch(T(m), T(norms), T(exists), T(live), batch,
                                 N_PAD, sim)
    for r in (0, 5):
        s1, d1 = port.knn_topk_batch(T(m), T(norms), T(exists), T(live),
                                     port.QueryBatch(q[r:r + 1], "cpu"),
                                     N_PAD, sim)
        assert torch.equal(s1[0], s8[r]) and torch.equal(d1[0], d8[r])
    # re-rank every doc: the exact order and bits of knn_flat
    cand = torch.stack([torch.randperm(N_PAD, generator=torch.Generator()
                                       .manual_seed(r)).to(torch.int32)
                        for r in range(8)])
    cs = torch.zeros(8, N_PAD)
    ts, td, _eps = port.knn_rerank_exact(T(m), T(norms), T(allowed), batch,
                                         cand, cs, 50, sim)
    fin = torch.isfinite(ts)
    assert torch.equal(ts, s8[:, :50])
    assert torch.equal(td[fin], d8[:, :50][fin])
    assert (td[~fin] == -1).all()
    # the duplicate rows tie: lower doc first
    row = d8[0].tolist()
    tied = [d for d in row if d in (5, 11, 17, 40)]
    assert tied == sorted(tied)


def test_query_norms_are_sequential_sums():
    q = np.random.default_rng(5).standard_normal((4, 300)).astype(np.float32)
    qn, q2 = port.query_norms(q)
    acc = np.zeros(4, np.float32)
    for d in range(300):
        acc = acc + q[:, d] * q[:, d]
    np.testing.assert_array_equal(q2, acc)
    np.testing.assert_array_equal(qn, np.sqrt(acc) + np.float32(1e-30))


def test_quantization_matches_the_reference():
    m = np.random.default_rng(6).standard_normal((64, 32)).astype(np.float32)
    m[3] = 0.0
    qq, qscale = port.quantize_queries(m)
    rq, rs = ref._quantize_queries(jnp.asarray(m))
    np.testing.assert_array_equal(qq, np.asarray(rq))
    np.testing.assert_array_equal(qscale, np.asarray(rs)[:, 0])


def test_cuda_tensors_never_take_the_plain_version(monkeypatch):
    """A kNN wrapper given CUDA tensors launches its kernel or raises: with
    the kernel library unavailable it raises instead of computing on the
    host."""
    from elasticsearch_tpu_torch import _build
    from elasticsearch_tpu_torch.ops import bm25 as port_bm25

    def no_library(family):
        raise _build.KernelBuildError("kernel library unavailable")

    monkeypatch.setattr(_build, "library", no_library)
    # the bound launchers of every family are cached in one place
    monkeypatch.setattr(port_bm25, "_FNS", {})
    monkeypatch.setattr(port, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(port, "_stream", lambda: 0)
    for name in ("knn_flat_plain", "knn_coarse_plain", "knn_rerank_plain"):
        monkeypatch.setattr(port, name, lambda *a, **k: pytest.fail(
            "plain version ran for a CUDA call"))
    m, norms, exists, live, q = make_inputs(7, 16, 2, "int")
    T = torch.as_tensor
    batch = port.QueryBatch(q, "cpu")
    q8, scales = quantize_rows(m)
    allowed = T(live & exists)
    with pytest.raises(_build.KernelBuildError):
        port.knn_flat(T(m), T(norms), allowed, batch.queries, batch.qn,
                      batch.q2, 10)
    qq, qscale = batch.quantized()
    with pytest.raises(_build.KernelBuildError):
        port.knn_coarse(T(q8), T(scales), T(norms), allowed, qq, qscale,
                        batch.qn, batch.q2, 32)
    cand = torch.arange(64, dtype=torch.int32).repeat(2, 1)
    with pytest.raises(_build.KernelBuildError):
        port.knn_rerank(T(m), T(norms), allowed, batch.queries, batch.qn,
                        batch.q2, cand, torch.zeros(2, 64), 10)


def test_every_kernel_source_is_a_listed_family():
    from elasticsearch_tpu_torch import _build
    from elasticsearch_tpu_torch.search.device_profile import KERNEL_FAMILIES
    assert sorted(_build.sources()) == sorted(KERNEL_FAMILIES)
