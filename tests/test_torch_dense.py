"""The dense collector's kernels (elasticsearch_tpu_torch) against the JAX
programs they replace, on the CPU, on the same seeded numpy inputs:

- ``bm25_block_scores`` (K8, plain version) against the JAX
  ``bm25_block_scores``;
- ``bm25_topk`` at one query (served by K1's plain version) against the
  JAX ``bm25_topk``;
- ``vector_scores`` (K9, plain version) against the JAX ``vector_scores``;
- ``knn_topk`` at one query (served by K5's plain version) against the
  JAX ``knn_topk``;
- ``dense_topk`` (K10, plain version) against ``lax.top_k``.

Tolerances.

- K8: the port rounds each f32 contribution c to 64-bit fixed point
  (|error| <= 2^-33) and sums exactly, then rounds once to f32 (relative
  2^-24); the JAX program adds the n contributions of a doc in f32, each
  add rounding (relative 2^-24 of the partial sum). So |port - ref| <=
  n * 2^-33 + (n + 1) * 2^-24 * |ref|. These inputs put at most 15
  postings on a doc (asserted), so scores agree within atol 1e-8 +
  rtol 1e-6; the ``score > 0`` match mask must be equal exactly.
- bm25_topk: the same score tolerance; ids exact outside groups of
  scores within that tolerance of each other, compared as a set inside
  one.
- K9 on integer-valued vectors (SIFT1M's kind): every product and partial
  sum is an integer below 2^24, exact in any order, and the query norm is
  a correctly rounded root of an exact sum: equal bit for bit. On
  Gaussian vectors the two packages sum the D products in another order:
  the difference is a re-association error that scales with the sum of
  |products| -- about the same for every doc of a row, not with the
  doc's own score -- so scores agree within 4e-6 times the row's largest
  |score| (worst case 2 (D - 1) 2^-24 of the sum of |products|; the
  typical error is about 100x smaller).
- knn_topk: exact on integer vectors; scores to rtol 4e-6 and ids outside
  near-ties on Gaussian ones (as tests/test_torch_knn.py).
- K10: exact. Both sort the same values; ties (equal scores, -inf
  included) come back lowest index first in both.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from elasticsearch_tpu.ops import bm25 as ref_bm25
from elasticsearch_tpu.ops import knn as ref_knn

from elasticsearch_tpu_torch.ops import bm25 as port
from elasticsearch_tpu_torch.ops import knn as pknn
from elasticsearch_tpu_torch.ops import topk
from elasticsearch_tpu_torch.ops.bm25 import KMAX
from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE
from test_torch_bm25 import assert_topk_match
from torch_inputs import close_ids, make_inputs, make_knn_inputs

RTOL = 1e-6
ATOL = 1e-8
KNN_RTOL = 4e-6
SIMS = ("cosine", "dot_product", "l2_norm")


def one_query(seed: int, n_docs: int = 3000, nb: int = 96, qb: int = 64):
    """A seeded block store and ONE query's block list, padded the way
    ``gather_query_blocks`` pads (block 0, weight 0)."""
    inp = make_inputs(seed, n_docs=n_docs, nb=nb, n_q=1, per_q=1)
    rng = np.random.default_rng(seed + 1)
    n_real = qb - qb // 8
    idx = np.zeros(qb, np.int32)
    w = np.zeros(qb, np.float32)
    idx[:n_real] = rng.choice(nb, n_real, replace=False)
    w[:n_real] = rng.uniform(0.2, 9.0, n_real)
    inp.update(bidx=idx, bw=w, avgdl=float(rng.uniform(40.0, 60.0)))
    return inp


def postings_per_doc(inp) -> int:
    docs = inp["docs"][inp["bidx"][inp["bw"] > 0]]
    docs = docs[docs >= 0]
    return int(np.bincount(docs).max()) if docs.size else 0


def port_args(inp):
    return [torch.as_tensor(inp[k]) for k in ("docs", "tfs", "bidx", "bw",
                                               "dl")]


def ref_args(inp):
    return [jnp.asarray(inp[k]) for k in ("docs", "tfs", "bidx", "bw", "dl")]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_live", [False, True])
def test_bm25_block_scores_matches_reference(seed, with_live):
    inp = one_query(seed)
    assert postings_per_doc(inp) <= 15
    want = np.asarray(ref_bm25.bm25_block_scores(
        *ref_args(inp), jnp.float32(inp["avgdl"]), inp["n_pad"]))
    live = torch.as_tensor(inp["live"]) if with_live else None
    got = port.bm25_block_scores(*port_args(inp), inp["avgdl"], inp["n_pad"],
                                 live).numpy()
    if with_live:
        want = np.where(inp["live"], want, 0.0)   # Bm25Executor.scores
    assert got.dtype == np.float32 and got.shape == (inp["n_pad"],)
    np.testing.assert_array_equal(got > 0.0, want > 0.0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_bm25_block_scores_padding_and_empty_query():
    inp = one_query(3)
    inp["bw"][:] = 0.0              # every block padding: no posting lands
    got = port.bm25_block_scores(*port_args(inp), inp["avgdl"], inp["n_pad"])
    assert not bool(got.any())


@pytest.mark.parametrize("seed", [4, 5])
@pytest.mark.parametrize("k", [1, 10, 200])
def test_bm25_topk_matches_reference(seed, k):
    inp = one_query(seed)
    rs, rd = ref_bm25.bm25_topk(*ref_args(inp), jnp.float32(inp["avgdl"]),
                                jnp.asarray(inp["live"]), inp["n_pad"], k)
    calls = DEVICE_PROFILE.family("bm25_flat").calls
    ps, pd = port.bm25_topk(*port_args(inp), inp["avgdl"],
                            torch.as_tensor(inp["live"]), inp["n_pad"], k)
    assert DEVICE_PROFILE.family("bm25_flat").calls == calls + 1  # K1
    assert ps.shape == (k,) and pd.dtype == torch.int32
    assert_topk_match(np.asarray(rs)[None], np.asarray(rd)[None],
                      ps.numpy()[None], pd.numpy()[None])


def test_bm25_scores_then_dense_topk_equal_bm25_topk_bitwise():
    """K8 + the live & > 0 mask + K10 is bm25_topk, bit for bit: K8 sums
    what K1 sums."""
    inp = one_query(6, nb=256, qb=128)
    live = torch.as_tensor(inp["live"])
    s8 = port.bm25_block_scores(*port_args(inp), inp["avgdl"], inp["n_pad"],
                                live)
    via = topk.dense_topk(torch.where(s8 > 0, s8, -torch.inf), 50)
    got = port.bm25_topk(*port_args(inp), inp["avgdl"], live, inp["n_pad"],
                         50)
    for a, b in zip(via, got):
        assert torch.equal(a, b)


def vectors(m, norms, exists, sim):
    """A DeviceVectors stand-in on the CPU."""
    return SimpleNamespace(matrix=torch.as_tensor(m),
                           norms=torch.as_tensor(norms),
                           exists=torch.as_tensor(exists), similarity=sim)


KNN_CASES = [(kind, dims, sim) for kind in ("int", "gauss")
             for dims in (16, 128) for sim in SIMS]


def _ids(c):
    return "-".join(map(str, c))


@pytest.mark.parametrize("kind,dims,sim", KNN_CASES,
                         ids=map(_ids, KNN_CASES))
def test_vector_scores_matches_reference(kind, dims, sim):
    m, norms, exists, live, q = make_knn_inputs(7, dims, 2, kind, 900, 1024)
    want = np.asarray(ref_knn.vector_scores(
        jnp.asarray(m), jnp.asarray(norms), jnp.asarray(exists),
        jnp.asarray(q[0]), sim))
    got = pknn.query_scores(vectors(m, norms, exists, sim),
                            q[0]).numpy()
    assert got.dtype == np.float32 and got.shape == (1024,)
    np.testing.assert_array_equal(got[~exists], 0.0)
    if kind == "int":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(
            got, want, rtol=0, atol=KNN_RTOL * np.abs(want).max())


@pytest.mark.parametrize("kind,dims,sim", KNN_CASES,
                         ids=map(_ids, KNN_CASES))
def test_knn_topk_matches_reference(kind, dims, sim):
    m, norms, exists, live, q = make_knn_inputs(8, dims, 2, kind, 900, 1024)
    rs, rd = ref_knn.knn_topk(jnp.asarray(m), jnp.asarray(norms),
                              jnp.asarray(exists), jnp.asarray(live),
                              jnp.asarray(q[0]), 25, sim)
    calls = DEVICE_PROFILE.family("knn_flat").calls
    ps, pd = pknn.knn_topk(torch.as_tensor(m), torch.as_tensor(norms),
                           torch.as_tensor(exists), torch.as_tensor(live),
                           q[0], 25, sim)
    assert DEVICE_PROFILE.family("knn_flat").calls == calls + 1  # K5
    rs, rd, ps, pd = map(np.asarray, (rs, rd, ps, pd))
    np.testing.assert_array_equal(np.isfinite(ps), np.isfinite(rs))
    if kind == "int":
        np.testing.assert_array_equal(ps, rs)
        np.testing.assert_array_equal(pd, rd)
    else:
        fin = np.isfinite(rs)
        np.testing.assert_allclose(ps[fin], rs[fin], rtol=KNN_RTOL)
        close_ids(rs[None], rd[None], pd[None], KNN_RTOL)


@pytest.mark.parametrize("sim", SIMS)
def test_vector_scores_then_dense_topk_equal_knn_topk_bitwise(sim):
    """K9 masked to live & exists + K10 is knn_topk, bit for bit: K9 has
    K5's per-pair arithmetic."""
    m, norms, exists, live, q = make_knn_inputs(9, 64, 1, "gauss", 900,
                                                1024)
    mt, nt, et, lt = map(torch.as_tensor, (m, norms, exists, live))
    row = pknn.query_scores(vectors(m, norms, exists, sim),
                            q[0])
    via = topk.dense_topk(torch.where(lt & et, row, -torch.inf), 40)
    got = pknn.knn_topk(mt, nt, et, lt, q[0], 40, sim)
    for a, b in zip(via, got):
        assert torch.equal(a, b)


def topk_rows(seed: int, n: int):
    rng = np.random.default_rng(seed)
    rand = rng.standard_normal(n).astype(np.float32)
    rand[rng.random(n) < 0.5] = -np.inf
    equal = np.full(n, 1.5, np.float32)
    equal[rng.random(n) < 0.1] = -np.inf
    few = rng.integers(0, 3, n).astype(np.float32)
    few[rng.random(n) < 0.3] = -np.inf
    return {"random": rand, "all_neg_inf": np.full(n, -np.inf, np.float32),
            "equal": equal, "three_values": few}


TOPK_CASES = [(n, k, row) for n in (128, 5000) for k in (1, 10, 128)
              for row in ("random", "all_neg_inf", "equal", "three_values")]


@pytest.mark.parametrize("n,k,row", TOPK_CASES, ids=map(_ids, TOPK_CASES))
def test_dense_topk_matches_lax_top_k(n, k, row):
    x = topk_rows(n + k, n)[row]
    rs, rd = jax.lax.top_k(jnp.asarray(x), k)
    ps, pd = topk.dense_topk(torch.as_tensor(x), k)
    assert ps.dtype == torch.float32 and pd.dtype == torch.int32
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(rd))


def test_dense_topk_refuses_bad_inputs():
    x = torch.zeros(256)
    with pytest.raises(ValueError):
        topk.dense_topk(x, 0)
    with pytest.raises(ValueError):
        topk.dense_topk(x, 257)
    # (a k above the CTA top-k's 4,096 entries was refused here before the
    # wide selection; it is served now, in lax.top_k's order)
    s, d = topk.dense_topk(torch.zeros(8192), KMAX + 1)
    assert torch.equal(d, torch.arange(KMAX + 1, dtype=torch.int32))
    assert torch.equal(s, torch.zeros(KMAX + 1))
    with pytest.raises(TypeError):
        topk.dense_topk(x.double(), 5)
    with pytest.raises(ValueError):
        topk.dense_topk(torch.zeros(2, 128), 5)


def test_dense_wrappers_count_calls_not_launches_on_the_cpu():
    inp = one_query(10)
    before = {f: (DEVICE_PROFILE.family(f).calls,
                  DEVICE_PROFILE.family(f).launches)
              for f in ("bm25_scores", "knn_scores", "dense_topk")}
    port.bm25_block_scores(*port_args(inp), inp["avgdl"], inp["n_pad"])
    m, norms, exists, _live, q = make_knn_inputs(11, 8, 1, "int", 100, 128)
    pknn.query_scores(vectors(m, norms, exists, "cosine"),
                      q[0])
    topk.dense_topk(torch.zeros(128), 3)
    for f, (calls, launches) in before.items():
        assert DEVICE_PROFILE.family(f).calls == calls + 1
        assert DEVICE_PROFILE.family(f).launches == launches
