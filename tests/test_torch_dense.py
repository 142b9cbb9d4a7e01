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
- K10: exact. Both sort the same values in one total order (+0.0 above
  -0.0); ties (equal bits, -inf included) come back lowest index first
  in both. A served ``script_score`` whose scores are +0.0 on some docs
  and -0.0 on others gives a reference node's hits on a port node.
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


def key_rows(seed: int, n: int):
    """Rows that stress K10's 64-bit selection key: one score everywhere,
    +0.0 and -0.0 mixed, runs of -inf, subnormals of both signs, few
    distinct values, and Gaussian scores with -inf holes."""
    rng = np.random.default_rng(seed)
    zeros = np.where(rng.random(n) < 0.5, 0.0, -0.0).astype(np.float32)
    zeros[rng.random(n) < 0.05] = 1.0
    runs = rng.standard_normal(n).astype(np.float32)
    for start in rng.integers(0, n, 8):
        runs[start: start + n // 10] = -np.inf
    sub = (rng.integers(-3, 4, n) * 1e-40).astype(np.float32)
    few = rng.integers(0, 3, n).astype(np.float32)
    gauss = rng.standard_normal(n).astype(np.float32)
    gauss[rng.random(n) < 0.4] = -np.inf
    return {"all_equal": np.full(n, 2.5, np.float32), "signed_zeros": zeros,
            "neg_inf_runs": runs, "subnormals": sub, "three_values": few,
            "gauss": gauss}


KEY_ROWS = ("all_equal", "signed_zeros", "neg_inf_runs", "subnormals",
            "three_values", "gauss")
# n below and above one CTA's sort (SORT_CAP keys), k above it too
KEY_CASES = [(n, k, row) for n in (1000, topk.SORT_CAP + 3,
                                   2 * topk.SORT_CAP + 5)
             for k in (1, 10, 1000, topk.SORT_CAP + 1) if k <= n
             for row in KEY_ROWS]


@pytest.mark.parametrize("n,k,row", KEY_CASES, ids=map(_ids, KEY_CASES))
def test_selection_keys_order_as_the_stable_sort_and_lax_top_k(n, k, row):
    """The k largest of K10's 64-bit keys, decoded as the kernel decodes
    them, are the plain version's (a stable sort of the ordered score
    bits) top-k bit for bit, -0.0 kept as the row holds it; and
    lax.top_k's on every row, the one that mixes +0.0 and -0.0 included:
    lax.top_k compares floats in a total order, +0.0 above -0.0, and so
    do the key and the plain version (a script_score can return
    either)."""
    x = key_rows(n + k, n)[row]
    t = torch.as_tensor(x)
    ks, kd = topk.dense_topk_by_keys(t, k)
    ps, pd = topk.dense_topk_plain(t, k)
    assert torch.equal(kd, pd)
    assert torch.equal(ks.view(torch.int32), ps.view(torch.int32))
    keys = topk.selection_keys(t)
    assert torch.unique(keys).numel() == n
    rs, rd = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(kd.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(ks.numpy().view(np.int32),
                                  np.asarray(rs).view(np.int32))


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


def signed_zero_docs(n: int):
    """``n`` docs whose 2-dim vectors make a cosine of exactly 0, or of
    either sign, against the query [1, -1]: under ``boost: 0`` their
    script_score is +0.0 or -0.0."""
    rng = np.random.default_rng(31)
    out = []
    for i in range(n):
        a, b = (int(v) for v in rng.integers(1, 5, 2))
        if i % 3 == 0:
            b = a                                   # cosine exactly 0
        out.append((str(i), {"vec": [float(a), float(b)]}))
    return out


def test_script_score_signed_zeros_give_the_reference_hits():
    """A script_score under ``boost: 0`` scores every doc +0.0 or -0.0
    (the cosine times 0). The dense collector's top-k then decides the
    hits by the sign of zero: lax.top_k, in a total order, keeps the +0.0
    docs first, and so must K10's plain version. A reference node and a
    port node give the same hits, ids and score bits, one segment and two,
    for windows that cut inside the +0.0 docs and past them."""
    import json

    from elasticsearch_tpu.rest.controller import RestRequest as RefRequest
    from elasticsearch_tpu.rest.routes import build_controller as ref_ctl
    from elasticsearch_tpu.testing import InProcessCluster as RefCluster

    from elasticsearch_tpu_torch.rest.controller import RestRequest
    from elasticsearch_tpu_torch.rest.routes import build_controller
    from elasticsearch_tpu_torch.testing import InProcessCluster

    def driver(cluster, ctl, req_cls):
        def call(method, path, body=None, raw=b""):
            out = []
            ctl.dispatch(req_cls(method=method, path=path, query={},
                                 body=body, raw_body=raw),
                         lambda st, b: out.append((st, b)))
            cluster.run_until(lambda: bool(out), 120.0)
            return out[0]
        return call

    docs = signed_zero_docs(60)
    sides = []
    for cluster_cls, ctl, req_cls, kw in (
            (RefCluster, ref_ctl, RefRequest, {}),
            (InProcessCluster, build_controller, RestRequest,
             {"device": "cpu"})):
        c = cluster_cls(n_nodes=1, seed=7, **kw)
        c.start()
        call = driver(c, ctl(c.client()), req_cls)
        status, _ = call("PUT", "/z", {"settings": {
            "number_of_shards": 1, "number_of_replicas": 0},
            "mappings": {"properties": {"vec": {
                "type": "dense_vector", "dims": 2, "similarity": "cosine",
                "index_options": {"type": "flat"}}}}})
        assert status == 200
        for half in (docs[:30], docs[30:]):        # two segments
            lines = []
            for i, body in half:
                lines += [json.dumps({"index": {"_index": "z", "_id": i}}),
                          json.dumps(body)]
            status, resp = call("POST", "/_bulk",
                                raw=("\n".join(lines) + "\n").encode())
            assert status == 200 and not resp["errors"]
            assert call("POST", "/z/_refresh")[0] == 200
        sides.append(call)
    ref, port = sides
    for size in (5, 15, 60):
        body = {"size": size, "query": {"script_score": {
            "query": {"match_all": {}}, "boost": 0.0,
            "script": {"source": "cosineSimilarity(params.q, 'vec')",
                       "params": {"q": [1.0, -1.0]}}}}}
        (st_a, a), (st_b, b) = ref("POST", "/z/_search", body), \
            port("POST", "/z/_search", body)
        assert st_a == st_b == 200, (a, b)
        hits_a, hits_b = a["hits"]["hits"], b["hits"]["hits"]
        assert [h["_id"] for h in hits_a] == [h["_id"] for h in hits_b]
        signs = [np.signbit(np.float32(h["_score"])) for h in hits_a]
        assert signs == [np.signbit(np.float32(h["_score"]))
                         for h in hits_b]
        assert all(h["_score"] == 0.0 for h in hits_a)
        if size < 60:
            # the window holds only +0.0 docs, though lower ids score -0.0
            assert not any(signs)
        assert a["hits"]["total"] == b["hits"]["total"]
