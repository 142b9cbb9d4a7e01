"""Top-k windows wider than the kernels' 4,096-entry CTA selection, against
the JAX package (which answers every window with ``lax.top_k``).

A window above KMAX runs the wide selection: rounds of at most KMAX
entries, each after the cursor the round before left
(``csrc/topk_common.cuh``; the plain versions sort stably). These tests
drive windows of 4,097 and 10,000 through ``SearchService.search`` on
``device="cpu"`` -- ``match`` with ``from`` + ``size`` on the pruned and
on the dense collector, ``text_expansion`` and exact ``knn`` -- and an
IVF probe whose k passes 4,096, on one 9,000-doc segment (per-segment
launches with a window above KMAX) and on two segments (the plane).

Tolerance: ids exact; scores to each family's bound (rtol 1e-6 for BM25
and rank_features, which sum in fixed point where the reference adds f32
in posting order; exact for kNN over integer-valued vectors); hits whose
reference scores tie within the bound are compared as a set.
"""

import numpy as np
import pytest

from elasticsearch_tpu.index import InternalEngine as RefEngine
from elasticsearch_tpu.mapping import MapperService as RefMappers
from elasticsearch_tpu.ops import ivf as ref_ivf
from elasticsearch_tpu.ops.device_segment import PLANES as REF_PLANES
from elasticsearch_tpu.search import SearchService as RefService

from elasticsearch_tpu_torch.index import InternalEngine
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.ops import ivf as port_ivf
from elasticsearch_tpu_torch.ops.bm25 import KMAX, stable_topk
from elasticsearch_tpu_torch.ops.device_segment import PLANES
from elasticsearch_tpu_torch.ops.topk import dense_topk
from elasticsearch_tpu_torch.search import SearchService
from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE

import torch

N_DOCS = 9000
WINDOWS = (4097, 10_000)
MAPPING = {"properties": {
    "body": {"type": "text"}, "vec": {"type": "dense_vector", "dims": 3},
    "ml": {"type": "rank_features"}}}
LAYOUTS = {"one_segment": (), "two_segments": (4600,)}
_ENGINES = {}


def _docs():
    rng = np.random.default_rng(17)
    out = []
    for _ in range(N_DOCS):
        words = rng.integers(0, 30, int(rng.integers(3, 9)))
        feats = {f"f{int(x)}": float(rng.integers(1, 40)) / 8
                 for x in rng.integers(0, 24, 3)}
        out.append({"body": " ".join(f"w{int(x)}" for x in words),
                    "vec": [float(x) for x in rng.integers(-9, 10, 3)],
                    "ml": feats})
    return out


def engines(layout: str):
    if layout not in _ENGINES:
        ref = RefEngine(RefMappers(MAPPING), shard_label="ref")
        port = InternalEngine(MapperService(MAPPING), shard_label="port")
        for i, doc in enumerate(_docs()):
            ref.index(str(i), doc)
            port.index(str(i), doc)
            if i in LAYOUTS[layout]:
                ref.refresh()
                port.refresh()
        ref.refresh()
        port.refresh()
        for i in (5, 4601, 8000):
            ref.delete(str(i))
            port.delete(str(i))
        ref.refresh()
        port.refresh()
        _ENGINES[layout] = (ref, port)
    return _ENGINES[layout]


@pytest.fixture
def planes():
    keep = [(p, p.enabled) for p in (REF_PLANES, PLANES)]
    REF_PLANES.clear()
    PLANES.clear()
    yield
    for p, en in keep:
        p.enabled = en
        p.clear()


def assert_same_hits(want, got, rtol: float):
    hw, hg = want["hits"], got["hits"]
    assert hw["total"] == hg["total"]
    ids_w = [h["_id"] for h in hw["hits"]]
    ids_g = [h["_id"] for h in hg["hits"]]
    sw = np.array([h["_score"] for h in hw["hits"]])
    sg = np.array([h["_score"] for h in hg["hits"]])
    assert len(ids_w) == len(ids_g)
    np.testing.assert_allclose(sg, sw, rtol=rtol, atol=0)
    i = 0
    while i < len(sw):
        j = i + 1
        while j < len(sw) and abs(sw[j] - sw[i]) <= rtol * abs(sw[i]):
            j += 1
        assert set(ids_w[i:j]) == set(ids_g[i:j]), (i, j)
        if j - i == 1 or rtol == 0:
            assert ids_w[i:j] == ids_g[i:j]
        i = j


def _serve(layout, body, rtol):
    ref, port = engines(layout)
    want = RefService(ref).search(dict(body))
    got = SearchService(port, device="cpu").search(dict(body))
    assert_same_hits(want, got, rtol)
    return got


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("collector", ["pruned", "dense"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_match_window_above_kmax(layout, collector, window, planes):
    body = {"query": {"match": {"body": "w1 w2 w3 w4 w5 w6 w7 w8"}},
            "from": 7,
            "size": window - 7}
    if collector == "dense":
        body["track_total_hits"] = True
    fams = ("dense_topk",) if collector == "dense" else (
        "bm25_flat", "bm25_flat_seg")

    def calls():
        return sum(DEVICE_PROFILE.family(f).calls for f in fams)

    fam0 = calls()
    got = _serve(layout, body, 1e-6)
    total = got["hits"]["total"]["value"]
    assert total > KMAX
    assert len(got["hits"]["hits"]) == min(window, total) - 7
    assert calls() > fam0


def test_match_wide_window_extends_the_kmax_window(planes):
    """The first 4,096 hits of a 10,000 window are the 4,096 window's."""
    _ref, port = engines("one_segment")
    svc = SearchService(port, device="cpu")
    q = {"match": {"body": "w4 w5 w6 w7 w8 w9 w10"}}
    narrow = svc.search({"query": q, "size": KMAX})["hits"]["hits"]
    wide = svc.search({"query": q, "size": 10_000})["hits"]["hits"]
    assert [(h["_id"], h["_score"]) for h in wide[:KMAX]] == \
        [(h["_id"], h["_score"]) for h in narrow]


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_text_expansion_window_above_kmax(layout, window, planes):
    tokens = {f"f{i}": 0.25 * (1 + i % 7) for i in range(0, 24, 2)}
    body = {"query": {"text_expansion": {"ml": {"model_id": "m",
                                                "tokens": tokens}}},
            "size": window}
    got = _serve(layout, body, 1e-6)
    assert got["hits"]["total"]["value"] > KMAX
    assert len(got["hits"]["hits"]) == min(
        window, got["hits"]["total"]["value"])


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_knn_k_above_kmax(layout, window, planes):
    body = {"query": {"knn": {"field": "vec", "query_vector": [3.0, -2.0, 5.0],
                              "k": window, "num_candidates": window}},
            "size": window}
    got = _serve(layout, body, 0.0)
    assert len(got["hits"]["hits"]) > KMAX


def _clustered(seed: int, n_clusters: int, per: int, dims: int):
    rng = np.random.default_rng(seed)
    means = rng.integers(-50, 50, (n_clusters, dims)) * 10.0
    x = np.repeat(means, per, axis=0) + rng.integers(-3, 4, (
        n_clusters * per, dims))
    return x.astype(np.float32)


@pytest.mark.parametrize("window", WINDOWS)
def test_ivf_probe_k_above_kmax(window):
    x = _clustered(13, 4, 3000, 8)
    r = ref_ivf.IVFIndex.build(x, nlist=4, similarity="cosine")
    p = port_ivf.IVFIndex.build(x, nlist=4, similarity="cosine",
                                device="cpu")
    np.testing.assert_array_equal(p.centroids.numpy(),
                                  np.asarray(r.centroids))
    q = x[[3, 4000, 11_000]]
    rs, ri = r.search(q, window, 4)
    ps, pi = p.search(q, window, 4)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_array_equal(ps, rs)


@pytest.mark.parametrize("k", [1, KMAX, KMAX + 1, 3 * KMAX + 5])
def test_dense_topk_plain_order_at_any_k(k):
    """Ties (many equal scores and -inf slots) resolve lowest index first,
    and every k, below and above KMAX, gives a prefix of the full stable
    order."""
    rng = np.random.default_rng(k)
    x = rng.integers(0, 50, (3, 20_000)).astype(np.float32)
    x[x < 5] = -np.inf
    t = torch.as_tensor(x)
    full_s, full_d = stable_topk(t, t.shape[1])
    for row in range(t.shape[0]):
        s, d = dense_topk(t[row], k)
        assert torch.equal(d, full_d[row, :k])
        assert torch.equal(s, full_s[row, :k])
    with pytest.raises(ValueError):
        dense_topk(t[0], 20_001)
