"""The IVF path of elasticsearch_tpu_torch against the JAX package, on the
CPU, on the same seeded numpy inputs:

- the four kernels' plain PyTorch versions (ops/ivf.py) against the JAX
  programs they replace: ``ivf_assign`` (K11) against ``_assign``,
  ``ivf_update`` (K12) against ``_update``, ``ivf_init`` (K13) against
  ``_farthest_point_init``, ``ivf_search`` (K14) against ``_ivf_search``;
- ``kmeans`` and ``IVFIndex.build`` (device math + the host packing)
  against the JAX package's, and the port's search on a JAX-built index
  carried across by ``convert.ivf_from_reference``;
- served ``_search`` responses for ``knn`` on IVF-routed fields
  (``index_options.type: ivf`` on small segments), plane and per-segment,
  quantized tier on and off, with deletes after the build and a refresh
  that warm-starts k-means.

Tolerance. With integer-valued vectors in [0, 255] every bf16 operand is
exact, every product and partial sum an integer below 2^24, so dots,
centroid norms and distances are exact in any order: assignments,
seeding and searches must be equal bit for bit. Once the centroids are
means (after the first update) they are no longer integers, so later
assignments compare equal only where no two centroids' distances lie
within the summation-order bound below; the clustered test corpora keep
every row far from every other cluster, so their builds are equal. The
update sums each cluster's rows in ascending row order, the order in
which the JAX package's segment_sum adds them, and divides once: its
centroids are bit-equal on Gaussian data too. On Gaussian vectors the
assignment may differ only at a near-tie: the two packages' values of
c2 - 2 * dot for the two chosen centroids must lie within D * 2^-24 times
the sum of the magnitudes of their terms, for each of the two packages'
sums. Gaussian searches compare scores to rtol 4e-6 (f32 re-association
of the dot products and of the query's norm, as in tests/test_torch_knn.py)
and ids wherever neighbouring scores are further apart than that.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elasticsearch_tpu.index import InternalEngine as RefEngine
from elasticsearch_tpu.mapping import MapperService as RefMappers
from elasticsearch_tpu.ops import ivf as ref
from elasticsearch_tpu.ops.device_segment import PLANES as REF_PLANES
from elasticsearch_tpu.search import SearchService as RefService

from elasticsearch_tpu_torch.convert import ivf_from_reference
from elasticsearch_tpu_torch.index import InternalEngine
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.ops import ivf as port
from elasticsearch_tpu_torch.ops.device_segment import PLANES
from elasticsearch_tpu_torch.search import SearchService
from test_torch_knn_slice import planes  # noqa: F401 (a fixture)
from torch_inputs import close_ids

RTOL = 4e-6
SIMS = ("cosine", "dot_product", "l2_norm")
T = torch.as_tensor


def gaussian_or_int(seed: int, n: int, dims: int, kind: str):
    rng = np.random.default_rng(seed)
    if kind == "int":
        x = rng.integers(0, 256, (n, dims)).astype(np.float32)
    else:
        x = rng.standard_normal((n, dims)).astype(np.float32)
    x[7] = x[3]                 # duplicate rows: tied distances
    x[11] = x[3]
    return x


def clustered(seed: int, n_clusters: int, per_cluster, dims: int,
              spacing: int = 32):
    """Integer rows in [0, 255] around ``n_clusters`` distinct lattice
    points ``spacing`` apart, each row moved by 0 or 1 per dim: every row
    is far nearer its own cluster than any other. ``per_cluster`` is a
    count or one count per cluster. Rows come shuffled."""
    rng = np.random.default_rng(seed)
    side = 256 // spacing
    codes = rng.choice(side ** min(dims, 6), n_clusters, replace=False)
    centers = np.zeros((n_clusters, dims), np.float32)
    for d in range(min(dims, 6)):
        centers[:, d] = (codes // side ** d) % side * spacing
    centers[:, 6:] = rng.integers(0, 256 - spacing, (n_clusters,
                                                     max(dims - 6, 0)))
    counts = np.broadcast_to(per_cluster, (n_clusters,))
    which = np.repeat(np.arange(n_clusters), counts)
    x = centers[which] + rng.integers(0, 2, (len(which), dims))
    return x[rng.permutation(len(which))].astype(np.float32)


# ---------------------------------------------------------------------------
# the four programs
# ---------------------------------------------------------------------------

def _bf16(a):
    return T(a).to(torch.bfloat16).double().numpy()


def assert_assign_near_ties(x, cents, got, want):
    """Rows whose assignment differs are near-ties: both packages' values
    of c2 - 2 * dot for the two centroids lie within the f32
    summation-order bound of each other."""
    diff = np.nonzero(got != want)[0]
    assert len(diff) <= max(2, len(x) // 200), len(diff)
    d = x.shape[1]
    gamma = d * 2.0 ** -24
    xb, cb = _bf16(x[diff]), _bf16(cents)
    c64 = cents.astype(np.float64)
    for r, i in enumerate(diff):
        vals, bounds = [], []
        for c in (got[i], want[i]):
            prod = xb[r] * cb[c]
            vals.append((c64[c] ** 2).sum() - 2 * prod.sum())
            bounds.append(gamma * ((c64[c] ** 2).sum() +
                                   2 * np.abs(prod).sum()))
        assert abs(vals[0] - vals[1]) <= 2 * sum(bounds), (i, vals, bounds)


ASSIGN_CASES = [(kind, dims, nlist) for kind in ("int", "gauss")
                for dims, nlist in ((16, 37), (40, 200), (128, 64))]


@pytest.mark.parametrize("kind,dims,nlist", ASSIGN_CASES,
                         ids=["-".join(map(str, c)) for c in ASSIGN_CASES])
def test_assign_matches_reference(kind, dims, nlist):
    x = gaussian_or_int(1, 2500, dims, kind)
    rng = np.random.default_rng(2)
    cents = x[rng.choice(len(x), nlist, replace=False)].copy()
    cents[5] = cents[2]          # tied centroids: the lower index wins
    if kind == "gauss":
        cents += np.float32(0.01) * rng.standard_normal(
            cents.shape).astype(np.float32)
        cents[5] = cents[2]
    want = np.asarray(ref._assign(jnp.asarray(x), jnp.asarray(cents),
                                  nlist))
    got = port.ivf_assign(T(x), T(cents)).numpy()
    assert got.dtype == np.int32
    assert not (got == 5).any()
    if kind == "int":
        np.testing.assert_array_equal(got, want)
    else:
        assert_assign_near_ties(x, cents, got, want)


@pytest.mark.parametrize("kind", ["int", "gauss"])
@pytest.mark.parametrize("dims,nlist", [(16, 40), (96, 300)])
def test_update_matches_reference_bit_for_bit(kind, dims, nlist):
    """Row-order sums: equal bits on Gaussian data too; ids outside
    [0, nlist) are dropped and empty clusters keep their centroid."""
    x = gaussian_or_int(3, 3000, dims, kind)
    rng = np.random.default_rng(4)
    assign = rng.integers(0, nlist - 7, len(x)).astype(np.int32)
    assign[:5] = -1
    assign[5:9] = nlist + 3
    cents = rng.standard_normal((nlist, dims)).astype(np.float32)
    want = np.asarray(ref._update(jnp.asarray(x), jnp.asarray(assign),
                                  jnp.asarray(cents), nlist))
    got = port.ivf_update(T(x), T(assign), T(cents)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(got[nlist - 7:], cents[nlist - 7:])


@pytest.mark.parametrize("dims,nlist,first", [(16, 50, 0), (40, 64, 17),
                                              (100, 33, 1999)])
def test_farthest_point_init_matches_reference(dims, nlist, first):
    """Integer-valued rows (with duplicates): distances are exact in any
    order, so the seeding is equal bit for bit, first-index ties
    included."""
    x = gaussian_or_int(5, 2000, dims, "int")
    x[100:140] = x[0]            # many equal farthest candidates
    want = np.asarray(ref._farthest_point_init(
        jnp.asarray(x), jnp.asarray(first), nlist))
    got = port.ivf_init(T(x), first, nlist).numpy()
    np.testing.assert_array_equal(got, want)


def test_kmeans_cold_and_warm_match_reference():
    x = clustered(6, 24, 60, 16)
    want = ref.kmeans(x, 24, seed=3)
    got = port.kmeans(x, 24, seed=3, device="cpu")
    np.testing.assert_array_equal(got, want)
    y = np.concatenate([x, clustered(7, 24, 10, 16)])
    np.testing.assert_array_equal(
        port.kmeans(y, 24, init_centroids=got, device="cpu"),
        ref.kmeans(y, 24, init_centroids=want))
    # fewer rows than lists: the rows, repeated
    np.testing.assert_array_equal(port.kmeans(x[:5], 8, device="cpu"),
                                  ref.kmeans(x[:5], 8))


@pytest.mark.parametrize("sim", SIMS)
def test_build_matches_reference(sim):
    """Same centroids, lists, valid, ids and norms, including rows that
    overflow their list and spill to the next-nearest centroid."""
    sizes = np.full(20, 40)
    sizes[0], sizes[1] = 170, 95            # over the lists' cap (66)
    x = clustered(8, 20, sizes, 24)
    r = ref.IVFIndex.build(x, nlist=20, similarity=sim)
    p = port.IVFIndex.build(x, nlist=20, similarity=sim, device="cpu")
    assert (p.nlist, p.list_len) == (r.nlist, r.list_len)
    for name in ("centroids", "lists", "valid", "ids", "norms"):
        np.testing.assert_array_equal(getattr(p, name).numpy(),
                                      np.asarray(getattr(r, name)))
    assert not p.warm_started
    assert p._charge.n_bytes == r._charge.n_bytes


@pytest.mark.parametrize("kind", ["int", "gauss"])
@pytest.mark.parametrize("sim", SIMS)
def test_search_matches_reference_on_one_index(kind, sim):
    """The port's probe on a JAX-built index, carried across as arrays:
    the same ids, scores within the stated bound; nprobe up to nlist and k
    above the probed pool (clamped)."""
    rng = np.random.default_rng(9)
    x = gaussian_or_int(10, 1500, 32, kind)
    r = ref.IVFIndex.build(x, nlist=30, similarity=sim)
    p = ivf_from_reference(r.centroids, r.lists, r.valid, r.ids, r.norms,
                           sim, "cpu")
    q = x[rng.integers(0, len(x), 7)] + (
        rng.integers(-2, 3, (7, 32)) if kind == "int"
        else 0.1 * rng.standard_normal((7, 32))).astype(np.float32)
    q[-1] = 0.0                                   # an all-zero query
    for nprobe, k in ((1, 10), (4, 10), (4, 10 ** 4), (30, 50)):
        rs, ri = r.search(q, k, nprobe)
        ps, pi = p.search(q, k, nprobe)
        assert ps.shape == rs.shape and pi.dtype == np.int32
        if kind == "int":
            np.testing.assert_array_equal(pi, ri)
            np.testing.assert_array_equal(ps, rs)
        else:
            np.testing.assert_allclose(ps, rs, rtol=RTOL)
            close_ids(rs, ri, pi, RTOL)


def test_tied_scores_resolve_in_probe_order():
    """Equal scores order by probe rank, then list position -- not by doc
    id -- in both packages, and ids past the valid slots are -1 with score
    0. Under dot_product an axis query scores a doc by one coordinate, so
    docs of different lists tie."""
    x = clustered(11, 6, 12, 16)
    r = ref.IVFIndex.build(x, nlist=6, similarity="dot_product")
    p = ivf_from_reference(r.centroids, r.lists, r.valid, r.ids, r.norms,
                           "dot_product", "cpu")
    q = np.zeros((2, 16), np.float32)
    q[0, 0] = 1.0
    q[1, 3] = 1.0
    rs, ri = r.search(q, 72, 6)
    ps, pi = p.search(q, 72, 6)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_array_equal(ps, rs)
    runs = [pi[0][ps[0] == s] for s in np.unique(ps[0])]
    assert any(len(run) > 1 for run in runs)
    assert any(list(run) != sorted(run) for run in runs)
    # a pool larger than the valid slots: the tail is -1 / 0.0
    rs, ri = r.search(q, 10 ** 6, 2)
    ps, pi = p.search(q, 10 ** 6, 2)
    np.testing.assert_array_equal(pi, ri)
    assert (pi[0] == -1).any() and (ps[0][pi[0] == -1] == 0).all()


def test_probe_live_matches_reference():
    x = clustered(12, 10, 30, 16)
    rows = np.arange(len(x)) * 2 + 1          # the segment rows with vectors
    live = np.ones(2 * len(x) + 1, bool)
    live[rows[::3]] = False
    r = ref.IVFIndex.build(x, nlist=10, similarity="cosine")
    p = ivf_from_reference(r.centroids, r.lists, r.valid, r.ids, r.norms,
                           "cosine", "cpu")
    q = x[[4, 50, 120]]
    want = r.probe_live(q, 10, 3, rows, live, 2, 26)
    assert p.probe_live(q, 10, 3, rows, live, 2, 26) == want


def test_probe_k_above_kmax_is_refused():
    """(The name predates the wide selection, which this test once proved
    refused.) A probe whose k passes the kernels' 4,096-entry selection is
    served as the JAX package serves it: ids and scores equal."""
    x = clustered(13, 4, 1500, 8)
    r = ref.IVFIndex.build(x, nlist=4, similarity="cosine")
    p = port.IVFIndex.build(x, nlist=4, device="cpu")
    rs, ri = r.search(x[:1], 5000, 4)
    ps, pi = p.search(x[:1], 5000, 4)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_array_equal(ps, rs)


def test_cuda_tensors_never_take_the_plain_version(monkeypatch):
    """An IVF wrapper given CUDA tensors launches its kernel or raises:
    with the kernel library unavailable it raises instead of computing on
    the host."""
    from elasticsearch_tpu_torch import _build
    from elasticsearch_tpu_torch.ops import bm25 as port_bm25

    def no_library(family):
        raise _build.KernelBuildError("kernel library unavailable")

    monkeypatch.setattr(_build, "library", no_library)
    monkeypatch.setattr(port_bm25, "_FNS", {})
    monkeypatch.setattr(port, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(port, "_stream", lambda: 0)
    for name in ("ivf_assign_plain", "ivf_update_plain", "ivf_init_plain",
                 "ivf_search_plain"):
        monkeypatch.setattr(port, name, lambda *a, **k: pytest.fail(
            "plain version ran for a CUDA call"))
    x = T(gaussian_or_int(14, 64, 8, "int"))
    c = x[:4].clone()
    with pytest.raises(_build.KernelBuildError):
        port.ivf_assign(x, c)
    with pytest.raises(_build.KernelBuildError):
        port.ivf_update(x, torch.zeros(64, dtype=torch.int32), c)
    with pytest.raises(_build.KernelBuildError):
        port.ivf_init(x, 0, 4)
    lists = x.reshape(4, 16, 8)
    with pytest.raises(_build.KernelBuildError):
        port.ivf_search(x[:2], torch.ones(2), torch.ones(2), c, lists,
                        torch.ones(4, 16, dtype=torch.bool),
                        torch.zeros(4, 16, dtype=torch.int32),
                        torch.ones(4, 16), 5, 2)


# ---------------------------------------------------------------------------
# served: knn on IVF-routed fields, against a JAX node
# ---------------------------------------------------------------------------

DIMS = 16


def ivf_mapping(sim: str, nlist: int):
    return {"properties": {
        "vec": {"type": "dense_vector", "dims": DIMS, "similarity": sim,
                "index_options": {"type": "ivf", "nlist": nlist}},
        "tag": {"type": "keyword"}}}


def add_docs(engines, vectors, start: int, refresh_at=()):
    for i, v in enumerate(vectors, start):
        body = {"vec": [float(x) for x in v], "tag": f"t{i % 5}"}
        for e in engines:
            e.index(str(i), body)
        if i in refresh_at:
            for e in engines:
                e.refresh()
    for e in engines:
        e.refresh()


def knn_bodies(rng, corpus, n: int):
    out = []
    for i in range(n):
        q = corpus[rng.integers(0, len(corpus))] + rng.integers(0, 3, DIMS)
        k, nc = ((10, 40), (5, 200), (25, 90), (10, 10))[i % 4]
        body = {"query": {"knn": {"field": "vec",
                                  "query_vector": [float(v) for v in q],
                                  "k": k, "num_candidates": nc}},
                "size": 10}
        if i % 4 == 2:
            body["from"] = 5
        if i % 4 == 3:
            body["query"]["knn"]["boost"] = 2.0
        out.append(body)
    return out


def assert_same(ref_svc, port_svc, bodies):
    for body in bodies:
        a, b = ref_svc.search(body), port_svc.search(body)
        assert a["hits"]["total"] == b["hits"]["total"]
        assert [h["_id"] for h in a["hits"]["hits"]] == \
            [h["_id"] for h in b["hits"]["hits"]]
        assert [h["_score"] for h in a["hits"]["hits"]] == \
            [h["_score"] for h in b["hits"]["hits"]]
        assert a["hits"]["max_score"] == b["hits"]["max_score"]


@pytest.mark.parametrize("sim", SIMS)
@pytest.mark.parametrize("route", ["plane", "per_segment"])
@pytest.mark.parametrize("quantized", [True, False])
def test_ivf_knn_responses_match_reference(sim, route, quantized, planes):
    """index_options {type: ivf, nlist: 12} on small segments: each
    segment (or the shard plane) probes its own IVF index. Then deletes
    after the build, and a refresh that starts a new plane generation
    (warm-started k-means on the plane route)."""
    for p in (REF_PLANES, PLANES):
        p.enabled = route == "plane"
        p.quantized = quantized
    corpus = clustered(20, 12, 40, DIMS)
    ref_e = RefEngine(RefMappers(ivf_mapping(sim, 12)), shard_label="ref")
    port_e = InternalEngine(MapperService(ivf_mapping(sim, 12)),
                            shard_label="port")
    add_docs((ref_e, port_e), corpus[:300], 0, refresh_at=(150,))
    ref_svc, port_svc = RefService(ref_e), SearchService(port_e,
                                                         device="cpu")
    rng = np.random.default_rng(21)
    assert_same(ref_svc, port_svc, knn_bodies(rng, corpus, 8))
    for i in (3, 77, 160, 299):                   # deletes after the build
        ref_e.delete(str(i))
        port_e.delete(str(i))
    for e in (ref_e, port_e):
        e.refresh()
    assert_same(ref_svc, port_svc, knn_bodies(rng, corpus, 8))
    warm0 = (REF_PLANES.stats["ivf_warm_starts"],
             PLANES.stats["ivf_warm_starts"])
    add_docs((ref_e, port_e), corpus[300:], 300)   # a new segment
    assert_same(ref_svc, port_svc, knn_bodies(rng, corpus, 8))
    warm = (REF_PLANES.stats["ivf_warm_starts"] - warm0[0],
            PLANES.stats["ivf_warm_starts"] - warm0[1])
    assert warm[0] == warm[1] == (1 if route == "plane" else 0)
