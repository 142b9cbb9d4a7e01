"""The mesh data plane of elasticsearch_tpu_torch against the JAX package.

A node booted with ``mesh_data_plane=True`` answers an eligible
whole-index ``match``, bool-of-should ``match``, unfiltered ``knn`` or
``text_expansion`` with one sharded launch over the index's live docs
(``parallel/mesh_plane.py`` ``MeshDataPlane``, rows 40, 42 and 43),
marking the answer ``"_data_plane": "mesh"``:

- the reference's own identities (``tests/test_mesh_plane.py``'s 9
  tests) on a port node, the stub-index total clamp included;
- a port node against a reference node, both ``mesh_data_plane=True``
  (the port's default S = 8 slots, the reference node's 8 virtual
  devices), on 2 and 4 shards: text, bool-should, kNN under the three
  similarities, ``text_expansion`` with ``tokens`` and ``model_text``,
  ``track_total_hits`` default, false, 3 and true (which leaves the data
  plane on both), with deletes and refreshes between rounds: the same
  JSON, ``_data_plane`` included, scores to rtol 1e-6 (ROADMAP queue 3,
  item 5), and the same build counters;
- a failing sharded kernel: logged at error level, counted in
  ``mesh_fallbacks``, the request answered by the RPC fan-out;
- ``mesh_slots``: a node at S 4 serves a default (S 8) node's docs and
  scores; a card that does not initialize at boot is logged.
"""

import copy
import logging

import numpy as np
import pytest

from elasticsearch_tpu.rest.controller import RestRequest as RefRequest
from elasticsearch_tpu.rest.routes import build_controller as ref_controller
from elasticsearch_tpu.testing import InProcessCluster as RefCluster
from elasticsearch_tpu_torch._build import KernelError
from elasticsearch_tpu_torch.parallel import sharded_search
from elasticsearch_tpu_torch.rest.controller import RestRequest
from elasticsearch_tpu_torch.rest.routes import build_controller
from elasticsearch_tpu_torch.testing import InProcessCluster
from test_torch_mesh import RestCaller
from test_torch_node import bulk_lines, same


@pytest.fixture()
def cluster():
    c = InProcessCluster(n_nodes=1, seed=3, mesh_data_plane=True,
                         device="cpu")
    c.start()
    yield c
    c.stop()


def _ok(resp, err):
    assert err is None, f"unexpected error: {err}"
    return resp


WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
         "theta", "iota", "kappa"]


def _index_corpus(cluster, client, name="mesh", n=60, shards=3):
    cluster.call(lambda cb: client.create_index(
        name, {"settings": {"number_of_shards": shards,
                            "number_of_replicas": 0}}, cb))
    cluster.ensure_green(name)
    rng = np.random.default_rng(7)
    for i in range(n):
        text = " ".join(rng.choice(WORDS, size=int(rng.integers(3, 9))))
        resp, err = cluster.call(lambda cb, i=i, text=text: client.index_doc(
            name, f"d{i}", {"body": text, "n": i}, cb))
        _ok(resp, err)
    cluster.call(lambda cb: client.refresh(name, cb))


# ---------------------------------------------------------------------------
# the reference's identities (tests/test_mesh_plane.py) on the port
# ---------------------------------------------------------------------------

def test_mesh_path_serves_eligible_search(cluster):
    client = cluster.client()
    _index_corpus(cluster, client)
    q = {"query": {"match": {"body": "alpha gamma"}}, "size": 8}
    rpc, err = cluster.call(lambda cb: client.search(
        "mesh", {**q, "track_total_hits": True}, cb))
    _ok(rpc, err)
    assert "_data_plane" not in rpc
    default, err = cluster.call(lambda cb: client.search("mesh", q, cb))
    _ok(default, err)
    assert default.get("_data_plane") == "mesh"
    assert default["hits"]["total"] == rpc["hits"]["total"]
    clipped, err = cluster.call(lambda cb: client.search(
        "mesh", {**q, "track_total_hits": 3}, cb))
    _ok(clipped, err)
    assert clipped.get("_data_plane") == "mesh"
    assert clipped["hits"]["total"] == {"value": 3, "relation": "gte"}
    # on a mesh_data_plane node the DFS request is mesh-served too (the
    # mesh path runs before the search type is read): as in the
    # reference's test, this compares the mesh with itself
    dfs, err = cluster.call(lambda cb: client.search(
        "mesh", q, cb, search_type="dfs_query_then_fetch"))
    _ok(dfs, err)
    mesh, err = cluster.call(lambda cb: client.search(
        "mesh", {**q, "track_total_hits": False}, cb))
    _ok(mesh, err)
    assert mesh.get("_data_plane") == "mesh"
    assert set(h["_id"] for h in mesh["hits"]["hits"]) == \
        set(h["_id"] for h in dfs["hits"]["hits"])
    np.testing.assert_allclose(
        [h["_score"] for h in mesh["hits"]["hits"]],
        [h["_score"] for h in dfs["hits"]["hits"]], rtol=1e-5, atol=1e-5)
    assert all("_source" in h for h in mesh["hits"]["hits"])
    stats = cluster.master().mesh_plane.stats
    assert stats["mesh_queries"] >= 3 and stats["mesh_builds"] == 1


def test_mesh_cache_invalidated_on_change(cluster):
    client = cluster.client()
    _index_corpus(cluster, client, name="inv", n=30, shards=2)
    body = {"query": {"match": {"body": "beta"}},
            "track_total_hits": False, "size": 5}
    r1, err = cluster.call(lambda cb: client.search("inv", body, cb))
    _ok(r1, err)
    assert r1.get("_data_plane") == "mesh"
    builds0 = cluster.master().mesh_plane.stats["mesh_builds"]
    r2, err = cluster.call(lambda cb: client.search("inv", body, cb))
    _ok(r2, err)
    assert cluster.master().mesh_plane.stats["mesh_builds"] == builds0
    resp, err = cluster.call(lambda cb: client.index_doc(
        "inv", "fresh", {"body": "omicronunique beta"}, cb))
    _ok(resp, err)
    cluster.call(lambda cb: client.refresh("inv", cb))
    r3, err = cluster.call(lambda cb: client.search(
        "inv", {"query": {"match": {"body": "omicronunique"}},
                "track_total_hits": False, "size": 5}, cb))
    _ok(r3, err)
    assert r3.get("_data_plane") == "mesh"
    assert [h["_id"] for h in r3["hits"]["hits"]] == ["fresh"]
    assert cluster.master().mesh_plane.stats["mesh_builds"] > builds0


def test_mesh_respects_deletes(cluster):
    client = cluster.client()
    _index_corpus(cluster, client, name="del", n=20, shards=2)
    body = {"query": {"match": {"body": "alpha"}},
            "track_total_hits": False, "size": 20}
    r1, err = cluster.call(lambda cb: client.search("del", body, cb))
    _ok(r1, err)
    got = [h["_id"] for h in r1["hits"]["hits"]]
    assert got, "the seeded corpus holds alpha docs"
    victim = got[0]
    resp, err = cluster.call(lambda cb: client.delete_doc("del", victim, cb))
    _ok(resp, err)
    cluster.call(lambda cb: client.refresh("del", cb))
    r2, err = cluster.call(lambda cb: client.search("del", body, cb))
    _ok(r2, err)
    assert r2.get("_data_plane") == "mesh"
    assert victim not in [h["_id"] for h in r2["hits"]["hits"]]


def test_ineligible_queries_fall_back_to_rpc(cluster):
    client = cluster.client()
    _index_corpus(cluster, client, name="fb", n=20, shards=2)
    for body in (
        {"query": {"bool": {"must": [{"match": {"body": "alpha"}}]}},
         "track_total_hits": False},
        {"query": {"match": {"body": "alpha"}},
         "track_total_hits": True},
        {"query": {"match": {"body": "alpha"}},
         "track_total_hits": False, "sort": [{"n": "asc"}]},
        {"query": {"match": {"body": "alpha"}},
         "track_total_hits": False,
         "aggs": {"m": {"max": {"field": "n"}}}},
    ):
        resp, err = cluster.call(lambda cb, b=body: client.search(
            "fb", b, cb))
        _ok(resp, err)
        assert "_data_plane" not in resp, body


def test_mesh_serves_bool_should(cluster):
    client = cluster.client()
    _index_corpus(cluster, client, name="bs", n=40, shards=2)
    body = {"query": {"bool": {"should": [
        {"match": {"body": {"query": "alpha", "boost": 2.0}}},
        {"match": {"body": "gamma delta"}}]}}, "size": 8,
        "track_total_hits": False}
    mesh, err = cluster.call(lambda cb: client.search("bs", body, cb))
    _ok(mesh, err)
    assert mesh.get("_data_plane") == "mesh"
    dfs, err = cluster.call(lambda cb: client.search(
        "bs", body, cb, search_type="dfs_query_then_fetch"))
    _ok(dfs, err)
    assert set(h["_id"] for h in mesh["hits"]["hits"]) == \
        set(h["_id"] for h in dfs["hits"]["hits"])
    np.testing.assert_allclose(
        [h["_score"] for h in mesh["hits"]["hits"]],
        [h["_score"] for h in dfs["hits"]["hits"]], rtol=1e-5, atol=1e-5)


def test_mesh_serves_knn(cluster):
    client = cluster.client()
    cluster.call(lambda cb: client.create_index("vecs", {
        "settings": {"number_of_shards": 2, "number_of_replicas": 0},
        "mappings": {"properties": {
            "vec": {"type": "dense_vector", "dims": 8,
                    "similarity": "cosine"}}}}, cb))
    cluster.ensure_green("vecs")
    rng = np.random.default_rng(11)
    vecs = rng.standard_normal((30, 8)).astype(np.float32)
    for i in range(30):
        resp, err = cluster.call(lambda cb, i=i: client.index_doc(
            "vecs", f"v{i}", {"vec": vecs[i].tolist()}, cb))
        _ok(resp, err)
    cluster.call(lambda cb: client.refresh("vecs", cb))
    qv = rng.standard_normal(8).astype(np.float32)
    body = {"query": {"knn": {"field": "vec", "query_vector": qv.tolist(),
                              "k": 5, "num_candidates": 30}}, "size": 5}
    mesh, err = cluster.call(lambda cb: client.search("vecs", body, cb))
    _ok(mesh, err)
    assert mesh.get("_data_plane") == "mesh"
    sims = (vecs @ qv) / (np.linalg.norm(vecs, axis=1)
                          * np.linalg.norm(qv) + 1e-30)
    expect = [f"v{i}" for i in np.argsort(-sims)[:5]]
    assert [h["_id"] for h in mesh["hits"]["hits"]] == expect


def test_mesh_serves_text_expansion(cluster):
    client = cluster.client()
    cluster.call(lambda cb: client.create_index("sp", {
        "settings": {"number_of_shards": 2, "number_of_replicas": 0},
        "mappings": {"properties": {
            "feats": {"type": "rank_features"}}}}, cb))
    cluster.ensure_green("sp")
    rng = np.random.default_rng(13)
    feats = [f"f{i}" for i in range(12)]
    docs = []
    for i in range(24):
        chosen = rng.choice(feats, size=int(rng.integers(2, 6)),
                            replace=False)
        docs.append({f: float(rng.uniform(0.5, 3.0)) for f in chosen})
        resp, err = cluster.call(lambda cb, i=i: client.index_doc(
            "sp", f"s{i}", {"feats": docs[i]}, cb))
        _ok(resp, err)
    cluster.call(lambda cb: client.refresh("sp", cb))
    tokens = {"f1": 1.5, "f3": 0.7, "f8": 2.0}
    body = {"query": {"text_expansion": {"feats": {
        "tokens": tokens}}}, "size": 6}
    mesh, err = cluster.call(lambda cb: client.search("sp", body, cb))
    _ok(mesh, err)
    assert mesh.get("_data_plane") == "mesh"
    truth = []
    for i, d in enumerate(docs):
        sc = sum(w * d.get(f, 0.0) for f, w in tokens.items())
        if sc > 0:
            truth.append((sc, f"s{i}"))
    truth.sort(key=lambda x: (-x[0], x[1]))
    assert set(h["_id"] for h in mesh["hits"]["hits"]) == \
        set(t[1] for t in truth[:6])


def test_mesh_build_cost_is_observable(cluster):
    client = cluster.client()
    _index_corpus(cluster, client, name="bt", n=30, shards=2)
    body = {"query": {"match": {"body": "beta"}},
            "track_total_hits": False, "size": 5}
    r, err = cluster.call(lambda cb: client.search("bt", body, cb))
    _ok(r, err)
    stats = cluster.master().mesh_plane.stats
    assert stats["mesh_builds"] >= 1
    assert stats["last_build_seconds"] > 0
    assert stats["last_build_docs"] == 30
    assert stats["build_seconds_total"] >= stats["last_build_seconds"]
    before = stats["mesh_builds"]
    r, err = cluster.call(lambda cb: client.index_doc(
        "bt", "new", {"body": "beta fresh"}, cb))
    _ok(r, err)
    cluster.call(lambda cb: client.refresh("bt", cb))
    r, err = cluster.call(lambda cb: client.search("bt", body, cb))
    _ok(r, err)
    assert stats["mesh_builds"] == before + 1
    assert stats["last_build_docs"] == 31


def test_mesh_knn_total_clamped_to_hits_returned():
    """The kNN hit window (size+from) is not bounded by query.k, so the
    total clamps to at least the hits returned; driven against a stub
    vector index."""
    from types import SimpleNamespace

    from elasticsearch_tpu_torch.parallel.mesh_plane import MeshDataPlane
    from elasticsearch_tpu_torch.search import dsl

    plane = MeshDataPlane(device="cpu")    # a CPU plane is always available
    n_docs = 1000

    class StubVectorIndex:
        n_docs = 1000

        def search(self, qv, k):
            scores = np.linspace(2.0, 1.0, k, dtype=np.float32)[None, :]
            ids = np.arange(k, dtype=np.int32)[None, :]
            return scores, ids

    id_map = (np.zeros(n_docs, np.int32), np.zeros(n_docs, np.int32),
              np.arange(n_docs, dtype=np.int32))
    shard_counts = np.array([n_docs])
    plane._vector_index = lambda *a: (StubVectorIndex(), id_map,
                                      shard_counts)
    shard = SimpleNamespace(engine=SimpleNamespace(
        acquire_reader=lambda: None))
    query = dsl.Knn(field="vec", query_vector=[0.0, 1.0], k=10)
    result = plane.search_knn("idx", "vec", {0: shard}, {"size": 100}, query)
    assert len(result["hits"]) == 100
    assert result["total"] >= len(result["hits"])
    assert result["relation"] == "eq"


# ---------------------------------------------------------------------------
# a port node against a reference node, both mesh_data_plane=True
# ---------------------------------------------------------------------------

VOCAB = [f"w{i}" for i in range(40)]
SIMS = ("cosine", "dot_product", "l2_norm")
MAPPINGS = {"properties": {
    "body": {"type": "text"},
    **{f"v_{s}": {"type": "dense_vector", "dims": 8, "similarity": s}
       for s in SIMS},
    "feats": {"type": "rank_features"}}}


def _unit(v):
    return [round(float(x), 4) for x in v / np.linalg.norm(v)]


MODEL_TEXT = "w1 w4 w9"


def _model_features():
    """The features the default expansion model gives MODEL_TEXT."""
    from elasticsearch_tpu_torch.ml import get_model
    return sorted(get_model(None, "cpu").expand(MODEL_TEXT))


def _docs(seed: int, n: int, base: int = 0):
    """Docs of 3-11 Zipf words over 40, a vector a similarity
    (dot_product's unit length, as the mapping requires), 2-4 of 16
    features and 0-2 of MODEL_TEXT's expansion; every 9th doc repeats an
    earlier one's fields (ties)."""
    rng = np.random.default_rng(seed)
    model = _model_features()
    out = []
    for i in range(n):
        if i % 9 == 8 and out:
            out.append((f"d{base + i}",
                        dict(out[int(rng.integers(0, len(out)))][1])))
            continue
        v = rng.standard_normal(8)
        out.append((f"d{base + i}", {
            "body": " ".join(VOCAB[min(int(rng.zipf(1.3)) - 1, 39)]
                             for _ in range(int(rng.integers(3, 12)))),
            "v_cosine": [round(float(x), 4) for x in v],
            "v_dot_product": _unit(v),
            "v_l2_norm": [round(float(x), 4) for x in 2.0 * v],
            "feats": {**{f"f{int(f)}": round(float(rng.uniform(0.1, 3.0)),
                                             3)
                         for f in rng.integers(0, 16,
                                               int(rng.integers(2, 5)))},
                      **{model[int(f)]: round(float(rng.uniform(0.1, 3.0)),
                                              3)
                         for f in rng.choice(len(model),
                                             int(rng.integers(0, 3)),
                                             replace=False)}},
        }))
    return out


def _bodies():
    rng = np.random.default_rng(77)
    out = []
    for track in (None, False, 3, True):
        extra = {} if track is None else {"track_total_hits": track}
        out.append((f"match_{track}", {"query": {"match": {
            "body": "w0 w3 w11"}}, "size": 8, **extra}))
        out.append((f"bool_should_{track}", {"query": {"bool": {"should": [
            {"match": {"body": "w1 w2"}},
            {"match": {"body": {"query": "w7", "boost": 2.0}}}]}},
            "size": 6, **extra}))
        out.append((f"tokens_{track}", {"query": {"text_expansion": {
            "feats": {"tokens": {"f1": 1.2, "f4": 0.7, "f9": 0.3}}}},
            "size": 7, **extra}))
    out.append(("match_from", {"query": {"match": {"body": "w2 w5"}},
                               "from": 3, "size": 5}))
    for s in SIMS:
        qv = rng.standard_normal(8)
        qv = _unit(qv) if s == "dot_product" else [round(float(x), 4)
                                                    for x in qv]
        out.append((f"knn_{s}", {"query": {"knn": {
            "field": f"v_{s}", "query_vector": qv, "k": 6,
            "num_candidates": 40}}, "size": 6}))
    out.append(("model_text", {"query": {"text_expansion": {"feats": {
        "model_text": MODEL_TEXT}}}, "size": 5}))
    return out


def _model_text_atol(resp) -> float:
    """ROADMAP queue 3, item 6: the most a ``model_text`` score may move
    when the two packages' models round a query weight 1e-4 apart."""
    from elasticsearch_tpu.ml import text_expansion as ref_ml
    query = ref_ml.get_model().expand(MODEL_TEXT)
    docs = max((sum(h["_source"]["feats"].get(f, 0.0) for f in query)
                for h in resp["hits"]["hits"]), default=0.0)
    return 1e-4 * (sum(query.values()) + docs + len(query))


_NODES = {}


def mesh_nodes(shards: int):
    """(reference caller, port caller), both ``mesh_data_plane=True``, with
    index ``p{shards}`` loaded through ``_bulk`` with a refresh between
    halves and deletes."""
    if shards not in _NODES:
        ref = RefCluster(n_nodes=1, seed=31, mesh_data_plane=True)
        port = InProcessCluster(n_nodes=1, seed=31, mesh_data_plane=True,
                                device="cpu")
        callers = []
        for c, ctl, req in ((ref, ref_controller, RefRequest),
                            (port, build_controller, RestRequest)):
            c.start()
            drive = RestCaller(c, ctl(c.client()), req)
            index = f"p{shards}"
            for method, path, body in [
                    ("PUT", f"/{index}", {"settings": {
                        "number_of_shards": shards,
                        "number_of_replicas": 0}, "mappings": MAPPINGS}),
                    ("POST", "/_bulk", bulk_lines(index, _docs(1, 120))),
                    ("POST", f"/{index}/_refresh", None),
                    ("POST", "/_bulk", bulk_lines(
                        index, _docs(2, 70, base=120),
                        deletes=[f"d{i}" for i in range(0, 190, 19)])),
                    ("POST", f"/{index}/_refresh", None)]:
                status, resp = drive(method, path, body)
                assert status < 300, (path, status, resp)
            callers.append(drive)
        _NODES[shards] = tuple(callers)
    return _NODES[shards]


def _node(drive):
    return next(iter(drive.cluster.nodes.values()))


def _check_round(shards: int):
    ref, port = mesh_nodes(shards)
    path = f"/p{shards}/_search"
    for name, body in _bodies():
        s_r, want = ref("POST", path, copy.deepcopy(body))
        s_p, got = port("POST", path, copy.deepcopy(body))
        assert s_r == s_p == 200, (name, want, got)
        assert got.get("_data_plane") == want.get("_data_plane"), \
            (name, got.get("_data_plane"), want.get("_data_plane"))
        # exact totals leave the data plane (the mesh executor
        # may then serve the fan-out: "mesh_plane" on both)
        assert (got.get("_data_plane") == "mesh") == \
            (body.get("track_total_hits") is not True), name
        if name.startswith(("tokens", "model_text")):
            assert got["hits"]["hits"], name
        same(want, got, atol=_model_text_atol(want) if name == "model_text"
             else 0.0)
    for key in ("mesh_builds", "last_build_docs", "mesh_queries"):
        assert _node(port).mesh_plane.stats[key] == \
            _node(ref).mesh_plane.stats[key], key


@pytest.mark.parametrize("shards", [2, 4], ids=["two_shards", "four_shards"])
def test_port_node_gives_the_reference_json(shards):
    """Every body on 2 and 4 shards: the port's JSON is the reference's,
    ``_data_plane: "mesh"`` included; then new docs, deletes and a
    refresh on both nodes, and every body again."""
    _check_round(shards)
    ref, port = mesh_nodes(shards)
    index = f"p{shards}"
    for drive in (ref, port):
        for method, path, body in (
                ("POST", "/_bulk", bulk_lines(
                    index, _docs(3, 40, base=400),
                    deletes=["d3", "d121", "d122", "d405"])),
                ("POST", f"/{index}/_refresh", None)):
            assert drive(method, path, body)[0] < 300
    _check_round(shards)


def test_a_failing_sharded_kernel_is_logged_and_served_by_rpc(
        monkeypatch, caplog):
    """A sharded kernel that raises (as a launch on the card raises
    KernelError): the request is answered by the RPC fan-out, counted in
    ``mesh_fallbacks`` and logged at error level, naming the family."""
    _ref, port = mesh_nodes(2)
    node = _node(port)
    body = {"query": {"match": {"body": "w0 w3"}}, "size": 6,
            "track_total_hits": 5}
    status, rpc = port("POST", "/p2/_search",
                       {**copy.deepcopy(body), "track_total_hits": True})
    assert status == 200 and rpc.get("_data_plane") != "mesh"

    def fail(*args, **kwargs):
        raise KernelError("[sharded_bm25_batch] kernel launch failed: CUDA "
                          "error 700")
    monkeypatch.setattr(sharded_search, "sharded_bm25_batch", fail)
    fallbacks = node.mesh_plane.stats["mesh_fallbacks"]
    with caplog.at_level(logging.ERROR):
        status, got = port("POST", "/p2/_search", copy.deepcopy(body))
    assert status == 200 and got.get("_data_plane") != "mesh"
    assert node.mesh_plane.stats["mesh_fallbacks"] == fallbacks + 1
    errors = [r for r in caplog.records if r.levelno >= logging.ERROR]
    assert errors and errors[0].exc_info is not None
    assert "sharded_bm25_batch" in caplog.text
    want = dict(rpc, hits=dict(rpc["hits"], total={"value": 5,
                                                   "relation": "gte"}))
    same(want, got)


def test_mesh_slots_set_the_data_planes_layout(cluster):
    """``mesh_slots`` is the node's S: a node booted with 4 slots serves
    the same docs with the same scores as a default (8-slot) node. Only
    the order of tied docs may differ (ties break by slot)."""
    assert cluster.master().mesh_plane.mesh.n_slots == 8
    four = InProcessCluster(n_nodes=1, seed=3, mesh_data_plane=True,
                            device="cpu", mesh_slots=4)
    four.start()
    try:
        assert four.master().mesh_plane.mesh.n_slots == 4
        body = {"query": {"match": {"body": "alpha gamma"}}, "size": 100}
        answers = []
        for c in (cluster, four):
            client = c.client()
            _index_corpus(c, client)
            resp, err = c.call(lambda cb: client.search("mesh", body, cb))
            _ok(resp, err)
            assert resp.get("_data_plane") == "mesh"
            answers.append(resp)
        eight, got = answers
        assert got["hits"]["total"] == eight["hits"]["total"]
        assert sorted((h["_score"], h["_id"]) for h in got["hits"]["hits"]) \
            == sorted((h["_score"], h["_id"]) for h in eight["hits"]["hits"])
    finally:
        four.stop()


def test_a_card_that_does_not_initialize_is_logged(monkeypatch, caplog):
    """``warmup`` on a card node whose CUDA init raises: the node stays on
    the per-shard fan-out, and says so at error level."""
    import torch
    from elasticsearch_tpu_torch.parallel.mesh_plane import MeshDataPlane

    def fail():
        raise RuntimeError("no CUDA-capable device is detected")
    monkeypatch.setattr(torch.cuda, "init", fail)
    plane = MeshDataPlane(n_slots=4, device="cuda")
    with caplog.at_level(logging.ERROR):
        plane.warmup()
    errors = [r for r in caplog.records if r.levelno >= logging.ERROR]
    assert errors and errors[0].exc_info is not None
    assert "did not initialize" in caplog.text
