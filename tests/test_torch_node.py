"""A node of the PyTorch build against a node of the JAX package, end to end.

Two one-node clusters, ``elasticsearch_tpu.testing.InProcessCluster`` and
``elasticsearch_tpu_torch.testing.InProcessCluster(device="cpu")`` (every
kernel wrapper runs its plain PyTorch version), get the same seed and the
same REST requests through their own REST controllers, on a 1-shard and
a 2-shard index: ``PUT`` the index, an ingest pipeline whose
``inference`` processor expands each body with the node's own expansion
model, two ``_bulk`` loads with a refresh between them (several
segments), deletes, then ``match`` (totals default, true, false and 5),
``bool`` with a filter, ``_msearch``, ``_count``, ``knn`` (exact and
filtered), ``text_expansion`` (``tokens`` and ``model_text``), a terms +
histogram aggregation and ``rank.rrf`` with two and three retrievers.

Only answers are compared: the JSON apart from ``took`` and the
``_data_plane`` routing label, never the mesh, batch or cache counters.
Rules (ROADMAP queue 3, items 2 and 3): integers, strings, ids, totals and
bucket keys exact; floats to rtol 1e-6 (BM25 and sparse sums are exact
fixed point in the port and f32 scatter-adds in the JAX package, and the
JAX package's kNN scores move by an ulp with the batch size); hits whose
reference scores tie within that tolerance are compared as a set. Item 4:
the two packages' expansion models round a token weight to 4 decimals
after summing in different orders, so an ingested ``ml_exp`` weight may
sit 1e-4 apart, and a ``model_text`` score by at most 1e-4 times the sum
of the query's and the hit's weights over the query's tokens.
"""

import json

import numpy as np
import pytest

from elasticsearch_tpu.rest.controller import RestRequest as RefRequest
from elasticsearch_tpu.rest.routes import build_controller as ref_controller
from elasticsearch_tpu.testing import InProcessCluster as RefCluster

from elasticsearch_tpu_torch.rest.controller import RestRequest
from elasticsearch_tpu_torch.rest.routes import build_controller
from elasticsearch_tpu_torch.testing import InProcessCluster

RTOL = 1e-6
DIMS = 8
WORDS = [f"w{i}" for i in range(60)]
IGNORED = ("took", "_data_plane")
MAPPINGS = {"properties": {
    "body": {"type": "text"}, "tag": {"type": "keyword"},
    "n": {"type": "integer"},
    "vec": {"type": "dense_vector", "dims": DIMS, "similarity": "cosine",
            "index_options": {"type": "flat"}},
    "ml": {"type": "rank_features"}, "ml_exp": {"type": "rank_features"}}}
PIPELINE = {"processors": [{"inference": {
    "field": "body", "target_field": "ml_exp"}}]}


def make_docs(seed: int, n: int, base: int = 0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        words = rng.integers(0, len(WORDS), int(rng.integers(3, 12)))
        out.append((str(base + i), {
            "body": " ".join(WORDS[int(w)] for w in words),
            "tag": f"t{int(rng.integers(0, 4))}",
            "n": int(rng.integers(-50, 200)),
            "vec": [round(float(x), 4) for x in rng.normal(size=DIMS)],
            "ml": {f"f{int(f)}": round(float(rng.uniform(0.1, 3.0)), 3)
                   for f in rng.integers(0, 12, 3)}}))
    return out


def query_vector(seed: int):
    rng = np.random.default_rng(seed)
    return [round(float(x), 4) for x in rng.normal(size=DIMS)]


def bulk_lines(index: str, docs, deletes=()):
    lines = []
    for doc_id, src in docs:
        lines += [{"index": {"_index": index, "_id": doc_id}}, src]
    for doc_id in deletes:
        lines.append({"delete": {"_index": index, "_id": doc_id}})
    return lines


def searches(index: str):
    """(name, method, path, body) of the request mix."""
    match = {"match": {"body": "w1 w3 w7"}}
    knn = {"field": "vec", "query_vector": query_vector(5), "k": 6,
           "num_candidates": 40}
    out = [
        ("match", {"query": match}),
        ("match_totals_true", {"query": match, "track_total_hits": True}),
        ("match_totals_false", {"query": match, "track_total_hits": False}),
        ("match_totals_5", {"query": match, "track_total_hits": 5}),
        ("bool_filter", {"query": {"bool": {
            "must": [{"match": {"body": "w2 w4"}}],
            "filter": [{"term": {"tag": "t1"}}]}}, "size": 7}),
        ("knn", {"query": {"knn": knn}}),
        ("knn_filtered", {"query": {"knn": dict(
            knn, filter={"term": {"tag": "t2"}})}}),
        ("text_expansion_tokens", {"query": {"text_expansion": {"ml": {
            "tokens": {"f1": 1.0, "f4": 0.5, "f9": 2.0}}}}}),
        ("text_expansion_model_text", {"query": {"text_expansion": {
            "ml_exp": {"model_text": "w1 w3 w5"}}},
            "track_total_hits": True}),
        ("aggs", {"query": {"match": {"body": "w1 w2"}}, "size": 0,
                  "aggs": {"tags": {"terms": {"field": "tag"}},
                           "ns": {"histogram": {"field": "n",
                                                "interval": 25},
                                  "aggs": {"hi": {"max": {"field": "n"}},
                                           "s": {"sum": {"field": "n"}}}}}}),
        ("rrf_2", {"query": match, "knn": knn, "size": 8,
                   "rank": {"rrf": {"rank_window_size": 30,
                                    "rank_constant": 20}}}),
        ("rrf_3", {"sub_searches": [{"query": match},
                                    {"query": {"match": {"body": "w2 w9"}}}],
                   "knn": knn, "size": 10,
                   "rank": {"rrf": {"rank_window_size": 25}}}),
    ]
    reqs = [(name, "POST", f"/{index}/_search", body) for name, body in out]
    reqs.append(("count", "POST", f"/{index}/_count",
                 {"query": {"term": {"tag": "t3"}}}))
    reqs.append(("msearch", "POST", "/_msearch", [
        {"index": index}, {"query": match, "size": 4},
        {"index": index}, {"query": {"knn": knn}}]))
    return reqs


class Driver:
    """One cluster's REST controller, driven request by request."""

    def __init__(self, cluster, controller, request_cls):
        self.cluster = cluster
        self.controller = controller
        self.request_cls = request_cls

    def __call__(self, method, path, body=None, query=None):
        raw = b""
        if isinstance(body, list):
            raw = ("\n".join(json.dumps(x) for x in body) + "\n"
                   ).encode("utf-8")
            body = None
        req = self.request_cls(method=method, path=path,
                               query=dict(query or {}), body=body,
                               raw_body=raw)
        out = []
        self.controller.dispatch(req, lambda s, b: out.append((s, b)))
        self.cluster.run_until(lambda: bool(out), 120.0)
        return out[0]


def load(drive, index: str, shards: int):
    for method, path, body, query in (
            ("PUT", "/_ingest/pipeline/exp", PIPELINE, None),
            ("PUT", f"/{index}", {"settings": {
                "number_of_shards": shards, "number_of_replicas": 0},
                "mappings": MAPPINGS}, None),
            ("POST", "/_bulk", bulk_lines(index, make_docs(3, 150)),
             {"pipeline": "exp"}),
            ("POST", f"/{index}/_refresh", None, None),
            ("POST", "/_bulk", bulk_lines(
                index, make_docs(4, 90, base=150),
                deletes=("3", "17", "40", "151")), {"pipeline": "exp"}),
            ("POST", f"/{index}/_refresh", None, None)):
        status, resp = drive(method, path, body, query)
        assert status < 300, (path, status, resp)
        if path == "/_bulk":
            assert not resp["errors"], resp


def expansion_atol(name, resp) -> float:
    """ROADMAP queue 3, item 4: the most a ``model_text`` score may move
    when either package's model rounds a weight 1e-4 the other way -- 1e-4
    times the query's weights plus the largest hit's weights over the
    query's tokens; 0 for every other request."""
    if name != "text_expansion_model_text":
        return 0.0
    from elasticsearch_tpu.ml import text_expansion as ref_ml
    query = ref_ml.get_model().expand("w1 w3 w5")
    docs = max((sum(h["_source"].get("ml_exp", {}).get(f, 0.0)
                    for f in query) for h in resp["hits"]["hits"]),
               default=0.0)
    return 1e-4 * (sum(query.values()) + docs + len(query))


_NODES = {}


def nodes():
    """(reference driver, port driver), booted and loaded once."""
    if not _NODES:
        ref = RefCluster(n_nodes=1, seed=41)
        port = InProcessCluster(n_nodes=1, seed=41, device="cpu")
        for c in (ref, port):
            c.start()
        _NODES["ref"] = Driver(ref, ref_controller(ref.client()),
                               RefRequest)
        _NODES["port"] = Driver(port, build_controller(port.client()),
                                RestRequest)
        for shards in (1, 2):
            for side in ("ref", "port"):
                load(_NODES[side], f"idx{shards}", shards)
    return _NODES["ref"], _NODES["port"]


def _tie_groups_match(a_hits, b_hits, path, atol):
    sa = [h.get("_score") for h in a_hits]
    if any(s is None for s in sa):
        assert [h["_id"] for h in a_hits] == [h["_id"] for h in b_hits], path
        return {h["_id"]: h for h in b_hits}
    i = 0
    while i < len(sa):
        j = i + 1
        while j < len(sa) and abs(sa[j] - sa[i]) <= \
                2 * (RTOL * abs(sa[i]) + atol) + 1e-12:
            j += 1
        ids_a = [h["_id"] for h in a_hits[i:j]]
        ids_b = [h["_id"] for h in b_hits[i:j]]
        if j < len(sa):       # a tie group at the cut may continue past it
            assert sorted(ids_a) == sorted(ids_b), (path, ids_a, ids_b)
        i = j
    return {h["_id"]: h for h in b_hits}


def same(a, b, path="$", atol=0.0):
    """``atol`` widens the score tolerance (``_score``, ``max_score``)."""
    if isinstance(a, dict):
        assert isinstance(b, dict), path
        ka = {k for k in a if k not in IGNORED}
        kb = {k for k in b if k not in IGNORED}
        assert ka == kb, (path, sorted(ka ^ kb))
        for k in sorted(ka):
            if k == "hits" and isinstance(a[k], list):
                assert len(a[k]) == len(b[k]), path + ".hits"
                by_id = _tie_groups_match(a[k], b[k], path + ".hits", atol)
                for n, hit in enumerate(a[k]):
                    other = by_id.get(hit["_id"])
                    if other is None:     # cut inside a tie group
                        continue
                    hit = {x: v for x, v in hit.items() if x != "_rank"}
                    other = {x: v for x, v in other.items() if x != "_rank"}
                    same(hit, other, f"{path}.hits[{n}]", atol)
                continue
            same(a[k], b[k], f"{path}.{k}", atol)
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for n, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{n}]", atol)
    elif isinstance(a, float) or isinstance(b, float):
        assert isinstance(b, (int, float)) and not isinstance(b, bool), path
        tol = RTOL * abs(a) + 1e-12
        if path.endswith(("_score", "max_score")):
            tol += atol
        elif "._source.ml_exp." in path:
            tol += 1e-4 + 1e-9      # item 4: a 4-decimal rounding apart
        assert abs(a - b) <= tol, (path, a, b)
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("shards", [1, 2], ids=["one_shard", "two_shards"])
@pytest.mark.parametrize("name", [n for n, *_ in searches("idx")])
def test_port_node_gives_the_reference_json(name, shards):
    ref, port = nodes()
    index = f"idx{shards}"
    (_, method, path, body), = [r for r in searches(index) if r[0] == name]
    want = ref(method, path, body)
    got = port(method, path, body)
    assert want[0] == got[0] == 200, (want, got)
    same(want[1], got[1], atol=expansion_atol(name, want[1]))
    if name.startswith("rrf"):
        assert got[1]["hits"]["hits"], got


def test_rrf_fused_on_the_port_kernel_path():
    """Every hybrid request of the mix fused through ``rrf_fuse_batch``
    (the plain version here), never through the host-fusion route."""
    from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE
    _ref, port = nodes()
    fuser = next(iter(port.cluster.nodes.values())).search_action.rrf_fuser
    calls = DEVICE_PROFILE.family("rrf_fuse_batch").calls
    batches = fuser.stats["rrf_fuse_batches"]
    for shards in (1, 2):
        for name, method, path, body in searches(f"idx{shards}"):
            if name.startswith("rrf"):
                assert port(method, path, body)[0] == 200
    assert fuser.stats["rrf_fuse_batches"] == batches + 4
    assert DEVICE_PROFILE.family("rrf_fuse_batch").calls == calls + 4
    assert fuser.stats["rrf_fuse_fallbacks"] == 0


@pytest.mark.parametrize("options,kind", [
    (None, "knn"), ({"type": "ivf"}, "knn"), ({"type": "flat"}, "dense"),
    ({"type": "hnsw"}, "dense")], ids=["absent", "ivf", "flat", "hnsw"])
def test_batcher_routes_knn_as_the_reference_does(options, kind):
    """ROADMAP queue 3, item 8: a ``knn`` whose ``index_options.type`` is
    neither absent nor ``ivf`` runs as the per-member dense kind in both
    packages; the others batch."""
    from elasticsearch_tpu.mapping import MapperService as RefMappers
    from elasticsearch_tpu.search.batch_executor import (
        classify_request as ref_classify,
    )
    from elasticsearch_tpu_torch.mapping import MapperService
    from elasticsearch_tpu_torch.search.batch_executor import (
        classify_request,
    )
    field = {"type": "dense_vector", "dims": 3, "similarity": "cosine"}
    if options is not None:
        field["index_options"] = options
    mapping = {"properties": {"v": field}}
    req = {"index": "i", "shard": 0, "window": 10, "body": {
        "query": {"knn": {"field": "v", "query_vector": [1, 0, 0],
                          "k": 5}}}}
    want = ref_classify(req, RefMappers(mapping)).kind
    got = classify_request(req, MapperService(mapping)).kind
    assert got == want == kind


@pytest.mark.parametrize("kind", ["text", "knn", "sparse"])
def test_mesh_fanout_is_a_counted_decline(kind):
    """A fan-out to two co-located shards takes the mesh for every kind --
    text, kNN and, since the sparse mesh programs are ported, the sparse
    kind (``_data_plane: "mesh_plane"``, ``mesh_searches`` +1): nothing is
    declined as ``mesh_backend_not_ready``, counted in ``mesh_fallbacks``
    or counted as not ported. The name dates from when the sparse fan-out
    was a counted decline."""
    from elasticsearch_tpu_torch.search import telemetry
    _ref, port = nodes()
    if port("HEAD", "/kinds2")[0] != 200:
        # a vector field the batcher classifies as the knn kind (``flat``
        # options take the dense kind; queue 3, item 8)
        mappings = {"properties": {
            "body": {"type": "text"}, "ml": {"type": "rank_features"},
            "vec": {"type": "dense_vector", "dims": DIMS,
                    "similarity": "cosine"}}}
        for method, path, body in (
                ("PUT", "/kinds2", {"settings": {
                    "number_of_shards": 2, "number_of_replicas": 0},
                    "mappings": mappings}),
                ("POST", "/_bulk", bulk_lines("kinds2", [
                    (i, {k: v for k, v in src.items() if k in mappings[
                        "properties"]})
                    for i, src in make_docs(8, 40)])),
                ("POST", "/kinds2/_refresh", None)):
            assert port(method, path, body)[0] < 300, path
    executor = next(iter(
        port.cluster.nodes.values())).search_transport.mesh_executor
    stats = dict(executor.stats)
    not_ported = dict(telemetry.TELEMETRY.not_ported)
    reasons = dict(telemetry.TELEMETRY.fallbacks)
    body = {"text": {"query": {"match": {"body": "w1 w2 w3 w4 w5"}}},
            "knn": {"query": {"knn": {"field": "vec", "k": 3,
                                      "query_vector": query_vector(7)}}},
            "sparse": {"query": {"text_expansion": {"ml": {
                "tokens": {"f1": 1.0, "f4": 0.5}}}}}}[kind]
    status, resp = port("POST", "/kinds2/_search", body)
    assert status == 200 and resp["_shards"]["successful"] == 2, resp
    assert resp["hits"]["hits"], resp
    key = telemetry.MESH_BACKEND_NOT_READY
    assert resp["_data_plane"] == "mesh_plane"
    assert executor.stats["mesh_searches"] == stats["mesh_searches"] + 1
    assert executor.stats["mesh_fallbacks"] == stats["mesh_fallbacks"]
    assert dict(telemetry.TELEMETRY.not_ported) == not_ported
    assert telemetry.TELEMETRY.fallbacks.get(key, 0) == reasons.get(key, 0)
