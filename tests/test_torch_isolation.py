"""elasticsearch_tpu_torch stands alone: it imports PyTorch, never JAX, and
nothing of the JAX package; and it never runs on the CPU unless asked."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "elasticsearch_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "elasticsearch_tpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.lineno, node.module


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PACKAGE.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_jax_or_reference_imports(path):
    bad = [(line, name) for line, name in _imported_roots(ROOT / path)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


BLOCKER = r'''
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "elasticsearch_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
from elasticsearch_tpu_torch.index import InternalEngine
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.search import SearchService
import elasticsearch_tpu_torch.search.plane_exec
import elasticsearch_tpu_torch.search.batch_executor
import elasticsearch_tpu_torch.ops.knn
import elasticsearch_tpu_torch.ops.topk
import elasticsearch_tpu_torch.ops.ivf
import elasticsearch_tpu_torch.ops.sparse
import elasticsearch_tpu_torch.ml
import elasticsearch_tpu_torch.convert
import elasticsearch_tpu_torch.ops.aggs
import elasticsearch_tpu_torch.script
import elasticsearch_tpu_torch.search.nested
import elasticsearch_tpu_torch.search.mesh_executor
import elasticsearch_tpu_torch.parallel.mesh
import elasticsearch_tpu_torch.parallel.sharded_search
from elasticsearch_tpu_torch.search.plane_aggs import plan_drain_aggs
from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE
engine = InternalEngine(MapperService({"properties": {
    "body": {"type": "text"}, "tag": {"type": "keyword"},
    "n": {"type": "integer"},
    "ml": {"type": "rank_features"},
    "vec": {"type": "dense_vector", "dims": 3, "similarity": "l2_norm"},
    "ivec": {"type": "dense_vector", "dims": 3, "similarity": "l2_norm",
             "index_options": {"type": "ivf", "nlist": 4}}}}))
for i in range(40):
    engine.index(str(i), {"body": "quick brown fox" if i % 3 else "lazy dog",
                          "tag": f"t{i % 2}", "vec": [float(i), 1.0, 2.0],
                          "ivec": [float(i), 1.0, 2.0],
                          "ml": {"f1": 1.0 + i % 5, f"f{10 + i % 3}": 0.5},
                          "n": i - 10})
    if i == 20:
        engine.refresh()
engine.refresh()
svc = SearchService(engine, device="cpu")
r = svc.search({"query": {"match": {"body": "fox"}}})
assert r["hits"]["total"]["value"] == 26, r["hits"]["total"]
k = svc.search({"query": {"knn": {"field": "vec", "query_vector": [7.2, 1, 2],
                                  "k": 3}}})
assert [h["_id"] for h in k["hits"]["hits"]] == ["7", "8", "6"], k
kf = svc.search({"query": {"knn": {"field": "vec", "k": 3,
                                   "query_vector": [7.2, 1, 2],
                                   "filter": {"term": {"tag": "t1"}}}}})
assert [h["_id"] for h in kf["hits"]["hits"]] == ["7", "9", "5"], kf
ki = svc.search({"query": {"knn": {"field": "ivec", "k": 3,
                                   "query_vector": [7.2, 1, 2],
                                   "num_candidates": 100}}})
assert [h["_id"] for h in ki["hits"]["hits"]] == ["7", "8", "6"], ki
assert DEVICE_PROFILE.family("ivf_search").calls > 0
f = svc.search({"query": {"bool": {"must": [{"match": {"body": "fox"}}],
                                   "filter": [{"term": {"tag": "t1"}}]}},
                "track_total_hits": True})
assert f["hits"]["total"] == {"value": 13, "relation": "eq"}, f["hits"]
s = svc.search({"query": {"script_score": {
    "query": {"match_all": {}},
    "script": {"source": "l2norm(params.v, 'vec')",
               "params": {"v": [7.2, 1, 2]}}}}, "size": 3,
    "sort": [{"_score": "asc"}]})
assert [h["_id"] for h in s["hits"]["hits"]] == ["7", "8", "6"], s
assert svc.count({"query": {"term": {"tag": "t0"}}})["count"] == 20
from elasticsearch_tpu_torch.ml import get_model
feats = get_model(device="cpu").expand("f1 lazy dog")
te = svc.search({"query": {"text_expansion": {"ml": {
    "model_text": "f1 lazy dog"}}}, "track_total_hits": True})
want = sum(1 for i in range(40) if any(
    f in feats for f in ("f1", f"f{10 + i % 3}")))
assert te["hits"]["total"] == {"value": want, "relation": "eq"}, te["hits"]
assert DEVICE_PROFILE.family("text_expansion_forward").calls == 1
assert DEVICE_PROFILE.family("sparse_scores").calls > 0
aggs = {"tags": {"terms": {"field": "tag"}},
        "ns": {"histogram": {"field": "n", "interval": 7},
               "aggs": {"hi": {"max": {"field": "n"}}}}}
a = svc.search({"query": {"match": {"body": "fox"}}, "size": 0,
                "aggs": aggs})["aggregations"]
assert [(b["key"], b["doc_count"]) for b in a["tags"]["buckets"]] == [
    ("t0", 13), ("t1", 13)], a
assert a["ns"]["buckets"][0] == {"key": -14.0, "doc_count": 2,
                                 "hi": {"value": -8.0}}, a
assert DEVICE_PROFILE.family("aggs_ordinal_counts").calls == 2
assert DEVICE_PROFILE.family("aggs_histogram").calls == 2
from types import SimpleNamespace
m = SimpleNamespace(req={"body": {"query": {"match": {"body": "fox"}},
                                  "aggs": aggs}}, trace=None, error=None)
preset = plan_drain_aggs(SimpleNamespace(engine=engine),
                         engine.acquire_reader(), [m], device="cpu")
assert preset[0]["tags"]["buckets"]["t1"]["doc_count"] == 13, preset
assert DEVICE_PROFILE.family("aggs_histogram_plane").calls == 1
import json
from elasticsearch_tpu_torch.rest.controller import RestRequest
from elasticsearch_tpu_torch.rest.routes import build_controller
from elasticsearch_tpu_torch.testing import InProcessCluster
cluster = InProcessCluster(n_nodes=1, seed=5, device="cpu")
cluster.start()
controller = build_controller(cluster.client())


def rest(method, path, body=None):
    raw = b""
    if isinstance(body, list):
        raw = ("\n".join(json.dumps(x) for x in body) + "\n").encode()
        body = None
    out = []
    controller.dispatch(RestRequest(method=method, path=path, body=body,
                                    raw_body=raw),
                        lambda status, resp: out.append((status, resp)))
    cluster.run_until(lambda: bool(out), 60.0)
    return out[0]


status, _ = rest("PUT", "/node_idx", {
    "settings": {"number_of_shards": 1, "number_of_replicas": 0},
    "mappings": {"properties": {
        "body": {"type": "text"},
        "vec": {"type": "dense_vector", "dims": 3,
                "similarity": "l2_norm"}}}})
assert status == 200, status
lines = []
for i in range(30):
    lines += [{"index": {"_index": "node_idx", "_id": str(i)}},
              {"body": "quick brown fox" if i % 3 else "lazy dog",
               "vec": [float(i), 1.0, 2.0]}]
status, resp = rest("POST", "/_bulk", lines)
assert status == 200 and not resp["errors"], resp
rest("POST", "/node_idx/_refresh")
status, resp = rest("POST", "/node_idx/_search",
                    {"query": {"match": {"body": "fox"}},
                     "track_total_hits": True})
assert status == 200 and resp["hits"]["total"]["value"] == 20, resp
calls = DEVICE_PROFILE.family("rrf_fuse_batch").calls
status, resp = rest("POST", "/node_idx/_search", {
    "query": {"match": {"body": "dog"}},
    "knn": {"field": "vec", "query_vector": [3.1, 1, 2], "k": 3,
            "num_candidates": 10},
    "rank": {"rrf": {"rank_window_size": 10}}, "size": 3})
assert status == 200, resp
assert resp["hits"]["hits"][0]["_id"] == "3", resp["hits"]
assert DEVICE_PROFILE.family("rrf_fuse_batch").calls == calls + 1
status, _ = rest("PUT", "/mesh_idx", {
    "settings": {"number_of_shards": 2, "number_of_replicas": 0},
    "mappings": {"properties": {"body": {"type": "text"}}}})
assert status == 200, status
lines = []
for i in range(30):
    lines += [{"index": {"_index": "mesh_idx", "_id": str(i)}},
              {"body": "quick brown fox" if i % 3 else "lazy dog"}]
status, resp = rest("POST", "/_bulk", lines)
assert status == 200 and not resp["errors"], resp
rest("POST", "/mesh_idx/_refresh")
calls = DEVICE_PROFILE.family("mesh_bm25_flat").calls
status, resp = rest("POST", "/mesh_idx/_search",
                    {"query": {"match": {"body": "fox"}}})
assert status == 200 and resp["_data_plane"] == "mesh_plane", resp
assert resp["hits"]["total"]["value"] == 20, resp["hits"]["total"]
assert DEVICE_PROFILE.family("mesh_bm25_flat").calls > calls
status, _ = rest("PUT", "/mesh_knn_idx", {
    "settings": {"number_of_shards": 2, "number_of_replicas": 0},
    "mappings": {"properties": {"v": {
        "type": "dense_vector", "dims": 3, "similarity": "cosine"}}}})
assert status == 200, status
lines = []
for i in range(30):
    lines += [{"index": {"_index": "mesh_knn_idx", "_id": str(i)}},
              {"v": [float(i), 1.0, 2.0]}]
status, resp = rest("POST", "/_bulk", lines)
assert status == 200 and not resp["errors"], resp
rest("POST", "/mesh_knn_idx/_refresh")
calls = DEVICE_PROFILE.family("mesh_knn_topk").calls
status, resp = rest("POST", "/mesh_knn_idx/_search", {"query": {"knn": {
    "field": "v", "query_vector": [29.0, 1.0, 2.0], "k": 4}}})
assert status == 200 and resp["_data_plane"] == "mesh_plane", resp
assert resp["hits"]["hits"][0]["_id"] == "29", resp["hits"]
assert DEVICE_PROFILE.family("mesh_knn_topk").calls > calls
status, _ = rest("PUT", "/mesh_sparse_idx", {
    "settings": {"number_of_shards": 2, "number_of_replicas": 0},
    "mappings": {"properties": {"ml": {"type": "rank_features"}}}})
assert status == 200, status
lines = []
for i in range(30):
    lines += [{"index": {"_index": "mesh_sparse_idx", "_id": str(i)}},
              {"ml": {"f1": 0.5 + i, "f2": 1.0} if i % 2 else {"f3": 2.0}}]
status, resp = rest("POST", "/_bulk", lines)
assert status == 200 and not resp["errors"], resp
rest("POST", "/mesh_sparse_idx/_refresh")
calls = DEVICE_PROFILE.family("mesh_sparse_topk").calls
status, resp = rest("POST", "/mesh_sparse_idx/_search", {
    "query": {"text_expansion": {"ml": {"tokens": {"f1": 1.0}}}},
    "size": 3})
assert status == 200 and resp["_data_plane"] == "mesh_plane", resp
assert resp["hits"]["total"]["value"] == 15, resp["hits"]["total"]
assert resp["hits"]["hits"][0]["_id"] == "29", resp["hits"]
assert DEVICE_PROFILE.family("mesh_sparse_topk").calls > calls
cluster.stop()
cluster = InProcessCluster(n_nodes=1, seed=6, device="cpu",
                           mesh_data_plane=True)
cluster.start()
controller = build_controller(cluster.client())
status, _ = rest("PUT", "/dp_idx", {
    "settings": {"number_of_shards": 2, "number_of_replicas": 0},
    "mappings": {"properties": {
        "body": {"type": "text"}, "ml": {"type": "rank_features"},
        "v": {"type": "dense_vector", "dims": 3, "similarity": "cosine"}}}})
assert status == 200, status
lines = []
for i in range(30):
    lines += [{"index": {"_index": "dp_idx", "_id": str(i)}},
              {"body": "quick brown fox" if i % 3 else "lazy dog",
               "v": [float(i), 1.0, 2.0],
               "ml": {"f1": 0.5 + i, "f2": 1.0} if i % 2 else {"f3": 2.0}}]
status, resp = rest("POST", "/_bulk", lines)
assert status == 200 and not resp["errors"], resp
rest("POST", "/dp_idx/_refresh")
for family, body, top in (
        ("sharded_bm25_batch", {"query": {"match": {"body": "fox"}}}, None),
        ("sharded_knn", {"query": {"knn": {
            "field": "v", "query_vector": [29.0, 1.0, 2.0], "k": 4}}}, "29"),
        ("sharded_sparse", {"query": {"text_expansion": {
            "ml": {"tokens": {"f1": 1.0}}}}, "size": 3}, "29")):
    calls = DEVICE_PROFILE.family(family).calls
    status, resp = rest("POST", "/dp_idx/_search", body)
    assert status == 200 and resp["_data_plane"] == "mesh", resp
    assert top is None or resp["hits"]["hits"][0]["_id"] == top, resp
    assert DEVICE_PROFILE.family(family).calls > calls, family
cluster.stop()
assert not any(m.split(".")[0] in ("jax", "jaxlib", "elasticsearch_tpu")
               for m in sys.modules)
print("served", len(r["hits"]["hits"]))
'''


def test_serves_with_jax_and_the_reference_blocked():
    out = subprocess.run([sys.executable, "-c", BLOCKER, str(ROOT)],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert "served 10" in out.stdout


def test_no_card_means_an_error_not_the_cpu(monkeypatch):
    from elasticsearch_tpu_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    from elasticsearch_tpu_torch.index import InternalEngine
    from elasticsearch_tpu_torch.mapping import MapperService
    from elasticsearch_tpu_torch.search import SearchService
    engine = InternalEngine(MapperService({"properties": {}}))
    with pytest.raises(RuntimeError):
        SearchService(engine)


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """A wrapper given CUDA tensors launches its kernel or raises: with the
    kernel library unavailable it raises instead of computing on the
    host."""
    from elasticsearch_tpu_torch import _build
    from elasticsearch_tpu_torch.ops import bm25

    def no_library(family):
        raise _build.KernelBuildError("no nvcc here")

    monkeypatch.setattr(_build, "library", no_library)
    monkeypatch.setattr(bm25, "_FNS", {})
    monkeypatch.setattr(bm25, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(bm25, "bm25_flat_plain", lambda *a, **k: pytest.fail(
        "plain version ran for a CUDA call"))
    n_pad = 256
    args = [torch.full((2, 128), -1, dtype=torch.int32),
            torch.zeros(2, 128), torch.zeros(32, dtype=torch.int32),
            torch.zeros(32), torch.zeros(32, dtype=torch.int32),
            torch.ones(n_pad), torch.ones(32), torch.ones(n_pad, dtype=bool)]
    monkeypatch.setattr(bm25, "_stream", lambda: 0)
    with pytest.raises(_build.KernelBuildError):
        bm25.bm25_flat(*args, n_pad, 1, 10)


@pytest.mark.parametrize("family", [
    "bm25_scores", "knn_scores", "dense_topk", "sparse_flat",
    "sparse_scores", "sparse_coarse", "sparse_rerank",
    "text_expansion_forward"])
def test_dense_wrappers_never_take_the_plain_version(family, monkeypatch):
    """The dense collector's, the sparse path's and the expansion model's
    wrappers, given CUDA tensors, launch their kernel or raise: with the
    kernel library unavailable they raise instead of computing on the
    host."""
    from elasticsearch_tpu_torch import _build
    from elasticsearch_tpu_torch.ml import text_expansion as te
    from elasticsearch_tpu_torch.ops import bm25, knn, sparse, topk

    def no_library(fam):
        raise _build.KernelBuildError("no nvcc here")

    def no_plain(*a, **k):
        pytest.fail("plain version ran for a CUDA call")

    monkeypatch.setattr(_build, "library", no_library)
    monkeypatch.setattr(bm25, "_FNS", {})
    monkeypatch.setattr(bm25, "_stream", lambda: 0)
    for mod in (bm25, knn, topk, sparse, te):
        monkeypatch.setattr(mod, "_on_cuda", lambda *t: True)
        monkeypatch.setattr(mod, "_stream", lambda: 0)
    monkeypatch.setattr(bm25, "bm25_block_scores_plain", no_plain)
    monkeypatch.setattr(knn, "vector_scores_plain", no_plain)
    monkeypatch.setattr(topk, "dense_topk_plain", no_plain)
    for name in ("sparse_flat_plain", "sparse_scores_plain",
                 "sparse_coarse_plain", "sparse_rerank_plain"):
        monkeypatch.setattr(sparse, name, no_plain)
    monkeypatch.setattr(te, "text_expansion_forward_plain", no_plain)
    n_pad = 256
    docs = torch.full((2, 128), -1, dtype=torch.int32)
    rows = (torch.zeros(1, 8, dtype=torch.int32), torch.ones(1, 8))
    live = torch.ones(n_pad, dtype=bool)
    with pytest.raises(_build.KernelBuildError):
        if family == "sparse_flat":
            sparse.sparse_topk_batch(docs, torch.zeros(2, 128), *rows, 1.0,
                                     1.0, live, n_pad, 10, "linear")
        elif family == "sparse_scores":
            sparse.sparse_scores(docs, torch.zeros(2, 128), rows[0][0],
                                 rows[1][0], 1.0, 1.0, n_pad, "log")
        elif family == "sparse_coarse":
            sparse.sparse_coarse_kernel(
                docs, torch.zeros(2, 128, dtype=torch.bfloat16), *rows,
                live, n_pad, 16)
        elif family == "sparse_rerank":
            sparse.sparse_rerank_kernel(
                docs, torch.zeros(2, 128), *rows, live,
                torch.zeros(1, 16, dtype=torch.int32), torch.zeros(1, 16),
                n_pad, 16, 10)
        elif family == "text_expansion_forward":
            ids = torch.zeros(2, 4, dtype=torch.int32)
            te.text_expansion_forward(ids, ids - 1, torch.zeros(9, 4),
                                      torch.zeros(4, 4), torch.zeros(4, 64),
                                      32)
        elif family == "bm25_scores":
            bm25.bm25_block_scores(
                torch.full((2, 128), -1, dtype=torch.int32),
                torch.zeros(2, 128), torch.zeros(8, dtype=torch.int32),
                torch.zeros(8), torch.ones(n_pad), 50.0, n_pad)
        elif family == "knn_scores":
            knn.vector_scores(torch.zeros(n_pad, 4), torch.zeros(n_pad),
                              torch.ones(n_pad, dtype=bool), torch.ones(4),
                              torch.ones(1), torch.ones(1), "cosine")
        else:
            topk.dense_topk(torch.zeros(n_pad), 10)


@pytest.mark.parametrize("family", [
    "aggs_ordinal_counts", "aggs_histogram", "aggs_ordinal_counts_plane",
    "aggs_histogram_plane", "dense_topk_wide"])
def test_aggs_and_wide_wrappers_never_take_the_plain_version(family,
                                                            monkeypatch):
    """The aggregation kernels' wrappers, and K10 at a window above KMAX,
    given CUDA tensors, launch their kernel or raise: with the kernel
    library unavailable they raise instead of computing on the host."""
    from elasticsearch_tpu_torch import _build
    from elasticsearch_tpu_torch.ops import aggs, bm25, topk

    def no_library(fam):
        raise _build.KernelBuildError("no nvcc")

    def no_plain(*a, **k):
        pytest.fail("plain version ran for a CUDA call")

    monkeypatch.setattr(_build, "library", no_library)
    monkeypatch.setattr(bm25, "_FNS", {})
    for mod in (aggs, topk):
        monkeypatch.setattr(mod, "_on_cuda", lambda *t: True)
        monkeypatch.setattr(mod, "_stream", lambda: 0)
    for name in ("ordinal_counts_plain", "ordinal_counts_plane_plain",
                 "histogram_partials_plain",
                 "histogram_partials_plane_plain"):
        monkeypatch.setattr(aggs, name, no_plain)
    monkeypatch.setattr(topk, "dense_topk_plain", no_plain)
    n = 256
    i32 = torch.zeros(n, dtype=torch.int32)
    mask = torch.ones(n, dtype=torch.bool)
    # the per-segment histogram moves its base / interval to the device
    monkeypatch.setattr(torch.Tensor, "to", lambda self, *a, **k: self)
    with pytest.raises(_build.KernelBuildError):
        if family == "aggs_ordinal_counts":
            aggs.ordinal_counts(i32, i32, mask, 8)
        elif family == "aggs_ordinal_counts_plane":
            aggs.ordinal_counts_plane(i32, i32, mask[None, :], 8)
        elif family == "aggs_histogram":
            aggs.histogram_partials(i32, mask, mask, 0, 5, 8)
        elif family == "aggs_histogram_plane":
            aggs.histogram_partials_plane(i32, mask, mask[None, :],
                                          i32[:1], i32[:1] + 5, 8)
        else:
            topk.dense_topk(torch.zeros(5000), 4097)


def test_plan_drain_aggs_raises_when_the_kernels_fail(monkeypatch):
    """A drain over a plane on the card whose kernels cannot be built
    raises: only planning errors turn into the typed host fallback."""
    from types import SimpleNamespace

    from elasticsearch_tpu_torch import _build
    from elasticsearch_tpu_torch.index import InternalEngine
    from elasticsearch_tpu_torch.mapping import MapperService
    from elasticsearch_tpu_torch.ops import aggs, bm25
    from elasticsearch_tpu_torch.ops.device_segment import PLANES
    from elasticsearch_tpu_torch.search.plane_aggs import plan_drain_aggs

    engine = InternalEngine(MapperService({"properties": {
        "tag": {"type": "keyword"}, "n": {"type": "integer"}}}))
    for i in range(40):
        engine.index(str(i), {"tag": f"t{i % 3}", "n": i - 17})
        if i == 19:
            engine.refresh()
    engine.refresh()

    def no_library(fam):
        raise _build.KernelBuildError("no nvcc")

    keep = (PLANES.enabled, PLANES.min_segments, PLANES.max_bytes)
    PLANES.clear()
    PLANES.enabled, PLANES.min_segments, PLANES.max_bytes = True, 2, 0
    monkeypatch.setattr(_build, "library", no_library)
    monkeypatch.setattr(bm25, "_FNS", {})
    monkeypatch.setattr(aggs, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(aggs, "_stream", lambda: 0)
    try:
        for body in ({"tags": {"terms": {"field": "tag"}}},
                     {"ns": {"histogram": {"field": "n", "interval": 5}}}):
            m = SimpleNamespace(req={"body": {"query": {"match_all": {}},
                                              "aggs": body}},
                                trace=None, error=None)
            with pytest.raises(_build.KernelBuildError):
                plan_drain_aggs(SimpleNamespace(engine=engine),
                                engine.acquire_reader(), [m], device="cpu")
    finally:
        PLANES.enabled, PLANES.min_segments, PLANES.max_bytes = keep
        PLANES.clear()


@pytest.mark.parametrize("family", ["rrf_fuse_batch", "rrf_fuse",
                                    "linear_fuse"])
def test_fusion_wrappers_never_take_the_plain_version(family, monkeypatch):
    """The fusion kernels' wrappers, given CUDA tensors, launch their
    kernel or raise: with the kernel library unavailable they raise
    instead of fusing on the host."""
    from elasticsearch_tpu_torch import _build
    from elasticsearch_tpu_torch.ops import bm25, fusion

    def no_library(fam):
        raise _build.KernelBuildError("no nvcc")

    def no_plain(*a, **k):
        pytest.fail("plain version ran for a CUDA call")

    monkeypatch.setattr(_build, "library", no_library)
    monkeypatch.setattr(bm25, "_FNS", {})
    monkeypatch.setattr(fusion, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(fusion, "_stream", lambda: 0)
    for name in ("rrf_fuse_batch_plain", "rrf_fuse_plain",
                 "linear_fuse_plain"):
        monkeypatch.setattr(fusion, name, no_plain)
    lists = torch.zeros(2, 2, 8, dtype=torch.int32)
    with pytest.raises(_build.KernelBuildError):
        if family == "rrf_fuse_batch":
            fusion.rrf_fuse_batch(lists, 16, 16, 60)
        elif family == "rrf_fuse":
            fusion.rrf_fuse(lists[0], 16, 16, 60)
        else:
            fusion.linear_fuse(torch.zeros(2, 64), torch.ones(2),
                               torch.ones(64, dtype=torch.bool), 10)


@pytest.mark.parametrize("family", ["mesh_bm25_flat", "mesh_bm25_coarse",
                                    "mesh_bm25_rerank", "mesh_knn_topk",
                                    "mesh_knn_coarse", "mesh_knn_rerank",
                                    "mesh_sparse_topk", "mesh_sparse_coarse",
                                    "mesh_sparse_rerank"])
def test_mesh_wrappers_never_take_the_plain_version(family, monkeypatch):
    """The mesh kernels' wrappers (text, kNN and sparse), given CUDA
    tensors, launch their kernel or raise: with the kernel library
    unavailable they raise instead of running the one-shard plain
    versions slot by slot on the host."""
    from elasticsearch_tpu_torch import _build
    from elasticsearch_tpu_torch.ops import bm25
    from elasticsearch_tpu_torch.parallel import mesh

    def no_library(fam):
        raise _build.KernelBuildError("no nvcc")

    def no_plain(*a, **k):
        pytest.fail("plain version ran for a CUDA call")

    monkeypatch.setattr(_build, "library", no_library)
    monkeypatch.setattr(bm25, "_FNS", {})
    monkeypatch.setattr(mesh, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(mesh, "_stream", lambda: 0)
    for name in ("mesh_bm25_flat_plain", "mesh_bm25_coarse_plain",
                 "mesh_bm25_rerank_plain", "bm25_flat_seg_plain",
                 "bm25_coarse_plain", "bm25_rerank_plain",
                 "mesh_knn_topk_plain", "mesh_knn_coarse_plain",
                 "mesh_knn_rerank_plain", "knn_flat_plain",
                 "knn_coarse_plain", "knn_rerank_plain",
                 "mesh_sparse_topk_plain", "mesh_sparse_coarse_plain",
                 "mesh_sparse_rerank_plain", "sparse_flat_plain",
                 "sparse_coarse_plain", "sparse_rerank_plain"):
        monkeypatch.setattr(mesh, name, no_plain)
    s, n_pad = 2, 256
    docs = torch.full((s, 2, 128), -1, dtype=torch.int32)
    tfs = torch.zeros(s, 2, 128)
    dl = torch.ones(s, n_pad)
    live = torch.ones(s, n_pad, dtype=torch.bool)
    seg = torch.zeros(s, n_pad, dtype=torch.int32)
    idx = torch.zeros(s, 32, dtype=torch.int32)
    w = torch.zeros(s, 32)
    m = torch.zeros(s, n_pad, 4)
    q = torch.ones(1, 4)
    one = torch.ones(1)
    cand = torch.zeros(s, 1, 16, dtype=torch.int32)
    with pytest.raises(_build.KernelBuildError):
        if family == "mesh_knn_topk":
            mesh.mesh_knn_topk(m, dl, live, q, one, one, 10)
        elif family == "mesh_knn_coarse":
            mesh.mesh_knn_coarse(m.to(torch.int8), dl, dl, live,
                                 q.to(torch.int8), one, one, one, 16)
        elif family == "mesh_knn_rerank":
            mesh.mesh_knn_rerank(m, dl, live, q, one, one, cand,
                                 torch.zeros(s, 1, 16), 10)
        elif family == "mesh_bm25_flat":
            mesh.mesh_bm25_flat(docs, tfs, dl, idx[:, None], w[:, None],
                                idx[:, None], w[:, None] + 1, live, seg,
                                n_pad, 1, 10, 1)
        elif family == "mesh_sparse_topk":
            mesh.mesh_sparse_topk(docs, tfs, idx[:, None, None],
                                  w[:, None, None], live, n_pad, 10)
        elif family == "mesh_sparse_coarse":
            mesh.mesh_sparse_coarse(docs, tfs.to(torch.bfloat16),
                                    idx[:, None], w[:, None], live, n_pad, 16)
        elif family == "mesh_sparse_rerank":
            mesh.mesh_sparse_rerank(docs, tfs, idx[:, None], w[:, None], live,
                                    torch.zeros(s, 1, 16, dtype=torch.int32),
                                    torch.zeros(s, 1, 16), n_pad, 16, 10)
        elif family == "mesh_bm25_coarse":
            mesh.mesh_bm25_coarse(docs, tfs.to(torch.bfloat16),
                                  dl.to(torch.bfloat16), idx, w, idx, w + 1,
                                  live, seg, n_pad, 1, 16, 1)
        else:
            mesh.mesh_bm25_rerank(docs, tfs, idx, w, idx, w + 1, dl, live,
                                  torch.zeros(s, 1, 16, dtype=torch.int32),
                                  torch.zeros(s, 1, 16), n_pad, 1, 16, 10)


def test_rrf_request_fails_when_the_fusion_kernel_fails(monkeypatch):
    """A hybrid request whose fusion kernel raises fails with an error
    naming the kernel: the coordinator never fuses on the host instead,
    and counts no host-fusion fallback."""
    from elasticsearch_tpu_torch import _build
    from elasticsearch_tpu_torch.ops import fusion
    from elasticsearch_tpu_torch.testing import InProcessCluster

    cluster = InProcessCluster(n_nodes=1, seed=7, device="cpu")
    cluster.start()
    client = cluster.client()
    try:
        _, err = cluster.call(lambda cb: client.create_index("h", {
            "settings": {"number_of_shards": 1, "number_of_replicas": 0},
            "mappings": {"properties": {
                "body": {"type": "text"},
                "vec": {"type": "dense_vector", "dims": 2,
                        "similarity": "l2_norm"}}}}, cb))
        assert err is None, err
        for i in range(12):
            _, err = cluster.call(lambda cb, i=i: client.index_doc(
                "h", str(i), {"body": "a b" if i % 2 else "b c",
                              "vec": [float(i), 0.0]}, cb))
            assert err is None, err
        cluster.call(lambda cb: client.refresh("h", cb))

        def broken(*a, **k):
            raise _build.KernelError("[rrf_fuse_batch] kernel launch "
                                     "failed: CUDA error 700")

        monkeypatch.setattr(fusion, "rrf_fuse_batch", broken)
        body = {"query": {"match": {"body": "b"}},
                "knn": {"field": "vec", "query_vector": [3.0, 0.0],
                        "k": 3, "num_candidates": 12},
                "rank": {"rrf": {}}}
        resp, err = cluster.call(lambda cb: client.search("h", body, cb))
        assert resp is None and err is not None
        assert "rrf_fuse_batch" in str(err)
        node = next(iter(cluster.nodes.values()))
        assert node.search_action.rrf_fuser.stats["rrf_fuse_fallbacks"] == 0
        assert node.search_action.rrf_fuser.stats["rrf_fuse_batches"] == 0
    finally:
        cluster.stop()


@pytest.mark.parametrize("family", ["sharded_knn", "sharded_bm25",
                                    "sharded_bm25_batch", "sharded_sparse",
                                    "sharded_hybrid"])
def test_sharded_wrappers_never_take_the_plain_version(family, monkeypatch):
    """The sharded data plane's wrappers (rows 40-44), given CUDA tensors,
    launch their kernel or raise: with the kernel library unavailable they
    raise instead of running the plain versions on the host."""
    from elasticsearch_tpu_torch import _build
    from elasticsearch_tpu_torch.ops import bm25
    from elasticsearch_tpu_torch.parallel import sharded_search as sh

    def no_library(fam):
        raise _build.KernelBuildError("no nvcc")

    def no_plain(*a, **k):
        pytest.fail("plain version ran for a CUDA call")

    monkeypatch.setattr(_build, "library", no_library)
    monkeypatch.setattr(bm25, "_FNS", {})
    monkeypatch.setattr(sh, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(sh, "_stream", lambda: 0)
    for name in ("sharded_knn_plain", "sharded_bm25_plain",
                 "sharded_bm25_batch_plain", "sharded_sparse_plain",
                 "sharded_hybrid_plain"):
        monkeypatch.setattr(sh, name, no_plain)
    s, n = 2, 256
    docs = torch.full((s, 2, 128), -1, dtype=torch.int32)
    tfs = torch.zeros(s, 2, 128)
    dl = torch.ones(s, n)
    idx = torch.zeros(s, 8, dtype=torch.int32)
    w = torch.zeros(s, 8)
    m = torch.zeros(s, n, 4)
    valid = torch.ones(s, n, dtype=torch.bool)
    q = torch.ones(1, 4)
    one = torch.ones(1)
    with pytest.raises(_build.KernelBuildError):
        if family == "sharded_knn":
            sh.sharded_knn(m, dl, valid, q, one, one, 10)
        elif family == "sharded_bm25":
            sh.sharded_bm25(docs, tfs, dl, 3.0, idx, w, 10)
        elif family == "sharded_bm25_batch":
            sh.sharded_bm25_batch(docs, tfs, dl, 3.0, idx[:, None],
                                  w[:, None], 10, counted=True)
        elif family == "sharded_sparse":
            sh.sharded_sparse(docs, tfs, idx, w, n, 10)
        else:
            sh.sharded_hybrid(docs, tfs, dl, 3.0, idx, w, m, dl, valid,
                              q[0], one, one, 10)
