"""The served match path of elasticsearch_tpu_torch against the JAX package,
end to end: the same documents through the reference ``InternalEngine`` +
``SearchService`` and through the port's on ``device="cpu"`` (the kernels'
plain PyTorch versions) must give the same ``_search`` responses.

Tolerance: scores to rtol 1e-6 (the port sums contributions exactly in
fixed point and rounds once; the reference adds them in f32 one by one);
ids, totals and relations exact, except that hits whose reference scores
tie within that tolerance are compared as a set.
"""

import numpy as np
import pytest

from elasticsearch_tpu.index import InternalEngine as RefEngine
from elasticsearch_tpu.index.store import Store as RefStore
from elasticsearch_tpu.index.translog import Translog as RefTranslog
from elasticsearch_tpu.mapping import MapperService as RefMappers
from elasticsearch_tpu.ops.device_segment import PLANES as REF_PLANES
from elasticsearch_tpu.search import SearchService as RefService

from elasticsearch_tpu_torch.convert import segments_from_reference
from elasticsearch_tpu_torch.index import InternalEngine, Reader
from elasticsearch_tpu_torch.index.store import Store
from elasticsearch_tpu_torch.index.translog import Translog
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.ops.device_segment import PLANES
from elasticsearch_tpu_torch.search import SearchService, dsl
from elasticsearch_tpu_torch.search.batch_executor import (
    _build_ctxs, batched_wand_topk_shard,
)
from elasticsearch_tpu_torch.search.phase import query_shard, shard_term_stats
from elasticsearch_tpu_torch.utils.errors import NotPortedError

RTOL = 1e-6
MAPPING = {"properties": {"body": {"type": "text"},
                          "tag": {"type": "keyword"},
                          "vec": {"type": "dense_vector", "dims": 3}}}
WORDS = [f"w{i}" for i in range(400)]


def make_docs(seed: int, n: int):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = np.minimum(rng.zipf(1.35, int(rng.integers(8, 40))) - 1, 399)
        out.append(" ".join(WORDS[t] for t in toks))
    return out


def make_queries(seed: int, n: int):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = np.minimum(rng.zipf(1.35, int(rng.integers(1, 5))) - 1, 399)
        out.append(" ".join(WORDS[t] for t in toks))
    return out


def index_both(docs, refresh_at=(), deletes=()):
    ref = RefEngine(RefMappers(MAPPING), shard_label="ref")
    port = InternalEngine(MapperService(MAPPING), shard_label="port")
    for i, text in enumerate(docs):
        body = {"body": text, "tag": f"t{i % 7}"}
        ref.index(str(i), body)
        port.index(str(i), body)
        if i in refresh_at:
            ref.refresh()
            port.refresh()
    ref.refresh()
    port.refresh()
    for i in deletes:
        ref.delete(str(i))
        port.delete(str(i))
    ref.refresh()
    port.refresh()
    return ref, port


@pytest.fixture
def planes():
    """Both packages' plane registries, restored after the test."""
    keep = [(p, p.quantized, p.rerank_depth, p.rerank_depth_max,
             p.min_segments) for p in (REF_PLANES, PLANES)]
    REF_PLANES.clear()
    PLANES.clear()
    yield
    for p, q, d, dm, ms in keep:
        p.quantized, p.rerank_depth, p.rerank_depth_max = q, d, dm
        p.min_segments = ms
        p.clear()


def assert_same_response(a, b):
    ha, hb = a["hits"], b["hits"]
    assert ha["total"] == hb["total"]
    if ha["max_score"] is None:
        assert hb["max_score"] is None
    else:
        assert hb["max_score"] == pytest.approx(ha["max_score"], rel=RTOL)
    ids_a = [h["_id"] for h in ha["hits"]]
    ids_b = [h["_id"] for h in hb["hits"]]
    sa = np.array([h["_score"] for h in ha["hits"]])
    sb = np.array([h["_score"] for h in hb["hits"]])
    assert len(ids_a) == len(ids_b)
    np.testing.assert_allclose(sb, sa, rtol=RTOL)
    i = 0
    while i < len(sa):
        j = i + 1
        while j < len(sa) and abs(sa[j] - sa[i]) <= RTOL * abs(sa[i]):
            j += 1
        if j < len(sa):        # a tie group at the cut may continue past it
            assert set(ids_a[i:j]) == set(ids_b[i:j])
        i = j
    for x, y in zip(ha["hits"], hb["hits"]):
        if x["_id"] == y["_id"]:
            assert x["_source"] == y["_source"]


def run_bodies(ref_svc, port_svc, queries, tracks=(None, False, 5),
               size=10):
    for text in queries:
        for track in tracks:
            body = {"query": {"match": {"body": text}}, "size": size}
            if track is not None:
                body["track_total_hits"] = track
            assert_same_response(ref_svc.search(body), port_svc.search(body))


@pytest.mark.parametrize("layout", ["one_segment", "segments_and_deletes"])
def test_search_responses_match_reference(layout, planes):
    docs = make_docs(1, 1200)
    if layout == "one_segment":
        ref, port = index_both(docs)
    else:
        ref, port = index_both(docs, refresh_at=(300, 700),
                               deletes=(3, 301, 702, 1100))
    assert (len(port.acquire_reader().segments) == 1) == (
        layout == "one_segment")
    run_bodies(RefService(ref), SearchService(port, device="cpu"),
               make_queries(2, 12))


@pytest.mark.parametrize("quantized", [True, False])
def test_quantized_tier_on_and_off_match_reference(quantized, planes):
    ref, port = index_both(make_docs(3, 1500), refresh_at=(500, 1000),
                           deletes=(10, 600))
    for p in (REF_PLANES, PLANES):
        p.quantized = quantized
        # a shallow first depth makes the margin fail and escalate
        p.rerank_depth, p.rerank_depth_max = 16, 64
    esc0 = PLANES.stats["rerank_escalations"]
    served0 = PLANES.stats["quantized_queries"]
    run_bodies(RefService(ref), SearchService(port, device="cpu"),
               make_queries(4, 10), tracks=(None, False))
    if quantized:
        assert PLANES.stats["quantized_queries"] > served0
        assert PLANES.stats["rerank_escalations"] > esc0
    else:
        assert PLANES.stats["quantized_queries"] == served0


def test_batch_of_eight_equals_solo_runs(planes):
    _ref, port = index_both(make_docs(5, 1000), refresh_at=(400,),
                            deletes=(7,))
    queries = make_queries(6, 8)
    reader = port.acquire_reader()
    mappers = port.mappers
    solo = [query_shard(reader, mappers, dsl.Match(field="body", text=q),
                        size=10, device="cpu") for q in queries]
    doc_count, dfs = shard_term_stats(reader, mappers, dsl.Bool(
        should=[dsl.Match(field="body", text=q) for q in queries]))
    ctxs = _build_ctxs(reader, mappers, doc_count, dfs, device="cpu")
    batch = batched_wand_topk_shard(ctxs, "body",
                                    [[(q, 1.0)] for q in queries], 10,
                                    10_000)
    for res, (cands, hits, rel, max_score, _prune) in zip(solo, batch):
        assert [(d.segment_idx, d.doc, d.score) for d in res.docs] == \
            [(d.segment_idx, d.doc, d.score) for d in cands[:10]]
        assert (res.total_hits, res.total_relation, res.max_score) == \
            (hits, rel, max_score)


def test_reference_store_opens_in_the_port(tmp_path, planes):
    docs = make_docs(7, 600)
    ref = RefEngine(RefMappers(MAPPING), store=RefStore(tmp_path / "store"),
                    translog=RefTranslog(tmp_path / "translog"),
                    shard_label="ref")
    for i, text in enumerate(docs):
        ref.index(str(i), {"body": text})
        if i == 300:
            ref.flush()
    ref.delete("5")
    ref.flush()
    ref.index("tail", {"body": "w0 w1 only in the translog"})
    ref.refresh()
    ref_hits = RefService(ref)
    port = InternalEngine(MapperService(MAPPING),
                          store=Store(tmp_path / "store"),
                          translog=Translog(tmp_path / "translog"),
                          shard_label="port")
    port.recover_from_store()
    port.refresh()
    assert port.doc_count == ref.doc_count
    run_bodies(ref_hits, SearchService(port, device="cpu"),
               make_queries(8, 6) + ["w0 w1"], tracks=(None,))
    ref.close()
    port.close()


def test_converted_segments_serve_the_same_hits(planes):
    ref, _port = index_both(make_docs(9, 800), refresh_at=(400,),
                            deletes=(2,))
    reader = ref.acquire_reader()
    segs = segments_from_reference(reader.segments)
    for a, b in zip(reader.segments, segs):
        assert (a.name, a.n_docs, a.ids) == (b.name, b.n_docs, b.ids)
        np.testing.assert_array_equal(a.live, b.live)
        pa, pb = a.postings["body"], b.postings["body"]
        for name in ("block_docs", "block_tfs", "doc_lens", "doc_freq"):
            np.testing.assert_array_equal(getattr(pa, name),
                                          getattr(pb, name))
        assert pa.terms == pb.terms
    from elasticsearch_tpu.search.phase import query_shard as ref_query
    from elasticsearch_tpu.search import dsl as ref_dsl
    mappers = MapperService(MAPPING)
    for q in make_queries(10, 5):
        want = ref_query(reader, ref.mappers,
                         ref_dsl.Match(field="body", text=q), size=10)
        got = query_shard(Reader(segs), mappers,
                          dsl.Match(field="body", text=q), size=10,
                          device="cpu")
        assert [(d.segment_idx, d.doc) for d in got.docs] == \
            [(d.segment_idx, d.doc) for d in want.docs]
        assert (got.total_hits, got.total_relation) == \
            (want.total_hits, want.total_relation)


@pytest.mark.parametrize("body,feature", [
    # (the ids predate the dense collector, which now serves the bodies
    # they named -- tests/test_torch_dense_slice.py -- and are kept for
    # the query nodes still outside the port)
    pytest.param({"query": {"function_score": {
        "query": {"match": {"body": "w1"}},
        "functions": [{"weight": 2.0}]}}}, "dense_query:FunctionScore",
        id="body0-dense_collector"),
    pytest.param({"query": {"query_string": {"query": "w1 AND w2"}},
                  "track_total_hits": True}, "dense_query:QueryString",
                 id="body1-dense_collector"),
    # (the ids of body2 and body3 predate the wide selection and the
    # aggregations, which the port now serves -- tests/test_torch_window.py
    # and tests/test_torch_aggs_slice.py -- so these bodies are held to the
    # reference's answer; feature None)
    pytest.param({"query": {"knn": {"field": "vec", "query_vector": [1, 0, 0],
                                    "k": 5000, "num_candidates": 5000,
                                    "filter": {"term": {"tag": "t1"}}}}},
                 None, id="body2-knn_topk_collector"),
    pytest.param({"query": {"match": {"body": "w1"}}, "aggs": {
        "t": {"terms": {"field": "tag"}}}}, None, id="body3-aggregations"),
])
def test_out_of_slice_requests_raise_not_ported(body, feature, planes):
    from elasticsearch_tpu_torch.search import telemetry
    ref, port = index_both(make_docs(11, 50))
    svc = SearchService(port, device="cpu")
    if feature is None:
        want, got = RefService(ref).search(body), svc.search(body)
        assert_same_response(want, got)
        assert got.get("aggregations") == want.get("aggregations")
        return
    before = telemetry.TELEMETRY.not_ported.get(feature, 0)
    with pytest.raises(NotPortedError) as info:
        svc.search(body)
    assert info.value.status == 501
    assert info.value.feature == feature
    assert telemetry.TELEMETRY.not_ported[feature] == before + 1
