"""The served dense collector of elasticsearch_tpu_torch against the JAX
package, end to end: the same documents through each package's
``InternalEngine`` + ``SearchService`` (the port on ``device="cpu"``, the
kernels' plain PyTorch versions) must give the same ``_search`` and
``_count`` responses over the request mix the dense collector serves --
exact totals, bool with filters and must_not, should with
minimum_should_match, the multi-term leaves, the phrase pair, dis_max,
constant_score, boosting, match_all, field sorts with missing values and
search_after, min_score, rescore, collapse, slice, terminate_after,
script_score's three vector functions and knn inside compound queries --
on one segment and on several segments with deletes.

Tolerance: scores to rtol 1e-6 (BM25 rows: the port sums a doc's
contributions exactly in fixed point and rounds once, the reference adds
them in f32 one by one; the vectors are integer-valued, so their parts
are exact); ids, totals, relations and field sort values exact (a
``_score`` sort value is a score: rtol 1e-6), except that hits whose
reference scores tie within that tolerance are compared as a set.

The port's own identity is bitwise: a ``match`` served by the dense
collector (K8 + K10) gives the block-max-pruned collector's (K1) hits and
score bits.
"""

import numpy as np
import pytest

from elasticsearch_tpu.index import InternalEngine as RefEngine
from elasticsearch_tpu.mapping import MapperService as RefMappers
from elasticsearch_tpu.ops.device_segment import PLANES as REF_PLANES
from elasticsearch_tpu.search import SearchService as RefService
from elasticsearch_tpu.search import dsl as ref_dsl
from elasticsearch_tpu.search.phase import query_shard as ref_query_shard
from elasticsearch_tpu.utils.errors import QueryParsingError as RefParseError

from elasticsearch_tpu_torch.index import InternalEngine
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.ops.device_segment import PLANES
from elasticsearch_tpu_torch.search import SearchService, dsl
from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE
from elasticsearch_tpu_torch.search.phase import query_shard
from elasticsearch_tpu_torch.utils.errors import QueryParsingError

RTOL = 1e-6
DIMS = 8
MAPPING = {"properties": {
    "body": {"type": "text"}, "tag": {"type": "keyword"},
    "n": {"type": "integer"},
    "vec": {"type": "dense_vector", "dims": DIMS, "similarity": "cosine"}}}
WORDS = [f"w{i}" for i in range(300)]
LAYOUTS = {"one_segment": ((), ()),
           "segments_and_deletes": ((250, 520), (3, 251, 600, 777))}


def make_docs(seed: int, n: int):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        toks = np.minimum(rng.zipf(1.35, int(rng.integers(6, 30))) - 1, 299)
        doc = {"body": " ".join(WORDS[t] for t in toks), "tag": f"t{i % 7}"}
        if i % 9:
            doc["n"] = int(rng.integers(0, 100))
        if i % 11:
            doc["vec"] = [float(x) for x in rng.integers(0, 10, DIMS)]
        out.append(doc)
    return out


_ENGINES = {}


def engines(layout: str):
    """(reference engine, port engine) with the same 900 documents, built
    once per layout."""
    if layout not in _ENGINES:
        refresh_at, deletes = LAYOUTS[layout]
        ref = RefEngine(RefMappers(MAPPING), shard_label="ref")
        port = InternalEngine(MapperService(MAPPING), shard_label="port")
        for i, doc in enumerate(make_docs(21, 900)):
            ref.index(str(i), doc)
            port.index(str(i), doc)
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
        _ENGINES[layout] = (ref, port)
    return _ENGINES[layout]


@pytest.fixture
def planes():
    """Both packages' plane registries, restored after the test."""
    keep = [(p, p.enabled, p.quantized) for p in (REF_PLANES, PLANES)]
    REF_PLANES.clear()
    PLANES.clear()
    yield
    for p, en, q in keep:
        p.enabled, p.quantized = en, q
        p.clear()


def assert_same_response(a, b):
    ha, hb = a["hits"], b["hits"]
    assert ha["total"] == hb["total"]
    if ha["max_score"] is None:
        assert hb["max_score"] is None
    else:
        assert hb["max_score"] == pytest.approx(ha["max_score"], rel=RTOL)
    assert len(ha["hits"]) == len(hb["hits"])
    ids_a = [h["_id"] for h in ha["hits"]]
    ids_b = [h["_id"] for h in hb["hits"]]
    sa = np.array([h["_score"] if h["_score"] is not None else np.nan
                   for h in ha["hits"]], np.float64)
    sb = np.array([h["_score"] if h["_score"] is not None else np.nan
                   for h in hb["hits"]], np.float64)
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
            # a _score sort value is a score: the same tolerance
            assert y.get("sort") == pytest.approx(x.get("sort"), rel=RTOL)
            assert x.get("fields") == y.get("fields")


QV = [1.0, 4.0, 2.0, 0.0, 7.0, 3.0, 5.0, 1.0]


def script(fn: str, suffix: str = ""):
    return {"source": f"{fn}(params.qv, 'vec'){suffix}",
            "params": {"qv": QV}}


def knn(k: int = 10, **extra):
    return {"knn": {"field": "vec", "query_vector": QV, "k": k,
                    "num_candidates": 50, **extra}}


BODIES = {
    # (these two asserted dense_collector 501s before the dense collector)
    "match_exact_totals": {"query": {"match": {"body": "w1 w7"}},
                           "track_total_hits": True},
    "bool_must_filter": {"query": {"bool": {
        "must": [{"match": {"body": "w1"}}],
        "filter": [{"term": {"tag": "t1"}}]}}},
    "bool_full": {"query": {"bool": {
        "must": [{"match": {"body": "w2 w5"}}],
        "filter": [{"terms": {"tag": ["t1", "t2", "t4"]}},
                   {"range": {"n": {"gte": 10, "lt": 70}}}],
        "must_not": [{"match": {"body": "w3"}}]}},
        "track_total_hits": True},
    "bool_should_msm": {"query": {"bool": {"should": [
        {"match": {"body": "w4"}}, {"match": {"body": "w6"}},
        {"term": {"tag": "t3"}}], "minimum_should_match": 2}}},
    "bool_boost_must_not_only": {"query": {"bool": {
        "must_not": [{"term": {"tag": "t0"}}], "boost": 2.0}}},
    "match_and": {"query": {"match": {"body": {
        "query": "w1 w2 w8", "operator": "and"}}}},
    "match_msm": {"query": {"match": {"body": {
        "query": "w1 w2 w8 w9", "minimum_should_match": "50%"}}}},
    "multi_match_best": {"query": {"multi_match": {
        "query": "w1 t2", "fields": ["body", "tag^3"]}}},
    "multi_match_most": {"query": {"multi_match": {
        "query": "w3 w9", "fields": ["body", "tag"],
        "type": "most_fields"}}},
    "match_phrase": {"query": {"match_phrase": {"body": "w0 w1"}}},
    "match_phrase_slop": {"query": {"match_phrase": {
        "body": {"query": "w2 w0", "slop": 2}}}},
    "match_phrase_prefix": {"query": {"match_phrase_prefix": {
        "body": "w0 w1"}}},
    "dis_max": {"query": {"dis_max": {"queries": [
        {"match": {"body": "w5"}}, {"match": {"body": "w6 w7"}}],
        "tie_breaker": 0.3}}},
    "constant_score": {"query": {"constant_score": {
        "filter": {"range": {"n": {"lte": 30}}}, "boost": 1.5}}},
    "boosting": {"query": {"boosting": {
        "positive": {"match": {"body": "w2"}},
        "negative": {"term": {"tag": "t5"}}, "negative_boost": 0.2}}},
    "match_all": {"query": {"match_all": {}}, "size": 10},
    "match_all_boost_paged": {"query": {"match_all": {"boost": 3.0}},
                              "from": 40, "size": 15},
    "match_none": {"query": {"match_none": {}}},
    "leaves": {"query": {"bool": {"should": [
        {"exists": {"field": "n"}}, {"ids": {"values": ["5", "77", "404"]}},
        {"prefix": {"tag": "t6"}}, {"wildcard": {"body": "w1?"}},
        {"regexp": {"body": "w2[0-3]"}},
        {"fuzzy": {"body": {"value": "w100", "fuzziness": 1}}}]}}},
    "sort_field_asc": {"query": {"match": {"body": "w8"}},
                       "sort": [{"n": {"order": "asc"}}], "size": 25},
    "sort_field_desc_missing": {"query": {"match": {"body": "w8"}},
                                "sort": [{"n": {"order": "desc",
                                                "missing": 50}}],
                                "size": 25},
    "sort_search_after": {"query": {"match": {"body": "w8"}},
                          "sort": [{"n": {"order": "desc"}}],
                          "search_after": [60], "size": 25},
    "sort_score_asc": {"query": {"match": {"body": "w9 w12"}},
                       "sort": [{"_score": {"order": "asc"}}]},
    "score_search_after": {"query": {"match": {"body": "w9"}},
                           "search_after": [2.0]},
    "min_score": {"query": {"match": {"body": "w2 w11"}}, "min_score": 3.0},
    "size_zero": {"query": {"match": {"body": "w4"}}, "size": 0,
                  "track_total_hits": True},
    "rescore": {"query": {"match": {"body": "w1"}}, "rescore": {
        "window_size": 20, "query": {
            "rescore_query": {"match": {"body": "w3"}},
            "query_weight": 0.5, "rescore_query_weight": 2.0}}},
    "collapse": {"query": {"match": {"body": "w2"}},
                 "collapse": {"field": "tag"}},
    "slice": {"query": {"match": {"body": "w1"}},
              "slice": {"id": 1, "max": 3}},
    "script_score_cosine": {"query": {"script_score": {
        "query": {"match_all": {}},
        "script": script("cosineSimilarity", " + 1.0")}}},
    "script_score_dot": {"query": {"script_score": {
        "query": {"bool": {"filter": [{"term": {"tag": "t2"}}]}},
        "script": script("dotProduct")}}},
    "script_score_l2": {"query": {"script_score": {
        "query": {"range": {"n": {"lt": 50}}},
        "script": script("l2norm")}}, "size": 5},
    # (this one asserted a dense_collector 501 before the dense collector)
    "knn_in_bool_must": {"query": {"bool": {"must": [knn(3)]}}},
    "knn_in_bool_filtered": {"query": {"bool": {
        "must": [knn(40)], "filter": [{"term": {"tag": "t1"}}]}}},
    "knn_in_bool_should": {"query": {"bool": {"should": [
        knn(20), {"match": {"body": "w3"}}]}}, "track_total_hits": True},
    "knn_in_dis_max": {"query": {"dis_max": {"queries": [
        knn(15), {"match": {"body": "w4"}}]}}},
    "knn_profile": {"query": knn(10), "profile": True},
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", list(BODIES))
def test_dense_responses_match_reference(name, layout, planes):
    ref, port = engines(layout)
    body = BODIES[name]
    want = RefService(ref).search(body)
    got = SearchService(port, device="cpu").search(body)
    assert_same_response(want, got)
    if body.get("profile"):
        collectors = [s["collector"][0]["name"]
                      for s in got["profile"]["shards"][0]["searches"]]
        assert collectors == ["SimpleTopScoreDocCollector"]


COUNTS = [{"match": {"body": "w1"}}, {"term": {"tag": "t3"}},
          {"bool": {"filter": [{"range": {"n": {"gte": 40}}}],
                    "must_not": [{"match": {"body": "w0"}}]}},
          {"match_all": {}}, None]


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("qi", range(len(COUNTS)))
def test_count_matches_reference(qi, layout, planes):
    ref, port = engines(layout)
    body = {} if COUNTS[qi] is None else {"query": COUNTS[qi]}
    want = RefService(ref).count(body)
    got = SearchService(port, device="cpu").count(body)
    assert got == want


@pytest.mark.parametrize("limit", [1, 40, 10_000])
def test_terminate_after_matches_reference(limit, planes):
    ref, port = engines("segments_and_deletes")
    body = {"match": {"body": "w1 w3"}}
    want = ref_query_shard(ref.acquire_reader(), ref.mappers,
                           ref_dsl.parse_query(body), size=10,
                           terminate_after=limit)
    got = query_shard(port.acquire_reader(), port.mappers,
                      dsl.parse_query(body), size=10, terminate_after=limit,
                      device="cpu")
    assert (got.total_hits, got.total_relation, got.terminated_early) == \
        (want.total_hits, want.total_relation, want.terminated_early)
    assert [(d.segment_idx, d.doc) for d in got.docs] == \
        [(d.segment_idx, d.doc) for d in want.docs]
    np.testing.assert_allclose([d.score for d in got.docs],
                               [d.score for d in want.docs], rtol=RTOL)


def test_unsupported_script_raises_the_reference_400(planes):
    """script_score over knn with a source that is not a vector function:
    both packages refuse it as a parsing error (400), not 501."""
    ref, port = engines("segments_and_deletes")
    body = {"query": {"script_score": {"query": knn(3), "script": {
        "source": "_score"}}}}
    with pytest.raises(RefParseError):
        RefService(ref).search(body)
    with pytest.raises(QueryParsingError) as info:
        SearchService(port, device="cpu").search(body)
    assert info.value.status == 400


@pytest.mark.parametrize("text", ["w1", "w2 w7 w30", "w0 w150 w3 w3"])
def test_dense_match_equals_the_pruned_collector_bitwise(text, planes):
    """The same match through the dense collector (exact totals: K8 per
    segment, then K10) and through the block-max-pruned one (K1): the same
    hits, score bits and totals, and the dense path launches K8 and K10
    once per segment and nothing of K1."""
    _ref, port = engines("segments_and_deletes")
    reader = port.acquire_reader()
    n_segs = len(reader.segments)
    fams = ("bm25_scores", "dense_topk", "bm25_flat")
    before = {f: DEVICE_PROFILE.family(f).calls for f in fams}
    dense = query_shard(reader, port.mappers,
                        dsl.Match(field="body", text=text), size=20,
                        track_total_hits=True, device="cpu")
    calls = {f: DEVICE_PROFILE.family(f).calls - before[f] for f in fams}
    assert calls == {"bm25_scores": n_segs, "dense_topk": n_segs,
                     "bm25_flat": 0}
    assert dense.collector == "dense"
    pruned = query_shard(reader, port.mappers,
                         dsl.Match(field="body", text=text), size=20,
                         device="cpu")
    assert pruned.collector == "wand_topk"
    assert [(d.segment_idx, d.doc, d.score) for d in dense.docs] == \
        [(d.segment_idx, d.doc, d.score) for d in pruned.docs]
    assert (dense.total_hits, dense.total_relation, dense.max_score) == \
        (pruned.total_hits, pruned.total_relation, pruned.max_score)


def test_script_score_launches_knn_scores_and_dense_topk(planes):
    _ref, port = engines("segments_and_deletes")
    n_segs = len(port.acquire_reader().segments)
    fams = ("knn_scores", "dense_topk", "knn_flat")
    before = {f: DEVICE_PROFILE.family(f).calls for f in fams}
    SearchService(port, device="cpu").search(BODIES["script_score_cosine"])
    calls = {f: DEVICE_PROFILE.family(f).calls - before[f] for f in fams}
    assert calls == {"knn_scores": n_segs, "dense_topk": n_segs,
                     "knn_flat": 0}
