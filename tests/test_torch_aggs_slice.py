"""The served aggregation path of elasticsearch_tpu_torch against the JAX
package, end to end, on ``device="cpu"`` (the kernels' plain versions):

- ``SearchService.search`` with ``aggs``: the bodies of the reference's
  ``tests/test_aggregations.py``, ``test_aggs_round2.py`` and
  ``test_aggs_round3.py`` that run on one shard (their multi-shard
  cluster cases need the node layer, which the port does not have yet),
  and the geonames-shaped bodies that ``chip_smoke.py`` drives at full
  scale, on each package's engine with the same documents;
- ``search.plane_aggs.plan_drain_aggs`` over the columns plane: its
  presets equal the reference's and the port's own host partials (the
  checks of the reference's ``tests/test_plane_aggs.py``: deletes,
  point-in-time readers, occupancy, eviction and incremental append, the
  breaker-starved fallback and the typed ineligible shapes).

Tolerance: none, except ``_score`` / ``max_score`` inside hits (rtol
1e-6, the BM25 bound of tests/test_torch_slice.py): keys, counts, sums,
mins and maxs are equal, sums bitwise -- each bucket's f32 sum adds in
row order in both packages (tests/test_torch_aggs.py).
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from elasticsearch_tpu.index import InternalEngine as RefEngine
from elasticsearch_tpu.mapping import MapperService as RefMappers
from elasticsearch_tpu.ops.device_segment import PLANES as REF_PLANES
from elasticsearch_tpu.search import SearchService as RefService
from elasticsearch_tpu.search.plane_aggs import (
    plan_drain_aggs as ref_plan_drain_aggs,
)
from elasticsearch_tpu.utils.errors import (
    IllegalArgumentError as RefIllegalArgument,
)

from elasticsearch_tpu_torch.index import InternalEngine
from elasticsearch_tpu_torch.indices.breaker import BREAKERS
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.ops.device_segment import PLANES
from elasticsearch_tpu_torch.search import SearchService, dsl, telemetry
from elasticsearch_tpu_torch.search.aggregations import (
    ShardAggregator, parse_aggs, reduce_aggs,
)
from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE
from elasticsearch_tpu_torch.search.phase import parse_sort, query_shard
from elasticsearch_tpu_torch.search.plane_aggs import plan_drain_aggs
from elasticsearch_tpu_torch.utils.errors import IllegalArgumentError

RTOL = 1e-6

# -- the reference suites' corpora ------------------------------------------

BOOKS_MAPPING = {"properties": {
    "genre": {"type": "keyword"}, "title": {"type": "text"},
    "price": {"type": "double"}, "stock": {"type": "long"},
    "sold": {"type": "date"}, "tags": {"type": "keyword"}}}
BOOKS = [
    {"genre": "scifi", "title": "dune", "price": 10.0, "stock": 3,
     "sold": "2024-01-05", "tags": ["a", "b"]},
    {"genre": "scifi", "title": "foundation", "price": 20.0, "stock": 1,
     "sold": "2024-01-20", "tags": ["a"]},
    {"genre": "fantasy", "title": "hobbit", "price": 30.0, "stock": 7,
     "sold": "2024-02-10", "tags": ["b"]},
    {"genre": "fantasy", "title": "mistborn", "price": 40.0, "stock": 2,
     "sold": "2024-03-01", "tags": ["c"]},
    {"genre": "crime", "title": "gone girl", "price": 15.0, "stock": 5,
     "sold": "2024-03-15"},
    {"title": "untagged", "price": 5.0, "stock": 0, "sold": "2024-01-31"},
]
SHOP_MAPPING = {"properties": {
    "body": {"type": "text"}, "color": {"type": "keyword"},
    "size": {"type": "keyword"}, "price": {"type": "integer"}}}
SIGNAL_MAPPING = {"properties": {
    "body": {"type": "text"}, "tag": {"type": "keyword"}}}
R3_MAPPING = {"properties": {
    "cat": {"type": "keyword"}, "price": {"type": "double"},
    "qty": {"type": "integer"}, "ts": {"type": "date"},
    "loc": {"type": "geo_point"},
    "comments": {"type": "nested", "properties": {
        "stars": {"type": "integer"}, "author": {"type": "keyword"}}}}}
R3 = [
    {"cat": "a", "price": 10.0, "qty": 1, "ts": "2024-01-01T00:00:00Z",
     "loc": {"lat": 48.85, "lon": 2.35},
     "comments": [{"stars": 5, "author": "kim"},
                  {"stars": 3, "author": "lee"}]},
    {"cat": "a", "price": 20.0, "qty": 2, "ts": "2024-01-01T01:00:00Z",
     "loc": {"lat": 48.86, "lon": 2.36},
     "comments": [{"stars": 4, "author": "kim"}]},
    {"cat": "b", "price": 30.0, "qty": 3, "ts": "2024-01-01T02:00:00Z",
     "loc": {"lat": 51.5, "lon": -0.12}},
    {"cat": "c", "price": 40.0, "qty": 4, "ts": "2024-01-02T00:00:00Z",
     "loc": {"lat": 40.71, "lon": -74.0}},
]

# -- the geonames shape (Rally's geonames track), at test size ---------------

GEONAMES_MAPPING = {"properties": {
    "name": {"type": "text"}, "country_code": {"type": "keyword"},
    "feature_class": {"type": "keyword"}, "population": {"type": "long"},
    "dem": {"type": "integer"}}}
FEATURE_CLASSES = ["A", "H", "L", "P", "R", "S", "T", "U", "V"]


def geonames_docs(seed: int, n: int):
    """GeoNames-shaped documents: Zipf-skewed country codes, 9 feature
    classes, a population with a share past 2^24 and dem in
    [-9999, 8848] (many negatives; -9999 is GeoNames' no-data value)."""
    rng = np.random.default_rng(seed)
    codes = [chr(65 + i // 26) + chr(65 + i % 26) for i in range(250)]
    words = [f"n{i}" for i in range(400)]
    out = []
    for _ in range(n):
        c = min(int(rng.zipf(1.3)) - 1, 249)
        dem = int(rng.integers(-200, 3000))
        if rng.random() < 0.05:
            dem = -9999
        elif rng.random() < 0.02:
            dem = int(rng.integers(3000, 8849))
        pop = int(rng.integers(0, 5000))
        if rng.random() < 0.1:
            pop = int(rng.integers(1 << 24, 1 << 26))
        out.append({
            "name": " ".join(words[int(min(rng.zipf(1.4), 400)) - 1]
                             for _ in range(int(rng.integers(1, 4)))),
            "country_code": codes[c],
            "feature_class": FEATURE_CLASSES[int(rng.integers(0, 9))],
            "population": pop, "dem": dem})
    return out


CORPORA = {
    "books": (BOOKS_MAPPING, lambda: BOOKS, (2,), ()),
    "shop": (SHOP_MAPPING, lambda: [
        {"body": "sale fox" if i % 5 == 0 else "plain item",
         "color": ["red", "blue", "green"][i % 3],
         "size": ["s", "m"][i % 2], "price": (i % 6) * 10}
        for i in range(30)], (), ()),
    "signal": (SIGNAL_MAPPING, lambda: [
        {"body": "crash report" if i < 12 else "feature request",
         "tag": ("bug" if i < 12 and i % 12 < 10 else
                 ["ui", "api", "docs"][i % 3])} for i in range(60)], (), ()),
    "round3": (R3_MAPPING, lambda: R3, (), ()),
    "geonames": (GEONAMES_MAPPING, lambda: geonames_docs(5, 3000),
                 (1100, 2100), (7, 1200, 2999)),
    # values just below 2^24 in a few buckets: every bucket's f32 sum
    # passes 2^24 within a few rows and rounds from there on
    "bigsum": ({"properties": {"v": {"type": "integer"},
                               "k": {"type": "keyword"}}},
               lambda: [{"v": int(v), "k": f"k{i % 3}"} for i, v in
                        enumerate(np.random.default_rng(9).integers(
                            0, (1 << 24) - 1, 2000))], (900,), (4,)),
}
_ENGINES = {}


def engines(name: str):
    if name not in _ENGINES:
        mapping, docs, refresh_at, deletes = CORPORA[name]
        ref = RefEngine(RefMappers(mapping), shard_label="ref")
        port = InternalEngine(MapperService(mapping), shard_label="port")
        for i, doc in enumerate(docs()):
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
        _ENGINES[name] = (ref, port)
    return _ENGINES[name]


def _month_hist(aggs):
    return {"m": {"date_histogram": {"field": "sold",
                                     "calendar_interval": "month"},
                  "aggs": aggs}}


GEO_TERMS = {"country": {"terms": {"field": "country_code", "size": 20}}}
GEO_HIST = {"elevation": {"histogram": {"field": "dem", "interval": 100},
                          "aggs": {"lo": {"min": {"field": "dem"}},
                                   "hi": {"max": {"field": "dem"}},
                                   "mean": {"avg": {"field": "dem"}}}}}
GEO_QUERIES = [None, {"term": {"feature_class": "P"}},
               {"match": {"name": "n0 n1"}}]

BODIES = [
    # tests/test_aggregations.py
    ("books", {"p_avg": {"avg": {"field": "price"}},
               "p_sum": {"sum": {"field": "price"}},
               "p_min": {"min": {"field": "price"}},
               "p_max": {"max": {"field": "price"}},
               "p_count": {"value_count": {"field": "price"}}}, None),
    ("books", {"s": {"stats": {"field": "price"}},
               "e": {"extended_stats": {"field": "price"}}}, None),
    ("books", {"p": {"avg": {"field": "price"}}},
     {"term": {"genre": "scifi"}}),
    ("books", {"g": {"avg": {"field": "absent", "missing": 7}}}, None),
    ("books", {"g": {"avg": {"field": "absent"}}}, None),
    ("books", {"genres": {"cardinality": {"field": "genre"}},
               "prices": {"cardinality": {"field": "price"}}}, None),
    ("books", {"p": {"percentiles": {"field": "price",
                                     "percents": [50, 99]}},
               "r": {"percentile_ranks": {"field": "price",
                                          "values": [20]}},
               "m": {"median_absolute_deviation": {"field": "price"}}},
     None),
    ("books", {"w": {"weighted_avg": {"value": {"field": "price"},
                                      "weight": {"field": "stock"}}}},
     None),
    ("books", {"genres": {"terms": {"field": "genre"},
                          "aggs": {"top": {"top_hits": {"size": 1}}}}},
     {"match": {"title": "dune foundation hobbit"}}),
    ("books", {"g": {"terms": {"field": "genre"}}}, None),
    ("books", {"t": {"terms": {"field": "tags", "missing": "none"}}}, None),
    ("books", {"g": {"terms": {"field": "genre", "size": 2,
                               "order": {"_key": "asc"}}}}, None),
    ("books", {"g": {"terms": {"field": "genre",
                               "order": {"avg_price": "desc"}},
                     "aggs": {"avg_price": {"avg": {"field": "price"}}}}},
     None),
    ("books", {"s": {"terms": {"field": "stock"}}}, None),
    ("books", {"h": {"histogram": {"field": "price", "interval": 10}}},
     None),
    ("books", {"h": {"histogram": {"field": "price", "interval": 10,
                                   "min_doc_count": 1}}},
     {"terms": {"genre": ["scifi", "fantasy"]}}),
    ("books", {"h": {"histogram": {"field": "stock", "interval": 2},
                     "aggs": {"s": {"sum": {"field": "stock"}},
                              "m": {"max": {"field": "stock"}}}}}, None),
    ("books", {"m": {"date_histogram": {"field": "sold",
                                        "calendar_interval": "month"}}},
     None),
    ("books", {"d": {"date_histogram": {"field": "sold",
                                        "fixed_interval": "30d",
                                        "min_doc_count": 1}}}, None),
    ("books", {"r": {"range": {"field": "price", "ranges": [
        {"to": 15}, {"from": 15, "to": 30}, {"from": 30, "key": "big"}]}}},
     None),
    ("books", {"cheap": {"filter": {"range": {"price": {"lt": 16}}},
                         "aggs": {"a": {"avg": {"field": "price"}}}},
               "by": {"filters": {"filters": {
                   "s": {"term": {"genre": "scifi"}},
                   "f": {"term": {"genre": "fantasy"}}}}},
               "all_docs": {"global": {}, "aggs": {
                   "n": {"value_count": {"field": "price"}}}},
               "no_genre": {"missing": {"field": "genre"}}},
     {"term": {"genre": "scifi"}}),
    ("books", {"g": {"terms": {"field": "genre"}, "aggs": {
        "h": {"histogram": {"field": "price", "interval": 20},
              "aggs": {"mx": {"max": {"field": "stock"}}}}}}}, None),
    ("books", {**_month_hist({"rev": {"sum": {"field": "price"}}}),
               "avg_rev": {"avg_bucket": {"buckets_path": "m>rev"}},
               "max_rev": {"max_bucket": {"buckets_path": "m>rev"}},
               "total": {"sum_bucket": {"buckets_path": "m>_count"}}},
     None),
    ("books", _month_hist({
        "rev": {"sum": {"field": "price"}},
        "cum": {"cumulative_sum": {"buckets_path": "rev"}},
        "diff": {"derivative": {"buckets_path": "rev"}},
        "per_doc": {"bucket_script": {
            "buckets_path": {"r": "rev", "n": "_count"},
            "script": "r / n"}}}), None),
    ("books", _month_hist({
        "rev": {"sum": {"field": "price"}},
        "keep": {"bucket_selector": {"buckets_path": {"r": "rev"},
                                     "script": "r > 31"}}}), None),
    ("books", _month_hist({
        "rev": {"sum": {"field": "price"}},
        "by_rev": {"bucket_sort": {"sort": [{"rev": {"order": "desc"}}],
                                   "size": 2}}}), None),
    ("books", {"h": {"date_histogram": {"field": "sold",
                                        "fixed_interval": "1s"}}}, None),
    ("books", _month_hist({"keep": {"bucket_selector": {
        "buckets_path": "rev", "script": "x > 0"}}}), None),
    ("books", _month_hist({"keep": {"bucket_script": {
        "buckets_path": {"x": "_count"}}}}), None),
    # tests/test_aggs_round2.py
    ("shop", {"grid": {"composite": {"sources": [
        {"col": {"terms": {"field": "color"}}},
        {"sz": {"terms": {"field": "size"}}}], "size": 2}}}, None),
    ("shop", {"grid": {"composite": {"sources": [
        {"col": {"terms": {"field": "color"}}},
        {"sz": {"terms": {"field": "size"}}}], "size": 2,
        "after": {"col": "blue", "sz": "s"}}}}, None),
    ("shop", {"grid": {"composite": {"sources": [
        {"p": {"histogram": {"field": "price", "interval": 20}}}],
        "size": 10}, "aggs": {"avg_price": {"avg": {"field": "price"}}}}},
     None),
    ("shop", {"sig": {"significant_terms": {"field": "color",
                                            "min_doc_count": 1}}},
     {"match": {"body": "sale"}}),
    ("signal", {"sig": {"significant_terms": {"field": "tag",
                                              "min_doc_count": 2}}},
     {"match": {"body": "crash"}}),
    ("shop", {"c": {"terms": {"field": "color"}}}, None),
    ("shop", {"c": {"terms": {"field": "color"},
                    "aggs": {"m": {"max": {"field": "price"}}}}}, None),
    ("shop", {"h": {"histogram": {"field": "price", "interval": 20},
                    "aggs": {"s": {"sum": {"field": "price"}},
                             "mx": {"max": {"field": "price"}},
                             "avg": {"avg": {"field": "price"}}}}}, None),
    ("shop", {"h": {"histogram": {"field": "price", "interval": 20}}},
     {"match": {"body": "sale"}}),
    # tests/test_aggs_round3.py
    ("round3", {"c": {"nested": {"path": "comments"}, "aggs": {
        "avg_stars": {"avg": {"field": "comments.stars"}},
        "authors": {"terms": {"field": "comments.author"}},
        "back": {"reverse_nested": {}}}}}, None),
    ("round3", {"s": {"sampler": {"shard_size": 2}, "aggs": {
        "mx": {"max": {"field": "price"}}}}}, None),
    ("round3", {"s": {"diversified_sampler": {
        "shard_size": 3, "field": "cat", "max_docs_per_value": 1},
        "aggs": {"n": {"value_count": {"field": "price"}}}}}, None),
    ("round3", {"adj": {"adjacency_matrix": {"filters": {
        "cheap": {"range": {"price": {"lte": 20}}},
        "few": {"range": {"qty": {"lte": 2}}}}}}}, None),
    ("round3", {"r": {"rare_terms": {"field": "cat", "max_doc_count": 1}}},
     None),
    ("round3", {"h": {"auto_date_histogram": {"field": "ts",
                                              "buckets": 3}}}, None),
    ("round3", {"g": {"geo_distance": {
        "field": "loc", "origin": {"lat": 48.85, "lon": 2.35},
        "unit": "km", "ranges": [{"to": 100}, {"from": 100, "to": 1000},
                                 {"from": 1000}]}}}, None),
    ("round3", {"gh": {"geohash_grid": {"field": "loc", "precision": 3}},
                "gt": {"geotile_grid": {"field": "loc", "precision": 6}},
                "b": {"geo_bounds": {"field": "loc"}},
                "c": {"geo_centroid": {"field": "loc"}}}, None),
    ("round3", {"s": {"string_stats": {"field": "cat",
                                       "show_distribution": True}}}, None),
    ("round3", {"b": {"boxplot": {"field": "price"}},
                "t": {"top_metrics": {"metrics": {"field": "price"},
                                      "sort": {"qty": "desc"}}}}, None),
    ("round3", {"m": {"matrix_stats": {"fields": ["price", "qty"]}}}, None),
    ("round3", {"s": {"scripted_metric": {
        "init_script": "state['total'] = 0",
        "map_script": "state['total'] = state['total'] + doc['qty'].value",
        "combine_script": "state['total']",
        "reduce_script": "total = 0\nfor s in states:\n"
                         "    total = total + s\nreturn total"}}}, None),
    ("round3", {"per_cat": {"terms": {"field": "cat"},
                            "aggs": {"p": {"sum": {"field": "price"}}}},
                "pct": {"percentiles_bucket": {"buckets_path": "per_cat>p",
                                               "percents": [50.0]}}},
     None),
    ("round3", {"h": {"date_histogram": {"field": "ts",
                                         "fixed_interval": "1h"},
                      "aggs": {"s": {"sum": {"field": "price"}},
                               "d": {"serial_diff": {"buckets_path": "s",
                                                     "lag": 1}}}}}, None),
] + [
    # the geonames-shaped set chip_smoke.py drives at full scale
    ("geonames", aggs, q) for aggs in (GEO_TERMS, GEO_HIST)
    for q in GEO_QUERIES
] + [
    ("bigsum", {"h": {"histogram": {"field": "v", "interval": 1 << 22},
                      "aggs": {"s": {"sum": {"field": "v"}},
                               "a": {"avg": {"field": "v"}}}}}, q)
    for q in (None, {"term": {"k": "k1"}})
] + [
    # Rally geonames' country_agg_uncached: a terms with a sum sub-agg (the
    # host path in both packages)
    ("geonames", {"country_population": {
        "terms": {"field": "country_code", "size": 250},
        "aggs": {"population": {"sum": {"field": "population"}}}}}, None),
]


def _ids(cases):
    seen = {}
    out = []
    for corpus, aggs, _q in cases:
        base = f"{corpus}-{'+'.join(sorted(aggs))}"
        seen[base] = seen.get(base, 0) + 1
        out.append(f"{base}-{seen[base]}")
    return out


def same_tree(a, b, path="$"):
    """Equal JSON trees; a hit's ``_score`` / ``max_score`` to RTOL."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        for k in a:
            if k in ("_score", "max_score") and a[k] is not None:
                assert b[k] == pytest.approx(a[k], rel=RTOL), path
            else:
                same_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            same_tree(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, float) and \
            np.isnan(a) and np.isnan(b):
        pass
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


@pytest.fixture
def planes():
    keep = [(p, p.enabled, p.min_segments, p.max_bytes)
            for p in (REF_PLANES, PLANES)]
    for p in (REF_PLANES, PLANES):
        p.clear()
        p.enabled, p.min_segments, p.max_bytes = True, 2, 0
    yield
    for p, en, ms, mb in keep:
        p.enabled, p.min_segments, p.max_bytes = en, ms, mb
        p.clear()


@pytest.mark.parametrize("corpus,aggs,query", BODIES, ids=_ids(BODIES))
def test_aggs_responses_match_reference(corpus, aggs, query, planes):
    ref, port = engines(corpus)
    body = {"size": 0, "aggs": aggs}
    if query is not None:
        body["query"] = query
    if corpus == "books" and "top" in json.dumps(aggs):
        body["size"] = 3
    ref_svc = RefService(ref, index_name="ix")
    port_svc = SearchService(port, index_name="ix", device="cpu")
    try:
        want = ref_svc.search(json.loads(json.dumps(body)))
    except RefIllegalArgument as e:
        with pytest.raises(IllegalArgumentError) as info:
            port_svc.search(json.loads(json.dumps(body)))
        assert str(info.value) == str(e)
        return
    got = port_svc.search(json.loads(json.dumps(body)))
    want.pop("took")
    got.pop("took")
    same_tree(want, got)


def test_device_collectors_serve_the_geonames_bodies(planes):
    """The per-segment device halves run: sub-less keyword terms through
    K20, the dem histogram with its same-field metric subs through K21,
    one call a segment; the country_agg_uncached shape takes neither."""
    _ref, port = engines("geonames")
    svc = SearchService(port, device="cpu")
    n_segs = len(port.acquire_reader().segments)

    def calls():
        return (DEVICE_PROFILE.family("aggs_ordinal_counts").calls,
                DEVICE_PROFILE.family("aggs_histogram").calls)

    c0 = calls()
    svc.search({"size": 0, "aggs": {**GEO_TERMS, **GEO_HIST}})
    c1 = calls()
    assert (c1[0] - c0[0], c1[1] - c0[1]) == (n_segs, n_segs)
    svc.search({"size": 0, "aggs": BODIES[-1][1]})
    assert calls() == c1


# ---------------------------------------------------------------------------
# the columns plane: plan_drain_aggs presets
# ---------------------------------------------------------------------------

PLANE_MAPPING = {"properties": {
    "body": {"type": "text"}, "tag": {"type": "keyword"},
    "rank": {"type": "integer"}, "price": {"type": "integer"}}}
AGGS = {
    "tags": {"terms": {"field": "tag", "size": 10}},
    "ranks": {"histogram": {"field": "rank", "interval": 7}},
    "prices": {"histogram": {"field": "price", "interval": 25},
               "aggs": {"lo": {"min": {"field": "price"}},
                        "hi": {"max": {"field": "price"}},
                        "mean": {"avg": {"field": "price"}},
                        "n": {"value_count": {"field": "price"}}}},
}
QUERIES = [{"match": {"body": "w1 w2"}}, {"match_all": {}},
           {"term": {"tag": "t1"}}]


def plane_engines(seed: int, n_docs: int = 220, cuts=(70, 140)):
    """The reference test's shard (tests/test_plane_aggs.py _engine),
    indexed into both packages."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(30)]
    ref = RefEngine(RefMappers(PLANE_MAPPING), shard_label=f"r{seed}")
    port = InternalEngine(MapperService(PLANE_MAPPING),
                          shard_label=f"p{seed}")
    for i in range(n_docs):
        doc = {"body": " ".join(rng.choice(
                   vocab, size=int(rng.integers(3, 14)))),
               "rank": int(rng.integers(0, 60))}
        if i % 11:
            doc["tag"] = f"t{int(rng.integers(0, 9))}"
        if i % 7:
            doc["price"] = int(rng.integers(-40, 400))
        ref.index(str(i), doc)
        port.index(str(i), doc)
        if i in cuts:
            ref.refresh()
            port.refresh()
    ref.refresh()
    port.refresh()
    return ref, port, rng


def member(qbody, aggs=AGGS):
    return SimpleNamespace(
        req={"index": "i", "shard": 0, "window": 10,
             "body": {"query": qbody, "aggs": aggs}},
        trace=None, error=None)


def host_partials(eng, reader, qbody, aggs=AGGS):
    agg = ShardAggregator(parse_aggs(aggs))
    query_shard(reader, eng.mappers, dsl.parse_query(qbody), size=5,
                sort=parse_sort(None), track_total_hits=10_000,
                collectors=[agg], device="cpu")
    return agg.partial()


def jeq(a, b):
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True), \
        (a, b)


def without_sums(partial):
    """A partial with every metric sub's ``sum`` dropped: the plane sums a
    bucket in one f32 chain over the whole plane, the per-segment path in
    one chain a segment merged as Python floats, and past 2^24 the two
    round apart (in the reference too)."""
    out = json.loads(json.dumps(partial))
    for b in out.get("buckets", {}).values():
        for sub in b.get("subs", {}).values():
            sub.pop("sum", None)
    return out


def drain_parity(ref, port, ref_reader, reader, queries=QUERIES, aggs=AGGS,
                 host_sums=True):
    """The port's presets equal the reference's and the port's own host
    partials (without the sums when ``host_sums`` is False), for every
    member and agg."""
    members = [member(q, aggs) for q in queries]
    got = plan_drain_aggs(SimpleNamespace(engine=port), reader, members,
                          device="cpu")
    want = ref_plan_drain_aggs(SimpleNamespace(engine=ref), ref_reader,
                               [member(q, aggs) for q in queries])
    assert set(got) == set(want) == set(range(len(members)))
    for ui, m in enumerate(members):
        host = host_partials(port, reader, m.req["body"]["query"], aggs)
        assert set(got[ui]) == set(aggs)
        for name in got[ui]:
            jeq(got[ui][name], want[ui][name])
            if host_sums:
                jeq(got[ui][name], host[name])
            else:
                jeq(without_sums(got[ui][name]), without_sums(host[name]))
    return got


@pytest.mark.parametrize("deletes", [False, True])
def test_plane_presets_match_reference_and_host(deletes, planes):
    ref, port, rng = plane_engines(41 if not deletes else 43)
    if deletes:
        for i in rng.choice(200, size=35, replace=False):
            ref.delete(str(int(i)))
            port.delete(str(int(i)))
        ref.refresh()
        port.refresh()
    q0 = PLANES.stats["plane_aggs_queries"]
    drain_parity(ref, port, ref.acquire_reader(), port.acquire_reader())
    assert PLANES.stats["plane_aggs_queries"] - q0 == \
        len(QUERIES) * len(AGGS)
    assert PLANES.stats_snapshot()["resident_bytes"]["columns"] > 0
    assert telemetry.TELEMETRY.fallbacks.get("unknown", 0) == 0


def test_plane_presets_through_the_aggregator_match_per_segment(planes):
    """A preset ShardAggregator reduces to the per-segment response:
    plane (K22 / K23) and per segment (K20 / K21) agree on keys, counts,
    mins and maxs, and sums too where no bucket passes 2^24."""
    _ref, port, _rng = plane_engines(45)
    reader = port.acquire_reader()
    members = [member(q) for q in QUERIES]
    preset = plan_drain_aggs(SimpleNamespace(engine=port), reader, members,
                             device="cpu")
    specs = parse_aggs(AGGS)
    for ui, q in enumerate(QUERIES):
        agg = ShardAggregator(specs, preset=preset[ui])
        assert agg.preset_served
        query_shard(reader, port.mappers, dsl.parse_query(q), size=0,
                    collectors=[agg], device="cpu")
        plane = reduce_aggs(specs, [agg.partial()])
        solo = SearchService(port, device="cpu").search(
            {"query": q, "size": 0, "aggs": AGGS})["aggregations"]
        jeq(plane, solo)


def test_pit_reader_refresh_during_query_parity(planes):
    ref, port, rng = plane_engines(47)
    qbody = {"match": {"body": "w1"}}
    pit, ref_pit = port.acquire_reader(), ref.acquire_reader()
    plan_drain_aggs(SimpleNamespace(engine=port), pit, [member(qbody)],
                    device="cpu")
    for i in rng.choice(200, size=40, replace=False):
        ref.delete(str(int(i)))
        port.delete(str(int(i)))
    ref.refresh()
    port.refresh()
    drain_parity(ref, port, ref.acquire_reader(), port.acquire_reader(),
                 queries=[qbody])
    drain_parity(ref, port, ref_pit, pit, queries=[qbody])


def test_occupancy_invariance_and_one_launch_per_family(planes):
    _ref, port, _rng = plane_engines(53)
    reader = port.acquire_reader()
    shard = SimpleNamespace(engine=port)
    members = [member({"match": {"body": f"w{j}"}},
                      aggs={"tags": {"terms": {"field": "tag"}},
                            "ranks": {"histogram": {"field": "rank",
                                                    "interval": 5 + j}}})
               for j in range(4)]
    plan_drain_aggs(shard, reader, members, device="cpu")

    def calls():
        return (DEVICE_PROFILE.family("aggs_ordinal_counts_plane").calls,
                DEVICE_PROFILE.family("aggs_histogram_plane").calls)

    c0 = calls()
    batch = plan_drain_aggs(shard, reader, members, device="cpu")
    c1 = calls()
    assert (c1[0] - c0[0], c1[1] - c0[1]) == (1, 1)
    for ui, m in enumerate(members):
        jeq(batch[ui], plan_drain_aggs(shard, reader, [m], device="cpu")[0])


def test_eviction_then_rebuild_and_incremental_append(planes):
    ref, port, _rng = plane_engines(59)
    first = drain_parity(ref, port, ref.acquire_reader(),
                         port.acquire_reader(), queries=[QUERIES[0]])
    ev0 = PLANES.stats["plane_evictions"]
    PLANES.evict_cold()
    assert PLANES.stats["plane_evictions"] > ev0
    second = drain_parity(ref, port, ref.acquire_reader(),
                          port.acquire_reader(), queries=[QUERIES[0]])
    jeq(first, second)
    for i in range(300, 340):
        doc = {"body": "w1 appended", "tag": "t_new", "rank": 61,
               "price": 401}
        ref.index(str(i), doc)
        port.index(str(i), doc)
    ref.refresh()
    port.refresh()
    appends0 = PLANES.stats["plane_incremental_appends"]
    drain_parity(ref, port, ref.acquire_reader(), port.acquire_reader())
    assert PLANES.stats["plane_incremental_appends"] > appends0


def test_breaker_starved_fallback_identity(planes):
    ref, port, _rng = plane_engines(61)
    reader = port.acquire_reader()
    want = drain_parity(ref, port, ref.acquire_reader(), reader)
    req = BREAKERS.breaker("request")
    old_limit = req.limit
    fb0 = PLANES.stats["plane_aggs_fallbacks"]
    typed0 = telemetry.TELEMETRY.fallbacks.get(
        "plane_aggs_breaker_refused", 0)
    try:
        req.limit = req.used + 16
        preset = plan_drain_aggs(SimpleNamespace(engine=port), reader,
                                 [member(q) for q in QUERIES], device="cpu")
    finally:
        req.limit = old_limit
    assert preset == {}
    assert PLANES.stats["plane_aggs_fallbacks"] > fb0
    assert telemetry.TELEMETRY.fallbacks.get(
        "plane_aggs_breaker_refused", 0) > typed0
    for ui, q in enumerate(QUERIES):
        host = host_partials(port, reader, q)
        for name in want[ui]:
            jeq(want[ui][name], host[name])


def test_breaker_reserves_the_histogram_kernels_scratch(planes):
    """K23's reservation covers its scratch (the chunk counts, the bucket
    offsets, the [P, N] values in bucket order) beside the mask stack and
    the outputs: a request breaker with room for all but the scratch
    refuses the launch (typed), and one with room for all of it serves."""
    from elasticsearch_tpu_torch.index.segment import next_pow2
    from elasticsearch_tpu_torch.ops.aggs import histogram_scratch_bytes
    _ref, port, _rng = plane_engines(71)
    reader = port.acquire_reader()
    shard = SimpleNamespace(engine=port)
    aggs = {"r": {"histogram": {"field": "rank", "interval": 5}}}
    assert set(plan_drain_aggs(shard, reader, [member(QUERIES[1], aggs)],
                               device="cpu")[0]) == {"r"}
    part = PLANES.get(list(reader.segments), "columns", "rank", "cpu")
    nb_pad = next_pow2(part.vmax // 5 - part.vmin // 5 + 1, minimum=8)
    outputs = 2 * part.n_docs_pad + nb_pad * 4 * 4    # P 1: stack, outputs
    scratch = histogram_scratch_bytes(part.values.shape[0], 1, nb_pad)
    assert scratch > 4 * part.values.shape[0]
    req = BREAKERS.breaker("request")
    old_limit = req.limit
    typed0 = telemetry.TELEMETRY.fallbacks.get(
        "plane_aggs_breaker_refused", 0)
    try:
        req.limit = req.used + outputs + scratch - 1
        refused = plan_drain_aggs(shard, reader, [member(QUERIES[1], aggs)],
                                  device="cpu")
        req.limit = req.used + outputs + scratch
        served = plan_drain_aggs(shard, reader, [member(QUERIES[1], aggs)],
                                 device="cpu")
    finally:
        req.limit = old_limit
    assert refused == {}
    assert telemetry.TELEMETRY.fallbacks.get(
        "plane_aggs_breaker_refused", 0) == typed0 + 1
    assert set(served[0]) == {"r"}


def test_ineligible_shapes_keep_host_path_typed(planes):
    _ref, port, _rng = plane_engines(67)
    reader = port.acquire_reader()
    shard = SimpleNamespace(engine=port)
    ineligible = [
        member(QUERIES[0], aggs={"a": {"terms": {"field": "tag"}, "aggs": {
            "m": {"avg": {"field": "rank"}}}}}),
        member(QUERIES[0], aggs={"a": {"terms": {"field": "tag",
                                                 "missing": "zz"}}}),
        member(QUERIES[0], aggs={"a": {"histogram": {
            "field": "rank", "interval": 5},
            "aggs": {"m": {"avg": {"field": "price"}}}}}),
    ]
    shape0 = telemetry.TELEMETRY.fallbacks.get(
        "plane_aggs_ineligible_shape", 0)
    assert plan_drain_aggs(shard, reader, ineligible, device="cpu") == {}
    assert telemetry.TELEMETRY.fallbacks.get(
        "plane_aggs_ineligible_shape", 0) > shape0
    m = member(QUERIES[0])
    m.req["df_overrides"] = {"body": {"w1": 3}}
    assert plan_drain_aggs(shard, reader, [m], device="cpu") == {}
    assert telemetry.TELEMETRY.fallbacks.get("unknown", 0) == 0


def test_plane_sums_past_2_24_match_reference(planes):
    """The whole plane's f32 chain a bucket (K23) against the reference's,
    where every bucket's sum passes 2^24: bitwise. Against the port's own
    per-segment partials only keys, counts, mins and maxs agree."""
    ref, port = engines("bigsum")
    aggs = BODIES[-2][1]
    got = drain_parity(ref, port, ref.acquire_reader(), port.acquire_reader(),
                       queries=[{"match_all": {}}, {"term": {"k": "k1"}}],
                       aggs=aggs, host_sums=False)
    sums = [b["subs"]["s"]["sum"] for b in got[0]["h"]["buckets"].values()]
    assert min(sums) > 2 ** 24


def test_geonames_plane_presets_match_reference(planes):
    """The geonames-shaped drain (terms on country_code, the dem histogram
    with min / max / avg) over three segments with deletes: presets equal
    the reference's, sums bitwise."""
    ref, port = engines("geonames")
    queries = [{"match_all": {}}, {"term": {"feature_class": "P"}},
               {"match": {"name": "n0 n1"}}]
    drain_parity(ref, port, ref.acquire_reader(), port.acquire_reader(),
                 queries=queries, aggs={**GEO_TERMS, **GEO_HIST})
