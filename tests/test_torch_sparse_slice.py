"""The served learned-sparse path of elasticsearch_tpu_torch against the JAX
package, end to end: the same documents -- a rank_features field holding
the reference expansion model's output for seeded texts, and a
standalone rank_feature field -- through each package's
``InternalEngine`` + ``SearchService`` (the port on ``device="cpu"``, the
kernels' plain PyTorch versions) must give the same ``_search`` and
``_count`` responses over the sparse request mix: ``text_expansion``
with ``model_text`` (each package expanding it with its own model) and
with ``tokens``, the four ``rank_feature`` functions, both inside
``bool`` with a filter, and ``track_total_hits: true``; with the planes
on and off (the per-segment route) and the quantized tier on and off; on
one segment and on several segments with deletes.

Tolerance: scores to rtol 1e-6 (the port sums a doc's contributions
exactly in fixed point and rounds once, the reference adds them in f32
one by one; see tests/test_torch_sparse.py); ids, totals and relations
exact, except that hits whose reference scores tie within the tolerance
are compared as a set. A ``model_text`` body is expanded by each
package's own model: where the two rewrites give the same tokens the
responses are held to the above; where a token weight rounds to the
other side of a 4-decimal boundary (tests/test_torch_expansion.py), a
differing weight moves a doc's score by at most the difference times the
doc's weight of that feature, and the tolerance adds that sum.

The port's own identity is bitwise: a tokens query gives the same hits
and score bits through the plane (K15), per segment (K15 per segment),
the quantized tier (K16 + K17) and the dense collector (K19 + K10).
"""

import numpy as np
import pytest

from elasticsearch_tpu.index import InternalEngine as RefEngine
from elasticsearch_tpu.mapping import MapperService as RefMappers
from elasticsearch_tpu.ml import text_expansion as ref_ml
from elasticsearch_tpu.ops.device_segment import PLANES as REF_PLANES
from elasticsearch_tpu.search import SearchService as RefService

from elasticsearch_tpu_torch.index import InternalEngine
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.ml import text_expansion as port_ml
from elasticsearch_tpu_torch.ops.device_segment import PLANES
from elasticsearch_tpu_torch.search import SearchService
from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE

RTOL = 1e-6
MAPPING = {"properties": {
    "body": {"type": "text"}, "tag": {"type": "keyword"},
    "ml": {"type": "rank_features"}, "pr": {"type": "rank_feature"}}}
WORDS = [f"w{i}" for i in range(200)]
LAYOUTS = {"one_segment": ((), ()),
           "segments_and_deletes": ((300, 620), (3, 301, 640, 777))}


def make_texts(seed: int, n: int):
    rng = np.random.default_rng(seed)
    return [" ".join(WORDS[int(i)] for i in
                     rng.integers(0, len(WORDS), int(rng.integers(3, 9))))
            for _ in range(n)]


TEXTS = make_texts(31, 900)
_ENGINES = {}
_EXPANSIONS = []


def expansions():
    """The reference default model's expansions of TEXTS (computed once):
    the documents' rank_features, identical in both engines."""
    if not _EXPANSIONS:
        _EXPANSIONS.extend(ref_ml.get_model().expand_batch(TEXTS))
    return _EXPANSIONS


def engines(layout: str):
    """(reference engine, port engine) with the same 900 documents, built
    once per layout."""
    if layout not in _ENGINES:
        refresh_at, deletes = LAYOUTS[layout]
        ref = RefEngine(RefMappers(MAPPING), shard_label="ref")
        port = InternalEngine(MapperService(MAPPING), shard_label="port")
        for i, (text, feats) in enumerate(zip(TEXTS, expansions())):
            doc = {"body": text, "tag": f"t{i % 5}", "ml": feats,
                   "pr": float(1 + (i * 7) % 23)}
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


def set_planes(enabled: bool, quantized: bool) -> None:
    for p in (REF_PLANES, PLANES):
        p.enabled, p.quantized = enabled, quantized
        p.clear()


def assert_same_response(a, b, atol: float = 0.0):
    """Totals exact; scores to rtol RTOL (plus ``atol``); ids exact outside
    tie groups of that tolerance."""
    ha, hb = a["hits"], b["hits"]
    assert ha["total"] == hb["total"]
    assert len(ha["hits"]) == len(hb["hits"])
    if ha["max_score"] is None:
        assert hb["max_score"] is None
    else:
        assert abs(hb["max_score"] - ha["max_score"]) <= \
            RTOL * abs(ha["max_score"]) + atol
    ids_a = [h["_id"] for h in ha["hits"]]
    ids_b = [h["_id"] for h in hb["hits"]]
    sa = np.array([h["_score"] for h in ha["hits"]], np.float64)
    sb = np.array([h["_score"] for h in hb["hits"]], np.float64)
    tol = RTOL * np.abs(sa) + atol
    assert (np.abs(sb - sa) <= tol).all(), (sa, sb)
    i = 0
    while i < len(sa):
        j = i + 1
        while j < len(sa) and abs(sa[j] - sa[i]) <= 2 * tol[i]:
            j += 1
        if j < len(sa):        # a tie group at the cut may continue past it
            assert set(ids_a[i:j]) == set(ids_b[i:j])
        i = j


def expansion_atol(body) -> float:
    """0 when both packages' rewrites of ``body`` give the same tokens;
    else the most the differing token weights can move a score: each
    difference times the largest weight any document holds for that
    feature."""
    got = port_ml.rewrite_body_expansions(body, "cpu")
    want = ref_ml.rewrite_body_expansions(body)
    if got == want:
        return 0.0
    top = {}
    for feats in expansions():
        for f, w in feats.items():
            top[f] = max(top.get(f, 0.0), w)

    def tokens(node, out):
        if isinstance(node, dict):
            for k, v in node.items():
                if k == "tokens":
                    out.append(v)
                else:
                    tokens(v, out)
        elif isinstance(node, list):
            for v in node:
                tokens(v, out)
        return out
    atol = 0.0
    for tg, tw in zip(tokens(got, []), tokens(want, [])):
        for f in set(tg) | set(tw):
            atol += abs(tg.get(f, 0.0) - tw.get(f, 0.0)) * top.get(f, 0.0)
    return atol


TOKENS = {"f12": 2.25, "f4097": 1.5, "f777": 0.75, "f3": 0.5, "f1": 2.0,
          "f8000": 1.0}


def te(**opts):
    return {"text_expansion": {"ml": opts}}


BODIES = {
    "model_text": {"query": te(model_text=TEXTS[7])},
    "model_text_other": {"query": te(model_text="w3 w17 w9 w150"),
                         "size": 20},
    "model_text_default_id": {"query": te(model_text=TEXTS[400],
                                          model_id=ref_ml.DEFAULT_MODEL_ID)},
    "tokens": {"query": te(tokens=TOKENS)},
    "tokens_of_a_doc": {"query": {"text_expansion": {"ml": {
        "tokens": None}}}, "size": 15},
    "tokens_boost_paged": {"query": te(tokens=TOKENS, boost=2.0),
                           "from": 5, "size": 10},
    "exact_totals": {"query": te(model_text=TEXTS[11]),
                     "track_total_hits": True},
    "totals_limit": {"query": te(tokens=TOKENS), "track_total_hits": 5},
    "saturation": {"query": {"rank_feature": {
        "field": "ml.f12", "saturation": {"pivot": 0.5}}}},
    "log": {"query": {"rank_feature": {
        "field": "pr", "log": {"scaling_factor": 2.0}}}},
    "sigmoid": {"query": {"rank_feature": {
        "field": "pr", "sigmoid": {"pivot": 7.0, "exponent": 0.6}}}},
    "linear": {"query": {"rank_feature": {"field": "ml.f1", "linear": {},
                                          "boost": 3.0}}},
    "bool_filter": {"query": {"bool": {
        "must": [te(model_text=TEXTS[3])],
        "filter": [{"term": {"tag": "t2"}}]}}, "track_total_hits": True},
    "bool_should_rank_feature": {"query": {"bool": {
        "must": [te(tokens=TOKENS)],
        "should": [{"rank_feature": {"field": "pr",
                                     "saturation": {"pivot": 8.0}}}],
        "must_not": [{"term": {"tag": "t4"}}]}}},
}


def body_of(name: str):
    body = BODIES[name]
    if name == "tokens_of_a_doc":
        return {**body, "query": te(tokens=expansions()[42])}
    return body


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("plane", [True, False])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("name", sorted(BODIES))
def test_sparse_responses_match_reference(name, layout, plane, quantized,
                                          planes):
    set_planes(plane, quantized)
    ref, port = engines(layout)
    body = {**body_of(name), "_source": False}
    want = RefService(ref).search(dict(body))
    got = SearchService(port, device="cpu").search(dict(body))
    assert_same_response(want, got, expansion_atol(body))


@pytest.mark.parametrize("name", ["tokens", "model_text", "saturation",
                                  "bool_filter"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_count_matches_reference(name, layout, planes):
    ref, port = engines(layout)
    query = {"query": body_of(name)["query"]}
    want = RefService(ref).count(query)
    got = SearchService(port, device="cpu").count(query)
    assert got == want


@pytest.mark.parametrize("name", ["tokens", "tokens_of_a_doc", "model_text"])
def test_plane_segment_tier_and_dense_are_bitwise_equal(name, planes):
    """One tokens query through the four routes of the port: the plane's
    exact launch (K15), per segment (K15 per segment), the quantized tier
    (K16 + K17) and the dense collector (track_total_hits true: K19 +
    K10) -- the same hits, totals and score bits, and each route launched
    what it should (calls on the CPU)."""
    _ref, port = engines("segments_and_deletes")
    svc = SearchService(port, device="cpu")
    body = {**body_of(name), "_source": False}
    answers = {}
    routes = {"plane": (True, False, None), "segments": (False, False, None),
              "tier": (True, True, None), "dense": (True, False, True)}
    for route, (enabled, quantized, track) in routes.items():
        set_planes(enabled, quantized)
        before = DEVICE_PROFILE.snapshot()["families"]
        b = dict(body)
        if track is not None:
            b["track_total_hits"] = track
        res = svc.search(b)
        after = DEVICE_PROFILE.snapshot()["families"]
        calls = {f: after[f]["calls"] - before.get(f, {}).get("calls", 0)
                 for f in after}
        answers[route] = (
            [(h["_id"], h["_score"]) for h in res["hits"]["hits"]],
            res["hits"]["max_score"], res["hits"]["total"]["value"])
        if route == "tier":
            assert calls.get("sparse_coarse", 0) > 0
            assert calls.get("sparse_rerank", 0) > 0
        elif route == "dense":
            assert calls.get("sparse_scores", 0) > 0
            assert calls.get("dense_topk", 0) > 0
            assert calls.get("sparse_flat", 0) == 0
        else:
            assert calls.get("sparse_flat", 0) > 0
            assert calls.get("sparse_coarse", 0) == 0
    first = answers["plane"]
    assert first[0], "the query matched nothing"
    for route, got in answers.items():
        assert got[0] == first[0], route
        assert got[1] == first[1], route
    # exact totals are the same count the top-k routes read off the plane
    assert {a[2] for a in answers.values()} == {first[2]}


def test_text_expansion_inside_bool_runs_the_model_per_query(planes):
    """A model_text left inside a compound query (a _count is not
    rewritten) is expanded by the dense handler with the port's model:
    one forward call, and the same count as the rewritten search."""
    _ref, port = engines("one_segment")
    svc = SearchService(port, device="cpu")
    q = {"bool": {"must": [te(model_text="w5 w6 w7 w8 w9 w10")]}}
    before = DEVICE_PROFILE.family("text_expansion_forward").calls
    count = svc.count({"query": q})["count"]
    assert DEVICE_PROFILE.family("text_expansion_forward").calls == \
        before + 1
    res = svc.search({"query": q, "track_total_hits": True, "size": 0})
    assert res["hits"]["total"] == {"value": count, "relation": "eq"}


def test_sparse_window_above_the_kernels_top_k_raises_not_ported(planes):
    """(The name predates the wide selection, which this test once proved
    refused.) A sparse top-k window above the kernels' 4,096-entry
    selection is served as the JAX package serves it."""
    ref, port = engines("one_segment")
    body = {"query": te(tokens=TOKENS), "size": 5000}
    assert_same_response(RefService(ref).search(dict(body)),
                         SearchService(port, device="cpu").search(dict(body)))


def test_converted_segments_serve_the_same_sparse_answers(planes):
    """``convert.segments_from_reference`` carries each segment's
    rank_features fields: a shard read from the reference engine's
    segments gives the port engine's hits and score bits."""
    from elasticsearch_tpu_torch.convert import segments_from_reference
    from elasticsearch_tpu_torch.index.engine import Reader
    from elasticsearch_tpu_torch.search import dsl
    from elasticsearch_tpu_torch.search.phase import query_shard
    ref, port = engines("segments_and_deletes")
    segs = segments_from_reference(ref.acquire_reader().segments)
    for seg, mine in zip(segs, port.acquire_reader().segments):
        a, b = seg.features["ml"], mine.features["ml"]
        assert a.features == b.features
        np.testing.assert_array_equal(a.block_docs, b.block_docs)
        np.testing.assert_array_equal(a.block_weights, b.block_weights)
    for body in (te(tokens=TOKENS), te(tokens=expansions()[42]),
                 {"rank_feature": {"field": "pr", "log": {}}}):
        got, want = (query_shard(reader, port.mappers, dsl.parse_query(body),
                                 size=10, device="cpu")
                     for reader in (Reader(segs), port.acquire_reader()))
        assert [(d.segment_idx, d.doc, d.score) for d in got.docs] == \
            [(d.segment_idx, d.doc, d.score) for d in want.docs]
        assert got.total_hits == want.total_hits
