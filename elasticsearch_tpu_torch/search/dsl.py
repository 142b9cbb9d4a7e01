"""Query DSL: JSON -> typed query tree.

Mirrors the role of the reference's 48 QueryBuilders (index/query/*.java,
registered in SearchModule.java:265) — each DSL object parses into a typed
node that the executor compiles to device score/mask programs. The set here
covers the core retrieval surface plus the BASELINE capabilities (knn,
text_expansion, rank_feature) the reference snapshot lacks.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from elasticsearch_tpu_torch.utils.errors import QueryParsingError


class Query:
    """Base query node."""
    boost: float = 1.0


@dataclass
class MatchAll(Query):
    boost: float = 1.0


@dataclass
class MatchNone(Query):
    boost: float = 1.0


@dataclass
class Match(Query):
    field: str
    text: str
    operator: str = "or"            # or | and
    minimum_should_match: Optional[int] = None
    boost: float = 1.0


@dataclass
class MatchPhrase(Query):
    field: str
    text: str
    slop: int = 0
    boost: float = 1.0


@dataclass
class MultiMatch(Query):
    fields: List[str]
    text: str
    type: str = "best_fields"       # best_fields | most_fields
    operator: str = "or"
    boost: float = 1.0


@dataclass
class Term(Query):
    field: str
    value: Any
    boost: float = 1.0


@dataclass
class Terms(Query):
    field: str
    values: List[Any]
    boost: float = 1.0


@dataclass
class Range(Query):
    field: str
    gt: Optional[Any] = None
    gte: Optional[Any] = None
    lt: Optional[Any] = None
    lte: Optional[Any] = None
    # interval relation against RANGE fields (RangeFieldMapper):
    # intersects (default) | within | contains
    relation: str = "intersects"
    boost: float = 1.0


@dataclass
class Exists(Query):
    field: str
    boost: float = 1.0


@dataclass
class Ids(Query):
    values: List[str]
    boost: float = 1.0


@dataclass
class Prefix(Query):
    field: str
    value: str
    boost: float = 1.0


@dataclass
class Wildcard(Query):
    field: str
    value: str
    boost: float = 1.0


@dataclass
class Regexp(Query):
    field: str
    value: str
    boost: float = 1.0


@dataclass
class Fuzzy(Query):
    field: str
    value: str
    fuzziness: Any = "AUTO"
    boost: float = 1.0


@dataclass
class Bool(Query):
    must: List[Query] = field(default_factory=list)
    should: List[Query] = field(default_factory=list)
    must_not: List[Query] = field(default_factory=list)
    filter: List[Query] = field(default_factory=list)
    minimum_should_match: Optional[int] = None
    boost: float = 1.0


@dataclass
class ConstantScore(Query):
    filter: Query = None
    boost: float = 1.0


@dataclass
class DisMax(Query):
    queries: List[Query] = field(default_factory=list)
    tie_breaker: float = 0.0
    boost: float = 1.0


@dataclass
class Boosting(Query):
    positive: Query = None
    negative: Query = None
    negative_boost: float = 0.5
    boost: float = 1.0


@dataclass
class Knn(Query):
    field: str
    query_vector: List[float]
    k: int = 10
    num_candidates: int = 100
    filter: Optional[Query] = None
    boost: float = 1.0


@dataclass
class RankFeature(Query):
    field: str
    function: str = "saturation"     # saturation | log | sigmoid | linear
    pivot: float = 1.0
    exponent: float = 1.0
    scaling_factor: float = 1.0
    boost: float = 1.0


@dataclass
class TextExpansion(Query):
    """Learned-sparse query over a rank_features field (ELSER analog).

    Either ``tokens`` carries precomputed inference output, or
    ``model_text`` triggers on-device expansion through the registered
    model at query time (TextExpansionQueryBuilder's inference rewrite,
    re-done as a local jitted program — ml/text_expansion.py)."""
    field: str
    tokens: Optional[Dict[str, float]] = None
    model_id: Optional[str] = None
    model_text: Optional[str] = None
    boost: float = 1.0


@dataclass
class ScriptScore(Query):
    """script_score with the reference's vector-function surface
    (cosineSimilarity / dotProduct / l2norm — ScoreScriptUtils.java:132,151)."""
    query: Query = None
    source: str = ""
    params: Dict[str, Any] = field(default_factory=dict)
    boost: float = 1.0


@dataclass
class FunctionScore(Query):
    query: Query = None
    functions: List[Dict[str, Any]] = field(default_factory=list)
    boost_mode: str = "multiply"
    score_mode: str = "sum"
    boost: float = 1.0


@dataclass
class HasChild(Query):
    """Parents with at least one matching child
    (modules/parent-join HasChildQueryBuilder analog)."""
    child_type: str = ""
    query: Query = None
    min_children: int = 1
    boost: float = 1.0


@dataclass
class HasParent(Query):
    """Children whose parent matches
    (modules/parent-join HasParentQueryBuilder analog)."""
    parent_type: str = ""
    query: Query = None
    boost: float = 1.0


@dataclass
class ParentId(Query):
    """Children of one specific parent (ParentIdQueryBuilder analog)."""
    child_type: str = ""
    id: str = ""
    boost: float = 1.0


@dataclass
class MatchPhrasePrefix(Query):
    """Phrase with the LAST term as a prefix (search-as-you-type;
    index/query/MatchPhrasePrefixQueryBuilder analog)."""
    field: str = ""
    text: str = ""
    max_expansions: int = 50
    boost: float = 1.0


@dataclass
class MoreLikeThis(Query):
    """Find docs similar to free text: top tf-idf terms become a should
    query (index/query/MoreLikeThisQueryBuilder analog)."""
    fields: List[str] = field(default_factory=list)
    like: List[str] = field(default_factory=list)
    max_query_terms: int = 25
    min_term_freq: int = 2      # MoreLikeThisQueryBuilder defaults
    min_doc_freq: int = 5
    boost: float = 1.0


@dataclass
class GeoDistance(Query):
    """Docs whose geo_point lies within ``distance`` meters of a center
    (index/query/GeoDistanceQueryBuilder analog)."""
    field: str = ""
    lat: float = 0.0
    lon: float = 0.0
    distance_m: float = 0.0
    boost: float = 1.0


@dataclass
class GeoBoundingBox(Query):
    """Docs whose geo_point lies inside the box
    (index/query/GeoBoundingBoxQueryBuilder analog)."""
    field: str = ""
    top: float = 0.0
    left: float = 0.0
    bottom: float = 0.0
    right: float = 0.0
    boost: float = 1.0


_DISTANCE_UNITS = (   # longest suffix first so 'nmi' wins over 'mi'/'m'
    ("nmi", 1852.0), ("km", 1000.0), ("cm", 0.01), ("mm", 0.001),
    ("mi", 1609.344), ("yd", 0.9144), ("ft", 0.3048), ("in", 0.0254),
    ("nm", 1852.0), ("m", 1.0),
)


def parse_distance_m(raw: Any) -> float:
    """ES distance expression -> meters ('10km', '3mi', '500ft', number)."""
    if isinstance(raw, (int, float)):
        return float(raw)
    s = str(raw).strip().lower()
    try:
        for suffix, mult in _DISTANCE_UNITS:
            if s.endswith(suffix):
                return float(s[: -len(suffix)]) * mult
        return float(s)
    except (TypeError, ValueError):
        raise QueryParsingError(f"failed to parse distance [{raw!r}]")


def _parse_geo_point(spec: Any) -> Tuple[float, float]:
    if isinstance(spec, dict):
        return float(spec["lat"]), float(spec["lon"])
    if isinstance(spec, (list, tuple)) and len(spec) == 2:
        return float(spec[1]), float(spec[0])     # [lon, lat] GeoJSON order
    if isinstance(spec, str):
        lat, _, lon = spec.partition(",")
        return float(lat), float(lon)
    raise QueryParsingError(f"cannot parse geo point [{spec!r}]")


def _parse_geo_distance(spec: Dict[str, Any]) -> GeoDistance:
    opts = {k: v for k, v in spec.items()
            if k not in ("distance", "boost", "distance_type",
                         "validation_method")}
    if len(opts) != 1 or "distance" not in spec:
        raise QueryParsingError(
            "geo_distance requires [distance] and exactly one field")
    (fname, point), = opts.items()
    try:
        lat, lon = _parse_geo_point(point)
    except (KeyError, TypeError, ValueError) as e:
        raise QueryParsingError(
            f"failed to parse geo point for [{fname}]: {e}")
    return GeoDistance(field=fname, lat=lat, lon=lon,
                       distance_m=parse_distance_m(spec["distance"]),
                       boost=float(spec.get("boost", 1.0)))


def _parse_geo_bounding_box(spec: Dict[str, Any]) -> GeoBoundingBox:
    opts = {k: v for k, v in spec.items()
            if k not in ("boost", "validation_method", "type")}
    if len(opts) != 1:
        raise QueryParsingError(
            "geo_bounding_box requires exactly one field")
    (fname, box), = opts.items()
    try:
        if "top_left" in box and "bottom_right" in box:
            top, left = _parse_geo_point(box["top_left"])
            bottom, right = _parse_geo_point(box["bottom_right"])
        elif "top_right" in box and "bottom_left" in box:
            top, right = _parse_geo_point(box["top_right"])
            bottom, left = _parse_geo_point(box["bottom_left"])
        elif {"top", "left", "bottom", "right"} <= set(box):
            top, left = float(box["top"]), float(box["left"])
            bottom, right = float(box["bottom"]), float(box["right"])
        else:
            raise QueryParsingError(
                "geo_bounding_box requires corner points "
                "(top_left/bottom_right, top_right/bottom_left, or "
                "top/left/bottom/right)")
    except (KeyError, TypeError, ValueError) as e:
        raise QueryParsingError(
            f"failed to parse geo_bounding_box [{fname}]: {e}")
    return GeoBoundingBox(field=fname, top=top, left=left, bottom=bottom,
                          right=right,
                          boost=float(spec.get("boost", 1.0)))


def _parse_match_phrase_prefix(spec: Dict[str, Any]) -> MatchPhrasePrefix:
    fname, opts = _field_spec(spec, "query")
    return MatchPhrasePrefix(
        field=fname, text=str(opts.get("query", "")),
        max_expansions=int(opts.get("max_expansions", 50)),
        boost=float(opts.get("boost", 1.0)))


def _parse_more_like_this(spec: Dict[str, Any]) -> MoreLikeThis:
    like = spec.get("like")
    if like is None:
        raise QueryParsingError("more_like_this requires [like]")
    likes = like if isinstance(like, list) else [like]
    texts = [x for x in likes if isinstance(x, str)]
    if len(texts) != len(likes):
        # silently narrowing {"_index","_id"} doc references to only the
        # text likes would return different hits with no signal
        raise QueryParsingError(
            "more_like_this supports free-text [like] values only; "
            "document references are not supported")
    if not texts:
        raise QueryParsingError(
            "more_like_this requires at least one [like] text")
    return MoreLikeThis(
        fields=list(spec.get("fields", [])),
        like=texts,
        max_query_terms=int(spec.get("max_query_terms", 25)),
        min_term_freq=int(spec.get("min_term_freq", 2)),
        min_doc_freq=int(spec.get("min_doc_freq", 5)),
        boost=float(spec.get("boost", 1.0)))


@dataclass
class Percolate(Query):
    """Reverse search: which stored queries match this document
    (modules/percolator PercolateQueryBuilder analog)."""
    # NOTE: ``documents`` must precede ``field`` — the attribute named
    # "field" shadows dataclasses.field for the rest of the class body
    documents: List[Dict[str, Any]] = field(default_factory=list)
    field: str = "query"
    boost: float = 1.0


@dataclass
class Nested(Query):
    path: str = ""
    query: Query = None
    score_mode: str = "avg"
    # inner_hits spec ({} = defaults): the fetch phase returns the matching
    # nested objects per hit (InnerHitsPhase analog)
    inner_hits: Optional[Dict[str, Any]] = None
    boost: float = 1.0


# ---------------------------------------------------------------------------
# span family (index/query/Span*QueryBuilder analogs) — position-based
# matching evaluated by search/spans.py
# ---------------------------------------------------------------------------

class SpanQuery(Query):
    """Base for span nodes; every span node names exactly one field."""


@dataclass
class SpanTerm(SpanQuery):
    field: str = ""
    value: str = ""
    boost: float = 1.0


@dataclass
class SpanNear(SpanQuery):
    clauses: List[SpanQuery] = field(default_factory=list)
    slop: int = 0
    in_order: bool = True
    boost: float = 1.0


@dataclass
class SpanOr(SpanQuery):
    clauses: List[SpanQuery] = field(default_factory=list)
    boost: float = 1.0


@dataclass
class SpanNot(SpanQuery):
    include: SpanQuery = None
    exclude: SpanQuery = None
    pre: int = 0
    post: int = 0
    boost: float = 1.0


@dataclass
class SpanFirst(SpanQuery):
    match: SpanQuery = None
    end: int = 0
    boost: float = 1.0


@dataclass
class SpanContaining(SpanQuery):
    big: SpanQuery = None
    little: SpanQuery = None
    boost: float = 1.0


@dataclass
class SpanWithin(SpanQuery):
    big: SpanQuery = None
    little: SpanQuery = None
    boost: float = 1.0


@dataclass
class SpanMulti(SpanQuery):
    """Wraps a multi-term query (prefix/wildcard/regexp/fuzzy) as spans
    (SpanMultiTermQueryWrapper analog)."""
    match: Query = None
    boost: float = 1.0


@dataclass
class Intervals(Query):
    """Minimal-interval matching (index/query/IntervalQueryBuilder analog).
    ``rule`` is the raw source tree (match/any_of/all_of/prefix/wildcard
    with max_gaps/ordered/filter), interpreted by search/spans.py."""
    # NOTE: rule must precede the attribute named "field" (it shadows
    # dataclasses.field for the rest of the class body)
    rule: Dict[str, Any] = field(default_factory=dict)
    field: str = ""
    boost: float = 1.0


@dataclass
class QueryString(Query):
    """Lucene-syntax query string (QueryStringQueryBuilder analog). Parsed
    into a Query tree at rewrite time by search/querystring.py."""
    query: str = ""
    default_field: Optional[str] = None
    fields: List[str] = field(default_factory=list)
    default_operator: str = "or"
    boost: float = 1.0


@dataclass
class SimpleQueryString(Query):
    """Fault-tolerant simplified syntax (SimpleQueryStringBuilder analog)."""
    query: str = ""
    fields: List[str] = field(default_factory=list)
    default_operator: str = "or"
    boost: float = 1.0


@dataclass
class TermsSet(Query):
    """Docs matching >= N of the terms, N read per-doc from
    minimum_should_match_field or computed by a script
    (TermsSetQueryBuilder analog)."""
    # terms must precede the "field" attribute (dataclasses.field shadow)
    terms: List[Any] = field(default_factory=list)
    field: str = ""
    minimum_should_match_field: Optional[str] = None
    minimum_should_match_script: Optional[str] = None
    boost: float = 1.0


@dataclass
class DistanceFeature(Query):
    """Score decays with distance from an origin on a date or geo_point
    field: boost * pivot / (pivot + distance)
    (DistanceFeatureQueryBuilder analog)."""
    field: str = ""
    origin: Any = None
    pivot: Any = None
    boost: float = 1.0


@dataclass
class Pinned(Query):
    """Promoted ids rank first, organic results after
    (x-pack search-business-rules PinnedQueryBuilder analog)."""
    ids: List[str] = field(default_factory=list)
    organic: Query = None
    boost: float = 1.0


@dataclass
class ScriptQuery(Query):
    """Filter context scripted per document over doc values
    (index/query/ScriptQueryBuilder analog)."""
    source: str = ""
    params: Dict[str, Any] = field(default_factory=dict)
    boost: float = 1.0


@dataclass
class GeoShape(Query):
    """Docs whose geo_shape relates to the query geometry
    (GeoShapeQueryBuilder analog)."""
    # shape must precede the "field" attribute (dataclasses.field shadow)
    shape: Dict[str, Any] = field(default_factory=dict)
    field: str = ""
    relation: str = "intersects"
    boost: float = 1.0


@dataclass
class GeoPolygon(Query):
    """Docs whose geo_point lies inside the closed polygon
    (GeoPolygonQueryBuilder analog)."""
    # points must precede the "field" attribute (dataclasses.field shadow)
    points: List[Tuple[float, float]] = field(default_factory=list)  # (lat, lon)
    field: str = ""
    boost: float = 1.0


def parse_query(body: Any) -> Query:
    """Parse the object under "query" into a Query tree."""
    if body is None:
        return MatchAll()
    if not isinstance(body, dict) or len(body) != 1:
        raise QueryParsingError(
            f"query must be an object with exactly one key, got {body!r}")
    (kind, spec), = body.items()
    parser = _PARSERS.get(kind)
    if parser is None:
        raise QueryParsingError(f"unknown query type [{kind}]")
    if isinstance(spec, dict) and "_name" in spec:
        # clause-level _name (named queries) is metadata for the fetch
        # phase's matched_queries, never part of the clause body — strip
        # it HERE so single-field parsers don't count it as a field
        spec = {k: v for k, v in spec.items() if k != "_name"}
    return parser(spec)


def _field_spec(spec: Dict[str, Any], value_key: str) -> tuple:
    """Unpack {"field": <value-or-options>} into (field, options-dict)."""
    if not isinstance(spec, dict) or len(spec) != 1:
        raise QueryParsingError(f"expected single-field object, got {spec!r}")
    (fname, opts), = spec.items()
    if not isinstance(opts, dict):
        opts = {value_key: opts}
    return fname, opts


def _parse_match(spec):
    fname, opts = _field_spec(spec, "query")
    return Match(field=fname, text=str(opts.get("query", "")),
                 operator=str(opts.get("operator", "or")).lower(),
                 minimum_should_match=opts.get("minimum_should_match"),
                 boost=float(opts.get("boost", 1.0)))


def _parse_match_phrase(spec):
    fname, opts = _field_spec(spec, "query")
    return MatchPhrase(field=fname, text=str(opts.get("query", "")),
                       slop=int(opts.get("slop", 0)),
                       boost=float(opts.get("boost", 1.0)))


def _parse_multi_match(spec):
    if "fields" not in spec:
        raise QueryParsingError("multi_match requires [fields]")
    return MultiMatch(fields=list(spec["fields"]), text=str(spec.get("query", "")),
                      type=spec.get("type", "best_fields"),
                      operator=str(spec.get("operator", "or")).lower(),
                      boost=float(spec.get("boost", 1.0)))


def _parse_term(spec):
    fname, opts = _field_spec(spec, "value")
    return Term(field=fname, value=opts.get("value"),
                boost=float(opts.get("boost", 1.0)))


def _parse_terms(spec):
    spec = dict(spec)
    boost = float(spec.pop("boost", 1.0))
    if len(spec) != 1:
        raise QueryParsingError("terms query requires exactly one field")
    (fname, values), = spec.items()
    if not isinstance(values, list):
        raise QueryParsingError("terms query values must be an array")
    return Terms(field=fname, values=values, boost=boost)


def _parse_range(spec):
    fname, opts = _field_spec(spec, "gte")
    relation = str(opts.get("relation", "intersects")).lower()
    if relation not in ("intersects", "within", "contains"):
        raise QueryParsingError(
            f"unknown range relation [{relation}]")
    return Range(field=fname, gt=opts.get("gt"), gte=opts.get("gte"),
                 lt=opts.get("lt"), lte=opts.get("lte"),
                 relation=relation,
                 boost=float(opts.get("boost", 1.0)))


def _parse_bool(spec):
    def clause(name):
        v = spec.get(name, [])
        if isinstance(v, dict):
            v = [v]
        return [parse_query(q) for q in v]
    return Bool(must=clause("must"), should=clause("should"),
                must_not=clause("must_not"), filter=clause("filter"),
                minimum_should_match=spec.get("minimum_should_match"),
                boost=float(spec.get("boost", 1.0)))


def _parse_knn(spec):
    return Knn(field=spec["field"], query_vector=list(spec["query_vector"]),
               k=int(spec.get("k", 10)),
               num_candidates=int(spec.get("num_candidates", 100)),
               filter=parse_query(spec["filter"]) if spec.get("filter") else None,
               boost=float(spec.get("boost", 1.0)))


def _parse_rank_feature(spec):
    fname = spec.get("field")
    if fname is None:
        raise QueryParsingError("rank_feature requires [field]")
    function, pivot, exponent, scaling = "saturation", 1.0, 1.0, 1.0
    if "saturation" in spec:
        function = "saturation"
        pivot = float((spec["saturation"] or {}).get("pivot", 1.0))
    elif "log" in spec:
        function = "log"
        scaling = float((spec["log"] or {}).get("scaling_factor", 1.0))
    elif "sigmoid" in spec:
        function = "sigmoid"
        sig = spec["sigmoid"] or {}
        pivot = float(sig.get("pivot", 1.0))
        exponent = float(sig.get("exponent", 1.0))
    elif "linear" in spec:
        function = "linear"
    return RankFeature(field=fname, function=function, pivot=pivot,
                       exponent=exponent, scaling_factor=scaling,
                       boost=float(spec.get("boost", 1.0)))


def _parse_text_expansion(spec):
    fname, opts = _field_spec(spec, "model_text")
    tokens = opts.get("tokens")
    model_text = opts.get("model_text")
    if tokens is None and model_text is None:
        raise QueryParsingError(
            "text_expansion requires [tokens] (precomputed inference "
            "output) or [model_text] (on-device expansion)")
    return TextExpansion(
        field=fname,
        tokens=({str(k): float(v) for k, v in tokens.items()}
                if tokens is not None else None),
        model_id=opts.get("model_id"),
        model_text=model_text,
        boost=float(opts.get("boost", 1.0)))


def _parse_script_score(spec):
    script = spec.get("script", {})
    return ScriptScore(query=parse_query(spec.get("query")),
                       source=script.get("source", ""),
                       params=script.get("params", {}),
                       boost=float(spec.get("boost", 1.0)))


def _parse_function_score(spec):
    return FunctionScore(query=parse_query(spec.get("query")),
                         functions=list(spec.get("functions", [])),
                         boost_mode=spec.get("boost_mode", "multiply"),
                         score_mode=spec.get("score_mode", "sum"),
                         boost=float(spec.get("boost", 1.0)))


_PARSERS = {
    "match_all": lambda spec: MatchAll(boost=float((spec or {}).get("boost", 1.0))),
    "match_none": lambda spec: MatchNone(),
    "match": _parse_match,
    "match_phrase": _parse_match_phrase,
    "match_phrase_prefix": _parse_match_phrase_prefix,
    "more_like_this": _parse_more_like_this,
    "geo_distance": _parse_geo_distance,
    "geo_bounding_box": _parse_geo_bounding_box,
    "multi_match": _parse_multi_match,
    "term": _parse_term,
    "terms": _parse_terms,
    "range": _parse_range,
    "exists": lambda spec: Exists(field=spec["field"],
                                  boost=float(spec.get("boost", 1.0))),
    "ids": lambda spec: Ids(values=[str(v) for v in spec.get("values", [])]),
    "prefix": lambda spec: Prefix(*_field_value(spec, "value")),
    "wildcard": lambda spec: Wildcard(*_field_value(spec, "value")),
    "regexp": lambda spec: Regexp(*_field_value(spec, "value")),
    "fuzzy": lambda spec: _parse_fuzzy(spec),
    "bool": _parse_bool,
    "constant_score": lambda spec: ConstantScore(
        filter=parse_query(spec.get("filter")), boost=float(spec.get("boost", 1.0))),
    "dis_max": lambda spec: DisMax(
        queries=[parse_query(q) for q in spec.get("queries", [])],
        tie_breaker=float(spec.get("tie_breaker", 0.0)),
        boost=float(spec.get("boost", 1.0))),
    "boosting": lambda spec: Boosting(
        positive=parse_query(spec.get("positive")),
        negative=parse_query(spec.get("negative")),
        negative_boost=float(spec.get("negative_boost", 0.5)),
        boost=float(spec.get("boost", 1.0))),
    "knn": _parse_knn,
    "has_child": lambda spec: HasChild(
        child_type=spec["type"], query=parse_query(spec.get("query")),
        min_children=int(spec.get("min_children", 1)),
        boost=float(spec.get("boost", 1.0))),
    "has_parent": lambda spec: HasParent(
        parent_type=spec["parent_type"],
        query=parse_query(spec.get("query")),
        boost=float(spec.get("boost", 1.0))),
    "parent_id": lambda spec: ParentId(
        child_type=spec["type"], id=str(spec["id"]),
        boost=float(spec.get("boost", 1.0))),
    "percolate": lambda spec: Percolate(
        field=spec.get("field", "query"),
        documents=(spec.get("documents")
                   or ([spec["document"]] if "document" in spec else [])),
        boost=float(spec.get("boost", 1.0))),
    "nested": lambda spec: Nested(
        path=spec["path"], query=parse_query(spec.get("query")),
        score_mode=spec.get("score_mode", "avg"),
        inner_hits=spec.get("inner_hits"),
        boost=float(spec.get("boost", 1.0))),
    "rank_feature": _parse_rank_feature,
    "text_expansion": _parse_text_expansion,
    "script_score": _parse_script_score,
    "function_score": _parse_function_score,
    "span_term": lambda spec: _parse_span_term(spec),
    "span_near": lambda spec: SpanNear(
        clauses=[_parse_span(c) for c in spec.get("clauses", [])],
        slop=int(spec.get("slop", 0)),
        in_order=bool(spec.get("in_order", True)),
        boost=float(spec.get("boost", 1.0))),
    "span_or": lambda spec: SpanOr(
        clauses=[_parse_span(c) for c in spec.get("clauses", [])],
        boost=float(spec.get("boost", 1.0))),
    "span_not": lambda spec: SpanNot(
        include=_parse_span(spec["include"]),
        exclude=_parse_span(spec["exclude"]),
        pre=int(spec.get("pre", spec.get("dist", 0))),
        post=int(spec.get("post", spec.get("dist", 0))),
        boost=float(spec.get("boost", 1.0))),
    "span_first": lambda spec: SpanFirst(
        match=_parse_span(spec["match"]),
        end=int(spec.get("end", 0)),
        boost=float(spec.get("boost", 1.0))),
    "span_containing": lambda spec: SpanContaining(
        big=_parse_span(spec["big"]), little=_parse_span(spec["little"]),
        boost=float(spec.get("boost", 1.0))),
    "span_within": lambda spec: SpanWithin(
        big=_parse_span(spec["big"]), little=_parse_span(spec["little"]),
        boost=float(spec.get("boost", 1.0))),
    "span_multi": lambda spec: SpanMulti(
        match=parse_query(spec["match"]),
        boost=float(spec.get("boost", 1.0))),
    "intervals": lambda spec: _parse_intervals(spec),
    "query_string": lambda spec: QueryString(
        query=str(spec.get("query", "")),
        default_field=spec.get("default_field"),
        fields=list(spec.get("fields", [])),
        default_operator=str(spec.get("default_operator", "or")).lower(),
        boost=float(spec.get("boost", 1.0))),
    "simple_query_string": lambda spec: SimpleQueryString(
        query=str(spec.get("query", "")),
        fields=list(spec.get("fields", [])),
        default_operator=str(spec.get("default_operator", "or")).lower(),
        boost=float(spec.get("boost", 1.0))),
    "terms_set": lambda spec: _parse_terms_set(spec),
    "distance_feature": lambda spec: DistanceFeature(
        field=spec["field"], origin=spec.get("origin"),
        pivot=spec.get("pivot"),
        boost=float(spec.get("boost", 1.0))),
    "pinned": lambda spec: Pinned(
        ids=[str(i) for i in spec.get("ids", [])],
        organic=parse_query(spec.get("organic")),
        boost=float(spec.get("boost", 1.0))),
    "script": lambda spec: ScriptQuery(
        source=(spec.get("script") or {}).get("source", "")
        if isinstance(spec.get("script"), dict) else str(spec.get("script", "")),
        params=((spec.get("script") or {}).get("params", {})
                if isinstance(spec.get("script"), dict) else {}),
        boost=float(spec.get("boost", 1.0))),
    "wrapper": lambda spec: _parse_wrapper(spec),
    "geo_polygon": lambda spec: _parse_geo_polygon(spec),
    "geo_shape": lambda spec: _parse_geo_shape(spec),
    # match_bool_prefix: every term matches normally, the last as a
    # prefix (MatchBoolPrefixQueryBuilder) — the single-field form of
    # multi_match type bool_prefix
    "match_bool_prefix": lambda spec: _parse_match_bool_prefix(spec),
}


def _parse_match_bool_prefix(spec) -> MultiMatch:
    fname, opts = _field_spec(spec, "query")
    return MultiMatch(fields=[fname], text=str(opts.get("query", "")),
                      type="bool_prefix",
                      operator=str(opts.get("operator", "or")).lower(),
                      boost=float(opts.get("boost", 1.0)))


def _parse_geo_shape(spec) -> GeoShape:
    opts = {k: v for k, v in spec.items()
            if k not in ("boost", "ignore_unmapped")}
    if len(opts) != 1:
        raise QueryParsingError("geo_shape requires exactly one field")
    (fname, body), = opts.items()
    if not isinstance(body, dict) or "shape" not in body:
        raise QueryParsingError("geo_shape requires [shape]")
    relation = str(body.get("relation", "intersects")).lower()
    if relation not in ("intersects", "disjoint", "within", "contains"):
        raise QueryParsingError(
            f"unknown geo_shape relation [{relation}]")
    return GeoShape(field=fname, shape=body["shape"], relation=relation,
                    boost=float(spec.get("boost", 1.0)))


def _parse_span_term(spec) -> SpanTerm:
    fname, opts = _field_spec(spec, "value")
    return SpanTerm(field=fname, value=str(opts.get("value", "")),
                    boost=float(opts.get("boost", 1.0)))


def _parse_span(body: Any) -> SpanQuery:
    q = parse_query(body)
    if not isinstance(q, (SpanQuery,)):
        raise QueryParsingError(
            f"expected a span query, got [{type(q).__name__}]")
    return q


def _parse_intervals(spec) -> Intervals:
    fname, rule = _field_spec(spec, "match")
    boost = float(rule.pop("boost", 1.0)) if isinstance(rule, dict) else 1.0
    if not isinstance(rule, dict) or len(rule) != 1:
        raise QueryParsingError(
            "intervals requires exactly one rule (match/any_of/all_of/"
            "prefix/wildcard)")
    return Intervals(field=fname, rule=rule, boost=boost)


def _parse_terms_set(spec) -> TermsSet:
    fname, opts = _field_spec(spec, "terms")
    script = opts.get("minimum_should_match_script")
    if isinstance(script, dict):
        script = script.get("source", "")
    return TermsSet(
        field=fname, terms=list(opts.get("terms", [])),
        minimum_should_match_field=opts.get("minimum_should_match_field"),
        minimum_should_match_script=script,
        boost=float(opts.get("boost", 1.0)))


def _parse_wrapper(spec) -> Query:
    import base64
    import json as _json
    raw = spec.get("query")
    if raw is None:
        raise QueryParsingError("wrapper requires [query]")
    try:
        body = _json.loads(base64.b64decode(raw))
    except Exception as e:  # noqa: BLE001 — surface as a parse error
        raise QueryParsingError(f"failed to decode wrapper query: {e}")
    return parse_query(body)


def _parse_geo_polygon(spec) -> GeoPolygon:
    opts = {k: v for k, v in spec.items()
            if k not in ("boost", "validation_method")}
    if len(opts) != 1:
        raise QueryParsingError("geo_polygon requires exactly one field")
    (fname, poly), = opts.items()
    pts = [_parse_geo_point(p) for p in (poly or {}).get("points", [])]
    if len(pts) < 3:
        raise QueryParsingError("geo_polygon requires at least 3 points")
    return GeoPolygon(field=fname, points=pts,
                      boost=float(spec.get("boost", 1.0)))


def _field_value(spec, key):
    fname, opts = _field_spec(spec, key)
    return fname, str(opts.get(key, "")), float(opts.get("boost", 1.0))


def collect_named_queries(body_query: Any
                          ) -> List[Tuple[str, Dict[str, Any]]]:
    """[(name, clause_json)] for every ``_name``-tagged clause in a raw
    request query (search/fetch/subphase/MatchedQueriesPhase.java:43's
    named-weight registry, gathered at the JSON level so every query type
    participates without per-parser changes). The name may sit at the
    clause level ({"bool": {..., "_name": n}}) or inside field options
    ({"match": {"f": {"query": ..., "_name": n}}})."""
    out: List[Tuple[str, Dict[str, Any]]] = []

    def walk(node: Any) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                if k in _PARSERS and isinstance(v, dict):
                    name = v.get("_name")
                    if name is None:
                        for fv in v.values():
                            if isinstance(fv, dict) and "_name" in fv:
                                name = fv["_name"]
                                break
                    if name is not None:
                        out.append((str(name), {k: v}))
                walk(v)
        elif isinstance(node, list):
            for item in node:
                walk(item)

    walk(body_query)
    return out


def disjunctive_clauses(q: Query
                        ) -> Optional[Tuple[str, List[Tuple[str, float]]]]:
    """(field, [(text, boost)]) when the query is a pure disjunctive
    text-scoring shape — a Match with OR semantics, or a Bool of ONLY
    should Match clauses (default/1 minimum_should_match) on one field.
    Returns None otherwise.

    ONE definition shared by the shard WAND collector
    (search/phase.py wand_clauses) and the mesh one-program path
    (parallel/mesh_plane.py mesh_eligible) so their eligibility rules
    cannot drift. Field-type checks stay with the callers (they own the
    mappers)."""
    if isinstance(q, Match):
        if q.operator == "and" or q.minimum_should_match is not None:
            return None
        return q.field, [(q.text, q.boost)]
    if isinstance(q, Bool):
        if q.must or q.must_not or q.filter or not q.should:
            return None
        if q.minimum_should_match not in (None, 0, 1, "1"):
            return None
        field: Optional[str] = None
        clauses: List[Tuple[str, float]] = []
        for c in q.should:
            if not isinstance(c, Match) or c.operator == "and" \
                    or c.minimum_should_match is not None:
                return None
            if field is None:
                field = c.field
            elif field != c.field:
                return None   # one postings executor per (segment, field)
            clauses.append((c.text, c.boost * q.boost))
        if field is None:
            return None
        return field, clauses
    return None


def resolve_minimum_should_match(msm: Any, n_clauses: int) -> int:
    """ES minimum_should_match forms: 3, "3", "-1", "75%", "-25%"."""
    if msm is None:
        return 0
    if isinstance(msm, int):
        value = msm
    else:
        s = str(msm).strip()
        if s.endswith("%"):
            pct = float(s[:-1])
            if pct < 0:
                value = n_clauses - int(n_clauses * (-pct) / 100.0)
            else:
                value = int(n_clauses * pct / 100.0)
        else:
            value = int(s)
    if value < 0:
        value = n_clauses + value
    return max(0, min(value, n_clauses))


def _parse_fuzzy(spec):
    fname, opts = _field_spec(spec, "value")
    return Fuzzy(field=fname, value=str(opts.get("value", "")),
                 fuzziness=opts.get("fuzziness", "AUTO"),
                 boost=float(opts.get("boost", 1.0)))
