"""Field mappings and document parsing.

Mirrors the role of the reference's mapper layer —
``MapperService`` (index/mapper/MapperService.java:75),
``DocumentParser`` (index/mapper/DocumentParser.java:44) and the 29 field
mappers (index/mapper/*FieldMapper.java) plus the x-pack ``dense_vector``
(x-pack/plugin/vectors/.../mapper/DenseVectorFieldMapper.java) and
``rank_features`` (modules/mapper-extras/.../RankFeaturesFieldMapper.java) —
re-designed for a segment model where parsing produces *typed columns*
(terms with positions, numeric doc values, vectors) destined for padded
device arrays rather than a Lucene document.
"""

from __future__ import annotations

import datetime as _dt
import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from elasticsearch_tpu_torch.analysis import AnalysisRegistry, Token
from elasticsearch_tpu_torch.utils.errors import IllegalArgumentError, MapperParsingError

# Max vector dims, mirroring the reference's cap
# (x-pack/plugin/vectors/.../mapper/DenseVectorFieldMapper.java:45 — MAX_DIMS_COUNT=2048).
MAX_VECTOR_DIMS = 4096


@dataclass
class ParsedField:
    """One field's parsed contribution to a document."""
    name: str
    kind: str                                   # 'terms' | 'numeric' | 'vector' | 'features' | 'bool' | 'geo'
    terms: Optional[List[Token]] = None         # text: analyzed tokens with positions
    exact_terms: Optional[List[str]] = None     # keyword: untokenized values
    numeric: Optional[List[float]] = None       # numeric/date doc values
    vector: Optional[List[float]] = None        # dense_vector
    features: Optional[Dict[str, float]] = None # rank_features sparse weights
    geo: Optional[Tuple[float, float]] = None   # (lat, lon)


@dataclass
class ParsedDocument:
    doc_id: str
    source: Dict[str, Any]
    fields: Dict[str, ParsedField] = field(default_factory=dict)
    routing: Optional[str] = None


class FieldMapper:
    """Base field mapper. Subclasses parse one JSON value into a ParsedField."""

    type_name = "unknown"
    searchable = True
    has_doc_values = False

    def __init__(self, name: str, params: Dict[str, Any], analysis: AnalysisRegistry):
        self.name = name
        self.params = params

    def parse(self, value: Any) -> ParsedField:
        raise NotImplementedError

    def to_mapping(self) -> Dict[str, Any]:
        out = {"type": self.type_name}
        out.update(self.params)
        return out


class TextFieldMapper(FieldMapper):
    """Analyzed full-text field (reference: index/mapper/TextFieldMapper.java)."""

    type_name = "text"

    def __init__(self, name: str, params: Dict[str, Any], analysis: AnalysisRegistry):
        super().__init__(name, params, analysis)
        self.analyzer = analysis.get(params.get("analyzer", "standard"))
        self.search_analyzer = analysis.get(
            params.get("search_analyzer", params.get("analyzer", "standard")))

    def parse(self, value: Any) -> ParsedField:
        if isinstance(value, list):
            tokens: List[Token] = []
            pos_base = 0
            for v in value:
                toks = self.analyzer.analyze(str(v))
                for t in toks:
                    t.position += pos_base
                tokens.extend(toks)
                # position gap of 100 between array values, like Lucene's
                # default; every value advances the base, even empty ones
                pos_base = (toks[-1].position if toks else pos_base) + 100
            return ParsedField(self.name, "terms", terms=tokens)
        return ParsedField(self.name, "terms", terms=self.analyzer.analyze(str(value)))


class KeywordFieldMapper(FieldMapper):
    """Exact-value field (reference: index/mapper/KeywordFieldMapper.java)."""

    type_name = "keyword"
    has_doc_values = True

    def __init__(self, name: str, params: Dict[str, Any], analysis: AnalysisRegistry):
        super().__init__(name, params, analysis)
        self.ignore_above = params.get("ignore_above")

    def parse(self, value: Any) -> ParsedField:
        values = value if isinstance(value, list) else [value]
        out = []
        for v in values:
            s = str(v)
            if self.ignore_above is not None and len(s) > self.ignore_above:
                continue
            out.append(s)
        return ParsedField(self.name, "terms", exact_terms=out)


_INT_RANGES = {
    "byte": (-(1 << 7), (1 << 7) - 1),
    "short": (-(1 << 15), (1 << 15) - 1),
    "integer": (-(1 << 31), (1 << 31) - 1),
    "long": (-(1 << 63), (1 << 63) - 1),
}


class NumberFieldMapper(FieldMapper):
    """Numeric types (reference: index/mapper/NumberFieldMapper.java)."""

    has_doc_values = True

    def __init__(self, name: str, params: Dict[str, Any], analysis: AnalysisRegistry,
                 type_name: str = "long"):
        super().__init__(name, params, analysis)
        self.type_name = type_name
        self.scaling_factor = params.get("scaling_factor")
        if type_name == "scaled_float" and not self.scaling_factor:
            raise MapperParsingError(f"scaled_float [{name}] requires [scaling_factor]")

    def parse(self, value: Any) -> ParsedField:
        values = value if isinstance(value, list) else [value]
        out = []
        for v in values:
            if self.type_name in _INT_RANGES:
                # parse integral types exactly (no float round-trip, which
                # corrupts values above 2^53 and mis-ranges values near 2^63)
                try:
                    i = int(v) if not isinstance(v, float) else int(round(v))
                except (TypeError, ValueError):
                    raise MapperParsingError(
                        f"failed to parse field [{self.name}] of type [{self.type_name}]: [{v}]")
                lo, hi = _INT_RANGES[self.type_name]
                if not (lo <= i <= hi):
                    raise MapperParsingError(
                        f"value [{v}] out of range for field [{self.name}] of type [{self.type_name}]")
                # keep exact int (segment builder stores integral doc values
                # as int64 columns; float64 would corrupt above 2^53)
                out.append(i)
                continue
            try:
                f = float(v)
            except (TypeError, ValueError):
                raise MapperParsingError(
                    f"failed to parse field [{self.name}] of type [{self.type_name}]: [{v}]")
            if self.type_name == "scaled_float":
                out.append(round(f * self.scaling_factor) / self.scaling_factor)
            else:
                out.append(f)
        return ParsedField(self.name, "numeric", numeric=out)


class BooleanFieldMapper(FieldMapper):
    type_name = "boolean"
    has_doc_values = True

    def parse(self, value: Any) -> ParsedField:
        values = value if isinstance(value, list) else [value]
        out = []
        for v in values:
            if isinstance(v, bool):
                out.append(1.0 if v else 0.0)
            elif v in ("true", "True"):
                out.append(1.0)
            elif v in ("false", "False"):
                out.append(0.0)
            else:
                raise MapperParsingError(f"cannot parse boolean [{v}] for [{self.name}]")
        return ParsedField(self.name, "numeric", numeric=out)


_EPOCH = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)

_DATE_FORMATS = [
    "%Y-%m-%dT%H:%M:%S.%f%z", "%Y-%m-%dT%H:%M:%S%z", "%Y-%m-%dT%H:%M:%S.%f",
    "%Y-%m-%dT%H:%M:%S", "%Y-%m-%d %H:%M:%S", "%Y-%m-%d", "%Y/%m/%d",
]


def parse_date_millis(value: Any) -> float:
    """Parse a date to epoch millis. Accepts epoch numbers and common ISO formats.

    Reference analog: DateFieldMapper with 'strict_date_optional_time||epoch_millis'.
    """
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return float(value)
    s = str(value)
    if s.endswith("Z"):
        s = s[:-1] + "+0000"
    for fmt in _DATE_FORMATS:
        try:
            dt = _dt.datetime.strptime(s, fmt)
            if dt.tzinfo is None:
                dt = dt.replace(tzinfo=_dt.timezone.utc)
            return (dt - _EPOCH).total_seconds() * 1000.0
        except ValueError:
            continue
    try:
        return float(s)  # epoch millis as string
    except ValueError:
        raise MapperParsingError(f"failed to parse date [{value}]")


class DateFieldMapper(FieldMapper):
    type_name = "date"
    has_doc_values = True

    def parse(self, value: Any) -> ParsedField:
        values = value if isinstance(value, list) else [value]
        return ParsedField(self.name, "numeric", numeric=[parse_date_millis(v) for v in values])


class DenseVectorFieldMapper(FieldMapper):
    """Dense float vector for kNN (reference: x-pack DenseVectorFieldMapper).

    Unlike the reference (which stores vectors in binary doc values and scores
    them via painless script loops), vectors here become rows of an
    HBM-resident matrix scored with a tiled MXU matmul (ops/knn.py).
    """

    type_name = "dense_vector"

    def __init__(self, name: str, params: Dict[str, Any], analysis: AnalysisRegistry):
        super().__init__(name, params, analysis)
        self.dims = int(params.get("dims", 0))
        if not (0 < self.dims <= MAX_VECTOR_DIMS):
            raise MapperParsingError(
                f"dense_vector [{name}] requires 0 < dims <= {MAX_VECTOR_DIMS}, got {self.dims}")
        self.similarity = params.get("similarity", "cosine")
        if self.similarity not in ("cosine", "dot_product", "l2_norm"):
            raise MapperParsingError(f"unknown similarity [{self.similarity}] for [{name}]")
        self.index_options = params.get("index_options")  # e.g. {'type': 'ivf', 'nlist': 1024}

    def parse(self, value: Any) -> ParsedField:
        if not isinstance(value, list) or len(value) != self.dims:
            raise MapperParsingError(
                f"dense_vector [{self.name}] expects {self.dims} dims, "
                f"got {len(value) if isinstance(value, list) else type(value).__name__}")
        try:
            vec = [float(x) for x in value]
        except (TypeError, ValueError):
            raise MapperParsingError(
                f"dense_vector [{self.name}] contains non-numeric values")
        if any(math.isnan(x) or math.isinf(x) for x in vec):
            raise MapperParsingError(f"dense_vector [{self.name}] contains non-finite values")
        return ParsedField(self.name, "vector", vector=vec)


RANGE_TYPES = {"integer_range", "long_range", "float_range",
               "double_range", "date_range"}


class RangeFieldMapper(FieldMapper):
    """Interval-valued fields (index/mapper/RangeFieldMapper.java):
    a document stores {gte/gt, lte/lt}; queries test interval relations
    (intersects/contains/within). Bounds live on internal ``#lo``/``#hi``
    numeric companion columns (the same pattern as join's parent id)."""

    has_doc_values = False

    def __init__(self, name: str, params: Dict[str, Any],
                 analysis: AnalysisRegistry, type_name: str = "long_range"):
        super().__init__(name, params, analysis)
        self.type_name = type_name

    def _coerce(self, v: Any) -> float:
        if self.type_name == "date_range":
            return float(parse_date_millis(v))
        return float(v)

    def _one_bounds(self, value: Any) -> Tuple[float, float]:
        if not isinstance(value, dict):
            raise MapperParsingError(
                f"range field [{self.name}] expects an object with "
                f"gte/gt/lte/lt bounds")
        try:
            if "gte" in value:
                lo = self._coerce(value["gte"])
            elif "gt" in value:
                lo = self._coerce(value["gt"])   # open bound approximated
            else:
                lo = -math.inf
            if "lte" in value:
                hi = self._coerce(value["lte"])
            elif "lt" in value:
                hi = self._coerce(value["lt"])
            else:
                hi = math.inf
        except (TypeError, ValueError) as e:
            raise MapperParsingError(
                f"failed to parse range field [{self.name}]: {e}")
        if lo > hi:
            raise MapperParsingError(
                f"range field [{self.name}] has gte > lte")
        return lo, hi

    def bounds(self, value: Any) -> Tuple[List[float], List[float]]:
        """([lo...], [hi...]) — a doc may carry several ranges."""
        values = value if isinstance(value, list) else [value]
        pairs = [self._one_bounds(v) for v in values]
        return [p[0] for p in pairs], [p[1] for p in pairs]

    def parse(self, value: Any) -> ParsedField:
        self.bounds(value)   # validate; companions store the numbers
        return ParsedField(self.name, "terms", exact_terms=[])


class JoinFieldMapper(FieldMapper):
    """Parent-child relations within one index
    (modules/parent-join ParentJoinFieldMapper analog).

    A parent doc stores the relation name; a child doc stores
    {"name": <child_rel>, "parent": <parent_id>} and must be routed by the
    parent id so both land on the same shard. The relation name indexes as
    a keyword on this field; the parent id indexes on a companion
    ``<field>#parent`` keyword column the join queries read."""

    type_name = "join"
    has_doc_values = False

    def __init__(self, name: str, params: Dict[str, Any],
                 analysis: AnalysisRegistry):
        super().__init__(name, params, analysis)
        relations = params.get("relations") or {}
        self.parents = set(relations.keys())
        self.children = set()
        for kids in relations.values():
            self.children.update(kids if isinstance(kids, list) else [kids])

    def parse(self, value: Any) -> ParsedField:
        if isinstance(value, str):
            rel, parent = value, None
        elif isinstance(value, dict):
            rel = value.get("name")
            parent = value.get("parent")
        else:
            raise MapperParsingError(
                f"join [{self.name}] expects a relation name or object")
        if rel not in self.parents | self.children:
            raise MapperParsingError(
                f"unknown join relation [{rel}] for [{self.name}]")
        if rel in self.children and parent is None:
            raise MapperParsingError(
                f"join relation [{rel}] requires [parent]")
        return ParsedField(self.name, "terms", exact_terms=[str(rel)])


class PercolatorFieldMapper(FieldMapper):
    """Stored-query field (modules/percolator PercolatorFieldMapper
    analog): the value is a query body, validated by parsing at INDEX
    time so a broken alert query is rejected when registered, not
    silently skipped at percolation time. The body itself stays in
    _source; percolation evaluates it against a one-doc memory index
    (search/percolate.py)."""

    type_name = "percolator"
    searchable = False

    def parse(self, value: Any) -> ParsedField:
        from elasticsearch_tpu_torch.search import dsl
        if not isinstance(value, dict):
            raise MapperParsingError(
                f"percolator [{self.name}] expects a query object")
        try:
            dsl.parse_query(value)
        except Exception as e:  # noqa: BLE001 — surface as a mapping error
            raise MapperParsingError(
                f"percolator [{self.name}] failed to parse query: {e}")
        # source-only: no columnar contribution
        return ParsedField(self.name, "terms", terms=[])


class RankFeaturesFieldMapper(FieldMapper):
    """Sparse weighted features (reference: RankFeaturesFieldMapper.java).

    The substrate for learned sparse retrieval (ELSER-style text_expansion):
    a document maps feature names to positive weights; queries score with a
    sparse dot product kernel (ops/sparse.py).
    """

    type_name = "rank_features"

    def parse(self, value: Any) -> ParsedField:
        if not isinstance(value, dict):
            raise MapperParsingError(f"rank_features [{self.name}] expects an object")
        feats = {}
        for k, v in value.items():
            try:
                w = float(v)
            except (TypeError, ValueError):
                raise MapperParsingError(
                    f"rank_features [{self.name}] has non-numeric weight for [{k}]")
            if w < 0:
                raise MapperParsingError(
                    f"rank_features [{self.name}] weights must be >= 0, got {w} for [{k}]")
            feats[str(k)] = w
        return ParsedField(self.name, "features", features=feats)


class RankFeatureFieldMapper(FieldMapper):
    """Single named feature (reference: RankFeatureFieldMapper.java)."""

    type_name = "rank_feature"

    def __init__(self, name: str, params: Dict[str, Any], analysis: AnalysisRegistry):
        super().__init__(name, params, analysis)
        self.positive_score_impact = bool(params.get("positive_score_impact", True))

    def parse(self, value: Any) -> ParsedField:
        w = float(value)
        if w < 0:
            raise MapperParsingError(f"rank_feature [{self.name}] must be >= 0")
        return ParsedField(self.name, "features", features={self.name: w})


class GeoPointFieldMapper(FieldMapper):
    type_name = "geo_point"
    has_doc_values = True

    def parse(self, value: Any) -> ParsedField:
        try:
            if isinstance(value, dict):
                lat, lon = float(value["lat"]), float(value["lon"])
            elif isinstance(value, str):
                parts = value.split(",")
                if len(parts) != 2:
                    raise ValueError("expected 'lat,lon'")
                lat, lon = float(parts[0]), float(parts[1])
            elif isinstance(value, list) and len(value) == 2:
                lon, lat = float(value[0]), float(value[1])  # GeoJSON order
            else:
                raise ValueError(f"unsupported geo_point format {type(value).__name__}")
        except (KeyError, ValueError, TypeError) as e:
            raise MapperParsingError(f"cannot parse geo_point [{value}] for [{self.name}]: {e}")
        if not (-90 <= lat <= 90) or not (-180 <= lon <= 180):
            raise MapperParsingError(f"geo_point [{value}] out of range for [{self.name}]")
        return ParsedField(self.name, "geo", geo=(lat, lon))


class GeoShapeFieldMapper(FieldMapper):
    """GeoJSON geometries (index/mapper/GeoShapeFieldMapper analog).

    The reference triangulates into a BKD tree; here the shape stays in
    _source (validated at index time) and geo_shape queries evaluate
    relations host-side over candidate docs. This package does not carry
    the shape parser yet: indexing a geo_shape value is refused."""

    type_name = "geo_shape"

    def parse(self, value: Any) -> ParsedField:
        from elasticsearch_tpu_torch.utils.errors import NotPortedError
        raise NotPortedError("geo_shape")


class CompletionFieldMapper(FieldMapper):
    """Auto-complete inputs (reference: index/mapper/CompletionFieldMapper).

    The reference builds an FST; here inputs live in the keyword term
    dictionary and suggest does a prefix scan over it (search/suggest.py).
    Option scoring uses document frequency (per-doc weights are accepted
    in the input shape but not yet ranked on)."""

    type_name = "completion"
    has_doc_values = True

    def parse(self, value: Any) -> ParsedField:
        inputs = value.get("input", []) if isinstance(value, dict) \
            else value
        if not isinstance(inputs, list):
            inputs = [inputs]
        return ParsedField(self.name, "terms",
                           exact_terms=[str(v) for v in inputs])


class IpFieldMapper(FieldMapper):
    """IPv4/IPv6 field (index/mapper/IpFieldMapper.java analog).

    Values index as canonical address strings in the keyword term dict;
    CIDR term queries and IP ranges are handled ip-aware at query time
    (search/execute.py) by testing the segment's term dictionary, which
    stays small relative to doc count."""

    type_name = "ip"
    has_doc_values = True

    def parse(self, value: Any) -> ParsedField:
        import ipaddress
        values = value if isinstance(value, list) else [value]
        out = []
        for v in values:
            try:
                out.append(str(ipaddress.ip_address(str(v))))
            except ValueError:
                raise MapperParsingError(
                    f"failed to parse ip [{v}] for field [{self.name}]")
        return ParsedField(self.name, "terms", exact_terms=out)


class BinaryFieldMapper(FieldMapper):
    """Base64 blob stored in _source only, not searchable
    (index/mapper/BinaryFieldMapper.java analog)."""

    type_name = "binary"
    searchable = False

    def parse(self, value: Any) -> ParsedField:
        import base64
        import binascii
        values = value if isinstance(value, list) else [value]
        for v in values:
            try:
                base64.b64decode(str(v), validate=True)
            except (binascii.Error, ValueError):
                raise MapperParsingError(
                    f"failed to parse base64 for binary field [{self.name}]")
        return ParsedField(self.name, "terms", exact_terms=[])


class TokenCountFieldMapper(FieldMapper):
    """Stores the analyzed token count of its input as a numeric column
    (modules/mapper-extras TokenCountFieldMapper analog)."""

    type_name = "token_count"
    has_doc_values = True

    def __init__(self, name: str, params: Dict[str, Any],
                 analysis: AnalysisRegistry):
        super().__init__(name, params, analysis)
        self.analyzer = analysis.get(params.get("analyzer", "standard"))

    def parse(self, value: Any) -> ParsedField:
        values = value if isinstance(value, list) else [value]
        return ParsedField(self.name, "numeric", numeric=[
            float(len(self.analyzer.analyze(str(v)))) for v in values])


class SearchAsYouTypeFieldMapper(TextFieldMapper):
    """Text field with shingle + prefix companions for type-ahead
    (modules/mapper-extras SearchAsYouTypeFieldMapper analog): indexing
    feeds ``._2gram`` / ``._3gram`` shingle subfields and an
    ``._index_prefix`` edge-ngram subfield; multi_match type bool_prefix
    targets the set."""

    type_name = "search_as_you_type"

    def __init__(self, name: str, params: Dict[str, Any],
                 analysis: AnalysisRegistry):
        super().__init__(name, params, analysis)
        self.max_shingle_size = int(params.get("max_shingle_size", 3))


class AliasFieldMapper(FieldMapper):
    """Alternate name for an existing field
    (index/mapper/FieldAliasMapper.java analog). Queries resolve the
    alias to its path before execution."""

    type_name = "alias"
    searchable = False

    def __init__(self, name: str, params: Dict[str, Any],
                 analysis: AnalysisRegistry):
        super().__init__(name, params, analysis)
        self.path = params.get("path")
        if not self.path:
            raise MapperParsingError(
                f"alias field [{name}] requires [path]")

    def parse(self, value: Any) -> ParsedField:
        raise MapperParsingError(
            f"field alias [{self.name}] cannot hold a value")


class ConstantKeywordFieldMapper(FieldMapper):
    """One value shared by every document of the index
    (x-pack ConstantKeywordFieldMapper analog): term queries for the
    value match ALL docs, handled at query time."""

    type_name = "constant_keyword"

    def __init__(self, name: str, params: Dict[str, Any],
                 analysis: AnalysisRegistry):
        super().__init__(name, params, analysis)
        self.value = params.get("value")

    def parse(self, value: Any) -> ParsedField:
        if self.value is None:
            self.value = str(value)      # first seen value pins the constant
            self.params["value"] = self.value
        elif str(value) != self.value:
            raise MapperParsingError(
                f"constant_keyword [{self.name}] only accepts "
                f"[{self.value}], got [{value}]")
        return ParsedField(self.name, "terms", exact_terms=[self.value])


# separator between path and leaf value in flattened field terms —
# chosen outside the printable range so user values cannot collide
FLATTENED_SEP = "\x1f"


class FlattenedFieldMapper(FieldMapper):
    """Whole-object-as-keywords field (x-pack FlattenedFieldMapper
    analog): every leaf value indexes under the root name, and keyed
    lookups (``field.key``) resolve via path-prefixed terms without new
    per-key mappings."""

    type_name = "flattened"

    def parse(self, value: Any) -> ParsedField:
        if not isinstance(value, dict):
            raise MapperParsingError(
                f"flattened field [{self.name}] expects an object")
        terms: List[str] = []

        def walk(prefix: str, obj: Any) -> None:
            if isinstance(obj, dict):
                for k, v in obj.items():
                    walk(f"{prefix}.{k}" if prefix else str(k), v)
            elif isinstance(obj, list):
                for v in obj:
                    walk(prefix, v)
            elif obj is not None:
                leaf = str(obj).lower() if isinstance(obj, bool) else str(obj)
                terms.append(leaf)
                terms.append(f"{prefix}{FLATTENED_SEP}{leaf}")

        walk("", value)
        return ParsedField(self.name, "terms", exact_terms=terms)


class WildcardFieldMapper(KeywordFieldMapper):
    """Keyword variant optimized for wildcard/regexp matching in the
    reference (x-pack WildcardFieldMapper's ngram acceleration); here the
    term dictionary scan already serves those queries, so the type is
    behaviorally a keyword without length limits."""

    type_name = "wildcard"

    def __init__(self, name: str, params: Dict[str, Any],
                 analysis: AnalysisRegistry):
        super().__init__(name, params, analysis)
        self.ignore_above = None


def parse_date_nanos_millis(value: Any) -> float:
    """Date with nanosecond precision -> fractional epoch millis
    (DateFieldMapper.Resolution.NANOSECONDS analog; %f caps at 6 digits
    so the 9-digit fraction parses separately)."""
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return float(value)
    s = str(value)
    import re as _re
    m = _re.match(r"^(.*?)\.(\d{7,9})(Z|[+-]\d{2}:?\d{2})?$", s)
    if m:
        base, frac, tz = m.groups()
        millis = parse_date_millis(base + (tz or "Z"))
        return millis + float(f"0.{frac}") * 1000.0
    return parse_date_millis(value)


class DateNanosFieldMapper(DateFieldMapper):
    type_name = "date_nanos"

    def parse(self, value: Any) -> ParsedField:
        values = value if isinstance(value, list) else [value]
        return ParsedField(self.name, "numeric", numeric=[
            parse_date_nanos_millis(v) for v in values])


class Murmur3FieldMapper(FieldMapper):
    """Stores the murmur3 hash of values as a numeric column for cheap
    cardinality aggregation (plugins/mapper-murmur3 analog)."""

    type_name = "murmur3"
    has_doc_values = True

    def parse(self, value: Any) -> ParsedField:
        from elasticsearch_tpu_torch.utils.murmur3 import murmur3_32
        values = value if isinstance(value, list) else [value]
        return ParsedField(self.name, "numeric", numeric=[
            float(murmur3_32(str(v).encode("utf-8"))) for v in values])


# root-level mapping keys that are configuration, never field names
# (index/mapper/DocumentMapperParser root handlers analog)
_ROOT_MAPPING_KEYS = frozenset(
    ("dynamic", "dynamic_templates", "date_detection",
     "numeric_detection", "runtime"))

_MAPPER_TYPES = {
    "text": TextFieldMapper,
    "keyword": KeywordFieldMapper,
    "completion": CompletionFieldMapper,
    "boolean": BooleanFieldMapper,
    "date": DateFieldMapper,
    "date_nanos": DateNanosFieldMapper,
    "dense_vector": DenseVectorFieldMapper,
    "join": JoinFieldMapper,
    "percolator": PercolatorFieldMapper,
    "rank_features": RankFeaturesFieldMapper,
    "rank_feature": RankFeatureFieldMapper,
    "geo_point": GeoPointFieldMapper,
    "geo_shape": GeoShapeFieldMapper,
    "ip": IpFieldMapper,
    "binary": BinaryFieldMapper,
    "token_count": TokenCountFieldMapper,
    "search_as_you_type": SearchAsYouTypeFieldMapper,
    "alias": AliasFieldMapper,
    "constant_keyword": ConstantKeywordFieldMapper,
    "flattened": FlattenedFieldMapper,
    "wildcard": WildcardFieldMapper,
    "murmur3": Murmur3FieldMapper,
}
for _num in ("long", "integer", "short", "byte", "double", "float", "half_float", "scaled_float"):
    _MAPPER_TYPES[_num] = _num  # sentinel; handled in build_mapper
for _rng in RANGE_TYPES:
    _MAPPER_TYPES[_rng] = _rng  # sentinel; handled in build_mapper

NUMERIC_TYPES = frozenset(
    ("long", "integer", "short", "byte", "double", "float", "half_float",
     "scaled_float", "date", "boolean"))


def build_mapper(name: str, spec: Dict[str, Any], analysis: AnalysisRegistry) -> FieldMapper:
    spec = dict(spec)
    type_name = spec.pop("type", "object")
    factory = _MAPPER_TYPES.get(type_name)
    if factory is None:
        raise MapperParsingError(f"no handler for type [{type_name}] on field [{name}]")
    if isinstance(factory, str):
        if factory in RANGE_TYPES:
            return RangeFieldMapper(name, spec, analysis,
                                    type_name=factory)
        return NumberFieldMapper(name, spec, analysis, type_name=factory)
    return factory(name, spec, analysis)


class MapperService:
    """Per-index schema: field name → mapper; parses documents; merges mapping updates.

    Reference analog: index/mapper/MapperService.java:75 (+ DocumentParser.java:44).
    Supports dynamic mapping: unseen fields get a type inferred from the JSON value
    (string → text with .keyword subfield, number → long/double, bool, date-ish → date).
    """

    def __init__(self, mapping: Optional[Dict[str, Any]] = None,
                 analysis: Optional[AnalysisRegistry] = None,
                 dynamic: Any = True):
        self.analysis = analysis or AnalysisRegistry()
        # tri-state like the reference: True (map new fields), False (ignore
        # them, still store in _source), "strict" (reject the document)
        self.dynamic = _parse_dynamic(dynamic)
        self._mappers: Dict[str, FieldMapper] = {}
        # container paths: full path -> "object" | "nested". Nested paths
        # additionally gate nested-query semantics (parity work pending).
        self._object_types: Dict[str, str] = {}
        if mapping:
            self.merge(mapping)

    def merge(self, mapping: Dict[str, Any]) -> None:
        props = mapping.get("properties")
        if props is None:
            # bare-props convenience form: everything except known root
            # mapping keys (dynamic, _source, _meta, ...) is a field spec.
            # Malformed (non-dict) specs fail loudly here exactly as they
            # would under an explicit "properties" key.
            props = {}
            for k, v in mapping.items():
                if k.startswith("_") or k in _ROOT_MAPPING_KEYS:
                    continue
                if not isinstance(v, dict):
                    raise MapperParsingError(
                        f"expected map for property [{k}] but got "
                        f"[{type(v).__name__}]")
                props[k] = v
        self._merge_props("", props)
        if "dynamic" in mapping:
            self.dynamic = _parse_dynamic(mapping["dynamic"])
        # internal companion columns (never serialized): join parent ids,
        # and range bounds as two numeric doc-value columns
        for name, m in list(self._mappers.items()):
            if m.type_name == "join":
                companion = f"{name}#parent"
                if companion not in self._mappers:
                    self._mappers[companion] = KeywordFieldMapper(
                        companion, {}, self.analysis)
            elif m.type_name in RANGE_TYPES:
                for suffix in ("#lo", "#hi"):
                    companion = f"{name}{suffix}"
                    if companion not in self._mappers:
                        self._mappers[companion] = NumberFieldMapper(
                            companion, {}, self.analysis,
                            type_name="double")
            elif m.type_name == "search_as_you_type":
                self._make_sayt_companions(name, m)

    def _make_sayt_companions(self, name: str,
                              m: "SearchAsYouTypeFieldMapper") -> None:
        """._2gram/._3gram shingles + ._index_prefix edge-ngrams."""
        from elasticsearch_tpu_torch.analysis.analyzers import (
            Analyzer, lowercase_filter, make_edge_ngram_filter,
            make_shingle_filter, standard_tokenizer,
        )
        for n in range(2, m.max_shingle_size + 1):
            sub = f"{name}._{n}gram"
            if sub in self._mappers:
                continue
            sh = Analyzer(f"__sayt_{n}gram", standard_tokenizer,
                          [lowercase_filter,
                           make_shingle_filter(n, n,
                                               output_unigrams=False)])
            mapper = TextFieldMapper(sub, {}, self.analysis)
            mapper.analyzer = sh
            mapper.search_analyzer = sh
            self._mappers[sub] = mapper
        sub = f"{name}._index_prefix"
        if sub not in self._mappers:
            pre = Analyzer(
                "__sayt_prefix", standard_tokenizer,
                [lowercase_filter,
                 make_shingle_filter(1, m.max_shingle_size),
                 make_edge_ngram_filter(1, 20)])
            mapper = TextFieldMapper(sub, {}, self.analysis)
            mapper.analyzer = pre
            # queries send the literal prefix; only indexing expands ngrams
            from elasticsearch_tpu_torch.analysis import STANDARD
            mapper.search_analyzer = STANDARD
            self._mappers[sub] = mapper

    def _merge_props(self, prefix: str, props: Dict[str, Any]) -> None:
        for name, spec in props.items():
            full = f"{prefix}{name}"
            if not isinstance(spec, dict):
                raise MapperParsingError(
                    f"expected map for property [{full}] but got "
                    f"[{type(spec).__name__}]")
            # inner objects: implicit (properties, no type) or explicit
            # object/nested (ObjectMapper/NestedObjectMapper analog) —
            # recurse, record the container kind, no leaf mapper
            if spec.get("type") in ("object", "nested") or \
                    ("properties" in spec and "type" not in spec):
                existing = self._mappers.get(full)
                if existing is not None:
                    raise MapperParsingError(
                        f"mapper [{full}] cannot change type from "
                        f"[{existing.type_name}] to [object]")
                prior_kind = self._object_types.get(full)
                if "type" in spec:
                    # explicit object<->nested change is rejected (ES:
                    # "can't merge a non object mapping ... nested")
                    if prior_kind is not None and prior_kind != spec["type"]:
                        raise MapperParsingError(
                            f"mapper [{full}] cannot change type from "
                            f"[{prior_kind}] to [{spec['type']}]")
                    self._object_types[full] = spec["type"]
                elif prior_kind is None:
                    # implicit properties-only spec keeps an existing kind
                    self._object_types[full] = "object"
                self._merge_props(f"{full}.", spec.get("properties", {}))
                continue
            new = build_mapper(full, spec, self.analysis)
            existing = self._mappers.get(full)
            if existing is not None and existing.type_name != new.type_name:
                raise MapperParsingError(
                    f"mapper [{full}] cannot change type from "
                    f"[{existing.type_name}] to [{new.type_name}]")
            if full in self._object_types:
                raise MapperParsingError(
                    f"mapper [{full}] cannot change type from "
                    f"[{self._object_types[full]}] to [{new.type_name}]")
            self._mappers[full] = new
            # text fields get an automatic .keyword subfield unless disabled,
            # mirroring ES dynamic-template default behavior
            for sub, subspec in spec.get("fields", {}).items():
                self._mappers[f"{full}.{sub}"] = build_mapper(f"{full}.{sub}", subspec, self.analysis)

    def resolve_field(self, field_name: str) -> str:
        """Follow a field alias to its target path (FieldAliasMapper
        analog); non-aliases resolve to themselves."""
        m = self._mappers.get(field_name)
        if m is not None and m.type_name == "alias":
            return m.path
        return field_name

    def mapper(self, field_name: str) -> Optional[FieldMapper]:
        m = self._mappers.get(field_name)
        if m is not None and m.type_name == "alias":
            return self._mappers.get(m.path)
        return m

    def field_type(self, field_name: str) -> Optional[str]:
        m = self.mapper(field_name)
        return m.type_name if m else None

    def field_names(self) -> List[str]:
        return sorted(self._mappers.keys())

    def to_mapping(self) -> Dict[str, Any]:
        props: Dict[str, Any] = {}
        for name, m in sorted(self._mappers.items()):
            if "#" in name:
                continue   # internal companion columns (join#parent)
            node = props
            parts = name.split(".")
            # .keyword-style subfields render under 'fields'
            parent = ".".join(parts[:-1])
            if parent in self._mappers and self._mappers[parent].type_name == "text":
                parent_spec = _descend(props, parent.split("."))
                parent_spec.setdefault("fields", {})[parts[-1]] = m.to_mapping()
                continue
            for p in parts[:-1]:
                node = node.setdefault(p, {}).setdefault("properties", {})
            node[parts[-1]] = m.to_mapping()
        # container types survive the round-trip: nested always explicitly,
        # and empty object containers too (else serialize->reparse would
        # silently drop them and a later put_mapping could repurpose the
        # path as a leaf field, diverging from live mappers)
        for path, kind in self._object_types.items():
            node = props
            parts = path.split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {}).setdefault("properties", {})
            leaf = node.setdefault(parts[-1], {})
            if kind == "nested" or not leaf:
                leaf["type"] = kind
        return {"properties": props}

    def _infer(self, name: str, value: Any) -> Optional[FieldMapper]:
        if isinstance(value, bool):
            spec: Dict[str, Any] = {"type": "boolean"}
        elif isinstance(value, int):
            spec = {"type": "long"}
        elif isinstance(value, float):
            spec = {"type": "double"}
        elif isinstance(value, str):
            spec = {"type": "text"}
            if _looks_like_date(value):
                try:
                    parse_date_millis(value)
                    spec = {"type": "date"}
                except MapperParsingError:
                    pass
        elif isinstance(value, dict):
            return None  # object: recurse in parse
        elif isinstance(value, list):
            return self._infer(name, value[0]) if value else None
        else:
            return None
        if name in self._object_types:
            # a scalar arriving at an object/nested container path is a
            # document error, not a mapping update (DocumentParser rejects
            # "tried to parse field [x] as object" the same way)
            raise MapperParsingError(
                f"object mapping for [{name}] tried to parse value as "
                f"{self._object_types[name]}, got a concrete value")
        self._mappers[name] = build_mapper(name, spec, self.analysis)
        if spec["type"] == "text":
            self._mappers[f"{name}.keyword"] = build_mapper(
                f"{name}.keyword", {"type": "keyword", "ignore_above": 256}, self.analysis)
        return self._mappers[name]

    def parse_document(self, doc_id: str, source: Dict[str, Any],
                       routing: Optional[str] = None) -> ParsedDocument:
        doc = ParsedDocument(doc_id=doc_id, source=source, routing=routing)
        self._parse_obj("", source, doc)
        # a child join doc MUST be routed (by its parent id) or it can land
        # on a different shard than the parent and every join query would
        # silently miss it (the reference's RoutingMissingException)
        for name, mapper in self._mappers.items():
            if getattr(mapper, "type_name", "") != "join":
                continue
            parsed = doc.fields.get(name)
            if parsed is not None and parsed.exact_terms and \
                    parsed.exact_terms[0] in mapper.children and \
                    routing is None:
                raise MapperParsingError(
                    f"routing is required for join child documents "
                    f"([{name}] relation [{parsed.exact_terms[0]}])")
        return doc

    def _parse_obj(self, prefix: str, obj: Dict[str, Any], doc: ParsedDocument) -> None:
        for key, value in obj.items():
            name = f"{prefix}{key}"
            if value is None:
                continue
            mapper = self._mappers.get(name)
            if mapper is None:
                if isinstance(value, dict):
                    self._parse_obj(f"{name}.", value, doc)
                    continue
                if self.dynamic == "strict":
                    raise MapperParsingError(
                        f"mapping set to strict, dynamic introduction of [{name}] is not allowed")
                if self.dynamic is False:
                    continue  # ignore unmapped field; it stays in _source only
                mapper = self._infer(name, value)
                if mapper is None:
                    if isinstance(value, list) and value and isinstance(value[0], dict):
                        for item in value:
                            self._parse_obj(f"{name}.", item, doc)
                    continue
            parsed = mapper.parse(value)
            if name in doc.fields:
                _merge_parsed(doc.fields[name], parsed)
            else:
                doc.fields[name] = parsed
            # feed the join parent-id companion column
            if mapper.type_name == "join" and isinstance(value, dict) and \
                    value.get("parent") is not None:
                comp = f"{name}#parent"
                companion = self._mappers.get(comp)
                if companion is not None:
                    doc.fields[comp] = companion.parse(str(value["parent"]))
            # feed range bound companions (lists align: lo[i] pairs with
            # hi[i]; unbounded sides store +-inf, comparable like the
            # query side's open bounds)
            if mapper.type_name in RANGE_TYPES:
                los, his = mapper.bounds(value)
                for suffix, bound_list in (("#lo", los), ("#hi", his)):
                    comp = self._mappers.get(f"{name}{suffix}")
                    if comp is not None:
                        doc.fields[f"{name}{suffix}"] = \
                            comp.parse(bound_list)
            # feed text.keyword subfields
            kw = self._mappers.get(f"{name}.keyword")
            if kw is not None and mapper.type_name == "text":
                sub = kw.parse(value)
                subname = f"{name}.keyword"
                if subname in doc.fields:
                    _merge_parsed(doc.fields[subname], sub)
                else:
                    doc.fields[subname] = sub
            # feed search_as_you_type shingle/prefix companions
            if mapper.type_name == "search_as_you_type":
                for suffix in ([f"._{n}gram" for n in range(2, 10)]
                               + ["._index_prefix"]):
                    comp = self._mappers.get(f"{name}{suffix}")
                    if comp is None:
                        continue
                    sub = comp.parse(value)
                    subname = f"{name}{suffix}"
                    if subname in doc.fields:
                        _merge_parsed(doc.fields[subname], sub)
                    else:
                        doc.fields[subname] = sub


def _merge_parsed(into: ParsedField, other: ParsedField) -> None:
    for attr in ("terms", "exact_terms", "numeric"):
        a, b = getattr(into, attr), getattr(other, attr)
        if b:
            setattr(into, attr, (a or []) + b)
    if other.features:
        into.features = {**(into.features or {}), **other.features}
    if other.vector:
        into.vector = other.vector
    if other.geo:
        into.geo = other.geo


def _descend(props: Dict[str, Any], parts: List[str]) -> Dict[str, Any]:
    node = props
    for p in parts[:-1]:
        node = node[p]["properties"]
    return node[parts[-1]]


def _parse_dynamic(value: Any) -> Any:
    if value in ("strict",):
        return "strict"
    if value in (False, "false"):
        return False
    return True


def _looks_like_date(s: str) -> bool:
    if len(s) < 8 or not s[:4].isdigit():
        return False
    return s[4] in "-/" and any(c.isdigit() for c in s[5:7])
