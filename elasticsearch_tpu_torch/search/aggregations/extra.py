"""Aggregations round 3: nested/sampler/geo buckets and analytics metrics.

Buckets: nested, reverse_nested (search/aggregations/bucket/nested/),
sampler, diversified_sampler (bucket/sampler/), adjacency_matrix
(bucket/adjacency/), rare_terms (bucket/terms/RareTermsAggregator),
auto_date_histogram (bucket/histogram/AutoDateHistogramAggregator),
geo_distance (bucket/range/GeoDistanceAggregator), geohash_grid,
geotile_grid (bucket/geogrid/).

Metrics: geo_bounds, geo_centroid (metrics/GeoBounds*, GeoCentroid*),
string_stats, boxplot, top_metrics (x-pack analytics), matrix_stats
(modules/aggs-matrix-stats), scripted_metric (metrics/ScriptedMetric*).

Pipelines: percentiles_bucket, serial_diff (pipeline/).

Registration happens at import: the COLLECT/MERGE/FINALIZE maps in
buckets.py / metrics.py are updated, and spec.py's type sets grow.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.search.aggregations import spec as spec_mod
from elasticsearch_tpu_torch.search.aggregations.buckets import (
    BUCKET_COLLECT, BUCKET_FINALIZE, BUCKET_MERGE, _collect_subs,
    _doc_count, _filter_mask, _finalize_subs, _merge_subs, finalize_single,
    merge_multi, merge_single,
)
from elasticsearch_tpu_torch.search.aggregations.metrics import (
    METRIC_COLLECT, METRIC_FINALIZE, METRIC_MERGE, merge_percentiles,
)
from elasticsearch_tpu_torch.search.aggregations.spec import AggSpec
from elasticsearch_tpu_torch.search.aggregations.values import (
    keyword_occurrences, numeric_occurrences,
)
from elasticsearch_tpu_torch.utils.errors import IllegalArgumentError

EARTH_RADIUS_M = 6_371_000.0


def _require_field(spec: AggSpec) -> str:
    fname = spec.params.get("field")
    if fname is None:
        raise IllegalArgumentError(
            f"aggregation [{spec.name}] requires a [field]")
    return fname


def _geo_rows(ctx, fname: str) -> np.ndarray:
    arr = ctx.segment.geo.get(ctx.mappers.resolve_field(fname))
    if arr is None:
        return np.full((ctx.segment.n_docs, 2), np.nan)
    return arr


# ---------------------------------------------------------------------------
# nested / reverse_nested
# ---------------------------------------------------------------------------

def _nested_objects(source: Dict[str, Any], path: str) -> List[Dict[str, Any]]:
    from elasticsearch_tpu_torch.search.nested import nested_objects
    return list(nested_objects(source or {}, path))


def _leaf_values(obj: Dict[str, Any], rel_path: str) -> List[Any]:
    node: Any = obj
    for part in rel_path.split("."):
        if isinstance(node, dict):
            node = node.get(part)
        else:
            return []
        if node is None:
            return []
    return node if isinstance(node, list) else [node]


def _metric_partial_from_values(sub: AggSpec, values: List[float]
                                ) -> Dict[str, Any]:
    vals = [float(v) for v in values]
    if sub.type in ("percentiles", "percentile_ranks",
                    "median_absolute_deviation", "boxplot"):
        return {"samples": vals, "count": len(vals)}
    return {"count": len(vals), "sum": float(sum(vals)),
            "min": min(vals) if vals else None,
            "max": max(vals) if vals else None,
            "sum_sq": float(sum(v * v for v in vals))}


def collect_nested(spec: AggSpec, ctx, mask, scores) -> Dict[str, Any]:
    """Sub-aggregations run over the nested OBJECTS of matching docs
    (bucket/nested/NestedAggregator analog). The device columns flatten
    nested arrays, so object-scoped values come from _source host-side —
    the same host/device split the nested query uses. Supported subs:
    the stats/percentile metric family, terms over object leaves, and
    reverse_nested (whose own subs see the parent doc mask)."""
    path = spec.params.get("path")
    if not path:
        raise IllegalArgumentError(
            f"nested aggregation [{spec.name}] requires [path]")
    seg = ctx.segment
    docs = np.nonzero(mask[: seg.n_docs])[0]
    n_objects = 0
    sub_partials: Dict[str, Any] = {}
    metric_values: Dict[str, List[float]] = {}
    term_counts: Dict[str, Dict[str, int]] = {}
    prefix = f"{path}."
    _NESTED_SUB_METRICS = ("avg", "sum", "min", "max", "value_count",
                           "stats", "extended_stats", "percentiles",
                           "percentile_ranks",
                           "median_absolute_deviation", "boxplot")
    for sub in spec.subs:
        if sub.is_pipeline or sub.type == "reverse_nested":
            continue
        if sub.type == "terms":
            term_counts[sub.name] = {}
        elif sub.type in _NESTED_SUB_METRICS:
            metric_values[sub.name] = []
        else:
            raise IllegalArgumentError(
                f"nested aggregation [{spec.name}] does not support "
                f"sub-aggregation type [{sub.type}]; supported: terms, "
                f"reverse_nested, and the stats/percentile metric family")
    has_objects = np.zeros(seg.n_docs, bool)
    for d in docs:
        for obj in _nested_objects(seg.sources[d] or {}, path):
            n_objects += 1
            has_objects[d] = True
            for sub in spec.subs:
                if sub.is_pipeline or sub.type == "reverse_nested":
                    continue
                fname = sub.params.get("field", "")
                rel = fname[len(prefix):] if fname.startswith(prefix) \
                    else fname
                vals = _leaf_values(obj, rel)
                if sub.type == "terms":
                    counts = term_counts[sub.name]
                    for v in vals:
                        counts[str(v)] = counts.get(str(v), 0) + 1
                else:
                    for v in vals:
                        try:
                            metric_values[sub.name].append(float(v))
                        except (TypeError, ValueError):
                            pass
    for sub in spec.subs:
        if sub.is_pipeline:
            continue
        if sub.type == "reverse_nested":
            # join back to the PARENTS of the nested docs in context —
            # only docs that actually contributed objects
            sub_partials[sub.name] = {
                "doc_count": int(has_objects.sum()),
                "subs": _collect_subs(sub, ctx, mask & has_objects,
                                      scores)}
        elif sub.type == "terms":
            sub_partials[sub.name] = {"buckets": {
                k: {"key": k, "doc_count": n, "subs": {}}
                for k, n in term_counts[sub.name].items()}}
        else:
            sub_partials[sub.name] = _metric_partial_from_values(
                sub, metric_values[sub.name])
    return {"doc_count": n_objects, "subs": sub_partials}


def collect_reverse_nested(spec: AggSpec, ctx, mask, scores
                           ) -> Dict[str, Any]:
    # reached only when used at top level (inside nested it is special-
    # cased above); semantically the parent doc set
    return {"doc_count": _doc_count(mask),
            "subs": _collect_subs(spec, ctx, mask, scores)}


# ---------------------------------------------------------------------------
# sampler / diversified_sampler
# ---------------------------------------------------------------------------

def _sample_mask(spec: AggSpec, ctx, mask, scores,
                 diversify_field: Optional[str] = None) -> np.ndarray:
    n = ctx.segment.n_docs
    shard_size = int(spec.params.get("shard_size", 100))
    s = np.asarray(scores)[: n].astype(np.float64)
    s[~mask[: n]] = -np.inf
    order = np.argsort(-s, kind="stable")
    out = np.zeros(n, bool)
    taken = 0
    per_value: Dict[Any, int] = {}
    max_per = int(spec.params.get("max_docs_per_value", 1))
    value_of = None
    if diversify_field is not None:
        kf = ctx.segment.keywords.get(
            ctx.mappers.resolve_field(diversify_field))
        dv = ctx.segment.doc_values.get(
            ctx.mappers.resolve_field(diversify_field))

        def value_of(d: int):
            if kf is not None:
                ords = kf.ord_values[kf.ord_offsets[d]: kf.ord_offsets[d + 1]]
                return kf.term_list[int(ords[0])] if len(ords) else None
            if dv is not None and dv.exists[d]:
                return float(dv.values[d])
            return None
    for d in order:
        if taken >= shard_size or s[d] == -np.inf:
            break
        if value_of is not None:
            v = value_of(int(d))
            if v is not None:
                if per_value.get(v, 0) >= max_per:
                    continue
                per_value[v] = per_value.get(v, 0) + 1
        out[d] = True
        taken += 1
    return out


def collect_sampler(spec: AggSpec, ctx, mask, scores) -> Dict[str, Any]:
    """Top-scoring shard_size docs feed the sub-aggregations
    (bucket/sampler/SamplerAggregator — best-docs deferring collector
    re-expressed as an up-front mask)."""
    m = _sample_mask(spec, ctx, mask, scores)
    return {"doc_count": _doc_count(m),
            "subs": _collect_subs(spec, ctx, m, scores)}


def collect_diversified(spec: AggSpec, ctx, mask, scores) -> Dict[str, Any]:
    m = _sample_mask(spec, ctx, mask, scores,
                     diversify_field=spec.params.get("field"))
    return {"doc_count": _doc_count(m),
            "subs": _collect_subs(spec, ctx, m, scores)}


# ---------------------------------------------------------------------------
# adjacency_matrix
# ---------------------------------------------------------------------------

def collect_adjacency(spec: AggSpec, ctx, mask, scores) -> Dict[str, Any]:
    filters = spec.params.get("filters")
    if not isinstance(filters, dict) or not filters:
        raise IllegalArgumentError(
            f"adjacency_matrix [{spec.name}] requires [filters]")
    sep = spec.params.get("separator", "&")
    masks = {name: (mask & _filter_mask(ctx, q))
             for name, q in filters.items()}
    buckets: Dict[str, Dict[str, Any]] = {}
    names = sorted(masks)
    for i, a in enumerate(names):
        n = _doc_count(masks[a])
        if n:
            buckets[a] = {"key": a, "doc_count": n,
                          "subs": _collect_subs(spec, ctx, masks[a], scores)}
        for b_name in names[i + 1:]:
            both = masks[a] & masks[b_name]
            n2 = _doc_count(both)
            if n2:
                key = f"{a}{sep}{b_name}"
                buckets[key] = {"key": key, "doc_count": n2,
                                "subs": _collect_subs(spec, ctx, both,
                                                      scores)}
    return {"buckets": buckets}


def finalize_adjacency(spec: AggSpec, p) -> Dict[str, Any]:
    out = []
    for key in sorted(p["buckets"]):
        b = p["buckets"][key]
        entry = {"key": b["key"], "doc_count": b["doc_count"]}
        entry.update(_finalize_subs(spec, b.get("subs", {})))
        out.append(entry)
    return {"buckets": out}


# ---------------------------------------------------------------------------
# rare_terms
# ---------------------------------------------------------------------------

def collect_rare_terms(spec: AggSpec, ctx, mask, scores) -> Dict[str, Any]:
    from elasticsearch_tpu_torch.search.aggregations.buckets import collect_terms
    return collect_terms(spec, ctx, mask, scores)


def finalize_rare_terms(spec: AggSpec, p) -> Dict[str, Any]:
    """Keep terms whose TOTAL count (post-merge) is <= max_doc_count —
    the long tail the terms agg truncates away (RareTermsAggregator)."""
    max_dc = int(spec.params.get("max_doc_count", 1))
    rows = [b for b in p["buckets"].values()
            if b["doc_count"] <= max_dc]
    rows.sort(key=lambda b: (b["doc_count"], str(b["key"])))
    out = []
    for b in rows:
        entry = {"key": b["key"], "doc_count": b["doc_count"]}
        entry.update(_finalize_subs(spec, b.get("subs", {})))
        out.append(entry)
    return {"buckets": out}


# ---------------------------------------------------------------------------
# auto_date_histogram
# ---------------------------------------------------------------------------

# interval ladder in ms (AutoDateHistogramAggregationBuilder.buildRoundings;
# months/years approximated as fixed spans — documented divergence)
_AUTO_LADDER = [1000, 5_000, 10_000, 30_000, 60_000, 300_000, 600_000,
                1_800_000, 3_600_000, 10_800_000, 43_200_000, 86_400_000,
                604_800_000, 2_592_000_000, 7_776_000_000, 31_536_000_000]


# per-segment ceiling on collected auto_date_histogram buckets; the rung
# coarsens until the distinct-key count fits (the agg's whole point is a
# handful of output buckets — unbounded per-second collection could wedge
# a shard on high-cardinality timestamp data)
_AUTO_COLLECT_MAX = 4096


def collect_auto_date_histogram(spec: AggSpec, ctx, mask, scores
                                ) -> Dict[str, Any]:
    fname = _require_field(spec)
    owners, values = numeric_occurrences(ctx, fname)
    keep = mask[owners]
    owners, values = owners[keep], values[keep]
    buckets: Dict[Any, Dict[str, Any]] = {}
    rung = _AUTO_LADDER[0]
    if len(values):
        # collect at the finest rung whose distinct-key count stays
        # bounded; finalize re-buckets to >= the coarsest shard rung
        for rung in _AUTO_LADDER:
            floored = (values // rung).astype(np.int64) * rung
            uniq = np.unique(floored)
            if len(uniq) <= _AUTO_COLLECT_MAX:
                break
        for key in uniq:
            sel = floored == key
            docs = np.unique(owners[sel])
            bmask = np.zeros(ctx.segment.n_docs, bool)
            bmask[docs] = True
            buckets[int(key)] = {
                "key": int(key), "doc_count": int(len(docs)),
                "subs": _collect_subs(spec, ctx, bmask, scores)}
    return {"buckets": buckets, "rung": int(rung)}


def merge_auto_date_histogram(spec: AggSpec, a, b):
    out = merge_multi(spec, {"buckets": a["buckets"]},
                      {"buckets": b["buckets"]})
    return {"buckets": out["buckets"],
            "rung": max(a.get("rung", _AUTO_LADDER[0]),
                        b.get("rung", _AUTO_LADDER[0]))}


def finalize_auto_date_histogram(spec: AggSpec, p) -> Dict[str, Any]:
    from elasticsearch_tpu_torch.search.aggregations.buckets import (
        format_date_key,
    )
    from elasticsearch_tpu_torch.search.aggregations.engine import merge_one
    target = int(spec.params.get("buckets", 10))
    raw = sorted(p["buckets"].values(), key=lambda b: b["key"])
    if not raw:
        return {"buckets": [], "interval": "1s"}
    span = raw[-1]["key"] - raw[0]["key"]
    interval = next((iv for iv in _AUTO_LADDER
                     if span / iv < max(target, 1)), _AUTO_LADDER[-1])
    # never resolve FINER than any shard collected (its keys are already
    # floored to its rung; a finer grid would misplace their mass)
    interval = max(interval, int(p.get("rung", _AUTO_LADDER[0])))
    merged: Dict[int, Dict[str, Any]] = {}
    for b in raw:
        key = int(b["key"] // interval * interval)
        into = merged.get(key)
        if into is None:
            merged[key] = {"key": key, "doc_count": b["doc_count"],
                           "subs": dict(b.get("subs", {}))}
        else:
            into["doc_count"] += b["doc_count"]
            for sub in spec.subs:
                if sub.is_pipeline:
                    continue
                a_s = into["subs"].get(sub.name)
                b_s = b.get("subs", {}).get(sub.name)
                if a_s is not None and b_s is not None:
                    into["subs"][sub.name] = merge_one(sub, a_s, b_s)
                elif b_s is not None:
                    into["subs"][sub.name] = b_s
    out = []
    for key in sorted(merged):
        b = merged[key]
        entry = {"key": float(key),
                 "key_as_string": format_date_key(float(key)),
                 "doc_count": b["doc_count"]}
        entry.update(_finalize_subs(spec, b.get("subs", {})))
        out.append(entry)
    ms = interval
    unit = f"{ms}ms"
    for label, width in (("s", 1000), ("m", 60_000), ("h", 3_600_000),
                         ("d", 86_400_000)):
        if ms % width == 0 and ms // width > 0:
            unit = f"{ms // width}{label}"
    return {"buckets": out, "interval": unit}


# ---------------------------------------------------------------------------
# geo buckets
# ---------------------------------------------------------------------------

def _haversine_m(lat, lon, qlat, qlon):
    la, lo = np.radians(lat), np.radians(lon)
    qa, qo = math.radians(qlat), math.radians(qlon)
    a = np.sin((la - qa) / 2) ** 2 + \
        np.cos(la) * math.cos(qa) * np.sin((lo - qo) / 2) ** 2
    return 2 * EARTH_RADIUS_M * np.arcsin(np.sqrt(np.clip(a, 0, 1)))


def collect_geo_distance(spec: AggSpec, ctx, mask, scores) -> Dict[str, Any]:
    from elasticsearch_tpu_torch.search.dsl import _parse_geo_point
    fname = _require_field(spec)
    origin = spec.params.get("origin")
    ranges = spec.params.get("ranges")
    if origin is None or not ranges:
        raise IllegalArgumentError(
            f"geo_distance [{spec.name}] requires [origin] and [ranges]")
    qlat, qlon = _parse_geo_point(origin)
    unit = {"m": 1.0, "km": 1000.0, "mi": 1609.344}.get(
        spec.params.get("unit", "m"), 1.0)
    pts = _geo_rows(ctx, fname)
    dist = _haversine_m(pts[:, 0], pts[:, 1], qlat, qlon) / unit
    valid = ~np.isnan(dist) & mask[: ctx.segment.n_docs]
    buckets: Dict[str, Dict[str, Any]] = {}
    for r in ranges:
        lo = float(r.get("from", 0.0))
        hi = float(r["to"]) if r.get("to") is not None else np.inf
        sel = valid & (dist >= lo) & (dist < hi)
        key = r.get("key") or (
            f"{_fmt_num(lo)}-{_fmt_num(hi) if np.isfinite(hi) else '*'}")
        buckets[key] = {
            "key": key, "from": lo,
            **({"to": hi} if np.isfinite(hi) else {}),
            "doc_count": _doc_count(sel),
            "subs": _collect_subs(spec, ctx, sel, scores)}
    return {"buckets": buckets}


def _fmt_num(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else str(v)


def finalize_geo_distance(spec: AggSpec, p) -> Dict[str, Any]:
    out = []
    for key, b in sorted(p["buckets"].items(),
                         key=lambda kv: kv[1].get("from", 0.0)):
        entry = {k: v for k, v in b.items() if k != "subs"}
        entry.update(_finalize_subs(spec, b.get("subs", {})))
        out.append(entry)
    return {"buckets": out}


_GEOHASH32 = "0123456789bcdefghjkmnpqrstuvwxyz"


def geohash_encode(lat: float, lon: float, precision: int) -> str:
    """Standard geohash (Geohash.stringEncode analog)."""
    lat_lo, lat_hi = -90.0, 90.0
    lon_lo, lon_hi = -180.0, 180.0
    out = []
    bit = 0
    ch = 0
    even = True
    while len(out) < precision:
        if even:
            mid = (lon_lo + lon_hi) / 2
            if lon >= mid:
                ch = (ch << 1) | 1
                lon_lo = mid
            else:
                ch <<= 1
                lon_hi = mid
        else:
            mid = (lat_lo + lat_hi) / 2
            if lat >= mid:
                ch = (ch << 1) | 1
                lat_lo = mid
            else:
                ch <<= 1
                lat_hi = mid
        even = not even
        bit += 1
        if bit == 5:
            out.append(_GEOHASH32[ch])
            bit = 0
            ch = 0
    return "".join(out)


def geotile_key(lat: float, lon: float, zoom: int) -> str:
    """z/x/y slippy-map tile key (GeoTileUtils.longEncode analog)."""
    n = 1 << zoom
    x = int((lon + 180.0) / 360.0 * n)
    lat_r = math.radians(max(min(lat, 85.05112878), -85.05112878))
    y = int((1.0 - math.log(math.tan(lat_r) + 1.0 / math.cos(lat_r))
             / math.pi) / 2.0 * n)
    return f"{zoom}/{min(max(x, 0), n - 1)}/{min(max(y, 0), n - 1)}"


def _collect_geo_grid(spec: AggSpec, ctx, mask, scores, keyer
                      ) -> Dict[str, Any]:
    fname = _require_field(spec)
    pts = _geo_rows(ctx, fname)
    n = ctx.segment.n_docs
    valid = ~np.isnan(pts[: n, 0]) & mask[: n]
    cells: Dict[str, list] = {}
    for d in np.nonzero(valid)[0]:
        cells.setdefault(keyer(float(pts[d, 0]), float(pts[d, 1])),
                         []).append(int(d))
    buckets = {}
    for key, docs in cells.items():
        bmask = np.zeros(n, bool)
        bmask[docs] = True
        buckets[key] = {"key": key, "doc_count": len(docs),
                        "subs": _collect_subs(spec, ctx, bmask, scores)}
    return {"buckets": buckets}


def collect_geohash_grid(spec: AggSpec, ctx, mask, scores) -> Dict[str, Any]:
    precision = int(spec.params.get("precision", 5))
    return _collect_geo_grid(
        spec, ctx, mask, scores,
        lambda lat, lon: geohash_encode(lat, lon, precision))


def collect_geotile_grid(spec: AggSpec, ctx, mask, scores) -> Dict[str, Any]:
    precision = int(spec.params.get("precision", 7))
    return _collect_geo_grid(
        spec, ctx, mask, scores,
        lambda lat, lon: geotile_key(lat, lon, precision))


def finalize_geo_grid(spec: AggSpec, p) -> Dict[str, Any]:
    size = int(spec.params.get("size", 10000))
    rows = sorted(p["buckets"].values(),
                  key=lambda b: (-b["doc_count"], str(b["key"])))[:size]
    out = []
    for b in rows:
        entry = {"key": b["key"], "doc_count": b["doc_count"]}
        entry.update(_finalize_subs(spec, b.get("subs", {})))
        out.append(entry)
    return {"buckets": out}


# ---------------------------------------------------------------------------
# geo metrics
# ---------------------------------------------------------------------------

def collect_geo_bounds(spec: AggSpec, ctx, mask, scores) -> Dict[str, Any]:
    fname = _require_field(spec)
    pts = _geo_rows(ctx, fname)
    n = ctx.segment.n_docs
    valid = ~np.isnan(pts[: n, 0]) & mask[: n]
    if not valid.any():
        return {"top": None, "bottom": None, "left": None, "right": None}
    lat, lon = pts[: n, 0][valid], pts[: n, 1][valid]
    return {"top": float(lat.max()), "bottom": float(lat.min()),
            "left": float(lon.min()), "right": float(lon.max())}


def merge_geo_bounds(spec, a, b):
    if a.get("top") is None:
        return b
    if b.get("top") is None:
        return a
    return {"top": max(a["top"], b["top"]),
            "bottom": min(a["bottom"], b["bottom"]),
            "left": min(a["left"], b["left"]),
            "right": max(a["right"], b["right"])}


def finalize_geo_bounds(spec, p):
    if p.get("top") is None:
        return {}
    return {"bounds": {
        "top_left": {"lat": p["top"], "lon": p["left"]},
        "bottom_right": {"lat": p["bottom"], "lon": p["right"]}}}


def collect_geo_centroid(spec: AggSpec, ctx, mask, scores) -> Dict[str, Any]:
    fname = _require_field(spec)
    pts = _geo_rows(ctx, fname)
    n = ctx.segment.n_docs
    valid = ~np.isnan(pts[: n, 0]) & mask[: n]
    lat, lon = pts[: n, 0][valid], pts[: n, 1][valid]
    return {"sum_lat": float(lat.sum()), "sum_lon": float(lon.sum()),
            "count": int(valid.sum())}


def merge_geo_centroid(spec, a, b):
    return {"sum_lat": a["sum_lat"] + b["sum_lat"],
            "sum_lon": a["sum_lon"] + b["sum_lon"],
            "count": a["count"] + b["count"]}


def finalize_geo_centroid(spec, p):
    if not p["count"]:
        return {"count": 0}
    return {"location": {"lat": p["sum_lat"] / p["count"],
                         "lon": p["sum_lon"] / p["count"]},
            "count": p["count"]}


# ---------------------------------------------------------------------------
# string_stats / boxplot / top_metrics / matrix_stats / scripted_metric
# ---------------------------------------------------------------------------

def collect_string_stats(spec: AggSpec, ctx, mask, scores) -> Dict[str, Any]:
    fname = _require_field(spec)
    owners, ords, term_list = keyword_occurrences(ctx, fname)
    keep = mask[owners]
    ords = ords[keep]
    count = 0
    len_sum = 0
    min_len: Optional[int] = None
    max_len: Optional[int] = None
    chars: Dict[str, int] = {}
    for o in ords:
        t = term_list[int(o)]
        count += 1
        ln = len(t)
        len_sum += ln
        min_len = ln if min_len is None else min(min_len, ln)
        max_len = ln if max_len is None else max(max_len, ln)
        # chars always accumulate: entropy is part of the DEFAULT
        # response (show_distribution only adds the distribution map)
        for c in t:
            chars[c] = chars.get(c, 0) + 1
    return {"count": count, "len_sum": len_sum, "min_len": min_len,
            "max_len": max_len, "chars": chars}


def merge_string_stats(spec, a, b):
    chars = dict(a["chars"])
    for c, n in b["chars"].items():
        chars[c] = chars.get(c, 0) + n
    return {"count": a["count"] + b["count"],
            "len_sum": a["len_sum"] + b["len_sum"],
            "min_len": _opt2(min, a["min_len"], b["min_len"]),
            "max_len": _opt2(max, a["max_len"], b["max_len"]),
            "chars": chars}


def _opt2(fn, x, y):
    if x is None:
        return y
    if y is None:
        return x
    return fn(x, y)


def finalize_string_stats(spec, p):
    out = {"count": p["count"],
           "min_length": p["min_len"], "max_length": p["max_len"],
           "avg_length": (p["len_sum"] / p["count"]) if p["count"] else None}
    total = sum(p["chars"].values())
    if total:
        entropy = -sum((n / total) * math.log2(n / total)
                       for n in p["chars"].values())
        out["entropy"] = entropy
        if spec.params.get("show_distribution"):
            out["distribution"] = {c: n / total
                                   for c, n in sorted(p["chars"].items())}
    return out


def collect_boxplot(spec: AggSpec, ctx, mask, scores) -> Dict[str, Any]:
    fname = _require_field(spec)
    owners, values = numeric_occurrences(ctx, fname)
    keep = mask[owners]
    vals = values[keep]
    return {"samples": [float(v) for v in vals], "count": int(len(vals))}


def finalize_boxplot(spec, p):
    s = np.sort(np.asarray(p["samples"], np.float64))
    if not len(s):
        return {"min": None, "max": None, "q1": None, "q2": None,
                "q3": None}
    q1, q2, q3 = np.percentile(s, [25, 50, 75])
    return {"min": float(s[0]), "max": float(s[-1]),
            "q1": float(q1), "q2": float(q2), "q3": float(q3)}


def collect_top_metrics(spec: AggSpec, ctx, mask, scores) -> Dict[str, Any]:
    metrics = spec.params.get("metrics")
    sort = spec.params.get("sort")
    if metrics is None or sort is None:
        raise IllegalArgumentError(
            f"top_metrics [{spec.name}] requires [metrics] and [sort]")
    metrics = metrics if isinstance(metrics, list) else [metrics]
    mnames = [m["field"] for m in metrics]
    if isinstance(sort, str):
        # plain-string shorthand: sort by the field ascending
        sort_field, order = sort, "asc"
    else:
        sort_entry = sort[0] if isinstance(sort, list) else sort
        if not isinstance(sort_entry, dict) or not sort_entry:
            raise IllegalArgumentError(
                f"top_metrics [{spec.name}] has an invalid [sort]")
        (sort_field, order), = sort_entry.items()
        if isinstance(order, dict):
            order = order.get("order", "asc")
    size = int(spec.params.get("size", 1))
    seg = ctx.segment
    sf = seg.doc_values.get(ctx.mappers.resolve_field(sort_field))
    rows: List[Tuple[float, Dict[str, Any]]] = []
    if sf is not None:
        docs = np.nonzero(mask[: seg.n_docs] & sf.exists[: seg.n_docs])[0]
        for d in docs:
            entry = {}
            for mn in mnames:
                dv = seg.doc_values.get(ctx.mappers.resolve_field(mn))
                entry[mn] = float(dv.values[d]) \
                    if dv is not None and dv.exists[d] else None
            rows.append((float(sf.values[d]), entry))
    rows.sort(key=lambda r: r[0], reverse=(order == "desc"))
    return {"rows": rows[:size], "order": order}


def _top_metrics_order(spec: AggSpec) -> str:
    """Sort order from the SPEC, not from partials — an empty shard's
    neutral partial must not override the query's direction."""
    sort = spec.params.get("sort")
    if isinstance(sort, str):
        return "asc"
    entry = sort[0] if isinstance(sort, list) else sort
    if isinstance(entry, dict) and entry:
        (_f, order), = entry.items()
        if isinstance(order, dict):
            order = order.get("order", "asc")
        return str(order)
    return "asc"


def merge_top_metrics(spec, a, b):
    rows = a["rows"] + b["rows"]
    order = _top_metrics_order(spec)
    rows.sort(key=lambda r: r[0], reverse=(order == "desc"))
    size = int(spec.params.get("size", 1))
    return {"rows": rows[:size], "order": order}


def finalize_top_metrics(spec, p):
    return {"top": [{"sort": [r[0]], "metrics": r[1]}
                    for r in p["rows"]]}


def collect_matrix_stats(spec: AggSpec, ctx, mask, scores) -> Dict[str, Any]:
    """Per-field moments + pairwise cross-products over docs carrying ALL
    the fields (modules/aggs-matrix-stats MatrixStatsAggregator; the
    reference likewise skips docs missing any field)."""
    fields = spec.params.get("fields")
    if not fields:
        raise IllegalArgumentError(
            f"matrix_stats [{spec.name}] requires [fields]")
    seg = ctx.segment
    n = seg.n_docs
    cols = {}
    have = mask[: n].copy()
    for f in fields:
        dv = seg.doc_values.get(ctx.mappers.resolve_field(f))
        if dv is None:
            have[:] = False
            break
        cols[f] = dv.values.astype(np.float64)
        have &= dv.exists[: n]
    docs = np.nonzero(have)[0]
    out: Dict[str, Any] = {"n": int(len(docs)), "fields": list(fields),
                           "m1": {}, "m2": {}, "m3": {}, "m4": {},
                           "cross": {}}
    for f in fields:
        v = cols[f][docs] if len(docs) else np.zeros(0)
        out["m1"][f] = float(v.sum())
        out["m2"][f] = float((v ** 2).sum())
        out["m3"][f] = float((v ** 3).sum())
        out["m4"][f] = float((v ** 4).sum())
    for i, a in enumerate(fields):
        for b in fields[i + 1:]:
            va = cols[a][docs] if len(docs) else np.zeros(0)
            vb = cols[b][docs] if len(docs) else np.zeros(0)
            out["cross"][f"{a}|{b}"] = float((va * vb).sum())
    return out


def merge_matrix_stats(spec, a, b):
    out = {"n": a["n"] + b["n"], "fields": a["fields"] or b["fields"],
           "m1": {}, "m2": {}, "m3": {}, "m4": {}, "cross": {}}
    for key in ("m1", "m2", "m3", "m4", "cross"):
        names = set(a[key]) | set(b[key])
        out[key] = {f: a[key].get(f, 0.0) + b[key].get(f, 0.0)
                    for f in names}
    return out


def finalize_matrix_stats(spec, p):
    n = p["n"]
    if not n:
        return {"doc_count": 0}
    fields_out = []
    means = {f: p["m1"][f] / n for f in p["fields"]}
    variances = {f: max(p["m2"][f] / n - means[f] ** 2, 0.0)
                 for f in p["fields"]}
    for f in p["fields"]:
        mean = means[f]
        var = variances[f]
        std = math.sqrt(var)
        # central moments from raw moments
        m3c = p["m3"][f] / n - 3 * mean * p["m2"][f] / n + 2 * mean ** 3
        m4c = (p["m4"][f] / n - 4 * mean * p["m3"][f] / n
               + 6 * mean ** 2 * p["m2"][f] / n - 3 * mean ** 4)
        entry = {"name": f, "count": n, "mean": mean,
                 "variance": var * n / max(n - 1, 1),
                 "skewness": (m3c / std ** 3) if std > 0 else 0.0,
                 "kurtosis": (m4c / var ** 2) if var > 0 else 0.0,
                 "covariance": {}, "correlation": {}}
        for g in p["fields"]:
            if g == f:
                entry["covariance"][g] = var * n / max(n - 1, 1)
                entry["correlation"][g] = 1.0
                continue
            key = f"{f}|{g}" if f"{f}|{g}" in p["cross"] else f"{g}|{f}"
            cov = p["cross"][key] / n - means[f] * means[g]
            entry["covariance"][g] = cov * n / max(n - 1, 1)
            denom = math.sqrt(variances[f] * variances[g])
            entry["correlation"][g] = (cov / denom) if denom > 0 else 0.0
        fields_out.append(entry)
    return {"doc_count": n, "fields": fields_out}


def collect_scripted_metric(spec: AggSpec, ctx, mask, scores
                            ) -> Dict[str, Any]:
    """init/map per shard-segment in the sandboxed engine
    (metrics/ScriptedMetricAggregator). combine runs after the segment
    map loop; reduce runs at finalize over all combined states."""
    from elasticsearch_tpu_torch.script import default_engine
    from elasticsearch_tpu_torch.search.execute import _ScriptDocView
    params = dict(spec.params.get("params", {}))
    state: Dict[str, Any] = {}
    variables = {"state": state, "params": params}
    init = spec.params.get("init_script")
    if init:
        default_engine.execute(init, variables)
    map_src = spec.params.get("map_script")
    if not map_src:
        raise IllegalArgumentError(
            f"scripted_metric [{spec.name}] requires [map_script]")
    compiled = default_engine.compile(map_src)
    seg = ctx.segment
    columns = dict(seg.doc_values)
    for d in np.nonzero(mask[: seg.n_docs])[0]:
        compiled.execute({"state": state, "params": params,
                          "doc": _ScriptDocView(seg, columns, int(d))})
    combine = spec.params.get("combine_script")
    combined = state
    if combine:
        combined = default_engine.execute(
            _maybe_return(combine), {"state": state, "params": params})
    return {"states": [combined]}


def _maybe_return(src: str) -> str:
    import re as _re
    if ";" not in src and not _re.search(r"\breturn\b", src):
        return f"return ({src})"
    return src


def merge_scripted_metric(spec, a, b):
    return {"states": list(a["states"]) + list(b["states"])}


def finalize_scripted_metric(spec, p):
    from elasticsearch_tpu_torch.script import default_engine
    reduce_src = spec.params.get("reduce_script")
    if not reduce_src:
        return {"value": p["states"]}
    value = default_engine.execute(
        _maybe_return(reduce_src),
        {"states": list(p["states"]),
         "params": dict(spec.params.get("params", {}))})
    return {"value": value}


# ---------------------------------------------------------------------------
# pipelines: percentiles_bucket / serial_diff
# ---------------------------------------------------------------------------

def sibling_percentiles_bucket(spec: AggSpec, values: List[float]
                               ) -> Dict[str, Any]:
    pcts = spec.params.get("percents", [1.0, 5.0, 25.0, 50.0, 75.0,
                                        95.0, 99.0])
    if not values:
        return {"values": {f"{float(q)}": None for q in pcts}}
    s = np.sort(np.asarray(values, np.float64))
    return {"values": {
        f"{float(q)}": float(np.percentile(s, q)) for q in pcts}}


def parent_serial_diff(spec: AggSpec, buckets: List[Dict[str, Any]]) -> None:
    from elasticsearch_tpu_torch.search.aggregations.pipeline import (
        _bucket_value, _path_of,
    )
    lag = int(spec.params.get("lag", 1))
    path = _path_of(spec)
    vals = [_bucket_value(b, path) for b in buckets]
    for i, b in enumerate(buckets):
        if i >= lag and vals[i] is not None and vals[i - lag] is not None:
            b[spec.name] = {"value": vals[i] - vals[i - lag]}


# ---------------------------------------------------------------------------
# registration
# ---------------------------------------------------------------------------

_NEW_BUCKETS = {
    "nested": (collect_nested, merge_single, finalize_single),
    "reverse_nested": (collect_reverse_nested, merge_single,
                       finalize_single),
    "sampler": (collect_sampler, merge_single, finalize_single),
    "diversified_sampler": (collect_diversified, merge_single,
                            finalize_single),
    "adjacency_matrix": (collect_adjacency, merge_multi,
                         finalize_adjacency),
    "rare_terms": (collect_rare_terms, merge_multi, finalize_rare_terms),
    "auto_date_histogram": (collect_auto_date_histogram,
                            merge_auto_date_histogram,
                            finalize_auto_date_histogram),
    "geo_distance": (collect_geo_distance, merge_multi,
                     finalize_geo_distance),
    "geohash_grid": (collect_geohash_grid, merge_multi, finalize_geo_grid),
    "geotile_grid": (collect_geotile_grid, merge_multi, finalize_geo_grid),
}

_NEW_METRICS = {
    "geo_bounds": (collect_geo_bounds, merge_geo_bounds,
                   finalize_geo_bounds),
    "geo_centroid": (collect_geo_centroid, merge_geo_centroid,
                     finalize_geo_centroid),
    "string_stats": (collect_string_stats, merge_string_stats,
                     finalize_string_stats),
    "boxplot": (collect_boxplot, merge_percentiles, finalize_boxplot),
    "top_metrics": (collect_top_metrics, merge_top_metrics,
                    finalize_top_metrics),
    "matrix_stats": (collect_matrix_stats, merge_matrix_stats,
                     finalize_matrix_stats),
    "scripted_metric": (collect_scripted_metric, merge_scripted_metric,
                        finalize_scripted_metric),
}

for _name, (_c, _m, _f) in _NEW_BUCKETS.items():
    BUCKET_COLLECT[_name] = _c
    BUCKET_MERGE[_name] = _m
    BUCKET_FINALIZE[_name] = _f
    spec_mod.BUCKET_TYPES.add(_name)
for _name, (_c, _m, _f) in _NEW_METRICS.items():
    METRIC_COLLECT[_name] = _c
    METRIC_MERGE[_name] = _m
    METRIC_FINALIZE[_name] = _f
    spec_mod.METRIC_TYPES.add(_name)
spec_mod.PIPELINE_TYPES.update({"percentiles_bucket", "serial_diff"})
spec_mod.ALL_TYPES = (spec_mod.METRIC_TYPES | spec_mod.BUCKET_TYPES
                      | spec_mod.PIPELINE_TYPES)
