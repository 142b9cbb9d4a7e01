"""Metric aggregations: masked columnar reductions + mergeable partials.

Reference analog: search/aggregations/metrics/ (47 aggregators). Each
implements the (collect, merge, finalize) protocol over occurrence arrays
from values.py. Partials carry sufficient statistics (count/sum/min/max/
sum-of-squares/HLL registers/quantile samples) so coordinator reduce is
exact — the same shapes the reference's Internal* classes serialize.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.search.aggregations.spec import AggSpec
from elasticsearch_tpu_torch.search.aggregations.values import resolve_numeric
from elasticsearch_tpu_torch.utils.errors import IllegalArgumentError
from elasticsearch_tpu_torch.utils.murmur3 import murmur3_32

# percentile partials keep at most this many raw samples per shard; beyond
# it they thin deterministically (every k-th of the sorted run). The
# reference bounds memory the same way via t-digest compression.
MAX_SAMPLES = 10_000

# cardinality switches from exact hash sets to HLL registers past this
# (precision_threshold default, metrics/HyperLogLogPlusPlus.java)
DEFAULT_PRECISION_THRESHOLD = 3000
HLL_P = 11                       # 2048 registers
HLL_M = 1 << HLL_P


def _masked(spec: AggSpec, ctx, mask: np.ndarray
            ) -> Tuple[np.ndarray, np.ndarray]:
    owners, values = resolve_numeric(ctx, spec.params, spec.name)
    if len(owners) == 0:
        return owners, values
    keep = mask[owners]
    return owners[keep], values[keep]


# ---------------------------------------------------------------------------
# simple sufficient-statistics metrics
# ---------------------------------------------------------------------------

def collect_stats(spec: AggSpec, ctx, mask, scores) -> Dict[str, Any]:
    _, values = _masked(spec, ctx, mask)
    if len(values) == 0:
        return {"count": 0, "sum": 0.0, "min": None, "max": None,
                "sum_sq": 0.0}
    return {"count": int(len(values)), "sum": float(values.sum()),
            "min": float(values.min()), "max": float(values.max()),
            "sum_sq": float((values * values).sum())}


def merge_stats(spec: AggSpec, a, b) -> Dict[str, Any]:
    return {
        "count": a["count"] + b["count"],
        "sum": a["sum"] + b["sum"],
        "min": _opt(min, a["min"], b["min"]),
        "max": _opt(max, a["max"], b["max"]),
        "sum_sq": a["sum_sq"] + b["sum_sq"],
    }


def _opt(fn, x, y):
    if x is None:
        return y
    if y is None:
        return x
    return fn(x, y)


def finalize_stats(spec: AggSpec, p) -> Dict[str, Any]:
    count, total = p["count"], p["sum"]
    avg = total / count if count else None
    if spec.type == "avg":
        return {"value": avg}
    if spec.type == "sum":
        return {"value": total}
    if spec.type == "min":
        return {"value": p["min"]}
    if spec.type == "max":
        return {"value": p["max"]}
    if spec.type == "value_count":
        return {"value": count}
    if spec.type == "stats":
        return {"count": count, "min": p["min"], "max": p["max"],
                "avg": avg, "sum": total}
    # extended_stats
    if count:
        variance = max(p["sum_sq"] / count - (total / count) ** 2, 0.0)
        std = math.sqrt(variance)
    else:
        variance = std = None
    sigma = float(spec.params.get("sigma", 2.0))
    bounds = (
        {"upper": avg + sigma * std, "lower": avg - sigma * std}
        if count else {"upper": None, "lower": None})
    return {"count": count, "min": p["min"], "max": p["max"], "avg": avg,
            "sum": total, "sum_of_squares": p["sum_sq"] if count else None,
            "variance": variance, "std_deviation": std,
            "std_deviation_bounds": bounds}


# ---------------------------------------------------------------------------
# weighted_avg
# ---------------------------------------------------------------------------

def collect_weighted_avg(spec: AggSpec, ctx, mask, scores) -> Dict[str, Any]:
    vspec = spec.params.get("value", {})
    wspec = spec.params.get("weight", {})
    vo, vv = resolve_numeric(ctx, vspec, spec.name)
    wo, wv = resolve_numeric(ctx, wspec, spec.name)
    # single weight per doc (the reference rejects multi-valued weights)
    wmap = np.full(ctx.segment.n_docs, np.nan)
    wmap[wo] = wv
    keep = mask[vo] & ~np.isnan(wmap[vo])
    vo, vv = vo[keep], vv[keep]
    w = wmap[vo]
    return {"wsum": float((vv * w).sum()), "w": float(w.sum())}


def merge_weighted_avg(spec, a, b):
    return {"wsum": a["wsum"] + b["wsum"], "w": a["w"] + b["w"]}


def finalize_weighted_avg(spec, p):
    return {"value": (p["wsum"] / p["w"]) if p["w"] else None}


# ---------------------------------------------------------------------------
# cardinality (exact set → HLL past precision threshold)
# ---------------------------------------------------------------------------

def _hash_value(v: Any) -> int:
    if isinstance(v, float) and v.is_integer():
        v = int(v)
    return murmur3_32(str(v).encode("utf-8"), seed=0x9747b28c) & 0xFFFFFFFF


def _hll_from_hashes(hashes) -> List[int]:
    registers = [0] * HLL_M
    for h in hashes:
        # reuse the 32-bit hash: index = low p bits, rank from the rest
        idx = h & (HLL_M - 1)
        rest = h >> HLL_P
        rank = (32 - HLL_P) - rest.bit_length() + 1 if rest else (32 - HLL_P + 1)
        if rank > registers[idx]:
            registers[idx] = rank
    return registers


def collect_cardinality(spec: AggSpec, ctx, mask, scores) -> Dict[str, Any]:
    from elasticsearch_tpu_torch.search.aggregations.values import (
        field_kind, keyword_occurrences,
    )
    fname = spec.params.get("field")
    script = spec.params.get("script")
    if fname is not None and script is None and \
            field_kind(ctx, fname) == "keyword":
        owners, ords, term_list = keyword_occurrences(ctx, fname)
        keep = mask[owners]
        uniq = np.unique(ords[keep])
        hashes = {_hash_value(term_list[o]) for o in uniq}
    else:
        _, values = _masked(spec, ctx, mask)
        hashes = {_hash_value(v) for v in values}
    return {"kind": "exact", "hashes": sorted(hashes)}


def merge_cardinality(spec: AggSpec, a, b) -> Dict[str, Any]:
    threshold = int(spec.params.get("precision_threshold",
                                    DEFAULT_PRECISION_THRESHOLD))
    threshold = min(max(threshold, 0), 40000)
    if a["kind"] == "exact" and b["kind"] == "exact":
        merged = sorted(set(a["hashes"]) | set(b["hashes"]))
        if len(merged) <= threshold:
            return {"kind": "exact", "hashes": merged}
        return {"kind": "hll", "registers": _hll_from_hashes(merged)}
    ra = (a["registers"] if a["kind"] == "hll"
          else _hll_from_hashes(a["hashes"]))
    rb = (b["registers"] if b["kind"] == "hll"
          else _hll_from_hashes(b["hashes"]))
    return {"kind": "hll",
            "registers": [max(x, y) for x, y in zip(ra, rb)]}


def finalize_cardinality(spec: AggSpec, p) -> Dict[str, Any]:
    if p["kind"] == "exact":
        return {"value": len(p["hashes"])}
    registers = np.asarray(p["registers"], np.float64)
    alpha = 0.7213 / (1.0 + 1.079 / HLL_M)
    estimate = alpha * HLL_M * HLL_M / np.power(2.0, -registers).sum()
    zeros = int((registers == 0).sum())
    if estimate <= 2.5 * HLL_M and zeros:
        estimate = HLL_M * math.log(HLL_M / zeros)   # linear counting
    return {"value": int(round(estimate))}


# ---------------------------------------------------------------------------
# percentiles / percentile_ranks (bounded-sample sketch)
# ---------------------------------------------------------------------------

def _thin(samples: List[float]) -> List[float]:
    if len(samples) <= MAX_SAMPLES:
        return samples
    samples = sorted(samples)
    step = len(samples) / MAX_SAMPLES
    return [samples[min(int(i * step), len(samples) - 1)]
            for i in range(MAX_SAMPLES)]


def collect_percentiles(spec: AggSpec, ctx, mask, scores) -> Dict[str, Any]:
    _, values = _masked(spec, ctx, mask)
    return {"samples": _thin([float(v) for v in values]),
            "count": int(len(values))}


def merge_percentiles(spec, a, b):
    return {"samples": _thin(a["samples"] + b["samples"]),
            "count": a["count"] + b["count"]}


def finalize_percentiles(spec: AggSpec, p) -> Dict[str, Any]:
    samples = np.asarray(p["samples"], np.float64)
    if spec.type == "percentile_ranks":
        targets = [float(v) for v in spec.params.get("values", [])]
        out = {}
        for t in targets:
            rank = (100.0 * float((samples <= t).sum()) / len(samples)
                    if len(samples) else None)
            out[_pct_key(t)] = rank
        return {"values": out}
    percents = spec.params.get("percents",
                               [1.0, 5.0, 25.0, 50.0, 75.0, 95.0, 99.0])
    out = {}
    for q in percents:
        out[_pct_key(float(q))] = (
            float(np.percentile(samples, float(q))) if len(samples)
            else None)
    return {"values": out}


def _pct_key(q: float) -> str:
    return f"{q:.1f}" if q != int(q) else f"{float(q):.1f}"


def collect_mad(spec: AggSpec, ctx, mask, scores) -> Dict[str, Any]:
    return collect_percentiles(spec, ctx, mask, scores)


def finalize_mad(spec: AggSpec, p) -> Dict[str, Any]:
    samples = np.asarray(p["samples"], np.float64)
    if not len(samples):
        return {"value": None}
    med = np.median(samples)
    return {"value": float(np.median(np.abs(samples - med)))}


# ---------------------------------------------------------------------------
# top_hits
# ---------------------------------------------------------------------------

def collect_top_hits(spec: AggSpec, ctx, mask, scores) -> Dict[str, Any]:
    size = int(spec.params.get("size", 3))
    seg = ctx.segment
    scores = np.asarray(scores, np.float64)[: seg.n_docs]
    docs = np.nonzero(mask)[0]
    if len(docs) == 0:
        return {"hits": [], "total": 0}
    order = docs[np.argsort(-scores[docs], kind="stable")][:size]
    hits = []
    for d in order:
        hit = {"_id": seg.ids[d] if d < len(seg.ids) else str(d),
               "_score": float(scores[d]),
               "_source": seg.sources[d] if d < len(seg.sources) else None}
        src_filter = spec.params.get("_source")
        if src_filter is not None and src_filter is not True:
            from elasticsearch_tpu_torch.search.fetch import filter_source
            includes = (src_filter if isinstance(src_filter, list) else
                        src_filter.get("includes", [])
                        if isinstance(src_filter, dict) else [src_filter])
            excludes = (src_filter.get("excludes", [])
                        if isinstance(src_filter, dict) else [])
            if hit["_source"] is not None:
                hit["_source"] = filter_source(hit["_source"], includes,
                                               excludes)
        hits.append(hit)
    return {"hits": hits, "total": int(len(docs))}


def merge_top_hits(spec: AggSpec, a, b) -> Dict[str, Any]:
    size = int(spec.params.get("size", 3))
    hits = sorted(a["hits"] + b["hits"], key=lambda h: -h["_score"])[:size]
    return {"hits": hits, "total": a["total"] + b["total"]}


def finalize_top_hits(spec: AggSpec, p) -> Dict[str, Any]:
    mx = max((h["_score"] for h in p["hits"]), default=None)
    return {"hits": {"total": {"value": p["total"], "relation": "eq"},
                     "max_score": mx, "hits": p["hits"]}}


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_SIMPLE = {"avg", "sum", "min", "max", "value_count", "stats",
           "extended_stats"}

METRIC_COLLECT = {t: collect_stats for t in _SIMPLE}
METRIC_MERGE = {t: merge_stats for t in _SIMPLE}
METRIC_FINALIZE = {t: finalize_stats for t in _SIMPLE}

METRIC_COLLECT.update({
    "weighted_avg": collect_weighted_avg,
    "cardinality": collect_cardinality,
    "percentiles": collect_percentiles,
    "percentile_ranks": collect_percentiles,
    "median_absolute_deviation": collect_mad,
    "top_hits": collect_top_hits,
})
METRIC_MERGE.update({
    "weighted_avg": merge_weighted_avg,
    "cardinality": merge_cardinality,
    "percentiles": merge_percentiles,
    "percentile_ranks": merge_percentiles,
    "median_absolute_deviation": merge_percentiles,
    "top_hits": merge_top_hits,
})
METRIC_FINALIZE.update({
    "weighted_avg": finalize_weighted_avg,
    "cardinality": finalize_cardinality,
    "percentiles": finalize_percentiles,
    "percentile_ranks": finalize_percentiles,
    "median_absolute_deviation": finalize_mad,
    "top_hits": finalize_top_hits,
})
