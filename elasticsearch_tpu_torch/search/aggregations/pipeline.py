"""Pipeline aggregations: coordinator-side transforms over reduced buckets.

Reference analog: search/aggregations/pipeline/ — sibling pipelines
(avg_bucket & co., buckets_path "multi_bucket>metric") and parent pipelines
(derivative, cumulative_sum, bucket_script/selector/sort) that live inside
a multi-bucket agg and read sibling metrics per bucket. Run after the final
reduce, exactly like InternalAggregation.java:212's pipeline phase.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np

from elasticsearch_tpu_torch.search.aggregations.spec import AggSpec
from elasticsearch_tpu_torch.utils.errors import IllegalArgumentError


def _bucket_value(bucket: Dict[str, Any], path: str) -> Optional[float]:
    """Resolve 'metric', 'metric.prop' or '_count' within one bucket."""
    if path == "_count":
        return float(bucket["doc_count"])
    name, _, prop = path.partition(".")
    node = bucket.get(name)
    if node is None:
        return None
    if prop:
        return node.get(prop)
    if isinstance(node, dict):
        return node.get("value")
    return None


def _buckets_of(out: Dict[str, Any], agg_name: str) -> List[Dict[str, Any]]:
    node = out.get(agg_name)
    if node is None or "buckets" not in node:
        raise IllegalArgumentError(
            f"buckets_path must reference a multi-bucket aggregation, "
            f"got [{agg_name}]")
    b = node["buckets"]
    return list(b.values()) if isinstance(b, dict) else b


# ---------------------------------------------------------------------------
# sibling pipelines
# ---------------------------------------------------------------------------

def run_pipelines(pipelines: List[AggSpec], out: Dict[str, Any]) -> None:
    for spec in pipelines:
        path = spec.params.get("buckets_path")
        if path is None:
            raise IllegalArgumentError(
                f"pipeline [{spec.name}] requires [buckets_path]")
        agg_name, _, metric_path = str(path).partition(">")
        buckets = _buckets_of(out, agg_name)
        values = [v for v in
                  (_bucket_value(b, metric_path) for b in buckets)
                  if v is not None]
        if spec.type == "avg_bucket":
            out[spec.name] = {
                "value": sum(values) / len(values) if values else None}
        elif spec.type == "sum_bucket":
            out[spec.name] = {"value": float(sum(values))}
        elif spec.type == "min_bucket":
            out[spec.name] = {"value": min(values) if values else None}
        elif spec.type == "max_bucket":
            out[spec.name] = {"value": max(values) if values else None}
        elif spec.type == "stats_bucket":
            if values:
                out[spec.name] = {
                    "count": len(values), "min": min(values),
                    "max": max(values),
                    "avg": sum(values) / len(values),
                    "sum": float(sum(values))}
            else:
                out[spec.name] = {"count": 0, "min": None, "max": None,
                                  "avg": None, "sum": 0.0}
        elif spec.type == "percentiles_bucket":
            from elasticsearch_tpu_torch.search.aggregations.extra import (
                sibling_percentiles_bucket,
            )
            out[spec.name] = sibling_percentiles_bucket(spec, values)
        else:
            raise IllegalArgumentError(
                f"[{spec.type}] is not a sibling pipeline aggregation")


# ---------------------------------------------------------------------------
# parent pipelines (inside a multi-bucket agg)
# ---------------------------------------------------------------------------

def run_parent_pipelines(pipelines: List[AggSpec], parent: AggSpec,
                         node: Dict[str, Any]) -> None:
    for spec in pipelines:
        buckets = node["buckets"]
        blist = list(buckets.values()) if isinstance(buckets, dict) \
            else buckets
        if spec.type == "cumulative_sum":
            _cumulative_sum(spec, blist)
        elif spec.type == "derivative":
            _derivative(spec, blist)
        elif spec.type == "moving_fn":
            _moving_fn(spec, blist)
        elif spec.type == "bucket_script":
            _bucket_script(spec, blist)
        elif spec.type == "bucket_selector":
            blist = _bucket_selector(spec, blist)
            if isinstance(buckets, list):
                node["buckets"] = blist
        elif spec.type == "bucket_sort":
            blist = _bucket_sort(spec, blist)
            if isinstance(buckets, list):
                node["buckets"] = blist
        elif spec.type == "serial_diff":
            from elasticsearch_tpu_torch.search.aggregations.extra import (
                parent_serial_diff,
            )
            parent_serial_diff(spec, blist)
        else:
            raise IllegalArgumentError(
                f"[{spec.type}] is not a parent pipeline aggregation")


def _path_of(spec: AggSpec) -> str:
    path = spec.params.get("buckets_path")
    if path is None:
        raise IllegalArgumentError(
            f"pipeline [{spec.name}] requires [buckets_path]")
    return str(path)


def _cumulative_sum(spec: AggSpec, buckets: List[Dict[str, Any]]) -> None:
    path = _path_of(spec)
    acc = 0.0
    for b in buckets:
        v = _bucket_value(b, path)
        if v is not None:
            acc += v
        b[spec.name] = {"value": acc}


def _derivative(spec: AggSpec, buckets: List[Dict[str, Any]]) -> None:
    path = _path_of(spec)
    prev: Optional[float] = None
    for b in buckets:
        v = _bucket_value(b, path)
        if prev is not None and v is not None:
            b[spec.name] = {"value": v - prev}
        if v is not None:
            prev = v


def _moving_fn(spec: AggSpec, buckets: List[Dict[str, Any]]) -> None:
    path = _path_of(spec)
    window = int(spec.params.get("window", 5))
    script = str(spec.params.get("script", "MovingFunctions.unweightedAvg(values)"))
    series: List[Optional[float]] = [_bucket_value(b, path)
                                     for b in buckets]
    for i, b in enumerate(buckets):
        lo = max(0, i - window)
        values = [v for v in series[lo:i] if v is not None]
        if "max" in script:
            out = max(values) if values else None
        elif "min" in script:
            out = min(values) if values else None
        elif "sum" in script:
            out = float(sum(values)) if values else None
        else:   # unweightedAvg default
            out = (sum(values) / len(values)) if values else None
        b[spec.name] = {"value": out}


def _script_inputs(spec: AggSpec):
    paths = spec.params.get("buckets_path")
    if not isinstance(paths, dict):
        raise IllegalArgumentError(
            f"[{spec.type}] aggregation [{spec.name}] requires a "
            f"buckets_path object mapping variable names to paths")
    script = spec.params.get("script")
    src = script if isinstance(script, str) else \
        (script or {}).get("source")
    if not isinstance(src, str) or not src.strip():
        raise IllegalArgumentError(
            f"[{spec.type}] aggregation [{spec.name}] requires a [script]")
    params = {} if isinstance(script, str) else script.get("params", {})
    return paths, src, params


def _bucket_script(spec: AggSpec, buckets: List[Dict[str, Any]]) -> None:
    paths, src, base_params = _script_inputs(spec)
    from elasticsearch_tpu_torch.script.engine import default_engine
    for b in buckets:
        variables = _bucket_variables(b, paths)
        if variables is None:
            continue
        value = default_engine.execute(
            _as_return(src),
            {"params": {**base_params, **variables}, **variables})
        b[spec.name] = {"value": float(value)}


def _bucket_selector(spec: AggSpec, buckets: List[Dict[str, Any]]
                     ) -> List[Dict[str, Any]]:
    paths, src, base_params = _script_inputs(spec)
    from elasticsearch_tpu_torch.script.engine import default_engine
    kept = []
    for b in buckets:
        variables = _bucket_variables(b, paths)
        if variables is None:
            continue
        keep = default_engine.execute(
            _as_return(src),
            {"params": {**base_params, **variables}, **variables})
        if keep:
            kept.append(b)
    return kept


def _bucket_variables(bucket: Dict[str, Any], paths: Dict[str, Any]
                      ) -> Optional[Dict[str, float]]:
    variables = {}
    for var, path in paths.items():
        v = _bucket_value(bucket, str(path))
        if v is None:
            return None
        variables[var] = v
    return variables


def _as_return(src: str) -> str:
    return src if src.strip().startswith("return") else f"return {src}"


def _bucket_sort(spec: AggSpec, buckets: List[Dict[str, Any]]
                 ) -> List[Dict[str, Any]]:
    sort = spec.params.get("sort", [])
    size = spec.params.get("size")
    from_ = int(spec.params.get("from", 0))
    for entry in reversed(sort if isinstance(sort, list) else [sort]):
        if isinstance(entry, str):
            path, order = entry, "asc"
        else:
            (path, body), = entry.items()
            order = body.get("order", "asc") if isinstance(body, dict) \
                else body
        def keyfn(b, _path=path):
            v = _bucket_value(b, _path)
            return -math.inf if v is None else v
        buckets = sorted(buckets, key=keyfn, reverse=(order == "desc"))
    buckets = buckets[from_:]
    if size is not None:
        buckets = buckets[: int(size)]
    return buckets
