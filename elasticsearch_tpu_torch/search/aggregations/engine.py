"""Aggregation execution engine: shard-side collection + coordinator reduce.

ShardAggregator plugs into the query phase's ``collectors`` hook
(search/phase.py query_shard) — one ``collect`` call per segment with the
device score/mask arrays, mirroring AggregationPhase.collect
(search/aggregations/AggregationPhase.java:40). ``reduce_aggs`` is the
coordinator-side InternalAggregation.reduce analog, followed by pipeline
aggs (pipeline.py).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from elasticsearch_tpu_torch.search.aggregations.buckets import (
    BUCKET_COLLECT, BUCKET_FINALIZE, BUCKET_MERGE,
)
from elasticsearch_tpu_torch.search.aggregations.metrics import (
    METRIC_COLLECT, METRIC_FINALIZE, METRIC_MERGE,
)
from elasticsearch_tpu_torch.search.aggregations.spec import AggSpec
from elasticsearch_tpu_torch.utils.errors import IllegalArgumentError


def collect_one(spec: AggSpec, ctx, mask: np.ndarray, scores) -> Any:
    fn = METRIC_COLLECT.get(spec.type) or BUCKET_COLLECT.get(spec.type)
    if fn is None:
        raise IllegalArgumentError(
            f"aggregation type [{spec.type}] is not executable per shard")
    return fn(spec, ctx, mask, scores)


def merge_one(spec: AggSpec, a: Any, b: Any) -> Any:
    fn = METRIC_MERGE.get(spec.type) or BUCKET_MERGE.get(spec.type)
    return fn(spec, a, b)


def finalize_one(spec: AggSpec, partial: Any) -> Dict[str, Any]:
    fn = METRIC_FINALIZE.get(spec.type) or BUCKET_FINALIZE.get(spec.type)
    return fn(spec, partial)


def empty_partial(spec: AggSpec) -> Any:
    """A neutral partial for shards/segments that produced nothing."""
    if spec.type in BUCKET_COLLECT:
        if spec.type in ("filter", "global", "missing", "nested",
                         "reverse_nested", "sampler",
                         "diversified_sampler"):
            return {"doc_count": 0, "subs": {}}
        return {"buckets": {}}
    if spec.type in ("percentiles", "percentile_ranks",
                     "median_absolute_deviation", "boxplot"):
        return {"samples": [], "count": 0}
    if spec.type == "cardinality":
        return {"kind": "exact", "hashes": []}
    if spec.type == "top_hits":
        return {"hits": [], "total": 0}
    if spec.type == "weighted_avg":
        return {"wsum": 0.0, "w": 0.0}
    if spec.type == "geo_bounds":
        return {"top": None, "bottom": None, "left": None, "right": None}
    if spec.type == "geo_centroid":
        return {"sum_lat": 0.0, "sum_lon": 0.0, "count": 0}
    if spec.type == "string_stats":
        return {"count": 0, "len_sum": 0, "min_len": None,
                "max_len": None, "chars": {}}
    if spec.type == "top_metrics":
        return {"rows": [], "order": "asc"}
    if spec.type == "matrix_stats":
        return {"n": 0, "fields": [], "m1": {}, "m2": {}, "m3": {},
                "m4": {}, "cross": {}}
    if spec.type == "scripted_metric":
        return {"states": []}
    return {"count": 0, "sum": 0.0, "min": None, "max": None,
            "sum_sq": 0.0}


class ShardAggregator:
    """Per-shard collector: fold every segment's partial into shard state.

    Conforms to the query phase's collector interface:
    ``collect(ctx, segment_idx, scores, mask)`` with device arrays.
    """

    def __init__(self, specs: List[AggSpec],
                 preset: Optional[Dict[str, Any]] = None):
        self.specs = [s for s in specs if not s.is_pipeline]
        self.pipeline_specs = [s for s in specs if s.is_pipeline]
        self.state: Dict[str, Any] = {}
        # drain-wide device aggregation (batch_executor plane_aggs): a
        # preset entry IS the whole-shard partial for that spec — the
        # plane kernel already folded every segment, so the per-segment
        # collect skips those specs and ``partial()`` ships the preset
        # through the unchanged merge/finalize
        names = {s.name for s in self.specs}
        self._preset = {k: v for k, v in (preset or {}).items()
                        if k in names}
        self.state.update(self._preset)
        self._collect_specs = [s for s in self.specs
                               if s.name not in self._preset]
        self.preset_served = bool(self._preset)

    def collect(self, ctx, segment_idx: int, scores, mask) -> None:
        n = ctx.segment.n_docs
        # the device mask stays visible to collectors with a device fast
        # path (buckets.py device partial-agg) — host conversion is for
        # the host-side collectors only. The host twin is stashed so the
        # fast paths can verify BY IDENTITY that the mask they were handed
        # is the top-level query mask: a sub-aggregation passes its
        # bucket-intersected mask, which only exists on the host, and the
        # device path must then decline
        ctx._agg_device_mask = mask
        mask_host = mask[:n].cpu().numpy().astype(bool)
        ctx._agg_top_host_mask = mask_host
        scores_host = scores[:n].cpu().numpy()
        for spec in self._collect_specs:
            partial = collect_one(spec, ctx, mask_host, scores_host)
            if spec.name in self.state:
                self.state[spec.name] = merge_one(
                    spec, self.state[spec.name], partial)
            else:
                self.state[spec.name] = partial

    def partial(self) -> Dict[str, Any]:
        """JSON-able shard partial, shipped to the coordinator."""
        out = {}
        for spec in self.specs:
            out[spec.name] = self.state.get(spec.name,
                                            empty_partial(spec))
        return out


def merge_partials(specs: List[AggSpec],
                   partials: List[Dict[str, Any]]) -> Dict[str, Any]:
    merged: Dict[str, Any] = {}
    for spec in specs:
        if spec.is_pipeline:
            continue
        acc = None
        for p in partials:
            if p is None or spec.name not in p:
                continue
            acc = (p[spec.name] if acc is None
                   else merge_one(spec, acc, p[spec.name]))
        merged[spec.name] = acc if acc is not None else empty_partial(spec)
    return merged


def reduce_aggs(specs: List[AggSpec],
                partials: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Shard partials → the final ``aggregations`` response object."""
    from elasticsearch_tpu_torch.search.aggregations.pipeline import run_pipelines
    merged = merge_partials(specs, partials)
    out: Dict[str, Any] = {}
    for spec in specs:
        if spec.is_pipeline:
            continue
        out[spec.name] = finalize_one(spec, merged[spec.name])
        _run_nested_pipelines(spec, out[spec.name])
    run_pipelines([s for s in specs if s.is_pipeline], out)
    return out


def _run_nested_pipelines(spec: AggSpec, node: Dict[str, Any]) -> None:
    """Parent pipelines (derivative, cumulative_sum, …) declared inside a
    multi-bucket agg operate on its finalized bucket list."""
    from elasticsearch_tpu_torch.search.aggregations.pipeline import (
        run_parent_pipelines,
    )
    for sub in spec.subs:
        if sub.is_bucket and "buckets" in node.get(sub.name, {}):
            for bucket in _bucket_list(node[sub.name]):
                _run_nested_pipelines(sub, bucket)
    pipelines = [s for s in spec.subs if s.is_pipeline]
    if pipelines and "buckets" in node:
        run_parent_pipelines(pipelines, spec, node)
    # recurse into own buckets for deeper nesting
    if "buckets" in node:
        for bucket in _bucket_list(node):
            for sub in spec.subs:
                if sub.is_bucket and sub.name in bucket:
                    _run_nested_pipelines(sub, bucket[sub.name])


def _bucket_list(node: Dict[str, Any]) -> List[Dict[str, Any]]:
    b = node.get("buckets")
    if isinstance(b, dict):
        return list(b.values())
    return b or []
