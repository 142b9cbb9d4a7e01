"""Agg request parsing: the ``"aggs"`` body → a typed spec tree.

Reference analog: AggregatorFactories.parseAggregators — each named entry
holds exactly one agg type plus optional nested ``aggs``
(search/aggregations/AggregatorFactories.java).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

from elasticsearch_tpu_torch.utils.errors import IllegalArgumentError

METRIC_TYPES = {
    "avg", "sum", "min", "max", "value_count", "stats", "extended_stats",
    "cardinality", "percentiles", "percentile_ranks", "top_hits",
    "weighted_avg", "median_absolute_deviation",
}
BUCKET_TYPES = {
    "terms", "range", "date_range", "histogram", "date_histogram",
    "filter", "filters", "global", "missing", "composite",
    "significant_terms",
    "significant_text",
}
PIPELINE_TYPES = {
    "avg_bucket", "sum_bucket", "min_bucket", "max_bucket", "stats_bucket",
    "derivative", "cumulative_sum", "bucket_script", "bucket_selector",
    "bucket_sort", "moving_fn",
}
ALL_TYPES = METRIC_TYPES | BUCKET_TYPES | PIPELINE_TYPES


@dataclass
class AggSpec:
    name: str
    type: str
    params: Dict[str, Any]
    subs: List["AggSpec"] = field(default_factory=list)

    @property
    def is_pipeline(self) -> bool:
        return self.type in PIPELINE_TYPES

    @property
    def is_bucket(self) -> bool:
        return self.type in BUCKET_TYPES


def parse_aggs(body: Any) -> List[AggSpec]:
    """Parse an ``aggs``/``aggregations`` mapping into spec trees."""
    if not body:
        return []
    if not isinstance(body, dict):
        raise IllegalArgumentError("aggregations must be an object")
    out: List[AggSpec] = []
    for name, entry in body.items():
        if not isinstance(entry, dict):
            raise IllegalArgumentError(
                f"aggregation [{name}] must be an object")
        sub_body = entry.get("aggs", entry.get("aggregations"))
        type_keys = [k for k in entry
                     if k not in ("aggs", "aggregations", "meta")]
        if len(type_keys) != 1:
            raise IllegalArgumentError(
                f"aggregation [{name}] must define exactly one type, "
                f"got {type_keys}")
        agg_type = type_keys[0]
        if agg_type not in ALL_TYPES:
            raise IllegalArgumentError(
                f"unknown aggregation type [{agg_type}] for [{name}]")
        params = entry[agg_type]
        if params is None:
            params = {}
        if not isinstance(params, dict):
            raise IllegalArgumentError(
                f"aggregation [{name}] body must be an object")
        subs = parse_aggs(sub_body)
        if agg_type in PIPELINE_TYPES and subs:
            raise IllegalArgumentError(
                f"pipeline aggregation [{name}] cannot have sub-aggregations")
        if agg_type in METRIC_TYPES and subs:
            raise IllegalArgumentError(
                f"metric aggregation [{name}] cannot have sub-aggregations")
        out.append(AggSpec(name=name, type=agg_type, params=params,
                           subs=subs))
    return out
