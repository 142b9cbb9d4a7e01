"""Aggregations: two-level framework — per-shard collection over segment
columns, coordinator-side reduce, then pipeline aggs.

Reference analogs: search/aggregations/AggregatorBase.java:41 (per-shard
collection), InternalAggregation.java:227 (``reduce()`` tree merge at the
coordinator), pipeline reduce :212. The TPU-first divergence: collection is
not a per-doc collector callback chain but masked columnar reductions over a
segment's doc-value arrays — the shape XLA fuses into single reduction
kernels when the columns are device-resident.

Protocol per agg type (registered in metrics.py / buckets.py):
    collect(spec, ctx, mask, scores) -> partial     (one segment)
    merge(spec, a, b) -> partial                    (segments AND shards)
    finalize(spec, partial) -> response node        (coordinator)
Partials are plain JSON-able Python so they cross the transport unchanged.
Pipeline aggs (pipeline.py) run after finalize on the reduced tree.
"""

from elasticsearch_tpu_torch.search.aggregations.spec import AggSpec, parse_aggs
from elasticsearch_tpu_torch.search.aggregations.engine import (
    ShardAggregator, merge_partials, reduce_aggs,
)
# importing extra registers the round-3 agg types into the maps
from elasticsearch_tpu_torch.search.aggregations import extra  # noqa: F401,E402

__all__ = [
    "AggSpec", "parse_aggs", "ShardAggregator", "merge_partials",
    "reduce_aggs",
]
