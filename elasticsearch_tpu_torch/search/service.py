"""SearchService: request body -> phases -> response, for one shard.

Reference analog: search/SearchService.java:136. The JAX package's
``search/service.py`` cut to what this package serves: ``_search`` bodies
through the block-max-pruned text collector, the kNN collector and the
dense collector (exact totals, field sorts, ``search_after``,
``min_score``, ``rescore``, ``collapse``, ``slice``, ``profile`` and the
query nodes ``search/execute.py`` serves), the sparse collector for
resolved ``text_expansion`` (a ``model_text`` is expanded first by the
coordinator rewrite, ``ml.text_expansion.rewrite_body_expansions``, on
the service's device), ``aggs`` / ``aggregations`` (a ``ShardAggregator``
collector per request, reduced into the response), and ``_count``.
Scroll, suggest and the query nodes not ported yet raise NotPortedError
(status 501).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from elasticsearch_tpu_torch.device import DeviceLike, resolve_device
from elasticsearch_tpu_torch.index.engine import InternalEngine, Reader
from elasticsearch_tpu_torch.search import dsl, telemetry
from elasticsearch_tpu_torch.search.fetch import fetch_hits
from elasticsearch_tpu_torch.search.phase import (
    ShardQueryResult, parse_sort, query_shard,
)
from elasticsearch_tpu_torch.utils.errors import (
    IllegalArgumentError, NotPortedError,
)


class SearchService:
    """Request body -> query phase -> fetch -> response, for one shard.

    ``device``: where the shard's device arrays live — None means the
    CUDA card (an error when there is none); tests pass "cpu" to run the
    kernels' plain PyTorch versions."""

    def __init__(self, engine: InternalEngine, index_name: str = "index",
                 device: DeviceLike = None):
        self.engine = engine
        self.index_name = index_name
        self.device = resolve_device(device)
        self._last_result: Optional[ShardQueryResult] = None

    # ------------------------------------------------------------------

    def search(self, body: Optional[Dict[str, Any]] = None,
               scroll_keep_alive: Optional[float] = None,
               reader: Optional[Reader] = None,
               doc_count_override: Optional[int] = None,
               df_overrides: Optional[Dict[str, Dict[str, int]]] = None,
               collectors: Optional[List] = None) -> Dict[str, Any]:
        body = body or {}
        t0 = time.monotonic()
        entry_ns = time.monotonic_ns()
        # request [timeout] budget: validated at ENTRY (junk must 400
        # before any query cost is paid, matching the coordinator path's
        # _parse_timeout_seconds), checked at the collection boundary —
        # coarser than the reference's in-collection checks: one shard's
        # whole query either fits the budget or reports timed_out
        budget = None
        if body.get("timeout") is not None:
            from elasticsearch_tpu_torch.utils.settings import (
                parse_time_to_seconds,
            )
            try:
                budget = parse_time_to_seconds(body["timeout"])
            except (TypeError, ValueError):
                raise IllegalArgumentError(
                    f"[timeout] must be a time value, "
                    f"got [{body['timeout']!r}]")
            if budget <= 0:
                raise IllegalArgumentError("[timeout] must be > 0")
        if scroll_keep_alive:
            raise NotPortedError("scroll")
        if body.get("suggest"):
            raise NotPortedError("suggest")
        reader = reader or self.engine.acquire_reader()
        if "text_expansion" in str(body.get("query", "")):
            from elasticsearch_tpu_torch.ml.text_expansion import (
                rewrite_body_expansions,
            )
            body = rewrite_body_expansions(body, self.device)
        query = dsl.parse_query(body.get("query"))

        agg_specs = None
        aggregator = None
        agg_body = body.get("aggs", body.get("aggregations"))
        if agg_body:
            from elasticsearch_tpu_torch.search.aggregations import (
                ShardAggregator, parse_aggs,
            )
            agg_specs = parse_aggs(agg_body)
            aggregator = ShardAggregator(agg_specs)
            collectors = list(collectors or []) + [aggregator]
        size = int(body.get("size", 10))
        from_ = int(body.get("from", 0))
        sort = parse_sort(body.get("sort"))
        search_after = body.get("search_after")
        track = body.get("track_total_hits", 10_000)

        # per-request telemetry (monotonic stamps + counters only; span
        # detail surfaces solely inside the profile block): the
        # single-shard service is the smallest serving path, so its
        # trace carries rewrite / device_dispatch / fetch. The rewrite
        # span runs from ENTRY — expansion rewrite, parse, agg/sort
        # setup above are the work it attributes
        trace = telemetry.SearchTrace(
            telemetry.classify_query_class(query), "solo")
        trace.t0_ns = entry_ns
        trace.add_span("rewrite", time.monotonic_ns() - entry_ns)
        with telemetry.activate(trace), trace.span("device_dispatch"):
            result = query_shard(
                reader, self.engine.mappers, query,
                size=size, from_=from_, sort=sort,
                search_after=search_after,
                track_total_hits=track,
                min_score=body.get("min_score"),
                doc_count_override=doc_count_override,
                df_overrides=df_overrides,
                collectors=collectors,
                rescore=body.get("rescore"),
                collapse=body.get("collapse"),
                slice_spec=body.get("slice"),
                profile=bool(body.get("profile")),
                device=self.device,
            )

        t_fetch = time.monotonic_ns()
        include_sort = body.get("sort") is not None or search_after is not None
        hits = fetch_hits(
            reader, self.engine.mappers, result.docs, self.index_name,
            query=query,
            source_filter=body.get("_source", True),
            docvalue_fields=body.get("docvalue_fields"),
            highlight=body.get("highlight"),
            include_sort=include_sort,
            seq_no_primary_term=bool(body.get("seq_no_primary_term")),
            include_version=bool(body.get("version")),
        )
        cfield = (body.get("collapse") or {}).get("field")
        if cfield:
            for hit, d in zip(hits, result.docs):
                if d.ckey is not None:
                    hit.setdefault("fields", {})[cfield] = [d.ckey]

        timed_out = budget is not None and \
            (time.monotonic() - t0) >= budget

        response: Dict[str, Any] = {
            "took": int((time.monotonic() - t0) * 1000),
            "timed_out": timed_out,
            "_shards": {"total": 1, "successful": 1, "skipped": 0, "failed": 0},
            "hits": {
                "total": {"value": result.total_hits, "relation": result.total_relation},
                "max_score": result.max_score,
                "hits": hits,
            },
        }

        if aggregator is not None:
            from elasticsearch_tpu_torch.search.aggregations import (
                reduce_aggs,
            )
            response["aggregations"] = reduce_aggs(
                agg_specs, [aggregator.partial()])

        trace.add_span("fetch", time.monotonic_ns() - t_fetch)
        trace.finish()
        telemetry.TELEMETRY.observe(trace)
        if result.profile is not None:
            # full span tree per shard rides the profile block ONLY —
            # with profile off the response carries no telemetry keys
            result.profile["telemetry"] = trace.tree()
            response["profile"] = {"shards": [{
                "id": f"[_local][{self.index_name}][0]",
                "searches": [result.profile]}]}

        self._last_result = result
        return response

    def count(self, body: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        body = body or {}
        reader = self.engine.acquire_reader()
        query = dsl.parse_query(body.get("query"))
        result = query_shard(reader, self.engine.mappers, query,
                             size=0, track_total_hits=True,
                             device=self.device)
        return {"count": result.total_hits,
                "_shards": {"total": 1, "successful": 1, "skipped": 0, "failed": 0}}
