"""SearchService: request body -> phases -> response, for one shard.

Reference analog: search/SearchService.java:136 (phase dispatch, scroll
context registry at :203 with keep-alive reaping at :230). The JAX
package's ``search/service.py``: ``_search`` bodies through the
block-max-pruned text collector, the kNN collector and the dense
collector (exact totals, field sorts, ``search_after``, ``min_score``,
``rescore``, ``collapse``, ``slice``, ``profile`` and the query nodes
``search/execute.py`` serves), the sparse collector for resolved
``text_expansion`` (a ``model_text`` is expanded first by the coordinator
rewrite, ``ml.text_expansion.rewrite_body_expansions``, on the service's
device), ``aggs`` / ``aggregations``, scroll and ``_count``; plus the
node's self-reported search pressure (``NodePressure``). Suggest and the
query nodes not ported yet raise NotPortedError (status 501).
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from elasticsearch_tpu_torch.device import DeviceLike, resolve_device
from elasticsearch_tpu_torch.index.engine import InternalEngine, Reader
from elasticsearch_tpu_torch.search import dsl, telemetry
from elasticsearch_tpu_torch.search.fetch import fetch_hits
from elasticsearch_tpu_torch.search.phase import (
    ShardQueryResult, SortSpec, parse_sort, query_shard,
)
from elasticsearch_tpu_torch.utils.errors import (
    IllegalArgumentError, NotPortedError, SearchEngineError,
)


class SearchContextMissingError(SearchEngineError):
    status = 404


class NodePressure:
    """A data node's self-reported search pressure: in-flight member
    count and a service-time EWMA measured inside the shard batcher's
    drains. Snapshots piggyback on every shard query response (the C3
    server-side feedback loop — ResponseCollectorService consumes them
    on the coordinator), so replica selection sees a node SATURATING one
    response before its round trips degrade, and can tell a slow wire
    (service time small, response time large) from a slow node."""

    ALPHA = 0.3

    __slots__ = ("in_flight", "service_ewma_ms", "observations",
                 "occupancy_ewma", "cached_served", "write_ewma",
                 "write_observations")

    def __init__(self) -> None:
        self.in_flight = 0
        self.service_ewma_ms: Optional[float] = None
        self.observations = 0
        # members per drain (EWMA): with the service EWMA this yields the
        # node's drain RATE in members/second — what the shard-side shed
        # point's Little's-law bound and its Retry-After estimates run on
        self.occupancy_ewma: Optional[float] = None
        # request-cache hits answered at intake: served traffic counted
        # into the observation windows (see observe_cached)
        self.cached_served = 0
        # write-pressure utilization EWMA (in-flight indexing bytes over
        # the indexing_pressure.memory.limit): fed by the shard bulk
        # action on every charge/release, piggybacked on search responses
        # so ARS and the shed point see an INGEST-hot node too
        self.write_ewma: Optional[float] = None
        self.write_observations = 0

    def observe(self, service_ms: float, members: int = 1) -> None:
        s = max(float(service_ms), 0.0)
        self.service_ewma_ms = s if self.service_ewma_ms is None else \
            self.ALPHA * s + (1 - self.ALPHA) * self.service_ewma_ms
        m = max(float(members), 1.0)
        self.occupancy_ewma = m if self.occupancy_ewma is None else \
            self.ALPHA * m + (1 - self.ALPHA) * self.occupancy_ewma
        self.observations += 1

    def observe_cached(self) -> None:
        """A request-cache hit served at intake IS served traffic: it
        counts into the pressure tracker's observation windows — without
        consuming a queued-member slot, and without folding its near-zero
        host time into the DRAIN-measured service/occupancy EWMAs. Those
        EWMAs size the member bound (drain_rate x target latency) for
        work that actually queues; letting sub-millisecond hits inflate
        the drain rate would over-admit the very members a hot duplicate
        flood arrives alongside."""
        self.observations += 1
        self.cached_served += 1

    def drain_rate_per_s(self) -> float:
        """Drain-measured throughput estimate: members served per second
        (occupancy EWMA over service-time EWMA). 0.0 until the first
        drain has been observed."""
        if self.service_ewma_ms is None:
            return 0.0
        return (self.occupancy_ewma or 1.0) / \
            (max(self.service_ewma_ms, 1e-3) / 1000.0)

    def retry_after_s(self, backlog: int) -> int:
        """Honest shed backoff: seconds until ``backlog`` members ahead
        of a retry would drain at the measured rate (1s floor, 60s cap —
        the coordinator pool's Retry-After clamp). Cold node: 1s."""
        import math
        rate = self.drain_rate_per_s()
        if rate <= 0.0:
            return 1
        return max(1, min(60, int(math.ceil((backlog + 1) / rate))))

    def observe_write(self, current_bytes: int, limit_bytes: int) -> None:
        """Fold one write-pressure reading (in-flight bytes / limit) into
        the utilization EWMA. Called by TransportShardBulkAction at every
        stage charge/release on this node."""
        if limit_bytes <= 0:
            return
        u = max(0.0, float(current_bytes) / float(limit_bytes))
        self.write_ewma = u if self.write_ewma is None else \
            self.ALPHA * u + (1 - self.ALPHA) * self.write_ewma
        self.write_observations += 1

    def snapshot(self, queue_depth: int) -> Dict[str, Any]:
        """The piggyback payload: current queue depth is the caller's
        (the batcher knows its queued members); EWMA and in-flight are
        this tracker's."""
        return {"queue": int(queue_depth),
                "in_flight": int(self.in_flight),
                "service_ewma_ms": round(self.service_ewma_ms or 0.0, 3),
                "write_pressure": round(self.write_ewma or 0.0, 4)}


@dataclass
class ScrollContext:
    scroll_id: str
    reader: Reader
    body: Dict[str, Any]
    sort: List[SortSpec]
    last_sort_values: Optional[List[Any]]
    keep_alive_until: float
    index_name: str


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
        self._scrolls: Dict[str, ScrollContext] = {}
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
        if body.get("suggest"):
            raise NotPortedError("suggest")
        self.reap_scrolls()
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

        if scroll_keep_alive:
            scroll_id = uuid.uuid4().hex
            self._scrolls[scroll_id] = ScrollContext(
                scroll_id, reader, dict(body), sort,
                self._cursor_of(body, result),
                time.monotonic() + scroll_keep_alive, self.index_name)
            response["_scroll_id"] = scroll_id
        self._last_result = result
        return response

    @staticmethod
    def _cursor_of(body: Dict[str, Any], result: ShardQueryResult):
        """Cursor for the next scroll page. Field sorts use the hit's sort
        values; the default score sort uses (score, segment, doc) — the
        internal tiebreak understood by phase._after."""
        if not result.docs:
            return None
        last = result.docs[-1]
        if body.get("sort") is not None:
            # append (segment, doc) tiebreak so tied sort keys never repeat
            # or drop across pages (phase._after understands the extension)
            return list(last.sort_values) + [last.segment_idx, last.doc]
        return [last.score, last.segment_idx, last.doc]

    # ------------------------------------------------------------------

    def scroll(self, scroll_id: str, keep_alive: Optional[float] = None
               ) -> Dict[str, Any]:
        self.reap_scrolls()
        sc = self._scrolls.get(scroll_id)
        if sc is None:
            raise SearchContextMissingError(f"No search context found for id [{scroll_id}]")
        if sc.last_sort_values is None:
            return self._empty_page(scroll_id)   # exhausted
        body = dict(sc.body)
        body.pop("from", None)
        body["search_after"] = sc.last_sort_values
        response = self.search(body, reader=sc.reader)
        sc.last_sort_values = self._cursor_of(body, self._last_result)
        if keep_alive:
            sc.keep_alive_until = time.monotonic() + keep_alive
        response["_scroll_id"] = scroll_id
        return response

    def clear_scroll(self, scroll_id: str) -> bool:
        return self._scrolls.pop(scroll_id, None) is not None

    def reap_scrolls(self) -> None:
        now = time.monotonic()
        for sid in [s for s, c in self._scrolls.items() if c.keep_alive_until < now]:
            del self._scrolls[sid]

    def _empty_page(self, scroll_id: str) -> Dict[str, Any]:
        return {
            "took": 0, "timed_out": False, "_scroll_id": scroll_id,
            "_shards": {"total": 1, "successful": 1, "skipped": 0, "failed": 0},
            "hits": {"total": {"value": 0, "relation": "eq"},
                     "max_score": None, "hits": []},
        }

    # ------------------------------------------------------------------

    def count(self, body: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        body = body or {}
        reader = self.engine.acquire_reader()
        query = dsl.parse_query(body.get("query"))
        result = query_shard(reader, self.engine.mappers, query,
                             size=0, track_total_hits=True,
                             device=self.device)
        return {"count": result.total_hits,
                "_shards": {"total": 1, "successful": 1, "skipped": 0, "failed": 0}}
