"""Distributed search: scatter-gather coordination over shard copies.

Reference analogs: action/search/TransportSearchAction.java:88 (resolve
indices → shard iterators → async phases), AbstractSearchAsyncAction.java:68
(fan-out with per-shard failure accounting), CanMatchPreFilterSearchPhase.java:57
(cheap pre-filter skipping non-matching shards), SearchPhaseController.java:160
(k-way merge of per-shard top docs), DfsPhase.java:43 (global term stats),
FetchSearchPhase (doc fetch from winning shards only), and the per-phase wire
actions of SearchTransportService.java:72-79. Reader contexts pin a
point-in-time view between query and fetch (SearchService contexts :203).
"""

from __future__ import annotations

import copy
import functools
import json
import time
import uuid as uuid_mod
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.cluster.state import ClusterState
from elasticsearch_tpu_torch.index.engine import Reader
from elasticsearch_tpu_torch.indices.indices_service import IndicesService
from elasticsearch_tpu_torch.search import dsl
from elasticsearch_tpu_torch.search.fetch import fetch_hits
from elasticsearch_tpu_torch.search import telemetry
from elasticsearch_tpu_torch.search.phase import (
    ShardDoc, collect_query_terms, parse_sort, query_shard,
    shard_field_stats, shard_term_stats,
)
from elasticsearch_tpu_torch.search.telemetry import TELEMETRY, SearchTrace
from elasticsearch_tpu_torch.transport.transport import TransportService
from elasticsearch_tpu_torch.utils.errors import (
    IllegalArgumentError, IndexNotFoundError, NotPortedError,
    SearchEngineError, shard_busy_info,
)
from elasticsearch_tpu_torch.utils.retry import RetryableAction


class _AllCopiesShed(Exception):
    """Internal: every copy of one shard shed ``shard_busy`` inside one
    failover round — the only outcome that surfaces the busy signal to
    the caller (as a 429-status shard failure / request). ``retry_after``
    is the LEAST-LOADED copy's estimate: the minimum across the round's
    sheds, i.e. the soonest ANY copy's measured drain rate expects
    headroom."""

    def __init__(self, n_copies: int, retry_after: int):
        super().__init__(
            f"all {n_copies} copies shed the query (shard_busy); "
            f"retry_after={retry_after}s")
        self.n_copies = n_copies
        self.retry_after = retry_after

SEARCH_CAN_MATCH = "indices:data/read/search[can_match]"
SEARCH_DFS = "indices:data/read/search[phase/dfs]"
SEARCH_QUERY = "indices:data/read/search[phase/query]"

# per-search bound on in-flight shard query requests
# (SearchRequest.DEFAULT_MAX_CONCURRENT_SHARD_REQUESTS)
DEFAULT_MAX_CONCURRENT_SHARD_REQUESTS = 5


def _parse_max_concurrent(raw) -> Optional[int]:
    """Validated at request entry: junk must 400, and a non-positive
    value must not wedge the fan-out into dispatching nothing."""
    if raw is None:
        return None
    try:
        value = int(raw)
    except (TypeError, ValueError):
        raise IllegalArgumentError(
            f"[max_concurrent_shard_requests] must be a positive "
            f"integer, got [{raw!r}]")
    if value < 1:
        raise IllegalArgumentError(
            "[max_concurrent_shard_requests] must be >= 1")
    return value


def _parse_allow_partial(raw) -> Optional[bool]:
    """Request-level allow_partial_search_results; None = defer to the
    search.default_allow_partial_results cluster setting."""
    if raw is None:
        return None
    if isinstance(raw, bool):
        return raw
    text = str(raw).lower()
    if text in ("true", "1", "yes"):
        return True
    if text in ("false", "0", "no"):
        return False
    raise IllegalArgumentError(
        f"[allow_partial_search_results] must be a boolean, got [{raw!r}]")


def _parse_timeout_seconds(raw) -> Optional[float]:
    """Request time budget ('100ms', '2s', seconds-number); None = none."""
    if raw is None:
        return None
    from elasticsearch_tpu_torch.utils.settings import parse_time_to_seconds
    try:
        value = parse_time_to_seconds(raw)
    except (TypeError, ValueError):
        raise IllegalArgumentError(
            f"[timeout] must be a time value, got [{raw!r}]")
    if value <= 0:
        raise IllegalArgumentError("[timeout] must be > 0")
    return value
SEARCH_FETCH = "indices:data/read/search[phase/fetch]"
# cross-cluster search: a remote coordinator executes the whole search
# for its clusters' indices and returns the final response
# (RemoteClusterService.java:65 + SearchResponseMerger.java)
SEARCH_CCS = "indices:data/read/search[ccs]"

CONTEXT_KEEP_ALIVE = 60.0

DoneFn = Callable[[Optional[Dict[str, Any]], Optional[Exception]], None]


def _task_phase(phase_state: Dict[str, Any], phase: str,
                plane: Optional[str] = None) -> None:
    """Live phase visibility: in-flight searches show their current
    phase + chosen data plane in ``GET /_tasks`` (the reference's task
    status payloads). A dict assignment per transition — no allocation
    beyond the payload, no locking (status is a read-mostly snapshot).
    ``plane`` overrides for in-flight routing verdicts the response
    must not yet carry (a mesh-queued fan-out can still fall back)."""
    task = phase_state.get("task")
    if task is not None:
        task.status = {
            "phase": phase,
            "data_plane": plane or phase_state.get("data_plane")
            or "fanout"}


import logging

logger = logging.getLogger(__name__)
_slowlog = logging.getLogger("index.search.slowlog")


class SearchTransportService:
    """Data-node side: executes the per-shard search phases."""

    def __init__(self, node_id: str, indices: IndicesService,
                 ts: TransportService, task_manager=None,
                 state_supplier=None):
        self.node_id = node_id
        self.indices = indices
        self.ts = ts
        self.task_manager = task_manager
        # cluster-state access for index-level settings (frozen checks);
        # None in unit tests driving the shard phases directly
        self.state = state_supplier
        self._contexts: Dict[str, Tuple[Reader, float]] = {}
        # shard request cache (indices/request_cache.py — the reference's
        # IndicesRequestCache rebuilt on generation stamps): response
        # rows keyed by (shard, engine search generation, normalized
        # plan), charged to the request_cache breaker child, LRU-bounded
        # by search.request_cache.max_bytes, invalidation typed by the
        # engine-recorded cause of every generation move
        from elasticsearch_tpu_torch.indices.request_cache import (
            ShardRequestCache,
        )
        self.request_cache = ShardRequestCache()
        # adaptive cross-query micro-batcher (search/batch_executor.py):
        # eligible shard queries coalesce into single batched device
        # programs; search.batch.enabled=false restores the solo path
        from elasticsearch_tpu_torch.search.batch_executor import (
            ShardQueryBatcher,
        )
        self.batcher = ShardQueryBatcher(self)
        # mesh-sharded SPMD fan-out executor (search/mesh_executor.py):
        # a co-located fan-out whose shards' planes are resident on the
        # local device mesh runs as ONE compiled program per phase;
        # search.mesh.enabled=false restores the RPC scatter-gather
        from elasticsearch_tpu_torch.search.mesh_executor import (
            MeshSearchExecutor,
        )
        self.mesh_executor = MeshSearchExecutor(self)
        ts.register_handler(SEARCH_CAN_MATCH, self._on_can_match)
        ts.register_handler(SEARCH_DFS, self._on_dfs)
        ts.register_handler(SEARCH_QUERY, self._on_query)
        ts.register_handler(SEARCH_FETCH, self._on_fetch)

    def _now(self) -> float:
        # scheduler time, so virtual-time simulations reap deterministically
        return self.ts.transport.scheduler.now()

    def _reap(self) -> None:
        now = self._now()
        for cid in [c for c, (_, exp) in self._contexts.items() if exp < now]:
            del self._contexts[cid]

    # ------------------------------------------------------------------

    def _on_can_match(self, req: Dict[str, Any], sender: str
                      ) -> Dict[str, Any]:
        shard = self.indices.shard(req["index"], req["shard"])
        query = dsl.parse_query(req.get("body", {}).get("query"))
        from elasticsearch_tpu_torch.search.phase import contains_term_expansion
        if not collect_query_terms(query) or \
                contains_term_expansion(query):
            # dictionary-expanded queries (prefix etc.) can match terms
            # their literal text never names — df pre-filtering would
            # produce false negatives
            return {"can_match": True}
        reader = shard.engine.acquire_reader()
        # a shard can produce hits only if at least one (analyzed) query
        # term exists in its term dictionaries — df aggregation gives us
        # exactly that, cheaply (no scoring)
        _, dfs = shard_term_stats(reader, shard.engine.mappers, query)
        can = any(df > 0 for termmap in dfs.values()
                  for df in termmap.values())
        # buffered docs aren't searchable; a refresh may change the answer,
        # but false negatives are impossible for *searchable* data
        return {"can_match": bool(can)}

    def _on_dfs(self, req: Dict[str, Any], sender: str) -> Dict[str, Any]:
        shard = self.indices.shard(req["index"], req["shard"])
        reader = shard.engine.acquire_reader()
        query = dsl.parse_query(req.get("body", {}).get("query"))
        doc_count, dfs = shard_term_stats(reader, shard.engine.mappers,
                                          query)
        field_stats = shard_field_stats(reader, shard.engine.mappers, query)
        return {"doc_count": doc_count, "dfs": dfs,
                "field_stats": field_stats}

    def _cache_coverage(self, body: Dict[str, Any], window: int) -> bool:
        """Delegates to THE shared cacheability predicate
        (``_CacheTier.covers`` — one rule set for both tiers, so
        coverage can never drift between the shard and coordinator
        caches)."""
        return self.request_cache.covers(body, window)

    def _cache_norm_key(self, req: Dict[str, Any]) -> str:
        """The normalized plan: body (minus the cache directive itself)
        plus everything else that changes what the shard computes —
        window and the DFS stat overrides."""
        body = req.get("body") or {}
        if "request_cache" in body:
            body = {k: v for k, v in body.items()
                    if k != "request_cache"}
        return json.dumps(
            [body, req.get("window", 0), req.get("df_overrides"),
             req.get("doc_count_override"),
             req.get("field_stats_overrides")],
            sort_keys=True, default=str)

    def request_cache_lookup(self, req: Dict[str, Any],
                             arrival_ns: Optional[int] = None
                             ) -> Optional[Dict[str, Any]]:
        """Intake-time request-cache consult (the batcher calls this for
        EVERY arriving query, before classification): a cacheable
        duplicate over an unmoved generation answers immediately —
        no collection window, no reader probe, no device dispatch. The
        generation stamp makes the freshness check ONE attribute read
        (``engine.search_generation``); only a window>0 hit pays a
        reader acquisition, to pin the fetch-phase context. None = miss
        (or not cacheable); the drain fills the cache."""
        entry_ns = time.monotonic_ns()
        body = req.get("body") or {}
        window = int(req.get("window", 0) or 0)
        if not self._cache_coverage(body, window):
            return None
        shard = self.indices.shard(req["index"], req["shard"])
        engine = shard.engine
        generation = engine.search_generation
        cached = self.request_cache.get(
            (req["index"], req["shard"]), generation,
            self._cache_norm_key(req),
            cause=lambda: engine.search_generation_cause)
        if cached is None:
            return None
        context_id = None
        if window > 0:
            # the fetch phase needs a pinned point-in-time reader; the
            # acquisition must still see the generation the entry was
            # filled at (a racing refresh degrades to a miss — and
            # un-counts the tier hit the probe already recorded, so
            # hit_rate reflects requests actually SERVED from cache)
            reader = engine.acquire_reader()
            if reader.generation != generation:
                rc = self.request_cache
                rc.stats["hits"] = max(rc.stats["hits"] - 1, 0)
                rc.stats["misses"] += 1
                return None
            context_id = uuid_mod.uuid4().hex
            self._contexts[context_id] = (
                reader, self._now() + CONTEXT_KEEP_ALIVE)
        cached = {**cached, "context_id": context_id}
        shard.search_stats["request_cache_hits"] += 1
        # cache hits are served traffic too: without this the cheapest
        # executions vanish from the rings and the histogram p50/p95
        # skew upward. Classed pre-parse (the body-shape classifier), no
        # device_dispatch span — the hit's own span name keeps it out of
        # dispatch percentiles. Labeled "batch" like every other query
        # on the unified path, so one cache-hit class never splits
        # across histogram keys by where the hit landed
        trace = SearchTrace(telemetry.classify_body(body), "batch")
        trace.t0_ns = arrival_ns or entry_ns
        trace.add_span("queue_wait", entry_ns - (arrival_ns or entry_ns))
        trace.add_span("request_cache_hit",
                       time.monotonic_ns() - entry_ns)
        trace.finish()
        TELEMETRY.observe(trace)
        return cached

    def request_cache_fill(self, req: Dict[str, Any],
                           row: Dict[str, Any], reader) -> None:
        """Fill one executed response row (the batcher's shared-kind
        demux calls this per unique plan): the entry is stamped with the
        generation of the READER that computed it, so a later hit can
        only serve the exact searchable state the probe's generation
        names. The stored row never carries a context — a hit pins its
        own fresh reader."""
        body = req.get("body") or {}
        window = int(req.get("window", 0) or 0)
        if not self._cache_coverage(body, window):
            return
        generation = getattr(reader, "generation", None)
        if generation is None:
            return
        shard = self.indices.shard(req["index"], req["shard"])
        shard.search_stats["request_cache_misses"] += 1
        self.request_cache.put(
            (req["index"], req["shard"]), generation,
            self._cache_norm_key(req), {**row, "context_id": None},
            cause=lambda: shard.engine.search_generation_cause)

    def _slow_log(self, req: Dict[str, Any], took_s: float,
                  trace: Optional[SearchTrace] = None) -> None:
        """Per-index search slow log (index/SearchSlowLog.java:43 analog):
        thresholds come from dynamic index settings. When the shard's
        telemetry trace is available the line carries the full phase
        breakdown and chosen data plane, so a slow query explains itself
        without a re-run under profile."""
        try:
            settings = self.indices.index_service(
                req["index"]).metadata.settings
        except Exception:  # noqa: BLE001 — logging must never fail a query
            return
        from elasticsearch_tpu_torch.utils.settings import parse_time_to_seconds
        for level in ("warn", "info"):
            raw = settings.get(
                f"index.search.slowlog.threshold.query.{level}")
            if raw is None:
                continue
            if took_s >= parse_time_to_seconds(raw):
                getattr(_slowlog, "warning" if level == "warn" else "info")(
                    "[%s][%s] took[%.1fms], %s source[%s]",
                    req["index"], req["shard"], took_s * 1e3,
                    (trace.summary() + "," if trace is not None else ""),
                    str(req.get("body", {}))[:512])
                return

    def _on_query(self, req: Dict[str, Any], sender: str):
        arrival_ns = time.monotonic_ns()
        self._reap()
        # refresh the plane registry's and device observatory's dynamic
        # config from committed cluster settings (search.plane.* /
        # search.device_profile.storm_*) — cheap version-memoized reads;
        # every execution kind below consults the registry
        if self.state is not None:
            from elasticsearch_tpu_torch.ops.device_segment import PLANES
            from elasticsearch_tpu_torch.search.device_profile import (
                DEVICE_PROFILE,
            )
            state = self.state()
            PLANES.configure_from_state(state)
            DEVICE_PROFILE.configure_from_state(state)
            self.request_cache.configure_from_state(state)
        # THE shard execution path: every query is a batch member
        # (occupancy-1 keys drain on the next tick, so an isolated query
        # pays one scheduler hop; `search.batch.enabled: false` forces
        # window 0 through the same path). There is no solo handler.
        return self.batcher.enqueue(req, arrival_ns=arrival_ns)

    def execute_query_member(self, req: Dict[str, Any], reader, *,
                             cancel_check=None, trace=None,
                             started_wall: Optional[float] = None,
                             meta_out: Optional[Dict[str, Any]] = None,
                             preset_aggs: Optional[Dict[str, Any]] = None
                             ) -> Dict[str, Any]:
        """Execute ONE shard query over a provided reader snapshot — the
        per-member body of the batcher's ``dense`` kind (and the only
        way a shard query executes outside the shared device kernels).
        The caller (the drain) owns the reader acquisition, the member's
        task registration, queue-wait attribution, and error delivery;
        this method owns parse -> query_shard -> response shape, the
        request-cache fill, stats, telemetry spans, the slow log and
        frozen-index eviction."""
        t_query = started_wall if started_wall is not None \
            else time.monotonic()
        entry_ns = time.monotonic_ns()
        shard = self.indices.shard(req["index"], req["shard"])
        body = req.get("body", {})
        window = int(req.get("window", 0) or 0)
        generation = getattr(reader, "generation", None)
        cache_state = None
        if generation is not None and self._cache_coverage(body, window):
            shard_key = (req["index"], req["shard"])
            norm_key = self._cache_norm_key(req)
            cached = self.request_cache.get(
                shard_key, generation, norm_key,
                cause=lambda: shard.engine.search_generation_cause)
            if cached is not None:
                # filled between this member's intake miss and its drain
                shard.search_stats["request_cache_hits"] += 1
                context_id = None
                if window > 0:
                    # the hit pins its own context over the DRAIN's
                    # reader — the same generation the entry names
                    context_id = uuid_mod.uuid4().hex
                    self._contexts[context_id] = (
                        reader, self._now() + CONTEXT_KEEP_ALIVE)
                cached = {**cached, "context_id": context_id}
                if meta_out is not None:
                    # the drain's memo fan-out mirrors this branch's
                    # accounting for the row's duplicates
                    meta_out["cache_hit"] = True
                if trace is not None:
                    trace.add_span("request_cache_hit",
                                   time.monotonic_ns() - entry_ns)
                    trace.finish()
                    TELEMETRY.observe(trace)
                return cached
            shard.search_stats["request_cache_misses"] += 1
            cache_state = (shard_key, generation, norm_key)
        query = dsl.parse_query(body.get("query"))
        sort = parse_sort(body.get("sort"))
        if trace is None:
            trace = SearchTrace(telemetry.classify_query_class(query),
                                "solo")
            trace.t0_ns = entry_ns
        trace.add_span("rewrite", time.monotonic_ns() - entry_ns)

        aggregator = None
        agg_body = body.get("aggs", body.get("aggregations"))
        if agg_body:
            from elasticsearch_tpu_torch.search.aggregations import (
                ShardAggregator, parse_aggs,
            )
            aggregator = ShardAggregator(parse_aggs(agg_body),
                                         preset=preset_aggs)
            if aggregator.preset_served and trace is not None:
                # >=1 spec rides the drain-wide columns-plane partials
                # (search/plane_aggs.py): this member served on the
                # dense_device data plane — the label shows on the
                # trace, the slow log, _tasks and the latency
                # histograms, NEVER in the response body
                trace.data_plane = "dense_device"

        with telemetry.activate(trace), trace.span("device_dispatch"):
            result = query_shard(
                reader, shard.engine.mappers, query,
                size=req["window"], from_=0, sort=sort,
                search_after=body.get("search_after"),
                track_total_hits=body.get("track_total_hits", 10_000),
                min_score=body.get("min_score"),
                doc_count_override=req.get("doc_count_override"),
                df_overrides=req.get("df_overrides"),
                field_stats_overrides=req.get("field_stats_overrides"),
                collectors=[aggregator] if aggregator else None,
                rescore=body.get("rescore"),
                collapse=body.get("collapse"),
                slice_spec=body.get("slice"),
                profile=bool(body.get("profile")),
                terminate_after=body.get("terminate_after"),
                cancel_check=cancel_check,
                device=shard.search.device)
        t_demux = time.monotonic_ns()
        stats = shard.search_stats
        stats["query_total"] += 1
        if result.collector == "wand_topk" and result.prune_stats:
            stats["wand_queries"] += 1
            stats["wand_blocks_total"] += result.prune_stats[0]
            stats["wand_blocks_scored"] += result.prune_stats[1]
        context_id = None
        if req["window"] > 0:
            # size=0 (count) searches never fetch: don't pin a reader
            context_id = uuid_mod.uuid4().hex
            self._contexts[context_id] = (reader,
                                          self._now() + CONTEXT_KEEP_ALIVE)
        response = {
            "context_id": context_id,
            "total": result.total_hits,
            "relation": result.total_relation,
            "max_score": result.max_score,
            "collector": result.collector,
            "prune": list(result.prune_stats) if result.prune_stats else None,
            "docs": [{"segment": d.segment_idx, "doc": d.doc,
                      "score": d.score, "sort": list(d.sort_values),
                      **({"ckey": d.ckey} if d.ckey is not None else {})}
                     for d in result.docs],
            "terminated": result.terminated_early,
            "aggs_partial": aggregator.partial() if aggregator else None,
            "suggest_partial": (
                _suggest_partial(reader, shard.engine.mappers, body)
                if body.get("suggest") else None),
            "profile": result.profile,
        }
        if cache_state is not None:
            self.request_cache.put(
                *cache_state, {**response, "context_id": None},
                cause=lambda: shard.engine.search_generation_cause)
        trace.add_span("demux", time.monotonic_ns() - t_demux)
        trace.finish()
        TELEMETRY.observe(trace)
        if result.profile is not None:
            # full span detail rides the profile block ONLY (the
            # byte-invisibility contract: profile-off responses carry no
            # telemetry keys on any path)
            result.profile["telemetry"] = trace.tree()
        self._slow_log(req, time.monotonic() - t_query, trace=trace)
        # frozen index: device/HBM residency lasts one search — evict the
        # segment caches rebuilt during this query (FrozenEngine's
        # per-search reader analog)
        from elasticsearch_tpu_torch.xpack.searchable_snapshots import (
            evict_device_caches, is_frozen,
        )
        if self.state is not None and \
                is_frozen(self.state(), req["index"]):
            evict_device_caches(reader)
        return response

    def _fetch_shard(self, req: Dict[str, Any]):
        """The shard instance a fetch context was pinned on. Mesh-served
        fan-outs pin coordinator-local contexts on mesh-MEMBER copies
        (the request's ``served_by``); the host backend reaches that
        copy exactly as the mesh executor did at query time. Plain RPC
        fetches carry no ``served_by`` and stay strictly local."""
        served_by = req.get("served_by")
        if served_by and served_by != self.node_id:
            from elasticsearch_tpu_torch.parallel.mesh import host_backend
            backend = host_backend()
            if backend is not None:
                svc = backend.indices_of(served_by)
                if svc is not None and svc.has_shard(req["index"],
                                                     req["shard"]):
                    return svc.shard(req["index"], req["shard"])
        return self.indices.shard(req["index"], req["shard"])

    def _on_fetch(self, req: Dict[str, Any], sender: str) -> Dict[str, Any]:
        self._reap()
        # fetch is the context's last use: release it (the reference frees
        # query contexts once the fetch phase completes)
        entry = self._contexts.pop(req["context_id"], None)
        if entry is not None:
            reader = entry[0]
        else:
            # context expired: re-acquire (results may shift post-merge;
            # the reference fails the request — we degrade gracefully)
            shard_obj = self._fetch_shard(req)
            reader = shard_obj.engine.acquire_reader()
        shard = self._fetch_shard(req)
        body = req.get("body", {})
        docs = [ShardDoc(d["segment"], d["doc"], d["score"],
                         tuple(d.get("sort", ())))
                for d in req["docs"]]
        query = dsl.parse_query(body.get("query"))
        hits = fetch_hits(
            reader, shard.engine.mappers, docs, req["index"],
            query=query,
            source_filter=body.get("_source", True),
            docvalue_fields=body.get("docvalue_fields"),
            highlight=body.get("highlight"),
            include_sort=body.get("sort") is not None
            or body.get("search_after") is not None,
            seq_no_primary_term=bool(body.get("seq_no_primary_term")),
            include_version=bool(body.get("version")),
        )
        # script fields run host-side per fetched doc (FieldScript context)
        script_fields = body.get("script_fields")
        if script_fields:
            from elasticsearch_tpu_torch.script.engine import execute_field_script
            for hit, doc in zip(hits, docs):
                fields = hit.setdefault("fields", {})
                for fname, spec in script_fields.items():
                    src = hit.get("_source") or {}
                    value = execute_field_script(
                        spec.get("script", spec), src, src)
                    fields[fname] = [value]
        # matched_queries (MatchedQueriesPhase.java:43): every _name-tagged
        # clause runs once per segment; each hit reports the names whose
        # mask covers it
        named = dsl.collect_named_queries(body.get("query"))
        if named:
            self._annotate_matched_queries(reader, shard, named, docs,
                                           hits)
        return {"hits": hits}

    def _annotate_matched_queries(self, reader, shard, named, docs,
                                  hits) -> None:
        from elasticsearch_tpu_torch.search.execute import (
            SegmentContext, execute,
        )
        needed = {d.segment_idx for d in docs}
        parsed = []
        for name, clause in named:
            try:
                parsed.append((name, dsl.parse_query(clause)))
            except Exception:  # noqa: BLE001 — a clause that cannot
                # parse standalone just never matches
                continue
        masks: Dict[Tuple[int, str], np.ndarray] = {}
        for si in needed:
            seg = reader.segments[si]
            ctx = SegmentContext(seg, shard.engine.mappers,
                                 segment_idx=si, reader=reader,
                                 device=shard.search.device)
            for name, q in parsed:
                try:
                    _, m = execute(q, ctx)
                    masks[(si, name)] = m.cpu().numpy()
                except Exception:  # noqa: BLE001 — execution quirk:
                    # the clause never matches in this segment
                    continue
        for hit, doc in zip(hits, docs):
            matched = [name for name, _c in named
                       if (doc.segment_idx, name) in masks
                       and bool(masks[(doc.segment_idx, name)][doc.doc])]
            if matched:
                hit["matched_queries"] = matched


class RrfFusionBatcher:
    """Coordinator-side hybrid-fusion coalescing: concurrent RRF
    requests whose retriever legs complete in the same scheduler tick
    fuse in ONE ``rrf_fuse_batch`` launch (ops/fusion.py, K24) over
    [B, R, K] ranked lists instead of B independent fusions.

    Contract with the caller: ``submit`` hands over each retriever's
    ranked list encoded into a request-local dense id space and a
    ``done(candidate_ids, error)`` callback. The kernel returns every
    scored doc of every request (k covers the whole candidate pool, so
    nothing is cut at a float32 boundary); the caller re-attaches its
    exact host-precision scores to those candidates, which keeps the
    response byte-identical to the host-only path. ``done(None, None)``
    means "fuse on the host yourself": batching is disabled, the one
    route counted in ``rrf_fuse_fallbacks``. A kernel that fails to build
    or launch is not hidden behind host fusion: ``done(None, error)``
    fails each request of the batch with an error naming the kernel
    (the JAX package fuses on the host instead)."""

    # sub-ms collection window: retriever legs of concurrent hybrid
    # requests finish a few scheduler ticks apart (their shard fan-outs
    # resolve independently), so a same-tick-only drain misses most of
    # the coalescing win. Half a millisecond is invisible next to a
    # fan-out round trip and catches the whole completion cluster. The
    # window only opens while fusion traffic is RECENT (the shard
    # batcher's idle-drain discipline) — an isolated hybrid search
    # still fuses on the next tick.
    FUSE_WINDOW_S = 0.0005
    FUSE_RECENCY_S = 0.004

    def __init__(self, ts: TransportService, enabled_fn, device=None):
        self.ts = ts
        self.enabled = enabled_fn
        # where the fusion kernel runs (None = the CUDA card)
        self.device = device
        self._queue: List[Dict[str, Any]] = []
        self._timer = None
        self._last_drain: Optional[float] = None
        self.stats: Dict[str, float] = {
            "rrf_fuse_batches": 0,
            "rrf_fuse_requests": 0,
            "rrf_fuse_max_occupancy": 0,
            "rrf_fuse_fallbacks": 0,
        }

    def submit(self, doc_lists: List[List[int]], n_docs: int,
               rank_constant: int, done) -> None:
        try:
            enabled = self.enabled()
        except Exception:  # noqa: BLE001 — no committed state yet
            enabled = True
        if not enabled or n_docs <= 0:
            if n_docs > 0:
                self.stats["rrf_fuse_fallbacks"] += 1
            done(None, None)
            return
        self._queue.append({"lists": doc_lists, "n_docs": n_docs,
                            "rank_constant": rank_constant, "done": done})
        if self._timer is None:
            # recent fusion traffic opens the sub-ms window (everything
            # completing inside it fuses in one launch); an idle fuser
            # drains on the next tick — which still coalesces same-tick
            # submissions already in the dispatch queue
            scheduler = self.ts.transport.scheduler
            recent = self._last_drain is not None and \
                (scheduler.now() - self._last_drain) <= \
                self.FUSE_RECENCY_S
            self._timer = scheduler.schedule(
                self.FUSE_WINDOW_S if recent else 0.0, self._drain)

    def _drain(self) -> None:
        self._timer = None
        self._last_drain = self.ts.transport.scheduler.now()
        batch, self._queue = self._queue, []
        if not batch:
            return
        by_rc: Dict[int, List[Dict[str, Any]]] = {}
        for entry in batch:
            by_rc.setdefault(int(entry["rank_constant"]), []).append(entry)
        for rank_constant, entries in sorted(by_rc.items()):
            self._fuse_group(rank_constant, entries)

    def _fuse_group(self, rank_constant: int,
                    entries: List[Dict[str, Any]]) -> None:
        import torch

        from elasticsearch_tpu_torch.device import resolve_device
        from elasticsearch_tpu_torch.index.segment import next_pow2
        from elasticsearch_tpu_torch.ops.fusion import rrf_fuse_batch
        b = len(entries)
        r = max(2, max(len(e["lists"]) for e in entries))
        k_list = max([1] + [len(lst) for e in entries
                            for lst in e["lists"]])
        # pow2 pads on every varying axis keep the launch shapes few
        b_pad = next_pow2(b, minimum=1)
        k_pad = next_pow2(k_list, minimum=8)
        n_pad = next_pow2(max(e["n_docs"] for e in entries), minimum=8)
        # k covers the whole candidate pool (<= r * k_pad list slots,
        # clamped to the id space): every scored doc comes back, so the
        # kernel's selection can never drop a host-boundary candidate
        k_dev = min(n_pad, r * k_pad)
        arr = np.full((b_pad, r, k_pad), -1, np.int32)
        for bi, e in enumerate(entries):
            for ri, lst in enumerate(e["lists"]):
                if lst:
                    arr[bi, ri, : len(lst)] = lst
        t_dev = time.monotonic_ns()
        try:
            lists = torch.as_tensor(arr,
                                    device=resolve_device(self.device))
            _scores, docs = rrf_fuse_batch(lists, n_pad, k_dev,
                                           rank_constant)
            docs = docs.cpu().numpy()
        except Exception as e:  # noqa: BLE001 — the drain must keep
            # running: the failure is recorded and surfaced to every
            # request of the batch, never hidden behind host fusion
            logger.exception("rrf_fuse_batch failed for %d requests", b)
            err = SearchEngineError(
                f"[rrf_fuse_batch] fusion kernel failed: {e}")
            for entry in entries:
                try:
                    entry["done"](None, err)
                except Exception:  # noqa: BLE001
                    logger.exception("rrf fusion failure delivery failed")
            return
        # the fusion drain runs on a scheduler tick outside any one
        # request's context: its device time lands in the shared
        # histogram directly (one coalesced launch for B requests)
        TELEMETRY.observe_span("hybrid", "fanout", "rrf_fuse_device",
                               time.monotonic_ns() - t_dev)
        self.stats["rrf_fuse_batches"] += 1
        self.stats["rrf_fuse_requests"] += b
        self.stats["rrf_fuse_max_occupancy"] = max(
            self.stats["rrf_fuse_max_occupancy"], b)
        for bi, e in enumerate(entries):
            row = [int(d) for d in docs[bi] if d >= 0]
            try:
                e["done"](row, None)
            except Exception:  # noqa: BLE001 — one request's
                # downstream failure must not strand its batch-mates
                logger.exception("rrf fusion completion failed")


class TransportSearchAction:
    """Coordinating-node side: resolve → (can_match) → (dfs) → query →
    merge → fetch → respond."""

    def __init__(self, node_id: str, ts: TransportService,
                 state_supplier: Callable[[], ClusterState],
                 task_manager=None, indices: Optional[IndicesService] = None,
                 mesh_plane=None, thread_pool=None, remote_clusters=None,
                 search_transport=None, device=None):
        self.node_id = node_id
        # where the coordinator's own device work runs (the text_expansion
        # rewrite and the RRF fusion kernel); None = the CUDA card
        self.device = device
        self.ts = ts
        self.state = state_supplier
        self.task_manager = task_manager
        self.remote_clusters = remote_clusters
        # the local data-node side (reader contexts + the mesh-sharded
        # fan-out executor); None in coordinator-only unit tests
        self.search_transport = search_transport
        if remote_clusters is not None:
            # serve CCS requests arriving FROM other clusters
            ts.register_handler(SEARCH_CCS, self._on_ccs)
        # coordinator-side search admission (None in unit tests)
        self.thread_pool = thread_pool
        # SPMD fast path (parallel/mesh_plane.py): when this node drives a
        # multi-device mesh and holds every shard of the index, eligible
        # queries run as ONE compiled program instead of the RPC fan-out
        self.indices = indices
        self.mesh_plane = mesh_plane
        self._rr = 0
        # adaptive replica selection (ResponseCollectorService.java:179):
        # rank copies by observed EWMA round-trip + in-flight count
        from elasticsearch_tpu_torch.action.response_collector import (
            ResponseCollectorService,
        )
        self.response_collector = ResponseCollectorService()
        # hybrid RRF fusion batcher: concurrent requests' fusions
        # coalesce into one rrf_fuse_batch device dispatch
        self.rrf_fuser = RrfFusionBatcher(ts, self._batch_enabled,
                                          device=device)
        # coordinator fused-result cache (indices/request_cache.py): an
        # identical co-located fan-out answers from its fused response
        # with ZERO shard dispatches, stamped with the participating
        # shards' generation vector so any member moving invalidates it
        from elasticsearch_tpu_torch.indices.request_cache import (
            FusedResultCache,
        )
        self.fused_cache = FusedResultCache()
        # shard_busy failover observability — the coordinator half of
        # the two-sided shed contract, surfaced under
        # search_admission.shard_busy_failover in _nodes/stats
        self.shard_busy_stats: Dict[str, int] = {
            "sheds_seen": 0,       # shard_busy rejections received
            "failovers": 0,        # sheds routed to the next ranked copy
            "retry_rounds": 0,     # backed-off re-walks of a copy list
            "all_copies_shed": 0,  # shards surfaced as 429 failures
        }
        # admission tenant resolution memo (one cluster-state version's
        # expression -> concrete-indices mappings; rebuilt on version
        # change so index creation/deletion re-keys tenants immediately)
        self._tenant_cache: Dict[str, str] = {}
        self._tenant_cache_version: Optional[int] = None

    # shard_busy failover policy: within a round, a shed fails over to
    # the next C3-ranked copy immediately (a sibling may have headroom
    # RIGHT NOW); a round where EVERY copy shed backs off with equal
    # jitter (RetryableAction) and re-walks the re-ranked list — bounded
    # by rounds and by the request's own time budget
    SHARD_BUSY_MAX_ROUNDS = 3
    SHARD_BUSY_RETRY_INITIAL_S = 0.05
    SHARD_BUSY_RETRY_MAX_S = 0.5
    SHARD_BUSY_RETRY_TIMEOUT_S = 10.0

    def _admission_tenant(self, index_expression: str) -> str:
        """The fair-admission tenant key: the index expression RESOLVED
        to its concrete indices (sorted, comma-joined) so ``logs*`` and
        ``logs-1,logs-2`` count as ONE tenant and neither can dodge fair
        shedding by rephrasing the same target set. Falls back to the
        raw expression when no cluster state is available (early boot,
        coordinator-only tests) or the expression names unknown/remote
        indices — admission must never fail on the tenant key. Memoized
        per cluster-state version (the resolve cost is measured in the
        overload bench line)."""
        raw = index_expression or "_all"
        try:
            state = self.state() if self.state is not None else None
            if state is None:
                return raw
            version = getattr(state, "version", None)
            if version != self._tenant_cache_version:
                self._tenant_cache = {}
                self._tenant_cache_version = version
            got = self._tenant_cache.get(raw)
            if got is None:
                try:
                    from elasticsearch_tpu_torch.cluster.metadata import (
                        resolve_index_expression,
                    )
                    names = resolve_index_expression(index_expression,
                                                     state.metadata)
                    got = ",".join(names) if names else raw
                except Exception:  # noqa: BLE001 — unknown/remote/
                    got = raw      # expression quirk: raw still buckets
                # the FALLBACK memoizes too: a flood of requests for a
                # deleted index must not pay an uncached resolve+raise
                # per admission at the coordinator's hottest chokepoint
                if len(self._tenant_cache) < 512:
                    self._tenant_cache[raw] = got
            return got
        except Exception:  # noqa: BLE001 — no readable state
            return raw

    def _batch_enabled(self) -> bool:
        """Mirrors ShardQueryBatcher's read of search.batch.enabled from
        committed cluster state (one toggle governs shard-level query
        batching AND coordinator-level fusion batching)."""
        from elasticsearch_tpu_torch.utils.settings import (
            SEARCH_BATCH_ENABLED, setting_from_state,
        )
        state = self.state() if self.state is not None else None
        return setting_from_state(state, SEARCH_BATCH_ENABLED)

    def _fused_cache_probe(self, expression: str, body: Dict[str, Any],
                           targets, search_type: str
                           ) -> Optional[Dict[str, Any]]:
        """Probe the coordinator fused-result cache for this fan-out.
        Returns None when the request is not coordinator-cacheable, else
        {"key", "vector", "hit"}: the cache key (concrete-indices tenant
        key + normalized request), the participating shards' CURRENT
        generation vector — readable without an RPC only because every
        target shard is locally present (the mesh co-location shape;
        anything else counts ``not_colocated`` and serves uncached) —
        and the cached fused response, if the vector still matches.
        Coverage mirrors the shard tier (size=0 by default, top-k behind
        the ``topk`` gate / per-request opt-in); requests carrying a
        [timeout] budget stay uncached — their responses are
        legitimately nondeterministic."""
        try:
            if self.indices is None or not targets:
                return None
            cache = self.fused_cache
            cache.configure_from_state(
                self.state() if self.state is not None else None)
            window = int(body.get("size", 10)) + int(body.get("from", 0))
            # the shared coverage predicate; this tier additionally
            # refuses [timeout]-carrying bodies (EXCLUDE_BUDGETED)
            if not cache.covers(body, window):
                return None
            vector = []
            for target in targets:
                if target.get("alias_filter") is not None:
                    return None
                if not self.indices.has_shard(target["index"],
                                              target["shard"]):
                    cache.stats["not_colocated"] += 1
                    return None
                vector.append((
                    target["index"], target["shard"],
                    self.indices.shard(target["index"],
                                       target["shard"]).search_generation))
            key_body = {k: v for k, v in body.items()
                        if k != "request_cache"}
            key = (self._admission_tenant(expression),
                   json.dumps([key_body, search_type], sort_keys=True,
                              default=str))
            vector = tuple(vector)
            return {"key": key, "vector": vector,
                    "hit": cache.get(key, vector,
                                     self._generation_cause_of)}
        except Exception:  # noqa: BLE001 — the cache probe must never
            return None    # fail (or mis-route) a search

    def _generation_cause_of(self, shard_key) -> str:
        """Typed invalidation attribution: the cause the MOVED shard's
        engine recorded for its latest generation move."""
        try:
            return self.indices.shard(
                shard_key[0], shard_key[1]).engine.search_generation_cause
        except Exception:  # noqa: BLE001 — shard gone mid-probe
            return "restore"

    def _fused_cache_fill(self, ctx: Dict[str, Any],
                          resp: Dict[str, Any]) -> None:
        """Fill with a CLEAN fused response only (no shard failures, no
        expired budget — a degraded response must never become the
        cached answer), stamped with the generation vector read at
        probe time: a shard that moved mid-fan-out leaves an entry no
        future vector can match, never a stale hit."""
        shards = resp.get("_shards") or {}
        if shards.get("failed") or resp.get("timed_out"):
            return
        stored = {k: v for k, v in resp.items()
                  if k not in ("took", "_data_plane")}
        self.fused_cache.put(ctx["key"], ctx["vector"],
                             copy.deepcopy(stored))

    # adaptive per-copy shard-query transport timeout: a copy with an
    # ARS response EWMA times out at 30x that EWMA (clamped to the
    # floor/ceiling settings) — a stalled copy fails over in RTT-scale
    # time; an unknown copy keeps the ceiling (the old flat 60s)
    SHARD_TIMEOUT_EWMA_MULTIPLE = 30.0

    def _shard_query_timeout(self, node: str, floor_s: float,
                             ceiling_s: float,
                             budget_left_s: Optional[float],
                             has_failover: bool = True) -> float:
        # the adaptive timeout exists to FAIL OVER in RTT-scale time;
        # with no sibling copy left to try, abandoning a slow-but-alive
        # copy early (a first-dispatch compile can legitimately run
        # multi-second) only converts success into a shard failure —
        # the last copy keeps the ceiling
        ewma_s = self.response_collector.response_ewma_s(node)
        timeout = ceiling_s if ewma_s is None or not has_failover else \
            min(ceiling_s,
                max(floor_s, ewma_s * self.SHARD_TIMEOUT_EWMA_MULTIPLE))
        if budget_left_s is not None:
            # the budget timer OWNS deadline semantics: the transport
            # timeout lands strictly after it (+50ms), so an expiry
            # surfaces as the guaranteed timed_out:true partial, never
            # a same-instant copy-timeout race that reads as a shard
            # failure
            timeout = min(timeout, max(budget_left_s, 0.0) + 0.05)
        return max(timeout, 1e-3)

    def _default_allow_partial(self, state: ClusterState) -> bool:
        """Cluster-wide default (search.default_allow_partial_results,
        dynamic via _cluster/settings persistent updates)."""
        from elasticsearch_tpu_torch.utils.settings import (
            SEARCH_DEFAULT_ALLOW_PARTIAL_RESULTS,
        )
        raw = state.metadata.persistent_settings.get(
            SEARCH_DEFAULT_ALLOW_PARTIAL_RESULTS.key)
        if raw is None:
            return True
        try:
            return SEARCH_DEFAULT_ALLOW_PARTIAL_RESULTS.parse(raw)
        except Exception:  # noqa: BLE001 — unparseable operator value:
            return True    # fail toward availability, like the default

    # ------------------------------------------------------------------
    # index/shard resolution
    # ------------------------------------------------------------------

    def _resolve_indices(self, expression: str,
                         state: ClusterState,
                         ignore_throttled: bool = True) -> List[str]:
        """Comma lists, `*` wildcards, `_all`, aliases
        (IndexNameExpressionResolver analog). Frozen indices are excluded
        from WILDCARD expansion unless ignore_throttled=false — explicit
        names always resolve (the reference's search-time default)."""
        from elasticsearch_tpu_torch.cluster.metadata import (
            resolve_index_expression,
        )
        names = resolve_index_expression(expression, state.metadata)
        # per-part discipline, computed ONCE and shared by the closed
        # and frozen filters: a part is wildcard-like when it expands
        # (*, _all, empty); explicit parts protect/indict their targets
        parts = [p.strip() for p in (expression or "").split(",")]
        has_wildcard = any(not p or "*" in p or p == "_all"
                           for p in parts) or not expression
        explicit_concrete: set = set()
        for part in parts:
            if not part or "*" in part or part == "_all":
                continue
            explicit_concrete.add(part)
            try:
                explicit_concrete.update(resolve_index_expression(
                    part, state.metadata))
            except Exception:  # noqa: BLE001 — unknown part
                pass
        # closed indices: skipped by wildcard-like parts, a 400 when
        # reached through an EXPLICIT part (IndexClosedException)
        open_names = []
        for n in names:
            if state.metadata.indices[n].state == "close":
                if n in explicit_concrete or not has_wildcard:
                    raise IllegalArgumentError(
                        f"closed index [{n}] cannot be searched "
                        f"(index_closed_exception)")
                continue
            open_names.append(n)
        names = open_names
        if ignore_throttled and has_wildcard:
            from elasticsearch_tpu_torch.xpack.searchable_snapshots import (
                is_frozen,
            )
            # explicit parts protect their targets — including indices
            # reached through an explicitly named ALIAS (shared
            # explicit_concrete set computed above)
            names = [n for n in names
                     if n in explicit_concrete or not is_frozen(state, n)]
        return names

    def _shard_targets(self, indices: List[str], state: ClusterState
                       ) -> List[Dict[str, Any]]:
        """One target per shard with an ordered list of copies to try —
        the shard iterator (GroupShardsIterator): a failed copy fails over
        to the next (AbstractSearchAsyncAction.onShardFailure)."""
        from elasticsearch_tpu_torch.utils.settings import (
            CLUSTER_USE_ADAPTIVE_REPLICA_SELECTION, setting_from_state,
        )
        use_ars = setting_from_state(
            state, CLUSTER_USE_ADAPTIVE_REPLICA_SELECTION)
        # C3's `clients` term reads the DATA-NODE count off cluster
        # state (the reference's ResponseCollectorService contract) —
        # not this coordinator's tracked-node count, which undercounts
        # until every data node has answered at least one query
        self.response_collector.set_data_node_count(
            sum(1 for n in state.nodes.values() if n.is_data))
        targets = []
        for index in indices:
            if not state.routing_table.has_index(index):
                continue
            irt = state.routing_table.index(index)
            for sid in sorted(irt.shards):
                copies = [sr.node_id for sr in irt.shard_group(sid)
                          if sr.active and sr.node_id is not None]
                if not copies:
                    raise SearchEngineError(
                        f"no active copy for [{index}][{sid}]")
                # round-robin rotation first (fairness among equals), then
                # the adaptive rank reorders once real observations exist
                # (cluster.routing.use_adaptive_replica_selection=false
                # keeps pure rotation — the chaos baseline)
                self._rr += 1
                rot = self._rr % len(copies)
                copies = copies[rot:] + copies[:rot]
                if use_ars:
                    copies = self.response_collector.order_copies(copies)
                targets.append({"index": index, "shard": sid,
                                "node": copies[0], "copies": copies})
        if use_ars and targets:
            # recovery decay, once per SEARCH (not per shard): nodes
            # that held copies but won no shard drift back into
            # contention so a healed node isn't starved forever
            winners = {t["node"] for t in targets}
            losers = {c for t in targets
                      for c in t["copies"]} - winners
            if losers:
                self.response_collector.decay_unselected(winners, losers)
        return targets

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------

    def _refresh_admission(self) -> None:
        """Apply the dynamic search.admission.* settings to the search
        pool when the cluster state has CHANGED since the last search
        (version-keyed — the hot admission path pays one attribute
        compare, not a settings scan + four parses per request). Pools
        left untouched when the operator has set NONE of the keys, so
        test harnesses that size pools directly keep their
        configuration."""
        try:
            state = self.state() if self.state is not None else None
            if state is None:
                return
            version = getattr(state, "version", None)
            if version is not None and \
                    version == getattr(self, "_admission_version", None):
                return
            self._admission_version = version
            settings = state.metadata.persistent_settings
            present = any(str(k).startswith("search.admission.")
                          for k in settings)
            if not present:
                if not getattr(self, "_admission_applied", False):
                    # never configured through settings: keep hands off
                    # pools sized directly (test harnesses)
                    return
                # the operator REMOVED the keys: fall through once so
                # setting_from_state re-applies the documented defaults
            self._admission_applied = present
            from elasticsearch_tpu_torch.utils.settings import (
                SEARCH_ADMISSION_FRAME, SEARCH_ADMISSION_QUEUE_MAX,
                SEARCH_ADMISSION_QUEUE_MIN,
                SEARCH_ADMISSION_TARGET_LATENCY, setting_from_state,
            )
            self.thread_pool.configure_search_admission(
                target_latency_s=setting_from_state(
                    state, SEARCH_ADMISSION_TARGET_LATENCY),
                min_queue=setting_from_state(
                    state, SEARCH_ADMISSION_QUEUE_MIN),
                max_queue=setting_from_state(
                    state, SEARCH_ADMISSION_QUEUE_MAX),
                frame_size=setting_from_state(
                    state, SEARCH_ADMISSION_FRAME))
        except Exception:  # noqa: BLE001 — a bad admission setting must
            pass           # never fail (or wedge) the serving path

    def execute(self, index_expression: str, body: Dict[str, Any],
                on_done: DoneFn, search_type: str = "query_then_fetch"
                ) -> None:
        # coordinator-side admission: the whole async search occupies one
        # "search" pool slot — runs inline when a slot is free, queues
        # within per-tenant-fair bounds, 429s (with a computed
        # Retry-After) beyond them. Shedding binds HERE, at fan-out
        # entry: a saturated node refuses NEW searches while every
        # already-admitted fan-out runs to completion undisturbed.
        if body.get("suggest"):
            # search/suggest.py is not ported yet: refused before any
            # fan-out (the shard side refuses too, in _suggest_partial)
            on_done(None, NotPortedError("suggest"))
            return
        if self.thread_pool is None:
            self._execute_admitted(index_expression, body, on_done,
                                   search_type)
            return
        self._refresh_admission()
        released = {"done": False}
        inner_admit = on_done

        def releasing_done(resp, err):
            if not released["done"]:
                released["done"] = True
                self.thread_pool.release("search")
            inner_admit(resp, err)

        def admitted_task() -> None:
            # the slot is held from here: ANY synchronous escape must
            # release it through releasing_done or the pool wedges
            try:
                self._execute_admitted(index_expression, body,
                                       releasing_done, search_type)
            except Exception as e:  # noqa: BLE001
                releasing_done(None, e)

        try:
            # the tenant key is the RESOLVED index expression: one hot
            # index's flood fills only its fair share of the queue
            # however the client spells the target set, and a queued
            # hot-tenant search can be DISPLACED (on_reject fires) to
            # admit a starved background tenant
            self.thread_pool.submit(
                "search", admitted_task,
                tenant=self._admission_tenant(index_expression),
                on_reject=lambda e: inner_admit(None, e))
        except Exception as e:  # noqa: BLE001 — backpressure
            inner_admit(None, e)

    def _execute_admitted(self, index_expression: str,
                          body: Dict[str, Any], on_done: DoneFn,
                          search_type: str = "query_then_fetch") -> None:
        t0 = time.monotonic()
        entry_ns = time.monotonic_ns()
        state = self.state()
        body = body or {}

        task = None
        if self.task_manager is not None:
            task = self.task_manager.register(
                "indices:data/read/search",
                f"search [{index_expression}]", cancellable=True)
            inner = on_done

            def on_done(resp, err):   # noqa: F811 — task-scoped wrapper
                self.task_manager.unregister(task)
                inner(resp, err)

        # malformed composite-clause SHAPES must 400 here, before any
        # dispatch dereferences them (a "rank": "rrf" string would
        # otherwise AttributeError into a 500 — ADVICE r5)
        try:
            _validate_composite_shapes(body)
            allow_partial = _parse_allow_partial(
                body.get("allow_partial_search_results"))
            budget = _parse_timeout_seconds(body.get("timeout"))
        except SearchEngineError as e:
            on_done(None, e)
            return
        if allow_partial is None:
            allow_partial = self._default_allow_partial(state)

        # composite paths AFTER task registration so CCS/RRF requests get
        # the same parent cancellable task as every other search
        if ":" in (index_expression or "") and \
                self.remote_clusters is not None:
            self._execute_ccs(t0, index_expression, body, on_done,
                              search_type)
            return
        if (body.get("rank") or {}).get("rrf") is not None:
            self._execute_rrf(t0, index_expression, body, on_done,
                              search_type)
            return

        # coordinator telemetry: request-level phase spans (rewrite /
        # can-match / query fan-out / merge / fetch), classed by body
        # shape (identical pre/post expansion rewrite), labeled by the
        # routing decision at finalize. Anchored at handler entry and
        # built BEFORE the rewrite work so the rewrite span measures
        # validation/resolve/alias/expansion time and the expansion's
        # device dispatch is attributed to the request
        ctrace = SearchTrace(telemetry.classify_body(body), "fanout")
        ctrace.t0_ns = entry_ns

        try:
            max_concurrent = _parse_max_concurrent(
                body.get("max_concurrent_shard_requests"))
            indices = self._resolve_indices(
                index_expression, state,
                ignore_throttled=body.get("ignore_throttled", True))
            # filtered aliases (AliasMetadata.filter): applied PER
            # TARGET INDEX like the reference — a shard of a filtered
            # index sees its alias filter(s) OR'ed; shards of plain
            # indices in the same expression stay unfiltered. An index
            # reached BOTH through a filtered alias and by its own name
            # stays unfiltered (the name grants full access).
            filters_by_index: Dict[str, List[Dict[str, Any]]] = {}
            direct = {p.strip() for p in
                      (index_expression or "").split(",")}
            for _alias, iname, filt in state.metadata.alias_filters(
                    index_expression):
                if iname in direct:
                    continue
                filters_by_index.setdefault(iname, []).append(filt)
            targets = self._shard_targets(indices, state)
            for target in targets:
                filters = filters_by_index.get(target["index"])
                if filters:
                    target["alias_filter"] = filters[0] \
                        if len(filters) == 1 else \
                        {"bool": {"should": filters,
                                  "minimum_should_match": 1}}
            # coordinator fused-result cache: a duplicate co-located
            # fan-out answers NOW — no expansion rewrite, no can-match,
            # no shard dispatch; a miss arms the fill so THIS fan-out's
            # clean fused response becomes the next duplicate's answer
            fused_ctx = self._fused_cache_probe(index_expression, body,
                                                targets, search_type)
            if fused_ctx is not None:
                hit = fused_ctx.pop("hit", None)
                if hit is not None:
                    resp = {**copy.deepcopy(hit),
                            "took": int((time.monotonic() - t0) * 1000)}
                    # observable end-to-end: the histogram entry lands
                    # under (class x "cached"). The response itself is
                    # byte-identical to the RPC fan-out's, modulo took —
                    # and modulo the _data_plane marker a mesh-served
                    # original would carry (stripped at fill; the
                    # established mesh golden contract is "modulo
                    # took/_data_plane")
                    ctrace.data_plane = "cached"
                    ctrace.add_span("request_cache_hit",
                                    time.monotonic_ns() - entry_ns)
                    ctrace.finish()
                    TELEMETRY.observe(ctrace)
                    on_done(resp, None)
                    return
                inner_done = on_done

                def caching_done(resp, err, _ctx=fused_ctx,
                                 _inner=inner_done):
                    if err is None and isinstance(resp, dict):
                        try:
                            self._fused_cache_fill(_ctx, resp)
                        except Exception:  # noqa: BLE001 — the fill
                            pass           # must never fail a response
                    _inner(resp, err)
                on_done = caching_done
            # coordinator-side inference rewrite: text_expansion model_text
            # becomes tokens ONCE per request (one batched device dispatch),
            # never per shard/segment — TextExpansionQueryBuilder.doRewrite
            from elasticsearch_tpu_torch.ml.text_expansion import (
                rewrite_body_expansions,
            )
            with telemetry.activate(ctrace):
                body = rewrite_body_expansions(body, self.device)
        except SearchEngineError as e:
            on_done(None, e)
            return
        if not targets:
            on_done(self._empty_response(t0, 0), None)
            return

        size = int(body.get("size", 10))
        from_ = int(body.get("from", 0))
        window = size + from_

        scheduler = self.ts.transport.scheduler
        ctrace.add_span("rewrite", time.monotonic_ns() - entry_ns)
        phase_state = {
            "skipped": 0, "failed": 0,
            "failures": [],
            "task": task,
            "task_id": task.task_id if task is not None else None,
            "max_concurrent_shard_requests": max_concurrent,
            "trace": ctrace,
            # graceful degradation knobs: per-shard failures after replica
            # failover either degrade the response (failures listed in
            # _shards) or fail the whole request, and the time budget
            # bounds how long the query fan-out may run
            "allow_partial": allow_partial,
            "deadline": (scheduler.now() + budget
                         if budget is not None else None),
        }
        _task_phase(phase_state, "can_match")

        if self._try_mesh_path(t0, indices, targets, body, window, from_,
                               size, phase_state, on_done):
            return

        t_can_match = time.monotonic_ns()

        def after_can_match(live_targets: List[Dict[str, Any]]) -> None:
            ctrace.add_span("can_match",
                            time.monotonic_ns() - t_can_match)
            if not live_targets:
                on_done(self._finalize(t0, [], body, phase_state,
                                       len(targets), total=0,
                                       relation="eq", max_score=None,
                                       hits=[]), None)
                return
            if search_type == "dfs_query_then_fetch":
                def run_dfs(overrides: Dict[str, Any]) -> None:
                    def run_query() -> None:
                        self._query_phase(t0, live_targets, body, window,
                                          from_, size, phase_state,
                                          len(targets), on_done, overrides)
                    # DFS fan-outs ride the mesh too: the coordinator's
                    # global df/avgdl land in every shard context of ONE
                    # mesh program per phase instead of a per-shard RPC
                    # fan-out; any miss re-enters the RPC query phase
                    # with the same overrides
                    if self._try_mesh_sharded_path(
                            t0, live_targets, body, window, from_, size,
                            phase_state, len(targets), on_done, run_query,
                            dfs_overrides=overrides):
                        return
                    run_query()
                self._dfs_phase(live_targets, body, run_dfs)
                return

            def run_query() -> None:
                self._query_phase(t0, live_targets, body, window, from_,
                                  size, phase_state, len(targets), on_done,
                                  None)

            # mesh-sharded SPMD path: a co-located fan-out (every target
            # shard's plane resident on this node's device mesh) scores as
            # ONE compiled program per phase; any miss falls back to the
            # per-shard scatter-gather, exactly like a plane miss. Runs
            # AFTER can-match so _shards.skipped is identical to the RPC
            # fan-out's and the mesh only scores surviving shards.
            if search_type == "query_then_fetch":
                if self._try_mesh_sharded_path(t0, live_targets, body,
                                               window, from_, size,
                                               phase_state, len(targets),
                                               on_done, run_query):
                    return
            run_query()

        self._can_match_phase(targets, body, phase_state, after_can_match)

    # -- mesh-sharded plane path (SPMD over co-located shards) -----------

    def _try_mesh_sharded_path(self, t0, targets, body, window, from_,
                               size, phase_state, n_total_shards, on_done,
                               fallback, dfs_overrides=None) -> bool:
        """Submit the fan-out to the mesh executor; True = submitted (it
        answers through ``on_done`` or re-enters ``fallback`` on a mesh
        miss). ``targets`` are the can-match survivors;
        ``n_total_shards`` the pre-can-match shard count for _shards
        accounting. Conditions beyond the executor's own eligibility: one
        concrete index, no per-shard alias filters, and >= 2 targets (a
        single shard's plane already serves in one program). Requests
        with a [timeout] budget ARE mesh-eligible: the coordinator
        deadline rides into the executor, whose check_members seam
        re-checks it between mesh dispatches (the shard-side
        between-segments discipline) and hands expired fan-outs back to
        the RPC path, where the budget machinery produces the partial
        response."""
        if self.search_transport is None:
            return False
        if len(targets) < 2:
            TELEMETRY.count_fallback(telemetry.MESH_TOO_FEW_SHARDS)
            return False
        index = targets[0]["index"]
        if any(t["index"] != index or t.get("alias_filter") is not None
               for t in targets):
            TELEMETRY.count_fallback(telemetry.MESH_ALIAS_OR_MULTI_INDEX)
            return False
        scheduler = self.ts.transport.scheduler
        t_sent = scheduler.now()

        def on_results(results) -> None:
            if results is None:
                fallback()
                return
            # mesh-served fan-outs are VISIBLE to ARS (PR 10 follow-up):
            # synthesize the per-shard observations the RPC path would
            # have produced — one on_send/on_response pair per target,
            # carrying the serving node's own pressure as the piggyback
            # — so a mesh-serving node's saturation is never invisible
            # to replica selection the moment a mesh spans nodes
            self._observe_mesh_serving(targets,
                                       scheduler.now() - t_sent, results)
            phase_state["data_plane"] = "mesh_plane"
            for target in targets:
                target["node"] = self.node_id    # fetch runs locally
            self._merge_and_fetch(t0, targets, results, body, from_,
                                  size, phase_state, n_total_shards,
                                  on_done)

        submitted = self.search_transport.mesh_executor.try_submit(
            index, targets, body, window, phase_state.get("task"),
            on_results, deadline=phase_state.get("deadline"),
            dfs_overrides=dfs_overrides)
        if submitted:
            phase_state["_t_query_ns"] = time.monotonic_ns()
            _task_phase(phase_state, "query", plane="mesh")
        return submitted

    def _observe_mesh_serving(self, targets, rtt_s: float,
                              results=None) -> None:
        """Feed ARS one synthesized per-shard observation per mesh-served
        target, attributed per serving HOST: each observation lands on
        the node whose copy the mesh actually scored (the synthesized
        response's ``served_by``), carrying THAT node's pressure
        snapshot — local from this batcher's tracker, remote via the
        host backend — exactly the piggyback an RPC shard response from
        that node would have carried. So on a multi-host mesh a
        saturated member host is visible to replica selection per host,
        not smeared into the coordinator's figures."""
        if self.search_transport is None:
            return
        try:
            from elasticsearch_tpu_torch.parallel.mesh import host_backend
            backend = host_backend()
            batcher = self.search_transport.batcher
            local_snap = batcher.node_pressure.snapshot(
                batcher.queue_depth())
            snaps: Dict[str, Any] = {self.node_id: local_snap}
            for i, _t in enumerate(targets):
                node = self.node_id
                if results is not None and i < len(results):
                    node = results[i].get("served_by") or self.node_id
                snap = snaps.get(node)
                if snap is None:
                    remote = backend.pressure_snapshot(node) \
                        if backend is not None else None
                    snap = snaps[node] = remote or local_snap
                self.response_collector.on_send(node)
                self.response_collector.on_response(
                    node, rtt_s,
                    service_ms=snap.get("service_ewma_ms"),
                    queue_depth=snap.get("queue"))
        except Exception:  # noqa: BLE001 — observability must never
            pass           # fail a served search

    # -- mesh one-program path ------------------------------------------

    def _try_mesh_path(self, t0, indices, targets, body, window, from_,
                       size, phase_state, on_done) -> bool:
        """Route the whole-index query through the SPMD mesh program when
        possible (parallel/mesh_plane.py); True = handled. Conditions: one
        index, every shard locally present, eligible query shape, mesh
        available. Any failure falls back to the RPC scatter-gather."""
        if self.mesh_plane is None or self.indices is None:
            return False
        if len(indices) != 1:
            return False
        from elasticsearch_tpu_torch.parallel.mesh_plane import mesh_eligible
        spec = mesh_eligible(body)
        if spec is None or not self.mesh_plane.available:
            return False
        field = spec["field"]
        index = indices[0]
        # the shard-side member bound governs this mesh path too (the
        # mesh executor's try_submit discipline): a node over its bound
        # refuses the fast path so the RPC fan-out's shed + failover
        # machinery applies — the bound cannot be dodged by being
        # mesh-served on EITHER mesh path
        batcher = self.search_transport.batcher \
            if self.search_transport is not None else None
        if batcher is not None and batcher.at_member_bound():
            TELEMETRY.count_fallback(telemetry.MESH_NODE_BUSY)
            return False
        shards: Dict[int, Any] = {}
        for target in targets:
            if target["index"] != index or \
                    not self.indices.has_shard(index, target["shard"]):
                return False
            shards[target["shard"]] = self.indices.shard(
                index, target["shard"])
        t_sent = self.ts.transport.scheduler.now()
        t_wall = time.monotonic_ns()
        # mesh-plane work counts into the node's pressure tracker like
        # every other serving path, so the piggybacks, the member bound
        # and the drain-rate estimates see it
        if batcher is not None:
            batcher.node_pressure.in_flight += 1
        try:
            try:
                mappers = self.indices.index_service(index).mapper_service
                kind = spec["kind"]
                if kind == "text":
                    if mappers.field_type(field) not in (
                            "text", "search_as_you_type"):
                        return False
                    result = self.mesh_plane.search_text(
                        index, field, shards, body, mappers,
                        clauses=spec["clauses"])
                elif kind == "knn":
                    if mappers.field_type(field) != "dense_vector":
                        return False
                    result = self.mesh_plane.search_knn(
                        index, field, shards, body, spec["query"])
                elif kind == "sparse":
                    if mappers.field_type(field) not in ("rank_features",
                                                         "rank_feature"):
                        return False
                    result = self.mesh_plane.search_sparse(
                        index, field, shards, body, spec["query"])
                else:
                    return False
            except Exception:  # noqa: BLE001 — RPC reports real errors
                # graceful degradation: the broken mesh program escapes
                # to the host-RPC scatter-gather, observably -- and never
                # silently: a failed kernel is an error of the card
                logger.exception("mesh data plane failed for a [%s] "
                                 "search on [%s][%s]; falling back to the "
                                 "per-shard fan-out", spec["kind"], index,
                                 field)
                self.mesh_plane.stats["mesh_fallbacks"] += 1
                TELEMETRY.count_fallback(telemetry.LEGACY_MESH_ERROR)
                return False
        finally:
            if batcher is not None:
                batcher.node_pressure.observe(
                    (time.monotonic_ns() - t_wall) / 1e6, members=1)
                batcher.node_pressure.in_flight = max(
                    0, batcher.node_pressure.in_flight - 1)
        if result is None:
            return False
        # mesh-served traffic is ARS-visible on this path too
        self._observe_mesh_serving(
            targets, self.ts.transport.scheduler.now() - t_sent)
        hits = result["hits"]
        phase_state["data_plane"] = "mesh"
        # synthesize per-shard query results so merge+fetch run unchanged
        # (the mesh program already IS the global merge; per-shard splits
        # only route the fetch phase)
        by_shard: Dict[int, List[Dict[str, Any]]] = {}
        for h in hits[:window]:
            by_shard.setdefault(h["shard"], []).append(
                {"segment": h["segment"], "doc": h["doc"],
                 "score": h["score"], "sort": h["sort"]})
        # totals are GLOBAL (the mesh program is the merge): the whole
        # request's count rides the first target; the others add zero
        results: List[Optional[Dict[str, Any]]] = []
        for i, target in enumerate(targets):
            target["node"] = self.node_id    # fetch runs locally
            docs = by_shard.get(target["shard"], [])
            results.append({
                "context_id": None,
                "total": result["total"] if i == 0 else 0,
                "relation": result["relation"] if i == 0 else "eq",
                "max_score": max((d["score"] for d in docs), default=None),
                "docs": docs})
        self._merge_and_fetch(t0, targets, results, body, from_, size,
                              phase_state, len(targets), on_done)
        return True

    # -- can_match ------------------------------------------------------

    def _can_match_phase(self, targets, body, phase_state, next_phase):
        query = body.get("query")
        has_terms = False
        if query is not None:
            try:
                has_terms = bool(collect_query_terms(dsl.parse_query(query)))
            except SearchEngineError:
                has_terms = False
        if len(targets) <= 1 or not has_terms or \
                _must_visit_all_shards(body):
            next_phase(targets)
            return
        live: List[Dict[str, Any]] = []
        pending = {"n": len(targets)}

        def one(target):
            def cb(resp, err):
                if err is None and resp is not None and resp["can_match"]:
                    live.append(target)
                elif err is not None:
                    live.append(target)   # fail open: let query phase decide
                else:
                    phase_state["skipped"] += 1
                pending["n"] -= 1
                if pending["n"] == 0:
                    live.sort(key=lambda t: (t["index"], t["shard"]))
                    next_phase(live)
            self.ts.send_request(target["node"], SEARCH_CAN_MATCH,
                                 {"index": target["index"],
                                  "shard": target["shard"], "body": body},
                                 cb, timeout=10.0)
        for target in targets:
            one(target)

    # -- dfs ------------------------------------------------------------

    def _dfs_phase(self, targets, body, next_phase):
        doc_count = {"n": 0}
        dfs: Dict[str, Dict[str, int]] = {}
        field_stats: Dict[str, Any] = {}   # field -> [sum_doc_len, n_docs]
        pending = {"n": len(targets)}

        def one(target):
            def cb(resp, err):
                if err is None and resp is not None:
                    doc_count["n"] += resp["doc_count"]
                    for field, termmap in resp["dfs"].items():
                        agg = dfs.setdefault(field, {})
                        for term, df in termmap.items():
                            agg[term] = agg.get(term, 0) + df
                    for field, (sum_len, n) in (
                            resp.get("field_stats") or {}).items():
                        cur = field_stats.setdefault(field, [0.0, 0])
                        cur[0] += float(sum_len)
                        cur[1] += int(n)
                pending["n"] -= 1
                if pending["n"] == 0:
                    next_phase({"doc_count_override": doc_count["n"],
                                "df_overrides": dfs,
                                "field_stats_overrides": field_stats})
            self.ts.send_request(target["node"], SEARCH_DFS,
                                 {"index": target["index"],
                                  "shard": target["shard"], "body": body},
                                 cb, timeout=30.0)
        for target in targets:
            one(target)

    # -- query ----------------------------------------------------------

    def _query_phase(self, t0, targets, body, window, from_, size,
                     phase_state, n_total_shards, on_done, dfs_overrides):
        phase_state.setdefault("_t_query_ns", time.monotonic_ns())
        _task_phase(phase_state, "query")
        results: List[Optional[Dict[str, Any]]] = [None] * len(targets)
        pending = {"n": len(targets)}
        resolved = [False] * len(targets)
        from elasticsearch_tpu_torch.utils.settings import (
            CLUSTER_USE_ADAPTIVE_REPLICA_SELECTION,
            SEARCH_SHARD_QUERY_TIMEOUT_CEILING,
            SEARCH_SHARD_QUERY_TIMEOUT_FLOOR, setting_from_state,
        )
        qp_state = self.state() if self.state is not None else None
        use_ars = setting_from_state(
            qp_state, CLUSTER_USE_ADAPTIVE_REPLICA_SELECTION)
        timeout_floor = setting_from_state(
            qp_state, SEARCH_SHARD_QUERY_TIMEOUT_FLOOR)
        timeout_ceiling = setting_from_state(
            qp_state, SEARCH_SHARD_QUERY_TIMEOUT_CEILING)

        def one(i: int, target) -> None:
            """Dispatch one shard: walk its (C3-ranked) copy list, treat
            ``shard_busy`` sheds as ROUTING signals (fail over to the
            next copy inside the round), and when a whole round sheds,
            back off with equal jitter (RetryableAction) and re-walk the
            re-ranked list — only a shard whose EVERY copy shed in its
            final round surfaces a (429-status) failure. Replica
            failovers and retry rounds re-use the shard's fan-out
            slot."""
            copies_all = target.get("copies", [target["node"]])
            scheduler = self.ts.transport.scheduler
            rounds = {"n": 0}

            def round_attempt(round_cb) -> None:
                rounds["n"] += 1
                copies = list(copies_all)
                if rounds["n"] > 1:
                    self.shard_busy_stats["retry_rounds"] += 1
                    # a RETRY round re-ranks: the sheds that triggered
                    # the backoff fed the busy nodes' backlogs into ARS,
                    # so the re-walk starts at the copy now expected
                    # least loaded. The FIRST round keeps the order
                    # _shard_targets computed (rotation fairness, plus
                    # the adaptive rank when ARS is on) — and with ARS
                    # off, retries keep pure rotation: the chaos
                    # baseline stays rank-free on every round.
                    if use_ars and len(copies) > 1:
                        copies = self.response_collector.order_copies(
                            copies)
                busy_ras: List[int] = []
                real_errs: List[Exception] = []

                def try_copy(copy_idx: int) -> None:
                    shard_body = body
                    if target.get("alias_filter") is not None:
                        # filtered alias: wrap for THIS shard's index only
                        shard_body = {**body, "query": {"bool": {
                            "must": [body.get("query", {"match_all": {}})],
                            "filter": [target["alias_filter"]]}}}
                    req = {"index": target["index"],
                           "shard": target["shard"],
                           "body": shard_body, "window": window}
                    if phase_state.get("task_id"):
                        req["task_id"] = phase_state["task_id"]
                    if phase_state.get("deadline") is not None:
                        # shard-side budget enforcement: ship the time
                        # LEFT at dispatch (durations survive process
                        # boundaries; absolute timestamps don't)
                        req["budget_remaining"] = max(
                            0.0, phase_state["deadline"] -
                            scheduler.now())
                    if dfs_overrides:
                        req.update(dfs_overrides)
                    node = copies[copy_idx]
                    # scheduler time, not wall: the round trip then
                    # includes the transport's (possibly simulated)
                    # latency, so replica ranking — and the wire/service
                    # split below — behaves identically under the
                    # deterministic harness and production
                    t_sent = scheduler.now()
                    self.response_collector.on_send(node)

                    def cb(resp, err):
                        rtt_s = scheduler.now() - t_sent
                        busy = shard_busy_info(err)
                        if busy is not None:
                            # a shed is NOT a response time (the node
                            # answered fast precisely because it did no
                            # work): its reported backlog lands on the
                            # queue EWMA so the cubed C3 term sinks the
                            # node's rank immediately
                            self.shard_busy_stats["sheds_seen"] += 1
                            self.response_collector.on_rejection(
                                node, busy["queued"] or None,
                                busy["retry_after"])
                        else:
                            # C3 feedback: the shard response piggybacks
                            # the node's self-reported queue depth and
                            # service-time EWMA — feed them to the
                            # collector so order_copies can route around
                            # a SATURATED node, not just a slow wire
                            pressure = resp.get("pressure") \
                                if err is None and isinstance(resp, dict) \
                                else None
                            self.response_collector.on_response(
                                node, rtt_s, failed=err is not None,
                                service_ms=(pressure or {})
                                .get("service_ewma_ms"),
                                queue_depth=(pressure or {}).get("queue"))
                            wp = (pressure or {}).get("write_pressure")
                            if wp:
                                # ingest-hot signal rides the same
                                # snapshot: utilization in [0,1], scale
                                # to a synthetic bytes/limit pair
                                self.response_collector.on_write_pressure(
                                    node, int(wp * 1_000_000), 1_000_000)
                        if err is None and isinstance(resp, dict) and \
                                resp.get("took_ms") is not None and \
                                phase_state.get("trace") is not None:
                            # wire vs service split: the shard reports
                            # its own took (arrival -> delivery), the
                            # coordinator subtracts it from the round
                            # trip — shown per shard in the profile:true
                            # coordinator tree
                            took_ms = float(resp["took_ms"])
                            wire_ms = max(rtt_s * 1000.0 - took_ms, 0.0)
                            phase_state["trace"].add_span(
                                "shard_query", max(int(rtt_s * 1e9), 1),
                                {"index": target["index"],
                                 "shard": target["shard"], "node": node,
                                 "service_ms": round(took_ms, 3),
                                 "wire_ms": round(wire_ms, 3)})
                        if phase_state.get("aborted") or \
                                phase_state.get("budget_expired"):
                            return   # the phase completed without us
                        if err is None:
                            target["node"] = node  # fetch follows query
                            round_cb({"resp": resp}, None)
                            return
                        # a cancelled task must abort the whole search,
                        # not fail over (cancellation is not a fault)
                        if getattr(err, "cause_type", "") == \
                                "TaskCancelledError" or \
                                type(err).__name__ == "TaskCancelledError":
                            phase_state["aborted"] = True
                            timer = phase_state.pop("_budget_timer", None)
                            if timer is not None:
                                timer.cancel()
                            on_done(None, err)
                            return
                        if busy is not None:
                            busy_ras.append(busy["retry_after"])
                            if copy_idx + 1 < len(copies):
                                # routing signal, not a failure: the
                                # next ranked copy may have headroom NOW
                                self.shard_busy_stats["failovers"] += 1
                                TELEMETRY.count_fallback(
                                    telemetry.SHARD_BUSY_FAILOVER)
                                try_copy(copy_idx + 1)
                                return
                            if len(busy_ras) == len(copies):
                                round_cb(None, _AllCopiesShed(
                                    len(copies), min(busy_ras)))
                            else:
                                # MIXED round: some copies failed for
                                # real — the shard's true cause is the
                                # fault, not overload; retrying/429ing
                                # would misreport a broken copy as busy
                                round_cb(None, real_errs[-1])
                            return
                        real_errs.append(err)
                        if copy_idx + 1 < len(copies):
                            # fail over to the next copy of this shard
                            try_copy(copy_idx + 1)
                            return
                        round_cb(None, err)
                    # adaptive per-copy timeout off the copy's own ARS
                    # response EWMA (PR 13's recorded leg): a stalled
                    # known-fast copy fails over in RTT-scale time; the
                    # timeout error then reads as a slow response, so
                    # the node's widened EWMA self-corrects the bound
                    budget_left = None \
                        if phase_state.get("deadline") is None else \
                        max(phase_state["deadline"] - scheduler.now(),
                            0.0)
                    self.ts.send_request(
                        node, SEARCH_QUERY, req, cb,
                        timeout=self._shard_query_timeout(
                            node, timeout_floor, timeout_ceiling,
                            budget_left,
                            has_failover=copy_idx + 1 < len(copies)))
                try_copy(0)

            def shard_done(wrapped, err) -> None:
                if phase_state.get("aborted") or \
                        phase_state.get("budget_expired"):
                    return
                if err is None:
                    results[i] = wrapped["resp"]
                else:
                    entry = {"shard": target["shard"],
                             "index": target["index"],
                             "reason": str(err),
                             "status": getattr(err, "status", 500)}
                    if isinstance(err, _AllCopiesShed):
                        # only now — every copy at its bound through the
                        # final round — does shard_busy surface; the
                        # Retry-After is the least-loaded copy's own
                        # drain-rate estimate
                        self.shard_busy_stats["all_copies_shed"] += 1
                        entry["status"] = 429
                        entry["retry_after"] = err.retry_after
                        entry["copies"] = err.n_copies
                    phase_state["failed"] += 1
                    phase_state["failures"].append(entry)
                resolved[i] = True
                pending["n"] -= 1
                if pending["n"] == 0:
                    timer = phase_state.pop("_budget_timer", None)
                    if timer is not None:
                        timer.cancel()
                    self._merge_and_fetch(t0, targets, results, body,
                                          from_, size, phase_state,
                                          n_total_shards, on_done)
                else:
                    # a completion frees a fan-out slot
                    pump = phase_state.get("_dispatch_next")
                    if pump is not None:
                        pump()

            deadline = phase_state.get("deadline")
            budget_left = None if deadline is None else \
                max(deadline - scheduler.now(), 0.0)
            timeout = self.SHARD_BUSY_RETRY_TIMEOUT_S \
                if budget_left is None else \
                min(budget_left, self.SHARD_BUSY_RETRY_TIMEOUT_S)
            RetryableAction(
                scheduler, round_attempt, shard_done,
                initial_delay=self.SHARD_BUSY_RETRY_INITIAL_S,
                max_delay=self.SHARD_BUSY_RETRY_MAX_S,
                timeout=max(timeout, 1e-3),
                is_retryable=lambda e: isinstance(e, _AllCopiesShed)
                and rounds["n"] < self.SHARD_BUSY_MAX_ROUNDS).run()

        # time budget (request [timeout]): when it expires with shard
        # responses still outstanding, the phase completes NOW with what
        # has arrived — timed_out: true, the missing shards recorded in
        # _shards.failures, and the fetch phase still materializing the
        # surviving hits (partial results over nothing).
        deadline = phase_state.get("deadline")
        if deadline is not None:
            scheduler = self.ts.transport.scheduler

            def budget_expired() -> None:
                if phase_state.get("aborted") or \
                        phase_state.get("budget_expired") or pending["n"] == 0:
                    return
                phase_state["budget_expired"] = True
                phase_state["timed_out"] = True
                for j, target in enumerate(targets):
                    if resolved[j]:
                        continue
                    phase_state["failed"] += 1
                    phase_state["failures"].append({
                        "shard": target["shard"], "index": target["index"],
                        "reason": "search budget expired before the shard "
                                  "responded",
                        "status": 503})
                self._merge_and_fetch(t0, targets, results, body, from_,
                                      size, phase_state, n_total_shards,
                                      on_done)

            phase_state["_budget_timer"] = scheduler.schedule(
                max(0.0, deadline - scheduler.now()), budget_expired)

        # bounded fan-out: at most max_concurrent_shard_requests shard
        # queries in flight per search; the next shard dispatches as each
        # completes (AbstractSearchAsyncAction's bounded concurrency).
        # phase_state["_dispatch_next"] is invoked from cb's completion
        # accounting; replica failovers re-use their slot.
        max_concurrent = int(
            phase_state.get("max_concurrent_shard_requests") or
            DEFAULT_MAX_CONCURRENT_SHARD_REQUESTS)
        cursor = {"i": 0}

        def dispatch_next() -> None:
            # a cancelled parent task stops the fan-out at the next slot
            # boundary: no further shard requests go out, and the search
            # aborts instead of waiting on undispatched shards
            task = phase_state.get("task")
            if task is not None and task.cancelled and \
                    not phase_state.get("aborted") and \
                    not phase_state.get("budget_expired"):
                phase_state["aborted"] = True
                timer = phase_state.pop("_budget_timer", None)
                if timer is not None:
                    timer.cancel()
                from elasticsearch_tpu_torch.utils.errors import TaskCancelledError
                on_done(None, TaskCancelledError(
                    f"task [{task.task_id}] was cancelled: "
                    f"{task.cancel_reason}"))
                return
            done = len(targets) - pending["n"]
            while cursor["i"] < len(targets) and \
                    (cursor["i"] - done) < max_concurrent:
                i = cursor["i"]
                cursor["i"] += 1
                one(i, targets[i])
                done = len(targets) - pending["n"]
        phase_state["_dispatch_next"] = dispatch_next
        dispatch_next()

    # -- reciprocal rank fusion (hybrid retrieval) -----------------------

    def _execute_rrf(self, t0, expression: str, body: Dict[str, Any],
                     on_done: DoneFn, search_type: str) -> None:
        """rank: {rrf: {...}} — hybrid retrieval (RRFRankPlugin analog,
        the BASELINE config-4 REST surface): each retriever (the query
        clause, a top-level knn clause, and/or sub_searches entries) runs
        as a full search over its own best data plane (mesh or RPC), and
        the coordinator fuses the ranked lists with reciprocal-rank
        scoring 1/(rank_constant + rank)."""
        rrf = dict((body.get("rank") or {}).get("rrf") or {})
        try:
            size = int(body.get("size", 10))
            from_ = int(body.get("from", 0))
            window = int(rrf.get("rank_window_size",
                                 max(size + from_, 10)))
            rank_constant = int(rrf.get("rank_constant", 60))
        except (TypeError, ValueError) as e:
            on_done(None, IllegalArgumentError(
                f"invalid [rrf] parameter: {e}"))
            return
        if rank_constant < 1:
            on_done(None, IllegalArgumentError(
                f"[rank_constant] must be greater than or equal to [1], "
                f"got [{rank_constant}]"))
            return
        if window < size + from_:
            on_done(None, IllegalArgumentError(
                f"[rank_window_size] ({window}) must be greater than or "
                f"equal to [size] + [from] ({size + from_})"))
            return
        if body.get("sub_searches") and body.get("query") is not None:
            on_done(None, IllegalArgumentError(
                "cannot specify both [query] and [sub_searches]"))
            return
        retrievers: List[Dict[str, Any]] = []
        for sub in body.get("sub_searches") or []:
            if sub.get("query") is None:
                on_done(None, IllegalArgumentError(
                    "[sub_searches] entries require a [query]"))
                return
            retrievers.append(sub["query"])
        if body.get("query") is not None:
            retrievers.append(body["query"])
        knn = body.get("knn")
        if knn is not None:
            # the standard multi-knn form is a LIST: each clause fuses as
            # its own retriever
            for clause in (knn if isinstance(knn, list) else [knn]):
                retrievers.append({"knn": clause})
        if len(retrievers) < 2:
            on_done(None, IllegalArgumentError(
                "[rrf] requires at least two retrievers (query, knn, "
                "or sub_searches)"))
            return
        for clause in ("aggs", "aggregations", "sort", "collapse",
                       "rescore", "search_after", "suggest",
                       "post_filter", "min_score", "indices_boost",
                       "script_fields", "runtime_mappings", "fields",
                       "terminate_after", "scroll"):
            if body.get(clause):
                # silently dropping a result-shaping clause would return
                # confidently-wrong hits; reject what fusion cannot honor
                on_done(None, IllegalArgumentError(
                    f"[rrf] cannot be combined with [{clause}]"))
                return

        results: List[Optional[Dict[str, Any]]] = [None] * len(retrievers)
        errors: list = []
        pending = {"n": len(retrievers)}
        passthrough = {k: body[k] for k in
                       ("_source", "docvalue_fields", "stored_fields",
                        "highlight", "timeout",
                        "allow_partial_search_results") if k in body}
        # hybrid coordinator telemetry: the legs record their own
        # (bm25/knn-classed) traces through _execute_admitted; this trace
        # attributes the request-level split between retriever fan-out
        # and fusion
        htrace = SearchTrace("hybrid", "fanout")
        t_legs = time.monotonic_ns()

        def complete() -> None:
            htrace.add_span("legs", time.monotonic_ns() - t_legs)
            if errors:
                on_done(None, errors[0])
                return
            # encode (index, _id) identities into a request-local dense
            # id space for the device fusion, keeping the exact host
            # (float64) reciprocal-rank sums for the response scores
            key_to_id: Dict[Tuple[str, str], int] = {}
            first_hit: List[Dict[str, Any]] = []
            scores64: List[float] = []
            doc_lists: List[List[int]] = []
            for ranked in results:
                hits = (ranked or {}).get("hits", {}).get("hits", [])
                lst: List[int] = []
                for rank, hit in enumerate(hits, start=1):
                    key = (hit.get("_index"), hit.get("_id"))
                    did = key_to_id.get(key)
                    if did is None:
                        did = len(first_hit)
                        key_to_id[key] = did
                        first_hit.append(hit)
                        scores64.append(0.0)
                    scores64[did] += 1.0 / (rank_constant + rank)
                    lst.append(did)
                doc_lists.append(lst)

            t_fuse = time.monotonic_ns()

            def finalize(candidates: Optional[List[int]],
                         error: Optional[Exception] = None) -> None:
                htrace.add_span("fuse", time.monotonic_ns() - t_fuse)
                htrace.finish()
                TELEMETRY.observe(htrace)
                if error is not None:
                    on_done(None, error)
                    return
                # candidates: the device fusion's scored docs (covers the
                # WHOLE candidate pool, so the set equals the host's),
                # or None = fuse entirely on the host. Either way the
                # output scores/order come from the f64 sums + the host
                # comparator — byte-identical across both paths.
                if candidates is None:
                    candidates = range(len(first_hit))
                # the dense id (first-seen order) is the FINAL tie-break:
                # it reproduces the host sort's stable insertion-order
                # behavior no matter which order the device returned the
                # candidates in, so full ties (same score AND same _id
                # across indices) order identically on both paths
                ordered = sorted(
                    ((scores64[did], did, first_hit[did])
                     for did in candidates),
                    key=lambda e: (-e[0], str(e[2].get("_id")), e[1]))
                out_hits = []
                for rank, (score, _did, hit0) in enumerate(
                        ordered[from_: from_ + size], start=from_ + 1):
                    hit = dict(hit0)
                    hit["_score"] = round(score, 6)
                    hit["_rank"] = rank
                    out_hits.append(hit)
                # shard accounting must reflect EVERY retriever's
                # fan-out, or one retriever's partial failure hides
                # behind another's clean run
                shards = {"total": 0, "successful": 0, "skipped": 0,
                          "failed": 0}
                timed_out = False
                for ranked in results:
                    sub = (ranked or {}).get("_shards") or {}
                    for f in shards:
                        shards[f] += int(sub.get(f, 0))
                    timed_out = timed_out or bool(
                        (ranked or {}).get("timed_out"))
                on_done({
                    "took": int((time.monotonic() - t0) * 1000),
                    "timed_out": timed_out,
                    "_shards": shards,
                    # windows cap what fusion can observe: the
                    # unique-doc count is a LOWER bound on true matches
                    "hits": {"total": {"value": len(first_hit),
                                       "relation": "gte"},
                             "max_score": (out_hits[0]["_score"]
                                           if out_hits else None),
                             "hits": out_hits},
                }, None)

            self.rrf_fuser.submit(doc_lists, len(first_hit),
                                  rank_constant, finalize)

        def collect(i: int):
            def cb(resp, err) -> None:
                if err is not None:
                    errors.append(err)
                else:
                    results[i] = resp
                pending["n"] -= 1
                if pending["n"] == 0:
                    complete()
            return cb

        for i, query in enumerate(retrievers):
            sub_body = {"query": query, "size": window,
                        "track_total_hits": False, **passthrough}
            self._execute_admitted(expression, sub_body, collect(i),
                                   search_type)

    # -- cross-cluster search --------------------------------------------

    def _on_ccs(self, req: Dict[str, Any], sender: str):
        """Serve a search arriving FROM another cluster's coordinator:
        run it fully here (this node is the remote's gateway) and return
        the final response over the reply channel."""
        from elasticsearch_tpu_torch.transport.transport import Deferred
        deferred = Deferred()

        def done(resp, err):
            if err is not None:
                deferred.reject(err)
            else:
                deferred.resolve(resp)

        self.execute(req.get("indices", ""), req.get("body") or {}, done,
                     search_type=req.get("search_type",
                                         "query_then_fetch"))
        return deferred

    def _execute_ccs(self, t0, expression: str, body: Dict[str, Any],
                     on_done: DoneFn, search_type: str) -> None:
        """Coordinator side of cross-cluster search: split the expression
        into local + per-alias remote groups, fan the search out (each
        remote coordinator runs it end-to-end, ccs_minimize_roundtrips
        style), and merge the final responses
        (action/search/SearchResponseMerger.java)."""
        from elasticsearch_tpu_torch.transport.remote import (
            split_remote_expression,
        )
        local_parts, remote_groups = split_remote_expression(expression)
        for clause in ("aggs", "aggregations", "suggest", "collapse",
                       "rescore", "rank"):
            if body.get(clause):
                on_done(None, IllegalArgumentError(
                    f"[{clause}] is not supported with remote cluster "
                    f"indices; query each cluster individually"))
                return
        unknown = [a for a in remote_groups
                   if a not in self.remote_clusters.seeds()]
        if unknown:
            on_done(None, IllegalArgumentError(
                f"no such remote cluster: [{unknown[0]}]"))
            return
        size = int(body.get("size", 10))
        from_ = int(body.get("from", 0))
        # every cluster returns its own top (from+size); the merge
        # re-slices — SearchResponseMerger's from+size over-fetch
        fan_body = {**body, "from": 0, "size": size + from_}
        keys = (["(local)"] if local_parts else []) + sorted(remote_groups)
        results: Dict[str, Dict[str, Any]] = {}
        errors: list = []
        skipped: list = []
        pending = {"n": len(keys)}

        def complete() -> None:
            if errors:
                on_done(None, errors[0][1])
                return
            on_done(self._merge_ccs(t0, body, results, from_, size,
                                    skipped=skipped), None)

        def collect(key: str):
            def cb(resp, err) -> None:
                if err is not None:
                    # cluster.remote.<alias>.skip_unavailable: a down or
                    # failing remote degrades the federated search (the
                    # cluster is reported skipped) instead of failing it
                    if key != "(local)" and \
                            self.remote_clusters.skip_unavailable(key):
                        skipped.append(key)
                    else:
                        errors.append((key, err))
                else:
                    results[key] = resp or {}
                pending["n"] -= 1
                if pending["n"] == 0:
                    complete()
            return cb

        if local_parts:
            self._execute_admitted(",".join(local_parts), fan_body,
                                   collect("(local)"), search_type)
        for alias in sorted(remote_groups):
            self.remote_clusters.send(
                alias, SEARCH_CCS,
                {"indices": ",".join(remote_groups[alias]),
                 "body": fan_body, "search_type": search_type},
                collect(alias), timeout=60.0)

    def _merge_ccs(self, t0, body: Dict[str, Any],
                   results: Dict[str, Dict[str, Any]],
                   from_: int, size: int,
                   skipped: Optional[list] = None) -> Dict[str, Any]:
        sort_specified = body.get("sort") is not None
        entries: list = []
        total = 0
        relation = "eq"
        timed_out = False
        max_score: Optional[float] = None
        shards = {"total": 0, "successful": 0, "skipped": 0, "failed": 0}
        for key, resp in results.items():
            h = resp.get("hits") or {}
            tot = h.get("total") or {}
            total += int(tot.get("value", 0))
            if tot.get("relation") == "gte":
                relation = "gte"
            timed_out = timed_out or bool(resp.get("timed_out"))
            ms = h.get("max_score")
            if ms is not None:
                max_score = ms if max_score is None else max(max_score, ms)
            sh = resp.get("_shards") or {}
            for f in shards:
                shards[f] += int(sh.get(f, 0))
            for hit in h.get("hits", []):
                if key != "(local)":
                    # remote hits carry the alias-qualified index name
                    hit = {**hit, "_index": f"{key}:{hit.get('_index')}"}
                entries.append(hit)
        tth = body.get("track_total_hits", 10_000)
        if tth is not True and tth is not False and tth \
                and total > int(tth):
            total = int(tth)
            relation = "gte"
        if sort_specified:
            import functools
            from elasticsearch_tpu_torch.search.phase import _cmp_values
            specs = parse_sort(body.get("sort"))
            reverse = [s.order == "desc" for s in specs]

            def cmp(a, b) -> int:
                for av, bv, rev in zip(a.get("sort") or [],
                                       b.get("sort") or [], reverse):
                    c = _cmp_values(av, bv, rev)
                    if c:
                        return c
                return 0

            entries.sort(key=functools.cmp_to_key(cmp))
        else:
            entries.sort(key=lambda hh: -(hh.get("_score") or 0.0))
        n_skipped = len(skipped or [])
        return {
            "took": int((time.monotonic() - t0) * 1000),
            "timed_out": timed_out,
            "_shards": shards,
            "_clusters": {"total": len(results) + n_skipped,
                          "successful": len(results),
                          "skipped": n_skipped},
            "hits": {"total": {"value": total, "relation": relation},
                     "max_score": max_score,
                     "hits": entries[from_: from_ + size]},
        }

    # -- merge + fetch ---------------------------------------------------

    def _merge_and_fetch(self, t0, targets, results, body, from_, size,
                         phase_state, n_total_shards, on_done):
        trace = phase_state.get("trace")
        t_merge = time.monotonic_ns()
        if trace is not None and phase_state.get("_t_query_ns"):
            trace.add_span("query_phase",
                           t_merge - phase_state.pop("_t_query_ns"))
        _task_phase(phase_state, "fetch")
        sort_specified = body.get("sort") is not None
        total = 0
        relation = "eq"
        max_score: Optional[float] = None
        entries: List[Tuple[int, Dict[str, Any]]] = []  # (target_idx, doc)
        for i, result in enumerate(results):
            if result is None:
                continue
            total += result["total"]
            if result["relation"] == "gte":
                relation = "gte"
            if result.get("terminated"):
                phase_state["terminated_early"] = True
            if result["max_score"] is not None:
                max_score = (result["max_score"] if max_score is None
                             else max(max_score, result["max_score"]))
            for doc in result["docs"]:
                entries.append((i, doc))
        # the coordinator re-clips the summed total at the request's
        # threshold (SearchPhaseController's TotalHits merge): each shard
        # counts up to the limit independently, so the raw sum can reach
        # n_shards * limit
        tth = body.get("track_total_hits", 10_000)
        if tth is not True and tth is not False and tth and total > int(tth):
            total = int(tth)
            relation = "gte"

        if sort_specified:
            from elasticsearch_tpu_torch.search.phase import _cmp_values
            sort_specs = parse_sort(body.get("sort"))

            def cmp(a, b):
                for pos, spec in enumerate(sort_specs):
                    c = _cmp_values(a[1]["sort"][pos], b[1]["sort"][pos],
                                    spec.order == "desc")
                    if c:
                        return c
                return (a[0] - b[0]) or (a[1]["doc"] - b[1]["doc"])
            entries.sort(key=functools.cmp_to_key(cmp))
        else:
            entries.sort(key=lambda e: (-e[1]["score"], e[0],
                                        e[1]["segment"], e[1]["doc"]))

        if body.get("collapse"):
            # cross-shard collapse: keep the best hit per key
            # (SearchPhaseController merge of CollapseTopFieldDocs)
            from elasticsearch_tpu_torch.search.phase import collapse_marker
            seen: set = set()
            deduped = []
            for e in entries:
                marker = collapse_marker(e[1].get("ckey"))
                if marker in seen:
                    continue
                seen.add(marker)
                deduped.append(e)
            entries = deduped

        winners = entries[from_:from_ + size]
        if trace is not None:
            trace.add_span("merge", time.monotonic_ns() - t_merge)
        if not winners:
            self._complete(self._finalize(t0, targets, body, phase_state,
                                          n_total_shards, total, relation,
                                          max_score, [], results=results),
                           on_done, phase_state)
            return

        # group winners per shard for fetch
        by_target: Dict[int, List[Tuple[int, Dict[str, Any]]]] = {}
        for order, (tidx, doc) in enumerate(winners):
            by_target.setdefault(tidx, []).append((order, doc))

        hits_out: List[Optional[Dict[str, Any]]] = [None] * len(winners)
        pending = {"n": len(by_target)}
        t_fetch = time.monotonic_ns()

        def one(tidx: int, docs: List[Tuple[int, Dict[str, Any]]]) -> None:
            target = targets[tidx]
            req = {"index": target["index"], "shard": target["shard"],
                   "context_id": results[tidx]["context_id"],
                   "docs": [d for _, d in docs], "body": body}
            served_by = results[tidx].get("served_by")
            if served_by:
                req["served_by"] = served_by

            def cb(resp, err):
                if err is None and resp is not None:
                    cfield = (body.get("collapse") or {}).get("field")
                    for (order, d), hit in zip(docs, resp["hits"]):
                        if cfield and d.get("ckey") is not None:
                            hit.setdefault("fields", {})[cfield] = \
                                [d["ckey"]]
                        hits_out[order] = hit
                else:
                    phase_state["failed"] += 1
                    phase_state["failures"].append({
                        "shard": target["shard"], "index": target["index"],
                        "reason": f"fetch: {err}",
                        "status": getattr(err, "status", 500)})
                pending["n"] -= 1
                if pending["n"] == 0:
                    if trace is not None:
                        trace.add_span("fetch",
                                       time.monotonic_ns() - t_fetch)
                    hits = [h for h in hits_out if h is not None]
                    self._complete(
                        self._finalize(t0, targets, body, phase_state,
                                       n_total_shards, total, relation,
                                       max_score, hits, results=results),
                        on_done, phase_state)
            self.ts.send_request(target["node"], SEARCH_FETCH, req, cb,
                                 timeout=60.0)
        for tidx, docs in by_target.items():
            one(tidx, docs)

    # -- response --------------------------------------------------------

    def _complete(self, resp: Dict[str, Any], on_done,
                  phase_state: Optional[Dict[str, Any]] = None) -> None:
        """Deliver the merged response — unless EVERY shard failed, in
        which case the whole search fails with the dominant cause's status
        (SearchPhaseExecutionException.status() analog: an all-shards 429
        is a request-wide 429, not a 200 with empty hits). With
        allow_partial_search_results=false, ANY shard failure or an
        expired time budget fails the request the same way."""
        shards = resp["_shards"]
        from elasticsearch_tpu_torch.utils.errors import SearchPhaseExecutionError
        failures = shards.get("failures") or []
        # skipped shards count as successful ops (the reference's skipShard
        # calls successfulShardExecution): only fail the request when every
        # NON-skipped shard failed and at least one did
        # an all-copies-shed 429 carries an HONEST Retry-After: each
        # failed shard's value is its least-loaded copy's drain-rate
        # estimate; the request can only be admitted once its slowest
        # such shard has headroom, hence the max across shards (the REST
        # layer mints the Retry-After header off the error metadata)
        busy_meta = {}
        ras = [f["retry_after"] for f in failures if f.get("retry_after")]
        if ras:
            busy_meta["retry_after"] = max(ras)
        if shards["total"] > 0 and shards["successful"] == 0 \
                and shards["skipped"] == 0 and shards["failed"] > 0:
            statuses = [f.get("status", 500) for f in failures]
            cause_status = max(statuses, default=503)
            reason = failures[0]["reason"] if failures else "all shards failed"
            on_done(None, SearchPhaseExecutionError(
                f"all shards failed: {reason}", cause_status=cause_status,
                **(busy_meta if cause_status == 429 else {})))
            return
        if phase_state is not None and \
                not phase_state.get("allow_partial", True) and \
                (shards["failed"] > 0 or resp.get("timed_out")):
            statuses = [f.get("status", 500) for f in failures]
            reason = failures[0]["reason"] if failures \
                else "search budget expired"
            cause_status = max(statuses, default=503)
            on_done(None, SearchPhaseExecutionError(
                f"{shards['failed']} of {shards['total']} shards failed "
                f"and partial results are disallowed "
                f"(allow_partial_search_results=false): {reason}",
                cause_status=cause_status,
                **(busy_meta if cause_status == 429 else {})))
            return
        on_done(resp, None)

    def _finalize(self, t0, targets, body, phase_state, n_total_shards,
                  total, relation, max_score, hits,
                  results=None) -> Dict[str, Any]:
        successful = n_total_shards - phase_state["failed"] \
            - phase_state["skipped"]
        resp = {
            "took": int((time.monotonic() - t0) * 1000),
            "timed_out": bool(phase_state.get("timed_out")),
            "_shards": {"total": n_total_shards,
                        "successful": max(successful, 0),
                        "skipped": phase_state["skipped"],
                        "failed": phase_state["failed"]},
            "hits": {"total": {"value": total, "relation": relation},
                     "max_score": max_score, "hits": hits},
        }
        if phase_state.get("terminated_early"):
            resp["terminated_early"] = True
        agg_body = body.get("aggs", body.get("aggregations"))
        if agg_body:
            # coordinator-side reduce of per-shard partials
            # (InternalAggregation.reduce analog)
            from elasticsearch_tpu_torch.search.aggregations import (
                parse_aggs, reduce_aggs,
            )
            partials = [r.get("aggs_partial") for r in (results or [])
                        if r is not None]
            resp["aggregations"] = reduce_aggs(parse_aggs(agg_body),
                                               partials)
        if phase_state["failures"]:
            resp["_shards"]["failures"] = phase_state["failures"]
        if phase_state.get("data_plane"):
            resp["_data_plane"] = phase_state["data_plane"]
        trace = phase_state.get("trace")
        if trace is not None:
            # the routing verdict labels the coordinator histogram entry:
            # "mesh"/"mesh_plane" when a mesh program served, "fanout"
            # for the RPC scatter-gather
            trace.data_plane = phase_state.get("data_plane") or "fanout"
            trace.finish()
            TELEMETRY.observe(trace)
        if body.get("profile"):
            shards_profile = []
            for target, r in zip(targets, results or []):
                if r is None or r.get("profile") is None:
                    continue
                shards_profile.append({
                    "id": f"[{target.get('node')}][{target['index']}]"
                          f"[{target['shard']}]",
                    "searches": [r["profile"]]})
            resp["profile"] = {"shards": shards_profile}
            if trace is not None:
                resp["profile"]["coordinator"] = trace.tree()
        return resp

    def _empty_response(self, t0, n_shards) -> Dict[str, Any]:
        return {
            "took": int((time.monotonic() - t0) * 1000),
            "timed_out": False,
            "_shards": {"total": n_shards, "successful": n_shards,
                        "skipped": 0, "failed": 0},
            "hits": {"total": {"value": 0, "relation": "eq"},
                     "max_score": None, "hits": []},
        }


def _validate_composite_shapes(body: Dict[str, Any]) -> None:
    """Malformed rank/sub_searches/knn container shapes 400 at entry
    instead of AttributeError/TypeError-ing into 500s deeper in the
    pipeline (and in the security DLS wrap — ADVICE r5 low)."""
    rank = body.get("rank")
    if rank is not None and not isinstance(rank, dict):
        raise IllegalArgumentError(
            f"[rank] must be an object, got [{type(rank).__name__}]")
    if isinstance(rank, dict):
        rrf = rank.get("rrf")
        if rrf is not None and not isinstance(rrf, dict):
            raise IllegalArgumentError(
                f"[rank.rrf] must be an object, got "
                f"[{type(rrf).__name__}]")
    subs = body.get("sub_searches")
    if subs is not None:
        if not isinstance(subs, list) or \
                not all(isinstance(s, dict) for s in subs):
            raise IllegalArgumentError(
                "[sub_searches] must be a list of objects")
    knn = body.get("knn")
    if knn is not None:
        clauses = knn if isinstance(knn, list) else [knn]
        if not all(isinstance(c, dict) for c in clauses):
            raise IllegalArgumentError(
                "[knn] must be an object or a list of objects")


def _must_visit_all_shards(body: Dict[str, Any]) -> bool:
    """A ``global`` agg anywhere in the tree must see every live doc, and
    suggesters read term dictionaries unrelated to the query — in both
    cases can_match shard skipping would silently drop results (the
    reference disables the match-none skip for mustVisitAllDocs aggs and
    suggest-bearing requests)."""
    if body.get("suggest"):
        return True
    agg_body = body.get("aggs", body.get("aggregations"))
    if not agg_body:
        return False

    def walk(entries) -> bool:
        if not isinstance(entries, dict):
            return False
        for entry in entries.values():
            if not isinstance(entry, dict):
                continue
            if "global" in entry:
                return True
            if walk(entry.get("aggs", entry.get("aggregations") or {})):
                return True
        return False
    return walk(agg_body)


def _suggest_partial(reader, mappers, body):
    # search/suggest.py is not ported yet
    raise NotPortedError("suggest")
