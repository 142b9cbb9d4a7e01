"""THE shard execution path: every shard query is a batch member.

Solo is a batch of one. ``SearchTransportService._on_query`` enqueues
EVERY arriving shard query here — there is no separate solo execution
path, no parity-locked duplicate kernels held byte-identical by golden
tests. The reference has exactly one ``SearchService.executeQueryPhase``
entry regardless of concurrency; this module is that entry for the
device-batched build:

- Queries classify into four kinds. ``text`` / ``knn`` / ``sparse`` are
  the *device-batchable* shapes (pure score-sorted top-k — exactly what
  ``choose_collector_context`` routes to the top-k collectors): Q
  members share ONE batched device program per segment per phase.
  Everything else — aggregations, suggest, nested, spans, rescore,
  collapse, profile, sorts, DFS overrides, sliced scrolls, frozen
  indices — classifies as ``dense``: device work stays per member
  (``query_shard`` over the drain's shared reader snapshot), but the
  members still share the drain's reader acquisition, the per-drain
  memo (identical plans execute once, rows fan out copy-on-write), the
  segments' filter-context caches, and the adaptive collection window.
- The queue drains **adaptively**: immediately when the key is idle (no
  recent dispatch — an isolated query pays only one scheduler hop; an
  occupancy-1 key drains on the same tick, so latency is unchanged vs
  the old solo path), and after up to ``search.batch.max_window_ms``
  under load so concurrent queries coalesce. ``search.batch.max_size``
  caps the query dimension of one dispatch — and adapts DOWN per key
  under HBM pressure (a breaker trip halves the key's effective cap;
  successful full drains regrow it toward the setting). All dynamic
  cluster settings; ``search.batch.enabled: false`` forces window 0
  through the SAME path (no second code path to hold in parity).
- One drain executes ONE batched device program per segment per phase
  (the query dimension padded to a pow2 bucket inside the executors),
  then demuxes per-query results — top-k
  docs, totals with the counts-then-skip contract, per-query
  ``theta``/prune stats — bit-compatible with the solo path.
- **Filtered kNN** batches too: each member's filter-context mask (the
  host-side mask builders of search/execute.py) is computed once per
  distinct filter per segment and rides the same [Q, D] x [D, N]
  kernel launch — shared as one [N_pad] mask when every member carries the
  same filter (the autocomplete / faceted-nav shape), stacked to
  [Q, N_pad] otherwise. Unfiltered members on IVF-routed segments
  (ivf-opted mapping, or ANN-sized corpora) go through ONE batched
  nprobe-probe (ops/ivf.py ``probe_live``) instead of falling back solo,
  provided the members agree on ``num_candidates``.
- **Per-drain memo**: members of one drain with an identical
  (plan, window, totals) execute once; the rows fan out to every
  duplicate (its own context, stats, slow-log entry — the response
  surface is indistinguishable from independent execution). A drain
  holds ONE reader snapshot, so a memo hit can never cross a refresh.
  Duplicate-heavy traffic (autocomplete storms) becomes nearly free.
- **Occupancy feedback**: each key's collection window adapts — drains
  carrying >= ``search.batch.target_occupancy`` live members grow the
  window (x2, bounded by ``search.batch.max_window_ms``); drains that
  come up thin (<= 1) shrink it back — so bursty keys coalesce harder
  while idle keys never hold a lone query hostage.
- Per-query deadlines and cancellation still bind: a query whose budget
  expires (or whose task is cancelled) before its batch drains is failed
  individually at drain entry; between device dispatches every member is
  re-checked (the batch inherits the earliest member deadline in the
  sense that expiry is detected at dispatch granularity), and a batch
  whose members have ALL died aborts outright. ``_msearch`` lines land
  in the same batch by construction — they arrive as independent shard
  queries within the same scheduler tick.

There is ONE degrade lane: a drain whose shared execution fails
(breaker trip, plane nprobe disagreement, kernel error) re-drains each
surviving member as a batch of one through the SAME ``_execute`` — at
occupancy 1 a breaker transient is minimal and plane members cannot
disagree with themselves, so the re-drain resolves every recoverable
cause; an error that persists at occupancy 1 is the query's own error
and fails that member individually. Batching is an optimization, never
a correctness gate — but there is no second execution path to fall to.

The mesh-sharded fan-out executor (search/mesh_executor.py) shares this
module's eligibility and demux seams — ``classify_request`` (so a query
is mesh-eligible iff it is batch-eligible), ``_build_ctxs`` (reader
snapshots become SegmentContexts identically) and ``_knn_demux`` (the
per-shard merge semantics) — which is what keeps a fan-out served from
the mesh byte-compatible with the same fan-out served shard-by-shard
through this batcher.
"""

from __future__ import annotations

import time
import uuid as uuid_mod
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.device import DeviceLike, resolve_device
from elasticsearch_tpu_torch.ops.bm25 import DEFAULT_B, DEFAULT_K1, P1_BUCKET
from elasticsearch_tpu_torch.search import dsl, telemetry
from elasticsearch_tpu_torch.search.phase import ShardDoc, parse_sort, wand_clauses
from elasticsearch_tpu_torch.search.telemetry import TELEMETRY, SearchTrace
from elasticsearch_tpu_torch.utils.errors import (
    SearchBudgetExceededError, ShardBusyError, TaskCancelledError,
)
from elasticsearch_tpu_torch.utils.settings import (
    SEARCH_BATCH_ENABLED, SEARCH_BATCH_MAX_SIZE, SEARCH_BATCH_MAX_WINDOW_MS,
    SEARCH_BATCH_TARGET_OCCUPANCY, SEARCH_SHARD_MAX_QUEUED_MEMBERS,
    SEARCH_SHARD_QUEUE_TARGET_LATENCY,
)


class _AllMembersDead(Exception):
    """Internal: every member expired/cancelled mid-batch; stop paying
    for device work nobody will read."""


# body clauses whose presence routes a request to the per-member dense
# kind: they either force the dense collector in query_shard or carry
# per-request state the shared device demux does not model
_DENSE_CLAUSES = ("aggs", "aggregations", "suggest", "rescore", "collapse",
                  "slice", "profile", "terminate_after")


@dataclass
class BatchSpec:
    """Classification result: the batch key components plus this member's
    private payload (clauses / query vector / expansion tokens — or, for
    the ``dense`` kind, the canonical request identity the per-drain
    memo dedups on)."""
    kind: str                      # "text" | "knn" | "sparse" | "dense"
    field: str
    window: int
    # text: counts-then-skip limit (0 = totals disabled);
    # knn/sparse: coordinator clip threshold (None = never clip)
    track_limit: int = 0
    clip_limit: Optional[int] = None
    clauses: Optional[List[Tuple[str, float]]] = None
    query_vector: Optional[List[float]] = None
    k: int = 10
    num_candidates: int = 100
    tokens: Optional[Dict[str, float]] = None
    boost: float = 1.0
    # filtered kNN: the parsed filter tree plus a stable value key —
    # members with DIFFERENT filters still share a batch (per-query mask
    # stack); equal keys share one mask computation per segment
    filter: Any = None
    filter_key: Optional[str] = None
    # the parsed + alias-resolved query tree (text class): classification
    # already paid the parse, so the drain's term-stats pass reuses it
    # instead of re-parsing the raw body on the hot path
    query: Any = None
    # dense kind: the canonical request identity (body + window + stat
    # overrides, JSON-normalized) — the per-drain memo key
    dense_key: Optional[str] = None

    def key(self) -> Tuple:
        if self.kind == "text":
            return ("text", self.field, self.window, self.track_limit)
        if self.kind == "knn":
            return ("knn", self.field, self.window, self.clip_limit, self.k)
        if self.kind == "sparse":
            return ("sparse", self.field, self.window, self.clip_limit)
        # every dense member of a shard shares one queue (the shared
        # reader acquisition IS the win; execution is per member anyway)
        return ("dense",)

    def memo_key(self) -> Tuple:
        """Identity for the per-drain memo: two members whose memo keys
        coincide are the SAME plan (kind/field/window/totals are already
        fixed by the batch key, so only the private payload matters)."""
        if self.kind == "text":
            return ("text", tuple(self.clauses or ()))
        if self.kind == "knn":
            return ("knn", tuple(self.query_vector or ()), self.boost,
                    self.num_candidates, self.filter_key)
        if self.kind == "sparse":
            return ("sparse", tuple(sorted((self.tokens or {}).items())),
                    self.boost)
        return ("dense", self.dense_key)


@dataclass
class _Member:
    req: Dict[str, Any]
    spec: BatchSpec
    deferred: Any
    enqueued_at: float
    enqueued_wall: float
    task: Any = None
    deadline: Optional[float] = None
    error: Optional[Exception] = None
    result: Optional[Dict[str, Any]] = None
    trace: Any = None
    enqueued_ns: int = 0


# histogram class per batch kind (search/telemetry.py labels); dense
# members classify from their body shape at enqueue
_CLASS_OF_KIND = {"text": "bm25", "knn": "knn", "sparse": "sparse"}


def _copy_compiles(source: SearchTrace, dest: SearchTrace) -> None:
    """A drain's compiles (device observatory attribution) belong to
    every member that shared the dispatch: the slow-log first-compile
    flag and the profile compile spans must land on the member traces,
    not die with the drain-scoped trace."""
    if not source.compiles:
        return
    dest.compiles += source.compiles
    for name, dur_ns, meta in source.spans:
        if name == "compile":
            dest.add_span(name, dur_ns, dict(meta) if meta else None)


def dense_spec(req: Dict[str, Any]) -> BatchSpec:
    """The per-member execution kind: a canonical request identity for
    the per-drain memo (identical dense members execute once per drain,
    rows fanned out copy-on-write), no device-batch payload."""
    import json as _json
    body = req.get("body") or {}
    try:
        key = _json.dumps(
            [body, req.get("window", 0), req.get("df_overrides"),
             req.get("doc_count_override"),
             req.get("field_stats_overrides")],
            sort_keys=True, default=str)
    except Exception:  # noqa: BLE001 — unserializable body: never memo
        key = uuid_mod.uuid4().hex
    return BatchSpec(kind="dense", field="", window=int(
        req.get("window", 0) or 0), dense_key=key)


def classify_request(req: Dict[str, Any], mappers) -> BatchSpec:
    """The kind of batch member this shard query becomes. Never None and
    never raises: ``text`` / ``knn`` / ``sparse`` when the shared device
    demux can reproduce the response byte-for-byte (the conditions
    mirror ``choose_collector_context``), the per-member ``dense`` kind
    for everything else — aggregations, suggest, nested, spans, rescore,
    collapse, profile, non-score sorts, DFS overrides, size-0 counts.
    A query whose body cannot even classify still executes (as dense);
    its real error surfaces from execution, not from routing."""
    try:
        return _classify(req, mappers)
    except Exception:  # noqa: BLE001 — classification must never fail a
        return dense_spec(req)  # query; execution reports the error


def _classify(req: Dict[str, Any], mappers) -> BatchSpec:
    window = int(req.get("window", 0))
    if window <= 0:
        return dense_spec(req)   # size-0 counts: no top-k to share
    # DFS overrides change idf/avgdl inputs per request: per-member
    if req.get("df_overrides") or req.get("doc_count_override") \
            or req.get("field_stats_overrides"):
        return dense_spec(req)
    body = req.get("body") or {}
    for clause in _DENSE_CLAUSES:
        if body.get(clause):
            return dense_spec(req)
    if body.get("min_score") is not None or \
            body.get("search_after") is not None:
        return dense_spec(req)
    if body.get("sort") is not None:
        sort = parse_sort(body.get("sort"))
        if not (len(sort) == 1 and sort[0].field == "_score"
                and sort[0].order == "desc"):
            return dense_spec(req)
    track = body.get("track_total_hits", 10_000)
    from elasticsearch_tpu_torch.search.execute import resolve_aliases
    query = resolve_aliases(dsl.parse_query(body.get("query")), mappers)

    wc = wand_clauses(query, mappers)
    if wc is not None:
        if track is True:
            return dense_spec(req)   # unbounded exact counting
        w_field, clauses = wc
        return BatchSpec(kind="text", field=w_field, window=window,
                         track_limit=int(track) if track else 0,
                         clauses=clauses, query=query)

    exact_total = track is True or (isinstance(track, int) and track > 0)
    clip = int(track) if (exact_total and track is not True) else None
    if isinstance(query, dsl.Knn):
        mapper = mappers.mapper(query.field)
        if mappers.field_type(query.field) != "dense_vector":
            return dense_spec(req)
        opts = getattr(mapper, "index_options", None) or {}
        if opts.get("type") not in (None, "ivf"):
            return dense_spec(req)   # unknown index type
        # filtered kNN batches: the filter becomes a per-query (or
        # shared) mask inside the batched matmul, exactly the dense
        # path's live & fmask; IVF-routed segments batch the probe
        return BatchSpec(kind="knn", field=query.field, window=window,
                         clip_limit=clip, query_vector=query.query_vector,
                         k=int(query.k), boost=float(query.boost),
                         num_candidates=int(query.num_candidates),
                         filter=query.filter,
                         filter_key=(repr(query.filter)
                                     if query.filter is not None else None))
    if isinstance(query, dsl.TextExpansion) and query.tokens:
        return BatchSpec(kind="sparse", field=query.field, window=window,
                         clip_limit=clip, tokens=dict(query.tokens),
                         boost=float(query.boost))
    return dense_spec(req)


# ---------------------------------------------------------------------------
# batched shard execution (per query class)
# ---------------------------------------------------------------------------

def _build_ctxs(reader, mappers, doc_count: int,
                dfs: Optional[Dict[str, Dict[str, int]]],
                field_stats: Optional[Dict[str, Tuple[float, int]]] = None,
                device: DeviceLike = None):
    """SegmentContexts over the reader snapshot, exactly as query_shard
    builds them (point-in-time live masks, shard-level stat overrides)."""
    import torch

    from elasticsearch_tpu_torch.index.segment import BLOCK, next_pow2
    from elasticsearch_tpu_torch.search.execute import SegmentContext
    device = resolve_device(device)
    ctxs = []
    for si, (seg, live_host) in enumerate(zip(reader.segments,
                                              reader.live_masks)):
        n_pad = next_pow2(max(seg.n_docs, 1), minimum=BLOCK)
        snap = np.zeros(n_pad, bool)
        snap[: len(live_host)] = live_host
        ctxs.append(SegmentContext(seg, mappers, segment_idx=si,
                                   doc_count_override=doc_count,
                                   df_overrides=dfs,
                                   field_stats_overrides=field_stats,
                                   live_override=torch.as_tensor(
                                       snap, device=device),
                                   reader=reader, device=device))
    return ctxs


def batched_wand_topk_shard(ctxs, field: str,
                            clause_lists: List[List[Tuple[str, float]]],
                            want: int, track_limit: int,
                            check_members: Optional[Callable[[], None]]
                            = None) -> List[Tuple]:
    """THE pruned text top-k executor for the served path — Q queries
    in shared device dispatches, solo being simply Q=1 (query_shard
    calls this directly). Member-for-member exact in scores,
    candidates, totals semantics and prune accounting (each member
    keeps its OWN shard-global theta, derived from its own phase-1
    partials).

    Returns per member: (candidates, hits, relation, max_score,
    (blocks_total, blocks_scored))."""
    from elasticsearch_tpu_torch.search.execute import _bm25_executor
    if ctxs:
        from elasticsearch_tpu_torch.ops.device_segment import PLANES
        part = PLANES.get([c.segment for c in ctxs], "postings", field,
                          ctxs[0].device)
        if part is not None:
            from elasticsearch_tpu_torch.search.plane_exec import plane_wand_topk
            got = plane_wand_topk(ctxs, part, field, clause_lists, want,
                                  track_limit,
                                  check_members=check_members)
            if got is not None:
                return got
    count = track_limit > 0
    n_q = len(clause_lists)
    per_seg = []            # (ctx, ex, plans[n_q], k_seg, avgdl)
    seen_terms: List[Dict[str, float]] = [{} for _ in range(n_q)]
    has_terms = [False] * n_q
    for ctx in ctxs:
        analyzer = ctx.search_analyzer(field)
        ex = _bm25_executor(ctx, field)
        if ex is None:
            continue        # field has no postings in this segment
        df_map = ctx.df_for(field) or {}
        member_terms: List[List[Tuple[str, float]]] = []
        any_terms = False
        for qi, clauses in enumerate(clause_lists):
            terms: List[Tuple[str, float]] = []
            for text, boost in clauses:
                terms.extend((t, boost) for t in analyzer.terms(text))
            member_terms.append(terms)
            if terms:
                any_terms = True
                has_terms[qi] = True
                for t, _b in terms:
                    if t not in seen_terms[qi]:
                        seen_terms[qi][t] = float(df_map.get(t, 0))
        if not any_terms:
            continue
        k_seg = min(max(want, 1), ctx.n_docs_pad)
        avgdl = ex._avgdl(ctx.avgdl_for(field))
        plans = ex.build_plans(member_terms, df_override=df_map or None,
                               avgdl=avgdl)
        per_seg.append((ctx, ex, plans, k_seg, avgdl))

    empty = ([], 0, "eq", None, (0, 0))
    if not per_seg:
        return [empty] * n_q

    from elasticsearch_tpu_torch.ops.bm25 import QueryPlan
    empty_plan = QueryPlan([], [], [], [])

    hits_upper = [int(sum(s.values())) for s in seen_terms]
    exact_mode = [count and hits_upper[qi] <= track_limit
                  for qi in range(n_q)]

    # phase A, one dispatch per segment: exact-mode members score ALL
    # their blocks (counted — their results are final); pruned members
    # score their P1_BUCKET highest-upper-bound blocks to establish theta
    counted_a = any(exact_mode)
    res_a = []
    for ctx, ex, plans, k_seg, avgdl in per_seg:
        if check_members is not None:
            check_members()
        rows = [p if exact_mode[qi] else p.top_by_ub(P1_BUCKET)
                for qi, p in enumerate(plans)]
        res_a.append(ex._dispatch_flat(rows, ctx.live, k_seg, DEFAULT_K1,
                                       DEFAULT_B, avgdl, counted=counted_a))

    # per-member shard-global theta from that member's own partials
    theta = np.full(n_q, -np.inf)
    s_a = [np.asarray(r[0]) for r in res_a]
    for qi in range(n_q):
        if exact_mode[qi]:
            continue
        partials = np.concatenate([s[qi] for s in s_a])
        finite = partials[np.isfinite(partials)]
        if len(finite) >= want:
            theta[qi] = float(np.sort(finite)[-want])

    # phase B, one dispatch per segment: pruned members' WAND survivors,
    # scored exactly (exact members ride along as empty rows so the row
    # index stays the member index)
    blocks_total = [0] * n_q
    blocks_scored = [0] * n_q
    hits_exact = [True] * n_q
    res_b = []
    need_b = not all(exact_mode)
    for ctx, ex, plans, k_seg, avgdl in per_seg:
        if check_members is not None:
            check_members()
        rows = []
        for qi, p in enumerate(plans):
            if exact_mode[qi]:
                blocks_total[qi] += p.n_blocks
                blocks_scored[qi] += p.n_blocks
                rows.append(empty_plan)
                continue
            surv = p.survivors(float(theta[qi]))
            p1_cost = min(p.n_blocks, P1_BUCKET)
            blocks_total[qi] += p.n_blocks
            blocks_scored[qi] += min(surv.n_blocks + p1_cost, p.n_blocks)
            hits_exact[qi] = hits_exact[qi] and \
                surv.n_blocks >= p.n_blocks
            rows.append(surv)
        if need_b:
            res_b.append(ex._dispatch_flat(rows, ctx.live, k_seg,
                                           DEFAULT_K1, DEFAULT_B, avgdl,
                                           counted=count))

    # demux: candidates (+ counts) per member
    out: List[Tuple] = []
    for qi in range(n_q):
        if not has_terms[qi]:
            out.append(empty)
            continue
        candidates: List[ShardDoc] = []
        max_score: Optional[float] = None
        hits_seen = 0
        for si_idx, (ctx, ex, plans, k_seg, avgdl) in enumerate(per_seg):
            got = res_a[si_idx] if exact_mode[qi] else res_b[si_idx]
            if count:
                s, d, h = got
                hits_seen += int(np.asarray(h)[qi])
            else:
                s, d = got
            s_row = np.asarray(s)[qi]
            d_row = np.asarray(d)[qi]
            for sc, doc in zip(s_row, d_row):
                if sc == -np.inf:
                    break
                candidates.append(ShardDoc(ctx.segment_idx, int(doc),
                                           float(sc), (float(sc),)))
                if max_score is None or sc > max_score:
                    max_score = float(sc)
        candidates.sort(key=lambda c: (-c.score, c.segment_idx, c.doc))
        prune = (blocks_total[qi], blocks_scored[qi])
        if not count:
            out.append((candidates, len(candidates), "gte", max_score,
                        prune))
        elif hits_seen >= track_limit:
            out.append((candidates, track_limit, "gte", max_score, prune))
        elif hits_exact[qi] or exact_mode[qi]:
            out.append((candidates, hits_seen, "eq", max_score, prune))
        else:
            out.append((candidates, None, None, max_score, prune))

    # members whose pruned counts might hide hits: one exact unpruned
    # counted pass (k=1, scores already final) — shared dispatches again
    recount = [qi for qi in range(n_q) if count and out[qi][1] is None]
    if recount:
        exact_hits = {qi: 0 for qi in recount}
        for ctx, ex, plans, k_seg, avgdl in per_seg:
            if check_members is not None:
                check_members()
            rows = [plans[qi] if qi in exact_hits else empty_plan
                    for qi in range(n_q)]
            _s, _d, h = ex._dispatch_flat(rows, ctx.live, 1, DEFAULT_K1,
                                          DEFAULT_B, avgdl, counted=True)
            h = np.asarray(h)
            for qi in exact_hits:
                exact_hits[qi] += int(h[qi])
        for qi in recount:
            candidates, _, _, max_score, prune = out[qi]
            # >= : relation at count == track_limit is "gte" on every
            # path — matches exact-mode/observed-full members and the
            # quantized coarse tier (see plane_exec's recount)
            if exact_hits[qi] >= track_limit:
                out[qi] = (candidates, track_limit, "gte", max_score,
                           prune)
            else:
                out[qi] = (candidates, exact_hits[qi], "eq", max_score,
                           prune)
    return out


def batched_knn_shard(ctxs, field: str, specs: List[BatchSpec],
                      k: int, check_members: Optional[Callable[[], None]]
                      = None, stats: Optional[Dict[str, float]] = None
                      ) -> List[Tuple]:
    """Q kNN queries through THE kNN executor (execute.knn_shard_winners
    -- the same call-site the solo rewrite is, with Q>1), demuxed to the
    dense collector's candidates/totals shape. A resident plane may
    raise PlaneFallback (IVF-routed members whose num_candidates imply
    different probe widths); the per-segment routing batches the probe
    per derived width and never falls back. ``stats`` gathers the
    filter-mask counters (``filter_mask_reuses``,
    ``knn_shared_mask_segments``)."""
    from elasticsearch_tpu_torch.search.execute import knn_shard_winners
    per_member_hits = knn_shard_winners(ctxs, field, specs, k,
                                        check_members, stats)
    return _knn_demux(specs, per_member_hits, k)


def _knn_demux(specs: List[BatchSpec],
               per_member_hits: List[List[Tuple[int, int, float]]],
               k: int) -> List[Tuple]:
    """Per-member shard-global merge (rewrite_knn's semantics) shared by
    the plane and per-segment batch paths."""
    out = []
    for qi, spec in enumerate(specs):
        hits = per_member_hits[qi]
        hits.sort(key=lambda x: -x[2])     # rewrite_knn's merge order
        winners = hits[: k]
        boost = spec.boost
        candidates = [ShardDoc(si, doc, sc * boost, (sc * boost,))
                      for si, doc, sc in winners]
        candidates.sort(key=lambda c: (-c.score, c.segment_idx, c.doc))
        max_score = max((c.score for c in candidates), default=None)
        total = len(winners)
        relation = "eq"
        if spec.clip_limit is not None and total > spec.clip_limit:
            total, relation = spec.clip_limit, "gte"
        out.append((candidates, total, relation, max_score, None))
    return out


def sparse_topk_shard(ctxs, field: str,
                      expansions: List[List[Tuple[str, float]]],
                      want: int,
                      check_members: Optional[Callable[[], None]] = None
                      ) -> List[Tuple]:
    """THE resolved-expansion top-k executor for the served path — Q
    expansions (solo being simply Q=1) through the rank-features plane
    when resident, else one batched launch per segment; exact counts
    read off the score plane (the dense path's mask sum). Returns
    (candidates, total, max_score) per member."""
    from elasticsearch_tpu_torch.ops.device_segment import DeviceFeatures
    from elasticsearch_tpu_torch.ops.sparse import SparseExecutor
    n_q = len(expansions)
    if ctxs:
        from elasticsearch_tpu_torch.ops.device_segment import PLANES
        part = PLANES.get([c.segment for c in ctxs], "features", field,
                          ctxs[0].device)
        if part is not None:
            from elasticsearch_tpu_torch.search.plane_exec import (
                plane_sparse_topk,
            )
            return plane_sparse_topk(ctxs, part, field, expansions, want,
                                     check_members=check_members)
    from elasticsearch_tpu_torch.indices.breaker import BREAKERS
    candidates: List[List[ShardDoc]] = [[] for _ in range(n_q)]
    totals = [0] * n_q
    for ctx in ctxs:
        dev = DeviceFeatures.for_segment(ctx.segment, field, ctx.device)
        if dev is None:
            continue
        if check_members is not None:
            check_members()
        ex = SparseExecutor(dev, ctx.segment.features[field])
        k_seg = min(max(want, 1), ctx.n_docs_pad)
        # the ONE charge site for per-segment sparse scoring (the plane
        # branch above charges inside plane_sparse_topk): one transient
        # score plane per segment launch
        with BREAKERS.breaker("request").limit_scope(
                8 * ctx.n_docs_pad * n_q, "sparse_topk"):
            s, d, h = ex.top_k_batch(expansions, ctx.live, k_seg,
                                     function="linear", count_hits=True)
        s = s.cpu().numpy()
        d = d.cpu().numpy()
        for qi in range(n_q):
            totals[qi] += int(h[qi])
            for sc, doc in zip(s[qi], d[qi]):
                if sc == -np.inf:
                    break
                candidates[qi].append(ShardDoc(ctx.segment_idx, int(doc),
                                               float(sc), (float(sc),)))
    out = []
    for qi in range(n_q):
        cands = candidates[qi]
        cands.sort(key=lambda c: (-c.score, c.segment_idx, c.doc))
        out.append((cands, totals[qi],
                    max((c.score for c in cands), default=None)))
    return out


def batched_sparse_shard(ctxs, field: str, specs: List[BatchSpec],
                         want: int,
                         check_members: Optional[Callable[[], None]]
                         = None) -> List[Tuple]:
    """Q resolved text_expansion members through ``sparse_topk_shard``,
    demuxed to the dense collector's candidates/totals shape (per-member
    coordinator clip applied)."""
    expansions = [[(t, w * s.boost) for t, w in s.tokens.items()]
                  for s in specs]
    got = sparse_topk_shard(ctxs, field, expansions, want, check_members)
    out = []
    for (cands, total, max_score), spec in zip(got, specs):
        relation = "eq"
        if spec.clip_limit is not None and total > spec.clip_limit:
            total, relation = spec.clip_limit, "gte"
        out.append((cands, total, relation, max_score, None))
    return out


# ---------------------------------------------------------------------------
# the batcher
# ---------------------------------------------------------------------------

class ShardQueryBatcher:
    """Per-data-node adaptive micro-batcher; owned by
    SearchTransportService, driven entirely on the scheduler's dispatch
    context (no locks — the same single-threaded discipline every handler
    already runs under)."""

    LAST_DISPATCH_CAP = 1024

    def __init__(self, sts):
        self.sts = sts
        self._queues: Dict[Tuple, List[_Member]] = {}
        self._timers: Dict[Tuple, Any] = {}
        # self-reported pressure (search/service.py NodePressure):
        # queue depth + in-flight + service-time EWMA, piggybacked on
        # every shard query response for C3 replica selection
        from elasticsearch_tpu_torch.search.service import NodePressure
        self.node_pressure = NodePressure()
        # chaos seam: > 0 delays every drain's DELIVERY by this many
        # scheduler seconds and counts itself into the observed service
        # time — a saturated/slow data node without touching the wire
        # (the overload chaos suite's slow-node-reroute scenario)
        self.fault_drain_delay_s = 0.0
        # per-key controller state: {"last": <dispatch time>, "window":
        # <current adaptive collection window, seconds>, "max_size":
        # <HBM-pressure-adapted cap, None = the setting>} — the
        # occupancy/pressure feedback loops' memory, FIFO-bounded like
        # the old recency map
        self._key_state: Dict[Tuple, Dict[str, float]] = {}
        self.stats: Dict[str, float] = {
            "batches_dispatched": 0,
            "queries_dispatched": 0,
            "max_occupancy": 0,
            "wait_ms_total": 0.0,
            "queries_expired": 0,
            "queries_cancelled": 0,
            # the one degrade lane: members re-drained at occupancy 1
            # after a shared-execution failure
            "member_redrains": 0,
            # per-drain memo + occupancy-feedback controller
            "memo_hits": 0,
            "window_grows": 0,
            "window_shrinks": 0,
            "knn_shared_mask_segments": 0,
            "filter_mask_reuses": 0,
            # adaptive per-key max_size under HBM pressure
            "max_size_shrinks": 0,
            "max_size_grows": 0,
            # breaker-charge feedback: caps shrunk from the OBSERVED
            # per-drain charge before any trip (PR 9 follow-up)
            "max_size_preshrinks": 0,
            # request-cache hits answered AT INTAKE (no collection wait)
            "request_cache_intake_hits": 0,
            # shard-side shed point (search.shard.max_queued_members):
            # members rejected AT INTAKE with a typed shard_busy error —
            # each shed counts here exactly once (and once in the
            # telemetry fallback taxonomy, never anywhere else)
            "shard_busy_sheds": 0,
            # high-water mark of QUEUED (not yet drained) members — the
            # shed-point correctness witness: with the bound set, no
            # drain may ever observe more queued members than the bound
            "queued_members_hwm": 0,
        }
        # last Retry-After issued by a shard_busy shed (stats surface)
        self.last_shard_retry_after_s = 0

    # -- settings (dynamic, from committed cluster state) ---------------

    def _setting(self, setting):
        from elasticsearch_tpu_torch.utils.settings import setting_from_state
        state = self.sts.state() if self.sts.state is not None else None
        return setting_from_state(state, setting)

    def enabled(self) -> bool:
        return self._setting(SEARCH_BATCH_ENABLED)

    def max_window_s(self) -> float:
        return self._setting(SEARCH_BATCH_MAX_WINDOW_MS) / 1000.0

    def max_size(self) -> int:
        return self._setting(SEARCH_BATCH_MAX_SIZE)

    def target_occupancy(self) -> int:
        return self._setting(SEARCH_BATCH_TARGET_OCCUPANCY)

    def _scheduler(self):
        return self.sts.ts.transport.scheduler

    def _key_max_size(self, key: Tuple) -> int:
        """Effective per-key drain cap: the setting, shrunk while the
        key is under HBM pressure (breaker trips halve it; successful
        full drains regrow it) — and PRE-shrunk from the breaker's
        OBSERVED per-drain charge: once a drain has measured what one
        member actually costs, the cap stops growing past what the
        current breaker headroom can admit, so the adaptive max_size
        reacts before the first trip instead of after."""
        cap = self.max_size()
        st = self._key_state.get(key)
        if st is not None and st.get("max_size"):
            cap = min(cap, int(st["max_size"]))
        per = st.get("charge_per_member") if st is not None else None
        if per:
            from elasticsearch_tpu_torch.indices.breaker import BREAKERS
            breaker = BREAKERS.breaker("request")
            if breaker.limit > 0:
                # 0.8: leave slack for drain-mates' transients so the
                # estimate errs toward shrinking, never toward a trip
                headroom = max(breaker.limit - breaker.used, 0) * 0.8
                fit = max(1, int(headroom // per))
                if fit < cap:
                    cap = fit
                    self.stats["max_size_preshrinks"] += 1
        return cap

    def queue_depth(self) -> int:
        """Queued (not yet drained) members across every key — the
        node's search-queue depth in the pressure piggyback."""
        return sum(len(q) for q in self._queues.values())

    # -- shard-side shed point ------------------------------------------

    def shard_queue_limit(self) -> int:
        """Effective per-node member bound: ``search.shard.max_queued_
        members`` (0 = unbounded, today's behavior byte-for-byte),
        SHRUNK by the same Little's-law controller the coordinator pool
        uses — once NodePressure has a drain-measured service EWMA, the
        bound that holds admitted shard work to ``search.shard.queue_
        target_latency`` is drain_rate * target; a node may never hold
        more members than it can serve inside the latency target."""
        cap = self._setting(SEARCH_SHARD_MAX_QUEUED_MEMBERS)
        if cap <= 0:
            return 0
        target = self._setting(SEARCH_SHARD_QUEUE_TARGET_LATENCY)
        rate = self.node_pressure.drain_rate_per_s()
        if target > 0 and rate > 0:
            ideal = int(rate * float(target))
            if ideal < cap:
                cap = max(1, ideal)
        return cap

    def member_occupancy(self) -> int:
        """Queued + in-flight members — what the member bound governs."""
        return self.queue_depth() + self.node_pressure.in_flight

    def at_member_bound(self) -> bool:
        """THE one definition of 'this node is over its member bound' —
        shared by the intake shed point below and the mesh executors'
        fast-path refusals, so the bound cannot silently diverge between
        the RPC and mesh serving paths."""
        limit = self.shard_queue_limit()
        return limit > 0 and self.member_occupancy() >= limit

    def _shed_check(self, req: Dict[str, Any]) -> None:
        """THE shard-side shed point: with the member bound set, an
        arrival that would push queued + in-flight members past it is
        rejected NOW, with a typed, Retry-After-carrying shard_busy
        error — it never touches a drain, never registers a task, never
        acquires a reader. The coordinator fails it over to the next
        ranked copy (the reference's retry-on-next-replica contract).
        Limit and occupancy are computed ONCE (at_member_bound's
        definition inlined) so the shed message reports the exact
        occupancy that triggered it."""
        limit = self.shard_queue_limit()
        if limit <= 0:
            return
        occupied = self.member_occupancy()
        if occupied < limit:
            return
        self.stats["shard_busy_sheds"] += 1
        retry_after = self.node_pressure.retry_after_s(occupied)
        self.last_shard_retry_after_s = retry_after
        TELEMETRY.count_fallback(telemetry.SHARD_BUSY)
        # retry_after=/queued= ride the MESSAGE: transport errors are
        # stringified on the wire, so the payload must survive in text
        # (utils/errors.shard_busy_info is the decoder)
        raise ShardBusyError(
            f"shard [{req.get('index')}][{req.get('shard')}] busy: "
            f"{occupied} members in flight (limit {limit}); "
            f"retry_after={retry_after}s queued={occupied}",
            retry_after=retry_after, queued=occupied)

    def shard_queue_stats(self) -> Dict[str, Any]:
        """The ``search_admission.shard_queue`` stats block: the
        configured and effective member bounds, live occupancy, shed
        count, the drain-rate estimate Retry-After is computed from, and
        the queued-members high-water mark."""
        return {
            "limit": self._setting(SEARCH_SHARD_MAX_QUEUED_MEMBERS),
            "effective_limit": self.shard_queue_limit(),
            "queued": self.queue_depth(),
            "in_flight": self.node_pressure.in_flight,
            "sheds": self.stats["shard_busy_sheds"],
            "queued_members_hwm": self.stats["queued_members_hwm"],
            "last_retry_after_s": self.last_shard_retry_after_s,
            "drain_rate_per_s": round(
                self.node_pressure.drain_rate_per_s(), 3),
        }

    # -- intake ---------------------------------------------------------

    def enqueue(self, req: Dict[str, Any],
                arrival_ns: Optional[int] = None) -> Any:
        """THE shard query entry point: every query becomes a batch
        member (occupancy-1 keys drain on the next scheduler tick, so an
        isolated query pays one hop — latency unchanged vs a dedicated
        solo path). Returns the transport Deferred the drain answers —
        or the response dict directly for a request-cache hit at intake
        (a cacheable duplicate never waits out a collection window).
        ``search.batch.enabled: false`` forces window 0 through this
        same path.

        Raises ShardBusyError when the node is at its member bound
        (search.shard.max_queued_members): the shed binds BEFORE
        classification and task registration — an overloaded node
        spends nothing on work it cannot admit. The request-cache
        consult runs BEFORE the shed: a hit consumes no queued-member
        slot and costs sub-millisecond host time, so the cache is the
        member bound's pressure-relief valve — the hot head of a
        duplicate flood is served for free at the exact moment the
        node is shedding, instead of being 429'd into a coordinator
        failover round for work that costs nothing."""
        scheduler = self._scheduler()
        # request-cache intake consult for EVERY kind, before the shed
        # point and before classification: a cacheable duplicate over an
        # unmoved generation answers NOW — no parse, no collection
        # window, no device dispatch. The hit is served traffic: it
        # counts into the NodePressure observation windows (without
        # consuming a queued-member slot) and carries the same
        # took/pressure piggyback a drained response would, so ARS
        # never goes blind on cache-served duplicates.
        try:
            cached = self.sts.request_cache_lookup(req, arrival_ns)
        except Exception:  # noqa: BLE001 — a broken lookup serves
            cached = None  # uncached, never fails the query
        if cached is not None:
            self.stats["request_cache_intake_hits"] += 1
            self.node_pressure.observe_cached()
            now_ns = time.monotonic_ns()
            took_ms = max((now_ns - (arrival_ns or now_ns)) / 1e6, 0.0)
            return {**cached, "took_ms": round(took_ms, 3),
                    "pressure": self.node_pressure.snapshot(
                        self.queue_depth())}
        self._shed_check(req)
        try:
            shard = self.sts.indices.shard(req["index"], req["shard"])
            frozen = False
            if self.sts.state is not None:
                from elasticsearch_tpu_torch.xpack.searchable_snapshots import (
                    is_frozen,
                )
                frozen = is_frozen(self.sts.state(), req["index"])
            spec = classify_request(req, shard.engine.mappers)
            if frozen and spec.kind != "dense":
                # frozen index: per-search device residency — the dense
                # member path evicts rebuilt caches after the drain
                spec = dense_spec(req)
        except Exception:  # noqa: BLE001 — intake must never fail a
            # query before execution can report its real error
            spec = dense_spec(req)

        from elasticsearch_tpu_torch.transport.transport import Deferred
        member = _Member(req=req, spec=spec, deferred=Deferred(),
                         enqueued_at=scheduler.now(),
                         enqueued_wall=time.monotonic())
        # queue-wait telemetry runs arrival -> drain (the collection
        # window IS the wait the trace must attribute)
        member.enqueued_ns = arrival_ns or time.monotonic_ns()
        if spec.kind == "dense":
            trace_class = telemetry.classify_body(req.get("body") or {})
        else:
            trace_class = _CLASS_OF_KIND.get(spec.kind, "other")
        member.trace = SearchTrace(trace_class, "batch")
        member.trace.t0_ns = member.enqueued_ns
        if self.sts.task_manager is not None:
            member.task = self.sts.task_manager.register(
                "indices:data/read/search[phase/query]",
                f"shard query [{req['index']}][{req['shard']}]",
                cancellable=True,
                parent_task_id=req.get("task_id"))
            member.task.status = {"phase": "queued", "data_plane": "batch"}
        remaining = req.get("budget_remaining")
        if remaining is not None:
            member.deadline = scheduler.now() + float(remaining)

        key = (req["index"], req["shard"]) + spec.key()
        queue = self._queues.setdefault(key, [])
        queue.append(member)
        self.stats["queued_members_hwm"] = max(
            self.stats["queued_members_hwm"], self.queue_depth())
        if len(queue) >= self._key_max_size(key):
            timer = self._timers.pop(key, None)
            if timer is not None:
                timer.cancel()
            self._drain(key)
        elif key not in self._timers:
            # adaptive window: a key with recent traffic waits up to its
            # occupancy-tuned window (never past max_window_ms) for
            # batch-mates; an idle key — or a disabled batcher (window
            # 0, the same path) — drains on the next scheduler tick
            # (which still coalesces every same-tick arrival already in
            # the dispatch queue)
            wait = 0.0
            if self.enabled():
                window_cap = self.max_window_s()
                st = self._key_state.get(key)
                recent = st is not None and \
                    (scheduler.now() - st["last"]) <= window_cap
                wait = min(st["window"], window_cap) if recent else 0.0
            self._timers[key] = scheduler.schedule(
                wait, lambda: self._drain(key))
        return member.deferred

    # -- member lifecycle ----------------------------------------------

    def _member_error(self, m: _Member) -> Optional[Exception]:
        """This member's expiry/cancellation error, if it is dead."""
        if m.task is not None:
            try:
                m.task.ensure_not_cancelled()
            except TaskCancelledError as e:
                self.stats["queries_cancelled"] += 1
                return e
        if m.deadline is not None and \
                self._scheduler().now() >= m.deadline:
            self.stats["queries_expired"] += 1
            return SearchBudgetExceededError(
                f"search budget expired while querying "
                f"[{m.req['index']}][{m.req['shard']}]")
        return None

    def _finish(self, m: _Member) -> None:
        if m.task is not None and self.sts.task_manager is not None:
            self.sts.task_manager.unregister(m.task)
            m.task = None
        if m.error is not None:
            m.deferred.reject(m.error)
        else:
            m.deferred.resolve(m.result)

    # -- drain ----------------------------------------------------------

    def _drain(self, key: Tuple) -> None:
        timer = self._timers.pop(key, None)
        if timer is not None:
            timer.cancel()
        members = self._queues.pop(key, [])
        if not members:
            return
        scheduler = self._scheduler()
        now = scheduler.now()
        # per-key controller state is FIFO-bounded: the key space includes
        # client-controlled components (window, totals), so an unbounded
        # dict would grow with request-shape variety for the process
        # lifetime. Losing an old entry only costs one immediate drain
        # and a window reset.
        window_cap = self.max_window_s()
        st = self._key_state.pop(key, None)
        if st is None:
            # fresh key: start the adaptive window small; full drains
            # grow it toward the cap
            st = {"window": window_cap / 4.0, "max_size": None}
        st["last"] = now
        self._key_state[key] = st
        while len(self._key_state) > self.LAST_DISPATCH_CAP:
            self._key_state.pop(next(iter(self._key_state)))

        # per-query deadline/cancellation binds at drain entry: a query
        # whose budget expired while queued fails individually, exactly
        # as the solo path's pre-collection check would fail it
        live: List[_Member] = []
        for m in members:
            m.error = self._member_error(m)
            if m.error is not None:
                self._finish(m)
            else:
                live.append(m)

        # occupancy feedback: a key whose drains keep running full earns
        # a longer collection window (more coalescing under load); a key
        # that drains thin gives the latency back. Bounded by
        # max_window_ms above, max_window_ms/16 below so the window can
        # always recover in a few drains.
        if len(live) >= self.target_occupancy():
            grown = min(window_cap,
                        max(st["window"] * 2.0, window_cap / 16.0))
            if grown > st["window"]:
                self.stats["window_grows"] += 1
            st["window"] = grown
        elif len(live) <= 1:
            shrunk = max(window_cap / 16.0, st["window"] / 2.0)
            if shrunk < st["window"]:
                self.stats["window_shrinks"] += 1
            st["window"] = shrunk
        if not live:
            return

        self.stats["batches_dispatched"] += 1
        self.stats["queries_dispatched"] += len(live)
        self.stats["max_occupancy"] = max(self.stats["max_occupancy"],
                                          len(live))
        self.node_pressure.in_flight += len(live)
        now_ns = time.monotonic_ns()
        for m in live:
            self.stats["wait_ms_total"] += (now - m.enqueued_at) * 1e3
            m.trace.add_span("queue_wait", now_ns - m.enqueued_ns)
            if m.task is not None:
                m.task.status = {"phase": "query", "data_plane": "batch"}

        # one drain = one execution: device work is shared, so every
        # member's trace carries the SAME device_dispatch span (annotated
        # with the drain occupancy) — that is the honest attribution of a
        # coalesced dispatch. Dense members execute (and trace) per
        # member inside _execute instead.
        dense = live[0].spec.kind == "dense"
        drain_trace = SearchTrace(
            _CLASS_OF_KIND.get(live[0].spec.kind, "other"), "batch")
        fell_back = False
        try:
            with telemetry.activate(drain_trace):
                self._execute(key, live)
        except _AllMembersDead:
            pass   # every member already carries its own error
        except Exception as e:  # noqa: BLE001 — the shared execution
            # must never lose queries: the ONE degrade lane re-drains
            # each surviving member as a batch of one through the same
            # _execute (minimal breaker transient, no plane member
            # disagreement possible at occupancy 1)
            fell_back = True
            from elasticsearch_tpu_torch.search.plane_exec import PlaneFallback
            from elasticsearch_tpu_torch.utils.errors import CircuitBreakingError
            TELEMETRY.count_fallback(
                telemetry.BATCH_IVF_NPROBE_DISAGREEMENT
                if isinstance(e, PlaneFallback) else
                telemetry.BATCH_BREAKER_REFUSED
                if isinstance(e, CircuitBreakingError) else
                telemetry.BATCH_EXEC_ERROR, len(live))
            if isinstance(e, CircuitBreakingError):
                # HBM pressure: halve this key's effective drain cap so
                # the next drains fit the budget; regrown by successful
                # full drains below
                shrunk = max(1, len(live) // 2)
                if shrunk < (st.get("max_size") or self.max_size()):
                    st["max_size"] = shrunk
                    self.stats["max_size_shrinks"] += 1
            self.stats["member_redrains"] += len(live)
            for m in live:
                if m.error is not None or m.result is not None:
                    continue
                t_re = time.monotonic_ns()
                sub = SearchTrace(m.trace.query_class, "batch")
                try:
                    with telemetry.activate(sub):
                        self._execute(key, [m])
                except _AllMembersDead:
                    continue   # m.error already set
                except Exception as e2:  # noqa: BLE001 — at occupancy 1
                    m.error = e2   # this is the query's own error
                    continue
                if not dense and m.result is not None:
                    m.trace.dispatches = sub.dispatches
                    m.trace.plane_backed = sub.plane_backed
                    _copy_compiles(sub, m.trace)
                    m.trace.add_span(
                        "device_dispatch", time.monotonic_ns() - t_re,
                        {"occupancy": 1, "redrain": 1})
                    m.trace.finish()
                    TELEMETRY.observe(m.trace)
        else:
            # successful shared drain at the full (shrunk) cap: regrow
            # the key's max_size toward the setting — headroom proved
            eff = st.get("max_size")
            if eff and len(live) >= eff:
                grown = min(self.max_size(), int(eff) * 2)
                if grown > eff:
                    st["max_size"] = None if grown >= self.max_size() \
                        else grown
                    self.stats["max_size_grows"] += 1
        if not fell_back and not dense:
            exec_ns = time.monotonic_ns() - now_ns
            meta = {"occupancy": len(live)}
            if drain_trace.dispatches:
                meta["dispatches"] = drain_trace.dispatches
            for m in live:
                if m.error is not None or m.result is None:
                    continue    # died mid-batch / delivered elsewhere
                t = m.trace
                t.dispatches = drain_trace.dispatches
                t.plane_backed = drain_trace.plane_backed
                _copy_compiles(drain_trace, t)
                t.add_span("device_dispatch", exec_ns, dict(meta))
                t.finish()
                TELEMETRY.observe(t)
        # pressure observation + delivery: every surviving member's
        # response carries the node's self-reported pressure (queue
        # depth, in-flight, service-time EWMA) and its own shard took —
        # the C3 feedback channel replica selection consumes. The chaos
        # seam (fault_drain_delay_s) delays DELIVERY in scheduler time
        # and counts itself into the observed service time.
        service_ms = (time.monotonic_ns() - now_ns) / 1e6
        delay = float(self.fault_drain_delay_s or 0.0)
        if delay > 0.0:
            service_ms += delay * 1000.0
        self.node_pressure.observe(service_ms, members=len(live))
        if delay > 0.0:
            scheduler.schedule(delay, lambda: self._deliver(live))
        else:
            self._deliver(live)
        # traffic may have queued behind a full-size drain
        if self._queues.get(key) and key not in self._timers:
            self._timers[key] = scheduler.schedule(
                0.0, lambda: self._drain(key))

    def _deliver(self, members: List[_Member]) -> None:
        """Resolve every drained member, stamping successful responses
        with the shard ``took_ms`` (arrival -> delivery in scheduler
        time — what the coordinator subtracts from its round trip to
        split wire from service) and the node pressure snapshot."""
        pressure = self.node_pressure
        now = self._scheduler().now()
        # ONE drain-consistent snapshot (taken while the drain's members
        # still count as in flight) shared copy-on-write by every member
        # — decrementing per member would make the last member report
        # in_flight=0 from a fully busy node
        snap = pressure.snapshot(self.queue_depth())
        for m in members:
            if m.error is None and isinstance(m.result, dict):
                took_ms = max((now - m.enqueued_at) * 1e3, 0.0)
                m.result = {**m.result, "took_ms": round(took_ms, 3),
                            "pressure": snap}
        pressure.in_flight = max(0, pressure.in_flight - len(members))
        for m in members:
            self._finish(m)

    def _set_phase(self, members: List[_Member], phase: str,
                   occupancy: Optional[int] = None,
                   data_plane: str = "batch") -> None:
        """_tasks phase fidelity: a shard task shows its current
        sub-phase (queued -> query -> dispatch -> demux) instead of
        "query" for its whole life — occupancy-1 members included.
        ``occupancy`` (drain width) rides the status so the hot-spans
        sampler (GET /_nodes/hot_spans) can show which in-flight spans
        share one device dispatch; ``data_plane`` is "dense_device" for
        members whose aggs ride the drain-wide columns plane."""
        for m in members:
            if m.task is not None and m.error is None:
                status = {"phase": phase, "data_plane": data_plane}
                if occupancy:
                    status["occupancy"] = occupancy
                m.task.status = status

    def _execute(self, key: Tuple, members: List[_Member]) -> None:
        from elasticsearch_tpu_torch.action.search_action import (
            CONTEXT_KEEP_ALIVE,
        )
        from elasticsearch_tpu_torch.search.phase import shard_term_stats
        index, shard_id = key[0], key[1]
        spec0 = members[0].spec
        shard = self.sts.indices.shard(index, shard_id)
        mappers = shard.engine.mappers
        reader = shard.engine.acquire_reader()

        def check_members() -> None:
            """Between device dispatches: mark freshly-dead members (the
            batch inherits the earliest member deadline — expiry is
            detected here, at dispatch granularity) and abort when no
            live member remains."""
            alive = 0
            for m in members:
                if m.error is None:
                    m.error = self._member_error(m)
                if m.error is None:
                    alive += 1
            if alive == 0:
                raise _AllMembersDead()

        # per-drain memo: members with an identical (plan, window,
        # totals) execute ONCE; their rows fan out below. The drain holds
        # one reader snapshot, so a memo hit can never cross a refresh —
        # unlike the request cache there is no freshness key to check.
        memo_index: Dict[Tuple, int] = {}
        uniques: List[_Member] = []
        assign: List[int] = []
        for m in members:
            mk = m.spec.memo_key()
            got = memo_index.get(mk)
            if got is None:
                got = len(uniques)
                memo_index[mk] = got
                uniques.append(m)
            else:
                self.stats["memo_hits"] += 1
            assign.append(got)

        if spec0.kind == "dense":
            self._execute_dense(shard, reader, members, uniques, assign)
            return

        # shard-level term stats exactly as query_shard computes them;
        # df per term is query-independent so the members' maps merge
        doc_count = sum(seg.n_docs for seg in reader.segments)
        dfs: Dict[str, Dict[str, int]] = {}
        if spec0.kind == "text":
            for u in uniques:
                _dc, m_dfs = shard_term_stats(reader, mappers,
                                              u.spec.query)
                for fname, termmap in m_dfs.items():
                    dfs.setdefault(fname, {}).update(termmap)
        ctxs = _build_ctxs(reader, mappers, doc_count,
                           dfs if spec0.kind == "text" else None,
                           device=shard.search.device)

        from elasticsearch_tpu_torch.index.segment import BLOCK
        from elasticsearch_tpu_torch.indices.breaker import BREAKERS
        breaker = BREAKERS.breaker("request")
        n_q = len(uniques)
        want = spec0.window
        self._set_phase(members, "dispatch", occupancy=len(members))
        # observe what the drain ACTUALLY charges (outer transient scope
        # plus everything the executors charge inside it) so the per-key
        # cap can pre-shrink from measurement instead of waiting for the
        # first trip (_key_max_size consults charge_per_member)
        with breaker.observe() as charge_obs:
            if spec0.kind == "text":
                transient = n_q * sum(
                    (P1_BUCKET * BLOCK * 8) + want * 8 for _ in ctxs)
                with breaker.limit_scope(transient, "wand_topk_batch"):
                    results = batched_wand_topk_shard(
                        ctxs, spec0.field,
                        [u.spec.clauses for u in uniques], want,
                        spec0.track_limit, check_members)
                collector = "wand_topk"
            elif spec0.kind == "knn":
                transient = n_q * sum(8 * ctx.n_docs_pad for ctx in ctxs)
                with breaker.limit_scope(transient, "knn_batch"):
                    results = batched_knn_shard(
                        ctxs, spec0.field, [u.spec for u in uniques],
                        spec0.k, check_members, stats=self.stats)
                collector = "dense"
            else:
                # sparse charges at its dispatch sites (the plane
                # executor's internal scope, or one score plane per
                # segment) — an outer scope here would double-charge the
                # plane path
                results = batched_sparse_shard(
                    ctxs, spec0.field, [u.spec for u in uniques], want,
                    check_members)
                collector = "dense"
        observed = max(charge_obs.peak - charge_obs.base, 0)
        st = self._key_state.get(key)
        if observed > 0 and st is not None:
            per = observed / max(n_q, 1)
            prev = st.get("charge_per_member")
            st["charge_per_member"] = per if not prev else \
                0.3 * per + 0.7 * prev

        self._set_phase(members, "demux", occupancy=len(members))
        # response rows are copy-on-write: the docs payload of a memo'd
        # plan is built ONCE for its unique and shared by every
        # duplicate (responses are serialized downstream, never
        # mutated); only the context_id differs per member
        rows: List[Optional[Dict[str, Any]]] = [None] * len(uniques)
        for m, ui in zip(members, assign):
            if m.error is not None:
                continue    # died mid-batch: fail, don't demux
            row = rows[ui]
            if row is None:
                candidates, total, relation, max_score, prune = \
                    results[ui]
                docs = candidates[: want]
                row = rows[ui] = {
                    "context_id": None,
                    "total": total,
                    "relation": relation,
                    "max_score": max_score,
                    "collector": collector,
                    "prune": list(prune) if prune else None,
                    "docs": [{"segment": d.segment_idx, "doc": d.doc,
                              "score": d.score,
                              "sort": list(d.sort_values)}
                             for d in docs],
                    "terminated": False,
                    "aggs_partial": None,
                    "suggest_partial": None,
                    "profile": None,
                }
                # request-cache fill, once per unique plan: stamped with
                # the DRAIN reader's generation, so a duplicate arriving
                # after this drain hits at intake (the shapes the topk
                # gate / per-request opt-in covers)
                try:
                    self.sts.request_cache_fill(m.req, row, reader)
                except Exception:  # noqa: BLE001 — the fill must never
                    pass           # fail a served response
            prune = row["prune"]
            stats = shard.search_stats
            stats["query_total"] += 1
            if collector == "wand_topk" and prune:
                stats["wand_queries"] += 1
                stats["wand_blocks_total"] += prune[0]
                stats["wand_blocks_scored"] += prune[1]
            context_id = uuid_mod.uuid4().hex
            self.sts._contexts[context_id] = (
                reader, self.sts._now() + CONTEXT_KEEP_ALIVE)
            m.result = {**row, "context_id": context_id}
            self.sts._slow_log(m.req,
                               time.monotonic() - m.enqueued_wall,
                               trace=m.trace)

    def _execute_dense(self, shard, reader, members: List[_Member],
                       uniques: List[_Member], assign: List[int]) -> None:
        """The per-member kind: each unique plan runs ``query_shard``
        over the DRAIN's shared reader snapshot (one acquisition per
        drain, not per query) through the full response pipeline
        (aggregations, suggest, rescore, collapse, profile, request
        cache, slow log); duplicates fan out copy-on-write with their
        own pinned contexts. Deadline/cancellation bind per member: a
        unique executes under its OWN checks, and its own failure never
        touches drain-mates."""
        from elasticsearch_tpu_torch.action.search_action import (
            CONTEXT_KEEP_ALIVE,
        )
        exec_ns: Dict[int, int] = {}
        cache_hit: Dict[int, bool] = {}
        # drain-wide agg planning (search/plane_aggs.py): the drain's
        # agg-bearing members are planned together — one columns-plane
        # dispatch per (shard, agg family) serves every eligible spec of
        # every distinct plan, and each member's ShardAggregator consumes
        # the whole-shard partial as a preset. plan_drain_aggs never
        # raises; {} keeps the pure host path.
        preset_by_ui: Dict[int, Dict[str, Any]] = {}
        if any(u.error is None and (
                (u.req.get("body") or {}).get("aggs") or
                (u.req.get("body") or {}).get("aggregations"))
               for u in uniques):
            from elasticsearch_tpu_torch.search.plane_aggs import plan_drain_aggs
            preset_by_ui = plan_drain_aggs(shard, reader, uniques,
                                           batch_stats=self.stats,
                                           device=shard.search.device)
        for ui, u in enumerate(uniques):
            if u.error is not None:
                continue
            self._set_phase([u], "dispatch",
                            data_plane="dense_device"
                            if ui in preset_by_ui else "batch")
            t0 = time.monotonic_ns()
            meta: Dict[str, Any] = {}
            try:
                u.result = self.sts.execute_query_member(
                    u.req, reader,
                    cancel_check=self._member_cancel_check(u),
                    trace=u.trace, started_wall=u.enqueued_wall,
                    meta_out=meta,
                    preset_aggs=preset_by_ui.get(ui))
            except (TaskCancelledError, SearchBudgetExceededError) as e:
                if isinstance(e, TaskCancelledError):
                    self.stats["queries_cancelled"] += 1
                else:
                    self.stats["queries_expired"] += 1
                u.error = e
            except Exception as e:  # noqa: BLE001 — the member's own
                u.error = e         # error (parse, breaker, ...)
            exec_ns[ui] = time.monotonic_ns() - t0
            cache_hit[ui] = bool(meta.get("cache_hit"))
        self._set_phase(members, "demux")
        for m, ui in zip(members, assign):
            if m is uniques[ui] or m.error is not None:
                continue
            # the duplicate's own death binds here (the shared kinds
            # observe it via check_members between dispatches): a
            # cancelled or budget-expired duplicate rejects instead of
            # resolving with a result its caller already abandoned
            m.error = self._member_error(m)
            if m.error is not None:
                continue
            u = uniques[ui]
            if u.error is not None:
                if isinstance(u.error, (TaskCancelledError,
                                        SearchBudgetExceededError)):
                    # the unique's cancellation/budget is its OWN, not
                    # the plan's: re-execute this duplicate under its
                    # own checks and promote it as the memo source for
                    # the remaining duplicates
                    self._set_phase([m], "dispatch")
                    t0 = time.monotonic_ns()
                    meta = {}
                    try:
                        m.result = self.sts.execute_query_member(
                            m.req, reader,
                            cancel_check=self._member_cancel_check(m),
                            trace=m.trace, started_wall=m.enqueued_wall,
                            meta_out=meta,
                            preset_aggs=preset_by_ui.get(ui))
                    except (TaskCancelledError,
                            SearchBudgetExceededError) as e:
                        if isinstance(e, TaskCancelledError):
                            self.stats["queries_cancelled"] += 1
                        else:
                            self.stats["queries_expired"] += 1
                        m.error = e
                        continue
                    except Exception as e:  # noqa: BLE001
                        m.error = e
                        continue
                    exec_ns[ui] = time.monotonic_ns() - t0
                    cache_hit[ui] = bool(meta.get("cache_hit"))
                    uniques[ui] = m
                    self._set_phase([m], "demux")
                    continue
                # an identical plan fails identically; sharing the
                # error object is safe (raised to distinct deferreds)
                m.error = u.error
                continue
            row = u.result
            context_id = None
            if row.get("context_id") is not None:
                # the duplicate pins its OWN context over the same
                # drain reader (fetch pops contexts individually)
                context_id = uuid_mod.uuid4().hex
                self.sts._contexts[context_id] = (
                    reader, self.sts._now() + CONTEXT_KEEP_ALIVE)
            # duplicates are served traffic: they count in the shard
            # search stats exactly as independent executions would,
            # mirroring the branch the unique took inside
            # execute_query_member (cache hit vs executed query)
            stats = shard.search_stats
            if cache_hit.get(ui):
                stats["request_cache_hits"] += 1
            else:
                stats["query_total"] += 1
                if row.get("collector") == "wand_topk" \
                        and row.get("prune"):
                    stats["wand_queries"] += 1
                    stats["wand_blocks_total"] += row["prune"][0]
                    stats["wand_blocks_scored"] += row["prune"][1]
            m.result = {**row, "context_id": context_id}
            # the duplicate's honest attribution is the unique's
            # execution it shared (the drain-span discipline) — the
            # dense_device label included: the row it serves WAS
            # collected on the columns plane
            if u.trace is not None and m.trace is not None and \
                    u.trace.data_plane == "dense_device":
                m.trace.data_plane = "dense_device"
            m.trace.add_span("device_dispatch", exec_ns.get(ui, 1),
                             {"memo": 1})
            m.trace.finish()
            TELEMETRY.observe(m.trace)
            self.sts._slow_log(m.req,
                               time.monotonic() - m.enqueued_wall,
                               trace=m.trace)

    def _member_cancel_check(self, m: _Member):
        """The member's own between-segments check (the old solo path's
        cancel_check): raises the member's typed error without touching
        drain-mates or double-counting stats."""
        checks = []
        if m.task is not None:
            checks.append(m.task.ensure_not_cancelled)
        if m.deadline is not None:
            scheduler = self._scheduler()

            def ensure_budget(deadline=m.deadline, scheduler=scheduler,
                              req=m.req):
                if scheduler.now() >= deadline:
                    raise SearchBudgetExceededError(
                        f"search budget expired while querying "
                        f"[{req['index']}][{req['shard']}]")
            checks.append(ensure_budget)
        if not checks:
            return None

        def cancel_check() -> None:
            for check in checks:
                check()
        return cancel_check
