"""One launch per phase for whole co-located fan-outs.

``TransportSearchAction`` fans an eligible query out to every target
shard over transport — one shard query per shard even when all the
shards live on this very node. This module collapses that fan-out: when
every target shard is local and the mesh-sharded plane
(ops/device_segment.py ``MESH_PLANES``) holds the query's (kind, field),
the WHOLE scatter-gather runs as ONE kernel launch per phase over the
shards' stacked planes (search/plane_exec.py ``mesh_wand_topk`` over
parallel/mesh.py's ``mesh_bm25_*`` kernels for the text kind,
``mesh_knn_winners`` over its ``mesh_knn_*`` kernels for the kNN kind,
``mesh_sparse_topk`` over its ``mesh_sparse_*`` kernels for the sparse
kind) and the results demux back
into ordinary per-shard query-phase responses — the coordinator merge,
fetch phase, and response shape stay the RPC fan-out's.

Batching: like the RRF fusion batcher, concurrent eligible searches
submitted in the same scheduler tick coalesce — their queries ride the
kernels' query dimension, so a wave of searches pays one launch per
phase, not one per search per shard.

Degradation: ANY miss (mesh disabled, plane refused by the device
budget, classification edge) hands the member back to the unchanged
per-shard fan-out — the mesh is an optimization, never a correctness
gate. A kNN fan-out over an IVF-mapped field or an ANN-sized shard, or
one whose shards would pick different tiers, is such a miss (typed
``mesh_ivf_routed`` / ``mesh_quantized_fallback``). A drain whose kernel
fails to build or launch hands its members back too (typed
``mesh_drain_error``) and logs the ``KernelError`` at error level.
"""

from __future__ import annotations

import json
import logging
import time
import uuid as uuid_mod
from dataclasses import dataclass, field as dc_field
from typing import Any, Callable, Dict, List, Optional, Tuple

from elasticsearch_tpu_torch.search import telemetry
from elasticsearch_tpu_torch.search.batch_executor import (
    BatchSpec, _CLASS_OF_KIND, _build_ctxs, _copy_compiles, _knn_demux,
    classify_request,
)
from elasticsearch_tpu_torch.search.telemetry import TELEMETRY, SearchTrace
from elasticsearch_tpu_torch.utils.settings import SEARCH_MESH_ENABLED

logger = logging.getLogger(__name__)


class _MeshMiss(Exception):
    """Internal: this drain cannot serve from the mesh; members return
    to the per-shard RPC fan-out. ``reason`` is a telemetry taxonomy
    constant — every miss is typed, never a bare count."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


@dataclass
class _Member:
    spec: BatchSpec
    body: Dict[str, Any]
    window: int
    shard_ids: List[int]
    task: Any
    on_results: Callable[[Optional[List[Dict[str, Any]]]], None]
    enqueued_wall: float = dc_field(default_factory=time.monotonic)
    # coordinator [timeout] deadline in scheduler time (the mesh is
    # local, so the absolute deadline crosses no process boundary)
    deadline: Optional[float] = None
    enqueued_ns: int = dc_field(default_factory=time.monotonic_ns)
    trace: Any = None
    # shard id -> node whose copy the mesh scores (multi-host meshes can
    # serve shards held by OTHER nodes on live mesh-member hosts)
    serving: Dict[int, str] = dc_field(default_factory=dict)
    # coordinator dfs_query_then_fetch stats (doc_count_override /
    # df_overrides / field_stats_overrides), applied to every shard ctx
    dfs: Optional[Dict[str, Any]] = None


class MeshSearchExecutor:
    """Per-node mesh fan-out executor; owned by SearchTransportService
    (which also owns the shard-level micro-batcher), driven on the
    scheduler's dispatch context like every other handler."""

    _KIND_OF = {"text": "postings", "knn": "vectors", "sparse": "features"}

    def __init__(self, sts):
        self.sts = sts
        self._queues: Dict[Tuple, List[_Member]] = {}
        self._scheduled: set = set()
        self.stats: Dict[str, float] = {
            "mesh_searches": 0,        # searches served from the mesh
            "mesh_batches": 0,         # mesh drains dispatched
            "mesh_fallbacks": 0,       # members handed back to the RPC path
            "mesh_shard_results": 0,   # per-shard responses synthesized
            "device_dispatches": 0,    # mesh kernels launched
            "max_occupancy": 0,
            # per-drain memo (the shard batcher's discipline): identical
            # same-tick members pay one term-stats pass and one
            # query-stack row, rows fanned out per duplicate
            "memo_hits": 0,
        }
        # per-HOST serving counters on multi-host meshes — host label ->
        # {"shard_results", "host_losses"}; monitor.mesh_plane_stats
        # surfaces them as "per_host" under _nodes/stats mesh_plane
        self.per_host_stats: Dict[str, Dict[str, int]] = {}

    # -- intake ---------------------------------------------------------

    def _scheduler(self):
        return self.sts.ts.transport.scheduler

    def _device(self):
        """The device this node's shards (and so its mesh) run on."""
        return self.sts.indices.device

    # -- multi-host topology --------------------------------------------

    def _host_backend(self):
        """The registered host backend, but only when a host topology is
        actually configured (search.mesh.hosts) — a single-host mesh
        never consults it, preserving the strict-local gate."""
        from elasticsearch_tpu_torch.ops.device_segment import MESH_PLANES
        if MESH_PLANES.hosts is None:
            return None
        from elasticsearch_tpu_torch.parallel.mesh import host_backend
        return host_backend()

    def _host_label(self, node_id: str) -> str:
        backend = self._host_backend()
        if backend is not None:
            host = backend.host_of_node(node_id)
            if host is not None:
                return "host_%d" % host
        return "host_0"

    def _host_count(self, label: str, counter: str) -> None:
        h = self.per_host_stats.setdefault(
            label, {"shard_results": 0, "host_losses": 0})
        h[counter] = h.get(counter, 0) + 1

    def _indices_of(self, node_id: str):
        """IndicesService holding ``node_id``'s shards, or None when the
        node's host is gone. The virtual host backend reaches every
        member host in-process — the stand-in for one multi-host SPMD
        program whose every participant addresses its own shards."""
        if node_id == self.sts.node_id:
            return self.sts.indices
        backend = self._host_backend()
        return backend.indices_of(node_id) if backend is not None else None

    def _serving_for(self, index: str, targets
                     ) -> Optional[Dict[int, str]]:
        """Map each target shard to the node whose copy the mesh will
        score: the local ACTIVE copy when present, else an ACTIVE copy on
        a live mesh-member host. None = some target has neither, the
        fan-out is not mesh-servable. Membership in t["copies"] (the
        routing table's active copies) is required either way — a
        locally registered shard instance alone may be an initializing
        replica mid peer-recovery, and scoring its half-copied engine
        would return silently incomplete hits."""
        serving: Dict[int, str] = {}
        backend = self._host_backend()
        for t in targets:
            if t["index"] != index:
                return None
            if self.sts.node_id in t.get("copies", ()) and \
                    self.sts.indices.has_shard(index, t["shard"]):
                serving[t["shard"]] = self.sts.node_id
                continue
            found = None
            if backend is not None:
                for node in t.get("copies", ()):
                    host = backend.host_of_node(node)
                    if host is None or not backend.host_alive(host):
                        continue
                    svc = backend.indices_of(node)
                    if svc is not None and \
                            svc.has_shard(index, t["shard"]):
                        found = node
                        break
            if found is None:
                return None
            serving[t["shard"]] = found
        return serving

    def try_submit(self, index: str, targets: List[Dict[str, Any]],
                   body: Dict[str, Any], window: int, task,
                   on_results: Callable[[Optional[List[Dict[str, Any]]]],
                                        None],
                   deadline: Optional[float] = None,
                   dfs_overrides: Optional[Dict[str, Any]] = None) -> bool:
        """True = queued for a mesh drain (``on_results`` fires with the
        per-shard query results in target order, or None = run the RPC
        fan-out). False = not mesh-eligible; caller proceeds normally.
        Never raises. Every False carries a typed routing-decision
        reason in the telemetry fallback taxonomy.

        ``deadline`` (scheduler time): the coordinator's [timeout]
        budget. The drain checks it at entry and between mesh dispatches
        (the shard-side between-segments discipline); an expired fan-out
        hands back to the RPC path, whose budget machinery produces the
        timed-out partial response.

        ``dfs_overrides``: coordinator dfs_query_then_fetch global term
        statistics; when present the drain skips local term-stats and
        builds every shard context from the overrides, so a DFS-normed
        fan-out costs the same 2-3 mesh dispatches as a plain one."""
        try:
            from elasticsearch_tpu_torch.ops.device_segment import (
                MESH_PLANES, PLANES,
            )
            from elasticsearch_tpu_torch.utils.settings import setting_from_state
            state = self.sts.state() if self.sts.state is not None else None
            if not setting_from_state(state, SEARCH_MESH_ENABLED):
                TELEMETRY.count_fallback(telemetry.MESH_DISABLED)
                return False
            # shard-side shed discipline covers the mesh path too: a
            # node over its member bound refuses the mesh fast path so
            # the RPC fan-out's enqueue shed + busy-failover machinery
            # governs — the bound cannot be dodged by being mesh-served
            if self.sts.batcher.at_member_bound():
                TELEMETRY.count_fallback(telemetry.MESH_NODE_BUSY)
                return False
            MESH_PLANES.configure_from_state(state)
            # the mesh's tier follows search.plane.* as the shard query
            # path's does (that path refreshes PLANES per shard request)
            PLANES.configure_from_state(state)
            if not MESH_PLANES.available(len(targets), self._device()):
                TELEMETRY.count_fallback(
                    telemetry.MESH_TOO_FEW_SHARDS
                    if len(targets) < max(1, MESH_PLANES.min_shards)
                    else telemetry.MESH_BACKEND_NOT_READY)
                return False
            if state is not None:
                from elasticsearch_tpu_torch.xpack.searchable_snapshots import (
                    is_frozen,
                )
                if is_frozen(state, index):
                    # per-search device residency: RPC path
                    TELEMETRY.count_fallback(telemetry.MESH_FROZEN_INDEX)
                    return False
            # co-location, fleet edition: every target shard must have
            # an ACTIVE copy on this node or on a live mesh-member host
            # (strictly local when no search.mesh.hosts topology is set)
            serving = self._serving_for(index, targets)
            if serving is None:
                TELEMETRY.count_fallback(telemetry.MESH_NOT_COLOCATED)
                return False
            svc0 = self._indices_of(serving[targets[0]["shard"]])
            shard0 = svc0.shard(index, targets[0]["shard"])
            spec = classify_request(
                {"index": index, "shard": targets[0]["shard"],
                 "body": body, "window": window},
                shard0.engine.mappers)
        except Exception:  # noqa: BLE001 — eligibility must never fail
            # a query; the RPC path reports real errors
            TELEMETRY.count_fallback(telemetry.MESH_ELIGIBILITY_ERROR)
            return False
        if spec is None or spec.kind == "dense":
            # per-member shapes (aggs, suggest, rescore, sorts, ...) ride
            # the shard batcher's dense kind through the RPC fan-out
            TELEMETRY.count_fallback(telemetry.MESH_INELIGIBLE_QUERY)
            return False
        if dfs_overrides is not None and spec.kind != "text":
            # coordinator df/avgdl normalization only shapes text
            # scoring; other kinds take the per-shard path unchanged
            TELEMETRY.count_fallback(telemetry.MESH_DFS_OVERRIDE)
            return False
        shard_ids = sorted(t["shard"] for t in targets)
        member = _Member(spec=spec, body=body, window=window,
                         shard_ids=shard_ids, task=task,
                         on_results=on_results, deadline=deadline,
                         serving=serving, dfs=dfs_overrides)
        member.trace = SearchTrace(
            _CLASS_OF_KIND.get(spec.kind, "other"), "mesh")
        member.trace.t0_ns = member.enqueued_ns
        dfs_token = None if dfs_overrides is None else \
            json.dumps(dfs_overrides, sort_keys=True, default=list)
        key = (index, tuple(shard_ids), dfs_token) + spec.key()
        self._queues.setdefault(key, []).append(member)
        if key not in self._scheduled:
            # same-tick coalescing (the RRF fusion batcher's discipline):
            # every member submitted in this dispatch round lands in one
            # mesh program; an isolated search pays one scheduler hop
            self._scheduled.add(key)
            self._scheduler().schedule(0.0, lambda: self._drain(key))
        return True

    # -- drain ----------------------------------------------------------

    def _drain(self, key: Tuple) -> None:
        self._scheduled.discard(key)
        members = self._queues.pop(key, [])
        if not members:
            return
        # deadline/cancellation binds per member at drain entry (the
        # shard batcher's discipline): an expired or cancelled member is
        # handed back to the RPC path individually — drain-mates still
        # score on the mesh
        now = self._scheduler().now()
        live: List[_Member] = []
        for m in members:
            if m.task is not None and getattr(m.task, "cancelled", False):
                TELEMETRY.count_fallback(telemetry.MESH_MEMBER_CANCELLED)
                self.stats["mesh_fallbacks"] += 1
                self._deliver(m, None)
            elif m.deadline is not None and now >= m.deadline:
                TELEMETRY.count_fallback(telemetry.MESH_DEADLINE_EXPIRED)
                self.stats["mesh_fallbacks"] += 1
                self._deliver(m, None)
            else:
                live.append(m)
        members = live
        if not members:
            return
        self.stats["mesh_batches"] += 1
        self.stats["max_occupancy"] = max(self.stats["max_occupancy"],
                                          len(members))
        t_exec = time.monotonic_ns()
        drain_trace = SearchTrace(
            _CLASS_OF_KIND.get(members[0].spec.kind, "other"), "mesh")
        # mesh drains count into the node's pressure tracker exactly
        # like batcher drains: in-flight while executing, an observed
        # (service, occupancy) sample after — so a mesh-serving node's
        # load is visible in its piggybacks, its shard-queue bound, and
        # the ARS observations the coordinator synthesizes per target
        pressure = self.sts.batcher.node_pressure
        pressure.in_flight += len(members)
        try:
            with telemetry.activate(drain_trace):
                results = self._execute(key, members)
        except _MeshMiss as miss:
            TELEMETRY.count_fallback(miss.reason, len(members))
            results = None
        except Exception as e:  # noqa: BLE001 — the mesh must never lose
            # a kernel that fails to build or launch is logged as an
            # error, never silently: the fan-out still answers per shard
            from elasticsearch_tpu_torch._build import KernelError
            if isinstance(e, KernelError):
                logger.exception("mesh kernel failed; falling back per "
                                 "shard")
            else:
                logger.debug("mesh drain failed; falling back per shard",
                             exc_info=True)
            TELEMETRY.count_fallback(telemetry.MESH_DRAIN_ERROR,
                                     len(members))
            results = None
        finally:
            pressure.observe((time.monotonic_ns() - t_exec) / 1e6,
                             members=len(members))
            pressure.in_flight = max(0,
                                     pressure.in_flight - len(members))
        if results is None:
            self.stats["mesh_fallbacks"] += len(members)
            for m in members:
                self._deliver(m, None)
            return
        self.stats["mesh_searches"] += len(members)
        exec_ns = time.monotonic_ns() - t_exec
        meta = {"occupancy": len(members)}
        if drain_trace.dispatches:
            meta["dispatches"] = drain_trace.dispatches
        for m, res in zip(members, results):
            t = m.trace
            t.add_span("queue_wait", t_exec - m.enqueued_ns)
            t.dispatches = drain_trace.dispatches
            _copy_compiles(drain_trace, t)
            t.add_span("device_dispatch", exec_ns, dict(meta))
            t.finish()
            TELEMETRY.observe(t)
            self._deliver(m, res)

    def _deliver(self, member: _Member, res) -> None:
        try:
            member.on_results(res)
        except Exception:  # noqa: BLE001 — one callback must not eat
            logger.exception("mesh result delivery failed")

    def _execute(self, key: Tuple, members: List[_Member]
                 ) -> Optional[List[List[Dict[str, Any]]]]:
        from elasticsearch_tpu_torch.action.search_action import (
            CONTEXT_KEEP_ALIVE,
        )
        from elasticsearch_tpu_torch.ops.device_segment import MESH_PLANES
        from elasticsearch_tpu_torch.search.phase import shard_term_stats
        index = key[0]
        shard_ids = list(key[1])
        spec0 = members[0].spec

        # [timeout] budgets are mesh-eligible: entry-expired (and
        # cancelled) members were peeled off individually in _drain; this
        # seam re-checks BETWEEN mesh dispatches — a deadline lapsing
        # during device execution abandons the mesh program and the whole
        # drain goes back to the RPC path, whose budget timer produces
        # the timed-out partial response
        scheduler = self._scheduler()
        serving = members[0].serving
        remote = sorted({n for n in serving.values()
                         if n != self.sts.node_id})
        backend = self._host_backend()

        def check_members() -> None:
            now = scheduler.now()
            for m in members:
                if m.task is not None and \
                        getattr(m.task, "cancelled", False):
                    raise _MeshMiss(telemetry.MESH_MEMBER_CANCELLED)
                if m.deadline is not None and now >= m.deadline:
                    raise _MeshMiss(telemetry.MESH_DEADLINE_EXPIRED)
            # a mesh-member host dropping mid-query abandons the mesh
            # program with a TYPED reason; the RPC fan-out's reroute
            # contract (any replica, automatic failover) then serves the
            # query off a surviving copy
            for node in remote:
                host = backend.host_of_node(node) \
                    if backend is not None else None
                if host is None or not backend.host_alive(host):
                    self._host_count(
                        "host_%d" % host if host is not None
                        else "host_unmapped", "host_losses")
                    raise _MeshMiss(telemetry.MESH_HOST_LOST)

        shards, readers = [], []
        for sid in shard_ids:
            node = serving.get(sid, self.sts.node_id)
            try:
                svc = self._indices_of(node)
                sh = svc.shard(index, sid)
                readers.append(sh.engine.acquire_reader())
                shards.append(sh)
            except Exception:
                if node != self.sts.node_id:
                    # serving host vanished between submit and drain
                    self._host_count(self._host_label(node),
                                     "host_losses")
                    raise _MeshMiss(telemetry.MESH_HOST_LOST)
                raise
        shard_segments = [((index, sid), list(r.segments))
                          for sid, r in zip(shard_ids, readers)]
        mpart = MESH_PLANES.get(shard_segments,
                                self._KIND_OF[spec0.kind], spec0.field,
                                shards[0].search.device)
        if mpart is None:
            raise _MeshMiss(telemetry.MESH_PLANE_MISSING)
        mappers = shards[0].engine.mappers

        # per-drain memo (the shard batcher's discipline): identical
        # same-tick members pay ONE term-stats pass and ONE query-stack
        # row; their per-shard response rows fan out below with their
        # own pinned contexts. The drain holds one reader snapshot per
        # shard, so a memo hit can never cross a refresh.
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

        # per-shard contexts + (text) term stats, exactly as query_shard
        # / the shard batcher build them — one reader snapshot per shard
        # per drain, so results cannot cross a refresh. DFS-normed
        # drains skip local term stats entirely: every shard context
        # carries the coordinator's global doc_count/df/avgdl, the same
        # overrides the per-shard RPC query phase would apply.
        dfs_over = members[0].dfs
        shard_ctxs = []
        for r in readers:
            if dfs_over is not None:
                shard_ctxs.append(_build_ctxs(
                    r, mappers, dfs_over.get("doc_count_override"),
                    dfs_over.get("df_overrides"),
                    field_stats=dfs_over.get("field_stats_overrides"),
                    device=mpart.device))
                continue
            doc_count = sum(seg.n_docs for seg in r.segments)
            dfs: Dict[str, Dict[str, int]] = {}
            if spec0.kind == "text":
                for m in uniques:
                    _dc, m_dfs = shard_term_stats(r, mappers,
                                                  m.spec.query)
                    for fname, termmap in m_dfs.items():
                        dfs.setdefault(fname, {}).update(termmap)
            shard_ctxs.append(_build_ctxs(
                r, mappers, doc_count,
                dfs if spec0.kind == "text" else None,
                device=mpart.device))

        counter: list = []
        want = spec0.window
        from elasticsearch_tpu_torch.search.plane_exec import (
            MeshFallback, mesh_knn_winners, mesh_sparse_topk,
            mesh_wand_topk,
        )
        try:
            if spec0.kind == "text":
                got = mesh_wand_topk(
                    shard_ctxs, mpart, spec0.field,
                    [m.spec.clauses for m in uniques], want,
                    spec0.track_limit, check_members=check_members,
                    counter=counter)
                if got is None:
                    raise _MeshMiss(telemetry.MESH_DFS_OVERRIDE)
                collector = "wand_topk"
                per_shard_member = got
            elif spec0.kind == "knn":
                raw = mesh_knn_winners(
                    shard_ctxs, mpart, spec0.field,
                    [m.spec for m in uniques], spec0.k,
                    check_members=check_members, counter=counter)
                collector = "dense"
                per_shard_member = [
                    _knn_demux([m.spec for m in uniques], row, spec0.k)
                    for row in raw]
            else:
                expansions = [[(t, w * m.spec.boost)
                               for t, w in m.spec.tokens.items()]
                              for m in uniques]
                raw = mesh_sparse_topk(shard_ctxs, mpart, spec0.field,
                                       expansions, want,
                                       check_members=check_members,
                                       counter=counter)
                collector = "dense"
                per_shard_member = []
                for row in raw:
                    member_rows = []
                    for (cands, total, max_score), m in zip(row, uniques):
                        relation = "eq"
                        clip = m.spec.clip_limit
                        if clip is not None and total > clip:
                            total, relation = clip, "gte"
                        member_rows.append((cands, total, relation,
                                            max_score, None))
                    per_shard_member.append(member_rows)
        except MeshFallback as mf:
            raise _MeshMiss(getattr(mf, "reason",
                                    telemetry.MESH_IVF_ROUTED))
        self.stats["device_dispatches"] += len(counter)

        # synthesize per-member, per-shard query-phase responses — the
        # exact dicts the shard batcher's drains produce,
        # with a pinned reader context per (member, shard) so the fetch
        # phase reads the same point-in-time snapshot
        now = self.sts._now()
        out: List[List[Dict[str, Any]]] = []
        for mi, m in enumerate(members):
            member_results: List[Dict[str, Any]] = []
            for pos, sid in enumerate(shard_ids):
                candidates, total, relation, max_score, prune = \
                    per_shard_member[pos][assign[mi]]
                docs = candidates[: want]
                shard = shards[pos]
                stats = shard.search_stats
                stats["query_total"] += 1
                if collector == "wand_topk" and prune:
                    stats["wand_queries"] += 1
                    stats["wand_blocks_total"] += prune[0]
                    stats["wand_blocks_scored"] += prune[1]
                served_by = serving.get(sid, self.sts.node_id)
                context_id = uuid_mod.uuid4().hex
                self.sts._contexts[context_id] = (
                    readers[pos], now + CONTEXT_KEEP_ALIVE)
                member_results.append({
                    "context_id": context_id,
                    # node whose copy the mesh scored — the coordinator
                    # attributes its ARS observation per serving HOST
                    "served_by": served_by,
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
                })
                self.sts._slow_log(
                    {"index": index, "shard": sid, "body": m.body},
                    time.monotonic() - m.enqueued_wall)
                self.stats["mesh_shard_results"] += 1
                self._host_count(self._host_label(served_by),
                                 "shard_results")
            out.append(member_results)
        return out
