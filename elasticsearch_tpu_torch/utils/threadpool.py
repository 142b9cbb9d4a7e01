"""Named execution pools with bounded admission — the backpressure layer.

The reference sizes real thread pools per workload (threadpool/
ThreadPool.java:69-130: search, write, get, management, ... each with a
queue bound) and rejects work beyond the queue with
EsRejectedExecutionException → HTTP 429. This build's node is an
event-loop, so the analog is ADMISSION control across async boundaries:
a pool grants in-flight slots (acquire at request entry, release at
completion), queues a bounded overflow, and rejects the rest. The write
pool additionally accounts in-flight request BYTES — the reference's
indexing-pressure limit (IndexingPressure.java) that stops a node from
buffering unbounded bulk payloads.

The overload control plane adds three behaviors on top of the static
bounds:

- **Little's-law queue resizing** (QueueResizingEsThreadPoolExecutor
  analog): the pool measures its completion rate over frames of
  ``frame_size`` tasks and moves ``queue_size`` toward
  ``rate * target_latency`` (bounded by [min_queue, max_queue], at most
  QUEUE_ADJUSTMENT per frame) — so past saturation the queue bounds the
  LATENCY of admitted work, not an arbitrary count. Resizing engages
  only when min_queue != max_queue (the reference's gate).
- **Per-tenant weighted-fair admission**: queued work is segregated per
  tenant key (the search path passes the index expression) and drained
  round-robin. When the queue is full, an arriving tenant whose backlog
  is under its fair share displaces the NEWEST queued entry of the
  fattest tenant instead of being rejected — one hot index can saturate
  its own share of the queue but cannot starve the rest of the fleet.
- **Computed Retry-After**: every rejection carries the seconds until a
  queue slot is expected to free (queue depth over the measured
  completion rate), surfaced as the HTTP ``Retry-After`` header so
  clients back off for a meaningful duration instead of a guess.
"""

from __future__ import annotations

import math
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Deque, Dict, Optional, Tuple

from elasticsearch_tpu_torch.utils.errors import RejectedExecutionError

# the default tenant for callers that don't segregate admission
DEFAULT_TENANT = "_default"


class Pool:
    """One named admission pool: in-flight slots + a bounded, per-tenant
    fair queue + frame-based completion-rate measurement."""

    # largest queue_size move per measurement frame (the reference's
    # QueueResizingEsThreadPoolExecutor tweak bound)
    QUEUE_ADJUSTMENT = 50
    RETRY_AFTER_MAX_S = 60
    # tenant keys come from client-supplied index expressions: bound the
    # rejection map (overflow pools into "_other") so hostile expression
    # churn can't grow node memory or the stats payload forever
    TENANT_CAP = 128

    def __init__(self, name: str, size: int, queue_size: int,
                 now_fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.size = size
        self.queue_size = queue_size
        self.active = 0
        self._now = now_fn or time.monotonic
        # tenant -> deque[(task, on_reject)], drained round-robin so no
        # tenant's backlog can monopolize the freed slots
        self.queues: "OrderedDict[str, Deque[Tuple]]" = OrderedDict()
        self.queued_total = 0
        self.completed = 0
        self.rejected = 0
        self.rejected_by_tenant: Dict[str, int] = {}
        self.largest_queue = 0
        # Little's-law adaptive resizing: engaged when min != max
        self.target_latency_s: Optional[float] = None
        self.min_queue = queue_size
        self.max_queue = queue_size
        self.frame_size = 100
        self._frame_completed = 0
        # the rate is completions per BUSY second: _busy_anchor is set
        # when an idle pool receives work and advanced at each
        # completion, so idle time — before a frame OR in the middle of
        # one — never reads as a slow pool (a stale rate would tell
        # clients to back off 60s from a pool that drains in
        # milliseconds, and shrink a healthy queue)
        self._busy_anchor: Optional[float] = None
        self._frame_busy_s = 0.0
        self.task_rate = 0.0        # completions/busy-second, last frame
        self.resizes = 0
        self._draining = False
        self.retry_after_issued = 0
        self.last_retry_after_s = 0

    # -- admission --------------------------------------------------------

    def submit(self, task: Callable[[], None],
               tenant: Optional[str] = None,
               on_reject: Optional[Callable[[Exception], None]] = None
               ) -> None:
        """Run task now if a slot is free, queue it within bounds (fairly
        across tenants), reject the overflow. A queued task may later be
        DISPLACED by a starved tenant — its ``on_reject`` is invoked with
        the rejection instead of the task ever running. The task MUST
        arrange for release() exactly once when its work (including async
        continuations) completes."""
        tenant = tenant or DEFAULT_TENANT
        if self.active == 0 and self.queued_total == 0:
            self._busy_anchor = self._now()    # idle -> busy transition
        if self.active < self.size:
            self.active += 1
            task()
            return
        if self.queued_total >= self.queue_size and \
                self._shed_for(tenant) is None:
            raise self._reject_error(tenant)
        self._enqueue(tenant, task, on_reject)

    def _enqueue(self, tenant, task, on_reject) -> None:
        queue = self.queues.get(tenant)
        if queue is None:
            queue = self.queues[tenant] = deque()
        queue.append((task, on_reject))
        self.queued_total += 1
        self.largest_queue = max(self.largest_queue, self.queued_total)

    def _shed_for(self, tenant: str):
        """Full queue: make room for ``tenant`` by shedding the newest
        entry of the fattest OTHER tenant — but only when the arriving
        tenant's backlog is strictly under that tenant's (it is below its
        fair share; shedding preserves total boundedness while restoring
        fairness). Returns None when the arrival itself must be rejected
        (it IS the fattest user of the queue)."""
        fat_tenant = None
        fat_len = -1
        for t, q in self.queues.items():
            if len(q) > fat_len:
                fat_tenant, fat_len = t, len(q)
        mine = len(self.queues.get(tenant, ()))
        if fat_tenant is None or fat_tenant == tenant or fat_len <= mine + 1:
            return None
        queue = self.queues[fat_tenant]
        if queue[-1][1] is None:
            # an entry submitted WITHOUT a rejection channel cannot be
            # displaced — shedding it would silently strand its caller;
            # the arrival takes the rejection instead
            return None
        _task, on_reject = queue.pop()
        self.queued_total -= 1
        if not queue:
            del self.queues[fat_tenant]
        err = self._reject_error(fat_tenant)
        try:
            on_reject(err)
        except Exception:  # noqa: BLE001 — a reject-callback failure
            pass           # must not strand the displacing arrival
        return (fat_tenant, err)

    def _reject_error(self, tenant: str) -> RejectedExecutionError:
        self.rejected += 1
        key = tenant if tenant in self.rejected_by_tenant or \
            len(self.rejected_by_tenant) < self.TENANT_CAP else "_other"
        self.rejected_by_tenant[key] = \
            self.rejected_by_tenant.get(key, 0) + 1
        retry_after = self.retry_after_s(tenant)
        self.retry_after_issued += 1
        self.last_retry_after_s = retry_after
        # ONE carrier for the computed backoff: the error metadata (it
        # rides to_json across transport; the REST layer reads it into
        # the body field and the Retry-After header)
        return RejectedExecutionError(
            f"rejected execution on [{self.name}]: queue capacity "
            f"[{self.queue_size}] reached", retry_after=retry_after,
            tenant=tenant)

    def retry_after_s(self, tenant: Optional[str] = None) -> int:
        """Seconds until a new request is expected to be admitted: the
        backlog ahead of it drained at the measured completion rate.
        With no rate measured yet (cold pool), a 1s floor — honest
        enough for a client's first backoff.

        With multiple tenants queued, a rejected ``tenant``'s estimate
        uses its OWN backlog at its FAIR SHARE of the pool rate (the
        queues drain round-robin, so a displacement-shed hot tenant's
        backlog drains at rate/n_tenants — quoting the whole-pool rate
        told exactly the tenants being shed to come back soonest). With
        one (or no) tenant queued, the fair share IS the pool rate and
        the estimate reduces to the whole-queue drain time."""
        if self.task_rate <= 0.0:
            est = 1.0
        else:
            n_tenants = len(self.queues)
            if tenant is not None and n_tenants > 1:
                depth = len(self.queues.get(tenant, ())) + 1
                est = depth * n_tenants / self.task_rate
            else:
                est = (self.queued_total + 1) / self.task_rate
        return max(1, min(self.RETRY_AFTER_MAX_S, int(math.ceil(est))))

    # -- completion + Little's-law resizing -------------------------------

    def release(self) -> None:
        self.active -= 1
        self.completed += 1
        now = self._now()
        if self._busy_anchor is not None:
            self._frame_busy_s += max(now - self._busy_anchor, 0.0)
        # still busy? keep accumulating from here; else stop the clock
        # until the next submit restarts it
        self._busy_anchor = now \
            if (self.active > 0 or self.queued_total) else None
        self._frame_completed += 1
        if self._frame_completed >= self.frame_size:
            self.task_rate = \
                self._frame_completed / max(self._frame_busy_s, 1e-9)
            self._frame_completed = 0
            self._frame_busy_s = 0.0
            self._resize_queue()
        # iterative drain with a reentrancy guard: a queued task that
        # completes (and releases) synchronously must not recurse one
        # frame per backlog entry — a 1000-deep queue of fast-failing
        # tasks would blow the stack mid-drain otherwise
        if self._draining:
            return
        self._draining = True
        try:
            while self.queued_total and self.active < self.size:
                task = self._pop_next()
                if task is None:
                    break
                self.active += 1
                task()
        finally:
            self._draining = False

    def _resize_queue(self) -> None:
        """Little's law (L = λ·W): the queue that holds admitted work to
        the target latency is rate * target. Move toward it by at most
        QUEUE_ADJUSTMENT per frame, inside [min_queue, max_queue]."""
        if not self.target_latency_s or self.min_queue == self.max_queue:
            return
        ideal = self.task_rate * self.target_latency_s
        step = int(round(ideal - self.queue_size))
        step = max(-self.QUEUE_ADJUSTMENT,
                   min(self.QUEUE_ADJUSTMENT, step))
        new = min(self.max_queue, max(self.min_queue,
                                      self.queue_size + step))
        if new != self.queue_size:
            self.queue_size = new
            self.resizes += 1

    def _pop_next(self) -> Optional[Callable[[], None]]:
        """Round-robin across tenant queues: pop the head of the first
        tenant, then rotate it behind the others."""
        for tenant in list(self.queues):
            queue = self.queues[tenant]
            if not queue:
                del self.queues[tenant]
                continue
            task, _on_reject = queue.popleft()
            self.queued_total -= 1
            if queue:
                self.queues.move_to_end(tenant)
            else:
                del self.queues[tenant]
            return task
        return None

    # -- surfaces ---------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        return {"threads": self.size, "active": self.active,
                "queue": self.queued_total, "queue_size": self.queue_size,
                "completed": self.completed, "rejected": self.rejected,
                "largest": self.largest_queue}

    def admission_stats(self) -> Dict[str, Any]:
        """The ``_nodes/stats`` ``search_admission`` queue block: live
        bounds, the adaptive controller's state, per-tenant rejections
        and the Retry-After values issued."""
        return {
            "queue": {
                "current": self.queued_total,
                "limit": self.queue_size,
                "min": self.min_queue,
                "max": self.max_queue,
                "resizes": self.resizes,
                "target_latency_ms": (
                    round(self.target_latency_s * 1000.0, 1)
                    if self.target_latency_s else None),
                "task_rate_per_s": round(self.task_rate, 3),
            },
            "active": self.active,
            "slots": self.size,
            "rejected_total": self.rejected,
            "rejections_by_tenant": dict(self.rejected_by_tenant),
            "retry_after": {"issued": self.retry_after_issued,
                            "last_s": self.last_retry_after_s},
        }


# reference pool sizing shape (ThreadPool.java:166-177), scaled to the
# event-loop model: "size" = concurrent in-flight operations
DEFAULT_POOLS = {
    "search": (16, 1000),
    "write": (8, 200),
    "get": (16, 1000),
    "management": (4, 100),
    "generic": (32, 500),
}

# indexing-pressure byte limit for in-flight write payloads — the
# documented default the ``indexing_pressure.memory.limit`` dynamic
# cluster setting overrides (IndexingPressure MAX_INDEXING_BYTES analog:
# 10% of heap there; a fixed 64mb default here)
WRITE_BYTES_LIMIT = 64 * 1024 * 1024


class IndexingPressure:
    """Three-stage in-flight write-byte accounting (IndexingPressure.java
    analog): every write payload is charged at the stage it occupies —
    **coordinating** (the node that parsed the bulk request),
    **primary** (the node executing the shard-level operations), and
    **replica** (a node applying replicated ops) — and released when
    that stage's work completes.

    Coordinating and primary admission share ``limit``: together they
    bound what THIS node has accepted responsibility for. The replica
    stage is checked separately against ``limit * REPLICA_HEADROOM``
    (1.5x) — replica work is downstream of a DIFFERENT node's primary
    having already accepted the bytes, so rejecting it at the shared
    limit would let a node's own coordinating admission starve the
    replication fan-out landing on it (the cross-node deadlock the
    reference's headroom rule exists to break).

    Rejections are typed ``es_rejected_execution_exception`` 429s
    carrying a computed Retry-After: released bytes are frame-measured
    into a drain rate (the Pool completion-rate pattern, on bytes), and
    the rejection's backoff is the time the current in-flight backlog
    needs to drain at that rate (1s floor, 60s cap — the coordinator
    pool's clamp). Rejection counts are per stage; the ``unknown``
    bucket exists so its pinned-at-zero value PROVES every rejection
    was stage-typed."""

    STAGES = ("coordinating", "primary", "replica")
    REPLICA_HEADROOM = 1.5
    # releases per drain-rate measurement frame (Pool.frame_size analog)
    FRAME_RELEASES = 16
    RETRY_AFTER_MAX_S = 60
    ALPHA = 0.3

    def __init__(self, limit: int = WRITE_BYTES_LIMIT,
                 now_fn: Optional[Callable[[], float]] = None):
        self.now = now_fn or time.monotonic
        self.limit = int(limit)
        self.current: Dict[str, int] = {s: 0 for s in self.STAGES}
        self.total: Dict[str, int] = {s: 0 for s in self.STAGES}
        self.rejections: Dict[str, int] = {s: 0 for s in self.STAGES}
        self.rejections["unknown"] = 0
        # byte drain-rate measurement (released bytes per second, EWMA
        # over frames of FRAME_RELEASES releases)
        self._frame_bytes = 0
        self._frame_releases = 0
        self._frame_t0: Optional[float] = None
        self.release_rate_bps = 0.0
        self.retry_after_issued = 0
        self.last_retry_after_s = 0
        # version-memoized dynamic-settings apply (the search.plane.*
        # configure_from_state pattern); _settings_applied tracks whether
        # the CURRENT limit came from cluster settings, so removal
        # restores the default exactly once without clobbering a limit
        # set directly (tests/operators poke write_bytes_limit)
        self._settings_version: Optional[int] = None
        self._settings_applied = False

    # -- admission --------------------------------------------------------

    def stage_limit(self, stage: str) -> int:
        if stage == "replica":
            return int(self.limit * self.REPLICA_HEADROOM)
        return self.limit

    def _stage_occupancy(self, stage: str) -> int:
        """The byte total ``stage`` admission is judged against:
        coordinating+primary share the limit; replica stands alone
        under its headroom."""
        if stage == "replica":
            return self.current["replica"]
        return self.current["coordinating"] + self.current["primary"]

    def acquire(self, stage: str, n: int) -> None:
        if stage not in self.STAGES:
            raise ValueError(f"unknown indexing-pressure stage [{stage}]")
        n = max(int(n), 0)
        would = self._stage_occupancy(stage) + n
        cap = self.stage_limit(stage)
        if would > cap:
            self.rejections[stage] += 1
            retry_after = self.retry_after_s()
            self.retry_after_issued += 1
            self.last_retry_after_s = retry_after
            from elasticsearch_tpu_torch.utils.errors import (
                EsRejectedExecutionError,
            )
            # stage= and retry_after= ride IN the message: replica
            # rejections cross the wire stringified (PR 9 invariant)
            # and the primary re-parses them with write_pressure_info
            raise EsRejectedExecutionError(
                f"rejected execution of {stage} operation: in-flight "
                f"indexing bytes [{would}] would exceed [{cap}] "
                f"stage={stage} retry_after={retry_after}s",
                retry_after=retry_after, stage=stage)
        self.current[stage] += n
        self.total[stage] += n

    def release(self, stage: str, n: int) -> None:
        n = max(int(n), 0)
        self.current[stage] = max(0, self.current[stage] - n)
        now = self.now()
        if self._frame_t0 is None:
            self._frame_t0 = now
        self._frame_bytes += n
        self._frame_releases += 1
        if self._frame_releases >= self.FRAME_RELEASES:
            elapsed = max(now - self._frame_t0, 1e-3)
            rate = self._frame_bytes / elapsed
            self.release_rate_bps = rate if self.release_rate_bps == 0.0 \
                else self.ALPHA * rate + \
                (1 - self.ALPHA) * self.release_rate_bps
            self._frame_bytes = 0
            self._frame_releases = 0
            self._frame_t0 = now

    def retry_after_s(self) -> int:
        """Honest write backoff: seconds until the CURRENT in-flight
        backlog drains at the measured release rate (1s floor, 60s
        cap). Cold node (no frame yet): 1s."""
        backlog = sum(self.current.values())
        rate = self.release_rate_bps
        if rate <= 0.0:
            return 1
        return max(1, min(self.RETRY_AFTER_MAX_S,
                          int(math.ceil((backlog + 1) / rate))))

    # -- dynamic settings -------------------------------------------------

    def configure_from_state(self, state) -> None:
        """Apply ``indexing_pressure.memory.limit`` from committed
        cluster state — version-memoized, so per-request refresh costs
        one integer compare; settings-removal falls back to the
        documented WRITE_BYTES_LIMIT default through the setting's own
        default machinery."""
        version = getattr(state, "version", None)
        if version is None or version == self._settings_version:
            return
        self._settings_version = version
        from elasticsearch_tpu_torch.utils.settings import (
            INDEXING_PRESSURE_MEMORY_LIMIT, setting_from_state,
        )
        raw = state.metadata.persistent_settings.get(
            INDEXING_PRESSURE_MEMORY_LIMIT.key)
        if raw is None:
            if self._settings_applied:
                # setting removed: restore the documented default
                self.limit = int(
                    INDEXING_PRESSURE_MEMORY_LIMIT.default(None))
                self._settings_applied = False
            return
        self.limit = int(setting_from_state(
            state, INDEXING_PRESSURE_MEMORY_LIMIT))
        self._settings_applied = True

    # -- observability ----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """The first-class ``_nodes/stats`` indexing_pressure section:
        per-stage current/total/limit/rejections plus the Retry-After
        drain-rate machinery's live values."""
        return {
            "limit_bytes": self.limit,
            "current_bytes": sum(self.current.values()),
            "stages": {
                s: {"current_bytes": self.current[s],
                    "total_bytes": self.total[s],
                    "limit_bytes": self.stage_limit(s),
                    "rejections": self.rejections[s]}
                for s in self.STAGES},
            "rejections": dict(self.rejections),
            "rejections_total": sum(
                self.rejections[s] for s in self.STAGES),
            "retry_after": {
                "issued": self.retry_after_issued,
                "last_s": self.last_retry_after_s,
                "release_rate_bytes_per_s": round(
                    self.release_rate_bps, 1)},
        }


def merge_indexing_pressure_sections(sections) -> Dict[str, Any]:
    """Fleet merge for ``_cluster/stats``: counters and byte gauges
    summed across nodes, per-stage rejection buckets summed per bucket,
    the last Retry-After kept as a maximum (the most-loaded node's
    honest backoff). Tolerates missing/empty sections from nodes that
    failed the fan-out."""
    out: Dict[str, Any] = {
        "limit_bytes": 0, "current_bytes": 0,
        "stages": {s: {"current_bytes": 0, "total_bytes": 0,
                       "rejections": 0}
                   for s in IndexingPressure.STAGES},
        "rejections": {s: 0 for s in
                       (*IndexingPressure.STAGES, "unknown")},
        "rejections_total": 0,
        "retry_after": {"issued": 0, "max_last_s": 0},
    }
    for sec in sections:
        if not sec:
            continue
        out["limit_bytes"] += sec.get("limit_bytes", 0)
        out["current_bytes"] += sec.get("current_bytes", 0)
        for s, stage in (sec.get("stages") or {}).items():
            agg = out["stages"].setdefault(
                s, {"current_bytes": 0, "total_bytes": 0,
                    "rejections": 0})
            for k in agg:
                agg[k] += stage.get(k, 0)
        for reason, n in (sec.get("rejections") or {}).items():
            out["rejections"][reason] = \
                out["rejections"].get(reason, 0) + n
        out["rejections_total"] += sec.get("rejections_total", 0)
        ra = sec.get("retry_after") or {}
        out["retry_after"]["issued"] += ra.get("issued", 0)
        out["retry_after"]["max_last_s"] = max(
            out["retry_after"]["max_last_s"], ra.get("last_s", 0))
    return out


class ThreadPoolService:
    """Per-node admission pools + three-stage write-bytes accounting."""

    def __init__(self, pools: Optional[Dict[str, tuple]] = None,
                 now_fn: Optional[Callable[[], float]] = None):
        self.pools: Dict[str, Pool] = {
            name: Pool(name, size, queue, now_fn=now_fn)
            for name, (size, queue) in (pools or DEFAULT_POOLS).items()}
        self.indexing_pressure = IndexingPressure(now_fn=now_fn)

    def pool(self, name: str) -> Pool:
        return self.pools[name]

    # -- slot admission ---------------------------------------------------

    def submit(self, name: str, task: Callable[[], None],
               tenant: Optional[str] = None,
               on_reject: Optional[Callable[[Exception], None]] = None
               ) -> None:
        """Run task now if a slot is free, queue it within bounds, reject
        beyond them. The task MUST arrange for release(name) exactly once
        when its work (including async continuations) completes.
        ``tenant`` segregates queued work for weighted-fair shedding;
        ``on_reject`` is how a QUEUED task learns it was displaced by a
        starved tenant (a synchronous rejection still raises)."""
        self.pools[name].submit(task, tenant=tenant, on_reject=on_reject)

    def release(self, name: str) -> None:
        self.pools[name].release()

    def configure_search_admission(
            self, target_latency_s: float, min_queue: int, max_queue: int,
            frame_size: int) -> None:
        """Apply the dynamic search.admission.* settings to the search
        pool (cheap assignments — callers refresh per request). The
        current queue_size is clamped into the new bounds so an operator
        narrowing the range takes effect immediately."""
        pool = self.pools.get("search")
        if pool is None:
            return
        if min_queue > max_queue:
            min_queue = max_queue
        pool.min_queue = min_queue
        pool.max_queue = max_queue
        pool.frame_size = max(1, int(frame_size))
        pool.target_latency_s = \
            float(target_latency_s) if min_queue != max_queue else None
        pool.queue_size = min(max_queue, max(min_queue, pool.queue_size))

    # -- write-bytes accounting (indexing pressure) -----------------------
    # legacy single-gate surface: delegates to the coordinating stage of
    # the three-stage IndexingPressure (autoscaling reads the aggregate
    # attributes; older tests drive acquire/release directly)

    @property
    def write_bytes_in_flight(self) -> int:
        return sum(self.indexing_pressure.current.values())

    @property
    def write_bytes_limit(self) -> int:
        return self.indexing_pressure.limit

    @write_bytes_limit.setter
    def write_bytes_limit(self, v: int) -> None:
        self.indexing_pressure.limit = int(v)

    @property
    def write_bytes_rejections(self) -> int:
        return sum(self.indexing_pressure.rejections[s]
                   for s in IndexingPressure.STAGES)

    def acquire_write_bytes(self, n: int) -> None:
        self.indexing_pressure.acquire("coordinating", n)

    def release_write_bytes(self, n: int) -> None:
        self.indexing_pressure.release("coordinating", n)

    def stats(self) -> Dict[str, Any]:
        out = {name: pool.stats() for name, pool in self.pools.items()}
        # back-compat blob inside thread_pool; the full per-stage view
        # is the first-class _nodes/stats "indexing_pressure" section
        out["indexing_pressure"] = {
            "current_bytes": self.write_bytes_in_flight,
            "limit_bytes": self.write_bytes_limit,
            "rejections": self.write_bytes_rejections,
        }
        return out
