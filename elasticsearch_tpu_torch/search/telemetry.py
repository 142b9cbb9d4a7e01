"""Search telemetry plane: per-request phase traces, data-plane decision
records, and latency histograms.

BENCH r05 showed four of five query classes far under the 5x-CPU target
with nothing in the system able to say WHERE a query's time goes across
the coordinator -> batcher / mesh / plane / solo routing maze. This
module is the reference blueprint's introspection triad (Lucene's
profile API, the task management API's live phase view, and the index
slow logs) rebuilt around this build's data planes:

- :class:`SearchTrace` — a per-request span record (queue wait, rewrite,
  device dispatch with dispatch count, demux, fetch, merge) populated by
  every serving path. Always-on-cheap by construction: spans are
  ``time.monotonic_ns()`` deltas plus counter increments — never a
  device sync, never an allocation beyond one small list per request.
  Full span detail is surfaced only under ``"profile": true`` and in
  slow-log lines past their thresholds.
- :class:`SearchTelemetry` (process-global ``TELEMETRY``, the PLANES /
  BREAKERS residency precedent) — ring-buffer latency histograms per
  (query class x data plane) with per-span breakdowns, served as the
  ``_nodes/stats`` ``"search_latency"`` section, plus the complete
  **fallback-reason taxonomy**: every data-plane routing decision and
  every fallback between planes (mesh -> RPC, plane -> per-segment,
  batch -> solo, IVF ``MeshFallback``, breaker refusals) counts under a
  typed reason constant below — no bare counts, no "unknown"s.
- the ``_current`` context — the active trace rides a contextvar so the
  ops-layer dispatch sites (``ops/bm25.py dispatch_flat``, the kNN /
  sparse kernels, the IVF probe) can attribute device programs to the
  request that launched them without threading a parameter through
  every executor signature.

Byte-invisibility contract: nothing in this module ever mutates a
response. Surfaces that DO show telemetry (profile blocks, slow logs,
``_tasks`` status, ``_nodes/stats``) are additive and gated; with
``profile`` off, responses on every path are byte-identical to a build
without telemetry.
"""

from __future__ import annotations

import contextvars
import math
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional


# ---------------------------------------------------------------------------
# fallback / routing-decision reason taxonomy
# ---------------------------------------------------------------------------
# Every counter increment names one of these constants. Adding a site
# means adding a constant here — count_fallback() maps anything else to
# UNKNOWN, and the telemetry test suite pins UNKNOWN at zero, so an
# untyped fallback fails CI instead of hiding in a bare count.

# mesh-sharded SPMD path: routing decisions (why a fan-out kept the RPC
# scatter-gather) and drain-time fallbacks (why a submitted fan-out was
# handed back)
MESH_DISABLED = "mesh_disabled"
MESH_BACKEND_NOT_READY = "mesh_backend_not_ready"
MESH_TOO_FEW_SHARDS = "mesh_too_few_shards"
MESH_FROZEN_INDEX = "mesh_frozen_index"
MESH_NOT_COLOCATED = "mesh_not_colocated"
MESH_HOST_LOST = "mesh_host_lost"
MESH_INELIGIBLE_QUERY = "mesh_ineligible_query"
MESH_ELIGIBILITY_ERROR = "mesh_eligibility_error"
MESH_PLANE_MISSING = "mesh_plane_missing"
MESH_PLANE_BUDGET_REFUSED = "mesh_plane_budget_refused"
MESH_IVF_ROUTED = "mesh_ivf_routed"
MESH_DFS_OVERRIDE = "mesh_dfs_override"
MESH_ALIAS_OR_MULTI_INDEX = "mesh_alias_or_multi_index"
MESH_MEMBER_CANCELLED = "mesh_member_cancelled"
MESH_DEADLINE_EXPIRED = "mesh_deadline_expired"
MESH_DRAIN_ERROR = "mesh_drain_error"
LEGACY_MESH_ERROR = "legacy_mesh_error"

# packed single-shard plane: why a shard served per-segment instead
PLANE_DISABLED = "plane_disabled"
PLANE_TOO_FEW_SEGMENTS = "plane_too_few_segments"
PLANE_BUDGET_REFUSED = "plane_budget_refused"
PLANE_FIELD_ABSENT = "plane_field_absent"
PLANE_IVF_NPROBE_DISAGREEMENT = "plane_ivf_nprobe_disagreement"
PLANE_IVF_BREAKER_REFUSED = "plane_ivf_breaker_refused"

# quantized coarse tier: why a coarse-eligible query served EXACT
# instead (mirror refused by the HBM budget, or the adaptive re-rank
# depth hit its bound without the margin proving top-k parity); results
# are identical either way — this is a perf-tier routing record
PLANE_QUANTIZED_FALLBACK = "plane_quantized_fallback"
MESH_QUANTIZED_FALLBACK = "mesh_quantized_fallback"
# measured-latency engage rule: the coarse tier measured SLOWER than
# exact for this query class (CPU-fallback boxes emulating bf16) and
# was disengaged by the observed-latency EWMA comparison
QUANTIZED_DISENGAGED_SLOW = "quantized_disengaged_slow"

# columns plane / drain-wide device aggregation (dense_device data
# plane): why an agg-bearing dense member's spec kept the host
# collector. Results are identical either way — a perf-tier routing
# record, like the quantized tier's
PLANE_AGGS_INELIGIBLE_SHAPE = "plane_aggs_ineligible_shape"
PLANE_AGGS_COLUMN_UNAVAILABLE = "plane_aggs_column_unavailable"
PLANE_AGGS_BREAKER_REFUSED = "plane_aggs_breaker_refused"
PLANE_AGGS_EXEC_ERROR = "plane_aggs_exec_error"

# shard micro-batcher: why a drained batch re-executed member-by-member
BATCH_IVF_NPROBE_DISAGREEMENT = "batch_ivf_nprobe_disagreement"
BATCH_BREAKER_REFUSED = "batch_breaker_refused"
BATCH_EXEC_ERROR = "batch_exec_error"

# shard-side shed point + coordinator busy-failover loop: a data node at
# its search.shard.max_queued_members bound sheds a query AT INTAKE
# (shard_busy, counted on the shedding node); the coordinator treats the
# typed rejection as a ROUTING signal and fails over to the next
# C3-ranked copy (shard_busy_failover, counted on the coordinator); a
# node over its member bound refuses the mesh fast path so the RPC
# fan-out's shed + failover machinery governs (mesh_node_busy)
SHARD_BUSY = "shard_busy"
SHARD_BUSY_FAILOVER = "shard_busy_failover"
MESH_NODE_BUSY = "mesh_node_busy"

UNKNOWN = "unknown"

KNOWN_REASONS = frozenset(
    v for k, v in list(globals().items())
    if k.isupper() and isinstance(v, str) and k != "UNKNOWN")


# ---------------------------------------------------------------------------
# the per-request trace
# ---------------------------------------------------------------------------

class SearchTrace:
    """One request's (or one shard request's) phase record.

    ``query_class``: bm25 | knn | sparse | hybrid | other.
    ``data_plane``: solo | plane | batch | mesh | coordinator-side labels
    ("fanout", "mesh_plane", ...). ``spans`` is a flat ordered list of
    (name, duration_ns, meta) — phases here are sequential per request,
    so a flat list IS the tree."""

    __slots__ = ("query_class", "data_plane", "spans", "dispatches",
                 "t0_ns", "total_ns", "plane_backed", "compiles")

    def __init__(self, query_class: str = "other",
                 data_plane: str = "solo"):
        self.query_class = query_class
        self.data_plane = data_plane
        self.spans: List[tuple] = []
        self.dispatches = 0
        self.t0_ns = time.monotonic_ns()
        self.total_ns = 0
        self.plane_backed = False
        # XLA compiles attributed to this request (the device observatory
        # records them through record_compile — a first-compile request
        # pays seconds of latency the phase spans alone can't explain)
        self.compiles = 0

    # -- span recording --------------------------------------------------

    def add_span(self, name: str, dur_ns: int,
                 meta: Optional[Dict[str, Any]] = None) -> None:
        # clamp at 1ns so a "did happen" phase can never read as absent
        self.spans.append((name, max(int(dur_ns), 1), meta))

    @contextmanager
    def span(self, name: str):
        """Time a phase; device programs launched inside (counted by
        record_dispatch through the active-trace contextvar) annotate
        the span with their dispatch count."""
        d0 = self.dispatches
        t0 = time.monotonic_ns()
        try:
            yield self
        finally:
            meta = None
            if self.dispatches > d0:
                meta = {"dispatches": self.dispatches - d0}
            self.add_span(name, time.monotonic_ns() - t0, meta)

    def mark_plane(self) -> None:
        """A plane executor served this request: a solo request's data
        plane upgrades to "plane"; batch/mesh keep their label (the
        plane backing is recorded on the flag either way)."""
        self.plane_backed = True
        if self.data_plane == "solo":
            self.data_plane = "plane"

    def finish(self) -> None:
        self.total_ns = max(time.monotonic_ns() - self.t0_ns, 1)

    # -- surfaces ---------------------------------------------------------

    def span_ns(self, name: str) -> int:
        return sum(d for n, d, _m in self.spans if n == name)

    def tree(self) -> Dict[str, Any]:
        """Profile-block shape: the span list plus the routing verdict —
        what ``"profile": true`` responses and slow-log lines show."""
        out: Dict[str, Any] = {
            "query_class": self.query_class,
            "data_plane": self.data_plane,
            "device_dispatches": self.dispatches,
            "time_in_nanos": self.total_ns or
            (time.monotonic_ns() - self.t0_ns),
            "phases": [
                {"name": n, "time_in_nanos": d, **(m or {})}
                for n, d, m in self.spans],
        }
        if self.plane_backed:
            out["plane_backed"] = True
        return out

    def summary(self) -> str:
        """One-line phase breakdown for slow-log lines. A request that
        paid XLA compiles is flagged — a first-compile p99 outlier then
        explains itself without a profile re-run."""
        parts = [f"{n}={d / 1e6:.2f}ms" for n, d, _m in self.spans]
        compiled = f"compiles[{self.compiles}], " if self.compiles else ""
        return (f"data_plane[{self.data_plane}], "
                f"dispatches[{self.dispatches}], "
                f"{compiled}phases[{' '.join(parts)}]")


# the active trace: set by the serving paths around execution so the
# ops-layer dispatch sites can attribute device programs to the request
_current: contextvars.ContextVar[Optional[SearchTrace]] = \
    contextvars.ContextVar("search_trace", default=None)


def current() -> Optional[SearchTrace]:
    return _current.get()


@contextmanager
def activate(trace: Optional[SearchTrace]):
    token = _current.set(trace)
    try:
        yield trace
    finally:
        _current.reset(token)


def record_dispatch(n: int = 1) -> None:
    """Called at every device-program launch site (ops/bm25.py
    dispatch_flat, the kNN/sparse kernels, the IVF probe, the mesh
    kernels). One contextvar read when no trace is active — cheap enough
    for the hot path, and never a device sync."""
    t = _current.get()
    if t is not None:
        t.dispatches += n


def record_compile(family: str, dur_ns: int) -> None:
    """Called by the device observatory (search/device_profile.py) when
    a profiled kernel call compiled: the active request's trace gains a
    ``compile`` span — ``profile: true`` responses show the compile_ms,
    slow logs flag the request — without the jitted function itself
    having to know about requests."""
    t = _current.get()
    if t is not None:
        t.compiles += 1
        t.add_span("compile", dur_ns,
                   {"family": family,
                    "compile_ms": round(dur_ns / 1e6, 3)})


def mark_plane_served() -> None:
    """Called by the plane executors: the active request was served off
    the packed plane (solo traces relabel to the "plane" data plane)."""
    t = _current.get()
    if t is not None:
        t.mark_plane()


def classify_query_class(query) -> str:
    """Histogram class of a parsed dsl query tree (duck-typed on the
    node class name so this module imports nothing from search.dsl):
    text scoring = bm25, dense vectors = knn, rank-features = sparse."""
    if query is None:
        return "other"
    name = type(query).__name__
    if name in ("Knn", "KnnBound"):
        return "knn"
    if name == "TextExpansion":
        return "sparse"
    return "bm25"


def classify_body(body: Optional[Dict[str, Any]]) -> str:
    """Coordinator-side class of a raw request body (pre-parse, so it
    must never raise): rank.rrf = hybrid, knn clause = knn,
    text_expansion = sparse, any other query = bm25."""
    body = body or {}
    try:
        if (body.get("rank") or {}).get("rrf") is not None:
            return "hybrid"
        if body.get("knn") is not None:
            return "knn"
        query = body.get("query")
        if query is None:
            return "other"
        if isinstance(query, dict):
            if "knn" in query:
                return "knn"
            if "text_expansion" in query:
                return "sparse"
        return "bm25"
    except Exception:  # noqa: BLE001 — classification must never fail
        return "other"


# ---------------------------------------------------------------------------
# histograms + the process-global registry
# ---------------------------------------------------------------------------

# exponential (HDR-style) bucket layout: HIST_SUB sub-buckets per power
# of two, from HIST_MIN_NS (1µs) up — ~19% value resolution across
# 1µs..~4.5min in ~112 ints. Same memory as the old 512-sample ring but
# the percentiles now reflect the WHOLE process history, which is what
# an overload scenario's p99 needs (a ring forgets the tail as soon as
# the flood of fast rejections rolls it over).
HIST_SUB = 4
HIST_MIN_NS = 1_000
HIST_BUCKETS = 28 * HIST_SUB


def _bucket_of(ns: int) -> int:
    if ns < HIST_MIN_NS:
        return 0
    idx = int(HIST_SUB * math.log2(ns / HIST_MIN_NS)) + 1
    return min(idx, HIST_BUCKETS - 1)


def _bucket_value_ns(idx: int) -> float:
    """Representative duration of one bucket (geometric midpoint)."""
    if idx <= 0:
        return float(HIST_MIN_NS)
    lo = HIST_MIN_NS * 2.0 ** ((idx - 1) / HIST_SUB)
    hi = HIST_MIN_NS * 2.0 ** (idx / HIST_SUB)
    return (lo * hi) ** 0.5


class _Hist:
    """Exponential-bucket histogram of durations (ns) + exact count and
    sum. Fixed memory for the process lifetime; the raw (sparse) bucket
    counts ride every snapshot so the coordinator can merge per-node
    sections into a fleet view and recompute honest percentiles."""

    __slots__ = ("buckets", "count", "sum_ns")

    def __init__(self):
        self.buckets = [0] * HIST_BUCKETS
        self.count = 0
        self.sum_ns = 0

    def observe(self, dur_ns: int) -> None:
        self.buckets[_bucket_of(dur_ns)] += 1
        self.count += 1
        self.sum_ns += dur_ns

    def _pct_ns(self, p: float) -> float:
        if not self.count:
            return 0.0
        target = max(1, math.ceil(p * self.count))
        seen = 0
        for idx, n in enumerate(self.buckets):
            seen += n
            if seen >= target:
                return _bucket_value_ns(idx)
        return _bucket_value_ns(HIST_BUCKETS - 1)

    def absorb_snapshot(self, snap: Dict[str, Any]) -> None:
        """Merge a (possibly remote) snapshot's raw buckets into this
        histogram — the fleet-merge path. Bucket keys arrive as strings
        after a JSON round trip."""
        count = int(snap.get("count") or 0)
        if not count:
            return
        self.count += count
        self.sum_ns += int(round(
            float(snap.get("mean_ms") or 0.0) * 1e6 * count))
        for key, n in (snap.get("buckets") or {}).items():
            idx = min(max(int(key), 0), HIST_BUCKETS - 1)
            self.buckets[idx] += int(n)

    def snapshot(self) -> Dict[str, Any]:
        out = {
            "count": self.count,
            "p50_ms": round(self._pct_ns(0.50) / 1e6, 4),
            "p95_ms": round(self._pct_ns(0.95) / 1e6, 4),
            "p99_ms": round(self._pct_ns(0.99) / 1e6, 4),
            "mean_ms": round(self.sum_ns / self.count / 1e6, 4)
            if self.count else 0.0,
        }
        if self.count:
            out["buckets"] = {idx: n for idx, n
                              in enumerate(self.buckets) if n}
        return out


class SearchTelemetry:
    """Process-global search-latency + fallback-reason registry (the
    PLANES / BREAKERS one-accelerator-per-process precedent). Surfaced
    as ``_nodes/stats`` ``"search_latency"`` and bench.py's telemetry
    block."""

    def __init__(self):
        # (query_class, data_plane) -> {"total": _Hist,
        #                               "spans": {name: _Hist},
        #                               "dispatches": int, "queries": int}
        self._planes: Dict[tuple, Dict[str, Any]] = {}
        self.fallbacks: Dict[str, int] = {}
        # feature -> requests refused with NotPortedError (features the
        # JAX package serves and this package does not carry yet)
        self.not_ported: Dict[str, int] = {}

    # -- recording --------------------------------------------------------

    def _entry(self, query_class: str, data_plane: str) -> Dict[str, Any]:
        key = (query_class, data_plane)
        entry = self._planes.get(key)
        if entry is None:
            entry = self._planes[key] = {
                "total": _Hist(), "spans": {}, "dispatches": 0,
                "queries": 0}
        return entry

    def observe(self, trace: SearchTrace) -> None:
        if not trace.total_ns:
            trace.finish()
        entry = self._entry(trace.query_class, trace.data_plane)
        entry["total"].observe(trace.total_ns)
        entry["queries"] += 1
        entry["dispatches"] += trace.dispatches
        spans = entry["spans"]
        for name, dur_ns, _meta in trace.spans:
            hist = spans.get(name)
            if hist is None:
                hist = spans[name] = _Hist()
            hist.observe(dur_ns)

    def observe_span(self, query_class: str, data_plane: str, name: str,
                     dur_ns: int) -> None:
        """Direct span observation (bench.py's per-config latency loops
        feed the same histograms the serving path does)."""
        entry = self._entry(query_class, data_plane)
        if name == "total":
            entry["total"].observe(max(int(dur_ns), 1))
            entry["queries"] += 1
            return
        hist = entry["spans"].get(name)
        if hist is None:
            hist = entry["spans"][name] = _Hist()
        hist.observe(max(int(dur_ns), 1))

    def count_fallback(self, reason: str, n: int = 1) -> None:
        """Typed routing-decision / fallback counter. An unrecognized
        reason counts under "unknown" — which the test suite pins at
        zero, so untyped call sites fail loudly instead of silently."""
        if reason not in KNOWN_REASONS:
            reason = UNKNOWN
        self.fallbacks[reason] = self.fallbacks.get(reason, 0) + n

    def count_not_ported(self, feature: str, n: int = 1) -> None:
        """A request refused because it needs ``feature``, which this
        package does not carry yet; counted by the feature's name."""
        self.not_ported[feature] = self.not_ported.get(feature, 0) + n

    # -- surfaces ---------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        classes: Dict[str, Any] = {}
        for (cls, plane), entry in sorted(self._planes.items()):
            classes[f"{cls}|{plane}"] = {
                "queries": entry["queries"],
                "device_dispatches": entry["dispatches"],
                "latency": entry["total"].snapshot(),
                "spans": {name: hist.snapshot()
                          for name, hist in sorted(
                              entry["spans"].items())},
            }
        return {
            "classes": classes,
            "fallback_reasons": dict(sorted(self.fallbacks.items())),
            "not_ported": dict(sorted(self.not_ported.items())),
        }

    def reset(self) -> None:
        self._planes.clear()
        self.fallbacks.clear()
        self.not_ported.clear()


TELEMETRY = SearchTelemetry()


def merge_latency_sections(sections: List[Dict[str, Any]]
                           ) -> Dict[str, Any]:
    """Coordinator-side fleet merge of per-node ``search_latency``
    sections (the ``_nodes/stats`` aggregation leg): raw exponential
    buckets sum across nodes and percentiles are recomputed from the
    merged distribution — never averaged from per-node percentiles,
    which would understate every fleet tail. ``_cluster/stats`` serves
    the result."""
    classes: Dict[str, Dict[str, Any]] = {}
    fallbacks: Dict[str, int] = {}
    for section in sections:
        for key, entry in (section.get("classes") or {}).items():
            agg = classes.get(key)
            if agg is None:
                agg = classes[key] = {"queries": 0, "dispatches": 0,
                                      "total": _Hist(), "spans": {}}
            agg["queries"] += int(entry.get("queries") or 0)
            agg["dispatches"] += int(entry.get("device_dispatches") or 0)
            agg["total"].absorb_snapshot(entry.get("latency") or {})
            for span, snap in (entry.get("spans") or {}).items():
                hist = agg["spans"].get(span)
                if hist is None:
                    hist = agg["spans"][span] = _Hist()
                hist.absorb_snapshot(snap or {})
        for reason, n in (section.get("fallback_reasons") or {}).items():
            fallbacks[reason] = fallbacks.get(reason, 0) + int(n)
    out_classes: Dict[str, Any] = {}
    for key, agg in sorted(classes.items()):
        out_classes[key] = {
            "queries": agg["queries"],
            "device_dispatches": agg["dispatches"],
            "latency": agg["total"].snapshot(),
            "spans": {span: hist.snapshot()
                      for span, hist in sorted(agg["spans"].items())},
        }
    return {"classes": out_classes,
            "fallback_reasons": dict(sorted(fallbacks.items()))}
