"""Node monitor probes: os / process / fs / device.

Reference: monitor/os/OsProbe.java, monitor/process/ProcessProbe.java,
monitor/fs/FsProbe.java — memory, load, file descriptors, data-path disk
usage — plus the accelerator dimension this build adds: device (HBM)
memory from the CUDA runtime, the resource that actually bounds search
working sets here.

Bootstrap checks (bootstrap/BootstrapChecks.java analog): run at node
start; failures log loudly and, when ``ESTPU_ENFORCE_BOOTSTRAP`` is
truthy (the production-mode analog), abort startup. The JVM-centric
checks (heap size, G1 settings) are moot in Python; the meaningful ones
here are descriptor limits, a writable data path, and a sane device/HBM
state.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


def _read_proc(path: str) -> Optional[str]:
    try:
        with open(path, encoding="ascii") as fh:
            return fh.read()
    except OSError:
        return None


def os_stats() -> Dict[str, Any]:
    """Memory + load from /proc (OsProbe.java's cgroup-less core)."""
    out: Dict[str, Any] = {"cpu": {"count": os.cpu_count() or 1}}
    meminfo = _read_proc("/proc/meminfo")
    if meminfo:
        fields = {}
        for line in meminfo.splitlines():
            name, _, rest = line.partition(":")
            parts = rest.split()
            if parts:
                fields[name] = int(parts[0]) * 1024   # kB -> bytes
        total = fields.get("MemTotal", 0)
        available = fields.get("MemAvailable", fields.get("MemFree", 0))
        out["mem"] = {
            "total_in_bytes": total,
            "free_in_bytes": available,
            "used_in_bytes": max(total - available, 0),
            "used_percent": round(100.0 * (total - available)
                                  / total, 1) if total else 0.0,
        }
    loadavg = _read_proc("/proc/loadavg")
    if loadavg:
        one, five, fifteen = loadavg.split()[:3]
        out["cpu"]["load_average"] = {"1m": float(one), "5m": float(five),
                                      "15m": float(fifteen)}
    return out


def process_stats() -> Dict[str, Any]:
    """Open FDs + RSS + cpu time for THIS process (ProcessProbe)."""
    out: Dict[str, Any] = {"id": os.getpid()}
    try:
        out["open_file_descriptors"] = len(os.listdir("/proc/self/fd"))
    except OSError:
        out["open_file_descriptors"] = -1
    try:
        import resource
        soft, _hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        out["max_file_descriptors"] = soft
        usage = resource.getrusage(resource.RUSAGE_SELF)
        out["mem"] = {"resident_in_bytes": usage.ru_maxrss * 1024}
        out["cpu"] = {"total_in_millis": int(
            (usage.ru_utime + usage.ru_stime) * 1000)}
    except (ImportError, ValueError):
        pass
    return out


def fs_stats(data_path: Optional[str]) -> Dict[str, Any]:
    """Disk totals for the data path (FsProbe)."""
    path = data_path or "."
    try:
        st = os.statvfs(path)
    except OSError:
        return {"total": {}}
    total = st.f_frsize * st.f_blocks
    free = st.f_frsize * st.f_bavail
    return {"total": {
        "path": os.path.abspath(path),
        "total_in_bytes": total,
        "free_in_bytes": free,
        "available_in_bytes": free,
    }}


def device_stats() -> Dict[str, Any]:
    """Card memory per device, when CUDA is live in this process -- the
    HBM counterpart of the reference's heap stats. Never initializes CUDA
    itself (stats observe, they must not pay first-init): a process that
    has run nothing on the card reports no devices."""
    out: Dict[str, Any] = {"devices": []}
    import sys
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return out
    for idx in range(torch.cuda.device_count()):
        entry: Dict[str, Any] = {"id": idx, "platform": "gpu"}
        try:
            free, total = torch.cuda.mem_get_info(idx)
            entry["bytes_in_use"] = int(total - free)
            entry["bytes_limit"] = int(total)
        except Exception:  # noqa: BLE001 — a card that cannot answer
            pass
        out["devices"].append(entry)
    return out


def device_plane_stats() -> Dict[str, Any]:
    """Packed multi-segment plane observability (ops/device_segment.py
    PlaneRegistry): full rebuilds vs incremental appends, evictions,
    resident bytes per kind (the ``columns`` doc-values plane
    included), the quantized coarse tier's configured and SERVED
    re-rank depths (rerank_depth / rerank_depth_max /
    rerank_depth_histogram, with quantized_queries, rerank_escalations,
    quantized_exact_fallbacks and the measured-latency engage rule's
    quantized_disengaged_slow), the drain-wide aggregation counters
    (plane_aggs_queries = specs served from a device partial,
    plane_aggs_fallbacks), and how often a missing/refused plane forced
    the per-segment fallback. Never initializes the device layer
    itself — a node that has served no device work reports an empty
    section."""
    import sys
    mod = sys.modules.get("elasticsearch_tpu_torch.ops.device_segment")
    if mod is None:
        return {}
    return mod.PLANES.stats_snapshot()


def mesh_plane_stats(mesh_executor=None) -> Dict[str, Any]:
    """Mesh-sharded plane observability (ops/device_segment.py
    MeshPlaneRegistry + search/mesh_executor.py): builds vs incremental
    appends, evictions, miss fallbacks, resident bytes (total and per
    device), plus the fan-out executor's served/fallback/dispatch
    counters. On a multi-host mesh (search.mesh.hosts) the section also
    carries the configured topology (``hosts``: n_hosts /
    devices_per_host / spec) and ``per_host`` serving counters — per
    host label, shard results scored off that host's copies and typed
    mesh_host_lost losses — so _nodes/stats shows WHERE the one-program
    fan-out's work actually lands as the mesh grows past one node.
    Never initializes the device layer itself."""
    import sys
    mod = sys.modules.get("elasticsearch_tpu_torch.ops.device_segment")
    if mod is None:
        return {}
    out = mod.MESH_PLANES.stats_snapshot()
    if mesh_executor is not None:
        out.update(mesh_executor.stats)
        per_host = getattr(mesh_executor, "per_host_stats", None)
        if per_host:
            out["per_host"] = {h: dict(c) for h, c in per_host.items()}
    return out


def search_batch_stats(batcher, rrf_fuser=None) -> Dict[str, Any]:
    """Micro-batcher observability (search/batch_executor.py): dispatch /
    occupancy / wait-time counters plus the derived means operators watch
    to see whether cross-query batching is actually engaging. The raw
    counters are cumulative since node start, like every other stat.

    Also derives the per-drain-memo hit rate (what fraction of dispatched
    queries were answered by a batch-mate's rows) and, when this node
    coordinates hybrid searches, merges the RRF fusion batcher's
    counters (rrf_fuse_batches / requests / max occupancy /
    fallbacks)."""
    if batcher is None:
        return {}
    out: Dict[str, Any] = dict(batcher.stats)
    dispatches = out.get("batches_dispatched", 0)
    queries = out.get("queries_dispatched", 0)
    out["mean_occupancy"] = round(queries / dispatches, 3) \
        if dispatches else 0.0
    out["mean_wait_ms"] = round(out.get("wait_ms_total", 0.0) / queries, 3) \
        if queries else 0.0
    out["memo_hit_rate"] = round(
        out.get("memo_hits", 0) / queries, 4) if queries else 0.0
    if rrf_fuser is not None:
        out.update(rrf_fuser.stats)
        fuses = out.get("rrf_fuse_batches", 0)
        out["mean_rrf_fuse_occupancy"] = round(
            out.get("rrf_fuse_requests", 0) / fuses, 3) if fuses else 0.0
    return out


def search_admission_stats(thread_pool, response_collector=None,
                           batcher=None,
                           ars_stats=None,
                           failover_stats=None) -> Dict[str, Any]:
    """Overload-control observability (utils/threadpool.py +
    action/response_collector.py + the shard batcher's pressure
    tracker): the search pool's live queue bounds and adaptive-resize
    state, rejections by tenant key, the Retry-After values issued, the
    node's own self-reported pressure, the shard-side shed point
    (``shard_queue``: configured + effective member bounds, occupancy,
    shard_busy sheds, the drain-rate estimate behind Retry-After) and
    the coordinator's busy-failover counters
    (``shard_busy_failover``: sheds seen, copy failovers, backed-off
    retry rounds, all-copies-shed surfaces), and the C3 rank inputs per
    node — everything an operator needs to explain WHY a request was
    shed, rerouted, or a replica skipped, from the stats surface
    alone."""
    if thread_pool is None:
        return {}
    pool = thread_pool.pools.get("search")
    if pool is None:
        return {}
    out: Dict[str, Any] = pool.admission_stats()
    if batcher is not None:
        out["node_pressure"] = batcher.node_pressure.snapshot(
            batcher.queue_depth())
        out["shard_queue"] = batcher.shard_queue_stats()
    if failover_stats is not None:
        out["shard_busy_failover"] = dict(failover_stats)
    # the caller may pass the already-built rank-input map (node stats
    # serves it under adaptive_selection too — compute once per call)
    if ars_stats is None and response_collector is not None:
        ars_stats = response_collector.stats()
    if ars_stats is not None:
        out["ars"] = ars_stats
    return out


def indexing_pressure_stats(thread_pool, shard_bulk=None) -> Dict[str, Any]:
    """Write-path pressure-plane observability (utils/threadpool.py
    IndexingPressure + action/replication.py): per-stage in-flight /
    lifetime byte accounting under the coordinating / primary / replica
    split, the per-stage rejection buckets (with the pinned-zero
    ``unknown`` bucket — every rejection must be attributable to a
    stage), the measured release rate behind the computed Retry-After
    values, and the primary's replica-pressure retry counters
    (rejections seen, batches that converged on retry, copies failed
    after the retry budget) — so a shed write, a slow ack, or a dropped
    replica is explainable from the stats surface alone."""
    if thread_pool is None:
        return {}
    ip = getattr(thread_pool, "indexing_pressure", None)
    if ip is None:
        return {}
    out: Dict[str, Any] = ip.stats()
    if shard_bulk is not None:
        out["replica_retries"] = dict(
            getattr(shard_bulk, "write_pressure_stats", {}) or {})
    return out


def request_cache_stats(search_transport, search_action=None
                        ) -> Dict[str, Any]:
    """Two-tier request-cache observability (indices/request_cache.py):
    the shard tier's hits / misses / evictions / typed
    invalidations_by_cause / resident bytes plus the batcher's
    intake-hit and pressure-observation counters, and the coordinator
    fused-result tier's figures under ``coordinator_*`` — so the
    duplicate-traffic win (and every entry the breaker refused) is
    explainable from the stats surface alone."""
    if search_transport is None:
        return {}
    out: Dict[str, Any] = search_transport.request_cache.snapshot()
    batcher = getattr(search_transport, "batcher", None)
    if batcher is not None:
        out["intake_hits"] = batcher.stats.get(
            "request_cache_intake_hits", 0)
        out["cached_pressure_observations"] = \
            batcher.node_pressure.cached_served
    if search_action is not None and \
            getattr(search_action, "fused_cache", None) is not None:
        out.update(search_action.fused_cache.snapshot(
            prefix="coordinator_"))
    return out


def search_latency_stats() -> Dict[str, Any]:
    """Search telemetry plane observability (search/telemetry.py
    TELEMETRY): ring-buffer latency histograms (p50/p95/p99 + span-level
    breakdown) per (query class x data plane), device-dispatch counts,
    and the complete fallback-reason taxonomy — every mesh -> RPC,
    plane -> per-segment, and batch -> solo event under a typed reason.
    Never imports the search package before it has served (a node that
    has run no searches reports an empty section)."""
    import sys
    mod = sys.modules.get("elasticsearch_tpu_torch.search.telemetry")
    if mod is None:
        return {}
    return mod.TELEMETRY.snapshot()


def device_profile_stats() -> Dict[str, Any]:
    """Device observatory observability (search/device_profile.py
    DEVICE_PROFILE + the plane registries' residency timelines): per
    kernel-family compile counts vs cache hits, compile wall-time,
    live shape-bucket cardinality, the recompile-storm counter, the
    measured execute-time EWMA per (family, shape bucket) and guarded
    FLOPs/bytes estimates — plus WHERE the plane HBM went (bytes by
    generation age, high-water marks) and WHY it left (eviction
    causes). Never initializes the device layer itself — a node that
    has dispatched no kernels reports an empty section."""
    import sys
    out: Dict[str, Any] = {}
    dp = sys.modules.get("elasticsearch_tpu_torch.search.device_profile")
    if dp is not None:
        out = dp.DEVICE_PROFILE.snapshot()
    seg = sys.modules.get("elasticsearch_tpu_torch.ops.device_segment")
    if seg is not None:
        out["plane_residency"] = seg.PLANES.residency_snapshot()
        out["mesh_plane_residency"] = \
            seg.MESH_PLANES.residency_snapshot()
    return out


def hot_spans_report(node, limit: int = 16) -> Dict[str, Any]:
    """GET /_nodes/hot_spans — the reference hot-threads analog over the
    data planes: sample every in-flight search task (the serving paths
    maintain phase / data plane / drain occupancy on the task status)
    and render the longest-running first, plus the shard batcher's
    queued members per batch key and the node's own pressure snapshot.
    Pure observation: nothing here touches a queue or a task."""
    spans: List[Dict[str, Any]] = []
    tm = getattr(node, "task_manager", None)
    if tm is not None:
        now_ms = tm.now_ms()
        for task in tm.list():
            if not str(task.action).startswith("indices:data/read/search"):
                continue
            status = task.status or {}
            entry: Dict[str, Any] = {
                "task": task.task_id,
                "action": task.action,
                "description": task.description,
                "phase": status.get("phase", "running"),
                "elapsed_ms": round(
                    max(now_ms - task.start_time_ms, 0.0), 3),
            }
            if status.get("data_plane") is not None:
                entry["data_plane"] = status["data_plane"]
            if status.get("occupancy") is not None:
                entry["occupancy"] = status["occupancy"]
            spans.append(entry)
    spans.sort(key=lambda s: (-s["elapsed_ms"], s["task"]))
    out: Dict[str, Any] = {
        "in_flight_total": len(spans),
        "spans": spans[: max(int(limit), 1)],
    }
    batcher = getattr(getattr(node, "search_transport", None),
                      "batcher", None)
    if batcher is not None:
        # batch keys are (index, shard, kind, ...bucketing components) —
        # never request payloads — but the rendering is still truncated
        # so no future key component can balloon a monitoring response;
        # colliding truncations SUM rather than shadow each other
        queued: Dict[str, int] = {}
        for key, queue in batcher._queues.items():
            if queue:
                label = "/".join(str(part) for part in key)[:128]
                queued[label] = queued.get(label, 0) + len(queue)
        out["queued_members"] = queued
        out["node_pressure"] = batcher.node_pressure.snapshot(
            batcher.queue_depth())
    return out


def recovery_stats(reconciler, indices_service=None) -> Dict[str, Any]:
    """Recovery & retention observability (indices/cluster_state_service
    + index/seqno): recoveries by kind (ops_based / peer_reuse / peer /
    in_place / existing_store / empty_store), ops replayed by catch-ups,
    bytes copied vs avoided, the typed file-fallback reason taxonomy,
    plus live lease counts and soft-delete history size across this
    node's primaries — the whole "did that restart pay a wipe?" question
    answerable from _nodes/stats alone."""
    if reconciler is None:
        return {}
    out: Dict[str, Any] = {
        "kinds": dict(reconciler.recovery_stats["kinds"]),
        "ops_replayed": reconciler.recovery_stats["ops_replayed"],
        "bytes_copied": reconciler.recovery_stats["bytes_copied"],
        "bytes_avoided": reconciler.recovery_stats["bytes_avoided"],
        "file_fallback_reasons": dict(
            reconciler.recovery_stats["file_fallback_reasons"]),
        "active_leases": 0, "leases_expired_total": 0,
        "leases_released_node_left": 0,
        "history_retained_ops": 0,
        # failover machinery: post-promotion resyncs this node ran as a
        # new primary, and cross-term rollbacks its engines performed
        "resync": dict(resyncer.stats) if (
            resyncer := getattr(reconciler, "resyncer", None)) is not None
        else {},
        "rollbacks": 0, "ops_rolled_back": 0,
        "translog_ops_trimmed": 0,
    }
    if indices_service is not None:
        for shard in list(indices_service.all_shards()):
            try:
                out["history_retained_ops"] += \
                    shard.engine.history_stats()["retained_ops"]
                out["rollbacks"] += shard.engine.rollbacks_total
                out["ops_rolled_back"] += shard.engine.ops_rolled_back_total
                if shard.engine.translog is not None:
                    out["translog_ops_trimmed"] += \
                        shard.engine.translog.ops_trimmed_below_total + \
                        shard.engine.translog.ops_trimmed_above_total
                if shard.tracker is not None:
                    lease_stats = shard.tracker.lease_stats()
                    out["active_leases"] += lease_stats["active"]
                    out["leases_expired_total"] += \
                        lease_stats["expired_total"]
                    out["leases_released_node_left"] += \
                        lease_stats["released_node_left"]
            except Exception:  # noqa: BLE001 — a closing shard is fine
                continue
    return out


def gateway_stats(gateway_allocator) -> Dict[str, Any]:
    """Gateway shard-state fetch observability (gateway.py
    GatewayAllocator): how many fetches the master issued, how often the
    cache answered, what the nodes reported (no copy / corruption-marked
    / stale), plus reconcile failures and cancelled recoveries — so every
    allocation decision the gateway makes is visible in _nodes/stats."""
    if gateway_allocator is None:
        return {}
    # the allocator owns the race-safe snapshot (stats can be read from
    # a REST thread while the dispatch thread mutates the fetch state)
    return gateway_allocator.stats_snapshot()


# ---------------------------------------------------------------------------
# bootstrap checks
# ---------------------------------------------------------------------------

MIN_FDS = 1024
# boot-time HBM occupancy above this fraction means another process (or a
# leak) already owns the accelerator the node is about to serve from
MAX_BOOT_HBM_FRACTION = 0.5


def bootstrap_checks(data_path: Optional[str]) -> List[str]:
    """Failure messages (empty = healthy). BootstrapChecks analog with a
    device-HBM gate replacing the JVM heap checks."""
    failures: List[str] = []
    proc = process_stats()
    max_fds = proc.get("max_file_descriptors", -1)
    if 0 < max_fds < MIN_FDS:
        failures.append(
            f"max file descriptors [{max_fds}] is too low; raise the "
            f"limit to at least [{MIN_FDS}]")
    if data_path is not None:
        probe = os.path.join(data_path, ".bootstrap_probe")
        try:
            os.makedirs(data_path, exist_ok=True)
            with open(probe, "w", encoding="ascii") as fh:
                fh.write("ok")
            os.remove(probe)
        except OSError as e:
            failures.append(f"data path [{data_path}] is not writable: {e}")
        else:
            fs = fs_stats(data_path).get("total", {})
            if fs.get("available_in_bytes", 1) == 0:
                failures.append(
                    f"data path [{data_path}] has no free space")
    for dev in device_stats().get("devices", []):
        limit = dev.get("bytes_limit")
        in_use = dev.get("bytes_in_use")
        if limit and in_use is not None and \
                in_use > limit * MAX_BOOT_HBM_FRACTION:
            failures.append(
                f"device [{dev.get('id')}] ({dev.get('platform')}) "
                f"already has {in_use} of {limit} HBM bytes in use at "
                f"boot — another process owns the accelerator")
    return failures


def run_bootstrap_checks(data_path: Optional[str]) -> None:
    """Log failures; raise when ESTPU_ENFORCE_BOOTSTRAP is truthy (the
    reference enforces in production mode, warns in dev mode)."""
    failures = bootstrap_checks(data_path)
    if not failures:
        return
    for failure in failures:
        logger.warning("bootstrap check failure: %s", failure)
    if str(os.environ.get("ESTPU_ENFORCE_BOOTSTRAP", "")).lower() in (
            "1", "true", "yes"):
        raise RuntimeError(
            "bootstrap checks failed: " + "; ".join(failures))
