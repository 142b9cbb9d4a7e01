"""Primary→replica replication for shard-level write batches.

Reference analog: action/support/replication/TransportReplicationAction.java
(ReroutePhase :625 — resolve the primary from cluster state and retry on
stale routing; AsyncPrimaryAction :284) and ReplicationOperation.java:110 —
execute on the primary, fan out concurrently to every assigned replica
copy, ack the caller only when all copies respond (failed copies are
reported to the master for removal, ShardStateAction analog). The primary's
global checkpoint rides on every replica request, and replica local
checkpoints ride back (GlobalCheckpointSyncAction piggyback).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from elasticsearch_tpu_torch.cluster.routing import ShardRouting, ShardState
from elasticsearch_tpu_torch.cluster.state import ClusterState
from elasticsearch_tpu_torch.index.shard import IndexShard
from elasticsearch_tpu_torch.indices.cluster_state_service import SHARD_FAILED
from elasticsearch_tpu_torch.indices.indices_service import IndicesService
from elasticsearch_tpu_torch.transport.scheduler import Scheduler
from elasticsearch_tpu_torch.transport.transport import Deferred, TransportService
from elasticsearch_tpu_torch.utils.errors import (
    IndexNotFoundError, SearchEngineError, ShardNotFoundError,
    UnavailableShardsError, VersionConflictError, write_pressure_info,
)
from elasticsearch_tpu_torch.utils.retry import RetryableAction

SHARD_BULK_PRIMARY = "indices:data/write/bulk[s][p]"
SHARD_BULK_REPLICA = "indices:data/write/bulk[s][r]"

# reroute backoff: first retry ~RETRY_INITIAL_DELAY, jittered-exponential
# up to RETRY_MAX_DELAY (utils/retry.py), capped by REROUTE_TIMEOUT overall
RETRY_INITIAL_DELAY = 0.2
RETRY_MAX_DELAY = 5.0
REROUTE_TIMEOUT = 30.0
# replica-stage indexing-pressure rejections are retried under the same
# backoff shape before the copy is failed out of the in-sync set: a
# transiently-starved replica converges, only a stuck one is removed
REPLICA_RETRY_TIMEOUT = 30.0


def _ops_bytes(ops: List[Dict[str, Any]]) -> int:
    """Byte estimate for a replicated-op batch (the replica-stage
    indexing-pressure charge): source payloads plus a fixed per-op
    allowance, no serialization on the hot path."""
    return sum(len(repr(op.get("source") or "")) + 64 for op in ops)


def _is_retryable(err: Any) -> bool:
    """True only when the op provably did not execute on a current primary:
    connection refused before delivery, stale-routing rejections, or
    routing that hasn't (yet) resolved to an active primary."""
    from elasticsearch_tpu_torch.transport.transport import NodeNotConnectedError
    if isinstance(err, (NodeNotConnectedError, UnavailableShardsError,
                        IndexNotFoundError, ShardNotFoundError)):
        return True
    text = str(err)
    return ("UnavailableShardsError" in text
            or "ShardNotFoundError" in text
            or "IndexNotFoundError" in text)


class TransportShardBulkAction:
    """One shard's slice of a bulk request, executed with replication."""

    def __init__(self, node_id: str, indices: IndicesService,
                 ts: TransportService, scheduler: Scheduler,
                 state_supplier: Callable[[], ClusterState],
                 thread_pool=None, node_pressure=None,
                 response_collector=None):
        self.node_id = node_id
        self.indices = indices
        self.ts = ts
        self.scheduler = scheduler
        self.state = state_supplier
        # write-path pressure plane wiring (all optional — unit tests
        # exercise the replication protocol without it): thread_pool
        # carries the three-stage IndexingPressure; node_pressure /
        # response_collector are LAZY accessors (the owning Node
        # constructs those services after this action)
        self.thread_pool = thread_pool
        self.node_pressure = node_pressure
        self.response_collector = response_collector
        self.last_reroute_retry: Optional[RetryableAction] = None
        self.last_replica_retry: Optional[RetryableAction] = None
        self.write_pressure_stats: Dict[str, int] = {
            "replica_pressure_rejections": 0,
            "replica_pressure_recoveries": 0,
            "replica_pressure_exhausted": 0}
        ts.register_handler(SHARD_BULK_PRIMARY, self._on_primary)
        ts.register_handler(SHARD_BULK_REPLICA, self._on_replica)

    # -- pressure-plane helpers ----------------------------------------

    def _pressure(self):
        if self.thread_pool is None:
            return None
        return getattr(self.thread_pool, "indexing_pressure", None)

    def _observe_write(self) -> None:
        """Fold this node's in-flight write bytes into its own
        NodePressure tracker — the same snapshot the shard batcher
        piggybacks on every search response, so ARS and the shard shed
        point see an ingest-hot node before read latency degrades."""
        ip = self._pressure()
        if ip is None or self.node_pressure is None:
            return
        try:
            tracker = self.node_pressure()
        except Exception:  # noqa: BLE001 — observability must not fail writes
            return
        if tracker is not None:
            tracker.observe_write(sum(ip.current.values()), ip.limit)

    def _ingest_remote_pressure(self, node_id: str,
                                snapshot: Optional[Dict[str, Any]]
                                ) -> None:
        """A peer's write-pressure snapshot rode back on a bulk /
        replication response: feed it to the local ResponseCollector so
        replica selection ranks the ingest-hot node down."""
        if snapshot is None or self.response_collector is None:
            return
        try:
            collector = self.response_collector()
        except Exception:  # noqa: BLE001 — observability must not fail writes
            return
        if collector is not None:
            collector.on_write_pressure(
                node_id, snapshot.get("current_bytes", 0),
                snapshot.get("limit_bytes", 0))

    # ------------------------------------------------------------------
    # coordinator side: route to the primary, retrying on stale routing
    # ------------------------------------------------------------------

    def execute(self, index: str, shard_id: int, items: List[Dict[str, Any]],
                on_done: Callable[[Optional[Dict[str, Any]],
                                   Optional[Exception]], None]) -> None:
        """Reroute phase as a RetryableAction: each attempt re-resolves the
        primary from CURRENT cluster state, so a retry after failover/heal
        lands on the promoted copy. Retries are jittered-exponential
        (utils/retry.py) — no fixed-delay spinning — and only fire for
        errors proving the op never executed (timeouts/unknown remote
        errors surface immediately: the primary may have applied the ops,
        and re-sending would duplicate writes)."""

        def attempt(cb) -> None:
            state = self.state()
            try:
                primary = state.routing_table.index(index).primary(shard_id)
            except SearchEngineError as e:
                cb(None, e)
                return
            if not primary.active or primary.node_id is None:
                cb(None, UnavailableShardsError(
                    f"primary shard [{index}][{shard_id}] is not active"))
                return

            def relay(resp, err, nid=primary.node_id) -> None:
                # the primary's write-pressure snapshot piggybacks on
                # every bulk response — feed it to this coordinator's
                # ARS view before completing the caller
                if err is None and isinstance(resp, dict):
                    self._ingest_remote_pressure(
                        nid, resp.get("write_pressure"))
                cb(resp, err)
            self.ts.send_request(
                primary.node_id, SHARD_BULK_PRIMARY,
                {"index": index, "shard": shard_id, "items": items},
                relay, timeout=REROUTE_TIMEOUT)

        action = RetryableAction(
            self.scheduler, attempt, on_done,
            initial_delay=RETRY_INITIAL_DELAY, max_delay=RETRY_MAX_DELAY,
            timeout=REROUTE_TIMEOUT, is_retryable=_is_retryable)
        # observable for telemetry and the chaos suite (backoff shape)
        self.last_reroute_retry = action
        action.run()

    # ------------------------------------------------------------------
    # primary side
    # ------------------------------------------------------------------

    def _on_primary(self, req: Dict[str, Any], sender: str) -> Deferred:
        index, shard_id = req["index"], req["shard"]
        shard = self.indices.shard(index, shard_id)
        if not shard.primary:
            raise UnavailableShardsError(
                f"shard [{index}][{shard_id}] on [{self.node_id}] "
                f"is not the primary")
        # primary-stage charge (IndexingPressure.markPrimaryOperationStarted
        # analog): held until the response is built, covering replica
        # fan-out. A rejection here surfaces to the coordinator as a
        # typed per-item 429 (NOT reroute-retried — the reference's
        # contract is that primary pressure sheds back to the client).
        ip = self._pressure()
        est = 0
        if ip is not None:
            ip.configure_from_state(self.state())
            # lazy import: bulk.py imports this module at its top
            from elasticsearch_tpu_torch.action.bulk import estimate_items_bytes
            est = estimate_items_bytes(req["items"])
            ip.acquire("primary", est)
            self._observe_write()
        results: List[Dict[str, Any]] = []
        ops: List[Dict[str, Any]] = []
        for item in req["items"]:
            results.append(self._execute_item(shard, item, ops))

        deferred = Deferred()

        def finish() -> None:
            # build the response (with the pressure snapshot) BEFORE
            # releasing, so the coordinator sees the load this request
            # contributed; then release and refresh the local tracker
            resp = self._primary_response(shard, results)
            if ip is not None:
                ip.release("primary", est)
                self._observe_write()
            deferred.resolve(resp)

        state = self.state()
        replicas = [
            sr for sr in
            state.routing_table.index(index).shard_group(shard_id)
            if not sr.primary and sr.assigned and sr.node_id != self.node_id
            and sr.state in (ShardState.INITIALIZING, ShardState.STARTED,
                             ShardState.RELOCATING)]
        pending = {"n": len(replicas)}
        if not ops or not replicas:
            finish()
            return deferred

        payload = {"index": index, "shard": shard_id, "ops": ops,
                   "global_checkpoint": shard.global_checkpoint,
                   "primary_term": shard.primary_term,
                   # the lease set rides every fan-out (RetentionLease
                   # sync analog): replicas persist it, so a promotion
                   # inherits the fleet's retention promises
                   "retention_leases": [
                       lease.to_dict()
                       for lease in shard.tracker.leases()]}

        def one_done() -> None:
            pending["n"] -= 1
            if pending["n"] == 0:
                finish()

        for replica in replicas:
            self._replicate_to(replica, payload, shard, one_done)
        return deferred

    def _replicate_to(self, sr: ShardRouting, payload: Dict[str, Any],
                      shard: IndexShard, one_done: Callable[[], None]
                      ) -> None:
        """Send one replica its op batch, retrying REPLICA-STAGE pressure
        rejections with jittered-exponential backoff before giving up.
        A transiently-starved replica (its 1.5×-headroom budget full of
        other primaries' fan-out) converges once it drains — acked docs
        are never lost to a momentary spike — while a replica still
        rejecting at REPLICA_RETRY_TIMEOUT is failed from the in-sync
        set like any other replication failure. Redelivery is safe: a
        rejected batch applied ZERO ops (the replica charges before
        applying), and the engine's per-doc seqno guard makes any
        re-send idempotent anyway."""
        saw_rejection = {"n": 0}

        def attempt(cb) -> None:
            self.ts.send_request(sr.node_id, SHARD_BULK_REPLICA, payload,
                                 cb, timeout=30.0)

        def is_pressure(err: Any) -> bool:
            if write_pressure_info(err) is None:
                return False
            saw_rejection["n"] += 1
            self.write_pressure_stats["replica_pressure_rejections"] += 1
            return True

        def on_ack(resp, err) -> None:
            if err is not None:
                if write_pressure_info(err) is not None:
                    self.write_pressure_stats[
                        "replica_pressure_exhausted"] += 1
                # replica could not apply acknowledged writes: it must
                # leave the in-sync set before we ack the client
                self._fail_replica(sr, str(err), one_done)
                return
            if saw_rejection["n"]:
                self.write_pressure_stats[
                    "replica_pressure_recoveries"] += 1
            if isinstance(resp, dict):
                self._ingest_remote_pressure(
                    sr.node_id, resp.get("write_pressure"))
            if shard.tracker is not None and sr.allocation_id:
                shard.tracker.update_local_checkpoint(
                    sr.allocation_id, resp.get("local_checkpoint", -1))
            one_done()

        action = RetryableAction(
            self.scheduler, attempt, on_ack,
            initial_delay=RETRY_INITIAL_DELAY, max_delay=RETRY_MAX_DELAY,
            timeout=REPLICA_RETRY_TIMEOUT, is_retryable=is_pressure)
        self.last_replica_retry = action
        action.run()

    def _execute_item(self, shard: IndexShard, item: Dict[str, Any],
                      ops: List[Dict[str, Any]]) -> Dict[str, Any]:
        action = item["action"]
        try:
            if action in ("index", "create"):
                result = shard.apply_index_on_primary(
                    item["id"], item["source"], routing=item.get("routing"),
                    op_type="create" if action == "create" else "index",
                    if_seq_no=item.get("if_seq_no"),
                    if_primary_term=item.get("if_primary_term"))
                ops.append(IndexShard.replicated_op(
                    result, "index", source=item["source"],
                    routing=item.get("routing")))
            elif action == "update":
                # primary-side get+merge+index (UpdateHelper analog): safe
                # against concurrent writers because the whole item runs
                # inside the primary's handler dispatch
                body = item.get("source") or {}
                current = shard.engine.get(item["id"], realtime=True)
                if current is None:
                    if "upsert" in body:
                        new_source = dict(body["upsert"])
                    elif body.get("doc_as_upsert") and "doc" in body:
                        new_source = dict(body["doc"])
                    else:
                        from elasticsearch_tpu_torch.utils.errors import (
                            DocumentMissingError,
                        )
                        raise DocumentMissingError(
                            shard.shard_id.index, item["id"])
                else:
                    new_source = dict(current["_source"])
                    if "doc" in body:
                        _deep_merge(new_source, body["doc"])
                    elif "script" in body:
                        from elasticsearch_tpu_torch.script.engine import (
                            execute_update_script,
                        )
                        merged = execute_update_script(new_source,
                                                       body["script"])
                        if merged is None:    # ctx.op = 'delete'
                            result = shard.apply_delete_on_primary(item["id"])
                            ops.append(IndexShard.replicated_op(
                                result, "delete"))
                            return {"action": action, "id": result.doc_id,
                                    "result": "deleted",
                                    "_seq_no": result.seqno,
                                    "_primary_term": result.primary_term,
                                    "_version": result.version,
                                    "status": 200}
                        new_source = merged
                result = shard.apply_index_on_primary(
                    item["id"], new_source, routing=item.get("routing"))
                ops.append(IndexShard.replicated_op(
                    result, "index", source=new_source,
                    routing=item.get("routing")))
            elif action == "delete":
                result = shard.apply_delete_on_primary(
                    item["id"],
                    if_seq_no=item.get("if_seq_no"),
                    if_primary_term=item.get("if_primary_term"))
                ops.append(IndexShard.replicated_op(result, "delete"))
            else:
                raise ValueError(f"unknown bulk action [{action}]")
        except VersionConflictError as e:
            return {"action": action, "id": item.get("id"), "error": {
                "type": "version_conflict_engine_exception",
                "reason": str(e)}, "status": 409}
        except Exception as e:  # noqa: BLE001 — per-item failure, not fatal
            return {"action": action, "id": item.get("id"), "error": {
                "type": type(e).__name__, "reason": str(e)}, "status": 400}
        return {"action": action, "id": result.doc_id,
                "result": result.result, "_seq_no": result.seqno,
                "_primary_term": result.primary_term,
                "_version": result.version,
                "status": 201 if result.result == "created" else 200}

    def _primary_response(self, shard: IndexShard,
                          results: List[Dict[str, Any]]) -> Dict[str, Any]:
        resp = {"items": results,
                "global_checkpoint": shard.global_checkpoint,
                "local_checkpoint": shard.local_checkpoint}
        ip = self._pressure()
        if ip is not None:
            # write-pressure snapshot piggybacks on the response so the
            # coordinator's ARS view learns this node is ingest-hot
            # without a stats poll (response piggyback, PR 11 pattern)
            resp["write_pressure"] = {
                "current_bytes": sum(ip.current.values()),
                "limit_bytes": ip.limit}
        return resp

    def _fail_replica(self, sr: ShardRouting, reason: str,
                      done: Callable[[], None]) -> None:
        state = self.state()
        master = state.master_node_id
        if master is None:
            done()
            return
        self.ts.send_request(master, SHARD_FAILED,
                             {"shard": sr.to_dict(),
                              "reason": f"replication failed: {reason}"},
                             lambda r, e: done(), timeout=30.0)

    # ------------------------------------------------------------------
    # replica side
    # ------------------------------------------------------------------

    def _on_replica(self, req: Dict[str, Any], sender: str) -> Dict[str, Any]:
        shard = self.indices.shard(req["index"], req["shard"])
        # replica-stage charge at 1.5× headroom, BEFORE any op applies:
        # a rejection means zero ops landed, so the primary's retry loop
        # can safely redeliver the whole batch. The extra headroom means
        # a node whose coordinating admission is saturated still accepts
        # replication fan-out from its peers — without it, two mutually
        # replicating nodes at their coordinating limits deadlock.
        ip = self._pressure()
        est = 0
        if ip is not None:
            ip.configure_from_state(self.state())
            est = _ops_bytes(req["ops"])
            ip.acquire("replica", est)
            self._observe_write()
        try:
            for op in req["ops"]:
                # the REQUEST term is the fence (ops keep their original
                # terms: a resync re-sends deposed-term ops under the new
                # primacy); the request's global checkpoint rides along
                # so a term bump rolls back to the newest checkpoint
                # known anywhere
                shard.apply_op_on_replica(
                    op, req_primary_term=req["primary_term"],
                    req_global_checkpoint=req["global_checkpoint"])
            shard.update_global_checkpoint_on_replica(
                req["global_checkpoint"])
            shard.learn_retention_leases(req.get("retention_leases"))
        finally:
            if ip is not None:
                ip.release("replica", est)
                self._observe_write()
        resp = {"local_checkpoint": shard.local_checkpoint}
        if ip is not None:
            resp["write_pressure"] = {
                "current_bytes": sum(ip.current.values()),
                "limit_bytes": ip.limit}
        return resp


SHARD_RESYNC = "indices:admin/seq_no/resync[r]"


class PrimaryReplicaSyncer:
    """Post-promotion primary–replica resync (PrimaryReplicaSyncer.java):
    every op above the global checkpoint the new primary knew at
    promotion is re-replicated — with its ORIGINAL primary term, under
    the NEW request term — to every in-sync copy, so replicas converge
    on the new primacy without paying a recovery. Redelivery is safe:
    the request-term bump makes each replica roll back its deposed-term
    tail to the global checkpoint first, and the engine's per-doc seqno
    guard turns ops a copy already holds into acks.

    The resync also rebuilds the promoted primary's replication
    tracker: each ack re-registers the copy (init_tracking + lease +
    mark_in_sync), so the global checkpoint and lease renewal resume
    exactly where the deposed primary left them."""

    def __init__(self, node_id: str, indices: IndicesService,
                 ts: TransportService,
                 state_supplier: Callable[[], Optional[ClusterState]]):
        self.node_id = node_id
        self.indices = indices
        self.ts = ts
        self.state = state_supplier
        self.stats: Dict[str, int] = {
            "resyncs_started": 0, "resyncs_completed": 0,
            "resyncs_noop": 0, "resync_ops_sent": 0,
            "resync_targets": 0, "resync_failures": 0,
            "resync_ops_applied": 0}
        ts.register_handler(SHARD_RESYNC, self._on_resync_replica)

    def resync(self, index: str, shard_id: int,
               on_done: Optional[Callable[[], None]] = None) -> None:
        shard = self.indices.shard(index, shard_id)
        from_seqno = shard.resync_from if shard.resync_from is not None \
            else shard.global_checkpoint + 1
        ops, complete = shard.engine.ops_history_snapshot(from_seqno)
        state = self.state()
        replicas = []
        if state is not None:
            replicas = [
                sr for sr in
                state.routing_table.index(index).shard_group(shard_id)
                if not sr.primary and sr.assigned
                and sr.node_id != self.node_id
                and sr.state in (ShardState.INITIALIZING,
                                 ShardState.STARTED, ShardState.RELOCATING)]
        if not complete:
            # promotion hole-fill noops make the above-checkpoint window
            # contiguous, so this means the history floor overtook the
            # window — replicas will converge through recovery instead
            self.stats["resync_failures"] += 1
            if on_done is not None:
                on_done()
            return
        if not replicas or not ops:
            self.stats["resyncs_noop"] += 1
            if on_done is not None:
                on_done()
            return
        self.stats["resyncs_started"] += 1
        self.stats["resync_targets"] += len(replicas)
        self.stats["resync_ops_sent"] += len(ops) * len(replicas)
        payload = {"index": index, "shard": shard_id, "ops": ops,
                   "global_checkpoint": shard.global_checkpoint,
                   "primary_term": shard.primary_term,
                   "retention_leases": [
                       lease.to_dict()
                       for lease in shard.tracker.leases()]}
        pending = {"n": len(replicas)}

        def one_done() -> None:
            pending["n"] -= 1
            if pending["n"] == 0:
                self.stats["resyncs_completed"] += 1
                if on_done is not None:
                    on_done()

        for replica in replicas:
            def on_ack(resp, err, sr: ShardRouting = replica) -> None:
                if err is None and shard.tracker is not None \
                        and sr.allocation_id:
                    try:
                        from elasticsearch_tpu_torch.index.seqno import (
                            peer_lease_id,
                        )
                        ckpt = resp.get("local_checkpoint", -1)
                        shard.tracker.init_tracking(
                            sr.allocation_id,
                            lease_id=peer_lease_id(sr.node_id),
                            retaining_seqno=ckpt + 1)
                        shard.tracker.mark_in_sync(sr.allocation_id, ckpt)
                    except ValueError as e:
                        err = e
                if err is not None:
                    # a copy that cannot converge on the new primacy must
                    # leave the in-sync set (the reference fails the shard
                    # from the resync proxy the same way)
                    self.stats["resync_failures"] += 1
                    self._fail_replica(sr, str(err), one_done)
                    return
                one_done()
            self.ts.send_request(replica.node_id, SHARD_RESYNC, payload,
                                 on_ack, timeout=30.0)

    def _fail_replica(self, sr: ShardRouting, reason: str,
                      done: Callable[[], None]) -> None:
        state = self.state()
        master = state.master_node_id if state is not None else None
        if master is None:
            done()
            return
        self.ts.send_request(master, SHARD_FAILED,
                             {"shard": sr.to_dict(),
                              "reason": f"resync failed: {reason}"},
                             lambda r, e: done(), timeout=30.0)

    def _on_resync_replica(self, req: Dict[str, Any],
                           sender: str) -> Dict[str, Any]:
        shard = self.indices.shard(req["index"], req["shard"])
        for op in req["ops"]:
            shard.apply_op_on_replica(
                op, req_primary_term=req["primary_term"],
                req_global_checkpoint=req["global_checkpoint"])
        shard.update_global_checkpoint_on_replica(req["global_checkpoint"])
        shard.learn_retention_leases(req.get("retention_leases"))
        self.stats["resync_ops_applied"] += len(req["ops"])
        return {"local_checkpoint": shard.local_checkpoint}


def _deep_merge(into: Dict[str, Any], other: Dict[str, Any]) -> None:
    for k, v in other.items():
        if isinstance(v, dict) and isinstance(into.get(k), dict):
            _deep_merge(into[k], v)
        else:
            into[k] = v
