"""The reconciler: diff committed cluster state against local shards.

Reference analog: indices/cluster/IndicesClusterStateService.java:210
(applyClusterState) — on every committed state, each node creates shards
newly routed to it, removes shards routed away or deleted, starts peer
recoveries for initializing replicas, and reports shard-started /
shard-failed back to the master (ShardStateAction analog). Peer recovery
follows indices/recovery/RecoverySourceHandler.java:144's shape collapsed
to one round-trip: snapshot of live ops (phase1+phase2 merged — segments
here are already op-shaped), then mark-in-sync on the source.
"""

from __future__ import annotations

import json
import logging
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from elasticsearch_tpu_torch.cluster.routing import ShardRouting, ShardState
from elasticsearch_tpu_torch.cluster.state import ClusterState
from elasticsearch_tpu_torch.index.engine import RollbackInfeasibleError
from elasticsearch_tpu_torch.index.seqno import peer_lease_id
from elasticsearch_tpu_torch.indices.indices_service import IndicesService
from elasticsearch_tpu_torch.transport.transport import TransportService
from elasticsearch_tpu_torch.utils.errors import ShardCorruptedError

logger = logging.getLogger(__name__)

SHARD_STARTED = "cluster/shard_started"
SHARD_FAILED = "cluster/shard_failed"
RECOVERY_START = "indices/recovery/start"

# why an ops-based catch-up was refused and the copy paid the file path
# (typed; anything else lands in "unknown", which tests pin at zero)
FILE_FALLBACK_REASONS = (
    "stale_commit",             # local commit had seqno holes / no data
    "term_mismatch",            # commit written under a different primacy
    "beyond_global_checkpoint",  # local history includes unacked ops
    "lease_expired",            # no retention lease for the node anymore
    "lease_not_covering",       # lease exists but starts past lcp+1
    "history_pruned",           # lease held, but the history has a hole
    "rollback_infeasible",      # cross-term tail could not be unwound
)


def new_recovery_stats() -> Dict[str, Any]:
    return {
        "kinds": {},             # recovery_kind -> count
        "ops_replayed": 0,       # ops applied by ops-based catch-ups
        "bytes_copied": 0,       # wire payload actually shipped
        "bytes_avoided": 0,      # full-snapshot bytes NOT shipped
        "file_fallback_reasons": {"unknown": 0},
        # failover machinery: post-promotion primary->replica resyncs and
        # cross-term engine rollbacks (PrimaryReplicaSyncer analog)
        "resync": {"resyncs_started": 0, "resyncs_completed": 0,
                   "resyncs_noop": 0, "resync_failures": 0,
                   "resync_targets": 0, "resync_ops_sent": 0,
                   "resync_ops_applied": 0},
        "rollbacks": 0,
        "ops_rolled_back": 0,
    }


def merge_recovery_sections(sections: List[Dict[str, Any]]
                            ) -> Dict[str, Any]:
    """Fleet-wide merge of per-node "recovery" stats sections
    (_cluster/stats fan-out)."""
    out = new_recovery_stats()
    out.update(active_leases=0, leases_expired_total=0,
               history_retained_ops=0, leases_released_node_left=0)
    for sec in sections:
        if not isinstance(sec, dict):
            continue
        for kind, n in (sec.get("kinds") or {}).items():
            out["kinds"][kind] = out["kinds"].get(kind, 0) + int(n)
        for reason, n in (sec.get("file_fallback_reasons") or {}).items():
            out["file_fallback_reasons"][reason] = \
                out["file_fallback_reasons"].get(reason, 0) + int(n)
        for key, n in (sec.get("resync") or {}).items():
            out["resync"][key] = out["resync"].get(key, 0) + int(n)
        for key in ("ops_replayed", "bytes_copied", "bytes_avoided",
                    "active_leases", "leases_expired_total",
                    "history_retained_ops", "leases_released_node_left",
                    "rollbacks", "ops_rolled_back"):
            out[key] = out.get(key, 0) + int(sec.get(key, 0) or 0)
    return out


class IndicesClusterStateService:
    def __init__(self, node_id: str, indices_service: IndicesService,
                 transport_service: TransportService):
        self.node_id = node_id
        self.indices = indices_service
        self.ts = transport_service
        self.last_applied: Optional[ClusterState] = None
        # shards this node is currently recovering (avoid double-starting)
        self._recovering: set = set()
        # allocation ids with an in-flight shard-failed retry loop (the
        # re-assert-on-every-state path must not stack duplicate loops)
        self._failing: set = set()
        # every completed recovery on this node, by kind, plus a bounded
        # per-recovery log for _cat/recovery (RecoveryState analog)
        self.recovery_stats = new_recovery_stats()
        self._recovery_log: deque = deque(maxlen=128)
        self.ts.register_handler(RECOVERY_START, self._on_recovery_start)
        # post-promotion primary–replica resync (PrimaryReplicaSyncer):
        # late import — action/replication imports SHARD_FAILED from here
        from elasticsearch_tpu_torch.action.replication import (
            PrimaryReplicaSyncer,
        )
        self.resyncer = PrimaryReplicaSyncer(
            node_id, indices_service, transport_service,
            lambda: self.last_applied)

    def _record_recovery(self, sr: ShardRouting, kind: str,
                         ops_replayed: int = 0, bytes_copied: int = 0,
                         bytes_avoided: int = 0,
                         file_reason: Optional[str] = None,
                         source_node: Optional[str] = None) -> None:
        stats = self.recovery_stats
        stats["kinds"][kind] = stats["kinds"].get(kind, 0) + 1
        stats["ops_replayed"] += ops_replayed
        stats["bytes_copied"] += bytes_copied
        stats["bytes_avoided"] += bytes_avoided
        if file_reason is not None:
            reason = file_reason if file_reason in FILE_FALLBACK_REASONS \
                else "unknown"
            stats["file_fallback_reasons"][reason] = \
                stats["file_fallback_reasons"].get(reason, 0) + 1
        self._recovery_log.append({
            "index": sr.index, "shard": sr.shard_id, "kind": kind,
            "primary": sr.primary, "node": self.node_id,
            "source_node": source_node, "ops_replayed": ops_replayed,
            "bytes_copied": bytes_copied, "bytes_avoided": bytes_avoided,
            "file_reason": file_reason})

    def recovery_log(self) -> List[Dict[str, Any]]:
        return list(self._recovery_log)

    # ------------------------------------------------------------------
    # apply
    # ------------------------------------------------------------------

    def apply_cluster_state(self, state: ClusterState) -> None:
        self.last_applied = state
        self._remove_stale_local_shards(state)
        self._update_index_metadata(state)
        self._create_or_recover_shards(state)
        self._release_departed_node_leases(state)

    def _release_departed_node_leases(self, state: ClusterState) -> None:
        """Early-expire `peer_recovery/<node>` leases for nodes that left
        the cluster AND whose copy was reallocated: once every copy of the
        group is active on live nodes, nothing is waiting for the departed
        disk to return, so pinning history for it only bloats retention.
        A lease for a node still in the cluster — or one whose group still
        has an unassigned/initializing copy that may come back to it —
        keeps aging out on the normal clock instead."""
        live = set(state.nodes)
        for shard in self.indices.all_shards():
            if not shard.primary or shard.tracker is None:
                continue
            try:
                irt = state.routing_table.index(shard.shard_id.index)
                group = irt.shard_group(shard.shard_id.shard)
            except Exception:  # noqa: BLE001 — routing gone; normal expiry
                continue
            if not all(r.active and r.node_id in live for r in group):
                continue   # a copy may still return to the departed node
            for lease in shard.tracker.leases():
                if not lease.id.startswith("peer_recovery/"):
                    continue
                node = lease.id.split("/", 1)[1]
                if node not in live:
                    shard.tracker.release_node_lease(node)

    def _remove_stale_local_shards(self, state: ClusterState) -> None:
        for index_name in list(self.indices.indices):
            if not state.metadata.has_index(index_name):
                # index deleted cluster-wide: drop data too
                self.indices.remove_index(index_name, delete_data=True)
                continue
            service = self.indices.indices[index_name]
            if not state.routing_table.has_index(index_name):
                continue
            irt = state.routing_table.index(index_name)
            for sid in list(service.shards):
                local = service.shards[sid]
                routed_here = [
                    sr for sr in irt.shard_group(sid)
                    if sr.node_id == self.node_id and
                    sr.allocation_id == local.allocation_id]
                if not routed_here:
                    service.remove_shard(sid)
                    self._recovering.discard((index_name, sid))

    def _update_index_metadata(self, state: ClusterState) -> None:
        # per-index isolation, like the reference reconciler: one index's
        # bad metadata must not abort the apply pass for every other index
        # (IndicesClusterStateService catches per-index and fails shards)
        for index_name, service in list(self.indices.indices.items()):
            if not state.metadata.has_index(index_name):
                continue
            meta = state.metadata.index(index_name)
            try:
                service.update_metadata(meta)
            except Exception as e:  # noqa: BLE001 — isolate the index
                # A node whose mapper diverged from committed metadata must
                # not keep serving the shards: fail this node's copies
                # LOUDLY and drop the poisoned IndexService entirely, so a
                # reassignment back to this node rebuilds a fresh
                # MapperService from the committed metadata instead of
                # silently reusing the diverged one.
                logger.error(
                    "[%s] failed to apply mapping update on [%s]: %s",
                    self.node_id, index_name, e)
                for sr in state.routing_table.shards_on_node(self.node_id):
                    if sr.index == index_name and \
                            sr.node_id == self.node_id and \
                            self.indices.has_shard(sr.index, sr.shard_id):
                        self._shard_failed(
                            sr, f"mapping update failed to apply: {e}")
                self.indices.remove_index(index_name, delete_data=False)

    def _create_or_recover_shards(self, state: ClusterState) -> None:
        for sr in state.routing_table.shards_on_node(self.node_id):
            if sr.node_id != self.node_id:
                continue   # relocation target handled via its own routing
            key = (sr.index, sr.shard_id)
            try:
                local_exists = self.indices.has_shard(sr.index, sr.shard_id)
                if sr.state == ShardState.INITIALIZING and not local_exists \
                        and key not in self._recovering:
                    self._recovering.add(key)
                    self._start_recovery(state, sr)
                elif sr.state == ShardState.STARTED and local_exists:
                    shard = self.indices.shard(sr.index, sr.shard_id)
                    term = state.metadata.index(sr.index).primary_term(
                        sr.shard_id)
                    if sr.primary and not shard.primary:
                        # replica promoted on failover: seed the tracker
                        # with every other ACTIVE copy so the global
                        # checkpoint stays pinned until resync acks prove
                        # where each one actually is, then re-replicate
                        # the above-checkpoint tail under the new term
                        irt = state.routing_table.index(sr.index)
                        in_sync = [
                            r.allocation_id
                            for r in irt.shard_group(sr.shard_id)
                            if r.active and r.allocation_id is not None]
                        shard.promote_to_primary(
                            term, in_sync_allocations=in_sync)
                        self.resyncer.resync(sr.index, sr.shard_id)
                elif sr.state == ShardState.STARTED and not local_exists:
                    # routing says this node serves the copy but it is
                    # gone locally — a tragic-event removal whose
                    # shard-failed report was lost mid-election, or an
                    # in-place process restart. A restarted PRIMARY whose
                    # disk still holds a committed store recovers IN
                    # PLACE: failing it would hand a possibly-sole copy
                    # to the balance-only allocator, which has no
                    # existing-copy awareness and could start an empty
                    # primary on another node (green-but-empty data
                    # loss). A corruption-marked store refuses to reopen
                    # inside recover_from_store and falls through to the
                    # failure report. Everything else re-asserts
                    # shard-failed on EVERY state application until the
                    # master reroutes — a lost report must not leave
                    # routing diverged forever.
                    if sr.primary and key not in self._recovering and \
                            sr.allocation_id not in self._failing and \
                            self.indices.has_on_disk_data(
                                state.metadata.index(sr.index),
                                sr.shard_id):
                        self._recovering.add(key)
                        self._recover_started_primary_in_place(state, sr)
                    else:
                        self._shard_failed(
                            sr, "shard copy missing locally "
                                "(failed or restarted; re-reporting)")
            except Exception as e:  # noqa: BLE001 — fail just this shard
                self._shard_failed(sr, f"shard apply failed: {e}")

    # ------------------------------------------------------------------
    # recovery
    # ------------------------------------------------------------------

    def _start_recovery(self, state: ClusterState, sr: ShardRouting,
                        allow_reuse: bool = True,
                        forced_file_reason: Optional[str] = None) -> None:
        metadata = state.metadata.index(sr.index)
        service = self.indices.create_index(metadata)
        term = metadata.primary_term(sr.shard_id)

        if sr.primary:
            # primary: recover from the local store (gateway allocation path)
            had_data = self.indices.has_on_disk_data(metadata, sr.shard_id)
            shard = service.create_shard(sr.shard_id, primary=True,
                                         primary_term=term,
                                         allocation_id=sr.allocation_id)
            try:
                if shard.engine.store is not None:
                    shard.engine.recover_from_store()
                    shard.rebind_tracker()
            except Exception as e:  # noqa: BLE001 — reported to master
                # drop the half-opened copy so a later reassignment to
                # this node starts clean instead of colliding with it
                service.remove_shard(sr.shard_id)
                self._shard_failed(sr, f"store recovery failed: {e}")
                return
            shard.recovery_kind = "existing_store" if had_data \
                else "empty_store"
            self._record_recovery(sr, shard.recovery_kind)
            self._watch_engine(service, shard, sr)
            self._shard_started(sr)
            return

        # replica: peer recovery from the active primary's node
        irt = state.routing_table.index(sr.index)
        primary = irt.primary(sr.shard_id)
        if not primary.active or primary.node_id is None:
            self._recovering.discard((sr.index, sr.shard_id))
            return   # retried on a later state where the primary is active

        # local-reuse probe (ReplicaShardAllocator's file-reuse analog,
        # collapsed to the safe ops-shaped gate): a fresh, non-corrupted
        # local commit with no seqno holes is reopened NOW — the shard
        # must exist before the recovery round-trip, or live replication
        # fan-out (which already targets this INITIALIZING copy) would
        # hit a missing shard for a full RTT — and the primary then
        # confirms whether the reopened history may be kept (the source
        # decides; a refusal wipes and pays the full copy)
        local_commit = None
        shard = None
        if allow_reuse:
            local = self.indices.local_shard_state(metadata.uuid,
                                                   sr.shard_id)
            if local and local.get("has_data") and local.get("verified") \
                    and not local.get("corrupted") and \
                    local.get("max_seqno", -1) >= 0:
                try:
                    shard = service.create_shard(
                        sr.shard_id, primary=False, primary_term=term,
                        allocation_id=sr.allocation_id, fresh_store=False)
                    shard.engine.recover_from_store()
                    tracker = shard.engine.tracker
                    if tracker.checkpoint != tracker.max_seqno:
                        # seqno holes survived commit + translog replay:
                        # the local history is not contiguous — the ops
                        # path can't extend it, so don't offer it
                        raise ValueError(
                            "recovered local copy has seqno holes")
                    # report the RECOVERED engine's watermarks (commit
                    # plus replayed translog tail) and let the SOURCE
                    # decide: identical → reuse as-is; behind but lease-
                    # covered → ops-based catch-up from checkpoint+1;
                    # anything else → wipe and file-copy. Acked ops in
                    # the replayed tail are exactly what ops-based
                    # catch-up preserves; UNacked ones are fenced by the
                    # source's global-checkpoint and term gates, which
                    # force the wipe instead of resurrecting them.
                    # the copy's own persisted global checkpoint rides
                    # along: cross-term commits whose history fits at or
                    # under it are still reconcilable by rollback+replay
                    pgcp = int((shard.engine.recovered_commit_extra or {})
                               .get("global_checkpoint", -1))
                    shard.update_global_checkpoint_on_replica(pgcp)
                    local_commit = {
                        "max_seqno": tracker.max_seqno,
                        "local_checkpoint": tracker.checkpoint,
                        "primary_term": local.get("primary_term", -1),
                        "global_checkpoint": pgcp}
                except Exception as e:  # noqa: BLE001 — fall back fresh
                    logger.warning(
                        "[%s] local reuse probe of [%s][%s] failed (%s); "
                        "using full peer recovery",
                        self.node_id, sr.index, sr.shard_id, e)
                    service.remove_shard(sr.shard_id)
                    shard = None
        if shard is None:
            # fresh_store: this copy is rebuilt from the primary's ops,
            # so any leftover on-disk state (incl. corruption markers
            # from a failed previous copy on this node) is wiped first
            shard = service.create_shard(
                sr.shard_id, primary=False, primary_term=term,
                allocation_id=sr.allocation_id, fresh_store=True)

        def on_response(resp: Optional[Dict[str, Any]],
                        err: Optional[Exception]) -> None:
            nonlocal shard
            if err is not None or resp is None:
                service.remove_shard(sr.shard_id)
                self._recovering.discard((sr.index, sr.shard_id))
                self._shard_failed(sr, f"peer recovery failed: {err}")
                return
            mode = resp.get("mode") or \
                ("reuse" if resp.get("reuse") else "file")
            if local_commit is None:
                mode = "file"   # nothing local to reuse or catch up
            reuse = mode == "reuse"
            ops_based = mode == "ops"
            try:
                if mode == "file" and local_commit is not None:
                    # the source refused the reopened history (typed
                    # reason in the response): wipe it and copy in full
                    service.remove_shard(sr.shard_id)
                    shard = service.create_shard(
                        sr.shard_id, primary=False, primary_term=term,
                        allocation_id=sr.allocation_id, fresh_store=True)
                if ops_based and resp.get("rollback_to") is not None:
                    # cross-term reconciliation: the source vouched only
                    # for history at/under rollback_to — unwind this
                    # copy's possibly-divergent tail first, then the
                    # replay below extends pure canonical history
                    try:
                        shard.engine.rollback_above(
                            int(resp["rollback_to"]))
                    except RollbackInfeasibleError as e:
                        # typed refusal: the tail cannot be PROVEN
                        # unwindable (history pruned past it and the
                        # segment copy merged away) — wipe and pay the
                        # full copy rather than serve a maybe-divergent
                        # doc, keeping "unknown" pinned at zero
                        logger.warning(
                            "[%s] cross-term rollback of [%s][%s] "
                            "infeasible (%s); wiping for full copy",
                            self.node_id, sr.index, sr.shard_id, e)
                        service.remove_shard(sr.shard_id)
                        self._start_recovery(
                            self.last_applied or state, sr,
                            allow_reuse=False,
                            forced_file_reason="rollback_infeasible")
                        return
                for op in resp["ops"]:
                    # historical ops keep their original terms; the fence
                    # term is the recovery source's CURRENT primary term.
                    # In ops mode this replays ONLY the missed tail —
                    # including delete tombstones and noops — on top of
                    # the reopened store: no wipe, no segment copy.
                    shard.apply_op_on_replica(
                        op, req_primary_term=resp.get("primary_term"))
                # fill seqno holes (overwritten/deleted history not shipped)
                for seqno in range(shard.engine.tracker.checkpoint + 1,
                                   resp["max_seqno"] + 1):
                    shard.engine.noop(seqno, reason="recovery hole fill")
                shard.update_global_checkpoint_on_replica(
                    resp["global_checkpoint"])
                shard.learn_retention_leases(resp.get("retention_leases"))
                shard.engine.refresh()
            except Exception as e:  # noqa: BLE001 — reported to master
                service.remove_shard(sr.shard_id)
                self._recovering.discard((sr.index, sr.shard_id))
                self._shard_failed(sr, f"recovery apply failed: {e}")
                return
            shard.recovery_kind = "peer_reuse" if reuse else (
                "ops_based" if ops_based else "peer")
            self._record_recovery(
                sr, shard.recovery_kind,
                ops_replayed=len(resp["ops"]) if ops_based else 0,
                bytes_copied=int(resp.get("bytes_copied", 0) or 0),
                bytes_avoided=int(resp.get("bytes_avoided", 0) or 0),
                # a typed reason is only meaningful when a local copy
                # EXISTED and was refused — a fresh copy isn't a
                # fallback, EXCEPT when this recovery is itself the wipe
                # restart of a refused rollback (the forced reason)
                file_reason=(resp.get("file_reason") or "unknown")
                if mode == "file" and local_commit is not None
                else (forced_file_reason if mode == "file" else None),
                source_node=resp.get("source_node"))
            self._watch_engine(service, shard, sr)
            self._shard_started(sr)

        # the start request retries with jittered-exponential backoff
        # through transient source-side failures (primary node briefly
        # unreachable / partitioned) before the copy is failed to the
        # master — RecoveryTarget's RetryableAction-driven retryRecovery
        def attempt(cb) -> None:
            from elasticsearch_tpu_torch.transport.transport import (
                NodeNotConnectedError,
            )
            state_now = self.last_applied
            source = primary.node_id
            if state_now is not None:
                try:
                    sr_now = state_now.routing_table.index(
                        sr.index).primary(sr.shard_id)
                    if sr_now.active and sr_now.node_id is not None:
                        source = sr_now.node_id   # primary moved: follow it
                except Exception:  # noqa: BLE001 — keep the last source
                    pass
            if source is None:
                cb(None, NodeNotConnectedError(
                    f"no active primary for [{sr.index}][{sr.shard_id}]"))
                return
            request = {"index": sr.index, "shard": sr.shard_id,
                       "allocation_id": sr.allocation_id}
            if local_commit is not None:
                request["local_commit"] = local_commit
            self.ts.send_request(source, RECOVERY_START, request, cb,
                                 timeout=60.0)

        from elasticsearch_tpu_torch.utils.retry import (
            RetryableAction, transient_cluster_error,
        )

        def retryable(err) -> bool:
            # the start request is idempotent on the source (snapshot +
            # mark-in-sync), so lost requests AND lost replies both retry
            return transient_cluster_error(err, retry_timeouts=True)

        RetryableAction(
            self.ts.transport.scheduler, attempt, on_response,
            initial_delay=0.5, max_delay=10.0, timeout=120.0,
            is_retryable=retryable).run()

    def _recover_started_primary_in_place(self, state: ClusterState,
                                          sr: ShardRouting) -> None:
        """Re-open a STARTED-routed primary from this node's own store
        after a process restart. No routing change is needed (the master
        already routes the copy here); success just restores service,
        failure (incl. a corruption marker) reports shard-failed like any
        other store-recovery failure."""
        metadata = state.metadata.index(sr.index)
        service = self.indices.create_index(metadata)
        term = metadata.primary_term(sr.shard_id)
        shard = service.create_shard(sr.shard_id, primary=True,
                                     primary_term=term,
                                     allocation_id=sr.allocation_id)
        try:
            if shard.engine.store is not None:
                shard.engine.recover_from_store()
                shard.rebind_tracker()
        except Exception as e:  # noqa: BLE001 — reported to master
            service.remove_shard(sr.shard_id)
            self._shard_failed(sr, f"in-place store recovery failed: {e}")
            return
        shard.recovery_kind = "in_place"
        self._record_recovery(sr, "in_place")
        self._watch_engine(service, shard, sr)
        self._recovering.discard((sr.index, sr.shard_id))
        # the master may be verifying this STARTED copy (gateway
        # reconcile after our reboot): a started report is the fast-path
        # proof the copy is live again — the verify poll is the fallback
        self._shard_started(sr)

    def _watch_engine(self, service, shard, sr: ShardRouting) -> None:
        """Turn a later tragic engine event (corruption, EIO at flush)
        into a routing event: drop the local copy and report shard-failed
        so the master promotes a clean replica and re-replicates."""
        def on_engine_failure(reason: str, exc: Exception,
                              sr=sr, service=service) -> None:
            try:
                service.remove_shard(sr.shard_id)
            except Exception:  # noqa: BLE001 — removal is best-effort
                logger.exception("failed to remove failed shard %s", sr)
            self._shard_failed(
                sr, f"engine failed, reason [{reason}]: {exc}")
        shard.add_failure_listener(on_engine_failure)

    def _on_recovery_start(self, req: Dict[str, Any], sender: str
                           ) -> Dict[str, Any]:
        """Primary side: snapshot live ops + register the recovering copy.

        Runs atomically within one handler dispatch, so the snapshot and
        in-sync registration can't interleave with a concurrent write; ops
        after this point reach the new copy through normal replica fan-out
        (the retention-lease ops-based path of RecoverySourceHandler)."""
        shard = self.indices.shard(req["index"], req["shard"])
        assert shard.primary and shard.tracker is not None
        # a corruption-marked (or failed) store must never be a recovery
        # source: replicas built from it would replicate the damage
        if shard.engine.failed:
            raise ShardCorruptedError(
                f"recovery source [{req['index']}][{req['shard']}] has a "
                f"failed engine: {shard.engine.failure_reason}")
        if shard.engine.store is not None:
            shard.engine.store.ensure_not_corrupted()
        ops, max_seqno = shard.engine.snapshot_ops()
        # mode decision (RecoverySourceHandler's shape): the target's
        # recovered local copy may be kept as-is ("reuse"), caught up by
        # replaying only its missed ops ("ops"), or must be wiped and
        # copied in full ("file", with a typed reason). Shared safety
        # gates for keeping ANY local history: hole-free (checkpoint ==
        # max), inside the global checkpoint (ops <= it are identical on
        # every in-sync copy, so no divergent or missing-delete history
        # can hide in the reused files), AND written under this
        # primary's CURRENT term: equal seqno watermarks across
        # different terms can name different ops (a dead primary's
        # unreplicated write vs its successor's), and only the term
        # identifies whose history the commit holds.
        mode = "file"
        file_reason: Optional[str] = None
        send_ops = ops
        rollback_to: Optional[int] = None
        local_commit = req.get("local_commit") or None

        def ops_if_covered(replay_from: int,
                           check_covering: bool = True) -> None:
            # ops-based catch-up: only when this NODE's retention lease
            # still covers everything the target must replay AND the
            # soft-delete history actually has it (the lease is the
            # promise; the history is the proof). A rollback-directed
            # catch-up skips the covering check: a deposed primary's own
            # lease retains from ITS high checkpoint, above the bound it
            # is told to roll back to — there the history completeness
            # check below is the entire (and sufficient) proof.
            nonlocal mode, file_reason, send_ops
            shard.tracker.expire_leases()
            lease = shard.tracker.get_lease(peer_lease_id(sender))
            if lease is None:
                file_reason = "lease_expired"
            elif check_covering and lease.retaining_seqno > replay_from:
                file_reason = "lease_not_covering"
            else:
                hist_ops, complete = \
                    shard.engine.ops_history_snapshot(replay_from)
                if not complete:
                    file_reason = "history_pruned"
                else:
                    mode = "ops"
                    send_ops = hist_ops

        if local_commit is not None:
            lcp = int(local_commit.get("local_checkpoint", -1))
            lmax = int(local_commit.get("max_seqno", -1))
            lterm = int(local_commit.get("primary_term", -1))
            if not (lcp == lmax >= 0):
                file_reason = "stale_commit"
            elif lterm == shard.primary_term:
                # same-primacy commit: the original three-way decision
                if lmax > shard.global_checkpoint:
                    file_reason = "beyond_global_checkpoint"
                elif lmax == max_seqno:
                    mode = "reuse"
                    send_ops = []
                else:
                    ops_if_covered(lmax + 1)
            else:
                # CROSS-TERM commit. The target's own persisted global
                # checkpoint bounds its canonical prefix: every op it
                # holds at/under that gcp was in-sync-everywhere when it
                # learned the value, so no primacy since can have
                # rewritten those seqnos. Ops ABOVE it may be a deposed
                # primary's unacked tail — reconcilable by directing the
                # target to roll back to the bound and replaying forward
                # from retained history. Only a commit with NO persisted
                # gcp is genuinely unverifiable cross-term.
                pgcp = int(local_commit.get("global_checkpoint", -1))
                # defensive floor: never trust a persisted gcp past what
                # this primary itself knows to be globally acked
                canon = min(pgcp, shard.global_checkpoint)
                if pgcp < 0:
                    file_reason = "term_mismatch"
                elif lmax <= canon:
                    # fully canonical cross-term history: as good as a
                    # same-term commit — reuse or plain ops catch-up
                    if lmax == max_seqno:
                        mode = "reuse"
                        send_ops = []
                    else:
                        ops_if_covered(lmax + 1)
                else:
                    # divergent-possible tail above the canonical bound:
                    # rollback+replay from there, lease permitting
                    rollback_to = min(lmax, canon)
                    ops_if_covered(rollback_to + 1, check_covering=False)
                    if mode != "ops":
                        rollback_to = None
        # payload accounting: what actually ships vs the full snapshot
        # the file path would have shipped (the cost ops-based avoids)
        bytes_full = len(json.dumps(ops))
        bytes_sent = bytes_full if mode == "file" \
            else len(json.dumps(send_ops))
        # the new copy gets a NODE-keyed retention lease immediately
        # (createMissingPeerRecoveryRetentionLeases analog), renewed from
        # here on by its checkpoint advances riding replication acks —
        # so its NEXT restart within the retention window is ops-based
        if mode == "reuse":
            retaining = lmax + 1
        elif mode == "ops":
            # with a rollback directive the copy's guaranteed floor is
            # the rollback bound, not its (about-to-be-unwound) lmax
            retaining = (rollback_to if rollback_to is not None
                         else lmax) + 1
        else:
            retaining = max_seqno + 1
        shard.tracker.init_tracking(
            req["allocation_id"], lease_id=peer_lease_id(sender),
            retaining_seqno=retaining)
        shard.tracker.mark_in_sync(req["allocation_id"], max_seqno)
        return {"mode": mode, "ops": send_ops, "max_seqno": max_seqno,
                "reuse": mode == "reuse",
                "rollback_to": rollback_to,
                "file_reason": file_reason,
                "bytes_copied": bytes_sent,
                "bytes_avoided": max(0, bytes_full - bytes_sent),
                "source_node": self.node_id,
                "global_checkpoint": shard.global_checkpoint,
                "primary_term": shard.primary_term,
                "retention_leases": [
                    lease.to_dict() for lease in shard.tracker.leases()]}

    # ------------------------------------------------------------------
    # master notifications
    # ------------------------------------------------------------------

    def _master_id(self) -> Optional[str]:
        state = self.last_applied
        return state.master_node_id if state is not None else None

    def _shard_started(self, sr: ShardRouting) -> None:
        self._recovering.discard((sr.index, sr.shard_id))
        master = self._master_id()
        if master is None:
            return
        self.ts.send_request(master, SHARD_STARTED,
                             {"shard": sr.to_dict()},
                             lambda r, e: None, timeout=30.0)

    def _shard_failed(self, sr: ShardRouting, reason: str) -> None:
        """Report a failed copy to the master. Reliable: retried with
        jittered backoff through no-master windows and dropped messages
        (SHARD_FAILED is idempotent on the master — apply_failed_shard
        matches by allocation_id, so a duplicate is a no-op), because a
        lost report would leave the master routing a STARTED shard this
        node no longer has (ShardStateAction's own retry discipline)."""
        self._recovering.discard((sr.index, sr.shard_id))
        if sr.allocation_id is not None:
            if sr.allocation_id in self._failing:
                return   # a retry loop for this copy is already running
            self._failing.add(sr.allocation_id)

        def attempt(cb) -> None:
            master = self._master_id()
            if master is None:
                from elasticsearch_tpu_torch.utils.errors import NotMasterError
                cb(None, NotMasterError("no master known to report "
                                        "shard failure to"))
                return
            self.ts.send_request(master, SHARD_FAILED,
                                 {"shard": sr.to_dict(), "reason": reason},
                                 cb, timeout=30.0)

        def retryable(err) -> bool:
            from elasticsearch_tpu_torch.utils.retry import (
                transient_cluster_error,
            )
            # timeouts ARE retryable here: the report is idempotent
            return transient_cluster_error(err, retry_timeouts=True)

        def finished(_r, _e) -> None:
            self._failing.discard(sr.allocation_id)

        from elasticsearch_tpu_torch.utils.retry import RetryableAction
        RetryableAction(
            self.ts.transport.scheduler, attempt, finished,
            initial_delay=0.5, max_delay=10.0, timeout=120.0,
            is_retryable=retryable).run()
