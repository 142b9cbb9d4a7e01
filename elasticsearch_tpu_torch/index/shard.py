"""IndexShard: the per-shard facade over engine + replication tracking.

Reference analog: index/shard/IndexShard.java — the write entry points
``applyIndexOperationOnPrimary`` (:747) vs ``applyIndexOperationOnReplica``
(:756), primary-term checks, and the shard's ReplicationTracker ownership
(primary mode). Search goes through the shard's SearchService the way the
reference acquires searchers through the shard's engine.
"""

from __future__ import annotations

import uuid as uuid_mod
from typing import Any, Dict, List, Optional

from elasticsearch_tpu_torch.device import DeviceLike
from elasticsearch_tpu_torch.index.engine import EngineResult, InternalEngine
from elasticsearch_tpu_torch.index.seqno import ReplicationTracker
from elasticsearch_tpu_torch.index.store import Store
from elasticsearch_tpu_torch.index.translog import Translog
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.search.service import SearchService
from elasticsearch_tpu_torch.utils.errors import IllegalArgumentError


class ShardId:
    __slots__ = ("index", "shard")

    def __init__(self, index: str, shard: int) -> None:
        self.index = index
        self.shard = shard

    def __eq__(self, other: object) -> bool:
        return (isinstance(other, ShardId) and other.index == self.index
                and other.shard == self.shard)

    def __hash__(self) -> int:
        return hash((self.index, self.shard))

    def __repr__(self) -> str:
        return f"[{self.index}][{self.shard}]"


class IndexShard:
    """One shard copy living on one node.

    primary=True copies own a ReplicationTracker (primary mode,
    ReplicationTracker.java:80); replicas only track their local checkpoint
    and learn the global checkpoint from the primary's piggyback.
    """

    def __init__(self, shard_id: ShardId, mapper_service: MapperService,
                 primary: bool, primary_term: int = 1,
                 allocation_id: Optional[str] = None,
                 store: Optional[Store] = None,
                 translog: Optional[Translog] = None,
                 index_sort=None,
                 check_on_startup=False,
                 soft_deletes_retention_ops: int = 1024,
                 retention_lease_period_s: float = 12 * 3600,
                 node_id: Optional[str] = None,
                 device: DeviceLike = None):
        self.shard_id = shard_id
        self.primary = primary
        self.primary_term = primary_term
        self.allocation_id = allocation_id or uuid_mod.uuid4().hex
        # which node hosts this copy: keys the primary's OWN retention
        # lease (node-keyed like every peer lease, so a successor primary
        # that inherited the lease set can serve this node's return)
        self.node_id = node_id
        # the primary's lease set, learned via replication piggyback and
        # persisted in THIS copy's commits too — the seed a promotion
        # restores so history promised to departed copies stays promised
        self._replica_leases: List[Dict[str, Any]] = []
        # soft-deletes knobs (index.soft_deletes.retention.ops /
        # .retention_lease.period) — dynamic via update_retention_settings
        self.soft_deletes_retention_ops = soft_deletes_retention_ops
        self.retention_lease_period_s = retention_lease_period_s
        # how this copy's data came to be on this node ("existing_store",
        # "empty_store", "peer", "peer_reuse", "in_place") — set by the
        # reconciler; observable so tests/operators can assert a restart
        # recovered in place instead of paying an avoidable copy
        self.recovery_kind: Optional[str] = None
        self.engine = InternalEngine(
            mapper_service, store=store, translog=translog,
            primary_term=primary_term,
            shard_label=f"{shard_id.index}_{shard_id.shard}",
            index_sort=index_sort,
            check_on_startup=check_on_startup)
        self.engine.history_retention_ops = soft_deletes_retention_ops
        # every commit this copy writes records its identity, so a later
        # gateway fetch can match the on-disk data to routing
        self.engine.commit_extra["allocation_id"] = self.allocation_id
        self.search = SearchService(self.engine, index_name=shard_id.index,
                                    device=device)
        self.tracker: Optional[ReplicationTracker] = None
        if primary:
            self._enter_primary_mode()
        else:
            # replicas persist the LEARNED lease set: a promotion (or a
            # primary restarted over this copy's disk) restores it, so
            # the fleet's retention promises survive the failover
            self.engine.commit_leases_supplier = \
                lambda: list(self._replica_leases)
        self._global_checkpoint_replica = -1
        # [resync_from, max_seqno] at promotion — the ops the new primary
        # must re-replicate under its new term (PrimaryReplicaSyncer's
        # window); None until this copy is actually promoted
        self.resync_from: Optional[int] = None
        # EVERY copy persists its learned global checkpoint into commits:
        # after a failover, ops at/below a copy's own persisted gcp are
        # canonical history no new primary can have diverged from — the
        # cross-term recovery gate keys on this
        self.engine.global_checkpoint_supplier = \
            lambda: self.global_checkpoint
        # shard-level search stats (index/search/stats/SearchStats analog);
        # wand_* track the pruned collector's block-skipping effectiveness
        self.search_stats: Dict[str, int] = {
            "query_total": 0, "wand_queries": 0,
            "wand_blocks_total": 0, "wand_blocks_scored": 0,
            "request_cache_hits": 0, "request_cache_misses": 0}
        # refresh publishes into the packed device plane: an append-only
        # refresh re-packs any resident plane incrementally so the NEXT
        # query doesn't pay the upload (ops/device_segment.PlaneRegistry)
        self.engine.refresh_listeners.append(self._publish_plane)

    def _publish_plane(self) -> None:
        import sys
        if "elasticsearch_tpu_torch.ops.device_segment" not in sys.modules:
            return      # no device work yet in this process
        try:
            from elasticsearch_tpu_torch.ops.device_segment import (
                MESH_PLANES, PLANES,
            )
            PLANES.on_refresh(self.engine.segments)
            # mesh-sharded planes this shard participates in re-pack
            # incrementally too (the other member shards keep their
            # last-published segment sets)
            MESH_PLANES.on_refresh(
                (self.shard_id.index, self.shard_id.shard),
                self.engine.segments)
        except Exception:  # noqa: BLE001 — publication is an optimization
            pass

    def _enter_primary_mode(self) -> None:
        self.primary = True
        self.tracker = ReplicationTracker(
            self.allocation_id, self.engine.tracker,
            lease_retention_seconds=self.retention_lease_period_s,
            node_id=self.node_id)
        # primary mode owns history retention: the engine's prune floor
        # folds in the tracker's leases, and every commit persists them
        self.engine.retention_floor_supplier = self._retention_floor
        self.engine.commit_leases_supplier = lambda: [
            lease.to_dict() for lease in self.tracker.leases()]

    def _retention_floor(self) -> int:
        """Expire overdue leases, then return the minimum seqno any
        surviving lease still retains (Engine.getMinRetainedSeqNo)."""
        self.tracker.expire_leases()
        return self.tracker.min_retained_seqno()

    def update_retention_settings(self, retention_ops: Optional[int] = None,
                                  lease_period_s: Optional[float] = None
                                  ) -> None:
        """Apply a dynamic settings update to the live shard."""
        if retention_ops is not None:
            self.soft_deletes_retention_ops = int(retention_ops)
            self.engine.history_retention_ops = int(retention_ops)
        if lease_period_s is not None:
            self.retention_lease_period_s = float(lease_period_s)
            if self.tracker is not None:
                self.tracker._lease_retention = float(lease_period_s)

    def rebind_tracker(self) -> None:
        """Re-point the ReplicationTracker at the engine's (possibly
        replaced) local checkpoint tracker. ``recover_from_store`` swaps
        the engine's tracker for one seeded from the commit; without the
        rebind a store-recovered primary computes its global checkpoint
        from the abandoned pre-recovery tracker (stuck at -1 forever).
        Also the seam where commit-persisted retention leases come back:
        a restarted primary keeps honoring history it promised to
        departed copies before the restart."""
        if self.tracker is not None:
            self.tracker.local = self.engine.tracker
            persisted = self.engine.recovered_commit_extra.get(
                "retention_leases")
            if persisted:
                self.tracker.restore_leases(persisted)

    # ------------------------------------------------------------------
    # write path
    # ------------------------------------------------------------------

    def apply_index_on_primary(self, doc_id: str, source: Dict[str, Any],
                               **kw: Any) -> EngineResult:
        assert self.primary, f"{self.shard_id} is not a primary"
        return self.engine.index(doc_id, source, **kw)

    def apply_delete_on_primary(self, doc_id: str, **kw: Any) -> EngineResult:
        assert self.primary, f"{self.shard_id} is not a primary"
        return self.engine.delete(doc_id, **kw)

    def apply_op_on_replica(self, op: Dict[str, Any],
                            req_primary_term: Optional[int] = None,
                            req_global_checkpoint: Optional[int] = None
                            ) -> EngineResult:
        """Apply a primary-assigned operation. op is the replicated wire
        form: {op_type, doc_id, source?, routing?, seqno, version,
        primary_term}.

        The stale-primary fence compares the SENDING primary's term
        (``req_primary_term``, the request-level term of the reference's
        TransportReplicationAction), not the op's own term: peer recovery
        and the post-promotion resync legitimately replay history written
        under OLDER terms after a failover bumped the shard's term. Live
        replication passes no ``req_primary_term`` and falls back to the
        op term (for live ops the two are the same).

        A term BUMP is this copy's first contact with a new primacy: the
        request's global checkpoint is folded in first, then the engine
        rolls back to the global checkpoint — uncommitted ops from the
        deposed term are discarded in place (resetEngineToGlobalCheckpoint
        analog) and the new primary's resync/replication replays forward.
        A rollback the engine cannot prove safe raises, failing the
        shard, which routes it to the typed wipe-recovery path."""
        fence_term = req_primary_term if req_primary_term is not None \
            else op["primary_term"]
        if fence_term < self.primary_term:
            raise IllegalArgumentError(
                f"op primary term [{fence_term}] is below the shard's "
                f"[{self.primary_term}]")
        if fence_term > self.primary_term:
            if req_global_checkpoint is not None:
                self.update_global_checkpoint_on_replica(
                    req_global_checkpoint)
            self.engine.rollback_above(self._global_checkpoint_replica)
        self.primary_term = max(self.primary_term, fence_term)
        self.engine.primary_term = self.primary_term
        if op["op_type"] == "index":
            return self.engine.index(
                op["doc_id"], op["source"], routing=op.get("routing"),
                seqno=op["seqno"], version=op["version"],
                primary_term=op["primary_term"])
        if op["op_type"] == "delete":
            return self.engine.delete(
                op["doc_id"], seqno=op["seqno"], version=op["version"],
                primary_term=op["primary_term"])
        if op["op_type"] == "noop":
            self.engine.noop(op["seqno"], reason=op.get("reason") or "",
                             primary_term=op["primary_term"])
            return EngineResult(op.get("doc_id", ""), op["seqno"],
                                op["primary_term"], 0, "noop")
        raise IllegalArgumentError(f"unknown op_type [{op['op_type']}]")

    @staticmethod
    def replicated_op(result: EngineResult, op_type: str,
                      source: Optional[Dict[str, Any]] = None,
                      routing: Optional[str] = None) -> Dict[str, Any]:
        """Wire form of a completed primary op for replica fan-out."""
        op: Dict[str, Any] = {
            "op_type": op_type, "doc_id": result.doc_id,
            "seqno": result.seqno, "version": result.version,
            "primary_term": result.primary_term,
        }
        if op_type == "index":
            op["source"] = source
            op["routing"] = routing
        return op

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    @property
    def search_generation(self) -> int:
        """The engine's search generation stamp — THE freshness key both
        request-cache tiers use (the shard tier per entry, the
        coordinator tier as one component of a fan-out's generation
        vector). One attribute read; never walks segments."""
        return self.engine.search_generation

    @property
    def local_checkpoint(self) -> int:
        return self.engine.tracker.checkpoint

    @property
    def max_seqno(self) -> int:
        return self.engine.tracker.max_seqno

    @property
    def global_checkpoint(self) -> int:
        if self.tracker is not None:
            return self.tracker.global_checkpoint
        return self._global_checkpoint_replica

    def update_global_checkpoint_on_replica(self, checkpoint: int) -> None:
        if checkpoint > self._global_checkpoint_replica:
            self._global_checkpoint_replica = checkpoint

    def learn_retention_leases(self, leases) -> None:
        """Replica learns the primary's lease set (RetentionLeaseSync
        analog, piggybacked on replication): remembered in memory and
        persisted into this copy's commits, it is what a promotion
        restores so history promised to departed copies stays retained
        under the new primacy."""
        if leases:
            self._replica_leases = list(leases)

    # ------------------------------------------------------------------
    # failover
    # ------------------------------------------------------------------

    def promote_to_primary(self, new_primary_term: int,
                           in_sync_allocations=None) -> int:
        """Replica → primary on failover. Bumps the primary term, fills
        seqno holes with no-ops so the checkpoint can advance, and
        captures the resync window: every op above the global checkpoint
        this copy knew as a replica must be re-replicated to the other
        in-sync copies under the NEW term (PrimaryReplicaSyncer analog).
        Returns the first seqno of that window.

        ``in_sync_allocations`` (the routing table's in-sync set) seeds
        the fresh tracker: the other copies hold the global checkpoint
        down at the last replica-learned value until their resync acks
        report real checkpoints — a freshly promoted primary must not
        let its own checkpoint masquerade as the fleet's."""
        resync_from = self._global_checkpoint_replica + 1
        self.primary_term = new_primary_term
        self.engine.primary_term = new_primary_term
        self._enter_primary_mode()
        # inherit the deposed primary's lease set (learned live, or from
        # this copy's own commit after a restart): the deposed NODE's own
        # node-keyed lease is in there, so its return stays ops-based
        inherited = self._replica_leases or \
            self.engine.recovered_commit_extra.get("retention_leases")
        if inherited:
            self.tracker.restore_leases(inherited)
        self.tracker.activate_promoted(
            self._global_checkpoint_replica,
            [a for a in (in_sync_allocations or [])
             if a != self.allocation_id])
        tracker = self.engine.tracker
        for seqno in range(tracker.checkpoint + 1, tracker.max_seqno + 1):
            self.engine.noop(seqno, reason="primary promotion hole fill")
        self.resync_from = resync_from
        return resync_from

    # ------------------------------------------------------------------
    # failure handling
    # ------------------------------------------------------------------

    def add_failure_listener(self, listener) -> None:
        """Register ``fn(reason, exc)`` fired once if the engine hits a
        tragic storage event (corruption, EIO) — the reconciler uses this
        to report shard-failed to the master (IndexShard failure callback
        analog)."""
        self.engine.failure_listeners.append(listener)

    @property
    def failed(self) -> bool:
        return self.engine.failed

    # ------------------------------------------------------------------

    def doc_stats(self) -> Dict[str, Any]:
        stats = self.engine.stats()
        stats.update({
            "shard": repr(self.shard_id),
            "primary": self.primary,
            "primary_term": self.primary_term,
            "allocation_id": self.allocation_id,
            "global_checkpoint": self.global_checkpoint,
        })
        return stats

    def close(self) -> None:
        self.engine.close()
