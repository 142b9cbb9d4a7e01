"""Sequence numbers, checkpoints, retention leases.

Reference analogs:
- LocalCheckpointTracker (index/seqno/LocalCheckpointTracker.java:31): issues
  seqnos on the primary and tracks the highest contiguous persisted seqno
  (the local checkpoint) on every copy.
- ReplicationTracker (index/seqno/ReplicationTracker.java:80): primary-side
  knowledge of every in-sync copy's local checkpoint; the global checkpoint is
  the minimum across the in-sync set; retention leases
  (ReplicationTracker.java:511) keep translog history for cheap ops-based
  re-sync of temporarily departed replicas.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

NO_OPS_PERFORMED = -1
UNASSIGNED_SEQ_NO = -2


class LocalCheckpointTracker:
    """Tracks processed seqnos; checkpoint = highest n with all of [0..n] processed."""

    def __init__(self, max_seqno: int = NO_OPS_PERFORMED,
                 local_checkpoint: int = NO_OPS_PERFORMED):
        self._max_seqno = max_seqno
        self._checkpoint = local_checkpoint
        self._pending: Set[int] = set()  # processed seqnos above the checkpoint

    def generate_seqno(self) -> int:
        self._max_seqno += 1
        return self._max_seqno

    def advance_max_seqno(self, seqno: int) -> None:
        """A replica observed a primary-assigned seqno."""
        if seqno > self._max_seqno:
            self._max_seqno = seqno

    def mark_processed(self, seqno: int) -> None:
        if seqno <= self._checkpoint:
            return
        self.advance_max_seqno(seqno)
        self._pending.add(seqno)
        while (self._checkpoint + 1) in self._pending:
            self._checkpoint += 1
            self._pending.discard(self._checkpoint)

    @property
    def checkpoint(self) -> int:
        return self._checkpoint

    @property
    def max_seqno(self) -> int:
        return self._max_seqno

    def pending_count(self) -> int:
        return len(self._pending)


@dataclass
class RetentionLease:
    id: str
    retaining_seqno: int
    timestamp: float
    source: str

    def to_dict(self) -> Dict[str, object]:
        """Commit-persistable form. The monotonic timestamp is NOT
        portable across process restarts, so it is deliberately dropped;
        a restored lease gets a fresh clock (restart leniency — the
        reference re-syncs lease timestamps from the primary too)."""
        return {"id": self.id, "retaining_seqno": self.retaining_seqno,
                "source": self.source}


PEER_RECOVERY_LEASE_SOURCE = "peer_recovery"


def peer_lease_id(node_id: str) -> str:
    """Retention leases are NODE-keyed (ReplicationTracker.
    getPeerRecoveryRetentionLeaseId): allocation ids change on every
    recovery, but the history a returning copy needs lives with the
    node that holds its disk."""
    return f"{PEER_RECOVERY_LEASE_SOURCE}/{node_id}"


class ReplicationTracker:
    """Primary-side replication group bookkeeping.

    in_sync allocation ids contribute to the global checkpoint; tracked-but-
    not-in-sync copies (recovering) are observed but don't hold it back until
    they finish recovery and are marked in-sync.
    """

    def __init__(self, shard_allocation_id: str, local_tracker: LocalCheckpointTracker,
                 lease_retention_seconds: float = 12 * 3600,
                 node_id: Optional[str] = None):
        self.allocation_id = shard_allocation_id
        self.local = local_tracker
        self._in_sync: Set[str] = {shard_allocation_id}
        self._tracked: Set[str] = {shard_allocation_id}
        self._checkpoints: Dict[str, int] = {shard_allocation_id: NO_OPS_PERFORMED}
        self._global_checkpoint = NO_OPS_PERFORMED
        self._leases: Dict[str, RetentionLease] = {}
        self._lease_retention = lease_retention_seconds
        self.primary_mode = True
        # allocation id -> lease id: the renewal hook. When a tracked
        # copy's local checkpoint advances (replica acks riding back
        # through action/replication.py), its lease is renewed to
        # checkpoint+1 — the next op that copy still needs.
        self._lease_of_alloc: Dict[str, str] = {}
        self.leases_expired_total = 0
        self.leases_released_node_left = 0
        # the primary retains its own history too (its lease never
        # expires while it IS the primary — see expire_leases). Keyed by
        # NODE when known: a successor primary that inherited the lease
        # set can then recognize this node's returning copy by sender
        self._own_lease_id = peer_lease_id(node_id or shard_allocation_id)
        self._lease_of_alloc[shard_allocation_id] = self._own_lease_id
        self.add_lease(self._own_lease_id, local_tracker.checkpoint + 1,
                       PEER_RECOVERY_LEASE_SOURCE)

    # -- membership ------------------------------------------------------

    def init_tracking(self, allocation_id: str,
                      lease_id: Optional[str] = None,
                      retaining_seqno: Optional[int] = None) -> None:
        """A new copy starts recovery: track it, not yet in-sync. When a
        lease id is given (the peer-recovery source handler passes the
        target NODE's lease id), a retention lease is created — or an
        existing one renewed — retaining from ``retaining_seqno``, and
        the copy's checkpoint advances keep renewing it from then on."""
        self._tracked.add(allocation_id)
        self._checkpoints.setdefault(allocation_id, NO_OPS_PERFORMED)
        if lease_id is not None:
            retaining = max(0, retaining_seqno or 0)
            self._lease_of_alloc[allocation_id] = lease_id
            if lease_id in self._leases:
                self.renew_lease(lease_id, retaining)
            else:
                self.add_lease(lease_id, retaining,
                               PEER_RECOVERY_LEASE_SOURCE)

    def activate_promoted(self, known_global_checkpoint: int,
                          in_sync_allocation_ids: List[str]) -> None:
        """Seed a freshly promoted primary's tracker (the reference's
        activatePrimaryMode under a new term): the global checkpoint
        starts from what this copy learned as a replica — never from its
        own local checkpoint, which may run ahead of copies that haven't
        acked — and the routing table's other in-sync copies are
        registered with unknown checkpoints so they hold the minimum
        down until their resync acks report real ones."""
        if known_global_checkpoint > self._global_checkpoint:
            self._global_checkpoint = known_global_checkpoint
        for aid in in_sync_allocation_ids:
            if aid == self.allocation_id:
                continue
            self._tracked.add(aid)
            self._in_sync.add(aid)
            self._checkpoints.setdefault(aid, NO_OPS_PERFORMED)

    def mark_in_sync(self, allocation_id: str, local_checkpoint: int) -> None:
        """Promote a tracked copy to in-sync. The copy must have caught up to
        the global checkpoint first (recovery finalization waits for this in
        the reference, RecoverySourceHandler.finalizeRecovery) — otherwise
        acknowledged writes above its checkpoint could be lost on failover."""
        if local_checkpoint < self._global_checkpoint:
            raise ValueError(
                f"cannot mark [{allocation_id}] in sync: its local checkpoint "
                f"[{local_checkpoint}] is below the global checkpoint "
                f"[{self._global_checkpoint}]")
        self._checkpoints[allocation_id] = local_checkpoint
        self._tracked.add(allocation_id)
        self._in_sync.add(allocation_id)
        self._renew_for_alloc(allocation_id, local_checkpoint + 1)
        self._recompute_global()

    def remove_copy(self, allocation_id: str) -> None:
        if allocation_id == self.allocation_id:
            return
        self._in_sync.discard(allocation_id)
        self._tracked.discard(allocation_id)
        self._checkpoints.pop(allocation_id, None)
        # the LEASE deliberately survives the copy's removal: that is the
        # entire point of retention leases — history for a departed copy
        # is held until the lease expires, so its return can be ops-based
        self._lease_of_alloc.pop(allocation_id, None)
        self._recompute_global()

    @property
    def in_sync_ids(self) -> Set[str]:
        return set(self._in_sync)

    # -- checkpoints -----------------------------------------------------

    def update_local_checkpoint(self, allocation_id: str, checkpoint: int) -> None:
        prev = self._checkpoints.get(allocation_id, NO_OPS_PERFORMED)
        if checkpoint > prev:
            self._checkpoints[allocation_id] = checkpoint
            # renewal rides the checkpoint advance (the replica's ack on
            # every replicated write): the copy provably holds everything
            # up to `checkpoint`, so its lease only needs checkpoint+1 on
            self._renew_for_alloc(allocation_id, checkpoint + 1)
            self._recompute_global()

    def _renew_for_alloc(self, allocation_id: str, retaining: int) -> None:
        lid = self._lease_of_alloc.get(allocation_id)
        if lid is not None and lid in self._leases:
            self.renew_lease(lid, retaining)

    def _recompute_global(self) -> None:
        self._checkpoints[self.allocation_id] = self.local.checkpoint
        self._renew_for_alloc(self.allocation_id, self.local.checkpoint + 1)
        if not self._in_sync:
            return
        new_global = min(self._checkpoints.get(a, NO_OPS_PERFORMED) for a in self._in_sync)
        if new_global > self._global_checkpoint:
            self._global_checkpoint = new_global

    @property
    def global_checkpoint(self) -> int:
        self._recompute_global()
        return self._global_checkpoint

    def update_global_checkpoint_on_replica(self, checkpoint: int) -> None:
        """Replica learns the global checkpoint from the primary's piggyback."""
        if checkpoint > self._global_checkpoint:
            self._global_checkpoint = checkpoint

    # -- retention leases ------------------------------------------------

    def add_lease(self, lease_id: str, retaining_seqno: int, source: str) -> RetentionLease:
        lease = RetentionLease(lease_id, retaining_seqno, time.monotonic(), source)
        self._leases[lease_id] = lease
        return lease

    def renew_lease(self, lease_id: str, retaining_seqno: int) -> None:
        lease = self._leases.get(lease_id)
        if lease is not None:
            lease.retaining_seqno = max(lease.retaining_seqno, retaining_seqno)
            lease.timestamp = time.monotonic()

    def remove_lease(self, lease_id: str) -> None:
        self._leases.pop(lease_id, None)

    def expire_leases(self, now: Optional[float] = None) -> List[str]:
        """Drop leases idle longer than the retention period. The
        primary's OWN lease never expires here — while this copy is the
        primary its history is the source everyone else recovers from."""
        now = time.monotonic() if now is None else now
        expired = [lid for lid, l in self._leases.items()
                   if lid != self._own_lease_id and
                   now - l.timestamp > self._lease_retention]
        for lid in expired:
            del self._leases[lid]
        self.leases_expired_total += len(expired)
        return expired

    def release_node_lease(self, node_id: str) -> bool:
        """Drop a departed node's peer-recovery lease EARLY: the node
        has permanently left the cluster and its copy was rebuilt
        elsewhere, so holding 12h of history for a disk that is never
        coming back only bloats every other copy's retention. Returns
        True if a lease was actually released."""
        lid = peer_lease_id(node_id)
        if lid == self._own_lease_id or lid not in self._leases:
            return False
        del self._leases[lid]
        self.leases_released_node_left += 1
        return True

    def has_lease(self, lease_id: str) -> bool:
        return lease_id in self._leases

    def get_lease(self, lease_id: str) -> Optional[RetentionLease]:
        return self._leases.get(lease_id)

    def restore_leases(self, leases: List[Dict[str, object]]) -> int:
        """Re-install commit-persisted leases after a store recovery.
        Timestamps restart fresh (monotonic clocks don't survive the
        process); retaining seqnos are authoritative. Returns how many
        were restored."""
        n = 0
        for entry in leases or []:
            try:
                lid = str(entry["id"])
                retaining = int(entry["retaining_seqno"])
            except (KeyError, TypeError, ValueError):
                continue
            if lid == self._own_lease_id:
                continue   # own lease already exists, tracks our checkpoint
            existing = self._leases.get(lid)
            if existing is None or existing.retaining_seqno < retaining:
                self.add_lease(lid, retaining,
                               str(entry.get("source",
                                             PEER_RECOVERY_LEASE_SOURCE)))
                n += 1
        return n

    def min_retained_seqno(self) -> int:
        """History below this may be discarded (translog trim / merge purge)."""
        self._recompute_global()   # own lease tracks the live checkpoint
        if self._leases:
            return min(l.retaining_seqno for l in self._leases.values())
        return self.global_checkpoint + 1

    def leases(self) -> List[RetentionLease]:
        return list(self._leases.values())

    def lease_stats(self) -> Dict[str, int]:
        return {"active": len(self._leases),
                "expired_total": self.leases_expired_total,
                "released_node_left": self.leases_released_node_left,
                "min_retained_seqno": self.min_retained_seqno()}
