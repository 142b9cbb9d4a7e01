"""Shard routing table: which node holds which shard copy, in which state.

Reference: cluster/routing/RoutingTable.java:58, ShardRouting states
UNASSIGNED/INITIALIZING/STARTED/RELOCATING, and OperationRouting.java:216
(murmur3(routing) % shards doc partitioning — implemented in
utils/murmur3.py's route_shard). Immutable, like everything in cluster
state.
"""

from __future__ import annotations

import uuid as uuid_mod
from dataclasses import dataclass, field, replace
from enum import Enum
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

from elasticsearch_tpu_torch.utils.errors import ShardNotFoundError


class ShardState(str, Enum):
    UNASSIGNED = "UNASSIGNED"
    INITIALIZING = "INITIALIZING"
    STARTED = "STARTED"
    RELOCATING = "RELOCATING"


@dataclass(frozen=True)
class ShardRouting:
    index: str
    shard_id: int
    primary: bool
    state: ShardState = ShardState.UNASSIGNED
    node_id: Optional[str] = None
    relocating_node_id: Optional[str] = None
    allocation_id: Optional[str] = None       # identity of this shard copy
    # consecutive allocation failures (UnassignedInfo.getNumFailedAllocations
    # analog) — MaxRetryDecider stops retry storms; reset by an explicit
    # reroute with retry_failed
    failed_attempts: int = 0
    # why the last copy failed (UnassignedInfo.getDetails analog) —
    # surfaced by _cluster/allocation/explain so operators can see e.g.
    # a corruption marker keeping a shard red
    unassigned_reason: Optional[str] = None
    # the allocation id this copy held BEFORE it became unassigned
    # (UnassignedInfo + in-sync-allocation-ids analog): the gateway
    # allocator matches on-disk copies against it so a restarted shard
    # goes back to the node actually holding its data
    last_allocation_id: Optional[str] = None

    @property
    def active(self) -> bool:
        return self.state in (ShardState.STARTED, ShardState.RELOCATING)

    @property
    def assigned(self) -> bool:
        return self.node_id is not None

    def initialize(self, node_id: str) -> "ShardRouting":
        assert self.state == ShardState.UNASSIGNED
        return replace(self, state=ShardState.INITIALIZING, node_id=node_id,
                       allocation_id=uuid_mod.uuid4().hex)

    def start(self) -> "ShardRouting":
        assert self.state == ShardState.INITIALIZING
        # a successful start clears the failure streak: MaxRetryDecider
        # counts CONSECUTIVE failures (UnassignedInfo is discarded once a
        # shard starts in the reference)
        return replace(self, state=ShardState.STARTED, failed_attempts=0,
                       unassigned_reason=None, last_allocation_id=None)

    def relocate(self, target_node: str) -> "ShardRouting":
        assert self.state == ShardState.STARTED
        return replace(self, state=ShardState.RELOCATING,
                       relocating_node_id=target_node)

    def fail(self, reason: Optional[str] = None) -> "ShardRouting":
        # an ACTIVE copy's identity is its own allocation id; a copy that
        # never started (failed mid-recovery) keeps pointing at the prior
        # on-disk identity, so the gateway fetch can still match the data
        # that outlived the failed attempt
        last = self.allocation_id if self.active else \
            (self.last_allocation_id or self.allocation_id)
        return ShardRouting(index=self.index, shard_id=self.shard_id,
                            primary=self.primary,
                            failed_attempts=self.failed_attempts + 1,
                            unassigned_reason=reason or
                            self.unassigned_reason,
                            last_allocation_id=last)

    def promote_to_primary(self) -> "ShardRouting":
        return replace(self, primary=True)

    def to_dict(self) -> Dict[str, Any]:
        return {"index": self.index, "shard": self.shard_id,
                "primary": self.primary, "state": self.state.value,
                "node": self.node_id,
                "relocating_node": self.relocating_node_id,
                "allocation_id": self.allocation_id,
                "failed_attempts": self.failed_attempts,
                "unassigned_reason": self.unassigned_reason,
                "last_allocation_id": self.last_allocation_id}

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "ShardRouting":
        return ShardRouting(index=d["index"], shard_id=d["shard"],
                            primary=d["primary"],
                            state=ShardState(d["state"]),
                            node_id=d.get("node"),
                            relocating_node_id=d.get("relocating_node"),
                            allocation_id=d.get("allocation_id"),
                            failed_attempts=d.get("failed_attempts", 0),
                            unassigned_reason=d.get("unassigned_reason"),
                            last_allocation_id=d.get("last_allocation_id"))


@dataclass(frozen=True)
class IndexRoutingTable:
    """All shard copies of one index: shards[shard_id] = (primary, *replicas)."""

    index: str
    shards: Mapping[int, Tuple[ShardRouting, ...]] = field(default_factory=dict)

    @staticmethod
    def new(index: str, n_shards: int, n_replicas: int) -> "IndexRoutingTable":
        shards: Dict[int, Tuple[ShardRouting, ...]] = {}
        for sid in range(n_shards):
            group = [ShardRouting(index=index, shard_id=sid, primary=True)]
            group += [ShardRouting(index=index, shard_id=sid, primary=False)
                      for _ in range(n_replicas)]
            shards[sid] = tuple(group)
        return IndexRoutingTable(index=index, shards=shards)

    def shard_group(self, shard_id: int) -> Tuple[ShardRouting, ...]:
        if shard_id not in self.shards:
            raise ShardNotFoundError(
                f"shard [{self.index}][{shard_id}] not found")
        return self.shards[shard_id]

    def primary(self, shard_id: int) -> ShardRouting:
        for sr in self.shard_group(shard_id):
            if sr.primary:
                return sr
        raise ShardNotFoundError(
            f"no primary for shard [{self.index}][{shard_id}]")

    def replace_shard(self, old: ShardRouting, new: ShardRouting
                      ) -> "IndexRoutingTable":
        group = list(self.shards[old.shard_id])
        idx = group.index(old)
        group[idx] = new
        return IndexRoutingTable(
            index=self.index,
            shards={**self.shards, old.shard_id: tuple(group)})

    def all_shards(self) -> Iterable[ShardRouting]:
        for group in self.shards.values():
            yield from group

    @property
    def all_primaries_active(self) -> bool:
        return all(self.primary(sid).active for sid in self.shards)

    @property
    def all_active(self) -> bool:
        return all(sr.active for sr in self.all_shards())

    def to_dict(self) -> Dict[str, Any]:
        return {"index": self.index,
                "shards": {str(sid): [sr.to_dict() for sr in group]
                           for sid, group in self.shards.items()}}

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "IndexRoutingTable":
        return IndexRoutingTable(
            index=d["index"],
            shards={int(sid): tuple(ShardRouting.from_dict(s) for s in group)
                    for sid, group in d.get("shards", {}).items()})


@dataclass(frozen=True)
class RoutingTable:
    indices: Mapping[str, IndexRoutingTable] = field(default_factory=dict)

    def index(self, name: str) -> IndexRoutingTable:
        if name not in self.indices:
            raise ShardNotFoundError(f"no routing for index [{name}]")
        return self.indices[name]

    def has_index(self, name: str) -> bool:
        return name in self.indices

    def put_index(self, irt: IndexRoutingTable) -> "RoutingTable":
        return RoutingTable(indices={**self.indices, irt.index: irt})

    def remove_index(self, name: str) -> "RoutingTable":
        return RoutingTable(indices={k: v for k, v in self.indices.items()
                                     if k != name})

    def all_shards(self) -> Iterable[ShardRouting]:
        for irt in self.indices.values():
            yield from irt.all_shards()

    def shards_on_node(self, node_id: str) -> List[ShardRouting]:
        return [sr for sr in self.all_shards() if sr.node_id == node_id or
                sr.relocating_node_id == node_id]

    def to_dict(self) -> Dict[str, Any]:
        return {"indices": {k: v.to_dict() for k, v in self.indices.items()}}

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "RoutingTable":
        return RoutingTable(
            indices={k: IndexRoutingTable.from_dict(v)
                     for k, v in d.get("indices", {}).items()})
