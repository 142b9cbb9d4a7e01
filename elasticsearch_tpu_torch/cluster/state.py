"""Immutable, versioned cluster state — the one shared truth.

Reference: cluster/ClusterState.java:86 (immutable + Diffable incremental
publication), cluster/node/DiscoveryNodeRole.java:33 (roles). Every change
produces a new state with version+1 under the master's current term;
publication ships a diff when the receiver has the parent version
(PublicationTransportHandler.java:89) and falls back to the full state.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, FrozenSet, Mapping, Optional, Tuple

from elasticsearch_tpu_torch.cluster.metadata import Metadata
from elasticsearch_tpu_torch.cluster.routing import RoutingTable


class Roles:
    MASTER = "master"
    DATA = "data"
    INGEST = "ingest"
    ALL: FrozenSet[str] = frozenset({MASTER, DATA, INGEST})


@dataclass(frozen=True)
class DiscoveryNode:
    node_id: str
    name: str = ""
    roles: FrozenSet[str] = field(default_factory=lambda: frozenset(Roles.ALL))
    address: str = "local"
    # node attributes for awareness/filter allocation (node.attr.* —
    # DiscoveryNode.getAttributes analog); frozen tuple of (key, value)
    attrs: Tuple[Tuple[str, str], ...] = ()
    # per-boot identity (DiscoveryNode.getEphemeralId analog): a fresh
    # value every process start, so a rejoin can distinguish "the same
    # running process re-sent its join" (no-op) from "the process
    # restarted" (replace the entry + republish the full state)
    ephemeral_id: str = ""

    def attr(self, key: str) -> Optional[str]:
        for k, v in self.attrs:
            if k == key:
                return v
        return None

    @property
    def is_master_eligible(self) -> bool:
        return Roles.MASTER in self.roles

    @property
    def is_data(self) -> bool:
        return Roles.DATA in self.roles

    def to_dict(self) -> Dict[str, Any]:
        out = {"id": self.node_id, "name": self.name or self.node_id,
               "roles": sorted(self.roles), "address": self.address}
        if self.attrs:
            out["attributes"] = dict(self.attrs)
        if self.ephemeral_id:
            out["ephemeral_id"] = self.ephemeral_id
        return out

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "DiscoveryNode":
        return DiscoveryNode(node_id=d["id"], name=d.get("name", ""),
                             roles=frozenset(d.get("roles", Roles.ALL)),
                             address=d.get("address", "local"),
                             attrs=tuple(sorted(
                                 d.get("attributes", {}).items())),
                             ephemeral_id=d.get("ephemeral_id", ""))


@dataclass(frozen=True)
class ClusterState:
    cluster_name: str = "elasticsearch-tpu"
    term: int = 0                    # master term (coordination epoch)
    version: int = 0                 # monotonic within and across terms
    state_uuid: str = "_na_"
    master_node_id: Optional[str] = None
    nodes: Mapping[str, DiscoveryNode] = field(default_factory=dict)
    metadata: Metadata = field(default_factory=Metadata)
    routing_table: RoutingTable = field(default_factory=RoutingTable)
    blocks: Tuple[str, ...] = ()     # global blocks, e.g. STATE_NOT_RECOVERED
    # voting configuration: node ids whose quorum commits state (Zen2's
    # VotingConfiguration; reconfigured as master-eligible nodes join/leave)
    voting_config: FrozenSet[str] = frozenset()

    STATE_NOT_RECOVERED_BLOCK = "state-not-recovered"
    NO_MASTER_BLOCK = "no-master"

    # -- functional updates --------------------------------------------------

    def next_version(self, **changes: Any) -> "ClusterState":
        import uuid as uuid_mod
        return replace(self, version=self.version + 1,
                       state_uuid=uuid_mod.uuid4().hex, **changes)

    def with_nodes(self, nodes: Mapping[str, DiscoveryNode],
                   master_node_id: Optional[str]) -> "ClusterState":
        return self.next_version(nodes=dict(nodes),
                                 master_node_id=master_node_id)

    def with_metadata(self, metadata: Metadata) -> "ClusterState":
        return self.next_version(metadata=metadata)

    def with_routing(self, routing_table: RoutingTable) -> "ClusterState":
        return self.next_version(routing_table=routing_table)

    def with_block(self, block: str) -> "ClusterState":
        if block in self.blocks:
            return self
        return self.next_version(blocks=self.blocks + (block,))

    def without_block(self, block: str) -> "ClusterState":
        if block not in self.blocks:
            return self
        return self.next_version(
            blocks=tuple(b for b in self.blocks if b != block))

    @property
    def master_node(self) -> Optional[DiscoveryNode]:
        return self.nodes.get(self.master_node_id) \
            if self.master_node_id else None

    def data_nodes(self) -> Dict[str, DiscoveryNode]:
        return {nid: n for nid, n in self.nodes.items() if n.is_data}

    def master_eligible_nodes(self) -> Dict[str, DiscoveryNode]:
        return {nid: n for nid, n in self.nodes.items()
                if n.is_master_eligible}

    # -- serialization + diffs ----------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {
            "cluster_name": self.cluster_name,
            "term": self.term, "version": self.version,
            "state_uuid": self.state_uuid,
            "master_node": self.master_node_id,
            "nodes": {nid: n.to_dict() for nid, n in self.nodes.items()},
            "metadata": self.metadata.to_dict(),
            "routing_table": self.routing_table.to_dict(),
            "blocks": list(self.blocks),
            "voting_config": sorted(self.voting_config),
        }

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "ClusterState":
        return ClusterState(
            cluster_name=d.get("cluster_name", "elasticsearch-tpu"),
            term=d.get("term", 0), version=d.get("version", 0),
            state_uuid=d.get("state_uuid", "_na_"),
            master_node_id=d.get("master_node"),
            nodes={nid: DiscoveryNode.from_dict(n)
                   for nid, n in d.get("nodes", {}).items()},
            metadata=Metadata.from_dict(d.get("metadata", {})),
            routing_table=RoutingTable.from_dict(d.get("routing_table", {})),
            blocks=tuple(d.get("blocks", ())),
            voting_config=frozenset(d.get("voting_config", ())))

    def diff_from(self, parent: "ClusterState") -> Dict[str, Any]:
        """Sections changed since `parent` (identity-compared — cheap because
        unchanged sections are shared between immutable states)."""
        diff: Dict[str, Any] = {
            "from_uuid": parent.state_uuid, "to_uuid": self.state_uuid,
            "term": self.term, "version": self.version,
            "master_node": self.master_node_id,
            "blocks": list(self.blocks),
            "voting_config": sorted(self.voting_config),
        }
        if self.nodes is not parent.nodes:
            diff["nodes"] = {nid: n.to_dict()
                             for nid, n in self.nodes.items()}
        if self.metadata is not parent.metadata:
            diff["metadata"] = self.metadata.to_dict()
        if self.routing_table is not parent.routing_table:
            diff["routing_table"] = self.routing_table.to_dict()
        return diff

    def apply_diff(self, diff: Mapping[str, Any]) -> "ClusterState":
        if diff["from_uuid"] != self.state_uuid:
            raise IncompatibleClusterStateError(
                f"diff base {diff['from_uuid']} != local {self.state_uuid}")
        out = self
        nodes = ({nid: DiscoveryNode.from_dict(n)
                  for nid, n in diff["nodes"].items()}
                 if "nodes" in diff else self.nodes)
        metadata = (Metadata.from_dict(diff["metadata"])
                    if "metadata" in diff else self.metadata)
        routing = (RoutingTable.from_dict(diff["routing_table"])
                   if "routing_table" in diff else self.routing_table)
        return replace(out, term=diff["term"], version=diff["version"],
                       state_uuid=diff["to_uuid"],
                       master_node_id=diff.get("master_node"),
                       nodes=nodes, metadata=metadata, routing_table=routing,
                       blocks=tuple(diff.get("blocks", ())),
                       voting_config=frozenset(diff.get("voting_config", ())))


class IncompatibleClusterStateError(Exception):
    """Receiver can't apply a diff (wrong base) — sender retries full state."""
