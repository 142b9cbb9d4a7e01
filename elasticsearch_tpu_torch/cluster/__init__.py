"""Cluster control plane: immutable state, routing, allocation, consensus.

Reference layer L3 (SURVEY.md §1): cluster/ClusterState.java:86 (immutable
versioned state), cluster/routing/ (shard routing + allocation),
cluster/coordination/ (Zen2 consensus). Host-side Python over the transport
layer — the MPMD control plane of the two-plane split; the SPMD data plane
lives in parallel/.
"""

from elasticsearch_tpu_torch.cluster.state import (
    ClusterState, DiscoveryNode, Roles,
)
from elasticsearch_tpu_torch.cluster.metadata import IndexMetadata, Metadata
from elasticsearch_tpu_torch.cluster.routing import (
    IndexRoutingTable, RoutingTable, ShardRouting, ShardState,
)
from elasticsearch_tpu_torch.cluster.allocation import AllocationService

__all__ = [
    "AllocationService", "ClusterState", "DiscoveryNode", "IndexMetadata",
    "IndexRoutingTable", "Metadata", "Roles", "RoutingTable", "ShardRouting",
    "ShardState",
]
