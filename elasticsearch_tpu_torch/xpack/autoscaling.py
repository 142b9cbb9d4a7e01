"""Autoscaling: policies + capacity decisions from current usage.

Reference: x-pack/plugin/autoscaling — policies name roles and deciders;
GET /_autoscaling/capacity reports required vs current capacity per
policy so an orchestrator can add/remove nodes. The deciders here are
the two that matter for this build's resource model: shard density
(shards per data node) and indexing pressure headroom.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

from elasticsearch_tpu_torch.utils.errors import (
    IllegalArgumentError, ResourceNotFoundError,
)

SECTION = "autoscaling_policies"

# reference cluster.max_shards_per_node default is 1000; scaled to this
# build's event-loop nodes
MAX_SHARDS_PER_NODE = 1000


class AutoscalingService:
    def __init__(self, node) -> None:
        self.node = node

    def _policies(self) -> Dict[str, Any]:
        return dict(self.node._applied_state()
                    .metadata.custom.get(SECTION, {}))

    def put_policy(self, name: str, body: Dict[str, Any],
                   on_done: Callable) -> None:
        body = dict(body or {})
        if not body.get("roles"):
            on_done(None, IllegalArgumentError(
                "autoscaling policy requires [roles]"))
            return
        from elasticsearch_tpu_torch.action.admin import PUT_CUSTOM
        self.node.master_client.execute(
            PUT_CUSTOM, {"section": SECTION, "name": name, "body": body},
            lambda r, e: on_done({"acknowledged": True}
                                 if e is None else None, e))

    def delete_policy(self, name: str, on_done: Callable) -> None:
        if name not in self._policies():
            on_done(None, ResourceNotFoundError(
                f"autoscaling policy [{name}] not found"))
            return
        from elasticsearch_tpu_torch.action.admin import DELETE_CUSTOM
        self.node.master_client.execute(
            DELETE_CUSTOM, {"section": SECTION, "name": name},
            lambda r, e: on_done({"acknowledged": True}
                                 if e is None else None, e))

    def capacity(self) -> Dict[str, Any]:
        """GET /_autoscaling/capacity: per policy, current node count vs
        the count the deciders require."""
        state = self.node._applied_state()
        n_data = len(state.data_nodes())
        total_shards = sum(1 for sr in state.routing_table.all_shards()
                           if sr.assigned)
        unassigned = sum(1 for sr in state.routing_table.all_shards()
                         if not sr.assigned)
        tp = self.node.thread_pool
        pressure = (tp.write_bytes_in_flight / tp.write_bytes_limit
                    if tp.write_bytes_limit else 0.0)
        policies = {}
        for name, p in sorted(self._policies().items()):
            required = max(1, -(-(total_shards + unassigned)
                                // MAX_SHARDS_PER_NODE))
            reasons = []
            if unassigned:
                # replicas that cannot fit (same-shard) need more nodes
                required = max(required, n_data + 1)
                reasons.append(
                    f"{unassigned} unassigned shard copies need "
                    f"additional nodes")
            if pressure > 0.8:
                required = max(required, n_data + 1)
                reasons.append(
                    f"indexing pressure at {pressure:.0%} of capacity")
            policies[name] = {
                "required_capacity": {"total": {"nodes": required}},
                "current_capacity": {"total": {"nodes": n_data}},
                "current_nodes": sorted(state.data_nodes()),
                "deciders": {
                    "shard_density": {
                        "required_nodes": max(1, -(-total_shards //
                                                   MAX_SHARDS_PER_NODE)),
                        "assigned_shards": total_shards,
                        "unassigned_shards": unassigned},
                    "indexing_pressure": {
                        "utilization": round(pressure, 4)},
                },
                "reason_summary": "; ".join(reasons) or "capacity ok",
            }
        return {"policies": policies}
