"""Shard allocation: decide which node gets each shard copy.

Reference: cluster/routing/allocation/AllocationService.java:70 (reroute on
every membership/metadata change), BalancedShardsAllocator.java:82 (weighted
least-loaded placement) and the pluggable decider chain (decider/ — same-
shard, filters, throttling). Pure functions ClusterState -> ClusterState;
the master runs them inside state updates.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Iterable, List, Optional, Sequence

from elasticsearch_tpu_torch.cluster.routing import (
    IndexRoutingTable, RoutingTable, ShardRouting, ShardState,
)
from elasticsearch_tpu_torch.cluster.state import ClusterState, DiscoveryNode


class Decision:
    YES = "YES"
    NO = "NO"
    THROTTLE = "THROTTLE"


class AllocationDecider:
    def can_allocate(self, shard: ShardRouting, node: DiscoveryNode,
                     state: ClusterState) -> str:
        return Decision.YES


class SameShardDecider(AllocationDecider):
    """No two copies of the same shard on one node
    (decider/SameShardAllocationDecider.java)."""

    def can_allocate(self, shard, node, state):
        for sr in state.routing_table.shards_on_node(node.node_id):
            if sr.index == shard.index and sr.shard_id == shard.shard_id:
                return Decision.NO
        return Decision.YES


class FilterDecider(AllocationDecider):
    """index.routing.allocation.{require,include,exclude}._name
    (decider/FilterAllocationDecider.java), matched on node names."""

    def can_allocate(self, shard, node, state):
        try:
            settings = state.metadata.index(shard.index).settings
        except Exception:  # noqa: BLE001 — index gone: no constraint
            return Decision.YES
        name = node.name or node.node_id
        req = settings.get("index.routing.allocation.require._name")
        if req and name != req:
            return Decision.NO
        inc = settings.get("index.routing.allocation.include._name")
        if inc and name not in str(inc).split(","):
            return Decision.NO
        exc = settings.get("index.routing.allocation.exclude._name")
        if exc and name in str(exc).split(","):
            return Decision.NO
        return Decision.YES


class ThrottlingDecider(AllocationDecider):
    """Bound concurrent recoveries per node
    (decider/ThrottlingAllocationDecider.java)."""

    def __init__(self, max_initializing_per_node: int = 4) -> None:
        self.max_initializing = max_initializing_per_node

    def can_allocate(self, shard, node, state):
        initializing = sum(
            1 for sr in state.routing_table.shards_on_node(node.node_id)
            if sr.state == ShardState.INITIALIZING)
        if initializing >= self.max_initializing:
            return Decision.THROTTLE
        return Decision.YES


class MaxRetryDecider(AllocationDecider):
    """Stop retry storms: a shard that failed allocation too many times
    stays unassigned until an explicit reroute with retry_failed
    (decider/MaxRetryAllocationDecider.java)."""

    def __init__(self, max_retries: int = 5) -> None:
        self.max_retries = max_retries

    def can_allocate(self, shard, node, state):
        if shard.failed_attempts >= self.max_retries:
            return Decision.NO
        return Decision.YES


class AwarenessDecider(AllocationDecider):
    """Spread copies of a shard across values of the awareness attributes
    (decider/AwarenessAllocationDecider.java): a node whose attribute
    value already holds its fair share of this shard's copies is
    rejected. Attributes come from the dynamic cluster setting
    cluster.routing.allocation.awareness.attributes."""

    def can_allocate(self, shard, node, state):
        attrs_setting = state.metadata.persistent_settings.get(
            "cluster.routing.allocation.awareness.attributes")
        if not attrs_setting:
            return Decision.YES
        group = state.routing_table.index(shard.index) \
            .shard_group(shard.shard_id) \
            if state.routing_table.has_index(shard.index) else ()
        n_copies = max(len(group), 1)
        for attr in str(attrs_setting).split(","):
            attr = attr.strip()
            if not attr:
                continue
            values = {n.attr(attr) for n in state.data_nodes().values()
                      if n.attr(attr) is not None}
            if not values:
                continue
            my_value = node.attr(attr)
            per_value_cap = -(-n_copies // len(values))  # ceil
            assigned_here = sum(
                1 for sr in group
                if sr.assigned and sr.node_id in state.nodes
                and state.nodes[sr.node_id].attr(attr) == my_value)
            if assigned_here >= per_value_cap:
                return Decision.NO
        return Decision.YES


class DiskThresholdDecider(AllocationDecider):
    """Keep shards off nodes past the low watermark
    (decider/DiskThresholdDecider.java). Usage comes from the cluster
    info the master refreshes from node stats
    (InternalClusterInfoService analog); absent info allows."""

    def __init__(self, low_watermark: float = 0.85) -> None:
        self.low_watermark = low_watermark
        # node_id -> (used_bytes, total_bytes)
        self.usages: Dict[str, tuple] = {}

    def can_allocate(self, shard, node, state):
        got = self.usages.get(node.node_id)
        if not got:
            return Decision.YES
        used, total = got
        if total > 0 and used / total >= self.low_watermark:
            return Decision.NO
        return Decision.YES


def default_deciders() -> Sequence[AllocationDecider]:
    """Fresh decider instances per service: DiskThresholdDecider carries
    mutable usage state, so sharing one module-level tuple would leak
    decisions across nodes (and across tests)."""
    return (SameShardDecider(), FilterDecider(), ThrottlingDecider(),
            MaxRetryDecider(), AwarenessDecider(), DiskThresholdDecider())


class AllocationService:
    def __init__(self,
                 deciders: Optional[Sequence[AllocationDecider]] = None):
        self.deciders = list(deciders if deciders is not None
                             else default_deciders())
        # GatewayAllocator (gateway.py), attached by the node: when set,
        # unassigned shards with a prior identity are placed on the node
        # holding the freshest non-corrupted on-disk copy instead of by
        # balance alone. None (the default) keeps reroute pure balance.
        self.gateway_allocator = None

    def disk_threshold(self) -> Optional["DiskThresholdDecider"]:
        """The service's disk decider, for cluster-info refreshes."""
        for d in self.deciders:
            if isinstance(d, DiskThresholdDecider):
                return d
        return None

    # -- decision ------------------------------------------------------------

    def decide(self, shard: ShardRouting, node: DiscoveryNode,
               state: ClusterState) -> str:
        worst = Decision.YES
        for d in self.deciders:
            verdict = d.can_allocate(shard, node, state)
            if verdict == Decision.NO:
                return Decision.NO
            if verdict == Decision.THROTTLE:
                worst = Decision.THROTTLE
        return worst

    # -- reroute -------------------------------------------------------------

    # BalancedShardsAllocator weight factors
    # (cluster.routing.allocation.balance.shard / .index defaults)
    SHARD_BALANCE = 0.45
    INDEX_BALANCE = 0.55
    REBALANCE_THRESHOLD = 1.0

    def _weight(self, loads: Dict[str, int],
                index_loads: Dict[str, Dict[str, int]],
                nid: str, index: str, n_nodes: int,
                total_shards: int, index_total: int) -> float:
        """BalancedShardsAllocator.WeightFunction: a node is attractive
        for a shard of [index] when it holds fewer shards overall AND
        fewer shards of that index than its fair share."""
        avg_shards = total_shards / n_nodes
        avg_index = index_total / n_nodes
        return (self.SHARD_BALANCE * (loads[nid] - avg_shards)
                + self.INDEX_BALANCE *
                (index_loads[nid].get(index, 0) - avg_index))

    def reroute(self, state: ClusterState,
                rebalance: bool = True) -> ClusterState:
        """Assign unassigned shards (primaries first) to the
        minimum-weight eligible node, then move replicas off overloaded
        nodes when the weight spread exceeds the threshold. Idempotent;
        no-op returns the same state."""
        data_nodes = state.data_nodes()
        if not data_nodes:
            return state
        routing = state.routing_table
        changed = False
        gateway = self.gateway_allocator
        if gateway is not None:
            # ReplicaShardAllocator cancel pass: an in-flight empty-store
            # replica build yields when a node holding the copy's real
            # data rejoins (the cancelled entry re-enters the unassigned
            # pool below and lands on the copy-holder)
            routing, n_cancelled = gateway.cancel_replaceable_recoveries(
                state, routing, self)
            if n_cancelled:
                changed = True
        loads: Dict[str, int] = {
            nid: len(routing.shards_on_node(nid)) for nid in data_nodes}
        index_loads: Dict[str, Dict[str, int]] = {
            nid: {} for nid in data_nodes}
        for nid in data_nodes:
            for sr in routing.shards_on_node(nid):
                index_loads[nid][sr.index] = \
                    index_loads[nid].get(sr.index, 0) + 1
        index_totals: Dict[str, int] = {}
        for sr in routing.all_shards():
            if sr.assigned:
                index_totals[sr.index] = index_totals.get(sr.index, 0) + 1
        n_nodes = len(data_nodes)

        def place(shard: ShardRouting, target: str) -> None:
            nonlocal routing, changed
            new_shard = shard.initialize(target)
            routing = routing.put_index(
                routing.index(shard.index).replace_shard(shard, new_shard))
            loads[target] += 1
            index_loads[target][shard.index] = \
                index_loads[target].get(shard.index, 0) + 1
            index_totals[shard.index] = \
                index_totals.get(shard.index, 0) + 1
            changed = True

        unassigned = sorted(
            (sr for sr in routing.all_shards()
             if sr.state == ShardState.UNASSIGNED),
            key=lambda sr: (not sr.primary, sr.index, sr.shard_id))
        if gateway is not None:
            # batch the shard-state fetches this pass will want into one
            # request per node before walking the shards
            gateway.prefetch(unassigned, state)
        for shard in unassigned:
            # replicas wait for an active primary to recover from
            if not shard.primary:
                primary = routing.index(shard.index).primary(shard.shard_id)
                if not primary.active:
                    continue
            st = state.next_version(routing_table=routing) if changed else state
            if gateway is not None and shard.last_allocation_id is not None:
                # this copy existed before: consult the gateway fetch
                # (Primary/ReplicaShardAllocator) before balance
                action, detail = gateway.decide_unassigned(shard, st, self)
                if action == "wait":
                    continue   # fetch in flight / throttled: next reroute
                if action == "allocate":
                    place(shard, detail)
                    continue
                if action in ("refuse", "fallback") and detail and \
                        shard.unassigned_reason != detail:
                    # surface the fetch-derived reason on the routing
                    # entry (health / _cat/shards / allocation explain)
                    noted = replace(shard, unassigned_reason=detail)
                    routing = routing.put_index(
                        routing.index(shard.index).replace_shard(
                            shard, noted))
                    shard = noted
                    changed = True
                if action == "refuse":
                    continue   # stays unassigned, loudly
            candidates = [
                nid for nid, node in data_nodes.items()
                if self.decide(shard, node, st) == Decision.YES]
            if not candidates:
                continue
            total = sum(loads.values())
            target = min(candidates, key=lambda nid: (
                self._weight(loads, index_loads, nid, shard.index, n_nodes,
                             total, index_totals.get(shard.index, 0)), nid))
            place(shard, target)

        if rebalance:
            rebalanced = self._rebalance(
                state, routing, data_nodes, loads, index_loads,
                index_totals)
            if rebalanced is not None:
                routing = rebalanced
                changed = True

        if not changed:
            return state
        return state.next_version(routing_table=routing)

    def _rebalance(self, state, routing, data_nodes, loads, index_loads,
                   index_totals) -> Optional[RoutingTable]:
        """Move STARTED replicas from max-weight to min-weight nodes while
        the spread exceeds the threshold (BalancedShardsAllocator.balance).
        Replica moves are drop-and-recover — the copy rebuilds from the
        primary on the target (a documented divergence from the
        reference's live relocation handoff; primaries never move).
        Returns the rebalanced routing table, or None for no change."""
        if len(data_nodes) < 2:
            return None
        # only rebalance a green cluster (ClusterRebalanceAllocationDecider
        # indices_all_active default)
        if any(not sr.active for sr in routing.all_shards()):
            return None
        changed = False
        for _round in range(8):            # bounded passes per reroute
            heavy = max(data_nodes, key=lambda nid: (loads[nid], nid))
            light = min(data_nodes, key=lambda nid: (loads[nid], nid))
            # move while the shard-count spread exceeds the threshold
            # (one move per pass converges to a <=1 spread)
            if loads[heavy] - loads[light] <= self.REBALANCE_THRESHOLD:
                break
            movable = [
                sr for sr in routing.shards_on_node(heavy)
                if not sr.primary and sr.state == ShardState.STARTED]
            moved = False
            for sr in movable:
                target_node = data_nodes[light]
                probe = sr.fail()
                st = state.next_version(routing_table=routing)
                if self.decide(replace(probe, failed_attempts=0),
                               target_node, st) != Decision.YES:
                    continue
                # drop the copy on the heavy node; allocate on the light
                irt = routing.index(sr.index)
                irt = irt.replace_shard(
                    sr, ShardRouting(index=sr.index, shard_id=sr.shard_id,
                                     primary=False))
                fresh = next(s for s in irt.shard_group(sr.shard_id)
                             if s.state == ShardState.UNASSIGNED)
                irt = irt.replace_shard(fresh, fresh.initialize(light))
                routing = routing.put_index(irt)
                loads[heavy] -= 1
                loads[light] += 1
                index_loads[heavy][sr.index] = \
                    index_loads[heavy].get(sr.index, 1) - 1
                index_loads[light][sr.index] = \
                    index_loads[light].get(sr.index, 0) + 1
                moved = True
                changed = True
                break
            if not moved:
                break
        return routing if changed else None

    # -- lifecycle events ----------------------------------------------------

    def apply_started_shards(self, state: ClusterState,
                             started: Iterable[ShardRouting]) -> ClusterState:
        routing = state.routing_table
        changed = False
        for shard in started:
            irt = routing.index(shard.index)
            current = next((sr for sr in irt.shard_group(shard.shard_id)
                            if sr.allocation_id == shard.allocation_id), None)
            if current is None or current.state != ShardState.INITIALIZING:
                continue
            routing = routing.put_index(
                irt.replace_shard(current, current.start()))
            changed = True
        if not changed:
            return state
        return self.reroute(state.next_version(routing_table=routing))

    def apply_failed_shard(self, state: ClusterState,
                           failed: ShardRouting,
                           count_failure: bool = True,
                           reason: Optional[str] = None) -> ClusterState:
        """Failed primary: promote an active replica, then schedule a new
        replica copy; failed replica: back to unassigned (reference:
        NodeRemovalClusterStateTaskExecutor → AllocationService.reroute).
        ``count_failure=False`` for operator-initiated cancels, which must
        not consume the MaxRetryDecider budget. ``reason`` is recorded on
        the unassigned copy (UnassignedInfo details) so allocation
        explain can answer *why* — e.g. a corrupted store."""
        routing = state.routing_table
        irt = routing.index(failed.index)
        current = next((sr for sr in irt.shard_group(failed.shard_id)
                        if sr.allocation_id == failed.allocation_id and
                        sr.allocation_id is not None), None)
        if current is None:
            return state
        if self.gateway_allocator is not None:
            # whatever the fetch cache said about this node's copy is
            # stale now (a corruption marker may have just appeared)
            self.gateway_allocator.invalidate_node_entry(
                failed.index, failed.shard_id, current.node_id)
        dropped = current.fail(reason)
        if not count_failure:
            dropped = replace(dropped,
                              failed_attempts=current.failed_attempts)
        irt = irt.replace_shard(current, dropped)
        metadata = state.metadata
        if current.primary:
            # every primary failure bumps the shard's primary term so stale
            # primaries can be fenced (IndexMetadata primaryTerms semantics)
            metadata = metadata.update_index(
                metadata.index(failed.index)
                .with_primary_term_bump(failed.shard_id))
            replicas = [sr for sr in irt.shard_group(failed.shard_id)
                        if not sr.primary and sr.active]
            if replicas:
                promoted = replicas[0]
                irt = irt.replace_shard(promoted, promoted.promote_to_primary())
                demoted = next(sr for sr in irt.shard_group(failed.shard_id)
                               if sr.primary and sr.state == ShardState.UNASSIGNED)
                # the replacement replica slot keeps the failed copy's
                # identity + reason: the gateway fetch can still match
                # whatever data outlived the failure, and explain keeps
                # answering WHY the copy died
                irt = irt.replace_shard(
                    demoted, ShardRouting(
                        index=failed.index, shard_id=failed.shard_id,
                        primary=False,
                        unassigned_reason=demoted.unassigned_reason,
                        last_allocation_id=demoted.last_allocation_id))
        routing = routing.put_index(irt)
        return self.reroute(state.next_version(routing_table=routing,
                                               metadata=metadata))

    def disassociate_dead_nodes(self, state: ClusterState,
                                dead: Iterable[str]) -> ClusterState:
        dead_set = set(dead)
        out = state
        for nid in dead_set:
            for shard in list(out.routing_table.shards_on_node(nid)):
                if shard.node_id in dead_set:
                    out = self.apply_failed_shard(
                        out, shard, reason=f"node [{nid}] left the cluster")
        return out
