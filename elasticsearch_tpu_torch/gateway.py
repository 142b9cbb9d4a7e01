"""Gateway: durable per-node cluster-state persistence + gateway allocation.

Reference analog: gateway/GatewayMetaState.java:79 +
PersistedClusterStateService.java:117 — every node persists its accepted
cluster state and coordination term; on restart the node boots from them
(then GatewayService-style recovery re-creates shards from local stores,
which our IndicesClusterStateService reconciler already does on apply).

Raft safety requires the term and the accepted state to be durable BEFORE
responding to vote/publish messages, so DurablePersistedState writes
through on every mutation (fsync'd atomic replace).

The second half of the reference's gateway package lives here too:
GatewayAllocator + AsyncShardFetch + Primary/ReplicaShardAllocator
(gateway/GatewayAllocator.java, gateway/AsyncShardFetch.java,
gateway/PrimaryShardAllocator.java, gateway/ReplicaShardAllocator.java).
The elected master asks every data node what its disks actually hold
(``_list_gateway_started_shards``), caches the answers per unassigned
shard, and allocates restarted primaries to the node with the freshest
non-corrupted copy — falling back to balance/empty-store only with an
explicit unassigned_reason. The same fetch results reconcile routing
against reality: a STARTED copy whose host reports no local store is
failed and reallocated instead of 404ing forever under green health.
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from elasticsearch_tpu_torch.cluster.coordination import Mode, PersistedState
from elasticsearch_tpu_torch.cluster.routing import ShardRouting, ShardState
from elasticsearch_tpu_torch.cluster.state import ClusterState
from elasticsearch_tpu_torch.index.disk_io import pack_footer, unpack_footer
from elasticsearch_tpu_torch.utils.errors import ShardCorruptedError

logger = logging.getLogger(__name__)


class CorruptedGatewayStateError(ShardCorruptedError):
    """The node's persisted coordination state (_state/state.json) failed
    its checksum or no longer parses: surfaced as a typed
    ShardCorruptedError-family failure at boot instead of a bare JSON
    parse error, so operators see WHAT is corrupted (the same discipline
    every shard artifact already follows)."""


class DurablePersistedState(PersistedState):
    """Write-through PersistedState: term/state mutations hit disk before
    the caller proceeds (CoordinationState mutates these exactly at the
    points where the algorithm requires durability)."""

    def __init__(self, path: Path, current_term: int = 0,
                 accepted_state: Optional[ClusterState] = None):
        object.__setattr__(self, "_path", path)
        object.__setattr__(self, "_ready", False)
        super().__init__(current_term=current_term,
                         accepted_state=accepted_state or ClusterState())
        object.__setattr__(self, "_ready", True)
        self._persist()

    def __setattr__(self, name, value):
        object.__setattr__(self, name, value)
        if getattr(self, "_ready", False) and \
                name in ("current_term", "accepted_state"):
            self._persist()

    def _persist(self) -> None:
        payload = json.dumps({
            "current_term": self.current_term,
            "accepted_state": self.accepted_state.to_dict(),
        }).encode("utf-8")
        tmp = self._path.with_name("." + self._path.name + ".tmp")
        with open(tmp, "wb") as f:
            # CRC32 footer like every shard artifact: a rotted/torn
            # state file is detected at load, not trusted
            f.write(pack_footer(payload))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path)


class GatewayMetaState:
    """Loads / creates the node's durable coordination state."""

    def __init__(self, data_path: str):
        self.dir = Path(data_path) / "_state"
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / "state.json"

    def load_or_create(self, initial_state: ClusterState
                       ) -> DurablePersistedState:
        if self.path.exists():
            raw = self.path.read_bytes()
            try:
                payload = unpack_footer(self.path, raw)
                d = json.loads(payload.decode("utf-8"))
            except (ShardCorruptedError, ValueError) as e:
                # checksum mismatch, missing footer, or (crc-valid but)
                # unparseable JSON: refuse to boot from it, typed —
                # corrupted coordination state must never be silently
                # reinterpreted as an empty/partial cluster
                raise CorruptedGatewayStateError(
                    f"gateway state [{self.path}] is corrupted: {e}"
                ) from e
            state = ClusterState.from_dict(d.get("accepted_state", {}))
            return DurablePersistedState(
                self.path,
                current_term=d.get("current_term", 0),
                accepted_state=_reset_routing(state))
        return DurablePersistedState(self.path,
                                     accepted_state=initial_state)


def _reset_routing(state: ClusterState) -> ClusterState:
    """Persisted METADATA survives a restart; routing does not — shard
    assignments are re-derived by allocation once the cluster re-forms
    (GatewayService.performStateRecovery → Primary/ReplicaShardAllocator).
    Every shard restarts life UNASSIGNED, but NOT amnesiac: each rebuilt
    entry keeps its prior copy's allocation id (last_allocation_id), so
    the GatewayAllocator's shard-state fetch can match on-disk copies to
    their last-known identity and send every shard back to the node that
    actually holds its data. Per-index replica overrides ride in
    metadata (number_of_replicas / settings survive verbatim); the
    rebuilt groups are sized from it."""
    from dataclasses import replace

    from elasticsearch_tpu_torch.cluster.routing import (
        IndexRoutingTable, RoutingTable, ShardRouting,
    )
    import uuid as uuid_mod
    fresh = {}
    for name in state.metadata.indices:
        im = state.metadata.index(name)
        prior = (state.routing_table.index(name)
                 if state.routing_table.has_index(name) else None)
        shards = {}
        for sid in range(im.number_of_shards):
            group = []
            prior_group = list(prior.shard_group(sid)) \
                if prior is not None and sid in prior.shards else []
            # primaries first, preserving each slot's prior identity; the
            # group is re-sized from metadata so replica-count overrides
            # applied before the restart come back exactly
            prior_group.sort(key=lambda sr: not sr.primary)
            for copy in range(1 + im.number_of_replicas):
                old = prior_group[copy] if copy < len(prior_group) else None
                group.append(ShardRouting(
                    index=name, shard_id=sid, primary=(copy == 0),
                    last_allocation_id=(
                        (old.allocation_id or old.last_allocation_id)
                        if old is not None else None)))
            shards[sid] = tuple(group)
        fresh[name] = IndexRoutingTable(index=name, shards=shards)
    # a NEW state_uuid is essential: the content changed, and the diff
    # publication protocol keys section reuse on uuid identity — keeping
    # the old uuid would let a master's diff silently skip the routing
    # section on a rebooted member, leaving it permanently diverged (the
    # need_full fallback only triggers on uuid mismatch)
    return replace(state,
                   routing_table=RoutingTable(indices=fresh),
                   nodes={}, master_node_id=None,
                   state_uuid=uuid_mod.uuid4().hex)


# ---------------------------------------------------------------------------
# gateway allocation: async shard-state fetch + freshest-copy placement
# ---------------------------------------------------------------------------

# each data node answers from its local stores: live shard, or on-disk
# commit watermarks + corruption-marker status (one request may carry many
# shards; the response maps "<index>:<shard>" -> info)
GATEWAY_STARTED_SHARDS = "internal:gateway/local/started_shards"


def _shard_key_str(index: str, shard_id: int) -> str:
    return f"{index}:{shard_id}"


class GatewayAllocator:
    """Master-driven shard-state fetch + existing-copy allocation.

    Every node runs the ``_list_gateway_started_shards`` HANDLER (the
    TransportNodesListGatewayStartedShards analog); only the elected
    master runs the fetch/allocate side. Results are cached per shard and
    invalidated on node join/leave, on shard failure (a marker may have
    appeared), and by an explicit ``reroute?retry_failed``.

    Three consumers of the fetch results:
      * PrimaryShardAllocator (``decide_unassigned``): unassigned
        primaries go to the node with the freshest non-corrupted copy
        (allocation-id match, then max_seqno, then commit generation);
        corrupted-everywhere refuses loudly; no-copy-anywhere falls back
        to balance with an explicit unassigned_reason.
      * ReplicaShardAllocator (``decide_unassigned`` +
        ``cancel_replaceable_recoveries``): replicas prefer nodes with
        reusable on-disk data, and an in-flight empty-store recovery is
        cancelled when a node holding a real copy rejoins.
      * Started-copy reconcile (``cluster_changed`` verify loop): a
        STARTED-routed copy whose host process rebooted is verified
        against what the host actually has — no local store at all fails
        the copy so it reallocates; until verified, cluster health must
        not claim green (health_unverified).

    Scope notes: the unverified-copy marks live on the ELECTED MASTER
    only, so ``_cluster/health`` is a master-routed action
    (Client.cluster_health_async forwards non-master requests over
    transport, like the reference's TransportClusterHealthAction) — the
    gate is authoritative cluster-wide; a node's locally-computed sync
    health remains a local view. And a freshly-elected master marks every STARTED copy
    unverified on its first committed state (it has no prior ephemeral
    observations), so routine failovers flash health not-green for about
    one fetch round trip until the live answers land — conservative by
    design; ROADMAP records the soft-mark refinement.
    """

    FETCH_TIMEOUT = 10.0
    VERIFY_RETRY_DELAY = 0.5
    # a failed fetch (node unreachable / timed out) is retried after this
    # long — an error entry must never become a permanent "no copy here"
    # verdict for a node that is still a cluster member
    FETCH_ERROR_RETRY = 5.0
    # how long an unassigned shard with a prior identity waits for a
    # copy-holding node to (re)join before the allocator falls back to a
    # balance/empty-store placement (gateway.recover_after_data_nodes +
    # index.unassigned.node_left.delayed_timeout analog): during a full
    # restart the master forms with a quorum while members are still
    # booting — building empty copies in that window wastes recoveries
    # at best and, for primaries, destroys data at worst
    EXISTING_COPY_GRACE = 30.0

    def __init__(self, node_id: str, transport_service, indices_service,
                 state_supplier: Callable[[], ClusterState]):
        self.node_id = node_id
        self.ts = transport_service
        self.indices = indices_service
        self._state = state_supplier
        # bound after Node wires the coordinator/allocation service
        self.coordinator = None
        self.allocation = None
        # (index, shard_id) -> node_id -> fetch result
        self._cache: Dict[Tuple[str, int], Dict[str, Dict[str, Any]]] = {}
        self._pending: Dict[Tuple[str, int], Set[str]] = {}
        # node_id -> last seen ephemeral id (reboot detector)
        self._node_ephemeral: Dict[str, str] = {}
        # (index, shard_id, node_id) -> {"primary", "allocation_id"} for
        # STARTED copies awaiting proof their host still serves them
        self._unverified: Dict[Tuple[str, int, str], Dict[str, Any]] = {}
        # nodes with a verify poll loop currently running (one per node)
        self._verifying_nodes: Set[str] = set()
        # per-shard fallback deadlines (EXISTING_COPY_GRACE bookkeeping)
        self._fallback_grace: Dict[Tuple, float] = {}
        self._reroute_queued = False
        self.stats: Dict[str, int] = {
            "fetches_issued": 0, "responses_received": 0,
            "fetch_errors": 0, "cache_hits": 0,
            "reported_none": 0, "reported_corrupted": 0,
            "reported_stale": 0, "verify_fetches": 0,
            "reconcile_failures": 0, "recoveries_cancelled": 0,
            "fallback_empty_allocations": 0,
            "grace_released_fleet_complete": 0,
            "lease_covered_allocations": 0,
        }
        self.ts.register_handler(GATEWAY_STARTED_SHARDS,
                                 self._on_list_started_shards)

    def bind(self, coordinator, allocation) -> None:
        self.coordinator = coordinator
        self.allocation = allocation

    # ------------------------------------------------------------------
    # node side: answer from local stores
    # ------------------------------------------------------------------

    def _on_list_started_shards(self, req: Dict[str, Any], sender: str
                                ) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for spec in req.get("shards", []):
            index, sid = spec["index"], int(spec["shard"])
            out[_shard_key_str(index, sid)] = self._local_info(
                index, sid, spec.get("uuid"))
        return {"shards": out}

    def _local_info(self, index: str, sid: int,
                    index_uuid: Optional[str]) -> Dict[str, Any]:
        info: Dict[str, Any] = {
            "node": self.node_id, "live": False, "has_data": False,
            "allocation_id": None, "generation": -1, "max_seqno": -1,
            "local_checkpoint": -1, "corrupted": None, "verified": False,
        }
        if self.indices.has_shard(index, sid):
            shard = self.indices.shard(index, sid)
            if not shard.engine.failed:
                info.update(
                    live=True, has_data=True,
                    allocation_id=shard.allocation_id,
                    max_seqno=shard.engine.tracker.max_seqno,
                    local_checkpoint=shard.engine.tracker.checkpoint,
                    verified=True)
                if shard.primary and shard.tracker is not None:
                    # lease/history watermarks ride the fetch: the
                    # allocator can prefer replica nodes this primary
                    # still retains ops-based catch-up history for
                    info.update(
                        primary=True,
                        lease_nodes=sorted(
                            lease.id.split("/", 1)[1]
                            for lease in shard.tracker.leases()
                            if lease.id.startswith("peer_recovery/")),
                        history_floor=shard.engine.history_stats()[
                            "history_min_seqno"])
                return info
        disk = self.indices.local_shard_state(index_uuid, sid)
        if disk is not None:
            info.update(disk)
        return info

    # ------------------------------------------------------------------
    # master side: fetch cache
    # ------------------------------------------------------------------

    def fetch_data(self, shard: ShardRouting, state: ClusterState
                   ) -> Optional[Dict[str, Dict[str, Any]]]:
        """Completed per-node results for this shard, or None while any
        fetch is in flight (AsyncShardFetch.fetchData semantics: the
        allocator leaves the shard unassigned this round and a completed
        fetch triggers the next reroute)."""
        key = (shard.index, shard.shard_id)
        data_nodes = set(state.data_nodes())
        results = self._cache.setdefault(key, {})
        pending = self._pending.setdefault(key, set())
        missing = sorted(data_nodes - set(results) - pending)
        if missing:
            try:
                uuid = state.metadata.index(shard.index).uuid
            except Exception:  # noqa: BLE001 — index deleted mid-flight
                return None
            for nid in missing:
                pending.add(nid)
                self._send_fetch(nid, [(key, uuid)])
        if pending & data_nodes:
            return None
        self.stats["cache_hits"] += 1
        return {nid: results[nid] for nid in data_nodes if nid in results}

    def prefetch(self, shards, state: ClusterState) -> None:
        """Batch the missing fetches for MANY unassigned shards into one
        request per node (the protocol is multi-shard for exactly this):
        a full restart's first reroute costs one round trip per data
        node, not shards x nodes."""
        per_node: Dict[str, List[Tuple[Tuple[str, int], str]]] = {}
        data_nodes = set(state.data_nodes())
        for shard in shards:
            if shard.last_allocation_id is None:
                continue
            key = (shard.index, shard.shard_id)
            try:
                uuid = state.metadata.index(shard.index).uuid
            except Exception:  # noqa: BLE001 — index deleted
                continue
            results = self._cache.setdefault(key, {})
            pending = self._pending.setdefault(key, set())
            for nid in sorted(data_nodes - set(results) - pending):
                pending.add(nid)
                per_node.setdefault(nid, []).append((key, uuid))
        for nid in sorted(per_node):
            self._send_fetch(nid, per_node[nid])

    def _send_fetch(self, nid: str,
                    specs: List[Tuple[Tuple[str, int], str]]) -> None:
        """One request to one node covering every spec'd shard; the
        caller has already added ``nid`` to each key's pending set."""
        payload = [{"index": key[0], "shard": key[1], "uuid": uuid}
                   for key, uuid in specs]

        def cb(resp, err, nid=nid) -> None:
            if err is not None or resp is None:
                self.stats["fetch_errors"] += 1
            else:
                self.stats["responses_received"] += 1
            any_completed = False
            for key, _uuid in specs:
                pending = self._pending.get(key)
                if pending is None or nid not in pending:
                    continue   # invalidated while in flight
                pending.discard(nid)
                results = self._cache.setdefault(key, {})
                if err is not None or resp is None:
                    # unreachable node == no usable copy THERE right now —
                    # but only for a while: the entry self-expires so a
                    # slow-but-present member gets re-asked instead of
                    # being permanently recorded as copyless
                    entry = {
                        "node": nid, "live": False, "has_data": False,
                        "allocation_id": None, "corrupted": None,
                        "verified": False, "error": str(err)}
                    results[nid] = entry

                    def expire(key=key, nid=nid, entry=entry) -> None:
                        if self._cache.get(key, {}).get(nid) is entry:
                            del self._cache[key][nid]
                            self._request_reroute("fetch error retry")
                    self.ts.transport.scheduler.schedule(
                        self.FETCH_ERROR_RETRY, expire)
                else:
                    info = resp.get("shards", {}).get(
                        _shard_key_str(*key)) or {
                            "node": nid, "live": False, "has_data": False,
                            "allocation_id": None, "corrupted": None,
                            "verified": False}
                    results[nid] = info
                    # counted HERE, once per node report — decision
                    # passes re-read the cache arbitrarily often and
                    # must not inflate the counters
                    if info.get("has_data") and info.get("corrupted"):
                        self.stats["reported_corrupted"] += 1
                    elif not info.get("has_data"):
                        self.stats["reported_none"] += 1
                if not pending:
                    any_completed = True
            if any_completed:
                self._request_reroute("fetch completed")

        self.stats["fetches_issued"] += 1
        self.ts.send_request(nid, GATEWAY_STARTED_SHARDS,
                             {"shards": payload}, cb,
                             timeout=self.FETCH_TIMEOUT)

    def invalidate_node_entry(self, index: str, shard_id: int,
                              node_id: Optional[str]) -> None:
        """A copy on this node just failed: whatever the cache says about
        that node is stale (a corruption marker may exist now)."""
        if node_id is None:
            return
        self._cache.get((index, shard_id), {}).pop(node_id, None)

    def invalidate_all(self) -> None:
        """Operator escape hatch (reroute?retry_failed): markers may have
        been cleared; refetch everything."""
        self._cache.clear()
        self._pending.clear()

    def _drop_node_entries(self, nid: str) -> None:
        for key in list(self._cache):
            self._cache[key].pop(nid, None)
        for key in list(self._pending):
            self._pending[key].discard(nid)

    def _request_reroute(self, why: str) -> None:
        coord, allocation = self.coordinator, self.allocation
        if coord is None or allocation is None or \
                coord.mode != Mode.LEADER or self._reroute_queued:
            return
        self._reroute_queued = True

        def done(_err) -> None:
            self._reroute_queued = False
        coord.submit_state_update(f"gateway-reroute ({why})",
                                  allocation.reroute, done)

    # ------------------------------------------------------------------
    # master side: membership changes + started-copy reconcile
    # ------------------------------------------------------------------

    def cluster_changed(self, state: ClusterState) -> None:
        """Called on the elected master for every committed state: keep
        the fetch cache honest across join/leave, and kick off
        verification of STARTED copies on rebooted hosts."""
        live = set(state.nodes)
        for nid in list(self._node_ephemeral):
            if nid not in live:
                del self._node_ephemeral[nid]
                self._drop_node_entries(nid)
        for nid, dnode in state.nodes.items():
            seen = self._node_ephemeral.get(nid)
            eph = dnode.ephemeral_id or ""
            if seen is None or seen != eph:
                self._node_ephemeral[nid] = eph
                # a new process behind a known name: its disks may say
                # anything now — refetch, and verify its STARTED copies.
                # seen None = THIS MASTER is fresh (no prior ephemeral
                # observations), not evidence the node rebooted: mark
                # SOFT — verified in the background, but health only
                # loses green after a fetch response actually says
                # not-live, so routine failovers don't flash yellow for
                # a round trip. seen != eph = a real reboot: hard mark.
                self._drop_node_entries(nid)
                if dnode.is_data:
                    self._mark_unverified(state, nid, soft=seen is None)
                    # shards still being decided must hear from the
                    # newcomer too: its disk may hold the copy an
                    # in-flight empty-store build should yield to
                    self._fetch_node_into_live_keys(state, nid)
        # prune verification marks that no longer match routing
        for key3 in list(self._unverified):
            index, sid, nid = key3
            entry = self._unverified[key3]
            sr = self._find_started(state, index, sid, nid,
                                    entry.get("allocation_id"))
            if sr is None:
                del self._unverified[key3]
        # prune cache entries for shard groups with nothing left to decide
        for key in list(self._cache):
            index, sid = key
            if not state.routing_table.has_index(index):
                self._cache.pop(key, None)
                self._pending.pop(key, None)
                continue
            try:
                group = state.routing_table.index(index).shard_group(sid)
            except Exception:  # noqa: BLE001 — shard count changed
                self._cache.pop(key, None)
                self._pending.pop(key, None)
                continue
            if all(sr.state == ShardState.STARTED for sr in group):
                self._cache.pop(key, None)
                self._pending.pop(key, None)
        for gkey in list(self._fallback_grace):
            index, sid = gkey[0], gkey[1]
            try:
                group = state.routing_table.index(index).shard_group(sid)
            except Exception:  # noqa: BLE001 — index/shard gone
                del self._fallback_grace[gkey]
                continue
            if not any(sr.state == ShardState.UNASSIGNED for sr in group):
                del self._fallback_grace[gkey]

    def _fetch_node_into_live_keys(self, state: ClusterState,
                                   nid: str) -> None:
        specs: List[Tuple[Tuple[str, int], str]] = []
        for key in list(self._cache):
            if nid in self._cache[key] or \
                    nid in self._pending.get(key, set()):
                continue
            try:
                uuid = state.metadata.index(key[0]).uuid
            except Exception:  # noqa: BLE001 — index deleted
                continue
            self._pending.setdefault(key, set()).add(nid)
            specs.append((key, uuid))
        if specs:
            self._send_fetch(nid, specs)

    def leader_stepdown(self) -> None:
        """This node is no longer master: its fetch/verify bookkeeping is
        no longer authoritative (the new master rebuilds its own)."""
        self._cache.clear()
        self._pending.clear()
        self._unverified.clear()
        self._verifying_nodes.clear()
        self._node_ephemeral.clear()
        self._fallback_grace.clear()

    @staticmethod
    def _find_started(state: ClusterState, index: str, sid: int,
                      nid: str, allocation_id: Optional[str]
                      ) -> Optional[ShardRouting]:
        if not state.routing_table.has_index(index):
            return None
        try:
            group = state.routing_table.index(index).shard_group(sid)
        except Exception:  # noqa: BLE001
            return None
        for sr in group:
            if sr.state == ShardState.STARTED and sr.node_id == nid and \
                    (allocation_id is None or
                     sr.allocation_id == allocation_id):
                return sr
        return None

    def _mark_unverified(self, state: ClusterState, nid: str,
                         soft: bool = False) -> None:
        """``soft``: the mark drives verification fetches but does NOT
        veto cluster health until the first fetch response reports the
        copy not-live (then it hardens). Used by a freshly-elected
        master, which has no prior ephemeral observation to distinguish
        a routine failover from a member reboot."""
        added = False
        for sr in state.routing_table.shards_on_node(nid):
            if sr.state != ShardState.STARTED or sr.node_id != nid:
                continue
            key3 = (sr.index, sr.shard_id, nid)
            if key3 in self._unverified:
                continue
            self._unverified[key3] = {"primary": sr.primary,
                                      "allocation_id": sr.allocation_id,
                                      "soft": soft}
            added = True
        if added and nid not in self._verifying_nodes:
            # ONE poll loop per node, covering all its marked shards in
            # a single batched request per round — a rebooted host busy
            # re-opening stores must not be hammered per shard
            self._verifying_nodes.add(nid)
            self._send_verify_batch(nid)

    def _send_verify_batch(self, nid: str) -> None:
        coord = self.coordinator
        keys = [k for k in self._unverified if k[2] == nid]
        if coord is None or coord.mode != Mode.LEADER or not keys:
            self._verifying_nodes.discard(nid)
            return
        state = self._state()
        specs: List[Dict[str, Any]] = []
        spec_keys: List[Tuple[str, int, str]] = []
        for key3 in keys:
            index, sid, _n = key3
            try:
                uuid = state.metadata.index(index).uuid
            except Exception:  # noqa: BLE001 — index deleted
                self._unverified.pop(key3, None)
                continue
            specs.append({"index": index, "shard": sid, "uuid": uuid})
            spec_keys.append(key3)
        if not specs:
            self._verifying_nodes.discard(nid)
            return
        self.stats["verify_fetches"] += 1

        def retry() -> None:
            self.ts.transport.scheduler.schedule(
                self.VERIFY_RETRY_DELAY,
                lambda: self._send_verify_batch(nid))

        def cb(resp, err) -> None:
            if self.coordinator is None or \
                    self.coordinator.mode != Mode.LEADER:
                self._verifying_nodes.discard(nid)
                return
            if err is not None or resp is None:
                # host unreachable: keep polling — if it left for good
                # the membership change prunes the marks
                retry()
                return
            for key3 in spec_keys:
                entry = self._unverified.get(key3)
                if entry is None:
                    continue
                index, sid, _n = key3
                info = resp.get("shards", {}).get(
                    _shard_key_str(index, sid)) or {}
                if info.get("live"):
                    del self._unverified[key3]   # verified: copy served
                    continue
                # first not-live fetch RESPONSE: a soft (election-time)
                # mark hardens — from here the copy vetoes health green
                # exactly like a reboot-observed mark
                entry["soft"] = False
                if info.get("has_data") and not info.get("corrupted"):
                    # the host holds a commit but hasn't re-opened it
                    # yet (in-place recovery in progress): poll on
                    continue
                else:
                    # no local store (or a corruption-marked one): the
                    # STARTED routing is a lie — fail the copy so
                    # allocation can put it on a node that actually has
                    # (or can rebuild) the data
                    reason = (
                        f"gateway reconcile: node [{nid}] reports a "
                        f"corruption-marked copy: {info.get('corrupted')}"
                        if info.get("corrupted") else
                        f"gateway reconcile: node [{nid}] holds no "
                        f"local copy for a STARTED shard")
                    del self._unverified[key3]
                    self.stats["reconcile_failures"] += 1
                    self._submit_reconcile_failure(key3, entry, reason)
            if any(k[2] == nid for k in self._unverified):
                retry()
            else:
                self._verifying_nodes.discard(nid)

        self.ts.send_request(nid, GATEWAY_STARTED_SHARDS,
                             {"shards": specs}, cb,
                             timeout=self.FETCH_TIMEOUT)

    def _submit_reconcile_failure(self, key3: Tuple[str, int, str],
                                  entry: Dict[str, Any],
                                  reason: str) -> None:
        index, sid, nid = key3
        coord, allocation = self.coordinator, self.allocation
        if coord is None or allocation is None:
            return

        def update(current: ClusterState) -> ClusterState:
            sr = self._find_started(current, index, sid, nid,
                                    entry.get("allocation_id"))
            if sr is None:
                return current
            # not an allocation failure: must not consume the
            # MaxRetryDecider budget (same as a node-left drop)
            return allocation.apply_failed_shard(
                current, sr, count_failure=False, reason=reason)
        coord.submit_state_update(
            f"gateway-reconcile-failed [{index}][{sid}] on [{nid}]",
            update)

    def note_started(self, sr: ShardRouting) -> None:
        """A started report for this copy doubles as verification."""
        self._unverified.pop((sr.index, sr.shard_id, sr.node_id), None)

    def health_unverified(self) -> List[Dict[str, Any]]:
        """STARTED copies this master has not yet confirmed are actually
        hosted — cluster health treats them as not-active so a rebooted
        host can't hide behind stale green routing. Soft (election-time)
        marks are excluded: they only veto health after a fetch response
        has actually said not-live (at which point they harden)."""
        coord = self.coordinator
        if coord is None or coord.mode != Mode.LEADER:
            return []
        return [{"index": index, "shard": sid, "node": nid,
                 "primary": entry.get("primary", False)}
                for (index, sid, nid), entry in self._unverified.items()
                if not entry.get("soft")]

    def stats_snapshot(self) -> Dict[str, Any]:
        """Counters + gauge snapshot, safe to call from any thread (the
        REST/stats path races the dispatch thread over TCP): retried over
        the rare mid-mutation iteration."""
        for _ in range(3):
            try:
                out: Dict[str, Any] = dict(self.stats)
                out["inflight_fetches"] = sum(
                    len(p) for p in list(self._pending.values()))
                out["cached_shards"] = len(self._cache)
                out["unverified_started_shards"] = len(self._unverified)
                out["unverified_soft"] = sum(
                    1 for e in list(self._unverified.values())
                    if e.get("soft"))
                return out
            except RuntimeError:   # dict changed size during iteration
                continue
        out = dict(self.stats)
        out["inflight_fetches"] = -1
        out["cached_shards"] = len(self._cache)
        out["unverified_started_shards"] = len(self._unverified)
        out["unverified_soft"] = -1
        return out

    def describe(self, index: str, shard_id: int) -> Optional[Dict[str, Any]]:
        """Fetch-cache view for one shard (allocation-explain surface).
        Same cross-thread read discipline as stats_snapshot: the REST
        thread copies dicts the dispatch thread mutates."""
        key = (index, shard_id)
        if key not in self._cache and key not in self._pending:
            return None
        for _ in range(3):
            try:
                return {"nodes": dict(self._cache.get(key, {})),
                        "pending": sorted(self._pending.get(key, set()))}
            except RuntimeError:   # changed size during iteration
                continue
        return {"nodes": {}, "pending": []}

    # ------------------------------------------------------------------
    # master side: allocation decisions (Primary/ReplicaShardAllocator)
    # ------------------------------------------------------------------

    def decide_unassigned(self, shard: ShardRouting, state: ClusterState,
                          allocation) -> Tuple[str, Optional[str]]:
        """Decision for one unassigned shard with a prior identity.

        Returns one of ("wait", None) — fetch in flight or target
        throttled; ("allocate", node_id) — place on this node;
        ("refuse", reason) — stay unassigned, loudly; ("fallback",
        reason_or_None) — no existing-copy opinion, use balance.
        """
        data = self.fetch_data(shard, state)
        if data is None:
            return ("wait", None)
        data_nodes = state.data_nodes()
        corrupted = [i for i in data.values()
                     if i.get("has_data") and i.get("corrupted")]
        # for a REPLICA, the live primary's fetched entry carries its
        # lease/history watermarks: a candidate node whose copy is still
        # lease-covered (checkpoint+1 inside the primary's retained
        # history) recovers ops-based — prefer it over a fresher-looking
        # copy that would pay the wipe (ReplicaShardAllocator's
        # matching-files preference, op-shaped)
        lease_nodes: Set[str] = set()
        history_floor: Optional[int] = None
        if not shard.primary:
            for info in data.values():
                if info.get("live") and info.get("primary"):
                    lease_nodes = set(info.get("lease_nodes") or [])
                    history_floor = info.get("history_floor")
                    break
        viable: List[Tuple[bool, bool, int, int, str]] = []
        for nid in sorted(data):
            info = data[nid]
            if nid not in data_nodes or not info.get("has_data") or \
                    info.get("corrupted"):
                continue
            lease_covered = nid in lease_nodes and (
                history_floor is None or
                int(info.get("local_checkpoint", -1) or -1) + 1 >=
                int(history_floor))
            viable.append((
                info.get("allocation_id") is not None and
                info.get("allocation_id") == shard.last_allocation_id,
                lease_covered,
                int(info.get("max_seqno", -1) or -1),
                int(info.get("generation", -1) or -1),
                nid))
        # freshest first: identity match, then lease coverage, then
        # seqno, then commit generation; node id breaks ties
        # deterministically
        viable.sort(key=lambda t: (not t[0], not t[1], -t[2], -t[3], t[4]))

        throttled = False
        for rank, (match, covered, seqno, gen, nid) in enumerate(viable):
            from elasticsearch_tpu_torch.cluster.allocation import Decision
            verdict = allocation.decide(shard, data_nodes[nid], state)
            if verdict == Decision.YES:
                self.stats["reported_stale"] += len(viable) - rank - 1
                if covered:
                    self.stats["lease_covered_allocations"] += 1
                self._fallback_grace.pop(self._grace_key(shard), None)
                return ("allocate", nid)
            if verdict == Decision.THROTTLE:
                throttled = True
        if throttled:
            return ("wait", None)

        if shard.primary:
            if viable:
                # HEALTHY copy-holders exist but every decider said NO —
                # report that, never a (wrong) all-corrupted verdict
                return ("refuse",
                        "existing-copy nodes rejected by allocation "
                        "deciders (gateway fetch)")
            if corrupted:
                return ("refuse",
                        f"cannot allocate primary: all "
                        f"{len(corrupted)} on-disk copies are "
                        f"corruption-marked (gateway fetch)")
            if not self._grace_elapsed(shard, state):
                return ("wait", None)
            if not (shard.unassigned_reason or "").startswith(
                    "no on-disk copy"):
                # first fallback for this copy only — a shard that can't
                # place re-enters here every reroute pass
                self.stats["fallback_empty_allocations"] += 1
            return ("fallback",
                    f"no on-disk copy found on any of {len(data)} data "
                    f"node(s) (gateway fetch); allocating as empty")
        # replicas rebuild from the primary anyway: no copy (or decider
        # NO) eventually means plain balance placement — but only after
        # the grace window, so a booting copy-holder gets its chance.
        # If the copy's last-known identity already reported in (e.g.
        # corruption-marked after a failover), there is nothing to wait
        # FOR: rebuild immediately.
        located = any(
            i.get("has_data") and i.get("allocation_id") is not None and
            i.get("allocation_id") == shard.last_allocation_id
            for i in data.values())
        if not located and not self._grace_elapsed(shard, state):
            return ("wait", None)
        return ("fallback", None)

    def _grace_key(self, shard: ShardRouting) -> Tuple:
        return (shard.index, shard.shard_id, shard.primary,
                shard.last_allocation_id)

    def _grace_elapsed(self, shard: ShardRouting,
                       state: Optional[ClusterState] = None) -> bool:
        """First fallback-eligible sighting starts the clock; the timer
        re-kicks a reroute when it runs out. The clock applies no matter
        what THIS node's storage looks like — a diskless dedicated
        master must still wait for disk-backed data nodes to finish
        booting before it builds empty copies.

        ``gateway.expected_data_nodes`` (dynamic) short-circuits the
        clock: reaching this decision point means every CURRENT data
        node already answered the shard-state fetch, so once the
        configured member count has reported in there is no absent
        copy-holder left to wait for — allocation releases immediately
        instead of sitting out the rest of the 30s window. 0 disables
        the check; the grace clock stays the fallback."""
        scheduler = self.ts.transport.scheduler
        now = scheduler.now()
        if state is not None:
            expected = self._expected_data_nodes(state)
            if expected > 0 and len(state.data_nodes()) >= expected:
                if self._fallback_grace.pop(self._grace_key(shard),
                                            None) is not None:
                    self.stats["grace_released_fleet_complete"] += 1
                return True
        key = self._grace_key(shard)
        deadline = self._fallback_grace.get(key)
        if deadline is None:
            self._fallback_grace[key] = now + self.EXISTING_COPY_GRACE
            scheduler.schedule(
                self.EXISTING_COPY_GRACE + 0.01,
                lambda: self._request_reroute("copy grace elapsed"))
            return False
        return now >= deadline

    @staticmethod
    def _expected_data_nodes(state: ClusterState) -> int:
        from elasticsearch_tpu_torch.utils.settings import (
            GATEWAY_EXPECTED_DATA_NODES, setting_from_state,
        )
        # default 0 = disabled: fail toward the grace-clock fallback
        return setting_from_state(state, GATEWAY_EXPECTED_DATA_NODES)

    def cancel_replaceable_recoveries(self, state: ClusterState, routing,
                                      allocation):
        """ReplicaShardAllocator.processExistingRecoveries analog: an
        INITIALIZING replica building an empty store from scratch is
        cancelled when a node holding that copy's actual data (matching
        allocation id, no marker) has rejoined — re-syncing a real copy
        is strictly cheaper than finishing the from-zero build. Returns
        (routing, n_cancelled)."""
        from dataclasses import replace as _replace

        from elasticsearch_tpu_torch.cluster.allocation import Decision
        cancelled = 0
        data_nodes = state.data_nodes()
        for sr in list(routing.all_shards()):
            if sr.state != ShardState.INITIALIZING or sr.primary or \
                    sr.last_allocation_id is None:
                continue
            results = self._cache.get((sr.index, sr.shard_id))
            if not results:
                continue
            assigned_info = results.get(sr.node_id)
            if assigned_info is None or assigned_info.get("has_data"):
                # unknown, or the target already holds (some) data:
                # leave the recovery alone
                continue
            for nid in sorted(results):
                info = results[nid]
                if nid == sr.node_id or nid not in data_nodes:
                    continue
                if not info.get("has_data") or info.get("corrupted"):
                    continue
                if info.get("allocation_id") != sr.last_allocation_id:
                    continue
                probe = ShardRouting(
                    index=sr.index, shard_id=sr.shard_id, primary=False,
                    last_allocation_id=sr.last_allocation_id)
                st = state.next_version(routing_table=routing)
                if allocation.decide(probe, data_nodes[nid],
                                     st) != Decision.YES:
                    continue
                dropped = _replace(
                    sr.fail(f"recovery cancelled: node [{nid}] rejoined "
                            f"with a reusable copy (gateway fetch)"),
                    failed_attempts=sr.failed_attempts,
                    last_allocation_id=sr.last_allocation_id)
                routing = routing.put_index(
                    routing.index(sr.index).replace_shard(sr, dropped))
                cancelled += 1
                self.stats["recoveries_cancelled"] += 1
                break
        return routing, cancelled
