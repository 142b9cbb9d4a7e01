"""Node composition: wire every service together and manage lifecycle.

Reference analog: node/Node.java:273 (constructor builds ~60 services) and
Node.start():708 (ordered startup: indices → transport → discovery/
coordination → API). The NodeClient mirrors client/node/NodeClient.java:43 —
the typed in-process facade the REST layer calls.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional

from elasticsearch_tpu_torch.action.admin import (
    BroadcastActions, CLUSTER_HEALTH_ACTION, CLUSTER_UPDATE_SETTINGS,
    CREATE_INDEX, DELETE_INDEX,
    FLUSH_SHARD, FORCEMERGE_SHARD, MasterActions, MasterClient,
    NODE_STATS_ACTION, PUT_MAPPING,
    REFRESH_SHARD, STATS_SHARD, UPDATE_ALIASES, UPDATE_SETTINGS,
    cluster_health,
)
from elasticsearch_tpu_torch.action.bulk import TransportBulkAction
from elasticsearch_tpu_torch.action.document import (
    TransportGetAction, TransportUpdateAction,
)
from elasticsearch_tpu_torch.action.replication import TransportShardBulkAction
from elasticsearch_tpu_torch.action.search_action import (
    SearchTransportService, TransportSearchAction,
)
from elasticsearch_tpu_torch.cluster.allocation import AllocationService
from elasticsearch_tpu_torch.cluster.coordination import (
    Coordinator, CoordinatorSettings, Mode,
)
from elasticsearch_tpu_torch.cluster.metadata import resolve_index_expression
from elasticsearch_tpu_torch.cluster.state import ClusterState, DiscoveryNode, Roles
from elasticsearch_tpu_torch.indices.cluster_state_service import (
    IndicesClusterStateService,
)
from elasticsearch_tpu_torch.indices.indices_service import IndicesService
from elasticsearch_tpu_torch.transport.scheduler import Scheduler
from elasticsearch_tpu_torch.transport.transport import (
    InMemoryTransport, TransportService,
)
from elasticsearch_tpu_torch.utils.errors import (
    IllegalArgumentError, SearchEngineError,
)

logger = logging.getLogger(__name__)


class Node:
    def __init__(self, node_id: str, transport: InMemoryTransport,
                 scheduler: Scheduler,
                 seed_peers: Optional[List[str]] = None,
                 roles: Optional[List[str]] = None,
                 data_path: Optional[str] = None,
                 initial_state: Optional[ClusterState] = None,
                 coordinator_settings: Optional[CoordinatorSettings] = None,
                 mesh_data_plane: bool = False,
                 mesh_slots: Optional[int] = None,
                 transport_service=None,
                 disk_io=None,
                 device=None):
        self.node_id = node_id
        # where this node's shards, its coordinator rewrite, its fusion
        # kernel and its ingest models run: None = the CUDA card (an
        # error when there is none), "cpu" = the kernels' plain versions
        from elasticsearch_tpu_torch.device import resolve_device
        self.device = resolve_device(device)
        self.scheduler = scheduler
        import uuid as _uuid
        self.discovery_node = DiscoveryNode(
            node_id=node_id, name=node_id,
            roles=frozenset(roles) if roles else frozenset(Roles.ALL),
            ephemeral_id=_uuid.uuid4().hex)

        # the wire is pluggable: in-memory (simulation / single process) or
        # an injected TcpTransportService (transport/tcp.py) for clusters
        # spanning OS processes — both honor the same service contract
        self.transport_service = transport_service or \
            TransportService(node_id, transport)
        self.indices_service = IndicesService(data_path=data_path,
                                              disk_io=disk_io,
                                              node_id=node_id,
                                              device=self.device)
        self.allocation_service = AllocationService()

        # gateway allocation (gateway.py GatewayAllocator): every node
        # answers the _list_gateway_started_shards fetch from its local
        # stores; the elected master uses the results to put restarted
        # shards back on the nodes that actually hold their data
        from elasticsearch_tpu_torch.gateway import GatewayAllocator
        self.gateway_allocator = GatewayAllocator(
            node_id, self.transport_service, self.indices_service,
            self._applied_state)
        self.allocation_service.gateway_allocator = self.gateway_allocator

        initial_state = initial_state or ClusterState()
        persisted_state = None
        if data_path is not None:
            # gateway: boot from the durably persisted term + accepted
            # state (GatewayMetaState analog); shards themselves recover
            # from their local stores when the reconciler applies state
            from elasticsearch_tpu_torch.gateway import GatewayMetaState
            # data_path is already per-node (callers namespace it)
            persisted_state = GatewayMetaState(data_path).load_or_create(
                initial_state)
        self.coordinator = Coordinator(
            self.discovery_node, self.transport_service, scheduler,
            initial_state, settings=coordinator_settings,
            seed_peers=seed_peers, on_committed=self._on_committed,
            persisted_state=persisted_state)
        self.gateway_allocator.bind(self.coordinator,
                                    self.allocation_service)

        self.reconciler = IndicesClusterStateService(
            node_id, self.indices_service, self.transport_service)
        self.master_actions = MasterActions(
            self.coordinator, self.allocation_service, self.transport_service)
        self.master_client = MasterClient(self.transport_service,
                                          self.coordinator)

        from elasticsearch_tpu_torch.ingest import IngestService
        self.ingest_service = IngestService(self._applied_state, node=self)

        from elasticsearch_tpu_torch.tasks import TaskManager
        self.task_manager = TaskManager(
            node_id, now_ms=lambda: scheduler.now() * 1000)
        self.task_results: Dict[str, Any] = {}

        from elasticsearch_tpu_torch.utils.threadpool import ThreadPoolService
        # scheduler-clocked: the Little's-law frame measurement (and the
        # Retry-After rates derived from it) then work identically under
        # the deterministic virtual-time harness and production
        self.thread_pool = ThreadPoolService(now_fn=scheduler.now)

        self.shard_bulk = TransportShardBulkAction(
            node_id, self.indices_service, self.transport_service, scheduler,
            self._applied_state, thread_pool=self.thread_pool,
            # lazy: both services are constructed below, after this action
            node_pressure=lambda: self.search_transport.batcher.node_pressure,
            response_collector=lambda: self.search_action.response_collector)
        self.bulk_action = TransportBulkAction(
            self.shard_bulk, self._applied_state, self._auto_create_index,
            ingest_service=self.ingest_service,
            thread_pool=self.thread_pool)
        self.get_action = TransportGetAction(
            node_id, self.indices_service, self.transport_service,
            self._applied_state)
        self.update_action = TransportUpdateAction(self.get_action,
                                                   self.bulk_action)
        self.search_transport = SearchTransportService(
            node_id, self.indices_service, self.transport_service,
            task_manager=self.task_manager,
            state_supplier=self._applied_state)
        self.mesh_plane = None
        if mesh_data_plane:
            # the one-program data plane (SURVEY §5.8's two-plane split):
            # the sharded programs over S = mesh_slots slots on the node's
            # device (None: DEFAULT_SLOTS, the JAX package's node layout)
            from elasticsearch_tpu_torch.parallel.mesh_plane import (
                DEFAULT_SLOTS, MeshDataPlane,
            )
            self.mesh_plane = MeshDataPlane(
                n_slots=mesh_slots or DEFAULT_SLOTS, device=self.device)
            # explicit mesh opt-in: bring the backend up at BOOT so the
            # first search finds the mesh ready instead of silently
            # serving the RPC fallback until other compute initializes it
            self.mesh_plane.warmup()
        # search.mesh.warmup_at_boot: pay device first-init NOW (the
        # mesh-sharded plane's mesh_ready() refuses to inside a search,
        # so the first eligible search per process otherwise takes the
        # RPC detour). Checked once more when the setting appears in a
        # later committed state (dynamic settings land after boot).
        self._mesh_warmed = False
        self._maybe_mesh_warmup(self._applied_state())
        from elasticsearch_tpu_torch.transport.remote import RemoteClusterService
        self.remote_clusters = RemoteClusterService(self)
        self.search_action = TransportSearchAction(
            node_id, self.transport_service, self._applied_state,
            task_manager=self.task_manager, indices=self.indices_service,
            mesh_plane=self.mesh_plane, thread_pool=self.thread_pool,
            remote_clusters=self.remote_clusters,
            search_transport=self.search_transport, device=self.device)
        self.broadcast_actions = BroadcastActions(
            node_id, self.indices_service, self.transport_service,
            self._applied_state)

        from elasticsearch_tpu_torch.action.snapshot import (
            SnapshotActions, SnapshotShardActions,
        )
        self.snapshot_shard_actions = SnapshotShardActions(
            self.indices_service, self.transport_service)
        self.snapshot_actions = SnapshotActions(self)

        from elasticsearch_tpu_torch.tasks import TaskActions
        self.task_actions = TaskActions(self)

        from elasticsearch_tpu_torch.action.reindex import ReindexActions
        self.reindex_actions = ReindexActions(self)

        from elasticsearch_tpu_torch.action.misc import MiscReadActions
        self.misc_actions = MiscReadActions(self)

        from elasticsearch_tpu_torch.rankeval import RankEvalAction
        self.rank_eval_action = RankEvalAction(self)

        self.client = NodeClient(self)

        from elasticsearch_tpu_torch.ilm import IndexLifecycleService
        self.ilm_service = IndexLifecycleService(self)
        from elasticsearch_tpu_torch.xpack.slm import SnapshotLifecycleService
        self.slm_service = SnapshotLifecycleService(self)
        from elasticsearch_tpu_torch.persistent import PersistentTasksService
        self.persistent_tasks = PersistentTasksService(self)

        from elasticsearch_tpu_torch.xpack.security import SecurityService
        self.security = SecurityService(self)
        from elasticsearch_tpu_torch.utils.resource_watcher import (
            ResourceWatcherService,
        )
        self.resource_watcher = ResourceWatcherService(self.scheduler)
        if self.security.file_realm.path:
            self.resource_watcher.watch(self.security.file_realm.path,
                                        self.security.file_realm.reload)

        from elasticsearch_tpu_torch.xpack.async_search import AsyncSearchService
        self.async_search = AsyncSearchService(self)

        from elasticsearch_tpu_torch.xpack.sql import SqlService
        self.sql = SqlService(self)

        from elasticsearch_tpu_torch.xpack.transform import TransformService
        self.transform_service = TransformService(self)

        from elasticsearch_tpu_torch.xpack.watcher import WatcherService
        self.watcher_service = WatcherService(self)

        from elasticsearch_tpu_torch.xpack.ccr import CcrService, CcrShardActions
        self.ccr_shard_actions = CcrShardActions(self)
        self.ccr_service = CcrService(self)

        from elasticsearch_tpu_torch.xpack.eql import EqlService
        self.eql = EqlService(self)

        from elasticsearch_tpu_torch.xpack.rollup import RollupService
        self.rollup_service = RollupService(self)

        from elasticsearch_tpu_torch.xpack.enrich import EnrichService
        self.enrich_service = EnrichService(self)

        from elasticsearch_tpu_torch.xpack.graph import GraphService
        self.graph_service = GraphService(self)

        from elasticsearch_tpu_torch.xpack.monitoring import MonitoringService
        self.monitoring_service = MonitoringService(self)

        from elasticsearch_tpu_torch.xpack.searchable_snapshots import (
            SearchableSnapshotsService,
        )
        self.searchable_snapshots = SearchableSnapshotsService(self)

        from elasticsearch_tpu_torch.xpack.ml_jobs import MlJobService
        self.ml_jobs = MlJobService(self)

        from elasticsearch_tpu_torch.xpack.autoscaling import AutoscalingService
        self.autoscaling = AutoscalingService(self)

        from elasticsearch_tpu_torch.action.resize import ResizeActions
        self.resize_actions = ResizeActions(self)

        # per-node stats endpoint (TransportNodesStatsAction node-level
        # handler): the coordinating node fans `_nodes/stats` out here
        self.transport_service.register_handler(
            NODE_STATS_ACTION,
            lambda req, sender: self.local_node_stats(
                sections=(req or {}).get("sections")))
        # master-routed health (TransportClusterHealthAction analog): the
        # unverified-STARTED gate is master-only state, so every node
        # answers health FROM the master's view, not its own
        self.transport_service.register_handler(
            CLUSTER_HEALTH_ACTION, self._on_cluster_health)

    def _on_cluster_health(self, req: Dict[str, Any],
                           sender: str) -> Dict[str, Any]:
        """Answer ONLY while actually the elected master: a node a caller
        still believes is master (stale applied state mid-election) must
        error — the caller then takes its flagged local-view fallback —
        rather than return a stale view dressed up as authoritative."""
        if self.coordinator.mode != Mode.LEADER:
            raise RuntimeError(
                f"[{self.node_id}] is not the elected master")
        state = self._applied_state()
        unverified = self.gateway_allocator.health_unverified()
        if req.get("indices") is not None:
            # bulk form (_cat/indices): every requested index's health in
            # ONE master round trip instead of one RPC per index
            return {"indices": {
                name: cluster_health(state, name, unverified=unverified)
                for name in req["indices"]
                if state.metadata.has_index(name)}}
        return cluster_health(state, req.get("index"),
                              unverified=unverified)

    # ------------------------------------------------------------------

    def _applied_state(self) -> ClusterState:
        return self.coordinator.applied_state

    def local_node_stats(self, sections=None) -> Dict[str, Any]:
        """All stats sections, or — when ``sections`` names some — only
        those, built lazily: a caller merging one section across the
        fleet (``_cluster/stats``'s search_latency view) must not make
        every node walk /proc, the device backend and every shard."""
        from elasticsearch_tpu_torch.indices.breaker import BREAKERS
        from elasticsearch_tpu_torch import monitor

        # the C3 rank inputs serve two sections (adaptive_selection and
        # search_admission.ars) — build them at most once per call
        ars_cache: Dict[str, Any] = {}

        def ars_stats():
            if "v" not in ars_cache:
                ars_cache["v"] = \
                    self.search_action.response_collector.stats()
            return ars_cache["v"]

        builders = {
            "indices": lambda: self.indices_service.stats(),
            "transport": lambda: dict(self.transport_service.stats),
            "breakers": BREAKERS.stats,
            "thread_pool": self.thread_pool.stats,
            "adaptive_selection": ars_stats,
            # overload control plane: adaptive queue bounds, per-tenant
            # rejections, Retry-After values, node pressure + ARS rank
            # inputs (utils/threadpool.py + response_collector.py)
            "search_admission": lambda: monitor.search_admission_stats(
                self.thread_pool,
                batcher=self.search_transport.batcher,
                ars_stats=ars_stats(),
                failover_stats=self.search_action.shard_busy_stats),
            # write-path pressure plane: three-stage in-flight byte
            # accounting, per-stage rejection buckets, Retry-After rates
            # + the primary's replica-retry counters (threadpool.py
            # IndexingPressure + action/replication.py)
            "indexing_pressure": lambda: monitor.indexing_pressure_stats(
                self.thread_pool, shard_bulk=self.shard_bulk),
            # real probes (OsProbe/ProcessProbe/FsProbe analogs + the
            # device/HBM dimension the reference lacks)
            "os": monitor.os_stats,
            "process": monitor.process_stats,
            "fs": lambda: monitor.fs_stats(self.indices_service.data_path),
            "device": monitor.device_stats,
            # packed multi-segment plane residency/rebuild/eviction
            # counters (ops/device_segment.py PlaneRegistry)
            "device_plane": monitor.device_plane_stats,
            # mesh-sharded plane residency + SPMD fan-out executor
            # counters (MeshPlaneRegistry + search/mesh_executor.py)
            "mesh_plane": lambda: monitor.mesh_plane_stats(
                self.search_transport.mesh_executor),
            # cross-query micro-batching occupancy/wait/dispatch/memo/
            # window-controller counters + coordinator RRF fusion batching
            "search_batch": lambda: monitor.search_batch_stats(
                self.search_transport.batcher,
                rrf_fuser=self.search_action.rrf_fuser),
            # two-tier request cache: shard-tier hits/misses/evictions +
            # typed invalidation causes + the coordinator fused-result
            # tier (indices/request_cache.py)
            "request_cache": lambda: monitor.request_cache_stats(
                self.search_transport, self.search_action),
            # per-(query class x data plane) latency histograms + the
            # typed fallback-reason taxonomy (search/telemetry.py)
            "search_latency": monitor.search_latency_stats,
            # device observatory: per-family compile/recompile counters,
            # execute EWMAs, FLOPs estimates + plane-HBM residency
            # timelines (search/device_profile.py + the plane registries)
            "device_profile": monitor.device_profile_stats,
            # gateway shard-state fetch counters (fetches issued, cache
            # hits, copies reported none/corrupted/stale, reconciles)
            "gateway": lambda: monitor.gateway_stats(
                self.gateway_allocator),
            # recovery kinds (ops_based vs wipe-and-copy), replayed-op /
            # byte accounting, typed file-fallback reasons + lease and
            # soft-delete history gauges (cluster_state_service.py)
            "recovery": lambda: monitor.recovery_stats(
                self.reconciler, self.indices_service),
        }
        want = None if sections is None else set(sections)
        out: Dict[str, Any] = {"name": self.node_id}
        for name, build in builders.items():
            if want is None or name in want:
                out[name] = build()
        return out

    def _on_committed(self, state: ClusterState) -> None:
        # appliers are isolated from each other: a reconciler failure (e.g. a
        # shard that can't initialize) must not skip master housekeeping, and
        # vice versa (ClusterApplierService catches per-applier the same way)
        for applier in (self.reconciler.apply_cluster_state,
                        self._master_housekeeping,
                        self._maybe_mesh_warmup):
            try:
                applier(state)
            except Exception:  # noqa: BLE001
                logger.exception("applier %s failed for state v%s on %s",
                                 getattr(applier, "__name__", applier),
                                 state.version, self.node_id)

    def _maybe_mesh_warmup(self, state: ClusterState) -> None:
        """search.mesh.warmup_at_boot applier: the first state (boot or
        committed) that carries the setting pays backend first-init via
        MESH_PLANES.warmup() — once per process, counted in the
        mesh_plane_warmups stat. Off by default: warmup blocks on device
        init, which only a node explicitly opted into mesh serving
        should pay at boot."""
        # getattr: a committed-state applier can fire before __init__
        # reaches the flag assignment
        if getattr(self, "_mesh_warmed", False):
            return
        from elasticsearch_tpu_torch.utils.settings import (
            SEARCH_MESH_WARMUP_AT_BOOT, setting_from_state,
        )
        if not setting_from_state(state, SEARCH_MESH_WARMUP_AT_BOOT):
            return
        self._mesh_warmed = True
        from elasticsearch_tpu_torch.ops.device_segment import MESH_PLANES
        MESH_PLANES.warmup(getattr(self, "device", None))

    def _master_housekeeping(self, state: ClusterState) -> None:
        """On the elected master: clean up routing after membership changes
        (the reference couples this via NodeRemovalClusterStateTaskExecutor
        and reroute listeners)."""
        if self.coordinator.mode != Mode.LEADER:
            # fetch/verify bookkeeping is master-only state
            self.gateway_allocator.leader_stepdown()
            return
        # keep the gateway fetch cache honest across membership changes,
        # and start verifying STARTED copies on rebooted hosts
        self.gateway_allocator.cluster_changed(state)
        dead = {sr.node_id for sr in state.routing_table.all_shards()
                if sr.node_id is not None and sr.node_id not in state.nodes}
        dead |= {sr.relocating_node_id
                 for sr in state.routing_table.all_shards()
                 if sr.relocating_node_id is not None
                 and sr.relocating_node_id not in state.nodes}
        needs_reroute = any(
            sr.state.value == "UNASSIGNED"
            for sr in state.routing_table.all_shards())
        if not dead and not needs_reroute:
            return

        def update(current: ClusterState) -> ClusterState:
            out = current
            dead_now = {sr.node_id
                        for sr in out.routing_table.all_shards()
                        if sr.node_id is not None
                        and sr.node_id not in out.nodes}
            if dead_now:
                out = self.allocation_service.disassociate_dead_nodes(
                    out, dead_now)
            return self.allocation_service.reroute(out)
        self.coordinator.submit_state_update("housekeeping-reroute", update)

    def _auto_create_index(self, name: str,
                           on_done: Callable[[Optional[Exception]], None]
                           ) -> None:
        def cb(resp, err):
            on_done(err)
        self.master_client.execute(
            CREATE_INDEX, {"index": name, "ignore_existing": True,
                           "settings": {"number_of_replicas": 1}}, cb)

    # ------------------------------------------------------------------

    def start(self) -> None:
        # bootstrap checks first (BootstrapChecks.check analog): dev mode
        # warns, ESTPU_ENFORCE_BOOTSTRAP aborts startup on failure
        from elasticsearch_tpu_torch.monitor import run_bootstrap_checks
        run_bootstrap_checks(self.indices_service.data_path)
        self.coordinator.start()
        self.ilm_service.start()
        self.slm_service.start()
        self.resource_watcher.start()
        self.persistent_tasks.start()
        self.transform_service.start()
        self.watcher_service.start()
        self.ccr_service.start()
        self.rollup_service.start()
        self.monitoring_service.start()
        self.ml_jobs.start()

    def stop(self) -> None:
        self.ml_jobs.stop()
        self.monitoring_service.stop()
        self.rollup_service.stop()
        self.ccr_service.stop()
        self.watcher_service.stop()
        self.transform_service.stop()
        self.ilm_service.stop()
        self.slm_service.stop()
        self.resource_watcher.stop()
        self.persistent_tasks.stop()
        self.coordinator.stop()
        self.transport_service.close()
        self.indices_service.close()


class NodeClient:
    """Typed in-process API facade — what the REST layer dispatches to.

    Every method is callback-style ``(args..., on_done(resp, err))`` so the
    same code runs under the deterministic scheduler and production.
    """

    def __init__(self, node: Node):
        self.node = node

    # -- index admin ----------------------------------------------------

    def create_index(self, name: str, body: Optional[Dict[str, Any]],
                     on_done, ignore_templates: bool = False) -> None:
        body = body or {}
        self.node.master_client.execute(CREATE_INDEX, {
            "index": name,
            "settings": body.get("settings") or {},
            "mappings": body.get("mappings") or {},
            "ignore_templates": ignore_templates,
        }, on_done)

    def delete_index(self, name: str, on_done) -> None:
        self.node.master_client.execute(DELETE_INDEX, {"index": name},
                                        on_done)

    def put_mapping(self, name: str, mappings: Dict[str, Any],
                    on_done) -> None:
        self.node.master_client.execute(
            PUT_MAPPING, {"index": name, "mappings": mappings}, on_done)

    def update_settings(self, name: str, settings: Dict[str, Any],
                        on_done) -> None:
        self.node.master_client.execute(
            UPDATE_SETTINGS, {"index": name, "settings": settings}, on_done)

    def update_aliases(self, actions: List[Dict[str, Any]], on_done) -> None:
        self.node.master_client.execute(
            UPDATE_ALIASES, {"actions": actions}, on_done)

    def cluster_update_settings(self, body: Dict[str, Any], on_done) -> None:
        self.node.master_client.execute(CLUSTER_UPDATE_SETTINGS, body,
                                        on_done)

    def get_mapping(self, name: str):
        state = self.node._applied_state()
        meta = state.metadata.index(name)
        return {meta.name: {"mappings": dict(meta.mappings)}}

    # -- index templates / ILM / rollover -------------------------------

    def put_index_template(self, name: str, body: Dict[str, Any],
                           on_done) -> None:
        from elasticsearch_tpu_torch.action.admin import PUT_TEMPLATE
        self.node.master_client.execute(
            PUT_TEMPLATE, {"name": name, "body": body}, on_done)

    def delete_index_template(self, name: str, on_done) -> None:
        from elasticsearch_tpu_torch.action.admin import DELETE_TEMPLATE
        self.node.master_client.execute(
            DELETE_TEMPLATE, {"name": name}, on_done)

    def get_index_templates(self, name: Optional[str] = None
                            ) -> Dict[str, Any]:
        templates = self.node._applied_state().metadata.templates
        if name is not None:
            import fnmatch
            templates = {k: v for k, v in templates.items()
                         if fnmatch.fnmatch(k, name)}
        return {"index_templates": [
            {"name": k, "index_template": dict(v)}
            for k, v in sorted(templates.items())]}

    def put_ilm_policy(self, name: str, body: Dict[str, Any],
                       on_done) -> None:
        from elasticsearch_tpu_torch.action.admin import PUT_ILM_POLICY
        self.node.master_client.execute(
            PUT_ILM_POLICY,
            {"name": name, "policy": (body or {}).get("policy", body)},
            on_done)

    def delete_ilm_policy(self, name: str, on_done) -> None:
        from elasticsearch_tpu_torch.action.admin import DELETE_ILM_POLICY
        self.node.master_client.execute(
            DELETE_ILM_POLICY, {"name": name}, on_done)

    def get_ilm_policies(self) -> Dict[str, Any]:
        return {k: {"policy": dict(v)} for k, v in sorted(
            self.node._applied_state().metadata.ilm_policies.items())}

    def put_slm_policy(self, policy_id: str, body: Dict[str, Any],
                       on_done) -> None:
        from elasticsearch_tpu_torch.action.admin import PUT_CUSTOM
        from elasticsearch_tpu_torch.xpack.slm import SECTION, \
            SnapshotLifecycleService
        body = dict(body or {})
        try:
            SnapshotLifecycleService.validate(body)
        except Exception as e:  # noqa: BLE001 — report as 400
            on_done(None, e)
            return
        # preserve scheduler bookkeeping across policy updates
        prior = self.node.slm_service.policies().get(policy_id, {})
        for k in ("_counter", "_last_run_ms", "_last_success"):
            if k in prior:
                body.setdefault(k, prior[k])
        self.node.master_client.execute(PUT_CUSTOM, {
            "section": SECTION, "name": policy_id, "body": body}, on_done)

    def delete_slm_policy(self, policy_id: str, on_done) -> None:
        from elasticsearch_tpu_torch.action.admin import DELETE_CUSTOM
        from elasticsearch_tpu_torch.xpack.slm import SECTION
        self.node.master_client.execute(DELETE_CUSTOM, {
            "section": SECTION, "name": policy_id}, on_done)

    # -- security ---------------------------------------------------------

    def put_security_user(self, name: str, body: Dict[str, Any],
                          on_done) -> None:
        from elasticsearch_tpu_torch.action.admin import PUT_SECURITY
        from elasticsearch_tpu_torch.xpack.security import hash_password
        raw = dict(body or {})
        password = raw.pop("password", None)
        if password is None:
            # pre-hashed credentials are NOT accepted (the reference's
            # API doesn't either): a stored malformed hash/salt pair
            # would crash every later verification for that user
            on_done(None, IllegalArgumentError(
                f"user [{name}] requires [password]"))
            return
        roles = raw.get("roles", [])
        if not isinstance(roles, list) or \
                not all(isinstance(r, str) for r in roles):
            on_done(None, IllegalArgumentError(
                f"user [{name}] [roles] must be a list of role names"))
            return
        entity = {"roles": roles, **hash_password(str(password))}
        if "full_name" in raw:
            entity["full_name"] = str(raw["full_name"])
        self.node.master_client.execute(
            PUT_SECURITY, {"kind": "users", "name": name, "body": entity},
            on_done)

    def put_security_role(self, name: str, body: Dict[str, Any],
                          on_done) -> None:
        from elasticsearch_tpu_torch.action.admin import PUT_SECURITY
        from elasticsearch_tpu_torch.xpack.security import (
            CLUSTER_PRIVILEGES, INDEX_PRIVILEGES,
        )
        body = dict(body or {})
        bad = set(body.get("cluster", [])) - CLUSTER_PRIVILEGES
        if bad:
            on_done(None, IllegalArgumentError(
                f"unknown cluster privileges {sorted(bad)}"))
            return
        for grant in body.get("indices", []):
            names = grant.get("names")
            if not isinstance(names, list) or not names:
                on_done(None, IllegalArgumentError(
                    "role index grants require [names] as a list"))
                return
            bad = set(grant.get("privileges", [])) - INDEX_PRIVILEGES
            if bad:
                on_done(None, IllegalArgumentError(
                    f"unknown index privileges {sorted(bad)}"))
                return
        self.node.master_client.execute(
            PUT_SECURITY, {"kind": "roles", "name": name,
                           "body": body}, on_done)

    def delete_security_entity(self, kind: str, name: str, on_done) -> None:
        from elasticsearch_tpu_torch.action.admin import DELETE_SECURITY
        self.node.master_client.execute(
            DELETE_SECURITY, {"kind": kind, "name": name}, on_done)

    def get_security_entities(self, kind: str,
                              name: Optional[str] = None) -> Dict[str, Any]:
        section = dict(self.node._applied_state()
                       .metadata.security.get(kind, {}))
        if name is not None:
            section = {k: v for k, v in section.items() if k == name}
        # never expose hashes over the API
        return {k: {kk: vv for kk, vv in v.items()
                    if kk not in ("hash", "salt")}
                for k, v in section.items()}

    def create_data_stream(self, name: str, on_done) -> None:
        from elasticsearch_tpu_torch.action.admin import CREATE_DATA_STREAM
        self.node.master_client.execute(CREATE_DATA_STREAM,
                                        {"name": name}, on_done)

    def delete_data_stream(self, name: str, on_done) -> None:
        from elasticsearch_tpu_torch.action.admin import DELETE_DATA_STREAM
        self.node.master_client.execute(DELETE_DATA_STREAM,
                                        {"name": name}, on_done)

    def get_data_streams(self, name: Optional[str] = None
                         ) -> Dict[str, Any]:
        """GET /_data_stream[/{name}] shape (GetDataStreamAction)."""
        import fnmatch as _fn
        state = self.node._applied_state()
        streams = state.metadata.data_streams
        if name and "*" not in name:
            if name not in streams:
                from elasticsearch_tpu_torch.utils.errors import (
                    IndexNotFoundError,
                )
                raise IndexNotFoundError(name)
            chosen = {name: streams[name]}
        elif name:
            chosen = {k: v for k, v in streams.items()
                      if _fn.fnmatch(k, name)}
        else:
            chosen = streams
        out = []
        for ds_name in sorted(chosen):
            ds = chosen[ds_name]
            out.append({
                "name": ds_name,
                "timestamp_field": ds.get("timestamp_field",
                                          {"name": "@timestamp"}),
                "generation": ds.get("generation", 1),
                "indices": [{"index_name": n}
                            for n in ds.get("indices", [])],
                "status": "GREEN",
            })
        return {"data_streams": out}

    def rollover(self, alias: str, body: Optional[Dict[str, Any]],
                 on_done) -> None:
        """Coordinator half of rollover (TransportRolloverAction): evaluate
        conditions against live stats, then submit the atomic state update.
        No conditions means roll unconditionally."""
        from elasticsearch_tpu_torch.action.admin import (
            ROLLOVER, next_rollover_name,
        )
        from elasticsearch_tpu_torch.utils.errors import IllegalArgumentError
        body = body or {}
        conditions = body.get("conditions") or {}
        unknown = set(conditions) - {"max_age", "max_docs"}
        if unknown:
            # silently ignoring a condition would mean "never rolls" with
            # no signal — reject like an unknown request parameter
            on_done(None, IllegalArgumentError(
                f"unknown rollover conditions {sorted(unknown)}; "
                "supported: max_age, max_docs"))
            return
        state = self.node._applied_state()
        data_stream = state.metadata.data_streams.get(alias)
        try:
            source = state.metadata.index(alias)   # exactly-one resolution
        except Exception as e:  # noqa: BLE001 — not-found / ambiguous
            on_done(None, e)
            return
        if data_stream is None and alias not in source.aliases:
            on_done(None, IllegalArgumentError(
                f"rollover target [{alias}] is a concrete index, not an "
                "alias or data stream"))
            return
        if data_stream is not None:
            from elasticsearch_tpu_torch.action.admin import backing_index_name
            new_index = body.get("new_index") or backing_index_name(
                alias, int(data_stream.get("generation", 1)) + 1)
        else:
            new_index = body.get("new_index") or \
                next_rollover_name(source.name)

        def proceed(met: Dict[str, bool]) -> None:
            if conditions and not any(met.values()):
                on_done({"acknowledged": False, "rolled_over": False,
                         "dry_run": bool(body.get("dry_run")),
                         "conditions": met}, None)
                return
            if body.get("dry_run"):
                on_done({"acknowledged": False, "rolled_over": False,
                         "dry_run": True, "conditions": met}, None)
                return
            request = {
                "new_index": new_index,
                "settings": body.get("settings") or {},
                "mappings": body.get("mappings") or {},
            }
            if data_stream is not None:
                request["data_stream"] = alias
            else:
                request["alias"] = alias
            self.node.master_client.execute(ROLLOVER, request,
                                            lambda resp, err: on_done(
                {**(resp or {}), "old_index": source.name,
                 "conditions": met} if err is None else None, err))

        met: Dict[str, bool] = {}
        if "max_age" in conditions:
            created = int(source.settings.get("index.creation_date", 0))
            age_ms = self.node.scheduler.wall_now() * 1000 - created
            from elasticsearch_tpu_torch.utils.settings import (
                parse_time_to_seconds,
            )
            met[f"[max_age: {conditions['max_age']}]"] = \
                age_ms >= parse_time_to_seconds(conditions["max_age"]) * 1000
        if "max_docs" in conditions:
            def with_stats(resp, err=None):
                if err is not None or resp is None:
                    # a stats failure must NOT read as "condition unmet" —
                    # that would silently stop a series from ever rolling
                    on_done(None, err or SearchEngineError(
                        f"stats unavailable for [{source.name}]"))
                    return
                idx = resp.get("indices", {}).get(source.name, {})
                docs = idx.get("primaries", {}).get(
                    "docs", {}).get("count", 0)
                met[f"[max_docs: {conditions['max_docs']}]"] = \
                    docs >= int(conditions["max_docs"])
                proceed(met)
            self.index_stats(source.name, with_stats)
            return
        proceed(met)

    # -- documents ------------------------------------------------------

    def index_doc(self, index: str, doc_id: str, source: Dict[str, Any],
                  on_done, routing: Optional[str] = None,
                  op_type: str = "index",
                  if_seq_no: Optional[int] = None,
                  if_primary_term: Optional[int] = None,
                  pipeline: Optional[str] = None) -> None:
        item = {"action": "create" if op_type == "create" else "index",
                "index": index, "id": doc_id, "source": source,
                "routing": routing}
        if pipeline is not None:
            item["pipeline"] = pipeline
        if if_seq_no is not None:
            item["if_seq_no"] = if_seq_no
        if if_primary_term is not None:
            item["if_primary_term"] = if_primary_term
        self._single_item_bulk(item, index, on_done)

    def delete_doc(self, index: str, doc_id: str, on_done,
                   routing: Optional[str] = None) -> None:
        self._single_item_bulk(
            {"action": "delete", "index": index, "id": doc_id,
             "routing": routing}, index, on_done)

    def _single_item_bulk(self, item, index, on_done) -> None:
        def cb(resp: Dict[str, Any]) -> None:
            result = next(iter(resp["items"][0].values()))
            if "error" in result:
                status = result.get("status", 500)
                err = SearchEngineError(result["error"]["reason"])
                err.status = status
                # an indexing-pressure 429 carries a computed Retry-After:
                # keep it on the error so the REST controller's
                # _retry_after_of emits the header for single-doc writes
                ra = result["error"].get("retry_after")
                if ra is not None:
                    err.metadata["retry_after"] = ra
                on_done(result, err)
            else:
                # keep the CONCRETE index the bulk path resolved (an
                # aliased write reports its write index, not the alias)
                result.setdefault("_index", index)
                result["_id"] = result.pop("id", item["id"])
                on_done(result, None)
        self.node.bulk_action.execute([item], cb)

    def bulk(self, items: List[Dict[str, Any]], on_done,
             payload_bytes: Optional[int] = None) -> None:
        self.node.bulk_action.execute(
            items, lambda resp: on_done(resp, None),
            payload_bytes=payload_bytes)

    def get(self, index: str, doc_id: str, on_done,
            routing: Optional[str] = None, realtime: bool = True) -> None:
        self.node.get_action.execute(index, doc_id, on_done,
                                     routing=routing, realtime=realtime)

    def update(self, index: str, doc_id: str, body: Dict[str, Any],
               on_done, routing: Optional[str] = None,
               retry_on_conflict: int = 3) -> None:
        self.node.update_action.execute(index, doc_id, body, on_done,
                                        routing=routing,
                                        retry_on_conflict=retry_on_conflict)

    # -- search ---------------------------------------------------------

    def search(self, index_expression: str, body: Optional[Dict[str, Any]],
               on_done, search_type: str = "query_then_fetch") -> None:
        self.node.search_action.execute(index_expression, body or {},
                                        on_done, search_type=search_type)

    def count(self, index_expression: str, body: Optional[Dict[str, Any]],
              on_done) -> None:
        body = dict(body or {})
        body["size"] = 0
        body["track_total_hits"] = True

        def cb(resp, err):
            if err is not None:
                on_done(None, err)
            else:
                on_done({"count": resp["hits"]["total"]["value"],
                         "_shards": resp["_shards"]}, None)
        self.search(index_expression, body, cb)

    # -- maintenance ----------------------------------------------------

    def refresh(self, index_expression: str, on_done) -> None:
        self.node.broadcast_actions.broadcast(
            REFRESH_SHARD, index_expression,
            lambda r: on_done(_shards_only(r), None))

    def flush(self, index_expression: str, on_done) -> None:
        self.node.broadcast_actions.broadcast(
            FLUSH_SHARD, index_expression,
            lambda r: on_done(_shards_only(r), None))

    def force_merge(self, index_expression: str, on_done,
                    max_num_segments: int = 1) -> None:
        self.node.broadcast_actions.broadcast(
            FORCEMERGE_SHARD, index_expression,
            lambda r: on_done(_shards_only(r), None),
            extra={"max_num_segments": max_num_segments})

    def index_stats(self, index_expression: str, on_done) -> None:
        """Per-index doc/segment stats aggregated over primary shards
        (TransportIndicesStatsAction analog)."""
        state = self.node._applied_state()
        try:
            names = resolve_index_expression(index_expression,
                                             state.metadata)
        except Exception as e:  # IndexNotFoundError → caller maps to 404
            on_done(None, e)
            return

        search_keys = ("query_total", "wand_queries",
                       "wand_blocks_total", "wand_blocks_scored",
                       "request_cache_hits", "request_cache_misses")

        def _zero() -> Dict[str, Any]:
            return {"docs": 0, "segments": 0, "translog_ops": 0,
                    "search": {k: 0 for k in search_keys}}

        def cb(r: Dict[str, Any]) -> None:
            per_index: Dict[str, Dict[str, Any]] = {n: _zero() for n in names}
            for p in r.get("payloads", []):
                if not p.get("primary"):
                    continue
                agg = per_index.setdefault(p["index"], _zero())
                agg["docs"] += p.get("docs", 0)
                agg["segments"] += p.get("segments", 0)
                agg["translog_ops"] += p.get("translog_ops", 0)
                for k in search_keys:
                    agg["search"][k] += p.get("search", {}).get(k, 0)
            indices_out = {}
            total_docs = 0
            for n in names:
                agg = per_index[n]
                total_docs += agg["docs"]
                prim = {"docs": {"count": agg["docs"], "deleted": 0},
                        "segments": {"count": agg["segments"]},
                        "translog": {"operations": agg["translog_ops"]},
                        "search": agg["search"]}
                indices_out[n] = {
                    "uuid": state.metadata.index(n).uuid,
                    "primaries": prim, "total": prim}
            total = {"docs": {"count": total_docs, "deleted": 0}}
            on_done({"_shards": r["_shards"],
                     "_all": {"primaries": total, "total": total},
                     "indices": indices_out}, None)
        self.node.broadcast_actions.broadcast(STATS_SHARD, index_expression,
                                              cb, names=names)

    # -- misc read APIs -------------------------------------------------

    def mget(self, body: Dict[str, Any], on_done,
             index: Optional[str] = None) -> None:
        self.node.misc_actions.mget(body, index, on_done)

    def termvectors(self, index: str, doc_id: str, on_done,
                    fields: Optional[List[str]] = None,
                    routing: Optional[str] = None) -> None:
        self.node.misc_actions.termvectors(index, doc_id, on_done,
                                           fields=fields, routing=routing)

    def explain(self, index: str, doc_id: str, body: Dict[str, Any],
                on_done, routing: Optional[str] = None) -> None:
        self.node.misc_actions.explain(index, doc_id, body, on_done,
                                       routing=routing)

    def field_caps(self, index_expression: str,
                   fields: Optional[str] = None) -> Dict[str, Any]:
        return self.node.misc_actions.field_caps(index_expression, fields)

    def analyze(self, body: Dict[str, Any],
                index: Optional[str] = None) -> Dict[str, Any]:
        return self.node.misc_actions.analyze(body, index=index)

    def rank_eval(self, index: str, body: Dict[str, Any], on_done) -> None:
        self.node.rank_eval_action.execute(index, body, on_done)

    # -- stored scripts / search templates ------------------------------

    def put_stored_script(self, script_id: str, body: Dict[str, Any],
                          on_done) -> None:
        from elasticsearch_tpu_torch.script.mustache import STORED_SCRIPT_PREFIX
        script = (body or {}).get("script", body or {})
        self.cluster_update_settings(
            {"persistent": {STORED_SCRIPT_PREFIX + script_id: script}},
            on_done)

    def get_stored_script(self, script_id: str) -> Optional[Dict[str, Any]]:
        from elasticsearch_tpu_torch.script.mustache import STORED_SCRIPT_PREFIX
        state = self.node._applied_state()
        return state.metadata.persistent_settings.get(
            STORED_SCRIPT_PREFIX + script_id)

    def delete_stored_script(self, script_id: str, on_done) -> None:
        from elasticsearch_tpu_torch.script.mustache import STORED_SCRIPT_PREFIX
        from elasticsearch_tpu_torch.utils.errors import ResourceNotFoundError
        if self.get_stored_script(script_id) is None:
            on_done(None, ResourceNotFoundError(
                f"stored script [{script_id}] does not exist"))
            return
        self.cluster_update_settings(
            {"persistent": {STORED_SCRIPT_PREFIX + script_id: None}},
            on_done)

    def search_template(self, index_expression: str,
                        template: Dict[str, Any], on_done) -> None:
        from elasticsearch_tpu_torch.script.mustache import render_search_body
        try:
            body = render_search_body(template or {},
                                      self.get_stored_script)
        except Exception as e:
            on_done(None, e)
            return
        self.search(index_expression, body, on_done)

    def render_template(self, template: Dict[str, Any]) -> Dict[str, Any]:
        from elasticsearch_tpu_torch.script.mustache import render_search_body
        return {"template_output": render_search_body(
            template or {}, self.get_stored_script)}

    # -- reindex family -------------------------------------------------

    def reindex(self, body: Dict[str, Any], on_done,
                wait_for_completion: bool = True) -> None:
        self.node.reindex_actions.reindex(
            body, on_done, wait_for_completion=wait_for_completion)

    def update_by_query(self, index: str, body: Dict[str, Any], on_done,
                        wait_for_completion: bool = True) -> None:
        self.node.reindex_actions.update_by_query(
            index, body, on_done,
            wait_for_completion=wait_for_completion)

    def delete_by_query(self, index: str, body: Dict[str, Any], on_done,
                        wait_for_completion: bool = True) -> None:
        self.node.reindex_actions.delete_by_query(
            index, body, on_done,
            wait_for_completion=wait_for_completion)

    # -- tasks ----------------------------------------------------------

    def list_tasks(self, on_done, actions: Optional[str] = None) -> None:
        self.node.task_actions.list_tasks(on_done, actions=actions)

    def get_task(self, task_id: str, on_done) -> None:
        """Resolved on the task's owning node (cross-node by id prefix)."""
        self.node.task_actions.get_task(task_id, on_done)

    def cancel_tasks(self, on_done, task_id: Optional[str] = None,
                     actions: Optional[str] = None) -> None:
        self.node.task_actions.cancel_tasks(on_done, task_id=task_id,
                                            actions=actions)

    # -- ingest pipelines ----------------------------------------------

    def put_pipeline(self, pipeline_id: str, body: Dict[str, Any],
                     on_done) -> None:
        from elasticsearch_tpu_torch.ingest import (
            PIPELINE_SETTING_PREFIX, IngestService,
        )
        try:
            IngestService.validate(body or {})
        except Exception as e:
            on_done(None, e)
            return
        self.cluster_update_settings(
            {"persistent": {PIPELINE_SETTING_PREFIX + pipeline_id:
                            body or {}}}, on_done)

    def get_pipeline(self, pipeline_id: Optional[str] = None
                     ) -> Dict[str, Any]:
        from elasticsearch_tpu_torch.utils.errors import ResourceNotFoundError
        pipelines = self.node.ingest_service.list_pipelines()
        if pipeline_id in (None, "*", "_all"):
            return pipelines
        if pipeline_id not in pipelines:
            raise ResourceNotFoundError(
                f"pipeline [{pipeline_id}] does not exist")
        return {pipeline_id: pipelines[pipeline_id]}

    def delete_pipeline(self, pipeline_id: str, on_done) -> None:
        from elasticsearch_tpu_torch.ingest import PIPELINE_SETTING_PREFIX
        from elasticsearch_tpu_torch.utils.errors import ResourceNotFoundError
        if pipeline_id not in self.node.ingest_service.list_pipelines():
            on_done(None, ResourceNotFoundError(
                f"pipeline [{pipeline_id}] does not exist"))
            return
        self.cluster_update_settings(
            {"persistent": {PIPELINE_SETTING_PREFIX + pipeline_id: None}},
            on_done)

    def simulate_pipeline(self, body: Dict[str, Any],
                          pipeline_id: Optional[str] = None
                          ) -> Dict[str, Any]:
        """POST _ingest/pipeline/[{id}/]_simulate"""
        service = self.node.ingest_service
        if pipeline_id is None:
            inline = (body or {}).get("pipeline")
            if inline is None:
                raise IllegalArgumentError(
                    "simulate requires a [pipeline] definition or id")
            procs = [service.compile_processor(p)
                     for p in inline.get("processors", [])]

            def run_pipeline(doc):
                for p in procs:
                    doc = p.run(doc)
                    if doc is None:
                        return None
                return doc
        else:
            def run_pipeline(doc):
                return service.execute_pipeline(pipeline_id, doc)
        docs_out = []
        for entry in (body or {}).get("docs", []):
            doc = {"_source": dict(entry.get("_source") or {}),
                   "_index": entry.get("_index", "_index"),
                   "_id": entry.get("_id", "_id"),
                   "_routing": entry.get("_routing")}
            try:
                result = run_pipeline(doc)
                if result is None:
                    docs_out.append({"doc": None})
                else:
                    docs_out.append({"doc": {
                        "_index": result["_index"],
                        "_id": result["_id"],
                        "_source": result["_source"]}})
            except Exception as e:  # noqa: BLE001 — per-doc result
                docs_out.append({"error": {
                    "type": type(e).__name__, "reason": str(e)}})
        return {"docs": docs_out}

    # -- snapshots ------------------------------------------------------

    def put_repository(self, name: str, body: Dict[str, Any],
                       on_done) -> None:
        from elasticsearch_tpu_torch.repositories import repository_settings
        try:
            settings = repository_settings(name, body or {})
        except Exception as e:
            on_done(None, e)
            return
        self.cluster_update_settings({"persistent": settings}, on_done)

    def get_repositories(self) -> Dict[str, Any]:
        state = self.node._applied_state()
        out: Dict[str, Any] = {}
        for key, val in state.metadata.persistent_settings.items():
            if key.startswith("repositories.") and key.endswith(".type"):
                name = key[len("repositories."):-len(".type")]
                out[name] = {
                    "type": val,
                    "settings": {"location":
                                 state.metadata.persistent_settings.get(
                                     f"repositories.{name}.location")}}
        return out

    def create_snapshot(self, repo: str, snap: str,
                        body: Optional[Dict[str, Any]], on_done) -> None:
        self.node.snapshot_actions.create(repo, snap, body, on_done)

    def restore_snapshot(self, repo: str, snap: str,
                         body: Optional[Dict[str, Any]], on_done) -> None:
        self.node.snapshot_actions.restore(repo, snap, body, on_done)

    def get_snapshots(self, repo: str, snap: str = "_all"
                      ) -> Dict[str, Any]:
        return self.node.snapshot_actions.get(repo, snap)

    def delete_snapshot(self, repo: str, snap: str) -> Dict[str, Any]:
        return self.node.snapshot_actions.delete(repo, snap)

    # -- cluster --------------------------------------------------------

    def cluster_health(self, index: Optional[str] = None) -> Dict[str, Any]:
        # STARTED copies the (local, if master) gateway allocator hasn't
        # confirmed are actually hosted count against green: a rebooted
        # node's stale routing must not hide a missing shard. NOTE: the
        # unverified marks live on the elected master only — REST health
        # goes through cluster_health_async, which routes non-master
        # requests to the master so the gate is authoritative
        # cluster-wide; this sync form reports the LOCAL view.
        return cluster_health(
            self.node._applied_state(), index,
            unverified=self.node.gateway_allocator.health_unverified())

    def _route_health_to_master(self, payload: Dict[str, Any],
                                leader_answer, local_flagged,
                                on_done) -> None:
        """Shared master-routing ladder for the health surfaces: answer
        on the ELECTED MASTER (whose gateway allocator owns the
        unverified-STARTED marks), refuse to serve a deposed master's
        stale view as authoritative, and fall back to the FLAGGED local
        view only when no master is known or the master doesn't
        answer."""
        master = self.node._applied_state().master_node_id
        if master == self.node.node_id:
            if self.node.coordinator.mode == Mode.LEADER:
                leader_answer()
            else:
                local_flagged()
            return
        if master is None:
            local_flagged()
            return

        def cb(resp, err):
            if err is not None or resp is None:
                local_flagged()
            else:
                on_done(resp, None)

        self.node.transport_service.send_request(
            master, CLUSTER_HEALTH_ACTION, payload, cb, timeout=10.0)

    def cluster_health_async(self, index: Optional[str],
                             on_done) -> None:
        """Authoritative cluster health: computed on the elected master,
        like the reference's master-node health action — a non-master
        node can no longer report green during the post-reboot verify
        window."""

        def local_flagged() -> None:
            local = self.cluster_health(index)
            local["master_routed"] = False
            on_done(local, None)

        self._route_health_to_master(
            {"index": index},
            lambda: on_done(self.cluster_health(index), None),
            local_flagged, on_done)

    def cluster_healths_async(self, indices: List[str], on_done) -> None:
        """Bulk master-routed health: every index's status resolved in
        ONE round trip to the elected master (the _cat/indices surface —
        the chained per-index form paid O(n_indices) sequential RPCs).
        ``on_done({"indices": {name: health_dict}}, None)``; the
        flagged local-view fallback applies exactly as in
        cluster_health_async."""

        def local_flagged() -> None:
            state = self.node._applied_state()
            out = {"indices": {
                name: self.cluster_health(name) for name in indices
                if state.metadata.has_index(name)},
                "master_routed": False}
            on_done(out, None)

        self._route_health_to_master(
            {"indices": indices},
            lambda: on_done(self.node._on_cluster_health(
                {"indices": indices}, self.node.node_id), None),
            local_flagged, on_done)

    def cluster_state(self) -> Dict[str, Any]:
        return self.node._applied_state().to_dict()

    def nodes_stats(self) -> Dict[str, Any]:
        """Local node's stats only (the historical sync form)."""
        return {"nodes": {self.node.node_id: self.node.local_node_stats()}}

    def nodes_stats_all(self, on_done, sections=None,
                        timeout: float = 30.0) -> None:
        """Every cluster node's stats, gathered over transport
        (TransportNodesStatsAction fan-out). ``sections`` narrows the
        request so single-section consumers (the _cluster/stats
        search_latency merge) don't make every node build its full
        stats payload; they also pass a short ``timeout`` so one dead
        node can't stall the endpoint for the full 30s."""
        state = self.node._applied_state()
        node_ids = sorted(state.nodes)
        out: Dict[str, Any] = {}
        pending = {"n": len(node_ids)}
        if not node_ids:
            on_done({"nodes": {}}, None)
            return
        req = {"sections": list(sections)} if sections else {}
        for nid in node_ids:
            def cb(resp, err, nid=nid):
                if err is None and resp is not None:
                    out[nid] = resp
                pending["n"] -= 1
                if pending["n"] == 0:
                    on_done({"_nodes": {"total": len(node_ids),
                                        "successful": len(out),
                                        "failed":
                                            len(node_ids) - len(out)},
                             "nodes": out}, None)
            if nid == self.node.node_id:
                cb(self.node.local_node_stats(sections=sections), None)
            else:
                self.node.transport_service.send_request(
                    nid, NODE_STATS_ACTION, req, cb, timeout=timeout)


def _shards_only(r: Dict[str, Any]) -> Dict[str, Any]:
    return {"_shards": r["_shards"]}
