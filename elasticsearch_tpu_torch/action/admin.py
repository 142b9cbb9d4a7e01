"""Master-level admin actions + broadcast shard maintenance actions.

Reference analogs: MetadataCreateIndexService.java:113 (create index
through a master state update), TransportDeleteIndexAction,
TransportPutMappingAction, TransportUpdateSettingsAction, the shard-state
listeners (ShardStateAction started/failed handlers), cluster health
(cluster/health/ClusterHealthResponse semantics), and broadcast actions
(refresh/flush/forcemerge over all shards, TransportBroadcastAction).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from elasticsearch_tpu_torch.cluster.allocation import AllocationService
from elasticsearch_tpu_torch.cluster.coordination import Coordinator
from elasticsearch_tpu_torch.cluster.metadata import (
    IndexMetadata, resolve_index_expression,
)
from elasticsearch_tpu_torch.cluster.routing import (
    IndexRoutingTable, ShardRouting, ShardState,
)
from elasticsearch_tpu_torch.cluster.state import ClusterState
from elasticsearch_tpu_torch.indices.cluster_state_service import (
    SHARD_FAILED, SHARD_STARTED,
)
from elasticsearch_tpu_torch.indices.indices_service import IndicesService
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.mapping.mappers import _ROOT_MAPPING_KEYS
from elasticsearch_tpu_torch.transport.transport import Deferred, TransportService
from elasticsearch_tpu_torch.utils.errors import (
    IllegalArgumentError, IndexNotFoundError, NotMasterError,
)
from elasticsearch_tpu_torch.utils.retry import RetryableAction

CREATE_INDEX = "indices:admin/create"
DELETE_INDEX = "indices:admin/delete"
OPEN_INDEX = "indices:admin/open"
CLOSE_INDEX = "indices:admin/close"
PUT_MAPPING = "indices:admin/mapping/put"
UPDATE_SETTINGS = "indices:admin/settings/update"
UPDATE_ALIASES = "indices:admin/aliases"
CLUSTER_UPDATE_SETTINGS = "cluster:admin/settings/update"
PUT_TEMPLATE = "indices:admin/index_template/put"
DELETE_TEMPLATE = "indices:admin/index_template/delete"
PUT_ILM_POLICY = "cluster:admin/ilm/put"
DELETE_ILM_POLICY = "cluster:admin/ilm/delete"
ROLLOVER = "indices:admin/rollover"
CREATE_DATA_STREAM = "indices:admin/data_stream/create"
DELETE_DATA_STREAM = "indices:admin/data_stream/delete"
VOTING_EXCLUSIONS = "cluster:admin/voting_config/exclusions"
PERSISTENT_UPDATE = "cluster:admin/persistent/update"
PUT_SECURITY = "cluster:admin/xpack/security/put"
DELETE_SECURITY = "cluster:admin/xpack/security/delete"
PUT_CUSTOM = "cluster:admin/xpack/custom/put"
DELETE_CUSTOM = "cluster:admin/xpack/custom/delete"
REROUTE = "cluster:admin/reroute"
REFRESH_SHARD = "indices:admin/refresh[s]"
NODE_STATS_ACTION = "cluster:monitor/nodes/stats[n]"
# master-routed cluster health: the unverified-STARTED gate lives on the
# elected master only, so non-master health requests forward here (the
# reference's TransportClusterHealthAction is a master-node action)
CLUSTER_HEALTH_ACTION = "cluster:monitor/health[m]"
FLUSH_SHARD = "indices:admin/flush[s]"
FORCEMERGE_SHARD = "indices:admin/forcemerge[s]"
STATS_SHARD = "indices:monitor/stats[s]"

MASTER_RETRY_DELAY = 0.2


def next_rollover_name(name: str) -> str:
    """logs-000003 -> logs-000004; unsuffixed names start at -000001
    (MetadataRolloverService.generateRolloverIndexName analog)."""
    import re
    m = re.match(r"^(.*)-(\d+)$", name)
    if m:
        prefix, digits = m.groups()
        return f"{prefix}-{int(digits) + 1:0{len(digits)}d}"
    return f"{name}-000001"


def backing_index_name(stream: str, generation: int) -> str:
    """.ds-<stream>-NNNNNN (DataStream.getDefaultBackingIndexName analog,
    minus the date component — generations alone keep names unique)."""
    return f".ds-{stream}-{generation:06d}"


def _validate_mappings(mappings: Dict[str, Any],
                       existing: Optional[Dict[str, Any]] = None
                       ) -> MapperService:
    """Validate a mapping update the way the appliers will consume it.

    Mirrors PutMappingExecutor: build a throwaway MapperService from the
    EXISTING mapping and merge the new one into it, so merge conflicts
    (e.g. changing a field type text->keyword) are rejected at the API
    instead of poisoning every node's applier post-commit. Returns the
    merged service so put_mapping can commit its serialized form."""
    service = MapperService(dict(existing)) if existing else MapperService()
    if mappings:
        service.merge(dict(mappings))
    return service
MASTER_TIMEOUT = 30.0


class MasterActions:
    """Handlers that only the elected master executes; callers route via
    ``MasterClient`` which retries on NotMaster/no-master."""

    def __init__(self, coordinator: Coordinator,
                 allocation: AllocationService, ts: TransportService):
        self.coordinator = coordinator
        self.allocation = allocation
        for action, handler in [
            (CREATE_INDEX, self._on_create_index),
            (DELETE_INDEX, self._on_delete_index),
            (OPEN_INDEX, self._on_open_index),
            (CLOSE_INDEX, self._on_close_index),
            (PUT_MAPPING, self._on_put_mapping),
            (UPDATE_SETTINGS, self._on_update_settings),
            (UPDATE_ALIASES, self._on_update_aliases),
            (CLUSTER_UPDATE_SETTINGS, self._on_cluster_settings),
            (PUT_TEMPLATE, self._on_put_template),
            (DELETE_TEMPLATE, self._on_delete_template),
            (PUT_ILM_POLICY, self._on_put_ilm_policy),
            (DELETE_ILM_POLICY, self._on_delete_ilm_policy),
            (ROLLOVER, self._on_rollover),
            (CREATE_DATA_STREAM, self._on_create_data_stream),
            (DELETE_DATA_STREAM, self._on_delete_data_stream),
            (VOTING_EXCLUSIONS, self._on_voting_exclusions),
            (PERSISTENT_UPDATE, self._on_persistent_update),
            (PUT_SECURITY, self._on_put_security),
            (DELETE_SECURITY, self._on_delete_security),
            (PUT_CUSTOM, self._on_put_custom),
            (DELETE_CUSTOM, self._on_delete_custom),
            (REROUTE, self._on_reroute),
            (SHARD_STARTED, self._on_shard_started),
            (SHARD_FAILED, self._on_shard_failed),
        ]:
            ts.register_handler(action, handler)

    def _submit(self, description: str,
                update: Callable[[ClusterState], ClusterState]) -> Deferred:
        deferred = Deferred()

        def done(err: Optional[Exception]) -> None:
            if err is not None:
                deferred.reject(err)
            else:
                deferred.resolve({"acknowledged": True})
        self.coordinator.submit_state_update(description, update, done)
        return deferred

    # -- index admin ----------------------------------------------------

    def _on_create_index(self, req: Dict[str, Any], sender: str) -> Deferred:
        name = req["index"]
        req_settings = dict(req.get("settings") or {})
        req_mappings = req.get("mappings") or {}
        if not name or name.startswith("_") or name != name.lower() \
                or any(c in name for c in ' ,"*\\<>|?/'):
            raise IllegalArgumentError(f"invalid index name [{name}]")
        # validate the request mapping BEFORE it enters the cluster state:
        # once committed, every node's applier would fail on it and the
        # index would never assign (MetadataCreateIndexService validates
        # the same way by building a MapperService up front)
        _validate_mappings(req_mappings)

        def update(state: ClusterState) -> ClusterState:
            if state.metadata.has_index(name):
                if req.get("ignore_existing"):
                    return state
                raise IllegalArgumentError(
                    f"index [{name}] already exists")
            return self._create_into(state, name, req_settings,
                                     req_mappings,
                                     ignore_templates=req.get(
                                         "ignore_templates", False))
        return self._submit(f"create-index [{name}]", update)

    def _create_into(self, state: ClusterState, name: str,
                     req_settings: Dict[str, Any],
                     req_mappings: Dict[str, Any],
                     ignore_templates: bool = False,
                     template_for: Optional[str] = None) -> ClusterState:
        """Create ``name`` in ``state`` with matching composable templates
        applied — lowest priority first, the explicit request winning
        (MetadataCreateIndexService.applyCreateIndexRequestWithV2Template).
        Shared by create-index and the atomic half of rollover.
        ``template_for``: match templates against this name instead of the
        index's own (data-stream backing indices match their STREAM name,
        never the .ds-* backing name)."""
        settings: Dict[str, Any] = {}
        aliases: list = []
        service = MapperService()
        # only the single highest-priority matching template applies
        # (findV2Template: composable templates are winner-takes-all, so
        # two individually-valid templates can never produce an unmergeable
        # combined mapping that wedges creation)
        # resize targets must be EXACT copies: templates bypassed
        # (MetadataCreateIndexService resize path sets no templates)
        layers = [] if ignore_templates else [
            t.get("template") or {}
            for _n, t in state.metadata.matching_templates(
                template_for or name)[:1]]
        for tmpl in layers:
            settings.update(tmpl.get("settings") or {})
            a = tmpl.get("aliases") or {}
            aliases.extend(a if isinstance(a, (list, tuple)) else a.keys())
            if tmpl.get("mappings"):
                service.merge(dict(tmpl["mappings"]))
        if req_mappings:
            service.merge(dict(req_mappings))
        mappings = service.to_mapping()
        for src in [t.get("mappings") or {} for t in layers] + [req_mappings]:
            for k, v in src.items():
                if k.startswith("_") or k in _ROOT_MAPPING_KEYS:
                    mappings[k] = v
        settings.update(req_settings)
        n_shards = int(settings.pop(
            "number_of_shards", settings.pop("index.number_of_shards", 1)))
        n_replicas = int(settings.pop(
            "number_of_replicas",
            settings.pop("index.number_of_replicas", 1)))
        # creation timestamp for age-based rollover/ILM conditions —
        # PERSISTED, so it must be epoch time, not the monotonic clock
        settings.setdefault("index.creation_date",
                            int(self.coordinator.scheduler.wall_now() * 1000))
        meta = IndexMetadata.create(
            name, number_of_shards=n_shards, number_of_replicas=n_replicas,
            mappings=mappings, settings=settings)
        if aliases:
            meta = meta.with_aliases(tuple(dict.fromkeys(aliases)))
        new = state.next_version(
            metadata=state.metadata.put_index(meta),
            routing_table=state.routing_table.put_index(
                IndexRoutingTable.new(name, n_shards, n_replicas)))
        return self.allocation.reroute(new)

    def _on_delete_index(self, req: Dict[str, Any], sender: str) -> Deferred:
        name = req["index"]

        def update(state: ClusterState) -> ClusterState:
            resolved = state.metadata.index(name).name   # raises if missing
            # the WRITE index of a data stream cannot be deleted directly
            # (and DELETE /<stream> resolves to it): the stream would be
            # corrupted — the _data_stream API owns that operation. Aged
            # NON-write backing indices delete normally (ILM does).
            for ds_name, ds in state.metadata.data_streams.items():
                indices = ds.get("indices", [])
                if indices and resolved == indices[-1]:
                    raise IllegalArgumentError(
                        f"index [{resolved}] is the write index of data "
                        f"stream [{ds_name}]; delete the data stream via "
                        f"DELETE /_data_stream/{ds_name}")
            md = state.metadata.remove_index(resolved)
            # a deleted backing index leaves its data stream's list, or
            # the stream would resolve to a ghost (ILM deletes aged
            # backing indices out of live streams)
            for ds_name, ds in md.data_streams.items():
                if resolved in ds.get("indices", []):
                    md = md.with_data_stream(ds_name, {
                        **ds, "indices": [n for n in ds["indices"]
                                          if n != resolved]})
            return state.next_version(
                metadata=md,
                routing_table=state.routing_table.remove_index(resolved))
        return self._submit(f"delete-index [{name}]", update)

    def _on_put_mapping(self, req: Dict[str, Any], sender: str) -> Deferred:
        name = req["index"]
        mappings = req.get("mappings") or {}

        def update(state: ClusterState) -> ClusterState:
            meta = state.metadata.index(name)
            # merge into the EXISTING mapping the way every applier will
            # (PutMappingExecutor): conflicts (type changes etc.) are
            # rejected here, and the COMMITTED mapping is the serialized
            # result of that same deep merge — so validation and commit
            # cannot diverge (a shallow properties update would silently
            # erase sibling sub-fields of nested objects)
            service = _validate_mappings(mappings, existing=meta.mappings)
            merged = service.to_mapping()
            # root-level keys (dynamic, _source, _meta, ...) carry forward,
            # new request winning over the existing mapping
            for src in (meta.mappings, mappings):
                for k, v in (src or {}).items():
                    if k.startswith("_") or k in _ROOT_MAPPING_KEYS:
                        merged[k] = v
            return state.next_version(metadata=state.metadata.update_index(
                meta.with_mappings(merged)))
        return self._submit(f"put-mapping [{name}]", update)

    def _on_update_settings(self, req: Dict[str, Any], sender: str
                            ) -> Deferred:
        name = req["index"]
        settings = dict(req.get("settings") or {})

        def update(state: ClusterState) -> ClusterState:
            meta = state.metadata.index(name)
            n_replicas = settings.pop(
                "number_of_replicas",
                settings.pop("index.number_of_replicas", None))
            new_meta = meta.with_settings(settings) if settings else meta
            routing = state.routing_table
            if n_replicas is not None and \
                    int(n_replicas) != meta.number_of_replicas:
                n_replicas = int(n_replicas)
                new_meta = new_meta.with_replicas(n_replicas)
                routing = routing.put_index(_resize_replicas(
                    routing.index(meta.name), n_replicas))
            new = state.next_version(
                metadata=state.metadata.update_index(new_meta),
                routing_table=routing)
            return self.allocation.reroute(new)
        return self._submit(f"update-settings [{name}]", update)

    def _set_index_state(self, name: str, new_state: str) -> Deferred:
        """open <-> close (MetadataIndexStateService analog): a closed
        index keeps its shards and data but rejects reads and writes."""
        from dataclasses import replace as _replace

        def update(state: ClusterState) -> ClusterState:
            from elasticsearch_tpu_torch.cluster.metadata import (
                resolve_index_expression,
            )
            metadata = state.metadata
            for concrete in resolve_index_expression(name, metadata):
                meta = metadata.indices[concrete]
                if meta.state != new_state:
                    metadata = metadata.update_index(_replace(
                        meta, state=new_state, version=meta.version + 1))
            if metadata is state.metadata:
                return state      # no-op: don't publish a new version
            return state.next_version(metadata=metadata)
        return self._submit(f"{new_state}-index [{name}]", update)

    def _on_open_index(self, req: Dict[str, Any], sender: str) -> Deferred:
        return self._set_index_state(req["index"], "open")

    def _on_close_index(self, req: Dict[str, Any], sender: str) -> Deferred:
        return self._set_index_state(req["index"], "close")

    def _on_update_aliases(self, req: Dict[str, Any], sender: str
                           ) -> Deferred:
        actions = req.get("actions", [])

        def update(state: ClusterState) -> ClusterState:
            metadata = state.metadata
            for action in actions:
                kind = next(iter(action))
                spec = action[kind]
                meta = metadata.index(spec["index"])
                aliases = set(meta.aliases)
                configs = dict(meta.alias_configs)
                if kind == "add":
                    aliases.add(spec["alias"])
                    # add REPLACES the alias config entirely (ES alias
                    # add semantics: re-adding without a filter clears
                    # the old filter)
                    props = {k: spec[k] for k in
                             ("filter", "routing", "is_write_index")
                             if k in spec}
                    configs.pop(spec["alias"], None)
                    if props:
                        configs[spec["alias"]] = props
                elif kind == "remove":
                    aliases.discard(spec["alias"])
                    configs.pop(spec["alias"], None)
                else:
                    raise IllegalArgumentError(
                        f"unknown alias action [{kind}]")
                metadata = metadata.update_index(
                    meta.with_aliases(tuple(sorted(aliases)), configs))
            return state.next_version(metadata=metadata)
        return self._submit("update-aliases", update)

    def _on_cluster_settings(self, req: Dict[str, Any], sender: str
                             ) -> Deferred:
        persistent = req.get("persistent") or {}

        def update(state: ClusterState) -> ClusterState:
            return state.next_version(
                metadata=state.metadata.with_persistent_settings(persistent))
        return self._submit("cluster-update-settings", update)

    # -- index templates (MetadataIndexTemplateService analog) ----------

    def _on_put_template(self, req: Dict[str, Any], sender: str) -> Deferred:
        name = req["name"]
        body = dict(req.get("body") or {})
        patterns = body.get("index_patterns")
        if not patterns or not isinstance(patterns, (list, tuple)):
            raise IllegalArgumentError(
                "index template requires [index_patterns]")
        try:
            int(body.get("priority", 0))
        except (TypeError, ValueError):
            raise IllegalArgumentError(
                f"template [priority] must be an integer, got "
                f"[{body.get('priority')!r}]")
        # reject broken template mappings at the API, not at create time
        _validate_mappings((body.get("template") or {}).get("mappings") or {})

        def update(state: ClusterState) -> ClusterState:
            return state.next_version(
                metadata=state.metadata.with_template(name, body))
        return self._submit(f"put-template [{name}]", update)

    def _on_delete_template(self, req: Dict[str, Any],
                            sender: str) -> Deferred:
        name = req["name"]

        def update(state: ClusterState) -> ClusterState:
            if name not in state.metadata.templates:
                from elasticsearch_tpu_torch.utils.errors import (
                    ResourceNotFoundError,
                )
                raise ResourceNotFoundError(
                    f"index template [{name}] not found")
            return state.next_version(
                metadata=state.metadata.with_template(name, None))
        return self._submit(f"delete-template [{name}]", update)

    # -- ILM policies (IndexLifecycleService metadata half) --------------

    def _on_put_ilm_policy(self, req: Dict[str, Any],
                           sender: str) -> Deferred:
        name = req["name"]
        policy = dict(req.get("policy") or {})

        def update(state: ClusterState) -> ClusterState:
            return state.next_version(
                metadata=state.metadata.with_ilm_policy(name, policy))
        return self._submit(f"put-ilm-policy [{name}]", update)

    def _on_delete_ilm_policy(self, req: Dict[str, Any],
                              sender: str) -> Deferred:
        name = req["name"]

        def update(state: ClusterState) -> ClusterState:
            if name not in state.metadata.ilm_policies:
                from elasticsearch_tpu_torch.utils.errors import (
                    ResourceNotFoundError,
                )
                raise ResourceNotFoundError(f"policy [{name}] not found")
            return state.next_version(
                metadata=state.metadata.with_ilm_policy(name, None))
        return self._submit(f"delete-ilm-policy [{name}]", update)

    # -- security entities (native realm's .security index analog) -------

    def _on_put_security(self, req: Dict[str, Any], sender: str) -> Deferred:
        kind, name = req["kind"], req["name"]
        if kind not in ("users", "roles", "api_keys"):
            raise IllegalArgumentError(f"unknown security kind [{kind}]")
        body = dict(req.get("body") or {})

        def update(state: ClusterState) -> ClusterState:
            return state.next_version(
                metadata=state.metadata.with_security_entity(
                    kind, name, body))
        return self._submit(f"put-security-{kind} [{name}]", update)

    def _on_delete_security(self, req: Dict[str, Any],
                            sender: str) -> Deferred:
        kind, name = req["kind"], req["name"]

        def update(state: ClusterState) -> ClusterState:
            if name not in state.metadata.security.get(kind, {}):
                from elasticsearch_tpu_torch.utils.errors import (
                    ResourceNotFoundError,
                )
                raise ResourceNotFoundError(f"{kind[:-1]} [{name}] not found")
            return state.next_version(
                metadata=state.metadata.with_security_entity(
                    kind, name, None))
        return self._submit(f"delete-security-{kind} [{name}]", update)

    # -- custom metadata sections (Metadata.Custom CRUD: transforms,
    # watches, ...) ------------------------------------------------------

    def _on_put_custom(self, req: Dict[str, Any], sender: str) -> Deferred:
        section, name = req["section"], req["name"]
        body = dict(req.get("body") or {})

        def update(state: ClusterState) -> ClusterState:
            return state.next_version(
                metadata=state.metadata.with_custom_entry(
                    section, name, body))
        return self._submit(f"put-{section} [{name}]", update)

    def _on_delete_custom(self, req: Dict[str, Any],
                          sender: str) -> Deferred:
        section, name = req["section"], req["name"]

        def update(state: ClusterState) -> ClusterState:
            if name not in state.metadata.custom.get(section, {}):
                from elasticsearch_tpu_torch.utils.errors import (
                    ResourceNotFoundError,
                )
                raise ResourceNotFoundError(
                    f"{section} entry [{name}] not found")
            return state.next_version(
                metadata=state.metadata.with_custom_entry(
                    section, name, None))
        return self._submit(f"delete-{section} [{name}]", update)

    # -- rollover (TransportRolloverAction's atomic state half) ----------

    def _on_persistent_update(self, req: Dict[str, Any],
                              sender: str) -> Deferred:
        """Field-level merge into one persistent task's entry, applied
        against the AUTHORITATIVE state inside the update closure — a
        caller-side read-modify-write PUT would race concurrent
        assignment/state writes and lose one of them
        (PersistentTasksClusterService's versioned task updates)."""
        task_id = req["task_id"]
        fields = dict(req.get("set") or {})
        create = req.get("create")

        def update(state: ClusterState) -> ClusterState:
            entries = dict(state.metadata.custom.get(
                "persistent_tasks", {}))
            entry = entries.get(task_id)
            if create is not None:
                # create-only: the duplicate check runs HERE against the
                # authoritative state, so a raced/retried submit can never
                # blind-overwrite a live task's assignment and progress
                if entry is not None:
                    raise IllegalArgumentError(
                        f"persistent task [{task_id}] already exists")
                entry = dict(create)
            elif entry is None:
                from elasticsearch_tpu_torch.utils.errors import (
                    ResourceNotFoundError,
                )
                raise ResourceNotFoundError(
                    f"no persistent task [{task_id}]")
            return state.next_version(
                metadata=state.metadata.with_custom_entry(
                    "persistent_tasks", task_id, {**entry, **fields}))
        return self._submit(f"persistent-update [{task_id}]", update)

    def _on_voting_exclusions(self, req: Dict[str, Any],
                              sender: str) -> Deferred:
        """Voting-config exclusions (AddVotingConfigExclusionsAction /
        ClearVotingConfigExclusionsAction analog): excluded master-eligible
        nodes leave the voting configuration so they can be decommissioned
        without losing quorum math; clearing re-admits present members.

        The exclusion list replicates in metadata
        (custom["voting_exclusions"]) and the shrunken voting_config rides
        the SAME committed state update, so every node's quorum arithmetic
        flips atomically — the reference's CoordinationMetadata semantics."""
        action = req.get("action", "add")
        nodes = [str(n) for n in (req.get("node_names") or [])]

        def update(state: ClusterState) -> ClusterState:
            current = set(state.voting_config)
            md = state.metadata
            exclusions = dict(md.custom.get("voting_exclusions", {}))
            if action == "add":
                if not nodes:
                    raise IllegalArgumentError(
                        "add voting exclusions requires [node_names]")
                # a typo'd name must fail loudly: silently recording a
                # no-op exclusion would let an operator decommission a
                # node the quorum still counts
                unknown = [n for n in nodes
                           if n not in current and n not in state.nodes]
                if unknown:
                    raise IllegalArgumentError(
                        f"unknown voting node(s) {sorted(unknown)}")
                remaining = current - set(nodes)
                if not remaining:
                    raise IllegalArgumentError(
                        "cannot exclude every voting node: the cluster "
                        "would lose its quorum")
                for n in nodes:
                    exclusions[n] = {"reason": "excluded"}
                new_config = frozenset(remaining)
            else:
                # clear: re-admit PRESENT MASTER-ELIGIBLE members only —
                # data-only nodes never vote, counting them in the config
                # would create phantom voters quorum can never reach.
                # Excluded voters ABSENT right now become pending: they
                # re-enter the config when they rejoin (and only then), so
                # the config never grows by nodes that may never return
                was_excluded = set(md.custom.get("voting_exclusions", {}))
                exclusions = {}
                members = set(state.master_eligible_nodes())
                new_config = frozenset(current | members)
                for name in was_excluded - members:
                    md = md.with_custom_entry("voting_pending", name, {})
            for name in list(md.custom.get("voting_exclusions", {})):
                md = md.with_custom_entry("voting_exclusions", name, None)
            for name, body in exclusions.items():
                md = md.with_custom_entry("voting_exclusions", name, body)
            return state.next_version(metadata=md,
                                      voting_config=new_config)
        return self._submit(f"voting-exclusions-{action}", update)

    def _on_create_data_stream(self, req: Dict[str, Any],
                               sender: str) -> Deferred:
        """Create a data stream + its first backing index atomically
        (CreateDataStreamAction.java:47 / MetadataCreateDataStreamService).
        Requires a matching composable template that DECLARES data_stream —
        the template supplies the backing indices' mappings/settings."""
        name = req["name"]
        if not name or name.startswith((".", "_")) or name != name.lower() \
                or any(c in name for c in ' ,"*\\<>|?/:'):
            raise IllegalArgumentError(f"invalid data stream name [{name}]")

        def update(state: ClusterState) -> ClusterState:
            md = state.metadata
            if md.has_index(name) or name in md.data_streams:
                raise IllegalArgumentError(
                    f"data stream or index [{name}] already exists")
            ds_spec = None
            for _n, t in md.matching_templates(name):
                if "data_stream" in t:
                    ds_spec = t.get("data_stream") or {}
                    break
            if ds_spec is None:
                raise IllegalArgumentError(
                    f"no matching index template with a data_stream "
                    f"definition for [{name}]")
            ts_field = (ds_spec.get("timestamp_field") or {}) \
                .get("name", "@timestamp")
            backing = backing_index_name(name, 1)
            state = self._create_into(state, backing,
                                      {"index.hidden": True}, {},
                                      template_for=name)
            md = state.metadata.with_data_stream(name, {
                "name": name,
                "timestamp_field": {"name": ts_field},
                "generation": 1,
                "indices": [backing]})
            return state.next_version(metadata=md)
        return self._submit(f"create-data-stream [{name}]", update)

    def _on_delete_data_stream(self, req: Dict[str, Any],
                               sender: str) -> Deferred:
        """Delete a data stream and EVERY backing index
        (DeleteDataStreamAction analog)."""
        name = req["name"]

        def update(state: ClusterState) -> ClusterState:
            ds = state.metadata.data_streams.get(name)
            if ds is None:
                raise IndexNotFoundError(name)
            md = state.metadata
            rt = state.routing_table
            for backing in ds.get("indices", []):
                if backing in md.indices:
                    md = md.remove_index(backing)
                    rt = rt.remove_index(backing)
            md = md.with_data_stream(name, None)
            return state.next_version(metadata=md, routing_table=rt)
        return self._submit(f"delete-data-stream [{name}]", update)

    def _rollover_data_stream(self, req: Dict[str, Any]) -> Deferred:
        """Data-stream rollover: next backing index, generation bump —
        one atomic state update (MetadataRolloverService's data-stream
        branch)."""
        ds_name = req["data_stream"]

        def update(state: ClusterState) -> ClusterState:
            md = state.metadata
            ds = md.data_streams.get(ds_name)
            if ds is None:
                raise IndexNotFoundError(ds_name)
            gen = int(ds.get("generation", 1)) + 1
            new_name = req.get("new_index") or \
                backing_index_name(ds_name, gen)
            if md.has_index(new_name):
                raise IllegalArgumentError(
                    f"rollover target [{new_name}] already exists")
            state = self._create_into(state, new_name,
                                      {"index.hidden": True,
                                       **dict(req.get("settings") or {})},
                                      dict(req.get("mappings") or {}),
                                      template_for=ds_name)
            md = state.metadata
            now_ms = int(self.coordinator.scheduler.wall_now() * 1000)
            old_name = ds["indices"][-1] if ds.get("indices") else None
            if old_name and old_name in md.indices:
                md = md.update_index(md.indices[old_name].with_settings(
                    {"index.rollover_date": now_ms}))
            md = md.with_data_stream(ds_name, {
                **ds, "generation": gen,
                "indices": list(ds.get("indices", [])) + [new_name]})
            return state.next_version(metadata=md)

        deferred = Deferred()

        def done(err: Optional[Exception]) -> None:
            if err is not None:
                deferred.reject(err)
            else:
                state = self.coordinator.applied_state
                ds = state.metadata.data_streams.get(ds_name) or {}
                indices = ds.get("indices") or [None]
                deferred.resolve({
                    "acknowledged": True, "rolled_over": True,
                    "new_index": indices[-1]})
        self.coordinator.submit_state_update(
            f"rollover-data-stream [{ds_name}]", update, done)
        return deferred

    def _on_rollover(self, req: Dict[str, Any], sender: str) -> Deferred:
        """Atomically create the next index in the series and swap the
        write alias. Condition evaluation (doc counts, age) happens on the
        coordinator BEFORE this is sent; this handler is the single
        cluster-state update (MetadataRolloverService.rolloverClusterState)."""
        if req.get("data_stream"):
            return self._rollover_data_stream(req)
        alias = req["alias"]

        def update(state: ClusterState) -> ClusterState:
            sources = [im for im in state.metadata.indices.values()
                       if alias in im.aliases]
            if len(sources) > 1:
                # the canonical is_write_index pattern: roll the single
                # write index; the others stay read members of the alias
                # (MetadataRolloverService write-alias rollover)
                writers = [im for im in sources
                           if (im.alias_configs.get(alias) or {})
                           .get("is_write_index")]
                if len(writers) != 1:
                    raise IllegalArgumentError(
                        f"rollover alias [{alias}] points to "
                        f"{len(sources)} indices without a single "
                        f"is_write_index")
                sources = writers
            if not sources:
                raise IllegalArgumentError(
                    f"rollover alias [{alias}] matches no index")
            old = sources[0]
            # explicit is_write_index => write-alias pattern: the old
            # generation stays a read member and only the flag moves
            # (MetadataRolloverService keys on the same distinction)
            multi_alias = bool((old.alias_configs.get(alias) or {})
                               .get("is_write_index"))
            # the coordinator resolves new_index BEFORE sending, so a
            # MasterClient retry after a lost response fails here with
            # "already exists" instead of silently rolling twice
            new_name = req.get("new_index") or next_rollover_name(old.name)
            if state.metadata.has_index(new_name):
                raise IllegalArgumentError(
                    f"rollover target [{new_name}] already exists")
            state = self._create_into(state, new_name,
                                      dict(req.get("settings") or {}),
                                      dict(req.get("mappings") or {}))
            metadata = state.metadata
            now_ms = int(self.coordinator.scheduler.wall_now() * 1000)
            old_meta = metadata.indices[old.name]
            if multi_alias:
                # write-alias rollover: the old index KEEPS the alias as
                # a read member; only the write flag moves
                old_configs = dict(old_meta.alias_configs)
                old_configs[alias] = {
                    k: v for k, v in
                    (old_configs.get(alias) or {}).items()
                    if k != "is_write_index"}
                if not old_configs[alias]:
                    old_configs.pop(alias)
                metadata = metadata.update_index(old_meta.with_aliases(
                    old_meta.aliases, old_configs
                ).with_settings({"index.rollover_date": now_ms}))
            else:
                metadata = metadata.update_index(old_meta.with_aliases(
                    tuple(a for a in old_meta.aliases if a != alias)
                ).with_settings({"index.rollover_date": now_ms}))
            new_meta = metadata.indices[new_name]
            new_configs = dict(new_meta.alias_configs)
            if multi_alias:
                new_configs[alias] = {"is_write_index": True}
            metadata = metadata.update_index(new_meta.with_aliases(
                tuple(dict.fromkeys(list(new_meta.aliases) + [alias])),
                new_configs))
            return state.next_version(metadata=metadata)

        deferred = Deferred()

        def done(err: Optional[Exception]) -> None:
            if err is not None:
                deferred.reject(err)
            else:
                # report what the committed state actually did; under the
                # write-alias pattern BOTH generations hold the alias, so
                # the new index is the one carrying is_write_index
                state = self.coordinator.applied_state
                targets = [im for im in state.metadata.indices.values()
                           if alias in im.aliases]
                writers = [im.name for im in targets
                           if (im.alias_configs.get(alias) or {})
                           .get("is_write_index")]
                new = req.get("new_index") or (
                    writers[0] if writers else
                    (targets[0].name if targets else None))
                deferred.resolve({
                    "acknowledged": True, "rolled_over": True,
                    "new_index": new})
        self.coordinator.submit_state_update(
            f"rollover [{alias}]", update, done)
        return deferred

    # -- reroute (TransportClusterRerouteAction analog) ------------------

    def _on_reroute(self, req: Dict[str, Any], sender: str) -> Deferred:
        """Explicit shard-movement commands + a reallocation pass. With no
        commands this is the bare "kick the allocator" call;
        ?retry_failed resets MaxRetryDecider's failure streaks
        (AllocationService.reroute retryFailed analog)."""
        commands = req.get("commands") or []
        retry_failed = bool(req.get("retry_failed"))

        def update(state: ClusterState) -> ClusterState:
            routing = state.routing_table
            if retry_failed:
                from dataclasses import replace as _replace
                # the operator may have cleared corruption markers or
                # replaced disks: the gateway fetch cache is stale
                if self.allocation.gateway_allocator is not None:
                    self.allocation.gateway_allocator.invalidate_all()
                for sr in list(routing.all_shards()):
                    if sr.failed_attempts and not sr.assigned:
                        irt0 = routing.index(sr.index)
                        routing = routing.put_index(irt0.replace_shard(
                            sr, _replace(sr, failed_attempts=0)))
                state = state.next_version(routing_table=routing)
            for command in commands:
                try:
                    (kind, spec), = command.items()
                    index, sid = spec["index"], int(spec["shard"])
                except (ValueError, KeyError, TypeError) as e:
                    # malformed client input is a 400, not a 500
                    raise IllegalArgumentError(
                        f"malformed reroute command {command!r}: {e}")
                irt = routing.index(index)
                group = irt.shard_group(sid)
                if kind == "cancel":
                    node = spec["node"]
                    target = next((sr for sr in group
                                   if sr.node_id == node), None)
                    if target is None:
                        raise IllegalArgumentError(
                            f"no copy of [{index}][{sid}] on [{node}]")
                    if target.primary and not spec.get("allow_primary"):
                        raise IllegalArgumentError(
                            "cancelling a primary requires "
                            "[allow_primary: true]")
                    # operator cancels must not consume the
                    # MaxRetryDecider failure budget
                    state = self.allocation.apply_failed_shard(
                        state, target, count_failure=False)
                    routing = state.routing_table
                elif kind == "move":
                    try:
                        from_node, to_node = \
                            spec["from_node"], spec["to_node"]
                    except KeyError as e:
                        raise IllegalArgumentError(
                            f"move requires [from_node]/[to_node]: {e}")
                    target = next((sr for sr in group
                                   if sr.node_id == from_node), None)
                    if target is None:
                        raise IllegalArgumentError(
                            f"no copy of [{index}][{sid}] on [{from_node}]")
                    if target.primary:
                        raise IllegalArgumentError(
                            "moving a primary is not supported; cancel a "
                            "replica or use replica count changes")
                    if to_node not in state.nodes:
                        raise IllegalArgumentError(
                            f"unknown node [{to_node}]")
                    # explicit commands must uphold the SameShardDecider
                    # invariant the allocator enforces everywhere else
                    if any(sr.node_id == to_node for sr in group):
                        raise IllegalArgumentError(
                            f"node [{to_node}] already holds a copy of "
                            f"[{index}][{sid}]")
                    moved = target.fail().initialize(to_node)
                    routing = routing.put_index(
                        irt.replace_shard(target, moved))
                    state = state.next_version(routing_table=routing)
                elif kind == "allocate_replica":
                    node = spec.get("node")
                    if node not in state.nodes:
                        raise IllegalArgumentError(
                            f"unknown node [{node}]")
                    if any(sr.node_id == node for sr in group):
                        raise IllegalArgumentError(
                            f"node [{node}] already holds a copy of "
                            f"[{index}][{sid}]")
                    target = next(
                        (sr for sr in group
                         if not sr.primary and not sr.assigned), None)
                    if target is None:
                        raise IllegalArgumentError(
                            f"no unassigned replica of [{index}][{sid}]")
                    routing = routing.put_index(
                        irt.replace_shard(target, target.initialize(node)))
                    state = state.next_version(routing_table=routing)
                else:
                    raise IllegalArgumentError(
                        f"unknown reroute command [{kind}]")
            return self.allocation.reroute(state)
        return self._submit("cluster-reroute", update)

    # -- shard state ----------------------------------------------------

    def _on_shard_started(self, req: Dict[str, Any], sender: str) -> Deferred:
        sr = ShardRouting.from_dict(req["shard"])
        if self.allocation.gateway_allocator is not None:
            # a started report from the host doubles as proof the copy is
            # live again (clears the reboot-reconcile verification mark)
            self.allocation.gateway_allocator.note_started(sr)

        def update(state: ClusterState) -> ClusterState:
            return self.allocation.apply_started_shards(state, [sr])
        return self._submit(f"shard-started {sr.index}[{sr.shard_id}]",
                            update)

    def _on_shard_failed(self, req: Dict[str, Any], sender: str) -> Deferred:
        sr = ShardRouting.from_dict(req["shard"])
        reason = req.get("reason")

        def update(state: ClusterState) -> ClusterState:
            return self.allocation.apply_failed_shard(state, sr,
                                                      reason=reason)
        return self._submit(f"shard-failed {sr.index}[{sr.shard_id}]",
                            update)


class MasterClient:
    """Coordinator-side: route a request to the elected master, retrying
    through elections (TransportMasterNodeAction's retry-on-master-change).

    Retries run through the unified RetryableAction (utils/retry.py):
    jittered-exponential backoff decorrelates the no-master retry storm a
    whole cluster produces during an election, instead of every caller
    re-polling on the same fixed beat."""

    def __init__(self, ts: TransportService, coordinator: Coordinator):
        self.ts = ts
        self.coordinator = coordinator
        # the most recent retry loop, observable for tests/telemetry
        self.last_retry: Optional["RetryableAction"] = None

    @staticmethod
    def _is_retryable(err: Exception) -> bool:
        # stale master pointer or mid-election: keep retrying until a new
        # master commits (TransportMasterNodeAction retry). Timeouts are
        # NOT retried — master actions include non-idempotent mutations.
        from elasticsearch_tpu_torch.utils.retry import transient_cluster_error
        return transient_cluster_error(err)

    def execute(self, action: str, request: Dict[str, Any],
                on_done: Callable[[Optional[Dict[str, Any]],
                                   Optional[Exception]], None],
                timeout: float = MASTER_TIMEOUT) -> None:
        scheduler = self.coordinator.scheduler

        def attempt(cb) -> None:
            master = self.coordinator.applied_state.master_node_id
            if self.coordinator.mode == "LEADER":
                master = self.coordinator.node.node_id
            if master is None:
                cb(None, NotMasterError("no elected master"))
                return
            self.ts.send_request(master, action, request, cb,
                                 timeout=timeout)

        self.last_retry = RetryableAction(
            scheduler, attempt, on_done,
            initial_delay=MASTER_RETRY_DELAY, max_delay=5.0,
            timeout=timeout, is_retryable=self._is_retryable)
        self.last_retry.run()


class BroadcastActions:
    """Refresh / flush / force-merge across every shard copy of an index
    (TransportBroadcastReplicationAction family)."""

    def __init__(self, node_id: str, indices: IndicesService,
                 ts: TransportService,
                 state_supplier: Callable[[], ClusterState]):
        self.node_id = node_id
        self.indices = indices
        self.ts = ts
        self.state = state_supplier
        ts.register_handler(REFRESH_SHARD, self._on_refresh)
        ts.register_handler(FLUSH_SHARD, self._on_flush)
        ts.register_handler(FORCEMERGE_SHARD, self._on_forcemerge)
        ts.register_handler(STATS_SHARD, self._on_stats)

    def _on_refresh(self, req, sender):
        self.indices.shard(req["index"], req["shard"]).engine.refresh()
        return {"ok": True}

    def _on_flush(self, req, sender):
        self.indices.shard(req["index"], req["shard"]).engine.flush()
        return {"ok": True}

    def _on_forcemerge(self, req, sender):
        self.indices.shard(req["index"], req["shard"]).engine.force_merge(
            req.get("max_num_segments", 1))
        return {"ok": True}

    def _on_stats(self, req, sender):
        shard = self.indices.shard(req["index"], req["shard"])
        stats = shard.engine.stats()
        return {"primary": shard.primary,
                "docs": stats.get("doc_count", 0),
                "segments": stats.get("num_segments", 0),
                "translog_ops": stats.get("translog_ops", 0),
                "search": dict(shard.search_stats)}

    def broadcast(self, action: str, index_expression: str,
                  on_done: Callable[[Dict[str, Any]], None],
                  extra: Optional[Dict[str, Any]] = None,
                  names: Optional[List[str]] = None) -> None:
        state = self.state()
        targets: List[ShardRouting] = []
        if names is None:
            names = resolve_index_expression(index_expression, state.metadata)
        for name in names:
            if not state.routing_table.has_index(name):
                continue
            for sr in state.routing_table.index(name).all_shards():
                # ALL assigned copies, not just active ones: an
                # INITIALIZING replica already receives write fan-out (it
                # is in-sync), so skipping it here would leave acked docs
                # invisible on it after it starts — the
                # TransportBroadcastReplicationAction family refreshes
                # through the whole replication group for the same reason.
                # A copy whose shard isn't ready yet just counts failed.
                if sr.assigned and sr.node_id is not None:
                    targets.append(sr)
        result = {"total": len(targets), "successful": 0, "failed": 0}
        payloads: List[Dict[str, Any]] = []
        if not targets:
            on_done({"_shards": result, "payloads": payloads})
            return
        pending = {"n": len(targets)}

        def one(sr: ShardRouting) -> None:
            req = {"index": sr.index, "shard": sr.shard_id}
            req.update(extra or {})

            def cb(resp, err):
                if err is None:
                    result["successful"] += 1
                    payloads.append({"index": sr.index,
                                     "shard": sr.shard_id, **resp})
                else:
                    result["failed"] += 1
                pending["n"] -= 1
                if pending["n"] == 0:
                    on_done({"_shards": result, "payloads": payloads})
            self.ts.send_request(sr.node_id, action, req, cb, timeout=60.0)
        for sr in targets:
            one(sr)


def _resize_replicas(irt: IndexRoutingTable, n_replicas: int
                     ) -> IndexRoutingTable:
    shards = {}
    for sid, group in irt.shards.items():
        primaries = [sr for sr in group if sr.primary]
        replicas = [sr for sr in group if not sr.primary]
        # keep assigned replicas first (drop surplus), add fresh unassigned
        # slots for any shortfall
        replicas.sort(key=lambda sr: not sr.assigned)
        keep: List[ShardRouting] = list(primaries) + replicas[:n_replicas]
        while len(keep) - len(primaries) < n_replicas:
            keep.append(ShardRouting(index=irt.index, shard_id=sid,
                                     primary=False))
        shards[sid] = tuple(keep)
    return IndexRoutingTable(index=irt.index, shards=shards)


def cluster_health(state: ClusterState,
                   index: Optional[str] = None,
                   unverified: Optional[List[Dict[str, Any]]] = None
                   ) -> Dict[str, Any]:
    """green: all copies active; yellow: all primaries active; red: some
    primary inactive (ClusterHealthStatus semantics).

    ``unverified``: STARTED copies the master's gateway allocator has not
    yet confirmed are actually hosted (the host process rebooted and the
    reconcile fetch hasn't seen the shard live again). They count as
    not-active — health must not report green while a STARTED-routed
    shard has no live local copy."""
    routing = state.routing_table
    names = ([state.metadata.index(index).name] if index
             else list(routing.indices))
    pending = {(u["index"], u["shard"], u["node"])
               for u in (unverified or [])}
    active_primary = 0
    active_total = 0
    unassigned = 0
    initializing = 0
    relocating = 0
    pending_verify = 0
    status = "green"
    for name in names:
        if not routing.has_index(name):
            continue
        for sr in routing.index(name).all_shards():
            if sr.state == ShardState.UNASSIGNED:
                unassigned += 1
                status = "red" if sr.primary else (
                    "yellow" if status == "green" else status)
            elif sr.state == ShardState.INITIALIZING:
                initializing += 1
                status = "red" if sr.primary else (
                    "yellow" if status == "green" else status)
            elif (sr.index, sr.shard_id, sr.node_id) in pending:
                # routed STARTED, but its rebooted host hasn't proven it
                # serves the copy: treat like an initializing shard
                pending_verify += 1
                initializing += 1
                status = "red" if sr.primary else (
                    "yellow" if status == "green" else status)
            else:
                active_total += 1
                if sr.primary:
                    active_primary += 1
                if sr.state == ShardState.RELOCATING:
                    relocating += 1
    out = {
        "cluster_name": state.cluster_name,
        "status": status,
        "number_of_nodes": len(state.nodes),
        "number_of_data_nodes": len(state.data_nodes()),
        "active_primary_shards": active_primary,
        "active_shards": active_total,
        "relocating_shards": relocating,
        "initializing_shards": initializing,
        "unassigned_shards": unassigned,
        "timed_out": False,
    }
    if pending_verify:
        out["unverified_started_shards"] = pending_verify
    return out
