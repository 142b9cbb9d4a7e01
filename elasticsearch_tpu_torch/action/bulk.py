"""Bulk coordination: group items by shard, auto-create indices, fan out.

Reference analog: action/bulk/TransportBulkAction.java:98 — auto-create
missing indices through the master (:235), group items by
``OperationRouting.generateShardId`` (murmur3, :415), fan each group to its
primary via the shard bulk action, and reassemble responses in request
order.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from elasticsearch_tpu_torch.action.replication import TransportShardBulkAction
from elasticsearch_tpu_torch.cluster.state import ClusterState
from elasticsearch_tpu_torch.utils.murmur3 import shard_id_for


CreateIndexFn = Callable[[str, Callable[[Optional[Exception]], None]], None]


class TransportBulkAction:
    def __init__(self, shard_bulk: TransportShardBulkAction,
                 state_supplier: Callable[[], ClusterState],
                 create_index: CreateIndexFn,
                 ingest_service=None, thread_pool=None):
        self.shard_bulk = shard_bulk
        self.state = state_supplier
        self.create_index = create_index
        self.ingest = ingest_service
        # indexing-pressure accounting (IndexingPressure.java analog);
        # None in unit tests that exercise the bulk path alone
        self.thread_pool = thread_pool

    def execute(self, items: List[Dict[str, Any]],
                on_done: Callable[[Dict[str, Any]], None],
                payload_bytes: Optional[int] = None) -> None:
        """items: [{action, index, id, source?, routing?, pipeline?,
        if_seq_no?, ...}]. ``payload_bytes`` is the raw NDJSON request
        length when the caller has it (the REST _bulk route) — the
        reference accounts REQUEST bytes, and charging the wire length
        avoids re-serializing every source on the hot path."""
        state = self.state()
        if self.thread_pool is not None:
            ip = getattr(self.thread_pool, "indexing_pressure", None)
            if ip is not None:
                ip.configure_from_state(state)
            est_bytes = payload_bytes if payload_bytes is not None else \
                estimate_items_bytes(items)
            try:
                if ip is not None:
                    ip.acquire("coordinating", est_bytes)
                else:
                    self.thread_pool.acquire_write_bytes(est_bytes)
            except Exception as e:  # noqa: BLE001 — backpressure, not fault
                retry_after = int((getattr(e, "metadata", None) or {})
                                  .get("retry_after", 1))
                # top-level error carries retry_after so the REST
                # layer's retry_after_of finds it and emits the
                # Retry-After header on the 429; per-item rejection
                # entries so single-doc callers (NodeClient.
                # _single_item_bulk reads items[0]) surface the 429
                # instead of crashing on an empty list
                on_done({"errors": True, "rejected": True,
                         "status": 429,
                         "error": {
                             "type": "es_rejected_execution_exception",
                             "reason": str(e),
                             "retry_after": retry_after},
                         "items": [{item.get("action", "index"): {
                             "id": item.get("id"),
                             "_index": item.get("index"),
                             "status": 429,
                             "error": {
                                 "type":
                                     "es_rejected_execution_exception",
                                 "reason": str(e),
                                 "retry_after": retry_after}}}
                             for item in items]})
                return
            inner = on_done

            def on_done(resp):  # noqa: F811 — release wraps completion
                if ip is not None:
                    ip.release("coordinating", est_bytes)
                else:
                    self.thread_pool.release_write_bytes(est_bytes)
                inner(resp)
        # fresh list: positional edits below must not mutate the caller's
        # (ingest-less _run_pipelines returns its input unchanged)
        items = list(self._run_pipelines(state, items))
        # index.blocks.write (mounted searchable snapshots, frozen
        # indices, read-only settings) rejects writes with 403
        # (ClusterBlockException analog); checked AFTER pipelines since a
        # processor may redirect the item's target index
        from elasticsearch_tpu_torch.utils.errors import ClusterBlockError
        for pos, item in enumerate(items):
            name = item.get("index")
            if not name or "_ingest_error" in item or \
                    item.get("_dropped"):
                continue
            try:
                meta = state.metadata.index(name)   # resolves aliases
            except Exception:  # noqa: BLE001 — auto-create handles it
                continue
            block_err = None
            if meta.state == "close":
                block_err = ClusterBlockError(
                    f"index [{name}] is closed "
                    f"(index_closed_exception)")
                block_err.status = 400
            elif meta.settings.get("index.blocks.write"):
                block_err = ClusterBlockError(
                    f"index [{name}] blocked by: "
                    f"[FORBIDDEN/8/index write (api)]")
                # FORBIDDEN blocks are 403; the class default (503) is
                # for no-master/not-recovered blocks
                block_err.status = 403
            if block_err is not None:
                # copy before mutating: without pipelines the list holds
                # the CALLER's dicts, which must not accrete error state
                items[pos] = {**item, "_ingest_error": block_err}
        missing = sorted({item["index"] for item in items
                          if not item.get("_dropped")
                          and "_ingest_error" not in item
                          and not state.metadata.has_index(item["index"])})
        pending = {"n": len(missing)}
        if not missing:
            self._run(items, on_done)
            return

        def created(err: Optional[Exception]) -> None:
            # racing creates are fine: "already exists" is success here
            pending["n"] -= 1
            if pending["n"] == 0:
                self._run(items, on_done)

        for name in missing:
            self.create_index(name, created)

    def _run_pipelines(self, state: ClusterState,
                       items: List[Dict[str, Any]]
                       ) -> List[Dict[str, Any]]:
        """Transform items through ingest pipelines before routing
        (IngestService.executeBulkRequest analog). Dropped items are
        marked, not removed — responses stay positional."""
        if self.ingest is None:
            return items
        resolved: List[tuple] = []   # (item, pipeline_or_None)
        by_pipeline: Dict[str, List[Dict[str, Any]]] = {}
        for item in items:
            pipeline = item.get("pipeline")
            if pipeline is None and item.get("action") in ("index",
                                                           "create"):
                meta = (state.metadata.indices.get(item["index"])
                        if item.get("index") else None)
                if meta is not None:
                    pipeline = meta.settings.get(
                        "default_pipeline",
                        meta.settings.get("index.default_pipeline"))
            if not pipeline or pipeline == "_none" or \
                    item.get("action") not in ("index", "create"):
                resolved.append((item, None))
            else:
                resolved.append((item, pipeline))
                by_pipeline.setdefault(pipeline, []).append(item)
        # inference processors expand the whole chunk in one device
        # dispatch up front; the per-item run below hits the model cache
        for pipeline, group in by_pipeline.items():
            self.ingest.prewarm_inference(pipeline, group)
        out = []
        for item, pipeline in resolved:
            if pipeline is None:
                out.append(item)
                continue
            try:
                processed = self.ingest.process_item(pipeline, item)
            except Exception as e:  # noqa: BLE001 — per-item failure
                item = dict(item)
                item["_ingest_error"] = e
                out.append(item)
                continue
            if processed is None:
                item = dict(item)
                item["_dropped"] = True
                out.append(item)
            else:
                out.append(processed)
        return out

    def _run(self, items: List[Dict[str, Any]],
             on_done: Callable[[Dict[str, Any]], None]) -> None:
        state = self.state()
        groups: Dict[Tuple[str, int], List[Tuple[int, Dict[str, Any]]]] = {}
        responses: List[Optional[Dict[str, Any]]] = [None] * len(items)
        for pos, item in enumerate(items):
            if item.get("_dropped"):
                # ingest drop processor: acknowledged, never indexed
                responses[pos] = {"action": item.get("action", "index"),
                                  "_index": item.get("index"),
                                  "id": item.get("id"),
                                  "result": "noop", "status": 200}
                continue
            if "_ingest_error" in item:
                responses[pos] = _item_error(item, item["_ingest_error"])
                continue
            index = item["index"]
            try:
                meta = state.metadata.index(index)
            except Exception as e:  # noqa: BLE001 — per-item failure
                responses[pos] = _item_error(item, e)
                continue
            # alias routing (AliasMetadata.indexRouting): writes through
            # an alias that declares routing use it unless the item
            # carries its own
            alias_routing = (meta.alias_configs.get(index) or {}) \
                .get("routing")
            if alias_routing and not item.get("routing"):
                item = {**item, "routing": alias_routing}
            routing_key = item.get("routing") or item["id"]
            shard = shard_id_for(routing_key, meta.number_of_shards)
            groups.setdefault((meta.name, shard), []).append((pos, item))

        pending = {"n": len(groups)}
        if not groups:
            on_done(_bulk_response(responses))
            return

        def group_done(key: Tuple[str, int],
                       positions: List[int]) -> Callable:
            def cb(resp: Optional[Dict[str, Any]],
                   err: Optional[Exception]) -> None:
                if err is not None:
                    for pos in positions:
                        responses[pos] = _item_error(items[pos], err)
                else:
                    for pos, result in zip(positions, resp["items"]):
                        result = dict(result)
                        result["_index"] = key[0]
                        responses[pos] = result
                pending["n"] -= 1
                if pending["n"] == 0:
                    on_done(_bulk_response(responses))
            return cb

        for key, group in groups.items():
            positions = [pos for pos, _ in group]
            group_items = [item for _, item in group]
            self.shard_bulk.execute(key[0], key[1], group_items,
                                    group_done(key, positions))


def estimate_items_bytes(items: List[Dict[str, Any]]) -> int:
    """Cheap per-item byte estimate for internal (non-REST) bulk callers
    that never had a wire payload: repr of the source plus a fixed
    header allowance. The REST path never takes this — it charges the
    raw NDJSON length it already holds."""
    return sum(len(repr(item.get("source") or "")) + 64 for item in items)


def _item_error(item: Dict[str, Any], err: Exception) -> Dict[str, Any]:
    from elasticsearch_tpu_torch.utils.errors import write_pressure_info
    status = getattr(err, "status", 500)
    entry = {"action": item.get("action", "index"), "id": item.get("id"),
             "_index": item.get("index"),
             "error": {"type": type(err).__name__, "reason": str(err)},
             "status": status}
    # a primary-stage indexing-pressure rejection crosses the transport
    # stringified: re-type it to the ES wire name and recover its
    # Retry-After so the item entry is a CLEAN typed 429
    info = write_pressure_info(err)
    if info is not None:
        entry["error"]["type"] = "es_rejected_execution_exception"
        entry["error"]["retry_after"] = info["retry_after"]
        entry["status"] = 429
    return entry


def _bulk_response(responses: List[Optional[Dict[str, Any]]]
                   ) -> Dict[str, Any]:
    items = []
    errors = False
    for r in responses:
        r = r or {"error": {"type": "internal", "reason": "missing"},
                  "status": 500}
        action = r.pop("action", "index")
        errors = errors or "error" in r
        items.append({action: r})
    return {"errors": errors, "items": items}


def parse_bulk_body(lines: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """NDJSON action/source pairs -> normalized item dicts (the REST wire
    form of _bulk, RestBulkAction)."""
    items: List[Dict[str, Any]] = []
    i = 0
    n_auto = 0
    while i < len(lines):
        header = lines[i]
        action = next(iter(header))
        meta = header[action] or {}
        item: Dict[str, Any] = {
            "action": action,
            "index": meta.get("_index"),
            "id": meta.get("_id"),
            "routing": meta.get("routing"),
        }
        if meta.get("pipeline") is not None:
            item["pipeline"] = meta["pipeline"]
        if meta.get("if_seq_no") is not None:
            item["if_seq_no"] = meta["if_seq_no"]
        if meta.get("if_primary_term") is not None:
            item["if_primary_term"] = meta["if_primary_term"]
        if item["id"] is None:
            import uuid as uuid_mod
            item["id"] = uuid_mod.uuid4().hex[:20]
            n_auto += 1
        i += 1
        if action in ("index", "create", "update"):
            item["source"] = lines[i]
            i += 1
        items.append(item)
    return items
