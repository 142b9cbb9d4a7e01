"""Single-document distributed actions: get, index, delete, update.

Reference analogs: action/get/TransportGetAction (routed realtime get),
action/index|delete (single-item bulk under the hood, as in modern ES),
action/update/TransportUpdateAction.java (get + merge + indexed with
if_seq_no, retried on conflict).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from elasticsearch_tpu_torch.action.bulk import TransportBulkAction
from elasticsearch_tpu_torch.cluster.routing import ShardState
from elasticsearch_tpu_torch.cluster.state import ClusterState
from elasticsearch_tpu_torch.indices.indices_service import IndicesService
from elasticsearch_tpu_torch.transport.transport import TransportService
from elasticsearch_tpu_torch.utils.errors import (
    DocumentMissingError, IndexNotFoundError, UnavailableShardsError,
    VersionConflictError,
)
from elasticsearch_tpu_torch.utils.murmur3 import shard_id_for

GET_SHARD = "indices:data/read/get[s]"

DoneFn = Callable[[Optional[Dict[str, Any]], Optional[Exception]], None]


class TransportGetAction:
    def __init__(self, node_id: str, indices: IndicesService,
                 ts: TransportService,
                 state_supplier: Callable[[], ClusterState]):
        self.node_id = node_id
        self.indices = indices
        self.ts = ts
        self.state = state_supplier
        self._rr = 0
        ts.register_handler(GET_SHARD, self._on_get)

    def execute(self, index: str, doc_id: str, on_done: DoneFn,
                routing: Optional[str] = None,
                realtime: bool = True, prefer_primary: bool = False) -> None:
        state = self.state()
        # a closed index rejects point reads too
        # (IndexClosedException semantics)
        try:
            if state.metadata.index(index).state == "close":
                from elasticsearch_tpu_torch.utils.errors import (
                    IllegalArgumentError,
                )
                err = IllegalArgumentError(
                    f"closed index [{index}] cannot serve gets "
                    f"(index_closed_exception)")
                on_done(None, err)
                return
        except Exception:  # noqa: BLE001 — missing index 404s below
            pass
        self._rr += 1
        routed_shard_request(
            self.ts, state, GET_SHARD, index, doc_id, on_done,
            routing=routing, extra={"realtime": realtime},
            prefer_primary=realtime or prefer_primary, rotate=self._rr)

    def _on_get(self, req: Dict[str, Any], sender: str) -> Dict[str, Any]:
        shard = self.indices.shard(req["index"], req["shard"])
        doc = shard.engine.get(req["id"], realtime=req.get("realtime", True))
        if doc is None:
            return {"_index": req["index"], "_id": req["id"], "found": False}
        out = dict(doc)
        out.update({"_index": req["index"], "found": True})
        return out


class TransportUpdateAction:
    """get → merge (partial doc or script) → index-with-if_seq_no, retried
    on concurrent-modification conflicts."""

    def __init__(self, get_action: TransportGetAction,
                 bulk_action: TransportBulkAction):
        self.get_action = get_action
        self.bulk = bulk_action

    def execute(self, index: str, doc_id: str, body: Dict[str, Any],
                on_done: DoneFn, routing: Optional[str] = None,
                retry_on_conflict: int = 3) -> None:
        attempts = {"left": retry_on_conflict + 1}

        def attempt() -> None:
            self.get_action.execute(index, doc_id, got, routing=routing,
                                    prefer_primary=True)

        def got(doc: Optional[Dict[str, Any]],
                err: Optional[Exception]) -> None:
            if err is not None:
                on_done(None, err)
                return
            if not doc.get("found"):
                if "upsert" in body:
                    new_source = dict(body["upsert"])
                elif body.get("doc_as_upsert") and "doc" in body:
                    new_source = dict(body["doc"])
                else:
                    on_done(None, DocumentMissingError(index, doc_id))
                    return
                item = {"action": "create", "index": index, "id": doc_id,
                        "source": new_source, "routing": routing}
            else:
                source = dict(doc["_source"])
                if "doc" in body:
                    _deep_merge(source, body["doc"])
                elif "script" in body:
                    source = _apply_script(source, body["script"])
                    if source is None:   # ctx.op = 'delete'
                        item = {"action": "delete", "index": index,
                                "id": doc_id,
                                "if_seq_no": doc["_seq_no"],
                                "if_primary_term": doc["_primary_term"]}
                        self.bulk.execute([item], indexed)
                        return
                item = {"action": "index", "index": index, "id": doc_id,
                        "source": source, "routing": routing,
                        "if_seq_no": doc["_seq_no"],
                        "if_primary_term": doc["_primary_term"]}
            self.bulk.execute([item], indexed)

        def indexed(resp: Dict[str, Any]) -> None:
            item = next(iter(resp["items"][0].values()))
            if "error" in item:
                if item["status"] == 409 and attempts["left"] > 1:
                    attempts["left"] -= 1
                    attempt()
                    return
                on_done(None, VersionConflictError(item["error"]["reason"])
                        if item["status"] == 409
                        else UnavailableShardsError(item["error"]["reason"]))
                return
            on_done(item, None)

        attempt()


def _deep_merge(into: Dict[str, Any], other: Dict[str, Any]) -> None:
    for k, v in other.items():
        if isinstance(v, dict) and isinstance(into.get(k), dict):
            _deep_merge(into[k], v)
        else:
            into[k] = v


def _apply_script(source: Dict[str, Any],
                  script: Any) -> Optional[Dict[str, Any]]:
    """Run an update script over ctx._source (ScriptService analog; the
    script engine is the sandboxed painless-lite evaluator)."""
    from elasticsearch_tpu_torch.script.engine import execute_update_script
    return execute_update_script(source, script)


def routed_shard_request(ts: TransportService, state: ClusterState,
                         action: str, index: str, doc_id: str,
                         on_done: DoneFn,
                         routing: Optional[str] = None,
                         extra: Optional[Dict[str, Any]] = None,
                         prefer_primary: bool = False,
                         rotate: int = 0,
                         timeout: float = 30.0) -> None:
    """Shared routing state machine for single-document reads: resolve
    the owning shard via murmur3 routing, pick copies (primary-first when
    the caller needs unrefreshed visibility, else round-robin by
    ``rotate``), and fail over sequentially (TransportSingleShardAction
    analog — get, termvectors, and explain all ride this)."""
    try:
        meta = state.metadata.index(index)
    except IndexNotFoundError as e:
        on_done(None, e)
        return
    shard = shard_id_for(routing or doc_id, meta.number_of_shards)
    group = [sr for sr in
             state.routing_table.index(meta.name).shard_group(shard)
             if sr.active and sr.node_id is not None]
    if prefer_primary:
        # realtime reads must see unrefreshed writes: only the primary's
        # buffers are guaranteed current (the reference's _primary path)
        group = [sr for sr in group if sr.primary] or group
    if not group:
        on_done(None, UnavailableShardsError(
            f"no active copy of [{meta.name}][{shard}]"))
        return
    rot = rotate % len(group)
    copies = group[rot:] + group[:rot]
    req = {"index": meta.name, "shard": shard, "id": doc_id,
           **(extra or {})}

    def attempt(idx: int) -> None:
        def cb(resp, err):
            if err is not None and idx + 1 < len(copies):
                attempt(idx + 1)    # fail over to the next copy
            else:
                on_done(resp, err)
        ts.send_request(copies[idx].node_id, action, req, cb,
                        timeout=timeout)
    attempt(0)
