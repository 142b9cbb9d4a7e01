"""Transforms: pivot a source index into an entity-centric dest index.

Reference: x-pack/plugin/transform — a persistent task pages a composite
aggregation over the source and bulk-writes one summary document per
group into the destination; date_histogram group_bys make this the
rollup mechanism as well. Here the transform definitions replicate in
cluster-state custom metadata, and the master runs due transforms on a
poll loop (the continuous mode recomputes the full pivot each trigger —
exact, and honest about the tradeoff: checkpoint-incremental updates are
an optimization this build does not claim).

Pivot shape (PUT _transform/{id}):
  {"source": {"index": "orders"},
   "dest": {"index": "daily_totals"},
   "frequency": "60s",                       # continuous mode; absent = batch
   "pivot": {
     "group_by": {"day": {"date_histogram": {"field": "ts",
                                             "fixed_interval": "1d"}},
                  "sku": {"terms": {"field": "sku"}}},
     "aggregations": {"total": {"sum": {"field": "amount"}}}}}
"""

from __future__ import annotations

import hashlib
import json
import logging
from typing import Any, Dict, List, Optional

from elasticsearch_tpu_torch.utils.errors import (
    IllegalArgumentError, ResourceNotFoundError,
)
from elasticsearch_tpu_torch.utils.settings import parse_time_to_seconds

logger = logging.getLogger(__name__)

SECTION = "transforms"
POLL_INTERVAL = 5.0
MAX_GROUPS = 10_000


def _doc_id(key: Dict[str, Any]) -> str:
    return hashlib.blake2b(json.dumps(key, sort_keys=True).encode(),
                           digest_size=16).hexdigest()


class TransformService:
    def __init__(self, node) -> None:
        self.node = node
        self._running = False
        self._timer = None
        # id -> runtime state (master-local; definitions are in metadata)
        self._state: Dict[str, Dict[str, Any]] = {}

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        self._running = True
        self._schedule()

    def stop(self) -> None:
        self._running = False
        if self._timer is not None:
            self._timer.cancel()

    def _schedule(self) -> None:
        if not self._running:
            return
        self._timer = self.node.scheduler.schedule(POLL_INTERVAL, self._tick)

    def _tick(self) -> None:
        if not self._running:
            return
        try:
            if self.node.coordinator.mode == "LEADER":
                self.run_due()
        except Exception:  # noqa: BLE001 — the loop must survive
            logger.exception("transform tick failed")
        self._schedule()

    # -- definitions ------------------------------------------------------

    def _defs(self) -> Dict[str, Any]:
        return dict(self.node._applied_state()
                    .metadata.custom.get(SECTION, {}))

    @staticmethod
    def validate(body: Dict[str, Any]) -> None:
        if not (body.get("source") or {}).get("index"):
            raise IllegalArgumentError("transform requires [source.index]")
        if not (body.get("dest") or {}).get("index"):
            raise IllegalArgumentError("transform requires [dest.index]")
        pivot = body.get("pivot") or {}
        if not pivot.get("group_by"):
            raise IllegalArgumentError(
                "transform requires [pivot.group_by]")

    def put(self, transform_id: str, body: Dict[str, Any], on_done) -> None:
        try:
            self.validate(body or {})
        except IllegalArgumentError as e:
            on_done(None, e)
            return
        from elasticsearch_tpu_torch.action.admin import PUT_CUSTOM
        entity = dict(body)
        entity.setdefault("started", False)
        self.node.master_client.execute(
            PUT_CUSTOM, {"section": SECTION, "name": transform_id,
                         "body": entity}, on_done)

    def delete(self, transform_id: str, on_done) -> None:
        from elasticsearch_tpu_torch.action.admin import DELETE_CUSTOM
        self._state.pop(transform_id, None)
        self.node.master_client.execute(
            DELETE_CUSTOM, {"section": SECTION, "name": transform_id},
            on_done)

    def get(self, transform_id: Optional[str] = None) -> Dict[str, Any]:
        defs = self._defs()
        if transform_id is not None:
            if transform_id not in defs:
                raise ResourceNotFoundError(
                    f"transform [{transform_id}] not found")
            defs = {transform_id: defs[transform_id]}
        out = []
        for tid, d in sorted(defs.items()):
            stats = self._state.get(tid, {})
            out.append({"id": tid, **d,
                        "stats": {
                            "pages_processed": stats.get("runs", 0),
                            "documents_indexed": stats.get("docs", 0),
                            "last_run_millis": stats.get("last_ms")}})
        return {"count": len(out), "transforms": out}

    def set_started(self, transform_id: str, started: bool,
                    on_done) -> None:
        defs = self._defs()
        if transform_id not in defs:
            on_done(None, ResourceNotFoundError(
                f"transform [{transform_id}] not found"))
            return
        body = {**defs[transform_id], "started": started}
        from elasticsearch_tpu_torch.action.admin import PUT_CUSTOM

        def after(resp, err):
            if err is None and started:
                # batch transforms run once immediately on _start
                self.run_one(transform_id, body, _log_err)
            on_done(resp if err is None else None, err)
        self.node.master_client.execute(
            PUT_CUSTOM, {"section": SECTION, "name": transform_id,
                         "body": body}, after)

    # -- execution --------------------------------------------------------

    def run_due(self) -> None:
        now = self.node.scheduler.now()
        for tid, d in self._defs().items():
            if not d.get("started") or not d.get("frequency"):
                continue   # batch transforms only run on _start
            freq = parse_time_to_seconds(d["frequency"])
            state = self._state.setdefault(tid, {})
            if now - state.get("last_run", -1e18) < freq:
                continue
            state["last_run"] = now
            self.run_one(tid, d, _log_err)

    def run_one(self, transform_id: str, d: Dict[str, Any],
                on_done) -> None:
        """One pivot pass: composite over source -> bulk into dest."""
        pivot = d["pivot"]
        sources: List[Dict[str, Any]] = []
        for name, spec in pivot["group_by"].items():
            sources.append({name: spec})
        body = {
            "size": 0,
            **({"query": d["source"]["query"]}
               if d["source"].get("query") else {}),
            "aggs": {"pivot": {
                "composite": {"size": MAX_GROUPS, "sources": sources},
                **({"aggs": pivot.get("aggregations")}
                   if pivot.get("aggregations") else {}),
            }},
        }

        def on_search(resp, err):
            if err is not None:
                on_done(None, err)
                return
            buckets = resp["aggregations"]["pivot"]["buckets"]
            items = []
            for b in buckets:
                doc = dict(b["key"])
                for agg_name in (pivot.get("aggregations") or {}):
                    doc[agg_name] = (b.get(agg_name) or {}).get("value")
                doc["_transform_doc_count"] = b["doc_count"]
                items.append({"action": "index",
                              "index": d["dest"]["index"],
                              "id": _doc_id(b["key"]), "source": doc})

            def on_bulk(bulk_resp):
                # item-level bulk failures must surface: stats count only
                # docs that actually indexed, and the run reports an error
                failed = [r for r in (bulk_resp or {}).get("items", [])
                          if "error" in r]
                indexed = len(items) - len(failed)
                state = self._state.setdefault(transform_id, {})
                state["runs"] = state.get("runs", 0) + 1
                state["docs"] = state.get("docs", 0) + indexed
                state["last_ms"] = int(
                    self.node.scheduler.wall_now() * 1000)
                err = None
                if failed:
                    err = IllegalArgumentError(
                        f"transform [{transform_id}] bulk failed for "
                        f"{len(failed)}/{len(items)} documents: "
                        f"{failed[0].get('error')}")
                on_done({"documents_indexed": indexed}, err)
            if not items:
                on_bulk({"items": []})
                return
            self.node.bulk_action.execute(items, on_bulk)
        self.node.search_action.execute(
            d["source"]["index"], body, on_search)


def _log_err(_resp, err) -> None:
    if err is not None:
        logger.warning("transform run failed: %s", err)
