"""Watcher: scheduled search -> condition -> actions.

Reference: x-pack/plugin/watcher — TickerScheduleTriggerEngine fires
watches, ExecutionService runs input (search) -> condition (compare) ->
actions (index/logging). Watch definitions replicate in cluster-state
custom metadata; the elected master runs due watches on a poll loop.

Watch shape (PUT _watcher/watch/{id}):
  {"trigger": {"schedule": {"interval": "30s"}},
   "input": {"search": {"request": {"indices": ["logs-*"],
                                    "body": {...}}}},
   "condition": {"compare": {"ctx.payload.hits.total.value": {"gt": 0}}},
   "actions": {"store": {"index": {"index": "alerts"}},
               "log": {"logging": {"text": "fired!"}}}}
"""

from __future__ import annotations

import logging
import uuid
from typing import Any, Dict, Optional

from elasticsearch_tpu_torch.utils.errors import (
    IllegalArgumentError, ResourceNotFoundError,
)
from elasticsearch_tpu_torch.utils.settings import parse_time_to_seconds

logger = logging.getLogger(__name__)

SECTION = "watches"
POLL_INTERVAL = 1.0


def _path_get(obj: Any, dotted: str) -> Any:
    node = obj
    for part in dotted.split("."):
        if isinstance(node, dict) and part in node:
            node = node[part]
        elif isinstance(node, list) and part.isdigit() and \
                int(part) < len(node):
            node = node[int(part)]
        else:
            return None
    return node


_COMPARE_OPS = {
    "gt": lambda v, w: v > w, "gte": lambda v, w: v >= w,
    "lt": lambda v, w: v < w, "lte": lambda v, w: v <= w,
    "eq": lambda v, w: v == w, "not_eq": lambda v, w: v != w,
}


def evaluate_condition(condition: Optional[Dict[str, Any]],
                       payload: Dict[str, Any]) -> bool:
    """always (default) | never | compare {path: {op: value}}."""
    if not condition or "always" in condition:
        return True
    if "never" in condition:
        return False
    compare = condition.get("compare")
    if compare is None:
        raise IllegalArgumentError(
            f"unsupported watch condition {sorted(condition)}")
    for path, ops in compare.items():
        key = path[len("ctx.payload."):] if \
            path.startswith("ctx.payload.") else path
        value = _path_get(payload, key)
        for op, want in ops.items():
            if op not in _COMPARE_OPS:
                # a typo'd op must never read as "condition satisfied"
                raise IllegalArgumentError(
                    f"unknown compare operator [{op}]; "
                    f"supported: {sorted(_COMPARE_OPS)}")
            if value is None or not _COMPARE_OPS[op](value, want):
                return False
    return True


class WatcherService:
    def __init__(self, node) -> None:
        self.node = node
        self._running = False
        self._timer = None
        self._state: Dict[str, Dict[str, Any]] = {}   # id -> runtime stats

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
        except Exception:  # noqa: BLE001
            logger.exception("watcher tick failed")
        self._schedule()

    # -- definitions ------------------------------------------------------

    def _defs(self) -> Dict[str, Any]:
        return dict(self.node._applied_state()
                    .metadata.custom.get(SECTION, {}))

    @staticmethod
    def validate(body: Dict[str, Any]) -> None:
        interval = ((body.get("trigger") or {}).get("schedule") or {}) \
            .get("interval")
        if not interval:
            raise IllegalArgumentError(
                "watch requires [trigger.schedule.interval]")
        request = ((body.get("input") or {}).get("search") or {}) \
            .get("request") or {}
        if not request.get("indices"):
            raise IllegalArgumentError(
                "watch requires [input.search.request.indices]")
        evaluate_condition(body.get("condition"), {})   # shape check

    def put(self, watch_id: str, body: Dict[str, Any], on_done) -> None:
        try:
            self.validate(body or {})
        except IllegalArgumentError as e:
            on_done(None, e)
            return
        from elasticsearch_tpu_torch.action.admin import PUT_CUSTOM
        entity = dict(body)
        entity.setdefault("active", True)
        self.node.master_client.execute(
            PUT_CUSTOM, {"section": SECTION, "name": watch_id,
                         "body": entity},
            lambda resp, err: on_done(
                {"_id": watch_id, "created": True} if err is None else None,
                err))

    def delete(self, watch_id: str, on_done) -> None:
        from elasticsearch_tpu_torch.action.admin import DELETE_CUSTOM
        self._state.pop(watch_id, None)
        self.node.master_client.execute(
            DELETE_CUSTOM, {"section": SECTION, "name": watch_id}, on_done)

    def get(self, watch_id: str) -> Dict[str, Any]:
        d = self._defs().get(watch_id)
        if d is None:
            raise ResourceNotFoundError(f"watch [{watch_id}] not found")
        stats = self._state.get(watch_id, {})
        return {"_id": watch_id, "watch": d, "status": {
            "executions": stats.get("executions", 0),
            "fired": stats.get("fired", 0),
            "last_checked_millis": stats.get("last_ms")}}

    # -- execution --------------------------------------------------------

    def run_due(self) -> None:
        now = self.node.scheduler.now()
        for wid, d in self._defs().items():
            if not d.get("active", True):
                continue
            interval = parse_time_to_seconds(
                d["trigger"]["schedule"]["interval"])
            state = self._state.setdefault(wid, {})
            if now - state.get("last_run", -1e18) < interval:
                continue
            state["last_run"] = now
            self.execute_watch(wid, d)

    def execute_watch(self, watch_id: str, d: Dict[str, Any]) -> None:
        request = d["input"]["search"]["request"]
        indices = request.get("indices")
        index_expr = ",".join(indices) if isinstance(indices, list) \
            else str(indices)

        def on_search(resp, err):
            state = self._state.setdefault(watch_id, {})
            state["executions"] = state.get("executions", 0) + 1
            state["last_ms"] = int(self.node.scheduler.wall_now() * 1000)
            if err is not None:
                logger.warning("watch [%s] input failed: %s", watch_id, err)
                return
            if not evaluate_condition(d.get("condition"), resp):
                return
            state["fired"] = state.get("fired", 0) + 1
            self._run_actions(watch_id, d, resp)
        self.node.search_action.execute(
            index_expr, request.get("body") or {}, on_search)

    def _run_actions(self, watch_id: str, d: Dict[str, Any],
                     payload: Dict[str, Any]) -> None:
        for name, action in (d.get("actions") or {}).items():
            if "logging" in action:
                logger.warning("watch [%s] action [%s]: %s", watch_id, name,
                               action["logging"].get("text", ""))
            elif "index" in action:
                dest = action["index"]["index"]
                doc = {
                    "watch_id": watch_id,
                    "fired_at_millis": int(
                        self.node.scheduler.wall_now() * 1000),
                    "hits_total": _path_get(payload, "hits.total.value"),
                }
                self.node.bulk_action.execute(
                    [{"action": "index", "index": dest,
                      "id": uuid.uuid4().hex, "source": doc}],
                    lambda _resp: None)
            else:
                logger.warning("watch [%s] action [%s]: unsupported type",
                               watch_id, name)
