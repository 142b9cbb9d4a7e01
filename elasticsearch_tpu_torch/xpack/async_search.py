"""Async search: submit now, fetch the (partial) response later.

Reference: x-pack/plugin/async-search — TransportSubmitAsyncSearchAction
keeps a mutable search task whose response can be polled by id, with a
wait_for_completion_timeout fast path and keep-alive-based expiry. Here
the search runs through the ordinary TransportSearchAction (as a
cancellable task) and the coordinator keeps the async state in memory;
ids are node-local like the reference's pre-index-persistence behavior.
"""

from __future__ import annotations

import uuid
from typing import Any, Dict, Optional

from elasticsearch_tpu_torch.utils.errors import ResourceNotFoundError
from elasticsearch_tpu_torch.utils.settings import parse_time_to_seconds

DEFAULT_WAIT = 1.0
DEFAULT_KEEP_ALIVE = 5 * 60.0


class AsyncSearchService:
    def __init__(self, node) -> None:
        self.node = node
        self._searches: Dict[str, Dict[str, Any]] = {}

    # -- lifecycle --------------------------------------------------------

    def _reap(self) -> None:
        now = self.node.scheduler.now()
        for sid in [s for s, e in self._searches.items()
                    if e["expiration"] < now]:
            del self._searches[sid]

    def _status(self, entry: Dict[str, Any]) -> Dict[str, Any]:
        out = {
            "id": entry["id"],
            "is_running": entry["running"],
            "is_partial": entry["running"] or entry["error"] is not None,
            "start_time_in_millis": int(entry["start"] * 1000),
            "expiration_time_in_millis": int(entry["expiration"] * 1000),
        }
        if entry["response"] is not None:
            out["response"] = entry["response"]
        if entry["error"] is not None:
            err = entry["error"]
            out["error"] = {"type": type(err).__name__, "reason": str(err)}
        return out

    # -- API --------------------------------------------------------------

    def submit(self, index_expression: str, body: Dict[str, Any],
               on_done, wait_for_completion: Any = None,
               keep_alive: Any = None, owner: Optional[str] = None) -> None:
        self._reap()
        wait_s = (parse_time_to_seconds(wait_for_completion)
                  if wait_for_completion is not None else DEFAULT_WAIT)
        keep_s = (parse_time_to_seconds(keep_alive)
                  if keep_alive is not None else DEFAULT_KEEP_ALIVE)
        sid = uuid.uuid4().hex
        now = self.node.scheduler.now()
        entry: Dict[str, Any] = {
            "id": sid, "running": True, "response": None, "error": None,
            "start": now, "expiration": now + keep_s, "owner": owner,
        }
        self._searches[sid] = entry
        responded = {"flag": False}

        def respond() -> None:
            if responded["flag"]:
                return
            responded["flag"] = True
            on_done(self._status(entry), None)

        def search_done(resp: Optional[Dict[str, Any]],
                        err: Optional[Exception]) -> None:
            entry["running"] = False
            entry["response"] = resp
            entry["error"] = err
            respond()

        self.node.search_action.execute(index_expression, body, search_done)
        # fast path: if the search beats the wait timeout, the submit call
        # returns the COMPLETE response; otherwise it returns the running
        # id and the client polls (SubmitAsyncSearchRequest semantics)
        self.node.scheduler.schedule(max(wait_s, 0.0), respond)

    def _owned(self, sid: str, owner: Optional[str]) -> Dict[str, Any]:
        entry = self._searches.get(sid)
        # a stored response is the OWNER's data: another principal gets
        # the same 404 as a nonexistent id (no existence oracle)
        if entry is None or entry.get("owner") != owner:
            raise ResourceNotFoundError(f"async search [{sid}] not found")
        return entry

    def get(self, sid: str, owner: Optional[str] = None) -> Dict[str, Any]:
        self._reap()
        return self._status(self._owned(sid, owner))

    def delete(self, sid: str, owner: Optional[str] = None
               ) -> Dict[str, Any]:
        self._reap()
        self._owned(sid, owner)
        del self._searches[sid]
        return {"acknowledged": True}
