"""REST dispatch: method+path-template routing to handlers.

Reference analog: rest/RestController.java:62 — a path trie keyed on
segments with {param} wildcards, per-method handler registration, uniform
error mapping (ElasticsearchException status → HTTP status, error body
shape). Handlers are callback-style so dispatch works identically under the
deterministic scheduler and the asyncio HTTP server.
"""

from __future__ import annotations

import json
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from elasticsearch_tpu_torch.utils.errors import SearchEngineError


@dataclass
class RestRequest:
    method: str
    path: str
    params: Dict[str, str] = field(default_factory=dict)   # from {templates}
    query: Dict[str, str] = field(default_factory=dict)    # ?k=v
    body: Any = None                                       # parsed JSON
    raw_body: bytes = b""
    headers: Dict[str, str] = field(default_factory=dict)  # lowercased keys
    # deprecation messages emitted while handling THIS request; the HTTP
    # server surfaces them as Warning: 299 headers
    # (DeprecationLogger/HeaderWarning analog)
    warnings: List[str] = field(default_factory=list)

    def deprecate(self, message: str) -> None:
        if message not in self.warnings:
            self.warnings.append(message)

    def param(self, name: str, default: Optional[str] = None) -> Optional[str]:
        return self.params.get(name, self.query.get(name, default))

    def flag(self, name: str, default: bool = False) -> bool:
        v = self.query.get(name)
        if v is None:
            return default
        return v.lower() in ("", "true", "1", "yes")


# handler(request, on_done(status:int, body:dict)) -> None
Handler = Callable[[RestRequest, Callable[[int, Any], None]], None]


class _TrieNode:
    __slots__ = ("children", "wildcard", "handlers", "param_name")

    def __init__(self) -> None:
        self.children: Dict[str, "_TrieNode"] = {}
        self.wildcard: Optional["_TrieNode"] = None
        self.param_name: Optional[str] = None
        self.handlers: Dict[str, Handler] = {}


class RestController:
    def __init__(self) -> None:
        self._root = _TrieNode()

    def register(self, method: str, template: str, handler: Handler) -> None:
        node = self._root
        for seg in [s for s in template.split("/") if s]:
            if seg.startswith("{") and seg.endswith("}"):
                if node.wildcard is None:
                    node.wildcard = _TrieNode()
                    node.wildcard.param_name = seg[1:-1]
                node = node.wildcard
            else:
                node = node.children.setdefault(seg, _TrieNode())
        if method in node.handlers:
            raise ValueError(f"duplicate route {method} {template}")
        node.handlers[method] = handler

    def _resolve(self, path: str) -> Tuple[Optional[_TrieNode],
                                           Dict[str, str]]:
        segs = [s for s in path.split("/") if s]
        params: Dict[str, str] = {}

        def walk(node: _TrieNode, i: int,
                 bound: Dict[str, str]) -> Optional[Tuple[_TrieNode,
                                                          Dict[str, str]]]:
            if i == len(segs):
                return (node, bound) if node.handlers else None
            seg = segs[i]
            # literal beats wildcard (trie priority, as in the reference)
            child = node.children.get(seg)
            if child is not None:
                hit = walk(child, i + 1, bound)
                if hit is not None:
                    return hit
            if node.wildcard is not None:
                hit = walk(node.wildcard, i + 1,
                           {**bound, node.wildcard.param_name: seg})
                if hit is not None:
                    return hit
            return None

        hit = walk(self._root, 0, params)
        if hit is None:
            return None, {}
        return hit

    def dispatch(self, request: RestRequest,
                 on_done: Callable[[int, Any], None]) -> None:
        node, params = self._resolve(request.path)
        if node is None:
            on_done(404, _error_body(
                "invalid_path_exception",
                f"no handler found for uri [{request.path}]", 404))
            return
        handler = node.handlers.get(request.method)
        if handler is None and request.method == "HEAD":
            handler = node.handlers.get("GET")
        if handler is None:
            on_done(405, _error_body(
                "method_not_allowed",
                f"incorrect HTTP method for uri [{request.path}], "
                f"allowed: {sorted(node.handlers)}", 405))
            return
        request.params.update(params)
        try:
            handler(request, on_done)
        except SearchEngineError as e:
            on_done(e.status, _error_body(_error_type(e), str(e), e.status,
                                          retry_after=_retry_after_of(e)))
        except Exception as e:  # noqa: BLE001 — uniform 500 mapping
            traceback.print_exc()
            on_done(500, _error_body(type(e).__name__, str(e), 500))


def _error_type(e: Exception) -> str:
    from elasticsearch_tpu_torch.utils.errors import exception_type_name
    return exception_type_name(type(e).__name__)


def _retry_after_of(err: Exception) -> Optional[int]:
    """The computed Retry-After a rejection carries in its metadata
    (admission pool rejections set it — metadata also survives the
    transport's to_json relay); None for every other error."""
    value = (getattr(err, "metadata", None) or {}).get("retry_after")
    try:
        return int(value) if value is not None else None
    except (TypeError, ValueError):
        return None


def _error_body(err_type: str, reason: str, status: int,
                retry_after: Optional[int] = None) -> Dict[str, Any]:
    error: Dict[str, Any] = {
        "type": err_type, "reason": reason,
        "root_cause": [{"type": err_type, "reason": reason}]}
    if retry_after is not None:
        # mirrored into the HTTP Retry-After header by the server
        error["retry_after"] = retry_after
    return {"error": error, "status": status}


def respond_error(on_done: Callable[[int, Any], None],
                  err: Exception) -> None:
    status = getattr(err, "status", 500)
    retry_after = _retry_after_of(err)
    # surface the ORIGINAL error type for errors relayed across transport
    cause_type = getattr(err, "cause_type", "")
    if cause_type:
        from elasticsearch_tpu_torch.utils.errors import exception_type_name
        reason = getattr(err, "cause_reason", str(err))
        on_done(status, _error_body(exception_type_name(cause_type),
                                    reason, status,
                                    retry_after=retry_after))
        return
    on_done(status, _error_body(_error_type(err), str(err), status,
                                retry_after=retry_after))


def wrap_client_cb(on_done: Callable[[int, Any], None],
                   status_ok: int = 200,
                   transform: Optional[Callable[[Any], Any]] = None
                   ) -> Callable[[Any, Optional[Exception]], None]:
    """Adapt NodeClient's (resp, err) callbacks to REST responses."""
    def cb(resp: Any, err: Optional[Exception] = None) -> None:
        if err is not None:
            respond_error(on_done, err)
        else:
            on_done(status_ok, transform(resp) if transform else resp)
    return cb
