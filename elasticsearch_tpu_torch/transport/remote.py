"""Remote-cluster connections for cross-cluster search.

Reference: transport/RemoteClusterService.java:65 — a per-alias
connection registry configured by ``cluster.remote.<alias>.seeds``
dynamic settings — and RemoteClusterAware.java (the ``alias:index``
expression split). Re-designed for this build: remote seeds become
synthetic entries in the local TcpTransport's address book, requests go
out over the normal framed wire, and responses ride BACK on the same
socket (transport/tcp.py's reply channel) since a remote cluster has no
address-book entry for the caller.

Trust model: cross-cluster requests use the same transport TLS contexts
as intra-cluster traffic — clusters that should federate must share a
transport CA (the reference's cert-based trust for CCS).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["RemoteClusterService", "split_remote_expression"]

SEED_PREFIX = "cluster.remote."
SEED_SUFFIX = ".seeds"
SKIP_UNAVAILABLE_SUFFIX = ".skip_unavailable"

# one shared declaration/parser for every alias's affix key (the registry
# Setting discipline — no hand-rolled boolean parsing here)
from elasticsearch_tpu_torch.utils.settings import Property, Scope, Setting

_SKIP_UNAVAILABLE_SETTING: Setting = Setting.bool_setting(
    SEED_PREFIX + "*" + SKIP_UNAVAILABLE_SUFFIX, False,
    scope=Scope.CLUSTER, properties=Property.DYNAMIC)


def split_remote_expression(expression: str
                            ) -> Tuple[List[str], Dict[str, List[str]]]:
    """"a,remote:b,remote:c*,other:d" -> (["a"], {"remote": ["b","c*"],
    "other": ["d"]}). Index names cannot contain ':', so a colon always
    marks a remote alias (RemoteClusterAware.buildRemoteIndexName)."""
    local: List[str] = []
    remote: Dict[str, List[str]] = {}
    for part in (expression or "").split(","):
        part = part.strip()
        if not part:
            continue
        alias, sep, rest = part.partition(":")
        if sep and alias and rest:
            remote.setdefault(alias, []).append(rest)
        else:
            local.append(part)
    return local, remote


class RemoteClusterService:
    """Resolves remote aliases to seed addresses and proxies requests."""

    def __init__(self, node) -> None:
        self.node = node

    # -- config --------------------------------------------------------

    def seeds(self) -> Dict[str, List[Tuple[str, int]]]:
        """alias -> [(host, port)] from persistent cluster settings."""
        settings = dict(self.node._applied_state()
                        .metadata.persistent_settings)
        out: Dict[str, List[Tuple[str, int]]] = {}
        for key, value in settings.items():
            if not (key.startswith(SEED_PREFIX)
                    and key.endswith(SEED_SUFFIX)):
                continue
            alias = key[len(SEED_PREFIX): -len(SEED_SUFFIX)]
            raw = value if isinstance(value, list) else \
                [s.strip() for s in str(value).split(",") if s.strip()]
            parsed: List[Tuple[str, int]] = []
            for entry in raw:
                host, _, port = str(entry).rpartition(":")
                try:
                    parsed.append((host, int(port)))
                except ValueError:
                    continue
            if parsed:
                out[alias] = parsed
        return out

    def aliases(self) -> List[str]:
        return sorted(self.seeds())

    def skip_unavailable(self, alias: str) -> bool:
        """cluster.remote.<alias>.skip_unavailable (dynamic): when true, a
        cross-cluster search treats this remote's failure as a SKIPPED
        cluster — degraded federated results instead of a failed search
        (RemoteClusterService.REMOTE_CLUSTER_SKIP_UNAVAILABLE analog)."""
        raw = self.node._applied_state().metadata.persistent_settings.get(
            f"{SEED_PREFIX}{alias}{SKIP_UNAVAILABLE_SUFFIX}")
        if raw is None:
            return False
        try:
            return _SKIP_UNAVAILABLE_SETTING.parse(raw)
        except Exception:  # noqa: BLE001 — unparseable operator value:
            return False   # fail toward strict (the setting's default)

    def info(self) -> Dict[str, Any]:
        """GET /_remote/info shape."""
        return {alias: {
            "seeds": [f"{h}:{p}" for h, p in addrs],
            "connected": True,     # lazy connections: reported configured
            "num_nodes_connected": len(addrs),
            "skip_unavailable": self.skip_unavailable(alias),
        } for alias, addrs in self.seeds().items()}

    # -- sending -------------------------------------------------------

    def send(self, alias: str, action: str, request: Dict[str, Any],
             on_response: Callable[[Optional[dict], Optional[Exception]],
                                   None],
             timeout: Optional[float] = None) -> None:
        """Send to the first reachable seed of ``alias``; tries the next
        seed on connection failure (sniff-lite — the reference's sniff
        mode additionally discovers gateway nodes behind the seeds)."""
        seeds = self.seeds().get(alias)
        ts = getattr(self.node, "transport_service", None)
        transport = getattr(ts, "transport", None)
        book = getattr(transport, "address_book", None)
        if not seeds or book is None:
            on_response(None, ValueError(
                f"no such remote cluster: [{alias}]" if not seeds else
                "remote clusters require the TCP transport"))
            return
        attempt = {"i": 0}

        def try_next(err: Optional[Exception]) -> None:
            i = attempt["i"]
            if i >= len(seeds):
                on_response(None, err or ConnectionError(
                    f"unable to connect to remote cluster [{alias}]"))
                return
            attempt["i"] = i + 1
            host, port = seeds[i]
            node_id = f"_remote::{alias}::{host}:{port}"
            book[node_id] = (host, port)

            def done(resp, e):
                if e is not None and isinstance(
                        e, (ConnectionError, OSError)) is False and \
                        type(e).__name__ not in ("NodeNotConnectedError",):
                    # a real remote error (handler raised): surface it
                    on_response(None, e)
                    return
                if e is not None:
                    try_next(e)
                    return
                on_response(resp, None)

            ts.send_request(node_id, action, request, done,
                            timeout=timeout)

        try_next(None)
