"""TransportService: action-name-dispatched request/response RPC.

Reference: transport/TransportService.java:72 (handler registry, timeouts,
local short-circuit) over TcpTransport framing. Here the wire is pluggable:
InMemoryTransport delivers between in-process nodes through the scheduler,
with per-link disruption rules (drop/delay/partition) subsuming the
reference's MockTransportService/DisruptableMockTransport test doubles.
Requests/responses are plain dicts (already JSON-shaped, like the
reference's Writeable DTOs are wire-shaped).
"""

from __future__ import annotations

import copy
import random as _random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

from elasticsearch_tpu_torch.transport.scheduler import Cancellable, Scheduler
from elasticsearch_tpu_torch.utils.errors import (
    NodeDisconnectedError, ReceiveTimeoutError, TransportError,
)


class ConnectTransportError(TransportError):
    """Link-level failure: node unreachable/disconnected."""


class NodeNotConnectedError(ConnectTransportError):
    pass


class RemoteTransportError(TransportError):
    """The remote handler raised; wraps the original error by name and
    rehydrates its HTTP status so the REST layer maps it faithfully
    (ElasticsearchException wire serialization analog)."""

    def __init__(self, node_id: str, action: str, cause: str) -> None:
        super().__init__(f"[{node_id}][{action}] remote error: {cause}")
        self.node_id = node_id
        self.action = action
        self.cause = cause
        self.cause_type, _, self.cause_reason = cause.partition(": ")
        from elasticsearch_tpu_torch.utils import errors as _errors
        original = getattr(_errors, self.cause_type, None)
        if isinstance(original, type) and \
                issubclass(original, _errors.SearchEngineError):
            self.status = original.status
        else:
            self.cause_type = ""


Handler = Callable[[Dict[str, Any], str], Dict[str, Any]]
ResponseCallback = Callable[[Optional[Dict[str, Any]], Optional[Exception]], None]


class Deferred:
    """Async handler response: a handler may return one of these instead of
    a dict and resolve/reject it later (the reference's handlers respond
    through an async TransportChannel, TcpTransportChannel.sendResponse)."""

    def __init__(self) -> None:
        self._on_value: Optional[Callable[[Dict[str, Any]], None]] = None
        self._on_error: Optional[Callable[[str], None]] = None
        self._value: Optional[Dict[str, Any]] = None
        self._error: Optional[str] = None
        self._done = False

    def resolve(self, value: Optional[Dict[str, Any]] = None) -> None:
        if self._done:
            return
        self._done = True
        self._value = value if value is not None else {}
        if self._on_value is not None:
            self._on_value(self._value)

    def reject(self, cause: Any) -> None:
        if self._done:
            return
        self._done = True
        self._error = (f"{type(cause).__name__}: {cause}"
                       if isinstance(cause, Exception) else str(cause))
        if self._on_error is not None:
            self._on_error(self._error)

    def _subscribe(self, on_value: Callable[[Dict[str, Any]], None],
                   on_error: Callable[[str], None]) -> None:
        self._on_value = on_value
        self._on_error = on_error
        if self._done:
            if self._error is not None:
                on_error(self._error)
            else:
                on_value(self._value or {})


@dataclass
class _Rule:
    """Disruption rule for a directed link (or wildcard '*').

    drop: blackhole — the message silently vanishes (packet loss; the
    sender's timeout is the only signal). disconnect: the link refuses —
    the sender fails fast with NodeNotConnectedError (connection refused),
    the retryable flavor real networks produce when a process is down.
    delay/jitter: fixed plus uniformly-random extra latency per message.

    Below the framed-request seam (TCP semantics; in-memory parity rule:
    both behave as drop — the send SUCCEEDS, nothing is processed, no
    error ever arrives, only the sender's timeout resolves):

    half_open: the peer stops reading but never FINs — frames vanish
    into its never-drained socket buffer. partial_frame: the length
    header (and part of the body) is delivered, then the body stalls
    mid-frame — over TCP the receiver's reader genuinely blocks inside
    one frame and later bytes on that connection desync the protocol
    until the connection resets.
    """
    drop: bool = False
    disconnect: bool = False
    delay: float = 0.0
    jitter: float = 0.0
    half_open: bool = False
    partial_frame: bool = False


class DisruptionRules:
    """Directed-link disruption rule book, shared by every transport
    flavor (in-memory AND TCP): one rule shape, one wildcard-lookup
    semantic, so a chaos scenario means the same thing on either wire.
    Subclasses/owners decide how a matched rule is APPLIED."""

    def __init__(self) -> None:
        self._rules: Dict[Tuple[str, str], _Rule] = {}

    def add_rule(self, sender: str, receiver: str,
                 drop: bool = False, delay: float = 0.0,
                 jitter: float = 0.0, disconnect: bool = False,
                 half_open: bool = False,
                 partial_frame: bool = False) -> None:
        self._rules[(sender, receiver)] = _Rule(
            drop=drop, disconnect=disconnect, delay=delay, jitter=jitter,
            half_open=half_open, partial_frame=partial_frame)

    def clear_rules(self) -> None:
        self._rules.clear()

    def heal(self) -> None:
        self.clear_rules()

    def partition(self, side_a, side_b, style: str = "blackhole") -> None:
        """Two-way partition between node-id groups. style='blackhole'
        drops silently (timeouts resolve the senders); style='disconnect'
        refuses fast (NodeNotConnectedError — the retryable flavor)."""
        self.partition_one_way(side_a, side_b, style=style)
        self.partition_one_way(side_b, side_a, style=style)

    def partition_one_way(self, from_side, to_side,
                          style: str = "blackhole") -> None:
        """Asymmetric partition: messages from_side -> to_side are
        disrupted; the reverse direction still delivers (the classic
        one-sided network failure that splits request/response paths)."""
        disconnect = style == "disconnect"
        for a in from_side:
            for b in to_side:
                self.add_rule(a, b, drop=not disconnect,
                              disconnect=disconnect)

    def rule(self, sender: str, receiver: str) -> Optional[_Rule]:
        for key in ((sender, receiver), (sender, "*"), ("*", receiver)):
            rule = self._rules.get(key)
            if rule is not None:
                return rule
        return None


class InMemoryTransport(DisruptionRules):
    """Delivers messages between TransportServices through the scheduler.

    One instance per simulated network. Per-link latency plus disruption
    rules; every delivery is a scheduled task, so under the deterministic
    scheduler the full cluster interleaving is seed-reproducible (jittered
    latency draws from the scheduler's seeded RNG when it has one).
    """

    def __init__(self, scheduler: Scheduler, default_latency: float = 0.001):
        super().__init__()
        self.scheduler = scheduler
        self.default_latency = default_latency
        self._nodes: Dict[str, "TransportService"] = {}
        # crashed nodes: detached but remembered, so restore() can bring
        # the same service back (a process crash/restart with state kept)
        self._crashed: Dict[str, "TransportService"] = {}
        self.random = getattr(scheduler, "random", None) or _random

    # -- membership ----------------------------------------------------------

    def attach(self, service: "TransportService") -> None:
        self._nodes[service.node_id] = service
        self._crashed.pop(service.node_id, None)

    def detach(self, node_id: str) -> None:
        self._nodes.pop(node_id, None)

    def connected(self, node_id: str) -> bool:
        return node_id in self._nodes

    # -- node crash / restart ------------------------------------------------

    def crash(self, node_id: str) -> None:
        """Simulate a process crash: the node vanishes from the wire
        (senders get connection-refused) but its in-memory state is kept
        for restore() — a crash/restart or a long SIGSTOP pause."""
        service = self._nodes.pop(node_id, None)
        if service is not None:
            self._crashed[node_id] = service

    def restore(self, node_id: str) -> None:
        """Bring a crashed node back onto the wire."""
        service = self._crashed.pop(node_id, None)
        if service is not None:
            self._nodes[node_id] = service

    def _rule(self, sender: str, receiver: str) -> Optional[_Rule]:
        return self.rule(sender, receiver)

    # -- delivery ------------------------------------------------------------

    def deliver(self, sender: str, receiver: str,
                fn: Callable[["TransportService"], None],
                on_undeliverable: Callable[[], None]) -> None:
        rule = self._rule(sender, receiver)
        if rule is not None and (rule.drop or rule.half_open or
                                 rule.partial_frame):
            # drop, AND the in-memory parity of the below-the-seam TCP
            # faults: the send succeeded as far as the sender can tell,
            # nothing is ever processed, only the timeout resolves
            return
        if rule is not None and rule.disconnect:
            # connection refused: resolves the sender promptly (and off the
            # current stack, preserving async callback discipline)
            self.scheduler.schedule(0.0, on_undeliverable)
            return
        latency = self.default_latency + (rule.delay if rule else 0.0)
        if rule is not None and rule.jitter > 0.0:
            latency += self.random.uniform(0.0, rule.jitter)

        def run() -> None:
            target = self._nodes.get(receiver)
            if target is None:
                on_undeliverable()
            else:
                fn(target)

        self.scheduler.schedule(latency, run)


class TransportService:
    """Per-node RPC endpoint: handler registry + async request/response.

    Handlers are ``fn(request: dict, sender_node_id: str) -> dict`` and run
    on the scheduler's dispatch context. Responses (or remote exceptions)
    come back through the caller's callback. Local sends short-circuit but
    still go through the scheduler, preserving async semantics
    (TransportService.java local-node optimization).
    """

    def __init__(self, node_id: str, transport: InMemoryTransport):
        self.node_id = node_id
        self.transport = transport
        self._handlers: Dict[str, Handler] = {}
        self._next_request_id = 0
        self.stats = {"sent": 0, "received": 0, "timeouts": 0}
        transport.attach(self)

    # -- registry ------------------------------------------------------------

    def register_handler(self, action: str, handler: Handler) -> None:
        if action in self._handlers:
            raise ValueError(f"handler already registered for [{action}]")
        self._handlers[action] = handler

    # -- sending -------------------------------------------------------------

    DEFAULT_TIMEOUT = 30.0

    def send_request(self, node_id: str, action: str, request: Dict[str, Any],
                     on_response: ResponseCallback,
                     timeout: Optional[float] = None) -> None:
        """Fire the request; exactly one callback invocation is guaranteed
        (response, remote error, undeliverable, or timeout). timeout=None
        means DEFAULT_TIMEOUT — a silently-dropped message (partition rule)
        must still resolve the callback, so every request has a timeout."""
        if timeout is None:
            timeout = self.DEFAULT_TIMEOUT
        self.stats["sent"] += 1
        done = {"flag": False}
        timeout_handle: Optional[Cancellable] = None

        def finish(resp: Optional[Dict[str, Any]],
                   err: Optional[Exception]) -> None:
            if done["flag"]:
                return
            done["flag"] = True
            if timeout_handle is not None:
                timeout_handle.cancel()
            on_response(resp, err)

        if timeout is not None:
            def on_timeout() -> None:
                self.stats["timeouts"] += 1
                finish(None, ReceiveTimeoutError(
                    f"[{node_id}][{action}] request timed out after {timeout}s"))
            timeout_handle = self.transport.scheduler.schedule(
                timeout, on_timeout)

        # snapshot the payload: sender-side mutation after send must not be
        # visible remotely (the wire would have serialized it)
        payload = copy.deepcopy(request)

        def handle_at(target: "TransportService") -> None:
            target.stats["received"] += 1
            handler = target._handlers.get(action)
            if handler is None:
                reply_err(f"no handler for action [{action}]")
                return
            try:
                response = handler(payload, self.node_id)
            except Exception as e:  # noqa: BLE001 — becomes a remote error
                reply_err(f"{type(e).__name__}: {e}")
                return

            def send_reply(resp: Optional[Dict[str, Any]]) -> None:
                resp = copy.deepcopy(resp if resp is not None else {})
                self.transport.deliver(
                    node_id, self.node_id,
                    lambda _me: finish(resp, None),
                    on_undeliverable=lambda: None)  # sender gone

            if isinstance(response, Deferred):
                response._subscribe(send_reply, reply_err)
            else:
                send_reply(response)

        def reply_err(cause: str) -> None:
            self.transport.deliver(
                node_id, self.node_id,
                lambda _me: finish(None, RemoteTransportError(
                    node_id, action, cause)),
                on_undeliverable=lambda: None)

        self.transport.deliver(
            self.node_id, node_id, handle_at,
            on_undeliverable=lambda: finish(None, NodeNotConnectedError(
                f"node [{node_id}] is not connected")))

    def close(self) -> None:
        self.transport.detach(self.node_id)
