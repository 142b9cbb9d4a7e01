"""TCP transport: the control plane across OS processes.

Reference: transport/TcpTransport.java:96 (framed wire, connection profile,
handshake) + TransportService.java:72 (request-id correlation, timeouts).
The in-memory transport simulates a network inside one process for
deterministic tests; this module is the production wire with the SAME
service contract (register_handler / send_request / close + the
one-callback guarantee), so every action and the coordinator run unchanged
over real sockets.

Wire format: 4-byte big-endian length prefix + UTF-8 JSON document.
Messages:
  {"t": "hs",  "node": sender_id}                      connection handshake
  {"t": "req", "id": N, "action": a, "sender": s, "body": {...}}
  {"t": "res", "id": N, "body": {...}}                 handler success
  {"t": "res", "id": N, "error": "Type: reason"}       handler failure

Concurrency model: socket reader threads only parse frames and hand them to
the scheduler; ALL handler execution happens on the scheduler's single
dispatch thread — the same ordering discipline as the in-memory transport
(and the reference's transport worker -> generic threadpool handoff).
Outbound writes run on one writer thread per peer so a blocked/slow peer
never stalls dispatch.
"""

from __future__ import annotations

import json
import queue
import random as _random
import socket
import struct
import threading
from typing import Any, Callable, Dict, Optional, Tuple

from elasticsearch_tpu_torch.transport.scheduler import Cancellable, Scheduler
from elasticsearch_tpu_torch.transport.transport import (
    Deferred, DisruptionRules, NodeNotConnectedError, RemoteTransportError,
    _Rule,
)
from elasticsearch_tpu_torch.utils.errors import ReceiveTimeoutError

__all__ = ["TcpDisruption", "TcpTransport", "TcpTransportService"]


class TcpDisruption(DisruptionRules):
    """Chaos rules for the REAL wire — drop / one-way partition /
    disconnect / jittered latency with the exact rule book the in-memory
    transport uses (transport.py ``DisruptionRules``), so every chaos
    scenario written against the in-memory wire means the same thing
    over real sockets.

    One instance is shared by every TcpTransport in the disrupted cluster
    (the test harness's network); rules are keyed by (sender, receiver)
    node ids with '*' wildcards, checked at the service layer where both
    endpoints' identities are known — requests on send, responses on
    reply. Thread-safe enough: rule mutation races only ever see a rule
    or no rule, never a torn one."""

    def __init__(self, rng: Optional[_random.Random] = None):
        super().__init__()
        self.random = rng or _random.Random(0)

    def latency(self, rule: _Rule) -> float:
        extra = self.random.uniform(0.0, rule.jitter) \
            if rule.jitter > 0.0 else 0.0
        return rule.delay + extra

_LEN = struct.Struct(">I")
MAX_FRAME = 256 * 1024 * 1024


def _jsonable(obj: Any) -> Any:
    """Last-resort converter so numpy scalars etc. survive serialization."""
    for attr in ("item",):
        if hasattr(obj, attr):
            try:
                return getattr(obj, attr)()
            except Exception:  # noqa: BLE001
                pass
    if isinstance(obj, (set, frozenset, tuple)):
        return list(obj)
    return str(obj)


def _encode_frame(msg: Dict[str, Any]) -> bytes:
    payload = json.dumps(msg, default=_jsonable).encode("utf-8")
    return _LEN.pack(len(payload)) + payload


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> Optional[Dict[str, Any]]:
    head = _recv_exact(sock, _LEN.size)
    if head is None:
        return None
    (length,) = _LEN.unpack(head)
    if length > MAX_FRAME:
        raise ValueError(f"frame of {length} bytes exceeds limit")
    body = _recv_exact(sock, length)
    if body is None:
        return None
    return json.loads(body.decode("utf-8"))


class _Peer:
    """Outbound connection to one node: a queue drained by a writer thread.

    Connect happens lazily on the writer thread (never on dispatch). On any
    send/connect failure the queued message's on_fail fires and the
    connection resets — the next message retries from scratch. Request
    timeouts remain the end-to-end guarantee.
    """

    def __init__(self, my_id: str, address: Tuple[str, int],
                 on_fail_dispatch: Callable[[Callable[[], None]], None],
                 ssl_context=None, on_message=None):
        self.my_id = my_id
        self.address = address
        self._ssl_context = ssl_context
        self._q: "queue.Queue" = queue.Queue()
        self._sock: Optional[socket.socket] = None
        self._closed = False
        self._dispatch = on_fail_dispatch
        # responses may ride back on THIS socket (the reference's
        # TcpTransportChannel replies on the inbound channel): a reader
        # thread per live connection feeds them to the transport
        self._on_message = on_message
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"tcp-out-{address[1]}")
        self._thread.start()

    def send(self, frame: bytes,
             on_fail: Optional[Callable[[], None]] = None) -> None:
        """``frame`` is already encoded — serialization happens at send
        time on the caller's thread, so later mutation of the request dict
        can't leak onto the wire (the in-memory transport's deepcopy-at-send
        snapshot semantics, transport.py)."""
        self._q.put((frame, on_fail))

    def _connect(self) -> socket.socket:
        sock = socket.create_connection(self.address, timeout=5.0)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if self._ssl_context is not None:
            sock = self._ssl_context.wrap_socket(
                sock, server_hostname=self.address[0])
        sock.settimeout(None)
        sock.sendall(_encode_frame({"t": "hs", "node": self.my_id}))
        if self._on_message is not None:
            threading.Thread(target=self._read_responses, args=(sock,),
                             daemon=True,
                             name=f"tcp-out-read-{self.address[1]}").start()
        return sock

    def _read_responses(self, sock: socket.socket) -> None:
        """Drain frames the peer writes back on the outbound socket (reply
        channel); ends silently when the connection resets."""
        try:
            while not self._closed:
                msg = _recv_frame(sock)
                if msg is None:
                    return
                cb = self._on_message
                if cb is not None:
                    self._dispatch(lambda m=msg: cb(m, None))
        except (OSError, ValueError):
            return

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                break
            frame, on_fail = item
            try:
                if self._sock is None:
                    self._sock = self._connect()
                self._sock.sendall(frame)
            except Exception:  # noqa: BLE001 — the writer must survive any
                # failure or the peer wedges silently for the node's life
                if self._sock is not None:
                    try:
                        self._sock.close()
                    except OSError:
                        pass
                    self._sock = None
                if on_fail is not None:
                    self._dispatch(on_fail)

    def close(self) -> None:
        self._closed = True
        self._q.put(None)
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass


class TcpTransport:
    """Listening socket + peer address book + outbound connection pool."""

    def __init__(self, scheduler: Scheduler, node_id: str,
                 bind: Tuple[str, int],
                 address_book: Dict[str, Tuple[str, int]],
                 ssl_certfile: Optional[str] = None,
                 ssl_keyfile: Optional[str] = None,
                 ssl_cafile: Optional[str] = None):
        self.scheduler = scheduler
        self.node_id = node_id
        self.bind_address = bind
        self.address_book = dict(address_book)
        # transport TLS (xpack.security.transport.ssl analog): when a
        # cert+key are supplied the listener wraps inbound sockets and
        # outbound connections verify against ca (or the same cert for
        # the self-signed single-CA deployment shape)
        self.ssl_certfile = ssl_certfile
        self.ssl_keyfile = ssl_keyfile
        self.ssl_cafile = ssl_cafile or ssl_certfile
        self._peers: Dict[str, _Peer] = {}
        self._lock = threading.Lock()
        self._server: Optional[socket.socket] = None
        self._inbound: set = set()
        self._closed = False
        # set by TcpTransportService: fn(msg, reply_conn) on the dispatch
        # thread; reply_conn (when not None) is the socket the request
        # arrived on — the reply channel
        self.on_message: Optional[Callable] = None
        # chaos seam (TcpDisruption): when set, the service layer checks
        # drop/disconnect/latency rules before frames touch a socket
        self.disruption: Optional[TcpDisruption] = None
        # replies over inbound sockets drain through ONE writer queue PER
        # connection (created lazily): a stalled peer wedges only its own
        # channel, never the dispatch thread or other peers' replies
        self._reply_channels: Dict[int, "queue.Queue"] = {}

    # -- lifecycle -----------------------------------------------------------

    def _build_ssl_contexts(self) -> None:
        """Built ONCE: contexts are shared by every peer/connection (a
        per-peer rebuild re-read certs from disk under the lock). The
        server context REQUIRES client certificates — transport TLS is
        mutual or it is authentication theater: without it any reachable
        attacker could handshake and inject forged frames."""
        self._server_ctx = None
        self._client_ctx = None
        if not self.ssl_certfile:
            return
        import ssl as ssl_mod
        sctx = ssl_mod.SSLContext(ssl_mod.PROTOCOL_TLS_SERVER)
        sctx.load_cert_chain(self.ssl_certfile, self.ssl_keyfile)
        sctx.verify_mode = ssl_mod.CERT_REQUIRED
        sctx.load_verify_locations(self.ssl_cafile)
        self._server_ctx = sctx
        cctx = ssl_mod.SSLContext(ssl_mod.PROTOCOL_TLS_CLIENT)
        cctx.load_verify_locations(self.ssl_cafile)
        cctx.check_hostname = False    # node certs carry ids, not hosts
        cctx.load_cert_chain(self.ssl_certfile, self.ssl_keyfile)
        self._client_ctx = cctx

    def _client_ssl_context(self):
        return self._client_ctx

    def start(self) -> None:
        self._build_ssl_contexts()
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(self.bind_address)
        srv.listen(64)
        # the listener is NOT wrapped: accept() must never run a TLS
        # handshake (a stalled or plaintext client would block or kill
        # the accept loop) — each connection wraps on its reader thread
        self._server = srv
        # rebinding port 0 resolves the ephemeral port for the address book
        self.bind_address = srv.getsockname()
        threading.Thread(target=self._accept_loop, daemon=True,
                         name=f"tcp-accept-{self.bind_address[1]}").start()

    def close(self) -> None:
        self._closed = True
        with self._lock:
            for q in self._reply_channels.values():
                q.put(None)
        if self._server is not None:
            try:
                self._server.close()
            except OSError:
                pass
        with self._lock:
            for peer in self._peers.values():
                peer.close()
            self._peers.clear()
            for conn in list(self._inbound):
                try:
                    conn.close()   # unblocks reader threads stuck in recv
                except OSError:
                    pass
            self._inbound.clear()

    # -- reply channel -------------------------------------------------------

    def reply_via(self, conn, msg: Dict[str, Any],
                  on_fail: Optional[Callable[[], None]] = None) -> None:
        """Send a response over the socket its request arrived on (the
        TcpTransportChannel analog) — the only route back to callers that
        are NOT in this cluster's address book (cross-cluster search)."""
        try:
            frame = _encode_frame(msg)
        except Exception:  # noqa: BLE001 — unserializable payload
            if on_fail is not None:
                self.scheduler.submit(on_fail)
            return
        key = id(conn)
        with self._lock:
            if self._closed:
                q = None
            else:
                q = self._reply_channels.get(key)
                if q is None:
                    q = self._reply_channels[key] = queue.Queue()
                    threading.Thread(
                        target=self._reply_loop, args=(key, conn, q),
                        daemon=True,
                        name=f"tcp-reply-{self.bind_address[1]}").start()
                # enqueue UNDER the lock: the idle-exit check below also
                # holds it, so a frame can never land on a queue whose
                # drainer already decided to exit
                q.put((frame, on_fail))
        if q is None and on_fail is not None:
            self.scheduler.submit(on_fail)

    def _drop_channel(self, key: int, q: "queue.Queue") -> None:
        with self._lock:
            if self._reply_channels.get(key) is q:
                del self._reply_channels[key]

    def _reply_loop(self, key: int, conn, q: "queue.Queue") -> None:
        """Drain one connection's replies; exits (and fails the rest of
        its queue) on the first write error so a dead peer's channel
        disappears instead of accumulating."""
        while True:
            try:
                item = q.get(timeout=60.0)
            except queue.Empty:
                # idle: exit unless a racing reply_via just enqueued
                with self._lock:
                    if q.empty():
                        if self._reply_channels.get(key) is q:
                            del self._reply_channels[key]
                        return
                continue
            if item is None:
                self._drop_channel(key, q)
                return
            frame, on_fail = item
            try:
                conn.sendall(frame)
            except OSError:
                if on_fail is not None:
                    self.scheduler.submit(on_fail)
                while not q.empty():
                    leftover = q.get_nowait()
                    if leftover and leftover[1] is not None:
                        self.scheduler.submit(leftover[1])
                self._drop_channel(key, q)
                return

    # -- inbound -------------------------------------------------------------

    def _accept_loop(self) -> None:
        assert self._server is not None
        while not self._closed:
            try:
                conn, _addr = self._server.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._inbound.add(conn)
            threading.Thread(target=self._read_loop, args=(conn,),
                             daemon=True, name="tcp-read").start()

    def _read_loop(self, conn: socket.socket) -> None:
        try:
            if self._server_ctx is not None:
                # per-connection handshake OFF the accept thread, with a
                # deadline so a stalled client costs one reader thread,
                # not cluster availability; failures close only this conn
                raw = conn
                raw.settimeout(10.0)
                try:
                    conn = self._server_ctx.wrap_socket(raw,
                                                        server_side=True)
                except (OSError, ValueError):
                    with self._lock:
                        self._inbound.discard(raw)
                    try:
                        raw.close()
                    except OSError:
                        pass
                    return
                conn.settimeout(None)
                with self._lock:
                    self._inbound.discard(raw)
                    if self._closed:
                        # close() ran mid-handshake: the wrapped socket
                        # must not outlive the transport
                        try:
                            conn.close()
                        except OSError:
                            pass
                        return
                    self._inbound.add(conn)
            hs = _recv_frame(conn)
            if not hs or hs.get("t") != "hs":
                return
            while not self._closed:
                msg = _recv_frame(conn)
                if msg is None:
                    return
                cb = self.on_message
                if cb is not None:
                    # parse on the reader thread, execute on dispatch;
                    # the conn rides along as the reply channel
                    self.scheduler.submit(lambda m=msg, c=conn: cb(m, c))
        except (OSError, ValueError):
            return
        finally:
            with self._lock:
                self._inbound.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    # -- outbound ------------------------------------------------------------

    def _peer_message(self, msg: Dict[str, Any], conn) -> None:
        """Frames a peer wrote back on OUR outbound socket (its reply
        channel); already on the dispatch thread."""
        cb = self.on_message
        if cb is not None:
            cb(msg, conn)

    def _peer_for(self, node_id: str) -> Optional[_Peer]:
        addr = self.address_book.get(node_id)
        if addr is None:
            return None
        with self._lock:
            if self._closed:
                return None
            peer = self._peers.get(node_id)
            if peer is None:
                peer = self._peers[node_id] = _Peer(
                    self.node_id, tuple(addr), self.scheduler.submit,
                    ssl_context=self._client_ssl_context(),
                    on_message=self._peer_message)
        return peer

    def send(self, node_id: str, msg: Dict[str, Any],
             on_fail: Optional[Callable[[], None]] = None) -> None:
        if self._closed:
            if on_fail is not None:
                self.scheduler.submit(on_fail)
            return
        try:
            frame = _encode_frame(msg)   # snapshot NOW, on the caller thread
        except Exception:  # noqa: BLE001 — unserializable payload
            if on_fail is not None:
                self.scheduler.submit(on_fail)
            return
        peer = self._peer_for(node_id)
        if peer is None:
            if on_fail is not None:
                self.scheduler.submit(on_fail)
            return
        peer.send(frame, on_fail)

    def send_truncated(self, node_id: str, msg: Dict[str, Any]) -> None:
        """Chaos (TcpDisruption ``partial_frame``): write the length
        header and roughly half the body onto the REAL socket, then
        stall — the peer's reader blocks mid-frame in _recv_exact, and
        any later bytes on this connection are consumed as the missing
        body, desyncing the framing until the connection resets. The
        closest a test harness gets to a wedged middlebox / a sender
        that died mid-write."""
        try:
            frame = _encode_frame(msg)
        except Exception:  # noqa: BLE001 — unserializable payload: the
            return         # fault already "ate" the message
        body_len = len(frame) - _LEN.size
        cut = _LEN.size + max(1, body_len // 2) if body_len > 1 \
            else _LEN.size
        peer = self._peer_for(node_id)
        if peer is not None:
            peer.send(frame[:cut], None)


class TcpTransportService:
    """TransportService contract over TcpTransport.

    Same guarantees as the in-memory service: handlers are
    ``fn(request, sender_id) -> dict | Deferred`` running on the dispatch
    thread; send_request invokes its callback exactly once (response,
    remote error, undeliverable, or timeout). Local sends short-circuit
    through the scheduler without touching a socket
    (TransportService.java's local-node optimization).
    """

    DEFAULT_TIMEOUT = 30.0

    def __init__(self, node_id: str, transport: TcpTransport):
        self.node_id = node_id
        self.transport = transport
        self._handlers: Dict[str, Callable] = {}
        self._pending: Dict[int, Callable[[Optional[dict], Optional[Exception]], None]] = {}
        self._next_id = 0
        self._id_lock = threading.Lock()
        self.stats = {"sent": 0, "received": 0, "timeouts": 0}
        transport.on_message = self._on_message

    # -- registry ------------------------------------------------------------

    def register_handler(self, action: str, handler: Callable) -> None:
        if action in self._handlers:
            raise ValueError(f"handler already registered for [{action}]")
        self._handlers[action] = handler

    # -- sending -------------------------------------------------------------

    def send_request(self, node_id: str, action: str, request: Dict[str, Any],
                     on_response, timeout: Optional[float] = None) -> None:
        if timeout is None:
            timeout = self.DEFAULT_TIMEOUT
        self.stats["sent"] += 1
        with self._id_lock:
            self._next_id += 1
            req_id = self._next_id
        done = {"flag": False}
        timeout_handle: Optional[Cancellable] = None

        def finish(resp, err) -> None:
            if done["flag"]:
                return
            done["flag"] = True
            self._pending.pop(req_id, None)
            if timeout_handle is not None:
                timeout_handle.cancel()
            on_response(resp, err)

        def on_timeout() -> None:
            self.stats["timeouts"] += 1
            finish(None, ReceiveTimeoutError(
                f"[{node_id}][{action}] request timed out after {timeout}s"))

        timeout_handle = self.transport.scheduler.schedule(timeout, on_timeout)
        self._pending[req_id] = finish

        if node_id == self.node_id:
            # local short-circuit, still async through the scheduler; the
            # JSON round-trip reproduces the wire's copy semantics
            payload = json.loads(json.dumps(request, default=_jsonable))
            self.transport.scheduler.submit(
                lambda: self._handle_request(
                    {"id": req_id, "action": action, "sender": self.node_id,
                     "body": payload}, local_finish=finish))
            return

        def do_send() -> None:
            self.transport.send(
                node_id,
                {"t": "req", "id": req_id, "action": action,
                 "sender": self.node_id, "body": request},
                on_fail=lambda: finish(None, NodeNotConnectedError(
                    f"node [{node_id}] is not connected")))

        # chaos rules (TcpDisruption parity with the in-memory wire):
        # drop = blackhole (only the timeout resolves); disconnect =
        # refused fast; delay/jitter = scheduled late send. Below the
        # framed seam: half_open frames really cross the socket but the
        # peer never reads them (the receive side swallows unprocessed);
        # partial_frame writes a TRUNCATED frame that wedges the peer's
        # reader mid-frame and desyncs the connection's framing
        disruption = self.transport.disruption
        rule = disruption.rule(self.node_id, node_id) \
            if disruption is not None else None
        if rule is not None:
            if rule.drop:
                return
            if rule.partial_frame:
                self.transport.send_truncated(
                    node_id,
                    {"t": "req", "id": req_id, "action": action,
                     "sender": self.node_id, "body": request})
                return
            if rule.disconnect:
                self.transport.scheduler.submit(
                    lambda: finish(None, NodeNotConnectedError(
                        f"node [{node_id}] is not connected")))
                return
            if rule.delay or rule.jitter:
                self.transport.scheduler.schedule(
                    disruption.latency(rule), do_send)
                return
        do_send()

    # -- receiving -----------------------------------------------------------

    def _on_message(self, msg: Dict[str, Any], reply_conn=None) -> None:
        t = msg.get("t")
        if t == "req":
            self._handle_request(msg, reply_conn=reply_conn)
        elif t == "res":
            finish = self._pending.get(msg.get("id"))
            if finish is None:
                return  # timed out / duplicate — late response dropped
            err = msg.get("error")
            if err is not None:
                finish(None, RemoteTransportError(
                    msg.get("sender", "?"), msg.get("action", "?"), err))
            else:
                finish(msg.get("body") or {}, None)

    def _handle_request(self, msg: Dict[str, Any],
                        local_finish=None, reply_conn=None) -> None:
        # half-open chaos (TcpDisruption): the sender's frame genuinely
        # crossed the socket, but this endpoint "stopped reading" — the
        # request is swallowed unprocessed, no reply, no FIN; only the
        # sender's timeout resolves. Local short-circuits are exempt
        # (loopback has no connection to half-open).
        if local_finish is None and self.transport.disruption is not None:
            rule = self.transport.disruption.rule(
                msg.get("sender", "?"), self.node_id)
            if rule is not None and rule.half_open:
                return
        self.stats["received"] += 1
        req_id = msg["id"]
        action = msg["action"]
        sender = msg["sender"]

        def _send_response(payload: Dict[str, Any]) -> None:
            # prefer the socket the request arrived on (the reference's
            # TcpTransportChannel): the ONLY route to cross-cluster
            # callers outside this cluster's address book, and a saved
            # reverse connection otherwise. Fallback: address-book send.
            def deliver() -> None:
                if reply_conn is not None:
                    self.transport.reply_via(
                        reply_conn, payload,
                        on_fail=lambda: self.transport.send(sender,
                                                            payload))
                else:
                    self.transport.send(sender, payload)

            # the response direction has its OWN rule lookup, so a
            # one-way partition severs exactly one direction — same
            # semantics as InMemoryTransport.deliver
            disruption = self.transport.disruption
            rule = disruption.rule(self.node_id, sender) \
                if disruption is not None else None
            if rule is not None:
                if rule.drop or rule.disconnect or rule.half_open:
                    return   # response lost: requester's timeout resolves
                if rule.partial_frame:
                    # header + half the body, then silence: the
                    # requester's reader wedges mid-frame
                    self.transport.send_truncated(sender, payload)
                    return
                if rule.delay or rule.jitter:
                    self.transport.scheduler.schedule(
                        disruption.latency(rule), deliver)
                    return
            deliver()

        def reply_ok(body: Optional[Dict[str, Any]]) -> None:
            if local_finish is not None:
                body = json.loads(json.dumps(body if body is not None else {},
                                             default=_jsonable))
                local_finish(body, None)
            else:
                _send_response({
                    "t": "res", "id": req_id, "sender": self.node_id,
                    "action": action, "body": body if body is not None else {}})

        def reply_err(cause: str) -> None:
            if local_finish is not None:
                local_finish(None, RemoteTransportError(
                    self.node_id, action, cause))
            else:
                _send_response({
                    "t": "res", "id": req_id, "sender": self.node_id,
                    "action": action, "error": cause})

        handler = self._handlers.get(action)
        if handler is None:
            reply_err(f"no handler for action [{action}]")
            return
        try:
            response = handler(msg.get("body") or {}, sender)
        except Exception as e:  # noqa: BLE001 — becomes a remote error
            reply_err(f"{type(e).__name__}: {e}")
            return
        if isinstance(response, Deferred):
            response._subscribe(reply_ok, reply_err)
        else:
            reply_ok(response)

    def close(self) -> None:
        self.transport.close()
