"""HTTP server: the user-facing port.

Reference analog: http/AbstractHttpServerTransport + the Netty4 impl
(modules/transport-netty4/.../Netty4HttpServerTransport.java:87). Here the
event loop is asyncio (the control plane is host-side Python by design,
SURVEY.md §7); request handling bridges to the node's scheduler thread and
resolves back through the loop.

Run a single-node dev cluster:  python -m elasticsearch_tpu_torch.rest.server
"""

from __future__ import annotations

import asyncio
import json
import signal
import sys
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qsl, urlsplit

from elasticsearch_tpu_torch.node.node import NodeClient
from elasticsearch_tpu_torch.rest.controller import RestController, RestRequest
from elasticsearch_tpu_torch.rest.routes import build_controller

MAX_BODY = 100 * 1024 * 1024   # http.max_content_length default (100mb)


class _BadRequest(Exception):
    """Malformed HTTP request: answered with a 400, then the connection
    closes (the HTTP pipeline can't resync after a framing error)."""


def retry_after_of(status: int, body: Any) -> Optional[int]:
    """Seconds for the HTTP Retry-After header of a 429 response whose
    error body carries the admission layer's computed value; None
    otherwise (no header). Pure so the header contract is unit-testable
    without a socket."""
    if status != 429 or not isinstance(body, dict):
        return None
    value = (body.get("error") or {}).get("retry_after") \
        if isinstance(body.get("error"), dict) else None
    try:
        return max(0, int(value)) if value is not None else None
    except (TypeError, ValueError):
        return None


class HttpServer:
    def __init__(self, client: NodeClient, host: str = "127.0.0.1",
                 port: int = 9200,
                 ssl_certfile: Optional[str] = None,
                 ssl_keyfile: Optional[str] = None):
        self.client = client
        self.controller: RestController = build_controller(client)
        self.host = host
        self.port = port
        # TLS (xpack.security.http.ssl analog): serve HTTPS when a cert +
        # key are supplied
        self.ssl_certfile = ssl_certfile
        self.ssl_keyfile = ssl_keyfile
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> None:
        ssl_ctx = None
        if self.ssl_certfile:
            import ssl as ssl_mod
            ssl_ctx = ssl_mod.SSLContext(ssl_mod.PROTOCOL_TLS_SERVER)
            ssl_ctx.load_cert_chain(self.ssl_certfile, self.ssl_keyfile)
        self._server = await asyncio.start_server(
            self._handle_connection, self.host, self.port, ssl=ssl_ctx)
        if self.port == 0:
            # ephemeral bind: report the kernel-assigned port so callers
            # (and the startup banner) see the real address — test
            # harnesses use this instead of the racy probe-close-rebind
            self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    # ------------------------------------------------------------------

    async def _handle_connection(self, reader: asyncio.StreamReader,
                                 writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                try:
                    request = await self._read_request(reader)
                except _BadRequest as e:
                    await self._write_response(
                        writer, 400,
                        {"error": {"type": "illegal_argument_exception",
                                   "reason": str(e)}, "status": 400})
                    break
                if request is None:
                    break
                status, body = await self._dispatch(request)
                await self._write_response(writer, status, body,
                                           head=request.method == "HEAD",
                                           request=request)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()

    async def _read_request(self, reader: asyncio.StreamReader
                            ) -> Optional[RestRequest]:
        try:
            request_line = await reader.readline()
        except ConnectionError:
            return None
        except ValueError:
            # StreamReader.readline wraps LimitOverrunError in ValueError
            # for over-limit lines
            raise _BadRequest("request line too long")
        if not request_line:
            return None
        parts = request_line.decode("latin-1").strip().split()
        if len(parts) < 2:
            raise _BadRequest("invalid HTTP request line")
        method, target = parts[0].upper(), parts[1]
        headers: Dict[str, str] = {}
        while True:
            try:
                line = await reader.readline()
            except ValueError:
                raise _BadRequest("header line too long")
            if line in (b"\r\n", b"\n", b""):
                break
            key, _, value = line.decode("latin-1").partition(":")
            headers[key.strip().lower()] = value.strip()
        try:
            length = int(headers.get("content-length", 0))
        except ValueError:
            raise _BadRequest("invalid Content-Length header")
        if length < 0:
            raise _BadRequest("invalid Content-Length header")
        if length > MAX_BODY:
            raise _BadRequest(
                f"request body larger than http.max_content_length "
                f"[{MAX_BODY}]")
        raw = await reader.readexactly(length) if length else b""
        split = urlsplit(target)
        query = dict(parse_qsl(split.query, keep_blank_values=True))
        body: Any = None
        ctype = headers.get("content-type", "")
        if raw and "x-ndjson" not in ctype:
            # multi-format body parsing (libs/x-content XContentFactory
            # analog): JSON / YAML / CBOR / SMILE by content-type, with
            # leading-byte sniffing when absent. NDJSON (bulk) stays
            # raw. YAML is only parsed when DECLARED — sniffing it would
            # turn arbitrary plain-text bodies into scalar strings that
            # handlers expecting dict-or-None would 500 on.
            from elasticsearch_tpu_torch.utils import xcontent
            declared = xcontent.format_from_content_type(ctype or None)
            fmt = declared or xcontent.sniff_format(raw)
            if fmt != xcontent.YAML or declared == xcontent.YAML:
                try:
                    parsed = xcontent.loads(raw, xcontent.CONTENT_TYPES[fmt])
                    if isinstance(parsed, (dict, list)):
                        body = parsed
                except Exception:  # noqa: BLE001 — handlers 400 on None
                    body = None
        return RestRequest(method=method, path=split.path, query=query,
                           body=body, raw_body=raw, headers=headers)

    async def _dispatch(self, request: RestRequest) -> Tuple[int, Any]:
        loop = asyncio.get_running_loop()
        future: asyncio.Future = loop.create_future()

        def on_done(status: int, body: Any) -> None:
            # handlers complete on the node's scheduler thread
            loop.call_soon_threadsafe(
                lambda: future.done() or future.set_result((status, body)))

        # dispatch on the scheduler thread so all node-internal callbacks
        # stay single-threaded (the applier-thread discipline)
        def run() -> None:
            # SecurityRestFilter analog: authn/authz before any handler.
            # A filter exception must resolve the request (500), or the
            # awaiting future — and the client connection — hang forever.
            try:
                security = getattr(self.client.node, "security", None)
                if security is not None:
                    denied = security.check(request)
                    if denied is not None:
                        on_done(*denied)
                        return
            except Exception as e:  # noqa: BLE001
                on_done(500, {"error": {
                    "type": "security_exception",
                    "reason": f"authentication filter failed: {e}"},
                    "status": 500})
                return
            self.controller.dispatch(request, on_done)

        self.client.node.scheduler.submit(run)
        return await future

    async def _write_response(self, writer: asyncio.StreamWriter,
                              status: int, body: Any,
                              head: bool = False,
                              request: Optional[RestRequest] = None
                              ) -> None:
        if isinstance(body, str):
            payload = body.encode("utf-8")
            ctype = "text/plain; charset=UTF-8"
        else:
            # response format mirrors the request body format unless
            # Accept overrides (RestRequest.getResponseContentType)
            from elasticsearch_tpu_torch.utils import xcontent
            req_fmt = None
            accept = None
            if request is not None:
                accept = (request.headers or {}).get("accept")
                req_fmt = xcontent.format_from_content_type(
                    (request.headers or {}).get("content-type"))
            fmt = xcontent.response_format(accept, req_fmt)
            try:
                payload = xcontent.dumps(body, fmt)
            except Exception as e:  # noqa: BLE001
                # a serialization failure must produce a 500, not kill
                # the connection with zero bytes written
                status = 500
                fmt = xcontent.JSON
                payload = xcontent.dumps({"error": {
                    "type": "serialization_exception",
                    "reason": str(e)}, "status": 500}, fmt)
            ctype = (f"{xcontent.CONTENT_TYPES[fmt]}; charset=UTF-8"
                     if fmt in (xcontent.JSON, xcontent.YAML)
                     else xcontent.CONTENT_TYPES[fmt])
        reason = {200: "OK", 201: "Created", 404: "Not Found",
                  400: "Bad Request", 405: "Method Not Allowed",
                  409: "Conflict", 429: "Too Many Requests",
                  500: "Internal Server Error",
                  503: "Service Unavailable"}.get(status, "OK")
        warning_lines = ""
        for message in getattr(request, "warnings", None) or []:
            # the reference's HeaderWarning shape: 299 + agent + quoted
            safe = message.replace('"', "'")
            warning_lines += f'Warning: 299 elasticsearch-tpu "{safe}"\r\n'
        retry_after = retry_after_of(status, body)
        if retry_after is not None:
            # load-shed responses tell clients HOW LONG to back off (the
            # admission pool computes it from its measured drain rate)
            warning_lines += f"Retry-After: {retry_after}\r\n"
        head_lines = (f"HTTP/1.1 {status} {reason}\r\n"
                      f"content-type: {ctype}\r\n"
                      f"content-length: {len(payload)}\r\n"
                      f"{warning_lines}"
                      f"\r\n").encode("latin-1")
        writer.write(head_lines + (b"" if head else payload))
        await writer.drain()


def run_single_node(host: str = "127.0.0.1", port: int = 9200,
                    data_path: Optional[str] = None, device=None) -> None:
    """Boot a one-node cluster on the threaded scheduler and serve HTTP
    (bootstrap/Elasticsearch.main analog for the dev distribution). The
    node runs on ``device``: None = the CUDA card (an error when there is
    none), "cpu" = the kernels' plain versions."""
    import time

    from elasticsearch_tpu_torch.cluster.state import ClusterState
    from elasticsearch_tpu_torch.node.node import Node
    from elasticsearch_tpu_torch.transport.scheduler import ThreadedScheduler
    from elasticsearch_tpu_torch.transport.transport import InMemoryTransport

    scheduler = ThreadedScheduler()
    transport = InMemoryTransport(scheduler, default_latency=0.0)
    node = Node("node0", transport, scheduler, seed_peers=["node0"],
                data_path=data_path,
                initial_state=ClusterState(voting_config=frozenset(["node0"])),
                device=device)
    node.start()
    deadline = time.monotonic() + 30
    while node.coordinator.mode != "LEADER":
        if time.monotonic() > deadline:
            raise RuntimeError("single node failed to elect itself")
        time.sleep(0.05)

    server = HttpServer(node.client, host, port)

    async def main() -> None:
        await server.start()
        print(f"elasticsearch_tpu node listening on "
              f"http://{host}:{server.port}", flush=True)
        stop = asyncio.Event()
        try:
            asyncio.get_running_loop().add_signal_handler(
                signal.SIGINT, stop.set)
            asyncio.get_running_loop().add_signal_handler(
                signal.SIGTERM, stop.set)
        except NotImplementedError:
            pass
        await stop.wait()
        await server.stop()

    try:
        asyncio.run(main())
    finally:
        node.stop()


def run_tcp_node(node_id: str, http_port: int, tcp_port: int,
                 peers: dict, host: str = "127.0.0.1",
                 data_path: Optional[str] = None, device=None) -> None:
    """Boot one member of a multi-process cluster over the TCP transport
    (bootstrap/Elasticsearch.main + discovery.seed_hosts analog).

    ``peers``: node_id -> (host, tcp_port) for EVERY cluster member,
    including this one — the static address book that stands in for
    seed-hosts discovery. ``device`` as for ``run_single_node``.
    """
    from elasticsearch_tpu_torch.cluster.state import ClusterState
    from elasticsearch_tpu_torch.node.node import Node
    from elasticsearch_tpu_torch.transport.scheduler import ThreadedScheduler
    from elasticsearch_tpu_torch.transport.tcp import TcpTransport, TcpTransportService

    scheduler = ThreadedScheduler()
    # TLS from env (elasticsearch.yml analog): ESTPU_TRANSPORT_SSL_CERT/
    # _KEY/_CA enable mutual transport TLS; ESTPU_HTTP_SSL_CERT/_KEY
    # serve HTTPS
    import os as _os
    tcp = TcpTransport(scheduler, node_id, (host, tcp_port),
                       {n: tuple(a) for n, a in peers.items()},
                       ssl_certfile=_os.environ.get(
                           "ESTPU_TRANSPORT_SSL_CERT"),
                       ssl_keyfile=_os.environ.get(
                           "ESTPU_TRANSPORT_SSL_KEY"),
                       ssl_cafile=_os.environ.get(
                           "ESTPU_TRANSPORT_SSL_CA"))
    tcp.start()
    service = TcpTransportService(node_id, tcp)
    node = Node(node_id, None, scheduler,
                seed_peers=sorted(peers),
                data_path=data_path,
                initial_state=ClusterState(
                    voting_config=frozenset(peers)),
                transport_service=service, device=device)
    node.start()

    server = HttpServer(node.client, host, http_port,
                        ssl_certfile=_os.environ.get(
                            "ESTPU_HTTP_SSL_CERT"),
                        ssl_keyfile=_os.environ.get(
                            "ESTPU_HTTP_SSL_KEY"))

    async def main() -> None:
        await server.start()
        print(f"elasticsearch_tpu node {node_id} "
              f"http://{host}:{server.port} tcp:{tcp_port}", flush=True)
        stop = asyncio.Event()
        try:
            asyncio.get_running_loop().add_signal_handler(
                signal.SIGINT, stop.set)
            asyncio.get_running_loop().add_signal_handler(
                signal.SIGTERM, stop.set)
        except NotImplementedError:
            pass
        await stop.wait()
        await server.stop()

    try:
        asyncio.run(main())
    finally:
        node.stop()


def _parse_peers(spec: str) -> dict:
    """"n1=127.0.0.1:9301,n2=127.0.0.1:9302" -> {id: (host, port)}."""
    out = {}
    for part in spec.split(","):
        nid, _, addr = part.partition("=")
        h, _, p = addr.rpartition(":")
        out[nid.strip()] = (h, int(p))
    return out


if __name__ == "__main__":
    if len(sys.argv) > 1 and all("=" in a for a in sys.argv[1:]):
        # multi-process form:
        #   python -m elasticsearch_tpu_torch.rest.server node=n1 http=9200 \
        #       tcp=9301 peers=n1=127.0.0.1:9301,n2=... [data=/path]
        #       [device=cpu]
        kv = dict(a.split("=", 1) for a in sys.argv[1:])
        run_tcp_node(kv["node"], int(kv["http"]), int(kv["tcp"]),
                     _parse_peers(kv["peers"]), data_path=kv.get("data"),
                     device=kv.get("device"))
    else:
        # python -m elasticsearch_tpu_torch.rest.server [port [data_path]]
        # serves on the CUDA card; ES_TORCH_DEVICE=cpu runs the plain
        # versions instead
        import os
        port = int(sys.argv[1]) if len(sys.argv) > 1 else 9200
        data = sys.argv[2] if len(sys.argv) > 2 else None
        run_single_node(port=port, data_path=data,
                        device=os.environ.get("ES_TORCH_DEVICE") or None)
