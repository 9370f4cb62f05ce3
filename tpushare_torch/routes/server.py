"""HTTP layer: the extender's webhook server.

The port's copy of ``tpushare/routes/server.py`` (gpushare's
``pkg/routes/routes.go``) for the single-pod path:

* ``POST {prefix}/filter`` — the predicate
* ``POST {prefix}/prioritize`` — node scoring
* ``POST {prefix}/bind`` — bind; HTTP 500 on error, so the scheduler
  retries (a gang member held below quorum too, though that is not
  counted as a failed bind)
* ``POST {prefix}/preempt``, ``{prefix}/validate`` — 404 "not
  configured", as the reference answers when they are not wired
* ``GET  {prefix}/inspect[/<node>]`` — the utilization document
* ``GET  /version``, ``/healthz``

Every verb answers with a ``Server-Timing`` header: the handler's own ms
and, for the read verbs, the micro-batch gate's queue wait. A malformed
body is refused with 400 and the handler returns. A bounded pool of
workers serves the accepted connections (``TPUSHARE_HTTP_WORKERS``, 8),
each for its keep-alive lifetime; a full hand-off queue blocks the
accept loop. The read verbs pass the micro-batch gate (routes/batch.py)
and the repeat-shape fast paths of routes/wire.py. ``/metrics`` and
``/debug/*`` come with the observability slice.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

import tpushare_torch
from tpushare_torch.api.extender import ExtenderBindingArgs
from tpushare_torch.routes import wire
from tpushare_torch.routes.batch import VerbBatcher, WorkItem

log = logging.getLogger(__name__)

DEFAULT_PREFIX = "/tpushare-scheduler"

#: Pool workers draining the accept queue (TPUSHARE_HTTP_WORKERS); each
#: holds one keep-alive connection at a time.
DEFAULT_HTTP_WORKERS = 8
#: Accepted but unassigned connections held before the accept loop
#: itself blocks (the back-pressure point).
ACCEPT_QUEUE_DEPTH = 128
#: Per-connection socket timeout: bounds a slow client's partial body and
#: an idle keep-alive connection's hold on a worker.
DEFAULT_SOCKET_TIMEOUT_S = 30.0
#: Largest accepted request body.
MAX_BODY_BYTES = 8 * 1024 * 1024


def _server_timing(handler_ms: float, queue_ms: float = 0.0) -> dict:
    """``Server-Timing``: the handler's own duration (no framing, no
    wire) and the micro-batch gate's queue wait."""
    return {"Server-Timing":
            f"handler;dur={handler_ms:.3f}, queue;dur={queue_ms:.3f}"}


class ExtenderHTTPServer(HTTPServer):
    allow_reuse_address = True
    #: Kernel accept backlog behind the bounded hand-off queue.
    request_queue_size = ACCEPT_QUEUE_DEPTH

    def __init__(self, addr, predicate, binder, inspect,
                 prefix: str = DEFAULT_PREFIX, prioritize=None):
        self.predicate = predicate
        self.binder = binder
        self.inspect = inspect
        self.prioritize = prioritize
        self.prefix = prefix
        #: Binds that failed; a gang member held below quorum is an
        #: expected hold and not counted.
        self.bind_errors = 0
        self._bind_errors_lock = threading.Lock()
        env = os.environ.get
        self.http_workers = max(1, int(env("TPUSHARE_HTTP_WORKERS",
                                           str(DEFAULT_HTTP_WORKERS))))
        self.socket_timeout_s = float(env("TPUSHARE_HTTP_TIMEOUT_S",
                                          str(DEFAULT_SOCKET_TIMEOUT_S)))
        window_s = float(env("TPUSHARE_BATCH_WINDOW_MS", "0.5")) / 1e3
        batch_n = int(env("TPUSHARE_BATCH_MAX", "16"))
        # TPUSHARE_BATCH=off makes submit a pass-through.
        enabled = env("TPUSHARE_BATCH", "on").lower() not in (
            "off", "0", "false")
        self.filter_gate = VerbBatcher(self._filter_batch,
                                       max_batch=batch_n,
                                       window_s=window_s, enabled=enabled)
        self.prioritize_gate = VerbBatcher(self._prioritize_batch,
                                           max_batch=batch_n,
                                           window_s=window_s,
                                           enabled=enabled)
        self._conn_queue: queue.Queue = queue.Queue(
            maxsize=ACCEPT_QUEUE_DEPTH)
        self._closing = False
        self._http_threads: list[threading.Thread] = []
        super().__init__(addr, _Handler)
        for i in range(self.http_workers):
            t = threading.Thread(target=self._http_worker,
                                 name=f"tpushare-http-worker-{i}",
                                 daemon=True)
            t.start()
            self._http_threads.append(t)

    # -- the bounded worker pool ------------------------------------------ #

    def process_request(self, request, client_address):
        """Hand the accepted connection to a pool worker; a full queue
        blocks the accept loop (back-pressure the kernel backlog takes)
        instead of spawning a thread a connection."""
        self._conn_queue.put((request, client_address))

    def _http_worker(self) -> None:
        """Serve connections, each for its keep-alive lifetime, until the
        shutdown sentinel or, when the sentinel did not fit a full queue,
        the closing flag at the next idle tick."""
        while True:
            try:
                item = self._conn_queue.get(timeout=1.0)
            except queue.Empty:
                if self._closing:
                    return
                continue
            if item is None:
                return
            request, client_address = item
            try:
                self.finish_request(request, client_address)
            except Exception:
                self.handle_error(request, client_address)
            finally:
                self.shutdown_request(request)

    def handle_error(self, request, client_address):
        """A client that went away is routine, not a stack trace."""
        exc = sys.exc_info()[1]
        if isinstance(exc, (ConnectionError, TimeoutError)):
            log.debug("client %s went away: %r", client_address, exc)
            return
        log.exception("error handling request from %s", client_address)

    def shutdown(self):
        """Stop the accept loop, then release the pool workers."""
        self._closing = True
        super().shutdown()
        for _ in self._http_threads:
            try:
                self._conn_queue.put_nowait(None)
            except queue.Full:
                break

    # -- batched verb execution ------------------------------------------- #
    # The gates run these on whichever thread drains the batch. A request
    # that raises is returned as its own result and re-raised on its own
    # handler thread, so it fails alone.

    def _filter_batch(self, items: list[WorkItem]):
        table, nominated = self.predicate.snapshot()
        out = []
        for it in items:
            try:
                t0 = time.perf_counter()
                result = self.predicate.handle(it.args, table=table,
                                               nominated=nominated)
                handler_ms = (time.perf_counter() - t0) * 1e3
                out.append((wire.encode_filter_result(result), handler_ms))
            except Exception as e:  # noqa: BLE001 - re-raised per item
                out.append(e)
        return out

    def _prioritize_batch(self, items: list[WorkItem]):
        table = self.prioritize.snapshot()
        out = []
        for it in items:
            try:
                t0 = time.perf_counter()
                entries = self.prioritize.handle(it.args, table=table)
                handler_ms = (time.perf_counter() - t0) * 1e3
                out.append((wire.encode_host_priorities(entries),
                            handler_ms))
            except Exception as e:  # noqa: BLE001 - re-raised per item
                out.append(e)
        return out


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # The webhook is on the scheduler's critical path: no Nagle delay.
    disable_nagle_algorithm = True
    # Buffered: the whole response goes out in one flush.
    wbufsize = 64 * 1024
    server: ExtenderHTTPServer

    def setup(self) -> None:
        # Before the stream wrappers: bounds a slow client's body and an
        # idle keep-alive connection's hold on its worker.
        self.timeout = self.server.socket_timeout_s
        super().setup()

    def version_string(self) -> str:
        return "tpushare"

    def log_message(self, fmt, *args):  # through logging, not stderr
        if log.isEnabledFor(logging.DEBUG):
            log.debug("%s %s", self.address_string(), fmt % args)

    def _send_json(self, doc: dict | list, status: int = 200,
                   extra_headers: dict | None = None) -> None:
        self._send_bytes(json.dumps(doc, separators=(",", ":")).encode(),
                         status, extra_headers)

    def _send_bytes(self, body: bytes, status: int = 200,
                    extra_headers: dict | None = None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for name, value in (extra_headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, text: bytes, status: int = 200) -> None:
        self.send_response(status)
        self.send_header("Content-Type", "text/plain; charset=utf-8")
        self.send_header("Content-Length", str(len(text)))
        self.end_headers()
        self.wfile.write(text)

    def _read_body(self) -> bytes | None:
        """The request body, or None after a 400. An oversized
        declaration is refused before reading; a stalled or truncated
        body closes the connection."""
        try:
            length = int(self.headers.get("Content-Length", 0) or 0)
        except ValueError:
            self.close_connection = True
            self._send_json({"Error": "malformed Content-Length"}, 400)
            return None
        if length > MAX_BODY_BYTES:
            self.close_connection = True
            self._send_json(
                {"Error": f"request body too large ({length} bytes; "
                          f"limit {MAX_BODY_BYTES})"}, 400)
            return None
        if length <= 0:
            self._send_json({"Error": "empty request body"}, 400)
            return None
        try:
            raw = self.rfile.read(length)
        except TimeoutError:
            self.close_connection = True
            try:
                self._send_json(
                    {"Error": "timed out reading request body"}, 400)
            except (OSError, ValueError):
                pass  # the stalled client is likely unreachable too
            return None
        if len(raw) < length:
            self.close_connection = True
            self._send_json({"Error": "truncated request body"}, 400)
            return None
        return raw

    def _read_json(self) -> dict | None:
        """The body as a JSON object, or None after a 400 (a top level
        that is not an object, ``null`` included, is a 400 too)."""
        raw = self._read_body()
        if raw is None:
            return None
        try:
            doc = json.loads(raw)
        except ValueError as e:
            self._send_json({"Error": f"malformed request body: {e}"}, 400)
            return None
        if not isinstance(doc, dict):
            self._send_json(
                {"Error": "request body must be a JSON object, got "
                          f"{type(doc).__name__}"}, 400)
            return None
        return doc

    def _read_args(self):
        """A filter or prioritize body through wire.py's fast path; None
        after a 400."""
        raw = self._read_body()
        if raw is None:
            return None
        try:
            return wire.parse_extender_args(raw)
        except ValueError as e:
            self._send_json({"Error": f"malformed request body: {e}"}, 400)
            return None

    def _gated(self, gate: VerbBatcher, args) -> None:
        res, queue_s = gate.submit(args)
        if isinstance(res, Exception):
            raise res  # this item's own failure: 500 below
        body, handler_ms = res
        self._send_bytes(body, extra_headers=_server_timing(
            handler_ms, queue_s * 1e3))

    # -- verbs -------------------------------------------------------------

    def do_GET(self):  # noqa: N802 (stdlib casing)
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        prefix = self.server.prefix
        try:
            if path == "/version":
                self._send_json({"version": tpushare_torch.__version__})
            elif path == "/healthz":
                self._send_text(b"ok")
            elif (path == f"{prefix}/inspect"
                  or path.startswith(f"{prefix}/inspect/")):
                rest = path[len(f"{prefix}/inspect"):]
                node = rest[1:] if rest.startswith("/") else None
                self._send_json(self.server.inspect.handle(node))
            else:
                self._send_json({"Error": f"no route for {path}"}, 404)
        except Exception as e:  # pragma: no cover - defensive
            log.exception("GET %s failed", path)
            self._send_json({"Error": str(e)}, 500)

    def do_POST(self):  # noqa: N802
        path = self.path.split("?", 1)[0].rstrip("/")
        prefix = self.server.prefix
        try:
            if path == f"{prefix}/filter":
                args = self._read_args()
                if args is not None:
                    self._gated(self.server.filter_gate, args)
            elif path == f"{prefix}/prioritize":
                args = self._read_args()
                if args is None:
                    return
                if self.server.prioritize is None:
                    self._send_json(
                        {"Error": "prioritize not configured"}, 404)
                    return
                self._gated(self.server.prioritize_gate, args)
            elif path in (f"{prefix}/preempt", f"{prefix}/validate"):
                if self._read_json() is not None:
                    what = ("preempt" if path.endswith("/preempt")
                            else "admission")
                    self._send_json({"Error": f"{what} not configured"},
                                    404)
            elif path == f"{prefix}/bind":
                doc = self._read_json()
                if doc is None:
                    return
                args = ExtenderBindingArgs.from_json(doc)
                t0 = time.perf_counter()
                result = self.server.binder.handle(args)
                handler_ms = (time.perf_counter() - t0) * 1e3
                if result.error and not result.pending:
                    with self.server._bind_errors_lock:
                        self.server.bind_errors += 1
                # gpushare answers 500 when bind fails, so the scheduler
                # retries; so does a member held below quorum.
                self._send_json(result.to_json(),
                                500 if result.error else 200,
                                extra_headers=_server_timing(handler_ms))
            else:
                self._send_json({"Error": f"no route for {path}"}, 404)
        except Exception as e:  # pragma: no cover - defensive
            log.exception("POST %s failed", path)
            self._send_json({"Error": str(e)}, 500)


def enable_tls(server: ExtenderHTTPServer, cert_file: str,
               key_file: str) -> None:
    """Serve HTTPS (the extender policy's ``enableHttps: true``). Call
    before ``serve_forever``. The handshake runs on the worker's thread,
    so a client that never speaks TLS cannot block the accept loop."""
    import ssl

    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert_file, key_file)
    server.socket = ctx.wrap_socket(server.socket, server_side=True,
                                    do_handshake_on_connect=False)


def serve_forever(server: ExtenderHTTPServer) -> threading.Thread:
    """Run the server on a daemon thread; returns the thread."""
    t = threading.Thread(target=server.serve_forever, name="tpushare-http",
                         daemon=True)
    t.start()
    return t
