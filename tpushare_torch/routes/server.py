"""HTTP layer: the extender's webhook server.

The port's copy of ``tpushare/routes/server.py`` (gpushare's
``pkg/routes/routes.go``) for the single-pod path:

* ``POST {prefix}/filter`` — the predicate
* ``POST {prefix}/prioritize`` — node scoring
* ``POST {prefix}/bind`` — bind; HTTP 500 on error, so the scheduler
  retries (a gang member held below quorum too, though that is not
  counted as a failed bind)
* ``POST {prefix}/preempt`` — victims a candidate node
  (``ExtenderPreemptionArgs`` in either era's keys)
* ``POST {prefix}/validate`` — the admission webhook (AdmissionReview)
* ``GET  {prefix}/inspect[/<node>]`` — the utilization document
* ``GET  /metrics`` — Prometheus (text format 0.0.4, ``routes/metrics.py``)
* ``GET  /debug/flight[?n=]`` — the flight recorder: the last completed
  placement decisions, newest first, and the recording drops
* ``GET  /debug/trace/<ns>/<pod>[?id=]`` — one pod's latest decision (or
  the attempt ``id`` names); ``GET /debug/trace?id=`` — a decision's
  causal chain
* ``GET  /debug/quota`` — the tenant quota ledger's snapshot
* ``GET  /debug/defrag`` — the fragmentation index (stranded HBM, each
  node's score, the pending shapes), the defrag executor's posture and
  budget, and its last plan
* ``GET  /debug/slo`` — the SLO objectives (error budget left, burn rate
  a window), the journeys' aggregates and the recording drops
* ``GET  /debug/journey/<ns>/<pod>`` — the pod's journey: creation to
  bound, its attempts' trace ids, queue wait against time in the verbs
* ``GET  /debug/timeline[?window=&series=&markers=]`` — the fleet
  timeline: tiered series, markers, exemplars, anomaly state (404 under
  ``TPUSHARE_TIMELINE=off``, 400 on a window that is not a number)
* ``GET  /debug/blackbox`` — the flight journal's and the exporter's
  health (404 unless ``TPUSHARE_BLACKBOX_DIR`` or ``TPUSHARE_EXPORT_URL``
  armed one)
* ``GET  /debug/fleetday`` — the fleet-day witness's schedule and verdict
* ``GET  /debug/http`` — the wire path: pool, accept queue, keep-alive
  reuse, the micro-batch gates and the wire memos
* ``GET  /debug/pprof`` — the profiling suite (``routes/pprof.py``):
  ``/profile`` (sampled CPU, collapsed stacks), ``/block`` (threads
  parked in lock waits), ``/trace`` (Chrome trace JSON), ``/mutex`` (the
  contended-lock registry), ``/heap[?stop=1]`` (tracemalloc),
  ``/goroutine`` (= ``/debug/threads``, all threads' stacks); a second
  time-boxed sampler while one runs answers 409, a non-numeric or NaN
  ``seconds`` / ``hz`` 400
* ``GET  /debug/profile/continuous[?window=]`` — the continuous
  profiler's rolling window, verb-rooted collapsed stacks;
  ``GET /debug/hotspots[?top=&window=]`` — top self-time frames per verb
  and the per-verb cost ledger (both 404 while the profiler is not
  running)
* ``GET  /version``, ``/healthz`` (``ok leader`` / ``ok follower`` under
  leader election)

``debug_routes=False`` (``DEBUG_ROUTES=0``) answers every ``/debug/*``
route with 404 "debug routes disabled".

Each scheduling verb runs inside a :mod:`tpushare_torch.trace` phase
under its latency histogram, so a TPU pod's filter, prioritize, preempt
and bind are one decision, finalized as ``bound``, ``failed``,
``gang-pending`` or ``unschedulable``. The read verbs open their phase on
the thread that drains the micro-batch, per item, because the handler's
thread may be parked in the gate while a batch leader does its work. A
caller's ``traceparent`` header becomes the decision's causal parent,
and the reply carries the decision's own ``traceparent``. Each verb's
latency also feeds :mod:`tpushare_torch.obs` (``note_verb``): the
timeline's p99 series and the exemplar that ``/metrics`` prints on the
bucket it landed in. Filter and bind link their decision to the pod's
journey (:mod:`tpushare_torch.slo`; a bind never opens one), and each
traced filter is one observation of the filter-latency objective.

Under leader election a follower answers bind with 503 "not the leader"
(``Retry-After: 1``), so the scheduler retries and the Service lands the
retry on the leader; every replica serves the read verbs. A verb that is
not wired answers 404 "... not configured".

Every verb answers with a ``Server-Timing`` header: the handler's own ms
and, for the read verbs, the micro-batch gate's queue wait. A malformed
body is refused with 400 and the handler returns. A bounded pool of
workers serves the accepted connections (``TPUSHARE_HTTP_WORKERS``, 8),
each for its keep-alive lifetime; a full hand-off queue blocks the
accept loop. The read verbs pass the micro-batch gate (routes/batch.py)
and the repeat-shape fast paths of routes/wire.py. The reference's
SLO, journey, defragmentation, autoscaler and router routes come with
those modules.
"""

from __future__ import annotations

import json
import logging
import math
import os
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

import tpushare_torch
from tpushare_torch import obs, profiling, slo, trace
from tpushare_torch.api.extender import (ExtenderBindingArgs,
                                         ExtenderPreemptionArgs)
from tpushare_torch.routes import metrics, pprof, wire
from tpushare_torch.routes.batch import VerbBatcher, WorkItem
from tpushare_torch.utils import locks
from tpushare_torch.utils import pod as podutils

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


def _traced_pod(pod) -> bool:
    """Only TPU pods get decision traces: the filter passes every other
    pod through untouched, and recording those would fill the flight
    recorder with non-decisions."""
    return (podutils.is_tpu_sharing_pod(pod)
            or podutils.is_tpu_chip_pod(pod))


class ExtenderHTTPServer(HTTPServer):
    allow_reuse_address = True
    #: Kernel accept backlog behind the bounded hand-off queue.
    request_queue_size = ACCEPT_QUEUE_DEPTH

    def __init__(self, addr, predicate, binder, inspect,
                 prefix: str = DEFAULT_PREFIX, prioritize=None,
                 preempt=None, admission=None, leader=None, quota=None,
                 gang_planner=None, workqueue=None, defrag=None,
                 debug_routes: bool = True):
        self.predicate = predicate
        self.binder = binder
        self.inspect = inspect
        self.prioritize = prioritize
        self.preempt = preempt
        self.admission = admission
        #: The leader elector (``is_leader() -> bool``) under leader
        #: election: only the leader binds.
        self.leader = leader
        #: The tenant quota ledger, for ``GET /debug/quota`` and the
        #: per-tenant gauges.
        self.quota = quota
        #: The gang planner, for the gangs-pending gauge (wired
        #: explicitly: dropping it must fail loudly, not freeze it).
        self.gang_planner = gang_planner
        #: The sync controller's workqueue, for its depth and retries.
        self.workqueue = workqueue
        #: The defrag executor, for the fragmentation gauges and
        #: ``GET /debug/defrag`` (wired explicitly, as the gang planner).
        self.defrag = defrag
        #: ``/debug/*`` shares the port with the webhook; operators can
        #: switch the routes off (``DEBUG_ROUTES=0``).
        self.debug_routes = debug_routes
        self.prefix = prefix
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
        # Wire stats, GIL-bumped ints for /debug/http and the
        # tpushare_http_* gauges.
        self.connections_total = 0
        self.requests_total = 0
        self.keepalive_reuses_total = 0
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
        self.connections_total += 1
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

    def _note_request(self, reused: bool) -> None:
        self.requests_total += 1
        if reused:
            self.keepalive_reuses_total += 1

    def http_stats(self) -> dict:
        """The wire path, for ``/debug/http`` and the tpushare_http_*
        gauges."""
        return {
            "workers": self.http_workers,
            "acceptQueueDepth": self._conn_queue.qsize(),
            "acceptQueueCapacity": ACCEPT_QUEUE_DEPTH,
            "socketTimeoutS": self.socket_timeout_s,
            "connectionsTotal": self.connections_total,
            "requestsTotal": self.requests_total,
            "keepaliveReusesTotal": self.keepalive_reuses_total,
            "filterGate": self.filter_gate.stats(),
            "prioritizeGate": self.prioritize_gate.stats(),
            "wireMemos": wire.memo_stats(),
        }

    # -- batched verb execution ------------------------------------------- #
    # The gates run these on whichever thread drains the batch, and the
    # trace phase opens here, per item, on that thread. A request that
    # raises is returned as its own result and re-raised on its own
    # handler thread, so it fails alone.

    def _filter_batch(self, items: list[WorkItem]):
        table, nominated = self.predicate.snapshot()
        out = []
        for it in items:
            try:
                out.append(self._run_filter(it.args, it.queue_s, table,
                                            nominated, parent=it.parent))
            except Exception as e:  # noqa: BLE001 - re-raised per item
                out.append(e)
        return out

    def _run_filter(self, args, queue_s, table, nominated, parent=""):
        t0 = time.perf_counter()
        with metrics.FILTER_LATENCY.time(), \
                trace.phase("filter", args.pod.namespace, args.pod.name,
                            args.pod.uid,
                            enabled=_traced_pod(args.pod)) as dec:
            if parent:
                trace.set_parent(parent)
            if queue_s:
                trace.note_queue_wait(queue_s)
            result = self.predicate.handle(args, table=table,
                                           nominated=nominated)
        handler_ms = (time.perf_counter() - t0) * 1e3
        if dec is not None:
            # One observation of the filter-latency objective ...
            slo.observe_filter(time.perf_counter() - t0)
            passed = (result.node_names if result.node_names is not None
                      else [n.name for n in (result.nodes or [])])
            if not passed:
                # Refused on every offered node: this attempt is over.
                trace.complete(dec, "unschedulable",
                               error="rejected on every candidate node")
            # ... and this attempt linked to the pod's journey (opening
            # it when the informer has not yet).
            slo.note_decision(args.pod.namespace, args.pod.name,
                              args.pod.uid, dec, pod=args.pod)
        # Timeline and exemplar (fire-and-forget, lock-free): the p99
        # series stays fresh without a scrape, and the bucket this
        # latency lands in remembers the trace id.
        obs.note_verb("filter", handler_ms / 1e3,
                      dec.trace_id if dec is not None else "")
        return (wire.encode_filter_result(result), handler_ms,
                dec.trace_id if dec is not None else "")

    def _prioritize_batch(self, items: list[WorkItem]):
        table = self.prioritize.snapshot()
        out = []
        for it in items:
            try:
                out.append(self._run_prioritize(it.args, it.queue_s, table,
                                                parent=it.parent))
            except Exception as e:  # noqa: BLE001 - re-raised per item
                out.append(e)
        return out

    def _run_prioritize(self, args, queue_s, table, parent=""):
        t0 = time.perf_counter()
        with metrics.PRIORITIZE_LATENCY.time(), \
                trace.phase("prioritize", args.pod.namespace, args.pod.name,
                            args.pod.uid,
                            enabled=_traced_pod(args.pod)) as dec:
            if parent:
                trace.set_parent(parent)
            if queue_s:
                trace.note_queue_wait(queue_s)
            entries = self.prioritize.handle(args, table=table)
        handler_ms = (time.perf_counter() - t0) * 1e3
        obs.note_verb("prioritize", handler_ms / 1e3,
                      dec.trace_id if dec is not None else "")
        return (wire.encode_host_priorities(entries), handler_ms,
                dec.trace_id if dec is not None else "")


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
        #: Requests served on this connection (keep-alive reuse).
        self._served = 0

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

    def _send_text(self, text: bytes, status: int = 200,
                   ctype: str = "text/plain; charset=utf-8") -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
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

    def _parent_trace(self) -> str:
        """The caller's causal root from its W3C ``traceparent`` header,
        or ``""`` (an absent or malformed header is no error)."""
        return trace.parse_traceparent(
            self.headers.get("traceparent", "") or "")

    def _query(self) -> dict[str, str]:
        if "?" not in self.path:
            return {}
        from urllib.parse import parse_qsl
        return dict(parse_qsl(self.path.split("?", 1)[1]))

    def _gated(self, gate: VerbBatcher, args) -> None:
        res, queue_s = gate.submit(args, parent=self._parent_trace())
        if isinstance(res, Exception):
            raise res  # this item's own failure: 500 below
        body, handler_ms, trace_id = res
        headers = _server_timing(handler_ms, queue_s * 1e3)
        if trace_id:
            headers["traceparent"] = trace.format_traceparent(trace_id)
        self._send_bytes(body, extra_headers=headers)

    def _serve_sampler(self, sampler, *, default_seconds: str,
                       default_hz: str,
                       ctype: str = "text/plain; charset=utf-8") -> None:
        """Shared seconds/hz parse, clamp and dispatch for the time-boxed
        profilers (profile, block, trace): one home for the bounds and
        the 400/409 contract. NaN is refused explicitly: it slips
        through min/max clamping and would make an empty profile."""
        q = self._query()
        try:
            seconds = float(q.get("seconds", default_seconds))
            hz = int(q.get("hz", default_hz))
            if not math.isfinite(seconds):
                raise ValueError(seconds)
        except ValueError:
            self._send_json({"Error": "seconds/hz must be numeric"}, 400)
            return
        seconds = min(max(seconds, 0.1), 60.0)
        hz = min(max(hz, 1), 1000)
        try:
            self._send_text(sampler(seconds, hz).encode(), ctype=ctype)
        except pprof.ProfileBusyError as e:
            self._send_json({"Error": str(e)}, 409)

    def _parse_window(self) -> tuple[bool, float | None]:
        """``?window=`` seconds for the continuous-profile surfaces:
        (True, seconds or None), None meaning the profiler's whole
        window; (False, None) after the 400 for a malformed value."""
        raw = self._query().get("window", "")
        if not raw:
            return True, None
        try:
            window = float(raw)
        except ValueError:
            self._send_json({"Error": "window must be numeric"}, 400)
            return False, None
        return True, min(max(window, 1.0), 3600.0)

    def _debug_profile(self, path: str) -> bool:
        """Serve a profiling route (``/debug/pprof*``,
        ``/debug/threads``, ``/debug/profile/continuous``,
        ``/debug/hotspots``); False when ``path`` is none."""
        if path in ("/debug/profile/continuous", "/debug/hotspots"):
            if not profiling.running():
                self._send_json(
                    {"Error": "continuous profiler is not running "
                              "(TPUSHARE_PROFILE=off, or the "
                              "process never armed it)"}, 404)
                return True
            if path == "/debug/profile/continuous":
                ok, window = self._parse_window()
                if ok:
                    self._send_text(profiling.profiler()
                                    .collapsed(window_s=window).encode())
                return True
            try:
                top = int(self._query().get("top", "5"))
            except ValueError:
                self._send_json({"Error": "top must be an integer"}, 400)
                return True
            ok, window = self._parse_window()
            if ok:
                self._send_json(profiling.hotspots_report(
                    top=min(max(top, 1), 50), window_s=window))
        elif path in ("/debug/threads", "/debug/pprof/goroutine"):
            self._send_text(pprof.thread_dump().encode())
        elif path == "/debug/pprof":
            self._send_text(pprof.index().encode())
        elif path == "/debug/pprof/profile":
            self._serve_sampler(pprof.sample_profile,
                                default_seconds="5", default_hz="100")
        elif path == "/debug/pprof/block":
            self._serve_sampler(pprof.sample_block_profile,
                                default_seconds="5", default_hz="100")
        elif path == "/debug/pprof/trace":
            self._serve_sampler(pprof.sample_trace,
                                default_seconds="2", default_hz="200",
                                ctype="application/json")
        elif path == "/debug/pprof/mutex":
            self._send_text(locks.render_mutex_profile().encode())
        elif path == "/debug/pprof/heap":
            stop = self._query().get("stop") in ("1", "true")
            self._send_text(pprof.heap_snapshot(stop=stop).encode())
        else:
            return False
        return True

    def _debug_get(self, path: str) -> bool:
        """Serve a ``/debug/*`` route; False when ``path`` is none."""
        if path == "/debug/flight":
            try:
                limit = int(self._query().get("n", "0") or 0)
            except ValueError:
                self._send_json({"Error": "n must be an integer"}, 400)
                return True
            self._send_json({
                "decisions": trace.flight(limit or None),
                "recordingDrops": trace.recorder().drops.value,
            })
        elif path == "/debug/quota":
            if self.server.quota is None:
                self._send_json({"Error": "quota not configured"}, 404)
            else:
                self._send_json({"tenants": self.server.quota.snapshot()})
        elif path == "/debug/defrag":
            if self.server.defrag is None:
                self._send_json({"Error": "defrag not configured"}, 404)
            else:
                self._send_json(self.server.defrag.status())
        elif path == "/debug/slo":
            self._send_json(slo.snapshot())
        elif path.startswith("/debug/journey/"):
            rest = path[len("/debug/journey/"):]
            ns, sep, pod_name = rest.partition("/")
            doc = (slo.get_journey(ns, pod_name)
                   if sep and pod_name and "/" not in pod_name else None)
            if doc is None:
                self._send_json(
                    {"Error": f"no journey for {rest!r} (want "
                              "/debug/journey/<namespace>/<pod>; "
                              "the tracker keeps the last "
                              f"~{slo.journey.DEFAULT_CAPACITY} "
                              "closed journeys)"}, 404)
            else:
                self._send_json(doc)
        elif path == "/debug/http":
            self._send_json(self.server.http_stats())
        elif path == "/debug/blackbox":
            doc = obs.blackbox_snapshot()
            if doc["journal"] is None and doc["export"] is None:
                self._send_json(
                    {"Error": "black-box journal is not armed "
                              "(set TPUSHARE_BLACKBOX_DIR and/or "
                              "TPUSHARE_EXPORT_URL)"}, 404)
            else:
                self._send_json(doc)
        elif path == "/debug/fleetday":
            # The fleet-day witness: its schedule, observation counts and
            # the last evaluate() report (null until a replay ran).
            self._send_json(obs.witness().snapshot())
        elif self._debug_profile(path):
            pass
        elif path == "/debug/timeline":
            self._debug_timeline()
        elif path == "/debug/trace":
            # A decision's causal chain: target, ancestors, descendants.
            chain_id = self._query().get("id", "")
            chain = trace.causal_chain(chain_id) if chain_id else None
            if chain is None:
                self._send_json(
                    {"Error": f"no causal chain for {chain_id!r} "
                              "(want /debug/trace?id=<trace-id>)"}, 404)
            else:
                self._send_json(chain)
        elif path.startswith("/debug/trace/"):
            rest = path[len("/debug/trace/"):]
            ns, sep, pod_name = rest.partition("/")
            trace_id = self._query().get("id", "")
            doc = (trace.get_trace(ns, pod_name, trace_id=trace_id)
                   if sep and pod_name and "/" not in pod_name else None)
            if doc is None:
                self._send_json(
                    {"Error": f"no trace for {rest!r} (want "
                              "/debug/trace/<namespace>/<pod>"
                              "[?id=<trace-id>])"}, 404)
            else:
                self._send_json(doc)
        else:
            return False
        return True

    def _debug_timeline(self) -> None:
        if not obs.enabled():
            self._send_json({"Error": "timeline recorder is disabled "
                                      "(TPUSHARE_TIMELINE=off)"}, 404)
            return
        query = self._query()
        window: float | None = None
        raw_window = query.get("window", "")
        if raw_window:
            try:
                window = min(max(float(raw_window), 1.0), 3600.0)
            except ValueError:
                self._send_json({"Error": "window must be numeric"}, 400)
                return
        series = None
        if query.get("series"):
            series = [s for s in query["series"].split(",") if s]
        markers = query.get("markers", "1") not in ("0", "false")
        self._send_json(obs.snapshot(window_s=window, series=series,
                                     markers=markers))

    # -- verbs -------------------------------------------------------------

    def do_GET(self):  # noqa: N802 (stdlib casing)
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        prefix = self.server.prefix
        self.server._note_request(self._served > 0)
        self._served += 1
        try:
            if path == "/version":
                self._send_json({"version": tpushare_torch.__version__})
            elif path == "/healthz":
                role = ""
                if self.server.leader is not None:
                    role = (" leader" if self.server.leader.is_leader()
                            else " follower")
                self._send_text(f"ok{role}".encode())
            elif path == "/metrics":
                server = self.server
                self._send_text(
                    metrics.scrape(server.inspect.cache,
                                   gang_planner=server.gang_planner,
                                   leader=server.leader,
                                   demand=server.predicate.demand,
                                   workqueue=server.workqueue,
                                   quota=server.quota,
                                   defrag=server.defrag,
                                   http_server=server),
                    ctype="text/plain; version=0.0.4")
            elif path.startswith("/debug/") and not self.server.debug_routes:
                self._send_json({"Error": "debug routes disabled"}, 404)
            elif path.startswith("/debug/") and self._debug_get(path):
                pass
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
        self.server._note_request(self._served > 0)
        self._served += 1
        try:
            if path == f"{prefix}/filter":
                args = self._read_args()
                if args is not None:
                    metrics.FILTER_REQUESTS.inc()
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
            elif path == f"{prefix}/preempt":
                doc = self._read_json()
                if doc is None:
                    return
                if self.server.preempt is None:
                    self._send_json({"Error": "preempt not configured"}, 404)
                    return
                pre_args = ExtenderPreemptionArgs.from_json(doc)
                t0 = time.perf_counter()
                with metrics.PREEMPT_LATENCY.time(), \
                        trace.phase("preempt", pre_args.pod.namespace,
                                    pre_args.pod.name, pre_args.pod.uid,
                                    enabled=_traced_pod(pre_args.pod)) \
                        as dec:
                    trace.set_parent(self._parent_trace())
                    result = self.server.preempt.handle(pre_args)
                handler_ms = (time.perf_counter() - t0) * 1e3
                obs.note_verb("preempt", handler_ms / 1e3,
                              dec.trace_id if dec is not None else "")
                self._send_json(result.to_json(),
                                extra_headers=_server_timing(handler_ms))
            elif path == f"{prefix}/validate":
                doc = self._read_json()
                if doc is None:
                    return
                if self.server.admission is None:
                    self._send_json({"Error": "admission not configured"},
                                    404)
                    return
                t0 = time.perf_counter()
                result = self.server.admission.handle(doc)
                handler_ms = (time.perf_counter() - t0) * 1e3
                if not result["response"]["allowed"]:
                    metrics.ADMISSION_REJECTED.inc()
                self._send_json(result,
                                extra_headers=_server_timing(handler_ms))
            elif path == f"{prefix}/bind":
                doc = self._read_json()
                if doc is None:
                    return
                args = ExtenderBindingArgs.from_json(doc)
                if (self.server.leader is not None
                        and not self.server.leader.is_leader()):
                    # A follower must not bind against its own, possibly
                    # stale, ledger. Checked at the last moment before the
                    # ledger commit; a write already in flight when
                    # leadership decays is bounded by the apiserver's
                    # request timeout (keep it below the lease duration).
                    self._send_json({"Error": "not the leader"}, 503,
                                    extra_headers={"Retry-After": "1"})
                    return
                t0 = time.perf_counter()
                with metrics.BIND_LATENCY.time(), \
                        trace.phase("bind", args.pod_namespace,
                                    args.pod_name, args.pod_uid) as dec:
                    # The caller's traceparent makes this decision a
                    # child of the scheduler's causal root.
                    trace.set_parent(self._parent_trace())
                    result = self.server.binder.handle(args)
                handler_ms = (time.perf_counter() - t0) * 1e3
                if result.error and not result.pending:
                    # A member held below quorum is an expected hold.
                    metrics.BIND_ERRORS.inc()
                # Bind ends the decision: bound, held below quorum (the
                # scheduler retries with a fresh attempt), or failed.
                if result.error and result.pending:
                    trace.complete(dec, "gang-pending", node=args.node,
                                   error=result.error)
                elif result.error:
                    trace.complete(dec, "failed", node=args.node,
                                   error=result.error)
                else:
                    trace.complete(dec, "bound", node=args.node)
                # The attempt joins the pod's journey, and a bound one
                # closes it; a bind opens none (after a restart the
                # controller rebuilds the journey from annotations).
                slo.note_decision(args.pod_namespace, args.pod_name,
                                  args.pod_uid, dec, open_new=False)
                obs.note_verb("bind", handler_ms / 1e3,
                              dec.trace_id if dec is not None else "")
                headers = _server_timing(handler_ms)
                headers["traceparent"] = trace.format_traceparent(
                    dec.trace_id)
                # gpushare answers 500 when bind fails, so the scheduler
                # retries; so does a member held below quorum.
                self._send_json(result.to_json(),
                                500 if result.error else 200,
                                extra_headers=headers)
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
