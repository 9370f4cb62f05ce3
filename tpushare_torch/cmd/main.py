"""The scheduler extender's process.

The twin of ``tpushare/cmd/main.py`` (gpushare's ``cmd/main.go``): build
the kube client, start the sync controller, wire the filter, prioritize,
bind, preempt, admission and inspect verbs over one cache and one tenant
quota ledger, and serve HTTP until signalled.

    python -m tpushare_torch.cmd.main

Environment:

* ``PORT``: the listen port, 39999 by default.
* ``KUBECONFIG``: the kubeconfig when not in a cluster.
* ``WORKERS``: sync worker threads, 4 by default.
* ``LOG_LEVEL``: debug, info (default), warning, error.
* ``LOG_DIR``: when set, log records also go to one file a level
  (``debug.log`` ... ``critical.log``, each holding its level alone).
* ``TPUSHARE_LOG_JSON``: ``1`` (or ``true``, ``yes``) writes the console
  as one JSON object a line, each tagged with the decision trace id
  active on the emitting thread (``trace/jsonlog.py``).
* ``DEBUG_ROUTES``: ``0`` (or ``false``, ``no``) answers every
  ``/debug/*`` route with 404; on by default.
* ``TLS_CERT_FILE`` / ``TLS_KEY_FILE``: serve HTTPS; exactly one of them
  set exits 2.
* ``TPUSHARE_SCORING``: ``binpack`` (default, tightest fit) or ``spread``
  (the emptiest placement wins), for the prioritize verb and the chip
  picker alike.
* ``TPUSHARE_TOPOLOGY``: ``off`` (or ``0``, ``false``, ``no``) turns off
  the slice placer's election and steering of slice-shape gangs; on by
  default.
* ``TPUSHARE_HTTP_WORKERS``, ``TPUSHARE_HTTP_TIMEOUT_S``,
  ``TPUSHARE_BATCH``, ``TPUSHARE_BATCH_MAX``, ``TPUSHARE_BATCH_WINDOW_MS``:
  the wire path (routes/server.py).
* ``LEADER_ELECT``: ``1`` (or ``true``, ``yes``) joins a Lease election
  (``k8s/leader.py``), so several replicas can run and only the Lease
  holder binds; followers answer bind with 503 and serve the read verbs.
  ``LEASE_NAMESPACE`` holds the Lease, ``kube-system`` by default.
* ``TPUSHARE_QUOTA_NAMESPACE``: the one namespace the ``tpushare-quotas``
  ConfigMap is trusted from, ``kube-system`` by default.
* ``TPUSHARE_SLO_NAMESPACE``: the one namespace the ``tpushare-slos``
  ConfigMap (pod-journey objectives: error budgets and burn-rate alerts,
  ``slo/``) is trusted from, ``kube-system`` by default; with no such
  ConfigMap the built-in objectives hold.
* ``TPUSHARE_DEFRAG_MODE``: ``off``, ``dry-run`` (default) or ``active``,
  the defragmentation rebalancer's posture (``defrag/``). Dry-run plans
  and publishes moves and evicts nothing; active evicts under the budget
  of ``TPUSHARE_DEFRAG_MAX_MOVES`` (moves a plan, 8),
  ``TPUSHARE_DEFRAG_MOVES_PER_HOUR`` (20),
  ``TPUSHARE_DEFRAG_NODE_COOLDOWN_S`` (300),
  ``TPUSHARE_DEFRAG_MAX_CONCURRENT`` (2), every
  ``TPUSHARE_DEFRAG_INTERVAL_S`` (60), on the leader only, and aborts a
  plan while an SLO burns.
* ``TPUSHARE_GC_TUNE``: the fleet-scale GC posture (``utils/runtime.py``),
  on by default (``off``, ``0``, ``false``, ``no`` keep the interpreter's
  thresholds); ``TPUSHARE_GC_GEN0`` sets the gen-0 threshold. ``main``
  applies it; ``serve_stack`` does not.
* ``TPUSHARE_PROFILE``: ``on`` (default) arms the continuous profiler
  (``profiling/``: verb-attributed stacks at ``/debug/profile/continuous``
  and ``/debug/hotspots``, the duty-cycled decision probe, the
  ``tpushare_profiler_*`` series); ``off`` (or ``0``, ``false``, ``no``)
  leaves it disarmed. ``TPUSHARE_PROFILE_HZ`` sets its rate, clamped to
  1-1000 (25 by default). The per-verb cost ledger (``tpushare_verb_*``)
  counts either way. ``main`` arms it; ``serve_stack`` does not.
* ``TPUSHARE_TIMELINE``: ``on`` (default) arms the retrospective
  timeline (bounded series history, fleet-event markers and anomaly
  watchers, served at ``/debug/timeline``); ``off`` disables sampling,
  markers and exemplar annotation, and every emission site degrades to
  a no-op.
* ``TPUSHARE_BLACKBOX_DIR``: when set, arms the black-box flight journal
  (``obs/blackbox.py``): markers, per-tick series samples and completed
  decisions append to CRC-framed, size-capped segments in this directory
  (``TPUSHARE_BLACKBOX_SEGMENT_BYTES``, 1 MiB, and
  ``TPUSHARE_BLACKBOX_SEGMENTS``, 8, bound it); SIGTERM and exit fsync
  the tail, and the next start replays it onto ``/debug/timeline`` and
  ``/debug/trace`` behind a ``restart`` marker. Unset: no journal.
* ``TPUSHARE_EXPORT_URL``: when set, the same records stream as
  JSON-lines POSTs to this HTTP sink (bounded queue, exponential
  backoff, an ``export-stall`` marker on a sustained failure).

Variables of the reference's main that the port does not yet read
(``NOT_PORTED``: autoscaling) are logged as a warning, one line each, when
set.
"""

from __future__ import annotations

import atexit
import logging
import os
import signal
import sys
import threading
from typing import NamedTuple

from tpushare_torch import obs
from tpushare_torch.controller.controller import Controller
from tpushare_torch.gang.planner import GangPlanner
from tpushare_torch.k8s.client import ApiClient, ClusterConfig
from tpushare_torch.routes.server import (ExtenderHTTPServer, enable_tls,
                                          serve_forever)
from tpushare_torch.scheduler.admission import Admission
from tpushare_torch.scheduler.bind import Bind
from tpushare_torch.scheduler.inspect import Inspect
from tpushare_torch.scheduler.predicate import DemandTracker, Predicate
from tpushare_torch.scheduler.preempt import Preempt
from tpushare_torch.scheduler.prioritize import Prioritize

log = logging.getLogger(__name__)

#: The reference main's variables that the port does not read yet, and
#: what of the reference each one sets.
NOT_PORTED = {
    "TPUSHARE_AUTOSCALE": "the fleet autoscaler",
    "TPUSHARE_AUTOSCALE_MIN_NODES": "the fleet autoscaler",
    "TPUSHARE_AUTOSCALE_MAX_NODES": "the fleet autoscaler",
    "TPUSHARE_AUTOSCALE_UP_DELAY_S": "the fleet autoscaler",
    "TPUSHARE_AUTOSCALE_DOWN_DELAY_S": "the fleet autoscaler",
    "TPUSHARE_AUTOSCALE_COOLDOWN_S": "the fleet autoscaler",
    "TPUSHARE_AUTOSCALE_INTERVAL_S": "the fleet autoscaler",
}


def warn_not_ported() -> list[str]:
    """Log one warning for each variable of ``NOT_PORTED`` that is set;
    returns their names."""
    names = [name for name in NOT_PORTED if os.environ.get(name)]
    for name in names:
        log.warning("%s is set but not read: %s is not yet ported",
                    name, NOT_PORTED[name])
    return names


def setup_signals(stop_event: threading.Event, flush=None) -> None:
    """The first SIGINT or SIGTERM asks for shutdown; a second exits at
    once. ``flush`` (``() -> bool``, e.g. ``obs.flush_blackbox``) runs on
    the first signal, after the stop event is set and before the main
    thread tears the servers down: the journal's SIGTERM durability
    point. A flush that fails is swallowed, so it can delay shutdown by
    at most its own timeout and never wedge it."""
    def handler(signum, frame):
        if stop_event.is_set():
            os._exit(1)
        stop_event.set()
        if flush is not None:
            try:
                flush()
            except Exception:  # noqa: BLE001 - flushing must not wedge exit
                pass

    signal.signal(signal.SIGINT, handler)
    signal.signal(signal.SIGTERM, handler)


class Stack(NamedTuple):
    """The verbs wired over one shared cache."""

    controller: Controller
    predicate: Predicate
    prioritize: Prioritize
    binder: Bind
    inspect: Inspect
    preempt: Preempt
    admission: Admission


def build_stack(client, is_leader=None) -> Stack:
    """The controller, the gang planner and the verbs over one cache.
    One read of ``TPUSHARE_SCORING`` feeds the prioritize verb and every
    ledger's chip picker, so the two never disagree on the fleet default.
    The controller's quota ledger is the one object every verb reads, so
    filter, bind, scoring, the gang pre-check and preemption agree on a
    tenant's standing. ``is_leader`` (``() -> bool``) gates the planner's
    binding retries and the controller's gang reaper. Starts the
    planner's housekeeping thread, which :func:`shutdown_stack` stops,
    and wires the timeline's sources (published ledgers only, never a
    fleet rescan) and arms its sampler and, where the environment asks,
    the black-box journal (``obs.stop`` disarms them)."""
    scoring = os.environ.get("TPUSHARE_SCORING", "binpack")
    controller = Controller(client, is_leader=is_leader,
                            default_scoring=scoring)
    # The slice placer costs nothing until a slice-shape gang arrives;
    # TPUSHARE_TOPOLOGY=off is the fleet-wide kill switch.
    placer = None
    if os.environ.get("TPUSHARE_TOPOLOGY", "on").lower() not in (
            "off", "0", "false", "no"):
        from tpushare_torch.topology.fleet import SlicePlacer
        placer = SlicePlacer(controller.cache)
    # The quorum pre-check lists nodes from the informer's store: no
    # apiserver LIST on the bind path.
    gang = GangPlanner(controller.cache, client,
                       node_lister=controller.hub.nodes.list,
                       is_leader=is_leader, quota=controller.quota,
                       placer=placer)
    gang.start()
    # Demand entries prune against the informer's pod view.
    predicate = Predicate(controller.cache, demand=DemandTracker(
        pod_lookup=controller.hub.get_pod),
        quota=controller.quota, client=client)
    # The frag index measures stranding against the shapes failing the
    # filter now: the predicate owns that tracker.
    controller.defrag.set_demand(predicate.demand)
    prioritize = Prioritize(controller.cache, gang_planner=gang,
                            policy=scoring, quota=controller.quota)
    binder = Bind(controller.cache, client, gang_planner=gang,
                  pod_lister=controller.hub.get_pod,
                  quota=controller.quota)
    inspect = Inspect(controller.cache, client.list_nodes,
                      gang_planner=gang)
    # The budgets feed preempt's violation count for the victim sets it
    # names (the scheduler's counts are for its own sets).
    preempt = Preempt(controller.cache, pdb_lister=controller.hub.pdbs.list,
                      quota=controller.quota)
    admission = Admission(controller.cache,
                          node_lister=controller.hub.nodes.list)
    obs.wire(client=client, demand=predicate.demand,
             defrag=controller.defrag, workqueue=controller.queue,
             nodes=controller.hub.nodes.list)
    obs.start()
    return Stack(controller, predicate, prioritize, binder, inspect,
                 preempt, admission)


def make_server(stack: Stack, address, leader=None,
                debug_routes: bool = True) -> ExtenderHTTPServer:
    """The HTTP server over every verb of ``stack``, with the gang
    planner, the workqueue, the quota ledger and the defrag executor its
    ``/metrics`` and ``/debug/defrag`` read."""
    return ExtenderHTTPServer(address, stack.predicate, stack.binder,
                              stack.inspect, prioritize=stack.prioritize,
                              preempt=stack.preempt,
                              admission=stack.admission, leader=leader,
                              quota=stack.controller.quota,
                              gang_planner=stack.binder.gang_planner,
                              workqueue=stack.controller.queue,
                              defrag=stack.controller.defrag,
                              debug_routes=debug_routes)


def serve_stack(client, address=("127.0.0.1", 0), workers: int = 2,
                leader=None):
    """Boot a wired stack and its HTTP server over ``client``; returns
    ``(stack, server)``. The harness of tests and of ``chip_smoke.py``.
    ``leader`` (a started :class:`tpushare_torch.k8s.leader.
    LeaderElector`) gates bind, the planner's retries and the reaper on
    its Lease, as ``main`` does under ``LEADER_ELECT``."""
    stack = build_stack(
        client, is_leader=leader.is_leader if leader is not None else None)
    stack.controller.start(workers=workers)
    server = make_server(stack, address, leader=leader)
    serve_forever(server)
    return stack, server


def shutdown_stack(stack, server) -> None:
    """Tear down a :func:`serve_stack` harness."""
    server.shutdown()
    server.server_close()
    stack.binder.gang_planner.stop()
    stack.controller.stop()


def configure_logging(level_name: str | None = None,
                      log_dir: str | None = None) -> None:
    """Console logging at ``LOG_LEVEL``, as JSON lines tagged with the
    decision trace id under ``TPUSHARE_LOG_JSON``; with ``log_dir``
    (``LOG_DIR``) also one file a level, each holding exactly that level
    (gpushare's multi-file layout). Calling it again replaces the files
    it added."""
    level = (level_name or os.environ.get("LOG_LEVEL", "info")).upper()
    root_level = getattr(logging, level, logging.INFO)
    root = logging.getLogger()
    had_handlers = bool(root.handlers)
    logging.basicConfig(level=root_level,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    if not had_handlers:
        # basicConfig just installed the console handler: tag it, so a
        # second call recognizes it. A host's own handlers stay as they
        # are.
        for handler in root.handlers:
            handler._tpushare_console = True
    if os.environ.get("TPUSHARE_LOG_JSON", "").lower() in ("1", "true",
                                                           "yes"):
        # Only our console handler: a host's keep their format.
        from tpushare_torch.trace.jsonlog import TraceJsonFormatter
        for handler in root.handlers:
            if getattr(handler, "_tpushare_console", False):
                handler.setFormatter(TraceJsonFormatter())
    log_dir = log_dir if log_dir is not None else os.environ.get(
        "LOG_DIR", "")
    for handler in list(root.handlers):
        if getattr(handler, "_tpushare_level_file", False):
            root.removeHandler(handler)
            handler.close()
    if not log_dir:
        return
    os.makedirs(log_dir, exist_ok=True)
    # The files take every level; the console keeps LOG_LEVEL.
    root.setLevel(min(root_level, logging.DEBUG))
    for handler in root.handlers:
        if getattr(handler, "_tpushare_console", False):
            handler.setLevel(root_level)
        elif (isinstance(handler, logging.StreamHandler)
              and not isinstance(handler, logging.FileHandler)
              and handler.level == logging.NOTSET):
            # A host's NOTSET stream handler would start emitting DEBUG.
            handler.setLevel(root_level)
    fmt = logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s")
    for name, lvl in (("debug", logging.DEBUG), ("info", logging.INFO),
                      ("warning", logging.WARNING),
                      ("error", logging.ERROR),
                      ("critical", logging.CRITICAL)):
        fh = logging.FileHandler(os.path.join(log_dir, f"{name}.log"))
        fh.setLevel(lvl)
        fh.addFilter(lambda rec, lv=lvl: rec.levelno == lv)
        fh.setFormatter(fmt)
        fh._tpushare_level_file = True
        root.addHandler(fh)


def start_leader(client):
    """A started :class:`tpushare_torch.k8s.leader.LeaderElector` when
    ``LEADER_ELECT`` is on, else None. Its identity is unique even
    without ``HOSTNAME``: two replicas sharing one would both pass the
    holder's renewal check."""
    env = os.environ
    if env.get("LEADER_ELECT", "").lower() not in ("1", "true", "yes"):
        return None
    from uuid import uuid4

    from tpushare_torch.k8s.leader import LeaderElector
    identity = (f"{env.get('HOSTNAME') or 'pid'}-{os.getpid()}-"
                f"{uuid4().hex[:8]}")
    leader = LeaderElector(
        client, identity,
        namespace=env.get("LEASE_NAMESPACE", "kube-system"))
    leader.start()
    log.info("leader election enabled (identity %s)", identity)
    return leader


def main() -> None:
    configure_logging()
    # The fleet-scale GC posture (TPUSHARE_GC_TUNE, on by default): the
    # default thresholds' gen-2 pauses make the webhook's p99 at 1,024
    # nodes.
    from tpushare_torch.utils.runtime import tune_gc_from_env
    tune_gc_from_env()
    # The continuous profiler and the per-verb cost ledger
    # (TPUSHARE_PROFILE, on by default: running before the incident).
    from tpushare_torch import profiling
    profiling.arm_from_env()
    # Disarmed at every exit (sys.exit included): the interpreter puts
    # SIGPROF's default action back as it finalizes, and a fire of the
    # armed ITIMER_PROF after that would kill the process.
    atexit.register(profiling.stop)
    warn_not_ported()
    port = int(os.environ.get("PORT", "39999"))
    workers = int(os.environ.get("WORKERS", "4"))
    cert, key = os.environ.get("TLS_CERT_FILE"), os.environ.get(
        "TLS_KEY_FILE")
    if bool(cert) != bool(key):
        log.error("TLS misconfigured: exactly one of TLS_CERT_FILE / "
                  "TLS_KEY_FILE is set; refusing to serve plain HTTP "
                  "behind an enableHTTPS registration")
        sys.exit(2)
    client = ApiClient(ClusterConfig.auto())
    # Before the stack, so the planner's retries are leader-gated.
    leader = start_leader(client)
    stack = build_stack(
        client, is_leader=leader.is_leader if leader is not None else None)
    stop = threading.Event()
    setup_signals(stop, flush=obs.flush_blackbox)
    # A clean interpreter exit flushes too; a SIGKILL keeps what the
    # journal's writer already handed the page cache.
    atexit.register(obs.flush_blackbox)
    stack.controller.start(workers=workers)
    debug_routes = os.environ.get("DEBUG_ROUTES", "1").lower() not in (
        "0", "false", "no")
    server = make_server(stack, ("0.0.0.0", port), leader=leader,
                         debug_routes=debug_routes)
    if cert and key:
        enable_tls(server, cert, key)
        log.info("TLS enabled (%s)", cert)
    serve_forever(server)
    log.info("tpushare scheduler extender listening on :%d", port)
    stop.wait()
    log.info("shutting down")
    server.shutdown()
    if leader is not None:
        leader.stop()
    stack.binder.gang_planner.stop()
    stack.controller.stop()
    # Last: drain, fsync and close the journal and the exporter (the
    # signal handler flushed what was queued at SIGTERM; this takes what
    # the teardown above emitted).
    obs.stop()


if __name__ == "__main__":
    main()
