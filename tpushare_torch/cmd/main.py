"""The scheduler extender's process.

The twin of ``tpushare/cmd/main.py`` (gpushare's ``cmd/main.go``): build
the kube client, start the sync controller, wire the filter, prioritize,
bind and inspect verbs over one cache, and serve HTTP until signalled.

    python -m tpushare_torch.cmd.main

Environment:

* ``PORT``: the listen port, 39999 by default.
* ``KUBECONFIG``: the kubeconfig when not in a cluster.
* ``WORKERS``: sync worker threads, 4 by default.
* ``LOG_LEVEL``: debug, info (default), warning, error.
* ``LOG_DIR``: when set, log records also go to one file a level
  (``debug.log`` ... ``critical.log``, each holding its level alone).
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

Gangs go through the gang planner (all or nothing, a housekeeping
thread for expiry and binding retries). Quotas, preemption, admission,
leader election and the observability routes come with their own slices.
"""

from __future__ import annotations

import logging
import os
import signal
import sys
import threading
from typing import NamedTuple

from tpushare_torch.controller.controller import Controller
from tpushare_torch.gang.planner import GangPlanner
from tpushare_torch.k8s.client import ApiClient, ClusterConfig
from tpushare_torch.routes.server import (ExtenderHTTPServer, enable_tls,
                                          serve_forever)
from tpushare_torch.scheduler.bind import Bind
from tpushare_torch.scheduler.inspect import Inspect
from tpushare_torch.scheduler.predicate import DemandTracker, Predicate
from tpushare_torch.scheduler.prioritize import Prioritize

log = logging.getLogger(__name__)


def setup_signals(stop_event: threading.Event) -> None:
    """The first SIGINT or SIGTERM asks for shutdown; a second exits at
    once."""
    def handler(signum, frame):
        if stop_event.is_set():
            os._exit(1)
        stop_event.set()

    signal.signal(signal.SIGINT, handler)
    signal.signal(signal.SIGTERM, handler)


class Stack(NamedTuple):
    """The verbs wired over one shared cache."""

    controller: Controller
    predicate: Predicate
    prioritize: Prioritize
    binder: Bind
    inspect: Inspect


def build_stack(client, is_leader=None) -> Stack:
    """The controller, the gang planner and the verbs over one cache.
    One read of ``TPUSHARE_SCORING`` feeds the prioritize verb and every
    ledger's chip picker, so the two never disagree on the fleet default.
    ``is_leader`` (``() -> bool``) gates the planner's binding retries and
    the controller's gang reaper. Starts the planner's housekeeping
    thread; :func:`shutdown_stack` stops it."""
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
                       is_leader=is_leader, placer=placer)
    gang.start()
    # Demand entries prune against the informer's pod view.
    predicate = Predicate(controller.cache, demand=DemandTracker(
        pod_lookup=controller.hub.get_pod))
    prioritize = Prioritize(controller.cache, gang_planner=gang,
                            policy=scoring)
    binder = Bind(controller.cache, client, gang_planner=gang,
                  pod_lister=controller.hub.get_pod)
    inspect = Inspect(controller.cache, client.list_nodes,
                      gang_planner=gang)
    return Stack(controller, predicate, prioritize, binder, inspect)


def serve_stack(client, address=("127.0.0.1", 0), workers: int = 2):
    """Boot a wired stack and its HTTP server over ``client``; returns
    ``(stack, server)``. The harness of tests and of ``chip_smoke.py``."""
    stack = build_stack(client)
    stack.controller.start(workers=workers)
    server = ExtenderHTTPServer(address, stack.predicate, stack.binder,
                                stack.inspect, prioritize=stack.prioritize)
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
    """Console logging at ``LOG_LEVEL``; with ``log_dir`` (``LOG_DIR``)
    also one file a level, each holding exactly that level (gpushare's
    multi-file layout). Calling it again replaces the files it added."""
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


def main() -> None:
    configure_logging()
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
    stack = build_stack(client)
    stop = threading.Event()
    setup_signals(stop)
    stack.controller.start(workers=workers)
    server = ExtenderHTTPServer(("0.0.0.0", port), stack.predicate,
                                stack.binder, stack.inspect,
                                prioritize=stack.prioritize)
    if cert and key:
        enable_tls(server, cert, key)
        log.info("TLS enabled (%s)", cert)
    serve_forever(server)
    log.info("tpushare scheduler extender listening on :%d", port)
    stop.wait()
    log.info("shutting down")
    server.shutdown()
    stack.binder.gang_planner.stop()
    stack.controller.stop()


if __name__ == "__main__":
    main()
