"""The device-plugin daemon on NVIDIA nodes (a DaemonSet pod a node).

The twin of ``tpushare/cmd/deviceplugin_main.py``: discover the cards,
publish their GiB and model on this Node, serve and register both
extended resources with kubelet, run the grant watchdog, and serve again
and re-register when kubelet's socket is recreated (a kubelet restart
wipes the plugin directory and its registrations).

    NODE_NAME=<node> python -m tpushare_torch.cmd.deviceplugin_main

Environment:

* ``NODE_NAME``: required; the Node this daemon runs on (the downward
  API).
* ``KUBECONFIG``: the kubeconfig when not in a cluster.
* ``DEVICE_PLUGIN_PATH``: kubelet's plugin directory, by default
  ``/var/lib/kubelet/device-plugins``; the partial-grant checkpoint
  lives there too.
* ``TPUSHARE_USAGE_DIR``: the tenants' heartbeat directory (a hostPath),
  by default ``/var/run/tpushare/usage``; empty turns the watchdog off.
* ``TPUSHARE_EVICT_OVERRUN``: "true" evicts a tenant over its grant for
  ``TPUSHARE_EVICT_AFTER_SWEEPS`` (3) consecutive sweeps; by default the
  watchdog observes and attributes only.
* ``METRICS_PORT``: serve the watchdog's gauges in the Prometheus text
  format on this port; 0 or unset turns it off.
* ``TPUSHARE_GPU_MODEL``, ``NVIDIA_VISIBLE_DEVICES``: discovery's hints
  (:mod:`tpushare_torch.deviceplugin.discovery`).

Exits 2 without ``NODE_NAME`` and 1 when discovery finds no card.
"""

from __future__ import annotations

import http.server
import logging
import os
import signal
import sys
import threading
import time
from typing import Callable

from tpushare_torch.deviceplugin import discovery
from tpushare_torch.deviceplugin.kubelet import (
    DEVICE_PLUGIN_PATH, KUBELET_SOCKET, run_node_daemon)
from tpushare_torch.deviceplugin.watchdog import GrantWatchdog
from tpushare_torch.k8s.client import ApiClient, ClusterConfig
from tpushare_torch.utils import const

log = logging.getLogger(__name__)

#: How often the daemon looks at kubelet's socket, and how long it lets a
#: restarted kubelet come up before serving again.
KUBELET_POLL_S = 3.0
KUBELET_SETTLE_S = 1.0


def setup_signals(stop: threading.Event) -> None:
    """The first SIGINT or SIGTERM asks for shutdown; a second exits at
    once."""
    def handler(signum, frame):
        if stop.is_set():
            os._exit(1)
        stop.set()

    signal.signal(signal.SIGINT, handler)
    signal.signal(signal.SIGTERM, handler)


def serve_metrics(watchdog: GrantWatchdog,
                  port: int) -> http.server.ThreadingHTTPServer:
    """Serve :meth:`GrantWatchdog.render` on every path of ``port``, from
    a daemon thread."""
    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - the http.server interface
            body = watchdog.render()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            log.debug("metrics: " + fmt, *args)

    server = http.server.ThreadingHTTPServer(("", port), Handler)
    threading.Thread(target=server.serve_forever, name="tpushare-metrics",
                     daemon=True).start()
    return server


def _inode(path: str) -> int | None:
    try:
        return os.stat(path).st_ino
    except OSError:
        return None


def run(node_name: str, client, inventory, stop: threading.Event,
        plugin_dir: str = DEVICE_PLUGIN_PATH,
        usage_dir: str = const.USAGE_DIR_DEFAULT, evict_after: int = 0,
        metrics_port: int = 0,
        metrics_bound: Callable[[int], None] | None = None) -> None:
    """The daemon until ``stop``: serve both resources, sweep the
    heartbeats, serve the gauges, and serve again when kubelet's socket
    is recreated. The gauges are served on ``metrics_port``, or not at
    all when it is 0, unless ``metrics_bound`` is given: then on the port
    the kernel picks when ``metrics_port`` is 0, and ``metrics_bound`` is
    called with the port bound, once it serves."""
    servers = run_node_daemon(node_name, client, inventory,
                              plugin_dir=plugin_dir, usage_dir=usage_dir)
    metrics = None
    if usage_dir:
        os.makedirs(usage_dir, exist_ok=True)
        watchdog = GrantWatchdog(node_name, client, usage_dir=usage_dir,
                                 evict_after=evict_after)
        threading.Thread(target=watchdog.run, args=(stop,),
                         name="tpushare-grant-watchdog", daemon=True).start()
        if metrics_port or metrics_bound is not None:
            metrics = serve_metrics(watchdog, metrics_port)
            if metrics_bound is not None:
                metrics_bound(metrics.server_address[1])
    kubelet_sock = os.path.join(plugin_dir, KUBELET_SOCKET)
    kubelet_ino = _inode(kubelet_sock)
    try:
        while not stop.wait(KUBELET_POLL_S):
            # A restarted kubelet wipes our sockets with the directory:
            # serve fresh ones, then register them.
            ino = _inode(kubelet_sock)
            if ino == kubelet_ino:
                continue
            kubelet_ino = ino
            if ino is None:
                continue
            log.info("kubelet socket recreated; serving the plugins again "
                     "and re-registering")
            time.sleep(KUBELET_SETTLE_S)
            for server in servers:
                server.stop()
            servers = run_node_daemon(node_name, client, inventory,
                                      plugin_dir=plugin_dir,
                                      usage_dir=usage_dir)
    finally:
        for server in servers:
            server.stop()
        if metrics is not None:
            metrics.shutdown()
            metrics.server_close()


def main() -> None:
    logging.basicConfig(
        level=getattr(logging, os.environ.get("LOG_LEVEL", "info").upper(),
                      logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    node_name = os.environ.get("NODE_NAME", "")
    if not node_name:
        log.error("NODE_NAME is required (set via the downward API)")
        sys.exit(2)
    client = ApiClient(ClusterConfig.auto())
    node = client.get_node(node_name)
    inventory = discovery.discover_host(
        node_labels=node.labels if node is not None else {})
    if inventory is None:
        log.error("no NVIDIA card discovered on %s; exiting", node_name)
        sys.exit(1)
    stop = threading.Event()
    setup_signals(stop)
    evict = os.environ.get("TPUSHARE_EVICT_OVERRUN", "").lower() == "true"
    run(node_name, client, inventory, stop,
        plugin_dir=os.environ.get("DEVICE_PLUGIN_PATH", DEVICE_PLUGIN_PATH),
        usage_dir=os.environ.get("TPUSHARE_USAGE_DIR",
                                 const.USAGE_DIR_DEFAULT),
        evict_after=int(os.environ.get("TPUSHARE_EVICT_AFTER_SWEEPS", "3"))
        if evict else 0,
        metrics_port=int(os.environ.get("METRICS_PORT", "0")))


if __name__ == "__main__":
    main()
