"""The extender's k8s plumbing in the port against the JAX package's: the
apiserver client's bind, node list and watch streams
(``tpushare_torch/k8s/client.py``), the fake apiserver's watch fan-out
(``fake.py``), the informer (``informer.py``) and the rate-limited work
queue (``workqueue.py``).

Each case runs the same calls or the same seeded operations through both
packages and compares what the server saw, what came out of the stream,
what the handlers were told and what the store holds.
"""

from __future__ import annotations

import http.server
import json
import queue
import threading
import time

import numpy as np
import pytest

from tpushare.api.objects import Node as JNode, Pod as JPod
from tpushare.k8s import client as JC
from tpushare.k8s.builders import make_node, make_pod
from tpushare.k8s.fake import FakeApiServer as JFake
from tpushare.k8s.informer import InformerHub as JHub
from tpushare.k8s.workqueue import RateLimitedQueue as JQueue
from tpushare_torch.api.objects import binding_doc
from tpushare_torch.api.objects import Pod as TPod
from tpushare_torch.k8s import client as TC
from tpushare_torch.k8s.fake import FakeApiServer as TFake
from tpushare_torch.k8s.informer import InformerHub as THub
from tpushare_torch.k8s.workqueue import RateLimitedQueue as TQueue

NODE = {"metadata": {"name": "n1", "resourceVersion": "3"}}
POD = {"metadata": {"name": "p", "namespace": "ns", "uid": "u1",
                    "resourceVersion": "7"}}


class Apiserver(http.server.BaseHTTPRequestHandler):
    """LIST answers and, for ``watch=true``, a stream: the pod stream
    sends ADDED, MODIFIED, DELETED and then a 410 ERROR the first time,
    after which the client must LIST again; the node stream sends one
    ADDED. Every request is logged."""

    log: list = []
    streamed: dict = {}

    def do_GET(self):  # noqa: N802
        self.log.append(("GET", self.path))
        path, _, query = self.path.partition("?")
        kind = "pods" if path == "/api/v1/pods" else (
            "nodes" if path == "/api/v1/nodes" else "")
        if not kind:
            self.send_response(404)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        if "watch=true" not in query:
            items = [POD] if kind == "pods" else [NODE]
            self._json({"items": items, "metadata": {"resourceVersion": "9"}})
            return
        n = self.streamed.get(kind, 0)
        self.streamed[kind] = n + 1
        if kind == "pods" and n == 0:
            events = [{"type": "ADDED", "object": POD},
                      {"type": "MODIFIED", "object": {**POD, "spec": {
                          "nodeName": "n1"}}},
                      {"type": "DELETED", "object": POD},
                      {"type": "ERROR", "object": {"code": 410}}]
        elif kind == "nodes" and n == 0:
            events = [{"type": "ADDED", "object": NODE}]
        else:
            time.sleep(1.0)  # a quiet watch, not a relist storm
            events = []
        body = b"".join(json.dumps(e).encode() + b"\n" for e in events)
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):  # noqa: N802
        n = int(self.headers.get("Content-Length") or 0)
        body = json.loads(self.rfile.read(n))
        self.log.append(("POST", self.path, body))
        self._json(body)

    def _json(self, doc):
        out = json.dumps(doc).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)

    def log_message(self, *args):
        pass


def serve():
    """A fresh apiserver with its own log and stream counts; returns
    (handler class, url, server)."""
    handler = type("Apiserver", (Apiserver,), {"log": [], "streamed": {}})
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return handler, f"http://127.0.0.1:{srv.server_address[1]}", srv


def _drain(q: queue.Queue, want: dict, timeout: float = 30.0) -> dict:
    """The first ``want[kind]`` items of each kind's stream (the streams
    interleave as their threads run)."""
    out = {k: [] for k in want}
    deadline = time.monotonic() + timeout
    while (any(len(out[k]) < n for k, n in want.items())
           and time.monotonic() < deadline):
        try:
            kind, etype, raw = q.get(timeout=0.2)
        except queue.Empty:
            continue
        if kind in out and len(out[kind]) < want[kind]:
            out[kind].append((kind, etype, raw))
    return out


def test_client_bind_list_and_watch_match_the_reference():
    seen = {}
    for name, mod in (("jax", JC), ("port", TC)):
        handler, url, srv = serve()
        try:
            client = mod.ApiClient(mod.ClusterConfig(host=url))
            client.bind_pod(binding_doc(TPod(POD), "n1"))
            nodes = [n.raw for n in client.list_nodes()]
            q = client.watch()
            # Pods: RELIST, 3 events, RELIST after the 410; nodes:
            # RELIST, ADDED.
            items = _drain(q, {"Pod": 5, "Node": 2})
            client.stop_watch(q)
        finally:
            srv.shutdown()
            srv.server_close()
        posts = [e for e in handler.log if e[0] == "POST"]
        seen[name] = (posts, nodes, items)
    assert seen["port"] == seen["jax"]
    posts, nodes, items = seen["port"]
    assert posts == [("POST", "/api/v1/namespaces/ns/pods/p/binding",
                      binding_doc(TPod(POD), "n1"))]
    assert nodes == [NODE]
    assert [e[1] for e in items["Pod"]] == [
        "RELIST", "ADDED", "MODIFIED", "DELETED", "RELIST"]
    assert [e[1] for e in items["Node"]] == ["RELIST", "ADDED"]


def _fake_ops(api, pod_cls, node_cls):
    api.create_node(make_node("n1"))
    api.create_pod(make_pod("a", hbm=2, uid="ua"))
    api.create_pod(make_pod("b", hbm=4, uid="ub"))
    p = api.get_pod("default", "a")
    p.metadata.setdefault("labels", {})["k"] = "v"
    api.update_pod(pod_cls(p.raw))
    api.bind_pod(binding_doc(TPod(api.get_pod("default", "b").raw), "n1"))
    api.update_pod_status("default", "b", "Running")
    n = api.get_node("n1")
    n.metadata["labels"] = {"x": "y"}
    api.update_node(node_cls(n.raw))
    api.delete_pod("default", "a")
    api.delete_node("n1")


def test_fake_watch_streams_match_the_reference():
    streams = []
    for fake, pod_cls, node_cls in ((JFake, JPod, JNode),
                                    (TFake, TPod, JNode)):
        api = fake()
        q = api.watch()
        _fake_ops(api, pod_cls, node_cls)
        items = []
        while not q.empty():
            kind, etype, raw = q.get()
            raw["metadata"].pop("creationTimestamp", None)
            items.append((kind, etype, raw))
        api.stop_watch(q)
        api.create_node(make_node("n2"))
        assert q.empty()  # a stopped watch hears nothing
        streams.append(items)
    assert streams[1] == streams[0]
    assert len(streams[0]) == 9


class Recorder:
    """Handlers that log what they are told."""

    def __init__(self, hub, kind):
        self.log = []
        add = getattr(hub, f"add_{kind}_handler")
        add(on_add=lambda o: self.log.append(("add", o.raw)),
            on_update=lambda old, new: self.log.append(
                ("update", old.raw if old is not None else None, new.raw)),
            on_delete=lambda o: self.log.append(("delete", o.raw)),
            filter_fn=lambda o: o.name != "ignored")


def _strip(x):
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items()
                if k != "creationTimestamp"}
    if isinstance(x, (list, tuple)):
        return type(x)(_strip(v) for v in x)
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_informer_matches_the_reference(seed):
    """Seeded creates, updates, binds, status changes and deletes of pods
    and nodes (one filtered out by the handlers' filter), then a RELIST
    that drops one pod and changes another: both informers tell their
    handlers the same and hold the same stores."""
    records = []
    for fake, hub_cls, pod_cls, node_cls in (
            (JFake, JHub, JPod, JNode), (TFake, THub, TPod, JNode)):
        rng = np.random.default_rng(seed)
        api = fake()
        api.create_node(make_node("pre"))
        api.create_pod(make_pod("pre", hbm=1, uid="u-pre"))
        hub = hub_cls(api)
        pods, nodes = Recorder(hub, "pod"), Recorder(hub, "node")
        hub.start()
        assert hub.wait_for_sync()
        names = []
        for step in range(40):
            op = rng.integers(5)
            if op == 0 or not names:
                name = "ignored" if step == 7 else f"p{step}"
                api.create_pod(make_pod(name, hbm=int(rng.integers(1, 9)),
                                        uid=f"u{step}"))
                names.append(name)
            elif op == 1:
                api.update_pod_status("default", str(rng.choice(names)),
                                      "Running")
            elif op == 2:
                name = names.pop(int(rng.integers(len(names))))
                api.delete_pod("default", name)
            elif op == 3:
                api.create_node(make_node(f"n{step}"))
            else:
                name = str(rng.choice(names))
                p = api.get_pod("default", name)
                p.metadata.setdefault("annotations", {})["s"] = str(step)
                api.update_pod(pod_cls(p.raw))
        # A reconnect: the LIST no longer has one pod, and has another
        # changed.
        listing = [p.raw for p in api.list_pods()]
        if listing:
            listing.pop(0)
        if listing:
            listing[-1] = {**listing[-1], "spec": {
                **listing[-1]["spec"], "nodeName": "pre"}}
        hub._watch_queue.put(("Pod", "RELIST", listing))
        deadline = time.monotonic() + 30
        while not hub.quiesced() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert hub.quiesced()
        stores = (sorted((k, _strip(o.raw)) for k, o in
                         ((f"{o.namespace}/{o.name}", o)
                          for o in hub.pods.list())),
                  sorted(o.name for o in hub.nodes.list()))
        hub.stop()
        records.append((_strip(pods.log), _strip(nodes.log), stores,
                        hub.get_pod("default", "pre") is not None))
    assert records[1] == records[0]


@pytest.mark.parametrize("seed", [0, 1])
def test_workqueue_matches_the_reference(seed):
    """Seeded add / get / done / forget / rate-limited requeue on both
    queues: the same keys come out in the same order, a key a worker
    holds is not handed out again, and the same failures are counted (the
    backoff is long enough that no requeued key returns in the test)."""
    outs = []
    for cls in (JQueue, TQueue):
        rng = np.random.default_rng(seed)
        q = cls(base_delay=30.0, max_delay=60.0)
        got, held = [], []
        for _ in range(200):
            op = rng.integers(5)
            key = f"k{int(rng.integers(6))}"
            if op == 0:
                q.add(key)
            elif op == 1:
                k = q.get(timeout=0)
                got.append(k)
                if k is not None:
                    held.append(k)
            elif op == 2 and held:
                q.done(held.pop(0))
            elif op == 3 and held:
                k = held.pop(0)
                q.add_rate_limited(k)
                q.done(k)
            elif op == 4:
                q.forget(key)
        got.append(len(q))
        outs.append((got, q._failures, sorted(q._processing)))
        q.shut_down()
    assert outs[1] == outs[0]
