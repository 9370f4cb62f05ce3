"""The port's apiserver client (``tpushare_torch/k8s/client.py``) against
the JAX package's, over one recording HTTP apiserver on localhost: every
call the node daemon makes goes through both clients, and the requests
the server saw (method, path, body), the objects returned and the errors
raised must agree. Then the cluster configuration: a kubeconfig with a
token and inline certificate data, the in-cluster service account, and
``auto``'s order."""

from __future__ import annotations

import base64
import http.server
import json
import tempfile
import threading

import pytest

from tpushare.k8s import client as JC
from tpushare.k8s import errors as JE
from tpushare_torch.api.objects import Node, Pod
from tpushare_torch.k8s import client as TC
from tpushare_torch.k8s import errors as TE

POD = {"metadata": {"name": "p", "namespace": "ns", "uid": "u1",
                    "resourceVersion": "7"},
       "spec": {"nodeName": "n1"}}
NODE = {"metadata": {"name": "n1", "resourceVersion": "3",
                     "annotations": {"tpushare.io/chip-hbm": "79"}}}


class Apiserver(http.server.BaseHTTPRequestHandler):
    """Canned answers; every request is appended to ``log``."""

    log: list = []

    def _answer(self):
        n = int(self.headers.get("Content-Length") or 0)
        body = json.loads(self.rfile.read(n)) if n else None
        self.log.append((self.command, self.path, body,
                         self.headers.get("Authorization")))
        path = self.path
        status, doc = 200, {}
        if path == "/api/v1/nodes/n1" and self.command == "GET":
            doc = NODE
        elif path.startswith("/api/v1/nodes/") and self.command == "GET":
            status, doc = 404, {"reason": "NotFound"}
        elif path.startswith("/api/v1/pods?"):
            if "continue=" not in path:
                doc = {"items": [POD], "metadata": {"continue": "a b"}}
            else:
                doc = {"items": [{**POD, "metadata": {
                    **POD["metadata"], "name": "q"}}], "metadata": {}}
        elif path == "/api/v1/namespaces/ns/pods/stale":
            status, doc = 409, {"reason": "Conflict"}
        elif path.endswith("/eviction"):
            status, doc = 429, {"reason": "TooManyRequests"}
        elif path.endswith("/events"):
            status, doc = 403, {"reason": "Forbidden"}
        elif self.command in ("PUT", "POST"):
            doc = body
        body_out = json.dumps(doc).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body_out)))
        self.end_headers()
        self.wfile.write(body_out)

    do_GET = do_PUT = do_POST = do_DELETE = _answer

    def log_message(self, *args):
        pass


@pytest.fixture
def server():
    Apiserver.log = []
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Apiserver)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def _calls(client, errors, objects):
    """The daemon's calls, with what each returned or raised."""
    node_cls, pod_cls = objects
    out = []

    def call(name, fn):
        try:
            got = fn()
        except errors.ApiError as e:
            out.append((name, type(e).__name__, e.status))
            return
        if isinstance(got, list):
            got = [g.raw for g in got]
        elif got is not None and hasattr(got, "raw"):
            got = got.raw
        out.append((name, got))

    call("get_node", lambda: client.get_node("n1"))
    call("get_node_missing", lambda: client.get_node("n9"))
    call("update_node", lambda: client.update_node(node_cls(NODE)))
    call("create_node", lambda: client.create_node(NODE))
    call("list_pods", lambda: client.list_pods(node_name="n1"))
    call("list_all", lambda: client.list_pods())
    call("get_pod", lambda: client.get_pod("ns", "p"))
    call("create_pod", lambda: client.create_pod(POD))
    call("update_pod", lambda: client.update_pod(pod_cls(POD)))
    call("update_stale", lambda: client.update_pod(pod_cls(
        {**POD, "metadata": {**POD["metadata"], "name": "stale"}})))
    call("delete_pod", lambda: client.delete_pod("ns", "p"))
    call("evict_pod", lambda: client.evict_pod("ns", "p"))
    call("create_event", lambda: client.create_event("ns", {"x": 1}))
    return out


def test_client_matches_the_reference(server):
    from tpushare.api.objects import Node as JNode, Pod as JPod

    results, logs = [], []
    for mod, errors, objects in ((JC, JE, (JNode, JPod)),
                                 (TC, TE, (Node, Pod))):
        Apiserver.log = []
        client = mod.ApiClient(mod.ClusterConfig(host=server, token="tok"))
        results.append(_calls(client, errors, objects))
        logs.append(list(Apiserver.log))
    assert results[1] == results[0]
    assert logs[1] == logs[0]
    got = dict((r[0], r[1:]) for r in results[1])
    assert got["update_stale"] == ("ConflictError", 409)
    assert got["evict_pod"] == ("ApiError", 429)
    assert got["get_node_missing"] == (None,)
    assert [p["metadata"]["name"] for p in got["list_pods"][0]] == ["p", "q"]
    assert {a for *_, a in logs[1]} == {"Bearer tok"}
    assert ("GET", "/api/v1/pods?limit=5000&fieldSelector=spec.nodeName"
            "%3Dn1&continue=a%20b", None, "Bearer tok") in logs[1]


def _kubeconfig(tmp_path, user: dict, cluster_extra: dict) -> str:
    import yaml

    doc = {"current-context": "c", "contexts": [
        {"name": "c", "context": {"cluster": "k", "user": "me"}}],
        "clusters": [{"name": "other", "cluster": {"server": "x"}},
                     {"name": "k", "cluster": {
                         "server": "https://10.0.0.1:6443/",
                         **cluster_extra}}],
        "users": [{"name": "me", "user": user}]}
    path = tmp_path / "kubeconfig"
    path.write_text(yaml.safe_dump(doc))
    return str(path)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("user,cluster", [
    ({"token": "t0k"}, {"certificate-authority-data":
                        base64.b64encode(b"CA PEM").decode()}),
    ({"client-certificate-data": base64.b64encode(b"CERT").decode(),
      "client-key-data": base64.b64encode(b"KEY").decode()},
     {"insecure-skip-tls-verify": True}),
    ({"client-certificate": "/etc/cert.pem", "client-key": "/etc/key.pem"},
     {"certificate-authority": "/etc/ca.pem"}),
])
def test_kubeconfig_matches_the_reference(tmp_path, monkeypatch, user,
                                          cluster):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # the PEMs
    path = _kubeconfig(tmp_path, user, cluster)
    want = JC.ClusterConfig.from_kubeconfig(path)
    got = TC.ClusterConfig.from_kubeconfig(path)
    assert (got.host, got.token, got.verify) == (want.host, want.token,
                                                 want.verify)
    for field in ("ca_file", "client_cert", "client_key"):
        a, b = getattr(want, field), getattr(got, field)
        assert (a is None) == (b is None), field
        if a is not None and a.startswith("/etc/"):
            assert b == a
        elif a is not None:
            assert _read(b) == _read(a)


def test_in_cluster_and_auto(tmp_path, monkeypatch):
    (tmp_path / "token").write_text("sa-token\n")
    for mod in (JC, TC):
        monkeypatch.setattr(mod, "SERVICE_ACCOUNT_DIR", str(tmp_path))
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "10.96.0.1")
    monkeypatch.setenv("KUBERNETES_SERVICE_PORT", "443")
    got = TC.ClusterConfig.auto()
    want = JC.ClusterConfig.auto()
    assert (got.host, got.token, got.ca_file) == (
        want.host, want.token, want.ca_file) == (
        "https://10.96.0.1:443", "sa-token", f"{tmp_path}/ca.crt")
    # Outside a cluster, auto reads the kubeconfig.
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST")
    monkeypatch.setenv("KUBECONFIG", _kubeconfig(
        tmp_path, {"token": "t"}, {"insecure-skip-tls-verify": True}))
    cfg = TC.ClusterConfig.auto()
    assert (cfg.host, cfg.token, cfg.verify) == ("https://10.0.0.1:6443",
                                                 "t", False)
    with pytest.raises(RuntimeError, match="not running in a cluster"):
        TC.ClusterConfig.in_cluster()
