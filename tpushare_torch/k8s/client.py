"""Minimal Kubernetes REST client (stdlib only).

The port's copy of ``tpushare/k8s/client.py``'s ``ClusterConfig`` and of
the ``ApiClient`` calls the device plugin, the grant watchdog and the
scheduler extender make: nodes and pods (get, list, create, update,
delete, evict, bind), Events, and the pod and node watch streams. It has
the calls of :class:`tpushare_torch.k8s.fake.FakeApiServer`, so either
runs under both.

Auth: the in-cluster service-account token and CA, or a kubeconfig with
token or client-certificate auth (``KUBECONFIG``).
"""

from __future__ import annotations

import base64
import json
import logging
import os
import queue
import ssl
import tempfile
import threading
import time
import urllib.error
import urllib.request
from urllib.parse import quote

from tpushare_torch import trace
from tpushare_torch.api.objects import (ConfigMap, Node, Pod,
                                        PodDisruptionBudget)
from tpushare_torch.k8s.errors import ApiError, ConflictError, NotFoundError
from tpushare_torch.utils import const

log = logging.getLogger(__name__)

SERVICE_ACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

#: The ConfigMaps the extender reads (the quota table and the SLO
#: objectives), each over a LIST/WATCH of its own name (a fieldSelector
#: cannot OR names; a watch of every ConfigMap would keep each
#: namespace's documents in the store).
_WATCHED_CONFIGMAPS = (const.QUOTA_CONFIGMAP, const.SLO_CONFIGMAP)


def _configmap_path(name: str) -> str:
    return ("/api/v1/configmaps?fieldSelector="
            + quote(f"metadata.name={name}"))


def _pem_file(data: str) -> str:
    """A kubeconfig's base64 ``*-data`` field written to a file, as the
    ssl module loads certificates from paths."""
    with tempfile.NamedTemporaryFile(delete=False, suffix=".pem") as tmp:
        tmp.write(base64.b64decode(data))
        return tmp.name


class ClusterConfig:
    def __init__(self, host: str, token: str = "", ca_file: str | None = None,
                 client_cert: str | None = None,
                 client_key: str | None = None, verify: bool = True):
        self.host = host.rstrip("/")
        self.token = token
        self.ca_file = ca_file
        self.client_cert = client_cert
        self.client_key = client_key
        self.verify = verify

    @classmethod
    def in_cluster(cls) -> "ClusterConfig":
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        if not host:
            raise RuntimeError("not running in a cluster "
                               "(KUBERNETES_SERVICE_HOST unset)")
        with open(f"{SERVICE_ACCOUNT_DIR}/token", encoding="utf-8") as f:
            token = f.read().strip()
        return cls(host=f"https://{host}:{port}", token=token,
                   ca_file=f"{SERVICE_ACCOUNT_DIR}/ca.crt")

    @classmethod
    def from_kubeconfig(cls, path: str | None = None) -> "ClusterConfig":
        import yaml

        path = path or os.environ.get("KUBECONFIG",
                                      os.path.expanduser("~/.kube/config"))
        with open(path, encoding="utf-8") as f:
            cfg = yaml.safe_load(f)

        def by_name(section, name):
            for item in cfg.get(section, []):
                if item.get("name") == name:
                    return item
            raise RuntimeError(f"kubeconfig: no {section} entry {name!r}")

        ctx = by_name("contexts", cfg.get("current-context"))["context"]
        cluster = by_name("clusters", ctx["cluster"])["cluster"]
        user = by_name("users", ctx["user"])["user"]

        def materialize(section, data_key, file_key):
            if section.get(file_key):
                return section[file_key]
            if section.get(data_key):
                return _pem_file(section[data_key])
            return None

        return cls(
            host=cluster["server"],
            token=user.get("token", ""),
            ca_file=materialize(cluster, "certificate-authority-data",
                                "certificate-authority"),
            client_cert=materialize(user, "client-certificate-data",
                                    "client-certificate"),
            client_key=materialize(user, "client-key-data", "client-key"),
            verify=not cluster.get("insecure-skip-tls-verify", False),
        )

    @classmethod
    def auto(cls) -> "ClusterConfig":
        """In-cluster first, then the kubeconfig."""
        try:
            return cls.in_cluster()
        except (RuntimeError, OSError):
            return cls.from_kubeconfig()


class ApiClient:
    def __init__(self, config: ClusterConfig):
        self.config = config
        self._ssl = self._build_ssl_context()
        self._watch_threads: dict[int, threading.Event] = {}

    def _build_ssl_context(self) -> ssl.SSLContext | None:
        if not self.config.host.startswith("https"):
            return None
        ctx = ssl.create_default_context(cafile=self.config.ca_file)
        if not self.config.verify:
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        if self.config.client_cert:
            ctx.load_cert_chain(self.config.client_cert,
                                self.config.client_key)
        return ctx

    def _request(self, method: str, path: str, body: dict | None = None,
                 timeout: float = 30.0) -> dict:
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(f"{self.config.host}{path}", data=data,
                                     method=method)
        req.add_header("Accept", "application/json")
        if data is not None:
            req.add_header("Content-Type", "application/json")
        if self.config.token:
            req.add_header("Authorization", f"Bearer {self.config.token}")
        # Each round trip, failed ones too, is charged to the caller's
        # open decision span; outside a decision the note is a no-op.
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=timeout,
                                        context=self._ssl) as resp:
                payload = resp.read()
                return json.loads(payload) if payload else {}
        except urllib.error.HTTPError as e:
            text = e.read().decode(errors="replace")
            if e.code == 404:
                raise NotFoundError(body=text) from None
            if e.code == 409:
                raise ConflictError(body=text) from None
            raise ApiError(e.code, reason=e.reason, body=text) from None
        except urllib.error.URLError as e:
            raise ApiError(0, reason=str(e.reason)) from None
        finally:
            trace.note_api_call(time.perf_counter() - t0,
                                method=method, path=path)

    # -- nodes --------------------------------------------------------- #

    def create_node(self, raw: dict) -> Node:
        return Node(self._request("POST", "/api/v1/nodes", body=raw))

    def get_node(self, name: str) -> Node | None:
        try:
            return Node(self._request("GET", f"/api/v1/nodes/{name}"))
        except NotFoundError:
            return None

    def list_nodes(self) -> list[Node]:
        doc = self._request("GET", "/api/v1/nodes")
        return [Node(item) for item in doc.get("items", [])]

    def update_node(self, node: Node) -> Node:
        """PUT the node object itself: annotations do not persist through
        the /status subresource."""
        return Node(self._request("PUT", f"/api/v1/nodes/{node.name}",
                                  body=node.raw))

    # -- pods ---------------------------------------------------------- #

    def create_pod(self, raw: dict) -> Pod:
        ns = raw.get("metadata", {}).get("namespace", "default")
        return Pod(self._request("POST", f"/api/v1/namespaces/{ns}/pods",
                                 body=raw))

    def get_pod(self, namespace: str, name: str) -> Pod:
        return Pod(self._request(
            "GET", f"/api/v1/namespaces/{namespace}/pods/{name}"))

    def list_pods(self, node_name: str | None = None) -> list[Pod]:
        """All pods, or one node's (filtered on the server), following
        the list's pagination."""
        base = "/api/v1/pods?limit=5000"
        if node_name:
            base += f"&fieldSelector=spec.nodeName%3D{node_name}"
        pods: list[Pod] = []
        cont = ""
        while True:
            doc = self._request(
                "GET", base + (f"&continue={quote(cont)}" if cont else ""))
            pods.extend(Pod(item) for item in doc.get("items", []))
            cont = doc.get("metadata", {}).get("continue", "")
            if not cont:
                return pods

    def update_pod(self, pod: Pod) -> Pod:
        return Pod(self._request(
            "PUT", f"/api/v1/namespaces/{pod.namespace}/pods/{pod.name}",
            body=pod.raw))

    def delete_pod(self, namespace: str, name: str) -> None:
        self._request("DELETE",
                      f"/api/v1/namespaces/{namespace}/pods/{name}")

    def bind_pod(self, binding: dict) -> None:
        """POST the ``v1.Binding`` to the pod's binding subresource."""
        meta = binding["metadata"]
        ns = meta.get("namespace", "default")
        self._request(
            "POST", f"/api/v1/namespaces/{ns}/pods/{meta['name']}/binding",
            body=binding)

    def evict_pod(self, namespace: str, name: str) -> None:
        """Deletion through the ``pods/eviction`` subresource, which
        honors PodDisruptionBudgets (429 while one has no disruption
        left)."""
        self._request(
            "POST", f"/api/v1/namespaces/{namespace}/pods/{name}/eviction",
            body={"apiVersion": "policy/v1", "kind": "Eviction",
                  "metadata": {"name": name, "namespace": namespace}})

    # -- budgets, ConfigMaps, Leases --------------------------------- #

    def list_pdbs(self) -> list[PodDisruptionBudget]:
        """Every PodDisruptionBudget (policy/v1): the preempt verb's
        violation count. Needs a ``poddisruptionbudgets`` list/watch
        RBAC rule."""
        doc = self._request("GET", "/apis/policy/v1/poddisruptionbudgets")
        return [PodDisruptionBudget(item) for item in doc.get("items", [])]

    def get_configmap(self, namespace: str, name: str) -> ConfigMap:
        return ConfigMap(self._request(
            "GET", f"/api/v1/namespaces/{namespace}/configmaps/{name}"))

    def list_configmaps(self) -> list[ConfigMap]:
        """The ConfigMaps named in ``_WATCHED_CONFIGMAPS``, one LIST a
        name filtered on the server. Needs a ``configmaps`` get/list/watch
        RBAC rule."""
        out: list[ConfigMap] = []
        for name in _WATCHED_CONFIGMAPS:
            doc = self._request("GET", _configmap_path(name))
            out.extend(ConfigMap(item) for item in doc.get("items", []))
        return out

    def get_lease(self, namespace: str, name: str) -> dict | None:
        try:
            return self._request(
                "GET", f"/apis/coordination.k8s.io/v1/namespaces/"
                       f"{namespace}/leases/{name}")
        except NotFoundError:
            return None

    def create_lease(self, namespace: str, raw: dict) -> dict:
        return self._request(
            "POST",
            f"/apis/coordination.k8s.io/v1/namespaces/{namespace}/leases",
            body=raw)

    def update_lease(self, namespace: str, name: str, raw: dict) -> dict:
        """PUT with the read resourceVersion: a stale one gets a 409."""
        return self._request(
            "PUT", f"/apis/coordination.k8s.io/v1/namespaces/"
                   f"{namespace}/leases/{name}",
            body=raw)

    # -- events -------------------------------------------------------- #

    def create_event(self, namespace: str, event: dict) -> None:
        try:
            self._request("POST", f"/api/v1/namespaces/{namespace}/events",
                          body=event)
        except ApiError as e:  # events are best-effort
            log.debug("event create failed: %s", e)

    # -- watch: the queue interface of FakeApiServer.watch ------------- #

    def watch(self) -> queue.Queue:
        """One LIST + WATCH stream a kind (pods, nodes, budgets) and one a
        watched ConfigMap name, into one queue of ``(kind, event_type,
        raw)``. A ConfigMap stream's RELIST names its scope, so the
        informer diffs only that name's documents."""
        q: queue.Queue = queue.Queue()
        stop = threading.Event()
        streams = [("Pod", "/api/v1/pods", ""),
                   ("Node", "/api/v1/nodes", ""),
                   ("PodDisruptionBudget",
                    "/apis/policy/v1/poddisruptionbudgets", "")]
        streams += [("ConfigMap", _configmap_path(name), name)
                    for name in _WATCHED_CONFIGMAPS]
        for i, (kind, path, scope) in enumerate(streams):
            threading.Thread(target=self._watch_loop,
                             args=(kind, path, q, stop, scope),
                             name=f"tpushare-watch-{kind.lower()}-{i}",
                             daemon=True).start()
        self._watch_threads[id(q)] = stop
        return q

    def stop_watch(self, q: queue.Queue) -> None:
        stop = self._watch_threads.pop(id(q), None)
        if stop is not None:
            stop.set()

    def _watch_loop(self, kind: str, path: str, q: queue.Queue,
                    stop: threading.Event, scope: str = "") -> None:
        """LIST, hand the items on as one RELIST (the informer diffs it
        against its store, so what changed while the watch was down is
        not lost), then WATCH from the list's resourceVersion until the
        stream ends or errs (410 Gone comes as an ERROR event), and LIST
        again."""
        while not stop.is_set():
            try:
                listing = self._request("GET", path)
                rv = listing.get("metadata", {}).get("resourceVersion", "")
                items = listing.get("items", []) or []
                q.put((kind, "RELIST",
                       {"scope": scope, "items": items} if scope
                       else items))
                sep = "&" if "?" in path else "?"
                url = (f"{self.config.host}{path}{sep}watch=true"
                       f"&resourceVersion={rv}&timeoutSeconds=300"
                       "&allowWatchBookmarks=true")
                req = urllib.request.Request(url)
                if self.config.token:
                    req.add_header("Authorization",
                                   f"Bearer {self.config.token}")
                with urllib.request.urlopen(req, timeout=330,
                                            context=self._ssl) as resp:
                    for line in resp:
                        if stop.is_set():
                            return
                        if not line.strip():
                            continue
                        evt = json.loads(line)
                        etype = evt.get("type", "")
                        if etype in ("ADDED", "MODIFIED", "DELETED"):
                            q.put((kind, etype, evt.get("object", {})))
                        elif etype == "ERROR":
                            break  # LIST again, at a fresh resourceVersion
            except (ApiError, OSError, json.JSONDecodeError) as e:
                if stop.is_set():
                    return
                status = (e.status if isinstance(e, ApiError)
                          else getattr(e, "code", None))
                if status in (403, 404):
                    # Denied or absent: that does not heal in a second.
                    log.warning("watch %s unavailable (%s); retrying in "
                                "60s", kind, e)
                    stop.wait(60.0)
                    continue
                log.warning("watch %s dropped (%s); re-listing", kind, e)
                stop.wait(1.0)
