"""In-memory apiserver with the calls the node daemon and the extender
make.

The port's copy of the part of ``tpushare/k8s/fake.py`` that the device
plugin, the grant watchdog and the scheduler extender reach: nodes, pods
(optimistic-concurrency updates: a stale ``resourceVersion`` gets a real
409), the ``pods/binding`` and ``pods/eviction`` subresources (the
latter with PodDisruptionBudget semantics), PodDisruptionBudgets,
ConfigMaps, Leases (optimistic concurrency too: leader election's safety
rests on it), Events, and watch streams of pods, nodes, budgets and
ConfigMaps. The client (:mod:`tpushare_torch.k8s.client`) has the
same calls over the apiserver's REST API, so either runs under both.
"""

from __future__ import annotations

import datetime
import itertools
import queue
import threading

from tpushare_torch.api.objects import (ConfigMap, Node, Pod,
                                        PodDisruptionBudget)
from tpushare_torch.k8s.errors import ApiError, ConflictError, NotFoundError


def _dcopy(obj):
    """Deep copy of a JSON document (dicts, lists and scalars)."""
    if type(obj) is dict:
        return {k: _dcopy(v) for k, v in obj.items()}
    if type(obj) is list:
        return [_dcopy(v) for v in obj]
    return obj


def _pdb_blocks(pdb: dict, pod: Pod) -> bool:
    """A PodDisruptionBudget with no disruption left whose selector
    (``matchLabels``, and ``matchExpressions`` with In, NotIn, Exists,
    DoesNotExist) picks ``pod``, which is not already being disrupted. An
    empty selector picks nothing."""
    meta, spec = pdb.get("metadata") or {}, pdb.get("spec") or {}
    status = pdb.get("status") or {}
    if meta.get("namespace", "default") != pod.namespace:
        return False
    try:
        allowed = int(status.get("disruptionsAllowed", 0))
    except (TypeError, ValueError):
        allowed = 0
    if allowed > 0 or pod.name in (status.get("disruptedPods") or {}):
        return False
    selector = spec.get("selector") or {}
    match, exprs = (selector.get("matchLabels") or {},
                    selector.get("matchExpressions") or [])
    if not match and not exprs:
        return False
    labels = pod.labels
    if any(labels.get(k) != v for k, v in match.items()):
        return False
    for expr in exprs:
        key, op = expr.get("key", ""), expr.get("operator", "")
        values = expr.get("values") or []
        ok = {"In": lambda: labels.get(key) in values,
              "NotIn": lambda: labels.get(key) not in values,
              "Exists": lambda: key in labels,
              "DoesNotExist": lambda: key not in labels}.get(op)
        if ok is None or not ok():
            return False
    return True


class FakeApiServer:
    """Thread-safe in-memory store of nodes, pods, PodDisruptionBudgets,
    ConfigMaps, Leases and Events, with watch fan-out."""

    def __init__(self):
        self._lock = threading.RLock()
        self._pods: dict[str, dict] = {}    # "ns/name" -> raw pod
        self._nodes: dict[str, dict] = {}   # name -> raw node
        self._pdbs: dict[str, dict] = {}    # "ns/name" -> raw pdb
        self._configmaps: dict[str, dict] = {}  # "ns/name" -> raw cm
        self._leases: dict[str, dict] = {}  # "ns/name" -> raw lease
        self._rv = itertools.count(1)
        self._uid = itertools.count(1)
        self.events: list[tuple[str, dict]] = []  # (namespace, event)
        self._watchers: list[queue.Queue] = []

    def _bump(self, obj: dict) -> None:
        obj.setdefault("metadata", {})["resourceVersion"] = str(next(self._rv))

    # -- watch --------------------------------------------------------- #

    def _notify(self, kind: str, event_type: str, obj: dict) -> None:
        for q in list(self._watchers):
            q.put((kind, event_type, _dcopy(obj)))

    def watch(self) -> queue.Queue:
        """Subscribe to ``(kind, event_type, raw)`` tuples: kind "Pod",
        "Node", "PodDisruptionBudget" or "ConfigMap", event_type "ADDED",
        "MODIFIED" or "DELETED"."""
        q: queue.Queue = queue.Queue()
        with self._lock:
            self._watchers.append(q)
        return q

    def stop_watch(self, q: queue.Queue) -> None:
        with self._lock:
            if q in self._watchers:
                self._watchers.remove(q)

    # -- nodes --------------------------------------------------------- #

    def create_node(self, raw: dict) -> Node:
        with self._lock:
            node = _dcopy(raw)
            self._bump(node)
            self._nodes[node["metadata"]["name"]] = node
            self._notify("Node", "ADDED", node)
            return Node(_dcopy(node))

    def get_node(self, name: str) -> Node | None:
        with self._lock:
            raw = self._nodes.get(name)
            return Node(_dcopy(raw)) if raw else None

    def list_nodes(self) -> list[Node]:
        with self._lock:
            return [Node(_dcopy(n)) for n in self._nodes.values()]

    def update_node(self, node: Node) -> Node:
        with self._lock:
            if node.name not in self._nodes:
                raise NotFoundError(reason=f"node {node.name} not found")
            updated = _dcopy(node.raw)
            self._bump(updated)
            self._nodes[node.name] = updated
            self._notify("Node", "MODIFIED", updated)
            return Node(_dcopy(updated))

    def delete_node(self, name: str) -> None:
        with self._lock:
            node = self._nodes.pop(name, None)
            if node is not None:
                self._notify("Node", "DELETED", node)

    # -- pods ---------------------------------------------------------- #

    def create_pod(self, raw: dict) -> Pod:
        with self._lock:
            pod = _dcopy(raw)
            meta = pod.setdefault("metadata", {})
            meta.setdefault("namespace", "default")
            meta.setdefault("uid", f"uid-{next(self._uid)}")
            meta.setdefault(
                "creationTimestamp",
                datetime.datetime.now(datetime.timezone.utc).strftime(
                    "%Y-%m-%dT%H:%M:%SZ"))
            key = f"{meta['namespace']}/{meta['name']}"
            if key in self._pods:
                raise ConflictError(reason=f"pod {key} already exists")
            self._bump(pod)
            self._pods[key] = pod
            self._notify("Pod", "ADDED", pod)
            return Pod(_dcopy(pod))

    def get_pod(self, namespace: str, name: str) -> Pod:
        with self._lock:
            key = f"{namespace}/{name}"
            if key not in self._pods:
                raise NotFoundError(reason=f"pod {key} not found")
            return Pod(_dcopy(self._pods[key]))

    def list_pods(self, node_name: str | None = None) -> list[Pod]:
        with self._lock:
            pods = [Pod(_dcopy(p)) for p in self._pods.values()]
        if node_name:
            pods = [p for p in pods if p.node_name == node_name]
        return pods

    def update_pod(self, pod: Pod) -> Pod:
        """A stale resourceVersion gets a 409, as from the apiserver."""
        with self._lock:
            key = pod.key()
            current = self._pods.get(key)
            if current is None:
                raise NotFoundError(reason=f"pod {key} not found")
            cur_rv = current["metadata"].get("resourceVersion")
            if pod.resource_version and pod.resource_version != cur_rv:
                raise ConflictError(
                    reason="the object has been modified; please apply your "
                           "changes to the latest version and try again")
            updated = _dcopy(pod.raw)
            updated["metadata"]["uid"] = current["metadata"]["uid"]
            self._bump(updated)
            self._pods[key] = updated
            self._notify("Pod", "MODIFIED", updated)
            return Pod(_dcopy(updated))

    def update_pod_status(self, namespace: str, name: str, phase: str) -> Pod:
        with self._lock:
            pod = self._pods.get(f"{namespace}/{name}")
            if pod is None:
                raise NotFoundError(reason=f"pod {namespace}/{name} not found")
            pod.setdefault("status", {})["phase"] = phase
            self._bump(pod)
            self._notify("Pod", "MODIFIED", pod)
            return Pod(_dcopy(pod))

    def delete_pod(self, namespace: str, name: str) -> None:
        with self._lock:
            key = f"{namespace}/{name}"
            pod = self._pods.pop(key, None)
            if pod is None:
                raise NotFoundError(reason=f"pod {key} not found")
            self._notify("Pod", "DELETED", pod)

    def bind_pod(self, binding: dict) -> None:
        """``POST pods/{name}/binding``: sets ``spec.nodeName``; a bound
        pod gets a 409."""
        with self._lock:
            meta = binding.get("metadata", {})
            key = f"{meta.get('namespace', 'default')}/{meta.get('name')}"
            pod = self._pods.get(key)
            if pod is None:
                raise NotFoundError(reason=f"pod {key} not found")
            if pod.get("spec", {}).get("nodeName"):
                raise ConflictError(reason=f"pod {key} is already bound")
            pod.setdefault("spec", {})["nodeName"] = binding["target"]["name"]
            self._bump(pod)
            self._notify("Pod", "MODIFIED", pod)

    def evict_pod(self, namespace: str, name: str) -> None:
        """``POST pods/{name}/eviction``: refused with 429 while a
        matching PodDisruptionBudget has no disruption left."""
        with self._lock:
            key = f"{namespace}/{name}"
            raw = self._pods.get(key)
            if raw is None:
                raise NotFoundError(reason=f"pod {key} not found")
            pod = Pod(_dcopy(raw))
            for pdb_key, pdb in self._pdbs.items():
                if _pdb_blocks(pdb, pod):
                    raise ApiError(
                        429, reason="TooManyRequests",
                        body=f"Cannot evict pod as it would violate the "
                             f"pod's disruption budget {pdb_key}")
            del self._pods[key]
            self._notify("Pod", "DELETED", raw)

    # -- PodDisruptionBudgets (policy/v1) ------------------------------ #

    def create_pdb(self, raw: dict) -> dict:
        """Returns the stored document (the daemon's callers edit it and
        hand it back to :meth:`update_pdb`)."""
        with self._lock:
            pdb = _dcopy(raw)
            meta = pdb.setdefault("metadata", {})
            meta.setdefault("namespace", "default")
            meta.setdefault("uid", f"uid-{next(self._uid)}")
            key = f"{meta['namespace']}/{meta['name']}"
            if key in self._pdbs:
                raise ConflictError(reason=f"pdb {key} already exists")
            self._bump(pdb)
            self._pdbs[key] = pdb
            self._notify("PodDisruptionBudget", "ADDED", pdb)
            return _dcopy(pdb)

    def update_pdb(self, raw: dict) -> dict:
        with self._lock:
            meta = raw.get("metadata") or {}
            key = f"{meta.get('namespace', 'default')}/{meta.get('name')}"
            if key not in self._pdbs:
                raise NotFoundError(reason=f"pdb {key} not found")
            updated = _dcopy(raw)
            self._bump(updated)
            self._pdbs[key] = updated
            self._notify("PodDisruptionBudget", "MODIFIED", updated)
            return _dcopy(updated)

    def delete_pdb(self, namespace: str, name: str) -> None:
        with self._lock:
            pdb = self._pdbs.pop(f"{namespace}/{name}", None)
            if pdb is not None:
                self._notify("PodDisruptionBudget", "DELETED", pdb)

    def list_pdbs(self) -> list[PodDisruptionBudget]:
        with self._lock:
            return [PodDisruptionBudget(_dcopy(p))
                    for p in self._pdbs.values()]

    # -- ConfigMaps (the quota table travels in one) -------------------- #

    def create_configmap(self, raw: dict) -> ConfigMap:
        with self._lock:
            cm = _dcopy(raw)
            meta = cm.setdefault("metadata", {})
            meta.setdefault("namespace", "default")
            key = f"{meta['namespace']}/{meta['name']}"
            if key in self._configmaps:
                raise ConflictError(reason=f"configmap {key} already exists")
            self._bump(cm)
            self._configmaps[key] = cm
            self._notify("ConfigMap", "ADDED", cm)
            return ConfigMap(_dcopy(cm))

    def get_configmap(self, namespace: str, name: str) -> ConfigMap:
        with self._lock:
            key = f"{namespace}/{name}"
            if key not in self._configmaps:
                raise NotFoundError(reason=f"configmap {key} not found")
            return ConfigMap(_dcopy(self._configmaps[key]))

    def update_configmap(self, cm: ConfigMap) -> ConfigMap:
        with self._lock:
            key = f"{cm.namespace}/{cm.name}"
            if key not in self._configmaps:
                raise NotFoundError(reason=f"configmap {key} not found")
            updated = _dcopy(cm.raw)
            self._bump(updated)
            self._configmaps[key] = updated
            self._notify("ConfigMap", "MODIFIED", updated)
            return ConfigMap(_dcopy(updated))

    def delete_configmap(self, namespace: str, name: str) -> None:
        with self._lock:
            cm = self._configmaps.pop(f"{namespace}/{name}", None)
            if cm is not None:
                self._notify("ConfigMap", "DELETED", cm)

    def list_configmaps(self) -> list[ConfigMap]:
        with self._lock:
            return [ConfigMap(_dcopy(c)) for c in self._configmaps.values()]

    # -- Leases (coordination.k8s.io), raw documents -------------------- #

    def get_lease(self, namespace: str, name: str) -> dict | None:
        with self._lock:
            raw = self._leases.get(f"{namespace}/{name}")
            return _dcopy(raw) if raw else None

    def create_lease(self, namespace: str, raw: dict) -> dict:
        with self._lock:
            lease = _dcopy(raw)
            meta = lease.setdefault("metadata", {})
            meta.setdefault("namespace", namespace)
            key = f"{namespace}/{meta['name']}"
            if key in self._leases:
                raise ConflictError(reason=f"lease {key} already exists")
            self._bump(lease)
            self._leases[key] = lease
            return _dcopy(lease)

    def update_lease(self, namespace: str, name: str, raw: dict) -> dict:
        """A stale resourceVersion gets a 409: of two candidates racing
        for an expired lease, one wins."""
        with self._lock:
            key = f"{namespace}/{name}"
            current = self._leases.get(key)
            if current is None:
                raise NotFoundError(reason=f"lease {key} not found")
            cur_rv = current["metadata"].get("resourceVersion")
            new_rv = raw.get("metadata", {}).get("resourceVersion")
            if new_rv and new_rv != cur_rv:
                raise ConflictError(
                    reason="the object has been modified; please apply "
                           "your changes to the latest version and try "
                           "again")
            updated = _dcopy(raw)
            self._bump(updated)
            self._leases[key] = updated
            return _dcopy(updated)

    # -- events -------------------------------------------------------- #

    def create_event(self, namespace: str, event: dict) -> None:
        with self._lock:
            self.events.append((namespace, _dcopy(event)))
