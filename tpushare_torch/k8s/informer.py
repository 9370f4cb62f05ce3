"""Informer: LIST + WATCH into a local store, with event handlers.

The port's copy of ``tpushare/k8s/informer.py`` for pods, nodes,
PodDisruptionBudgets (the preempt verb's violation count) and ConfigMaps
(the quota table): one daemon thread consumes the watch stream of a
:class:`tpushare_torch.k8s.fake.FakeApiServer` or an
:class:`tpushare_torch.k8s.client.ApiClient`, keeps a thread-safe store a
kind (the "lister") and calls the registered add, update and delete
handlers.
"""

from __future__ import annotations

import logging
import threading

from tpushare_torch.api.objects import (ConfigMap, Node, Pod,
                                        PodDisruptionBudget)
from tpushare_torch.utils import locks

log = logging.getLogger(__name__)

_WRAPPERS = {"Pod": Pod, "Node": Node,
             "PodDisruptionBudget": PodDisruptionBudget,
             "ConfigMap": ConfigMap}


class Store:
    """Thread-safe keyed object store (the lister)."""

    def __init__(self, site: str = "informer/store"):
        self._lock = locks.TracingRLock(site)
        self._items: dict[str, object] = {}

    @staticmethod
    def key_of(obj) -> str:
        if isinstance(obj, (Pod, PodDisruptionBudget, ConfigMap)):
            return f"{obj.namespace}/{obj.name}"
        return obj.name

    def replace(self, objs) -> None:
        with self._lock:
            self._items = {self.key_of(o): o for o in objs}

    def upsert(self, obj) -> None:
        with self._lock:
            self._items[self.key_of(obj)] = obj

    def delete(self, obj) -> None:
        """Remove ``obj``'s slot, unless the slot now holds another
        instance (another uid): a pod deleted and recreated under its name
        must not lose its successor to the old one's DELETED event."""
        with self._lock:
            key = self.key_of(obj)
            current = self._items.get(key)
            if current is None:
                return
            cur_uid = getattr(current, "uid", "")
            obj_uid = getattr(obj, "uid", "")
            if cur_uid and obj_uid and cur_uid != obj_uid:
                return
            self._items.pop(key, None)

    def get(self, key: str):
        with self._lock:
            return self._items.get(key)

    def list(self) -> list:
        with self._lock:
            return list(self._items.values())


class InformerHub:
    """One watch stream fanned out to the informers of each kind.

    ``start()`` makes the initial LIST (so ``wait_for_sync`` means what
    client-go's ``WaitForCacheSync`` does) and then consumes watch events
    on a daemon thread.
    """

    def __init__(self, client):
        self.client = client
        self.pods = Store("informer/pods")
        self.nodes = Store("informer/nodes")
        self.pdbs = Store("informer/pdbs")
        self.configmaps = Store("informer/configmaps")
        self._handlers: dict[str, list] = {"Pod": [], "Node": [],
                                           "PodDisruptionBudget": [],
                                           "ConfigMap": []}
        self._synced = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._watch_queue = None

    # -- registration --------------------------------------------------- #

    def add_pod_handler(self, on_add=None, on_update=None, on_delete=None,
                        filter_fn=None) -> None:
        self._handlers["Pod"].append((on_add, on_update, on_delete,
                                      filter_fn))

    def add_node_handler(self, on_add=None, on_update=None, on_delete=None,
                         filter_fn=None) -> None:
        self._handlers["Node"].append((on_add, on_update, on_delete,
                                       filter_fn))

    def add_configmap_handler(self, on_add=None, on_update=None,
                              on_delete=None, filter_fn=None) -> None:
        self._handlers["ConfigMap"].append((on_add, on_update, on_delete,
                                            filter_fn))

    # -- lifecycle ------------------------------------------------------ #

    def start(self) -> None:
        self._watch_queue = self.client.watch()
        self.pods.replace(self.client.list_pods())
        self.nodes.replace(self.client.list_nodes())
        # Budgets and ConfigMaps are optional on a client (and RBAC may
        # deny them): without them the listers are empty.
        for store, name in ((self.pdbs, "list_pdbs"),
                            (self.configmaps, "list_configmaps")):
            lister = getattr(self.client, name, None)
            if lister is None:
                continue
            try:
                store.replace(lister())
            except Exception:  # noqa: BLE001 - the watch recovers it
                log.warning("%s failed; its store stays empty until the "
                            "watch recovers", name, exc_info=True)
        self._synced.set()
        self._thread = threading.Thread(
            target=self._run, name="tpushare-informer", daemon=True)
        self._thread.start()

    def wait_for_sync(self, timeout: float = 30.0) -> bool:
        return self._synced.wait(timeout)

    def stop(self) -> None:
        self._stop.set()
        if self._watch_queue is not None:
            self.client.stop_watch(self._watch_queue)
            self._watch_queue.put(None)  # unblock the consumer

    # -- event loop ----------------------------------------------------- #

    def _run(self) -> None:
        while not self._stop.is_set():
            item = self._watch_queue.get()
            if item is None:
                self._watch_queue.task_done()  # shutdown sentinel
                break
            try:
                kind, event_type, raw = item
                wrapper = _WRAPPERS.get(kind)
                if wrapper is None:
                    continue
                store = {"Pod": self.pods, "Node": self.nodes,
                         "PodDisruptionBudget": self.pdbs,
                         "ConfigMap": self.configmaps}[kind]
                if event_type == "RELIST":
                    # The watch reconnected: diff the fresh LIST against
                    # the store and make up the events of the gap. A
                    # stream of one ConfigMap name diffs only documents
                    # of that name.
                    scope = ""
                    if isinstance(raw, dict):
                        scope = raw.get("scope") or ""
                        raw = raw.get("items", [])
                    self._handle_relist(kind, store,
                                        [wrapper(r) for r in raw],
                                        scope=scope)
                    continue
                obj = wrapper(raw)
                old = store.get(Store.key_of(obj))
                if event_type == "DELETED":
                    store.delete(obj)
                else:
                    store.upsert(obj)
                self._dispatch(kind, event_type, old, obj)
            finally:
                # After the dispatch: quiesced() means every delivered
                # event's handlers have run, not merely an empty pipe.
                self._watch_queue.task_done()

    def quiesced(self) -> bool:
        """True when every watch event delivered so far was dispatched."""
        q = self._watch_queue
        return q is None or q.unfinished_tasks == 0

    def _handle_relist(self, kind: str, store: Store, objs: list,
                       scope: str = "") -> None:
        # Imported here: the device plugin's informer needs no metrics
        # at import time.
        from tpushare_torch.routes import metrics
        metrics.safe_inc(metrics.INFORMER_RELISTS)
        fresh = {Store.key_of(o): o for o in objs}
        stale = [o for o in store.list() if Store.key_of(o) not in fresh
                 and (not scope or o.name == scope)]
        for obj in objs:
            old = store.get(Store.key_of(obj))
            store.upsert(obj)
            self._dispatch(kind, "ADDED" if old is None else "MODIFIED",
                           old, obj)
        for obj in stale:
            store.delete(obj)
            self._dispatch(kind, "DELETED", None, obj)

    def _dispatch(self, kind: str, event_type: str, old, obj) -> None:
        for on_add, on_update, on_delete, filter_fn in self._handlers[kind]:
            try:
                relevant = filter_fn is None or filter_fn(obj) or (
                    old is not None and filter_fn(old))
                if not relevant:
                    continue
                if event_type == "ADDED" and on_add:
                    on_add(obj)
                elif event_type == "MODIFIED" and on_update:
                    on_update(old, obj)
                elif event_type == "DELETED" and on_delete:
                    on_delete(obj)
            except Exception:  # pragma: no cover - handler bugs
                log.exception("informer handler failed for %s %s",
                              event_type, Store.key_of(obj))

    # -- lister convenience --------------------------------------------- #

    def get_pod(self, namespace: str, name: str) -> Pod | None:
        return self.pods.get(f"{namespace}/{name}")

    def get_node(self, name: str) -> Node | None:
        return self.nodes.get(name)
