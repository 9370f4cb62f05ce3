"""The cluster-wide ledger: node name -> NodeInfo, and the known pods.

The port's copy of ``tpushare/cache/cache.py`` (gpushare's
``pkg/cache/cache.go``, SchedulerCache). All durable truth lives in pod
annotations in the apiserver; :meth:`SchedulerCache.build` rebuilds the
ledger from them, which makes the extender restartable with no database.
Every read of the node table holds the lock, and a cached NodeInfo is
rebuilt when the node's card capacities change. A tenant quota ledger,
when given, is charged and uncharged on the same path as the card
ledger, the rebuild included, so tenant usage survives a restart too.
"""

from __future__ import annotations

import logging
from typing import Callable

from tpushare_torch.api.objects import Node, Pod
from tpushare_torch.cache.nodeinfo import NodeInfo
from tpushare_torch.quota.manager import QuotaManager
from tpushare_torch.utils import const
from tpushare_torch.utils import node as nodeutils
from tpushare_torch.utils import pod as podutils
from tpushare_torch.utils import locks

log = logging.getLogger(__name__)


class SchedulerCache:
    def __init__(self, node_getter: Callable[[str], Node | None],
                 pod_lister: Callable[[], list[Pod]],
                 default_scoring: str | None = None,
                 quota: QuotaManager | None = None) -> None:
        """``node_getter(name) -> Node | None`` and
        ``pod_lister() -> list[Pod]`` are the informer's listers, or a
        fake client's bound methods. ``default_scoring`` is the fleet
        scoring policy handed to every ledger's chip picker, the value
        the prioritize verb uses too. ``quota`` (a
        :class:`tpushare_torch.quota.manager.QuotaManager`) is charged
        what the card ledger prices."""
        self._node_getter = node_getter
        self._pod_lister = pod_lister
        self._default_scoring = default_scoring
        #: The tenant ledger mirroring this cache's known pods, or None.
        self.quota = quota
        self._lock = locks.TracingRLock("cache/table")
        self._nodes: dict[str, NodeInfo] = locks.guarded_dict(
            self._lock, "SchedulerCache._nodes")
        #: uid -> annotated pod
        self._known_pods: dict[str, Pod] = locks.guarded_dict(
            self._lock, "SchedulerCache._known_pods")
        #: name -> deletion epoch; bumped on every eviction so a lookup
        #: that fetched the node doc before the delete cannot re-insert
        #: a zombie ledger afterwards.
        self._node_epochs: dict[str, int] = locks.guarded_dict(
            self._lock, "SchedulerCache._node_epochs")
        #: uid -> PENDING pod with ``status.nominatedNodeName`` set (the
        #: scheduler preempted for it; its victims' capacity is earmarked
        #: until it binds). The predicate and the preempt planner subtract
        #: this demand so another pod cannot steal a preemptor's chips in
        #: the eviction→bind window — without it, gang members' per-member
        #: preemptions re-consume each other's freed capacity and the
        #: gang never commits.
        self._nominated: dict[str, Pod] = locks.guarded_dict(
            self._lock, "SchedulerCache._nominated")

    # ------------------------------------------------------------------ #
    # Known-pod set (reference cache.go:76-87)
    # ------------------------------------------------------------------ #

    def known_pod(self, uid: str) -> bool:
        with self._lock:
            return uid in self._known_pods

    def get_pod(self, uid: str) -> Pod | None:
        with self._lock:
            return self._known_pods.get(uid)

    # ------------------------------------------------------------------ #
    # Nominated pods (upstream: scheduler's nominatedNodeName handling)
    # ------------------------------------------------------------------ #

    def note_nominated(self, pod: Pod) -> None:
        """Track (or stop tracking) a pod's preemption nomination. A pod
        is nominated demand only while PENDING and UNLEDGERED: once its
        grant is priced (bound, or reserved by the gang planner) the
        ledger accounts for it, and an earmark on top would double-hold
        its capacity; a completed/unnominated pod earmarks nothing."""
        with self._lock:
            if (pod.nominated_node_name and not pod.node_name
                    and not podutils.is_complete_pod(pod)
                    and pod.uid not in self._known_pods):
                self._nominated[pod.uid] = pod
            else:
                self._nominated.pop(pod.uid, None)

    def clear_nominated(self, uid: str) -> None:
        with self._lock:
            self._nominated.pop(uid, None)

    def nominated_on(self, node_name: str) -> list[Pod]:
        """Pending pods whose preemption victory earmarked capacity on
        ``node_name``."""
        with self._lock:
            return [p for p in self._nominated.values()
                    if p.nominated_node_name == node_name]

    def nominated_node_names(self) -> set[str]:
        """Nodes with ANY earmarked preemption demand — the filter fast
        path's trigger set for falling back to the full per-node assume
        (O(nominated), which is almost always zero)."""
        with self._lock:
            if not self._nominated:
                return set()
            return {p.nominated_node_name
                    for p in self._nominated.values()}

    # ------------------------------------------------------------------ #
    # Node table (reference cache.go:36-46, 130-162)
    # ------------------------------------------------------------------ #

    def get_node_info(self, name: str) -> NodeInfo | None:
        """Fetch-or-build the ledger for ``name``.

        Rebuilds (and repopulates from known pods) when the apiserver's
        view of the node's chips no longer matches the cached ledger —
        covering the reference's non-sharing→sharing upgrade and the
        capacity-change case it missed.
        """
        with self._lock:
            epoch = self._node_epochs.get(name, 0)
        try:
            node = self._node_getter(name)
        except Exception:
            # Transient apiserver trouble is NOT deletion: serve the
            # cached ledger rather than destroying live reservations.
            log.warning("node getter errored for %s; serving cached view",
                        name, exc_info=True)
            with self._lock:
                return self._nodes.get(name)
        if node is None:
            # Apiserver no longer knows the node: evict the stale ledger
            # so a deleted node's chips stop haunting inspect/metrics
            # (the reference kept serving the cached NodeInfo forever —
            # same cache/apiserver-divergence family as cache.go:130-162).
            # Epoch-guarded: if the node flapped and another thread
            # already rebuilt a fresh ledger, do not destroy it.
            with self._lock:
                if self._node_epochs.get(name, 0) != epoch:
                    return self._nodes.get(name)
            self.remove_node(name)
            return None
        with self._lock:
            if self._node_epochs.get(name, 0) != epoch:
                # The node was deleted while we held its (pre-delete) doc;
                # do not resurrect the ledger. Caller retries and sees the
                # apiserver's current truth.
                return self._nodes.get(name)
            info = self._nodes.get(name)
            if (info is not None and node.resource_version
                    and info.node.resource_version == node.resource_version):
                # Node document unchanged since we built the ledger: skip
                # the annotation re-parse on the filter hot path.
                return info
            fresh_caps = nodeutils.get_chip_capacities(node)
            if info is None or [c.total_hbm for c in
                                (info.chips[i] for i in sorted(info.chips))] != fresh_caps:
                if info is not None:
                    log.info("rebuilding ledger for node %s (chip set changed)", name)
                info = NodeInfo(node, self._default_scoring)
                for pod in self._known_pods.values():
                    if pod.node_name == name and not podutils.is_complete_pod(pod):
                        info.add_or_update_pod(pod)
                self._nodes[name] = info
                return info
        # Same chip set: fold the fresh document in OUTSIDE the table
        # lock — apply_node_document takes the node lock, and keeping
        # the two un-nested keeps the acquisition graph a DAG.
        info.apply_node_document(node)
        return info

    def peek_node_info(self, name: str) -> NodeInfo | None:
        """The cached ledger without :meth:`get_node_info`'s check of the
        node document: for advisory reads (the gang quorum pre-check,
        steering) where a slightly stale ledger is fine."""
        with self._lock:
            return self._nodes.get(name)

    def gang_members(self, namespace: str, group: str) -> list[Pod]:
        """Every known (assumed or bound) pod of gang ``namespace/group``,
        across the fleet."""
        if not group:
            return []
        with self._lock:
            return [p for p in self._known_pods.values()
                    if p.namespace == namespace
                    and p.annotations.get(const.ANN_POD_GROUP) == group]

    def get_node_infos(self) -> list[NodeInfo]:
        with self._lock:
            return list(self._nodes.values())

    def node_table(self) -> dict[str, NodeInfo]:
        """One-lock snapshot of the whole ledger table, for the verb
        fast paths: at 1024 candidates, per-name ``get_node_info`` calls
        (each re-validating the node document against the informer) cost
        more than the verb's real work. The copy is a C-level dict copy;
        freshness is push-maintained — the controller's node watch
        handlers call :meth:`refresh_node`/:meth:`remove_node`, and a
        name missing here (first sight) falls back to
        :meth:`get_node_info`. Callers must treat values as read-only
        ledgers."""
        with self._lock:
            return dict(self._nodes)

    def refresh_node(self, node: Node) -> None:
        """Push path for the informer's node add/update events: bring
        the cached ledger (and its admission summary) in line with the
        freshest node document — the watch-driven twin of the pull
        re-validation inside :meth:`get_node_info`, applied from the
        document the watch ALREADY delivered (no apiserver round-trip
        on the informer dispatch thread — at 1k nodes, kubelet status
        updates arrive continuously and a blocking GET per event
        serializes pod handling behind network RTTs). Unknown nodes are
        left to first-use construction (the fast paths' miss
        fallback)."""
        with self._lock:
            info = self._nodes.get(node.name)
            if info is None:
                return
            if (node.resource_version
                    and info.node.resource_version == node.resource_version):
                return
            fresh_caps = nodeutils.get_chip_capacities(node)
            if [c.total_hbm for c in
                    (info.chips[i] for i in sorted(info.chips))] != fresh_caps:
                log.info("rebuilding ledger for node %s (chip set changed)",
                         node.name)
                info = NodeInfo(node, self._default_scoring)
                for pod in self._known_pods.values():
                    if (pod.node_name == node.name
                            and not podutils.is_complete_pod(pod)):
                        info.add_or_update_pod(pod)
                self._nodes[node.name] = info
                return
        # Outside the table lock, as in get_node_info's twin branch.
        info.apply_node_document(node)

    def sharing_node_infos(self) -> list[NodeInfo]:
        """Ledgers of the nodes that advertise shareable memory: the
        defrag planner's what-if universe (another node can neither
        strand capacity nor take a moved pod)."""
        with self._lock:
            infos = list(self._nodes.values())
        return [i for i in infos if nodeutils.is_tpu_sharing_node(i.node)]

    def remove_node(self, name: str) -> bool:
        """Drop a deleted node's ledger (no reference counterpart — the
        reference's cache only ever grew, SURVEY.md §2 defect family).

        Known pods that were placed on the node stay in ``_known_pods``:
        their annotations in the apiserver are still the durable truth,
        the pod-lifecycle path removes them when the node controller
        deletes them, and if the node re-registers ``get_node_info``
        rebuilds its ledger from exactly those pods.
        """
        with self._lock:
            removed = self._nodes.pop(name, None)
            self._node_epochs[name] = self._node_epochs.get(name, 0) + 1
        if removed is not None:
            log.info("node %s deleted; dropped its ledger (%d chips)",
                     name, removed.chip_count)
        return removed is not None

    # ------------------------------------------------------------------ #
    # Pod lifecycle (reference cache.go:89-127)
    # ------------------------------------------------------------------ #

    def add_or_update_pod(self, pod: Pod) -> bool:
        """Record an assumed pod in the ledger of its node."""
        if not pod.node_name:
            return False
        if not podutils.is_assumed(pod):
            return False
        with self._lock:
            known = self._known_pods.get(pod.uid)
        if (known is not None and pod.resource_version
                and known.resource_version == pod.resource_version):
            # The bind path stores its annotated pod inline; the informer
            # then echoes the SAME write back through the sync controller.
            # Identical resourceVersion == identical document — re-pricing
            # it would only burn the ledger locks on the filter hot path.
            return True
        info = self.get_node_info(pod.node_name)
        if info is None:
            log.warning("pod %s references unknown node %s", pod.key(), pod.node_name)
            return False
        with self._lock:
            added = info.add_or_update_pod(pod)
            if added:
                self._known_pods[pod.uid] = pod
                # Placed: its ledger entry accounts for it from here on.
                self._nominated.pop(pod.uid, None)
                if self.quota is not None:
                    # The tenant ledger charges what the card ledger just
                    # priced, from the same annotations.
                    self.quota.charge(pod)
        if added:
            # Rebuild the admission summary HERE, on the mutating
            # thread (a sync worker, usually) — a churn wave otherwise
            # leaves hundreds of invalidated summaries for the next
            # filter call to rebuild in one storm (a p99 spike).
            info.summary()
        return added

    def remove_pod(self, pod: Pod) -> None:
        """Forget a pod and free its chips (reference cache.go:116-127)."""
        with self._lock:
            self._known_pods.pop(pod.uid, None)
            self._nominated.pop(pod.uid, None)
            if self.quota is not None:
                self.quota.uncharge(pod)
            info = self._nodes.get(pod.node_name)
        if info is not None:
            info.remove_pod(pod)
            info.summary()  # rebuild off the verb path (see add path)

    # ------------------------------------------------------------------ #
    # Startup rebuild (reference BuildCache, cache.go:49-74)
    # ------------------------------------------------------------------ #

    def build(self) -> int:
        """Reconstruct the ledger from annotated pods; returns pod count."""
        count = 0
        for pod in self._pod_lister():
            if not podutils.is_assumed(pod):
                continue
            if not podutils.is_assigned_non_terminated(pod):
                continue
            if self.add_or_update_pod(pod):
                count += 1
        log.info("cache rebuilt from %d annotated pods", count)
        return count
