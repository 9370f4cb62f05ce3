"""Sync controller: keeps the ledger consistent with the apiserver.

The port's copy of ``tpushare/controller/controller.py`` (gpushare's
``pkg/gpushare/controller.go``) for the single-pod path: informer
handlers keep the pods that request HBM or cards, funnel their keys
through a rate-limited workqueue, and ``sync_pod`` reconciles the cache.
A deleted pod is stashed until its sync frees it, since the apiserver's
copy is gone by then; a committed gang member's death reaps the
survivors when the group falls below its minimum (``_maybe_reap_gang``).
Worker threads loop until shutdown, as many as asked. The controller
owns the tenant quota ledger: the cache charges it, and the
``tpushare-quotas`` ConfigMap configures it, trusted only from
``TPUSHARE_QUOTA_NAMESPACE`` (``kube-system`` by default). A node's
Ready → NotReady edge stamps a ``node-notready`` timeline marker and a
Warning Event; a quota ConfigMap applied stamps a ``config`` marker; the
start replays the black-box journal (:func:`tpushare_torch.obs.
replay_startup`). Pod journeys (:mod:`tpushare_torch.slo`) open when the
informer first sees an unassigned pod, close when it binds or is deleted,
and are rebuilt from annotations at the start; the ``tpushare-slos``
ConfigMap, trusted only from ``TPUSHARE_SLO_NAMESPACE``, sets the
objectives. The controller owns the defrag executor
(:mod:`tpushare_torch.defrag`) and the autoscale executor
(:mod:`tpushare_torch.autoscale`, which spends the defrag executor's
eviction budget), started and stopped with it.
"""

from __future__ import annotations

import logging
import os
import threading
import time

from tpushare_torch import obs, slo
from tpushare_torch.api.objects import ConfigMap, Pod
from tpushare_torch.cache.cache import SchedulerCache
from tpushare_torch.k8s import events
from tpushare_torch.k8s.errors import ApiError, NotFoundError
from tpushare_torch.k8s.informer import InformerHub
from tpushare_torch.k8s.workqueue import RateLimitedQueue
from tpushare_torch.quota import config as quota_config
from tpushare_torch.quota.manager import QuotaManager
from tpushare_torch.slo import config as slo_config
from tpushare_torch.utils import const
from tpushare_torch.utils import pod as podutils
from tpushare_torch.utils import locks

log = logging.getLogger(__name__)


class Controller:
    def __init__(self, client, hub: InformerHub | None = None,
                 is_leader=None, default_scoring: str | None = None):
        self.client = client
        self.hub = hub or InformerHub(client)
        self.queue = RateLimitedQueue()
        #: The tenant ledger: the cache charges it, the tpushare-quotas
        #: ConfigMap configures it, and build_stack hands it to the verbs.
        self.quota = QuotaManager()
        #: The one namespace the quota ConfigMap is trusted from: the
        #: watch is cluster-wide, and a match by name alone would let any
        #: namespace rewrite (or delete) the fleet's quota table.
        self._quota_namespace = os.environ.get("TPUSHARE_QUOTA_NAMESPACE",
                                               "kube-system")
        # default_scoring reaches every ledger's chip picker, so placement
        # within a node agrees with the prioritize verb's fleet policy.
        self.cache = SchedulerCache(self._get_node, self._list_pods,
                                    default_scoring=default_scoring,
                                    quota=self.quota)
        self._removed_lock = locks.TracingRLock("controller/removed")
        #: ns/name -> last seen Pod, for deletes (gpushare's
        #: removePodCache)
        self._removed: dict[str, Pod] = locks.guarded_dict(
            self._removed_lock, "Controller._removed")
        #: uids the gang reaper deleted itself: their deletes must not reap
        #: again (the owner may be recreating the group by then).
        self._reaped_uids: set[str] = locks.guarded_set(
            self._removed_lock, "Controller._reaped_uids")
        #: ``() -> bool``: gates the apiserver writes this controller
        #: issues (the gang reaper, the defrag and autoscale executors);
        #: the ledger's upkeep runs on every replica.
        self._is_leader = is_leader or (lambda: True)
        #: Defragmentation: the stranded-HBM index and the budgeted,
        #: SLO-guarded rebalancer. Dry-run by default;
        #: TPUSHARE_DEFRAG_MODE=active arms eviction. build_stack wires
        #: the filter verb's DemandTracker in after construction.
        from tpushare_torch.defrag.executor import DefragExecutor
        self.defrag = DefragExecutor(
            self.cache, client, quota=self.quota,
            pod_lister=self.hub.pods.list, is_leader=self._is_leader)
        #: Fleet autoscaling: demand-driven scale-up, drain-aware
        #: scale-down. Dry-run by default; TPUSHARE_AUTOSCALE=active arms
        #: node create and delete. It spends the defrag executor's
        #: eviction budget: drains and rebalance moves disrupt the same
        #: pods, so they share one hourly allowance. build_stack wires the
        #: DemandTracker (and serve_stack the router) after construction.
        from tpushare_torch.autoscale.executor import AutoscaleExecutor
        self.autoscale = AutoscaleExecutor(
            self.cache, client, quota=self.quota,
            pod_lister=self.hub.pods.list, is_leader=self._is_leader,
            budget=self.defrag.budget)
        self._workers: list[threading.Thread] = []
        self._stop = threading.Event()

        self.hub.add_pod_handler(
            on_add=self._on_pod_add,
            on_update=self._on_pod_update,
            on_delete=self._on_pod_delete,
            filter_fn=self._is_relevant_pod,
        )
        # The verbs' fast paths serve cached ledgers, so a changed node
        # document (capacity, sharing annotation) reaches the cache from
        # the watch.
        self.hub.add_node_handler(
            on_update=self._on_node_update,
            on_delete=self._on_node_delete)
        self.hub.add_configmap_handler(
            on_add=self._on_quota_configmap,
            on_update=lambda old, new: self._on_quota_configmap(new),
            on_delete=lambda cm: self.quota.set_config(quota_config.EMPTY),
            filter_fn=self._is_quota_configmap,
        )
        #: The one namespace the SLO ConfigMap is trusted from (the quota
        #: table's trust model).
        self._slo_namespace = os.environ.get("TPUSHARE_SLO_NAMESPACE",
                                             "kube-system")
        self.hub.add_configmap_handler(
            on_add=self._on_slo_configmap,
            on_update=lambda old, new: self._on_slo_configmap(new),
            # Deleted: the built-in objectives, not "no SLOs".
            on_delete=lambda cm: slo.engine().set_config(
                slo_config.DEFAULTS),
            filter_fn=self._is_slo_configmap,
        )
        # Arms the burn alert's Event (the gauges and log work without).
        slo.engine().set_client(client)

    # -- listers wired into the cache ----------------------------------- #

    def _get_node(self, name: str):
        """None only for a node confirmed missing (both clients map 404
        to None); a transient error propagates, and the cache then serves
        its cached ledger."""
        node = self.hub.get_node(name)
        if node is not None:
            return node
        # The informer may not have seen the node yet.
        return self.client.get_node(name)

    def _list_pods(self):
        pods = self.hub.pods.list()
        return pods if pods else self.client.list_pods()

    def _is_quota_configmap(self, cm: ConfigMap) -> bool:
        return (cm.name == const.QUOTA_CONFIGMAP
                and cm.namespace == self._quota_namespace)

    def _on_quota_configmap(self, cm: ConfigMap) -> None:
        """Applied inline: ``set_config`` is idempotent and needs no
        apiserver round trip."""
        self.quota.set_config(quota_config.parse_configmap(cm))
        obs.mark("config", f"quota ConfigMap {cm.namespace}/{cm.name} "
                 "applied", configmap="quota")

    def _is_slo_configmap(self, cm: ConfigMap) -> bool:
        return (cm.name == const.SLO_CONFIGMAP
                and cm.namespace == self._slo_namespace)

    def _on_slo_configmap(self, cm: ConfigMap) -> None:
        slo.engine().set_config(slo_config.parse_configmap(cm))

    @staticmethod
    def _is_relevant_pod(pod: Pod) -> bool:
        """Informer-side filter (gpushare filters on IsGPUsharingPod)."""
        return (podutils.is_tpu_sharing_pod(pod)
                or podutils.is_tpu_chip_pod(pod)
                or podutils.is_assumed(pod))

    # -- event handlers --------------------------------------------------- #

    @staticmethod
    def _journey_candidate(pod: Pod) -> bool:
        """An unassigned, live pod that asks for memory or cards: its
        journey's clock is the extender's to keep."""
        return ((podutils.is_tpu_sharing_pod(pod)
                 or podutils.is_tpu_chip_pod(pod))
                and not podutils.is_assumed(pod)
                and not pod.node_name
                and not podutils.is_complete_pod(pod))

    def _on_pod_add(self, pod: Pod) -> None:
        if self._journey_candidate(pod):
            # The informer or the first filter opens the journey, whichever
            # sees the pod first; both clock it from its creation time.
            slo.tracker().open_journey(pod)
        self.queue.add(pod.key())

    @staticmethod
    def _usage_changed(old: Pod | None, new: Pod) -> bool:
        """Did the watchdog's usage annotations on the pod change?"""
        if old is None:
            return (const.ANN_HBM_USED in new.annotations
                    or const.ANN_OVERRUN in new.annotations)
        return any(old.annotations.get(k) != new.annotations.get(k)
                   for k in (const.ANN_HBM_USED, const.ANN_OVERRUN))

    def _on_pod_update(self, old: Pod | None, new: Pod) -> None:
        """Enqueue iff the update changes the ledger: a known pod that
        completed, or whose watchdog usage changed (inspect shows it); an
        unknown pod that gained a bound assignment; or a nomination set
        or cleared by a preemption round."""
        known = self.cache.known_pod(new.uid)
        if known and podutils.is_complete_pod(new):
            self.queue.add(new.key())
        elif known and self._usage_changed(old, new):
            self.queue.add(new.key())
        elif known and (old is None or old.annotations.get(
                const.ANN_CKPT_IN_FLIGHT) != new.annotations.get(
                const.ANN_CKPT_IN_FLIGHT)):
            # A checkpoint-in-flight flip gates eviction (defrag moves):
            # the ledger's copy must learn it, or movable() reads a stale
            # verdict for the whole save.
            self.queue.add(new.key())
        elif not known and podutils.is_assumed(new) and new.node_name:
            self.queue.add(new.key())
        elif new.nominated_node_name != (
                old.nominated_node_name if old is not None else ""):
            self.queue.add(new.key())
        elif new.nominated_node_name and podutils.is_complete_pod(new):
            # A nominated pod that dies pending must sync too, or its
            # earmark blocks that node forever.
            self.queue.add(new.key())

    def _on_pod_delete(self, pod: Pod) -> None:
        # A pod deleted while its journey is open never bound: the
        # journey's "deleted" outcome (a no-op once it closed bound).
        slo.tracker().pod_deleted(pod)
        with self._removed_lock:
            self._removed[pod.key()] = pod
        self.queue.add(pod.key())

    def _on_node_update(self, old, new) -> None:
        """The node document changed: bring its cached ledger in line, and
        surface a Ready → NotReady transition as a host-failure marker and
        a Warning Event. Only the edge fires: a node that stays NotReady
        across status heartbeats must not flood the timeline; recovery
        shows as the ``fleet_nodes_ready`` series climbing back."""
        self.cache.refresh_node(new)
        if old is not None and old.ready and not new.ready:
            cursor = obs.mark("node-notready", f"node {new.name} NotReady",
                              node=new.name)
            pod = Pod({"metadata": {"name": "tpushare-scheduler-extender",
                                    "namespace": "kube-system", "uid": ""}})
            events.record(
                self.client, pod, events.REASON_NODE_NOTREADY,
                f"node {new.name} transitioned to NotReady; its chips "
                f"stay in the ledger until the Node object is deleted "
                f"[timeline {cursor}]",
                event_type="Warning", trace_id="")

    def _on_node_delete(self, node) -> None:
        """The Node object is gone: drop its ledger (inline: removal is
        idempotent and needs no apiserver round trip)."""
        self.cache.remove_node(node.name)

    # -- reconcile (gpushare's syncPod) ----------------------------------- #

    def sync_pod(self, key: str) -> None:
        namespace, name = key.split("/", 1)
        pod = self.hub.get_pod(namespace, name)
        if pod is None:
            try:
                pod = self.client.get_pod(namespace, name)
            except NotFoundError:
                pod = None
        with self._removed_lock:
            stashed = self._removed.pop(key, None)
        if stashed is not None and (pod is None
                                    or pod.uid != stashed.uid):
            # The deleted instance is gone: the key is empty, or holds a
            # successor under a new uid. A same-uid live pod means the
            # delete was stale: touch nothing.
            self.cache.remove_pod(stashed)
            log.info("sync: removed deleted pod %s (uid %s) from ledger",
                     key, stashed.uid)
            self._maybe_reap_gang(stashed)
        if pod is None:
            return
        if podutils.is_complete_pod(pod):
            self.cache.remove_pod(pod)
            log.info("sync: pod %s complete, freed its HBM", key)
        elif podutils.is_assumed(pod) and pod.node_name:
            self.cache.add_or_update_pod(pod)
            # Close the journey (a gang member bound by the planner's
            # commit thread, or a bind taken by an HA peer, arrives here,
            # not through this replica's bind route).
            slo.tracker().pod_bound(pod)
        elif not podutils.is_assumed(pod):
            # Pending: track (or drop) its preemption nomination.
            self.cache.note_nominated(pod)
        else:
            # Assumed but unbound: its ledger reservation holds its
            # capacity; a nomination on top would hold it twice.
            self.cache.clear_nominated(pod.uid)

    def _maybe_reap_gang(self, dead: Pod) -> None:
        """A bound gang member died mid-run (eviction, preemption, node
        loss) and its group can no longer reach quorum: the survivors are
        useless but still hold their cards, so delete them; an owner that
        recreates the group re-gangs it whole. Opt out a group with
        ``tpushare.io/pod-group-reap: "false"``."""
        group, minimum = podutils.get_pod_group(dead)
        if not group or minimum <= 1:
            return
        if podutils.is_complete_pod(dead) or not podutils.is_assumed(dead):
            # Finished (the survivors are fine), or never granted cards
            # (the planner's TTL rollback owns reservations).
            return
        if not dead.node_name:
            # Granted but never bound: the gang was still forming, which
            # is the planner's rollback to handle.
            return
        with self._removed_lock:
            if dead.uid in self._reaped_uids:
                # Our own reap: no cascade onto the owner's replacements.
                self._reaped_uids.discard(dead.uid)
                return
        if not self._is_leader():
            return  # one replica reaps
        if dead.annotations.get(const.ANN_POD_GROUP_REAP, "").lower() in (
                "false", "0", "no"):
            return
        # Only granted members count and die: a recreated replacement, not
        # yet scheduled, neither props up the quorum nor is killed.
        survivors = [
            p for p in self.hub.pods.list()
            if p.namespace == dead.namespace
            and p.annotations.get(const.ANN_POD_GROUP) == group
            and p.uid != dead.uid
            and podutils.is_assumed(p)
            and not podutils.is_complete_pod(p)
        ]
        if not survivors or len(survivors) >= minimum:
            return  # gone already, or still at quorum
        with self._removed_lock:
            self._reaped_uids.update(p.uid for p in survivors)
        log.warning(
            "gang %s/%s below quorum after %s died (%d survivors < min "
            "%d); reaping survivors to free their chips",
            dead.namespace, group, dead.name, len(survivors), minimum)
        from tpushare_torch.routes import metrics
        metrics.safe_inc(metrics.GANGS_REAPED)
        for p in survivors:
            try:
                self.client.delete_pod(p.namespace, p.name)
                events.record(
                    self.client, p, events.REASON_GANG_REAPED,
                    f"gang {group} lost member {dead.name} and cannot "
                    f"reach quorum ({len(survivors)} < {minimum}); "
                    "reclaiming this member's chips", event_type="Warning")
            except NotFoundError:
                pass  # the owner or another pass deleted it
            except ApiError as e:
                # Not deleted: its eventual death must reap again.
                with self._removed_lock:
                    self._reaped_uids.discard(p.uid)
                log.warning("gang reap of %s failed (%s); its deletion "
                            "will retrigger the reaper", p.key(), e)

    # -- workers ---------------------------------------------------------- #

    def _worker(self) -> None:
        while not self._stop.is_set():
            key = self.queue.get(timeout=0.5)
            if key is None:
                continue
            try:
                self.sync_pod(key)
            except ApiError as e:
                log.warning("sync of %s failed (%s); requeueing", key, e)
                self.queue.add_rate_limited(key)
            except Exception:
                log.exception("sync of %s crashed; requeueing", key)
                self.queue.add_rate_limited(key)
            else:
                self.queue.forget(key)
            finally:
                self.queue.done(key)

    # -- lifecycle -------------------------------------------------------- #

    def start(self, workers: int = 4) -> None:
        self.hub.start()
        if not self.hub.wait_for_sync():
            raise RuntimeError("informer cache never synced")
        # Crash forensics: replay the previous process's black-box journal
        # (markers and samples onto the timeline, decisions into the
        # flight recorder's restored buffer) behind a ``restart`` marker.
        # A no-op unless TPUSHARE_BLACKBOX_DIR is set; once a process.
        obs.replay_startup()
        # The initial LIST fills the stores without calling handlers:
        # seed the quota table from it, so the first filter enforces it.
        for cm in self.hub.configmaps.list():
            if self._is_quota_configmap(cm):
                self._on_quota_configmap(cm)
            elif self._is_slo_configmap(cm):
                self._on_slo_configmap(cm)
        self.cache.build()
        # Journeys across a restart: a bound pod's is rebuilt from its
        # annotations (assume-time against creationTimestamp), a pending
        # pod's opens again on its creation clock.
        for pod in self.hub.pods.list():
            if podutils.is_assumed(pod) and pod.node_name \
                    and not podutils.is_complete_pod(pod):
                slo.tracker().reconstruct(pod)
            elif self._journey_candidate(pod):
                slo.tracker().open_journey(pod)
        for i in range(workers):
            t = threading.Thread(target=self._worker,
                                 name=f"tpushare-sync-{i}", daemon=True)
            t.start()
            self._workers.append(t)
        # The defrag and autoscale loops (no-ops when their mode is off);
        # each first tick is a full interval away.
        self.defrag.start()
        self.autoscale.start()
        log.info("controller started with %d sync workers", workers)

    def stop(self) -> None:
        self._stop.set()
        self.defrag.stop()
        self.autoscale.stop()
        self.queue.shut_down()
        self.hub.stop()
        for t in self._workers:
            t.join(timeout=2)

    def wait_idle(self, timeout: float = 5.0) -> bool:
        """Block until the cache has converged on the apiserver: every
        delivered watch event dispatched, then the workqueue drained (in
        that order: dispatch enqueues work). Stable once the caller has
        stopped writing to the apiserver."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.hub.quiesced():
                with self.queue._cond:
                    busy = (len(self.queue._queue) + len(self.queue._delayed)
                            + len(self.queue._processing))
                if busy == 0:
                    return True
            time.sleep(0.01)
        return False
