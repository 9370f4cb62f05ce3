"""Filter (predicate) verb.

The port's copy of ``tpushare/scheduler/predicate.py`` (gpushare's
``pkg/scheduler/predicate.go``): a named predicate over the candidate
nodes with the HBM-share admission check bound over the cache. A pure
read path, no apiserver round trip. It takes both wire forms
(``NodeNames`` when the scheduler is ``nodeCacheCapable``, full
``Nodes`` otherwise). A tenant over its quota's hard limit is refused
on every node before any node is priced, with a quota reason and a
Warning Event at most once a tenant every ``QUOTA_EVENT_INTERVAL_S``.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable

from tpushare_torch.api.extender import ExtenderArgs, ExtenderFilterResult
from tpushare_torch.api.objects import Pod
from tpushare_torch.cache.cache import SchedulerCache
from tpushare_torch.cache.nodeinfo import MEMO_CAP, NodeInfo, NodeSummary
from tpushare_torch.k8s import events
from tpushare_torch.quota.manager import QuotaManager
from tpushare_torch.utils import node as nodeutils
from tpushare_torch.utils import pod as podutils

log = logging.getLogger(__name__)

#: Seconds between quota-denial Events a tenant: the scheduler retries a
#: denied pod every cycle, and an Event each time would flood the events
#: pipeline for a tenant parked over its limit.
QUOTA_EVENT_INTERVAL_S = 30.0


class DemandTracker:
    """Unplaceable demand, as seen from the filter verb — the
    cluster-autoscaler signal the reference never had.

    The stock autoscaler cannot reason about a webhook's extended
    resources: a pod rejected by OUR filter on every node looks, to the
    autoscaler, like a pod the cluster shape already satisfies. This
    tracker aggregates the pods currently failing everywhere (and what
    they ask for) into gauges an autoscaler or operator can act on:
    nonzero `tpushare_unschedulable_demand_*` for N minutes means the
    fleet needs more TPU nodes, not more retries.

    A pod passing filter on THIS replica clears its entry immediately.
    That is not enough by itself: in the HA deployment every replica
    answers filter behind one Service, so the pod's passing retry (or
    its deletion) can land on a peer and this replica would page about
    demand that is already running. Each scrape therefore re-checks
    entries against the local informer's pod view (``pod_lookup``) —
    a pod that is gone, re-created under a new UID, bound (by anyone),
    or terminated is pruned on the spot, replica-independently. The
    ``ttl`` is only the backstop for a missing lookup."""

    def __init__(self, ttl: float = 900.0,
                 pod_lookup: Callable[[str, str], Pod | None] | None = None,
                 ) -> None:
        self.ttl = ttl
        #: Optional lister-style fetch ``(ns, name) -> Pod | None``.
        self.pod_lookup = pod_lookup
        self._lock = threading.RLock()
        #: uid -> (hbm GiB, chips, (ns, name), last-seen monotonic,
        #: tenant) — the tenant rides along so the autoscaler signal can
        #: say WHOSE demand is unplaceable (`by_tenant`).
        self._entries: dict[str, tuple[int, int, tuple, float, str]] = {}

    def record_unplaceable(self, pod: Pod) -> None:
        hbm = podutils.get_hbm_from_pod_resource(pod)
        chips = podutils.get_chips_from_pod_resource(pod)
        with self._lock:
            self._entries[pod.uid] = (hbm, chips,
                                      (pod.namespace, pod.name),
                                      time.monotonic(),
                                      podutils.get_tenant(pod))

    def clear(self, uid: str) -> None:
        with self._lock:
            self._entries.pop(uid, None)

    def _still_pending(self, uid: str, ns_name: tuple) -> bool:
        """Is the pod still an unsatisfied demand, per the informer?"""
        try:
            pod = self.pod_lookup(*ns_name)
        except Exception:
            return True  # lookup trouble: keep the entry, TTL bounds it
        return (pod is not None and pod.uid == uid
                and not pod.node_name
                and not podutils.is_complete_pod(pod))

    def snapshot(self) -> tuple[int, int, int]:
        """(pods, total HBM GiB, total chips) still unplaceable; prunes
        expired and no-longer-pending entries as a side effect.

        ``pod_lookup`` runs OUTSIDE the tracker lock, so the filter path's
        ``record_unplaceable``/``clear`` never block behind a probe. The
        metrics scrape lock is still held by our caller for the whole
        snapshot — ``pod_lookup`` MUST stay a local-store read (the wired
        informer lookup is); wiring the networked ApiClient here would
        stall every ``/metrics`` scrape. Copy, probe unlocked, re-acquire
        to delete — a pod re-recorded between the probe and the delete
        wins via the ``seen`` timestamp check."""
        now = time.monotonic()
        with self._lock:
            entries = dict(self._entries)
        dead = {
            uid: seen
            for uid, (_, _, ns_name, seen, _) in entries.items()
            if now - seen > self.ttl
            or (self.pod_lookup is not None
                and not self._still_pending(uid, ns_name))
        }
        with self._lock:
            for uid, seen in dead.items():
                cur = self._entries.get(uid)
                if cur is not None and cur[3] == seen:
                    del self._entries[uid]
            pods = len(self._entries)
            hbm = sum(e[0] for e in self._entries.values())
            chips = sum(e[1] for e in self._entries.values())
        return pods, hbm, chips


def _admit(s: NodeSummary, req_chips: int, req_hbm: int,
           name: str) -> tuple[NodeSummary, bool, str]:
    """The summary-side admission verdict, memoized per node per request
    shape. Reason strings mirror ``NodeInfo.assume``'s exactly — the two
    admission paths must be indistinguishable in traces."""
    if not s.sharing:
        return s, False, f"node {name} advertises no shareable TPU HBM"
    if req_chips > 0:
        if len(s.free_chips) >= req_chips:
            return s, True, ""
        return s, False, (f"insufficient free TPU chips: want "
                          f"{req_chips}, have {len(s.free_chips)}")
    if req_hbm <= 0:
        return s, False, "pod requests no TPU resources"
    if s.max_free_chip >= req_hbm:
        return s, True, ""
    return s, False, "insufficient TPU HBM in one chip"


class Predicate:
    name = "tpushare-filter"

    def __init__(self, cache: SchedulerCache,
                 demand: DemandTracker | None = None,
                 quota: QuotaManager | None = None,
                 client: object | None = None) -> None:
        """``quota`` arms the hard-limit gate (None: no tenancy).
        ``client`` writes the denial Events; without it a denial is still
        enforced, just not visible to ``kubectl describe``."""
        self.cache = cache
        self.demand = demand or DemandTracker()
        self.quota = quota
        self.client = client
        self._quota_event_lock = threading.RLock()
        #: tenant -> monotonic stamp of its last denial Event.
        self._quota_event_at: dict[str, float] = {}

    def _deny_quota(self, args: ExtenderArgs, pod: Pod,
                    reason: str) -> ExtenderFilterResult:
        """Refuse every candidate with the quota reason. Not recorded as
        unplaceable demand: capacity exists, the tenant is over policy."""
        tenant = podutils.get_tenant(pod)
        failed = {name: reason for name in args.candidate_names()}
        self.demand.clear(pod.uid)
        if self.client is not None:
            now = time.monotonic()
            with self._quota_event_lock:
                due = (now - self._quota_event_at.get(tenant, 0.0)
                       >= QUOTA_EVENT_INTERVAL_S)
                if due:
                    self._quota_event_at[tenant] = now
            if due:
                events.record(self.client, pod, events.REASON_QUOTA_DENIED,
                              reason, event_type="Warning")
        log.debug("filter pod %s: quota-denied (%s)", pod.key(), reason)
        return ExtenderFilterResult(
            node_names=[] if args.node_names is not None else None,
            nodes=[] if args.nodes is not None else None,
            failed_nodes=failed,
        )

    def filter_node(self, pod: Pod, node_name: str) -> tuple[bool, str]:
        """The per-node admission check (reference
        gpushare-predicate.go:16-37), run with higher-or-equal-priority
        NOMINATED pods assumed present (upstream scheduler semantics) —
        capacity a preemptor's victims freed stays earmarked for it
        until it binds."""
        info = self.cache.get_node_info(node_name)
        if info is None:
            return False, f"unknown node {node_name}"
        if not nodeutils.is_schedulable(info.node, pod):
            # Upstream kube-scheduler filters cordoned nodes before any
            # extender; honoring the bit here keeps the verdict identical
            # for harnesses (and autoscaler drains) that skip that pass.
            return False, f"node {node_name} is cordoned (unschedulable)"
        if not nodeutils.is_tpu_sharing_node(info.node):
            return False, f"node {node_name} advertises no shareable TPU HBM"
        ok, reason = info.assume(pod,
                                 nominated=self.cache.nominated_on(node_name))
        return ok, reason

    def snapshot(self) -> tuple[dict[str, "NodeInfo"], set[str]]:
        """The per-request ledger view :meth:`handle` reads: the
        one-lock node table plus the nominated-demand trigger set.
        Exposed so the HTTP layer's micro-batch executor
        (routes/server.py) can take it ONCE and feed N coalesced
        requests through ``handle(table=, nominated=)`` — the
        per-shape admission memos then collapse the probe work across
        same-shape pods."""
        return self.cache.node_table(), self.cache.nominated_node_names()

    def handle(self, args: ExtenderArgs,
               table: "dict[str, NodeInfo] | None" = None,
               nominated: "set[str] | None" = None,
               ) -> ExtenderFilterResult:
        """Loop candidates, partition into schedulable / failed (reference
        predicate.go:15-39).

        The loop reads each node's :class:`NodeSummary` (one lock-free
        tuple read against the incrementally-maintained admission index)
        instead of replaying ``assume`` per candidate (about ten lock
        round trips and a dict build a candidate). Nodes with earmarked
        preemption demand — and names the table has never seen — take
        the full :meth:`filter_node` path, so semantics are unchanged
        where they matter.

        ``table``/``nominated`` inject a snapshot already taken (the
        micro-batch executor's path, via :meth:`snapshot`); when
        omitted the verb takes its own, as before."""
        pod = args.pod
        if not (podutils.is_tpu_sharing_pod(pod) or podutils.is_tpu_chip_pod(pod)):
            # Not ours: pass everything through untouched.
            return ExtenderFilterResult(
                node_names=args.node_names, nodes=args.nodes, failed_nodes={}
            )

        if self.quota is not None:
            # The tenant's hard limit first: no node is worth pricing for
            # a pod its tenant may not place anywhere.
            ok, reason = self.quota.admit(pod)
            if not ok:
                return self._deny_quota(args, pod, reason)

        req_chips = podutils.get_chips_from_pod_resource(pod)
        req_hbm = podutils.get_hbm_from_pod_resource(pod)
        shape = (req_chips, req_hbm)
        if nominated is None:
            nominated = self.cache.nominated_node_names()
        if table is None:
            table = self.cache.node_table()
        passed_names: list[str] = []
        passed_nodes: list = []
        failed: dict[str, str] = {}
        admit_pass = passed_names.append
        for name in args.candidate_names():
            info = table.get(name)
            if info is None or (nominated and name in nominated):
                # First sight of the node, or earmarked preemption
                # demand on it: the full assume path (rare).
                ok, reason = self.filter_node(pod, name)
                if ok:
                    admit_pass(name)
                else:
                    failed[name] = reason
                continue
            # Inline read of the published summary (even the summary()
            # call's early return costs at 1k candidates). Rebuilds
            # happen at mutation sites, so a miss here is rare.
            s = info._summary
            if s is None:
                s = info.summary()
            if s.unschedulable and not nodeutils.is_schedulable(info.node,
                                                                pod):
                # Cordoned (autoscaler drain / kubectl cordon): one
                # tuple-field read for the common uncordoned fleet; the
                # full toleration check only runs for the rare cordoned
                # node, so pods tolerating the unschedulable taint still
                # pass exactly as upstream would let them.
                failed[name] = f"node {name} is cordoned (unschedulable)"
                continue
            ent = info.admit_memo.get(shape)
            if ent is None or ent[0] is not s:
                ent = _admit(s, req_chips, req_hbm, name)
                memo = info.admit_memo
                if len(memo) >= MEMO_CAP:
                    memo.clear()
                memo[shape] = ent
            if ent[1]:
                admit_pass(name)
            else:
                failed[name] = ent[2]
        if args.nodes is not None:
            by_name = {n.name: n for n in args.nodes}
            passed_nodes = [by_name[n] for n in passed_names if n in by_name]
        if not passed_names and failed:
            # Failed EVERY offered node: this demand needs capacity the
            # fleet doesn't have — the autoscaler-visible signal.
            self.demand.record_unplaceable(pod)
        else:
            self.demand.clear(pod.uid)
        log.debug(
            "filter pod %s: %d passed, %d failed",
            pod.key(), len(passed_names), len(failed),
        )
        return ExtenderFilterResult(
            node_names=passed_names if args.node_names is not None else None,
            nodes=passed_nodes if args.nodes is not None else None,
            failed_nodes=failed,
        )
