"""Bind verb, the path that writes.

The port's copy of ``tpushare/scheduler/bind.py`` (gpushare's
``pkg/scheduler/bind.go``): fetch the pod from the informer, or from the
apiserver when the lister has none or another uid, then run the node
ledger's ``allocate`` (annotate, bind, update the ledger) and record the
outcome as an Event. A gang pod goes to the gang planner instead, so a
pod group is only ever committed all or nothing; a member reserved
below quorum answers a pending error, which the scheduler retries. With
a quota ledger, the tenant's hard limit is checked again at the last
moment, and the pod's request reserved under the same lock.
"""

from __future__ import annotations

import logging
from typing import Any, Callable

from tpushare_torch.api.extender import ExtenderBindingArgs, ExtenderBindingResult
from tpushare_torch.api.objects import Pod
from tpushare_torch.cache.cache import SchedulerCache
from tpushare_torch.cache.nodeinfo import AllocationError
from tpushare_torch.gang.planner import GangPending
from tpushare_torch.k8s import events
from tpushare_torch.k8s.errors import ApiError
from tpushare_torch.utils import const
from tpushare_torch.utils import pod as podutils

log = logging.getLogger(__name__)


class Bind:
    name = "tpushare-bind"

    def __init__(self, cache: SchedulerCache, client: Any,
                 gang_planner: Any = None,
                 pod_lister: Callable[[str, str], Pod | None] | None = None,
                 quota: Any = None) -> None:
        self.cache = cache
        self.client = client
        self.gang_planner = gang_planner
        #: The informer's fetch ``(ns, name) -> Pod | None``; when wired,
        #: reads go to the local store first.
        self.pod_lister = pod_lister
        #: A QuotaManager, or None. Sibling binds can land between a pod's
        #: filter and its bind, so the hard limit is checked again here.
        self.quota = quota

    def _get_pod(self, args: ExtenderBindingArgs) -> Pod | None:
        """Lister first, the apiserver when the lister has none or holds
        another uid than the scheduler sent."""
        pod = None
        if self.pod_lister is not None:
            pod = self.pod_lister(args.pod_namespace, args.pod_name)
        if pod is not None and args.pod_uid and pod.uid != args.pod_uid:
            log.warning(
                "pod %s/%s UID mismatch: scheduler sent %s, lister has %s; "
                "refetching from apiserver",
                args.pod_namespace, args.pod_name, args.pod_uid, pod.uid)
            pod = None
        if pod is None:
            pod = self.client.get_pod(args.pod_namespace, args.pod_name)
        return pod

    def handle(self, args: ExtenderBindingArgs) -> ExtenderBindingResult:
        try:
            pod = self._get_pod(args)
        except ApiError as e:
            return ExtenderBindingResult(error=str(e))
        info = self.cache.get_node_info(args.node)
        if info is None:
            return ExtenderBindingResult(error=f"unknown node {args.node}")
        reserved = False
        if (self.quota is not None
                and (podutils.is_tpu_sharing_pod(pod)
                     or podutils.is_tpu_chip_pod(pod))):
            # Check and reserve under one lock: two binds of one tenant on
            # two HTTP threads must not both pass a bare check.
            ok, reason = self.quota.admit_and_reserve(pod)
            if not ok:
                log.warning("bind refused for pod %s/%s: %s",
                            args.pod_namespace, args.pod_name, reason)
                events.record(self.client, pod,
                              events.REASON_QUOTA_DENIED,
                              f"node {args.node}: {reason}",
                              event_type="Warning")
                return ExtenderBindingResult(error=reason)
            reserved = True
        try:
            if self.gang_planner is not None and podutils.is_gang_pod(pod):
                self.gang_planner.bind_member(pod, args.node)
            else:
                new_pod = info.allocate(self.client, pod)
                self.cache.add_or_update_pod(new_pod)
                events.record(
                    self.client, new_pod, events.REASON_BOUND,
                    f"bound to node {args.node} chip(s) "
                    f"{new_pod.annotations.get(const.ANN_CHIP_IDX)} "
                    f"({new_pod.annotations.get(const.ANN_HBM_POD)} GiB HBM)")
            return ExtenderBindingResult()
        except (AllocationError, ApiError) as e:
            log.warning("bind failed for pod %s/%s on node %s: %s",
                        args.pod_namespace, args.pod_name, args.node, e)
            if isinstance(e, GangPending):
                # Not a failure: the member is reserved, awaiting quorum.
                events.record(self.client, pod,
                              events.REASON_GANG_PENDING, str(e))
                return ExtenderBindingResult(error=str(e), pending=True)
            events.record(self.client, pod, events.REASON_BIND_FAILED,
                          f"node {args.node}: {e}", event_type="Warning")
            return ExtenderBindingResult(error=str(e))
        finally:
            # Release the reservation unless the cache took the pod (a
            # placement, or a reserved gang member): its charge replaced
            # the reservation under the same uid.
            if reserved and not self.cache.known_pod(pod.uid):
                self.quota.uncharge(pod)
