"""Bind verb, the path that writes.

The port's copy of ``tpushare/scheduler/bind.py`` (gpushare's
``pkg/scheduler/bind.go``) for pods outside a gang: fetch the pod from
the informer, or from the apiserver when the lister has none or another
uid, then run the node ledger's ``allocate`` (annotate, bind, update the
ledger) and record the outcome as an Event. The gang planner and the
quota's last-moment check come with their own slices.
"""

from __future__ import annotations

import logging
from typing import Any, Callable

from tpushare_torch.api.extender import ExtenderBindingArgs, ExtenderBindingResult
from tpushare_torch.api.objects import Pod
from tpushare_torch.cache.cache import SchedulerCache
from tpushare_torch.cache.nodeinfo import AllocationError
from tpushare_torch.k8s import events
from tpushare_torch.k8s.errors import ApiError
from tpushare_torch.utils import const

log = logging.getLogger(__name__)


class Bind:
    name = "tpushare-bind"

    def __init__(self, cache: SchedulerCache, client: Any,
                 pod_lister: Callable[[str, str], Pod | None] | None = None
                 ) -> None:
        self.cache = cache
        self.client = client
        #: The informer's fetch ``(ns, name) -> Pod | None``; when wired,
        #: reads go to the local store first.
        self.pod_lister = pod_lister

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
        try:
            new_pod = info.allocate(self.client, pod)
        except (AllocationError, ApiError) as e:
            log.warning("bind failed for pod %s/%s on node %s: %s",
                        args.pod_namespace, args.pod_name, args.node, e)
            events.record(self.client, pod, events.REASON_BIND_FAILED,
                          f"node {args.node}: {e}", event_type="Warning")
            return ExtenderBindingResult(error=str(e))
        self.cache.add_or_update_pod(new_pod)
        events.record(
            self.client, new_pod, events.REASON_BOUND,
            f"bound to node {args.node} chip(s) "
            f"{new_pod.annotations.get(const.ANN_CHIP_IDX)} "
            f"({new_pod.annotations.get(const.ANN_HBM_POD)} GiB HBM)")
        return ExtenderBindingResult()
