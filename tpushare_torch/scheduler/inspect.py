"""Inspect verb: the utilization and debug document.

The port's copy of ``tpushare/scheduler/inspect.py`` (gpushare's
``pkg/scheduler/inspect.go``): per node, per card the total and used GiB
and the resident (assigned, running) pods, with the node's topology and
each card's coordinates, and the HBM a namespace holds; with a gang
planner wired, the groups in flight under ``gangs``.
"""

from __future__ import annotations

from typing import Any, Callable

from tpushare_torch.cache.cache import SchedulerCache
from tpushare_torch.cache.nodeinfo import NodeInfo
from tpushare_torch.utils import const
from tpushare_torch.utils import node as nodeutils
from tpushare_torch.utils import pod as podutils


class Inspect:
    name = "tpushare-inspect"

    def __init__(self, cache: SchedulerCache,
                 node_lister: Callable[[], list] | None = None,
                 gang_planner: Any = None) -> None:
        self.cache = cache
        self._node_lister = node_lister  # () -> list[Node], for all-nodes view
        self._gang_planner = gang_planner  # the groups in flight

    def _build_node(self, info: NodeInfo) -> dict:
        """Per-node document (reference inspect.go:33-71)."""
        chips = []
        used_total = 0
        for idx in sorted(info.chips):
            chip = info.chips[idx]
            pods = []
            for p in chip.snapshot_pods():
                if not podutils.is_assigned_non_terminated(p):
                    continue  # reference inspect.go:49 filter
                entry = {
                    "name": p.name,
                    "namespace": p.namespace,
                    # uid lets operator tooling (the what-if preempt CLI)
                    # join inspect output with preempt victim UIDs
                    "uid": p.uid,
                    "usedHBM": podutils.pod_used_hbm(p),
                    "chipIds": podutils.get_chip_ids_from_annotation(p),
                    # Request type + scoring intent travel with the dump
                    # so offline tooling (the defrag advisor) re-models
                    # the pod EXACTLY — no slice-vs-chip heuristics on
                    # heterogeneous fleets, no silently dropped spread
                    # policy.
                    "wholeChip":
                        podutils.get_chips_from_pod_resource(p) > 0,
                }
                scoring = p.annotations.get(const.ANN_SCORING)
                if scoring:
                    entry["scoring"] = scoring
                # Watchdog telemetry (apiserver-as-store): what the
                # tenant REPORTS using vs. the grant the ledger priced —
                # the operator-visible "verify" half of trust + verify
                # (the fraction cap is measured-unenforced, so the
                # ledger's usedHBM alone can hide an overrun).
                reported = p.annotations.get(const.ANN_HBM_USED)
                if reported is not None:
                    entry["reportedUsedHBM"] = reported
                if p.annotations.get(const.ANN_OVERRUN) == \
                        const.ASSIGNED_TRUE:
                    entry["overrun"] = True
                gang = p.annotations.get(const.ANN_POD_GROUP)
                if gang:
                    entry["gang"] = gang
                pods.append(entry)
            used = chip.get_used_hbm()
            used_total += used
            chips.append({
                "id": idx,
                "coords": list(info.topology.coords(idx))
                          if idx < info.topology.chip_count else [],
                "totalHBM": chip.total_hbm,
                "usedHBM": used,
                "pods": pods,
            })
        doc = {
            "name": info.name,
            "tpuType": nodeutils.get_tpu_type(info.node),
            "topology": nodeutils.get_topology(info.node),
            "sliceId": nodeutils.get_slice_id(info.node),
            "totalHBM": info.total_hbm,
            "usedHBM": used_total,
            "chips": chips,
        }
        # Cordon state matters to the operator reading this view: a
        # "free" cordoned node is not actually placeable capacity (gang
        # quorum skips it too).
        if info.node.unschedulable:
            doc["unschedulable"] = True
        if info.node.taints:
            # Exported so offline tooling (defrag) knows this node's
            # capacity is conditional — which pods can land here depends
            # on tolerations the dump doesn't carry.
            doc["taints"] = list(info.node.taints)
        # Position within a multi-host slice, when known: operators (and
        # the what-if CLI) can see which hosts of a slice are grid
        # neighbors — the adjacency gang placement optimizes for.
        widx = nodeutils.get_worker_index(info.node)
        if widx is not None:
            doc["workerIndex"] = widx
        pos = nodeutils.host_position(info.node)
        if pos is not None:
            doc["hostCoords"] = list(pos[0])
            doc["sliceTopology"] = nodeutils.get_slice_topology(info.node)
        return doc

    def handle(self, node_name: str | None = None) -> dict:
        """All nodes, or one (reference inspect.go:9-31)."""
        if node_name:
            info = self.cache.get_node_info(node_name)
            if info is None:
                return {"nodes": [], "error": f"unknown node {node_name}"}
            return {"nodes": [self._build_node(info)]}
        infos = {i.name: i for i in self.cache.get_node_infos()}
        if self._node_lister is not None:
            for node in self._node_lister():
                if node.name not in infos and nodeutils.is_tpu_sharing_node(node):
                    built = self.cache.get_node_info(node.name)
                    if built is not None:
                        infos[built.name] = built
        nodes = [self._build_node(i) for _, i in sorted(infos.items())]
        doc = {"nodes": nodes}
        namespaces = self._namespace_usage(nodes)
        if namespaces:
            doc["namespaces"] = namespaces
        if self._gang_planner is not None:
            gangs = self._gang_planner.snapshot()
            if gangs:
                doc["gangs"] = gangs
        return doc

    @staticmethod
    def _namespace_usage(nodes: list[dict]) -> list[dict]:
        """Per-namespace HBM totals — the chargeback view. A pod's
        ``usedHBM`` is its FULL grant (a multi-chip pod repeats it on
        every chip it holds), so each pod is counted exactly once."""
        usage: dict[str, dict] = {}
        for node in nodes:
            for chip in node["chips"]:
                for pod in chip["pods"]:
                    ns = usage.setdefault(
                        pod["namespace"], {"usedHBM": 0, "seen": set()})
                    key = (pod["namespace"], pod["name"])
                    if key not in ns["seen"]:
                        ns["seen"].add(key)
                        ns["usedHBM"] += pod["usedHBM"]
        return [{"namespace": ns, "usedHBM": u["usedHBM"],
                 "pods": len(u["seen"])}
                for ns, u in sorted(usage.items(),
                                    key=lambda kv: -kv[1]["usedHBM"])]
