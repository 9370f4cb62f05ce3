"""Fragmentation index: how much free HBM is actually *usable*?

The port's copy of ``tpushare/defrag/frag.py``.

Utilization gauges (`tpushare_node_hbm_used_gib`) cannot distinguish a
healthy 80%-full fleet from a pathological one: both report 20% free.
The difference is *shape* — whether the free capacity exists in pieces
some currently-pending request could take. This module scores it:

* **stranded HBM** — free HBM no currently-pending demand shape can
  use: a splinter smaller than every pending slice request, or a
  wholly-free chip on a node with too few free chips for every pending
  whole-chip request. Stranded capacity is the defrag planner's prey.
* **splinter chips** — chips carved into slices (partially used,
  partially free): each one is a chip no whole-chip pod can take.
* **packing ratio** — committed / total HBM across sharing nodes: the
  classic utilization number, carried here so the frag report is
  self-contained.

Demand shapes come from the filter verb's :class:`DemandTracker` (the
pods failing everywhere right now — exactly the demand stranding is
measured against); with no pending demand nothing is "stranded", by
definition: capacity nobody wants cannot be unusable.

All functions are pure reads over :class:`NodeInfo` ledgers; the
metrics scrape, the planner, `/debug/defrag`, and ``chip_smoke.py``'s
churn all call the same math.
"""

from __future__ import annotations

from typing import Iterable

from tpushare_torch.cache.nodeinfo import NodeInfo
from tpushare_torch.utils import node as nodeutils

#: (hbm GiB, whole chips) — one pending request's shape. Exactly one of
#: the two is nonzero (a pod asks for an HBM slice OR whole chips).
Shape = tuple[int, int]


def node_report(info: NodeInfo, shapes: Iterable[Shape]) -> dict:
    """Score one node's free capacity against the pending shapes."""
    avail = info.get_available_hbm()
    free_chips = set(info.get_free_chips())
    hbm_wants = sorted({h for h, c in shapes if h > 0})
    chip_wants = sorted({c for h, c in shapes if c > 0})
    free_hbm = 0
    stranded = 0
    splinters = 0
    for idx, chip in info.chips.items():
        free = avail.get(idx, 0)
        if 0 < free < chip.total_hbm:
            splinters += 1
        if free <= 0:
            continue
        free_hbm += free
        usable = any(free >= want for want in hbm_wants)
        if not usable and idx in free_chips and chip_wants:
            # A wholly-free chip serves a whole-chip request only when
            # the node has enough free chips for the smallest such
            # request — three free chips help no 4-chip pod.
            usable = len(free_chips) >= min(chip_wants)
        if not usable and (hbm_wants or chip_wants):
            stranded += free
    return {
        "node": info.name,
        "freeHBM": free_hbm,
        "strandedHBM": stranded,
        "splinterChips": splinters,
        "freeWholeChips": len(free_chips),
        # Fraction of the node's free HBM no pending request can take.
        "score": round(stranded / free_hbm, 4) if free_hbm else 0.0,
    }


def cluster_report(infos: Iterable[NodeInfo],
                   shapes: Iterable[Shape]) -> dict:
    """The fleet-level index: per-node reports plus the aggregates the
    metrics scrape exports and the executor decides from."""
    shapes = list(shapes)
    nodes = []
    free_hbm = stranded = splinters = used = total = 0
    for info in infos:
        if not nodeutils.is_tpu_sharing_node(info.node):
            continue
        report = node_report(info, shapes)
        nodes.append(report)
        free_hbm += report["freeHBM"]
        stranded += report["strandedHBM"]
        splinters += report["splinterChips"]
        total += info.total_hbm
        used += info.total_hbm - report["freeHBM"]
    return {
        "nodes": sorted(nodes, key=lambda n: -n["score"]),
        "freeHBM": free_hbm,
        "strandedHBM": stranded,
        # Fraction of the fleet's free HBM that is stranded — the
        # headline defrag number (the churn gates on it).
        "strandedRatio": round(stranded / free_hbm, 4) if free_hbm else 0.0,
        "splinterChips": splinters,
        # Committed / total across sharing nodes (the classic number).
        "packingRatio": round(used / total, 4) if total else 0.0,
        "pendingShapes": [{"hbm": h, "chips": c} for h, c in
                          sorted(set(shapes))],
    }
