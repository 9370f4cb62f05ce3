"""tpushare_torch.defrag — stranded-HBM detection and budgeted rebalancing.

The port's copy of ``tpushare/defrag/__init__.py``.

The extender bin-packs greedily at admission time; long-running fleets
drift into states where total free HBM is plentiful but scattered — a
pending pod that needs 24 GiB on one chip sits unschedulable behind six
nodes with 8 GiB free each (the Gandiva/HiveD fragmentation failure
mode). Three parts repair it:

* :mod:`tpushare_torch.defrag.frag` — the fragmentation index: scores each
  node and the cluster from the live ledger against the demand shapes
  currently failing the filter (stranded HBM, splinter chips, packing
  ratio).
* :mod:`tpushare_torch.defrag.planner` — the rebalance planner: a bounded
  greedy search for moves (evict pod P from node A, proven re-placeable
  on node B by replaying the real admission predicate and chip picker
  against a what-if copy of the ledger), gang-atomic, quota-safe, and
  checkpoint-aware.
* :mod:`tpushare_torch.defrag.executor` — the budgeted executor in the
  controller: leader-gated, dry-run by default
  (``TPUSHARE_DEFRAG_MODE=off|dry-run|active``), evicting through the
  PDB-honoring budgeted helper (:mod:`tpushare_torch.k8s.eviction`) and
  aborting the whole plan when the SLO engine reports a burning
  objective.

See docs/defrag.md for the index math, the planner invariants, and the
budget/abort runbook.
"""

from __future__ import annotations

from tpushare_torch.defrag.executor import DefragExecutor
from tpushare_torch.defrag.planner import Move, Plan, RebalancePlanner

__all__ = ["DefragExecutor", "Move", "Plan", "RebalancePlanner"]
