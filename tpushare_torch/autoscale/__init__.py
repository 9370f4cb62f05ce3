"""tpushare_torch.autoscale — demand-driven fleet autoscaling.

The port's copy of ``tpushare/autoscale/__init__.py``.

The subsystems below this one place work on a FIXED fleet: the filter
verb reports demand it cannot place (:class:`DemandTracker`), the frag
index prices how badly capacity is shredded, defrag repairs placement,
and the router signals serving pressure — but nothing changes the
number of nodes. This package closes that loop: a leader-gated
controller (:class:`AutoscaleExecutor`, modeled on the defrag
executor's tick/mode/budget shape) that provisions simulated nodes for
aged unplaceable demand and drains + deletes the most strandable node
when the fleet is oversized (docs/autoscale.md).
"""

from tpushare_torch.autoscale.executor import MODES, AutoscaleExecutor

__all__ = ["AutoscaleExecutor", "MODES"]
