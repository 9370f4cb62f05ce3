"""Fleet-scale serving front door: a tenant-aware request router over
shared-chip decode servers (docs/serving.md).

The port's copy of ``tpushare/router/__init__.py``.

The scheduler places decode pods on shared chips; the workload side
runs the continuous-batching slot server
(:mod:`tpushare_torch.workload.serving`). This package composes them into the
million-user story: an open-loop request stream routed by tenant +
slot-queue depth + KV-cache HBM headroom, load shedding by tenant quota
standing (reusing the :class:`tpushare_torch.quota.QuotaManager` spec), and a
scale-out signal into the scheduler when queues build.
"""

from tpushare_torch.router.router import (DecodeReplica, ReplicaEvent, Request,
                                    Router)

__all__ = ["DecodeReplica", "ReplicaEvent", "Request", "Router"]
