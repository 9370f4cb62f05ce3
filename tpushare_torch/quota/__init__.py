"""Multi-tenant HBM and card arbitration: the port's copy of
``tpushare/quota``.

A tenant is a namespace (or a pod's ``tpushare.io/tenant`` label). Its
spec, from the ``tpushare-quotas`` ConfigMap, has a ``guarantee`` and a
``limit`` in HBM GiB and whole cards:

* the limit is hard: filter and bind refuse a pod that would take its
  tenant past it, on every node, with a quota reason;
* the guarantee is what the tenant is owed: usage beyond it borrows idle
  capacity, and is the first thing preemption takes back (the victim
  tier, and reclaim at equal priority).

Usage is charged from the same pod annotations the scheduler cache
rebuilds from on restart, so no state is added.
"""

from tpushare_torch.quota.config import QuotaConfig, TenantQuota, parse_configmap
from tpushare_torch.quota.manager import QuotaManager

__all__ = ["QuotaConfig", "QuotaManager", "TenantQuota", "parse_configmap"]
