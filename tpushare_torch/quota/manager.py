"""Per-tenant usage ledger + arbitration queries.

The port's copy of ``tpushare/quota/manager.py``, with a plain
``threading.RLock`` where the reference has its tracing lock.

The manager is a pure in-memory view: every charge comes from the
scheduler cache's pod add/remove path, which itself is rebuilt from pod
annotations on restart — so tenant usage survives a crash the same way
the chip ledger does, with no database (the annotation-ledger discipline
of the whole system).

Accounting model (one dimension per request type, so the filter-time
admission check and the bind-time charge can never disagree):

* HBM-slice pods charge their granted ``tpushare.io/hbm-pod`` GiB
  (requested GiB before a grant exists) against the tenant's HBM quota.
* Whole-chip pods charge their granted chip count against the tenant's
  chip quota.

A pod is **borrowed** when its tenant's remaining usage would still
cover the guarantee without it — i.e. the pod sits entirely in
beyond-guarantee territory, so evicting it cannot cut into what the
tenant is owed. That is the reclaim tier preemption drains first.
"""

from __future__ import annotations

import logging
import threading

from tpushare_torch.api.objects import Pod
from tpushare_torch.quota import config as quota_config
from tpushare_torch.utils import pod as podutils

log = logging.getLogger(__name__)

#: (hbm GiB, chips) demand pair.
Demand = tuple[int, int]


class QuotaManager:
    """Thread-safe tenant ledger over the annotation truth."""

    def __init__(self,
                 config: quota_config.QuotaConfig | None = None) -> None:
        self._lock = threading.RLock()
        #: uid -> (tenant, hbm GiB, chips) currently charged
        self._pods: dict[str, tuple[str, int, int]] = {}
        #: tenant -> (hbm GiB, chips, pod count)
        self._usage: dict[str, tuple[int, int, int]] = {}
        with self._lock:
            self._config = config or quota_config.EMPTY

    # ------------------------------------------------------------------ #
    # Configuration (fed by the controller's ConfigMap handler)
    # ------------------------------------------------------------------ #

    def set_config(self, config: quota_config.QuotaConfig) -> None:
        with self._lock:
            self._config = config
        log.info("quota config applied: %d tenant spec(s)%s",
                 len(config.tenants),
                 "" if config.default is quota_config.UNLIMITED
                 else " + default")

    def config_for(self, tenant: str) -> quota_config.TenantQuota:
        with self._lock:
            return self._config.for_tenant(tenant)

    def configured(self, tenant: str) -> bool:
        with self._lock:
            return self._config.configured(tenant)

    # ------------------------------------------------------------------ #
    # Tenant resolution and demand pricing
    # ------------------------------------------------------------------ #

    @staticmethod
    def tenant_of(pod: Pod) -> str:
        return podutils.get_tenant(pod)

    @staticmethod
    def requested_demand(pod: Pod) -> Demand:
        """(hbm, chips) the pod ASKS for — the filter-time measure."""
        chips = podutils.get_chips_from_pod_resource(pod)
        if chips > 0:
            return 0, chips
        return podutils.get_hbm_from_pod_resource(pod), 0

    @staticmethod
    def granted_demand(pod: Pod) -> Demand:
        """(hbm, chips) the pod HOLDS per its bind annotations — the
        ledger-charge measure; falls back to the request for a pod whose
        grant is still being written."""
        if podutils.get_chips_from_pod_resource(pod) > 0:
            chips = len(podutils.get_chip_ids_from_annotation(pod))
            return 0, chips or podutils.get_chips_from_pod_resource(pod)
        hbm = podutils.get_hbm_from_pod_annotation(pod)
        return (hbm or podutils.get_hbm_from_pod_resource(pod)), 0

    # ------------------------------------------------------------------ #
    # The ledger (driven by SchedulerCache add/remove — restart-safe)
    # ------------------------------------------------------------------ #

    def charge(self, pod: Pod) -> None:
        """Record ``pod``'s grant against its tenant. Idempotent per uid
        and self-correcting on re-adds (a phase change to complete
        un-charges; a re-priced grant replaces the old charge)."""
        if podutils.is_complete_pod(pod):
            self.uncharge(pod)
            return
        tenant = self.tenant_of(pod)
        hbm, chips = self.granted_demand(pod)
        with self._lock:
            if self._pods.get(pod.uid) == (tenant, hbm, chips):
                return
            self._charge_locked(pod.uid, tenant, hbm, chips)

    def _charge_locked(self, uid: str, tenant: str, hbm: int,
                       chips: int) -> None:
        """Replace ``uid``'s ledger entry with (tenant, hbm, chips) —
        the ONE bookkeeping body behind both :meth:`charge` and
        :meth:`admit_and_reserve` (re-entrant: callers hold the
        lock)."""
        with self._lock:
            old = self._pods.get(uid)
            if old is not None:
                self._drop(uid, old)
            self._pods[uid] = (tenant, hbm, chips)
            used_h, used_c, count = self._usage.get(tenant, (0, 0, 0))
            self._usage[tenant] = (used_h + hbm, used_c + chips, count + 1)

    def uncharge(self, pod: Pod) -> None:
        with self._lock:
            entry = self._pods.pop(pod.uid, None)
            if entry is not None:
                self._drop(pod.uid, entry)

    def _drop(self, uid: str, entry: tuple[str, int, int]) -> None:
        """Subtract one charge from its tenant (re-entrant: callers
        already hold the ledger lock)."""
        with self._lock:
            tenant, hbm, chips = entry
            used_h, used_c, count = self._usage.get(tenant, (0, 0, 0))
            remaining = (max(used_h - hbm, 0), max(used_c - chips, 0),
                         max(count - 1, 0))
            if remaining == (0, 0, 0):
                self._usage.pop(tenant, None)
            else:
                self._usage[tenant] = remaining

    def usage(self, tenant: str) -> tuple[int, int, int]:
        """(hbm GiB, chips, pod count) currently charged to ``tenant``."""
        with self._lock:
            return self._usage.get(tenant, (0, 0, 0))

    # ------------------------------------------------------------------ #
    # Admission: the hard limit
    # ------------------------------------------------------------------ #

    def admit(self, pod: Pod, count: int = 1) -> tuple[bool, str]:
        """Would placing ``count`` copies of ``pod`` keep its tenant at
        or under its hard limit? Returns (ok, quota-denial reason). A
        pod already charged (bind retry, reserved gang member) is not
        double-counted against itself."""
        tenant = self.tenant_of(pod)
        hbm, chips = self.requested_demand(pod)
        with self._lock:
            quota = self._config.for_tenant(tenant)
            used_h, used_c, _ = self._usage.get(tenant, (0, 0, 0))
            own = self._pods.get(pod.uid)
        if own is not None and own[0] == tenant:
            used_h = max(used_h - own[1], 0)
            used_c = max(used_c - own[2], 0)
        if (quota.limit_hbm is not None and hbm > 0
                and used_h + hbm * count > quota.limit_hbm):
            return False, (
                f"quota: tenant {tenant} over HBM limit — {used_h} GiB "
                f"used + {hbm * count} GiB requested > limit "
                f"{quota.limit_hbm} GiB")
        if (quota.limit_chips is not None and chips > 0
                and used_c + chips * count > quota.limit_chips):
            return False, (
                f"quota: tenant {tenant} over chip limit — {used_c} "
                f"chip(s) used + {chips * count} requested > limit "
                f"{quota.limit_chips}")
        return True, ""

    def admit_and_reserve(self, pod: Pod) -> tuple[bool, str]:
        """Atomic :meth:`admit` + provisional charge of the pod's
        REQUESTED demand, under one lock acquisition — the bind-time
        gate. A bare check-then-charge lets two same-tenant binds on
        concurrent HTTP threads both pass ``admit`` before either
        charge lands, slipping the tenant past its hard limit.

        The provisional entry is keyed by uid like any charge, so the
        cache's post-placement :meth:`charge` simply replaces it with
        the granted amounts. A placement that FAILS after reserving
        (allocation error, apiserver failure) must be released by the
        caller (``Bind.handle`` does, via :meth:`uncharge`, when the
        cache never took ownership of the pod)."""
        tenant = self.tenant_of(pod)
        hbm, chips = self.requested_demand(pod)
        with self._lock:
            ok, reason = self.admit(pod)
            if not ok:
                return ok, reason
            self._charge_locked(pod.uid, tenant, hbm, chips)
        return True, ""

    # ------------------------------------------------------------------ #
    # Borrowing and fair-share reclaim
    # ------------------------------------------------------------------ #

    def is_borrowed(self, pod: Pod) -> bool:
        """Is ``pod`` held entirely beyond its tenant's guarantee?
        True exactly when evicting it cannot cut into owed capacity:
        the tenant's usage minus this pod still covers the guarantee.
        Tenants with no quota spec at all are never 'borrowing' — the
        reclaim tier must not reorder eviction in a quota-free fleet."""
        with self._lock:
            entry = self._pods.get(pod.uid)
            if entry is None:
                return False
            tenant, hbm, chips = entry
            if not self._config.configured(tenant):
                return False
            quota = self._config.for_tenant(tenant)
            used_h, used_c, _ = self._usage.get(tenant, (0, 0, 0))
        if hbm > 0:
            return used_h - hbm >= (quota.guarantee_hbm or 0)
        if chips > 0:
            return used_c - chips >= (quota.guarantee_chips or 0)
        return False

    def under_guarantee(self, pod: Pod) -> bool:
        """Would ``pod`` fit entirely inside its tenant's guaranteed
        share? This is the entitlement that justifies reclaim: a tenant
        asking only for what it is owed may displace borrowers."""
        tenant = self.tenant_of(pod)
        hbm, chips = self.requested_demand(pod)
        with self._lock:
            if not self._config.configured(tenant):
                return False
            quota = self._config.for_tenant(tenant)
            used_h, used_c, _ = self._usage.get(tenant, (0, 0, 0))
            own = self._pods.get(pod.uid)
        if own is not None and own[0] == tenant:
            used_h = max(used_h - own[1], 0)
            used_c = max(used_c - own[2], 0)
        if hbm > 0:
            return (quota.guarantee_hbm is not None
                    and used_h + hbm <= quota.guarantee_hbm)
        if chips > 0:
            return (quota.guarantee_chips is not None
                    and used_c + chips <= quota.guarantee_chips)
        return False

    def reclaimable_excess(self, tenant: str) -> Demand:
        """(hbm GiB, chips) the tenant currently holds BEYOND its
        guarantee — the most one fair-share reclaim plan may take from
        it. Per-victim ``is_borrowed`` is not enough on its own: each
        of two 16-GiB pods over a 16-GiB guarantee is individually
        borrowed, but evicting both cuts into owed capacity — the preempt
        verb caps the per-tenant reclaim total with this number.
        (0, 0) for unconfigured tenants."""
        with self._lock:
            if not self._config.configured(tenant):
                return 0, 0
            quota = self._config.for_tenant(tenant)
            used_h, used_c, _ = self._usage.get(tenant, (0, 0, 0))
        return (max(used_h - (quota.guarantee_hbm or 0), 0),
                max(used_c - (quota.guarantee_chips or 0), 0))

    def reclaim_eligible(self, preemptor: Pod, victim: Pod) -> bool:
        """May ``preemptor`` evict ``victim`` at EQUAL priority? Only
        for fair-share reclaim: the preemptor's tenant is asking within
        its guarantee, the victim sits wholly in borrowed territory,
        and they are different tenants (a tenant cannot reclaim from
        itself — its own borrowing is its own scheduling choice)."""
        if self.tenant_of(victim) == self.tenant_of(preemptor):
            return False
        return self.is_borrowed(victim) and self.under_guarantee(preemptor)

    def score_adjust(self, pod: Pod) -> int:
        """Fair-share bias for the prioritize verb's scores: +1 while
        the pod's tenant is asking within its guarantee (least-served
        tenants win ties), -1 once the tenant is already borrowing
        beyond it, 0 for unconfigured tenants."""
        tenant = self.tenant_of(pod)
        with self._lock:
            if not self._config.configured(tenant):
                return 0
            quota = self._config.for_tenant(tenant)
            used_h, used_c, _ = self._usage.get(tenant, (0, 0, 0))
        if self.under_guarantee(pod):
            return 1
        hbm, chips = self.requested_demand(pod)
        if hbm > 0 and used_h >= (quota.guarantee_hbm or 0):
            return -1
        if chips > 0 and used_c >= (quota.guarantee_chips or 0):
            return -1
        return 0

    @staticmethod
    def _dominant(quota: quota_config.TenantQuota, used_h: int,
                  used_c: int) -> float:
        ratios = []
        if quota.guarantee_hbm:
            ratios.append(used_h / quota.guarantee_hbm)
        if quota.guarantee_chips:
            ratios.append(used_c / quota.guarantee_chips)
        return round(max(ratios), 4) if ratios else 0.0

    def dominant_share(self, tenant: str) -> float:
        """Dominant-resource usage/guarantee ratio (DRF): the max over
        dimensions of used/guarantee. 0.0 when nothing is guaranteed to
        the tenant (its 'share' of owed capacity is undefined) — the
        operator-facing fairness number in /debug/quota."""
        with self._lock:
            quota = self._config.for_tenant(tenant)
            used_h, used_c, _ = self._usage.get(tenant, (0, 0, 0))
        return self._dominant(quota, used_h, used_c)

    # ------------------------------------------------------------------ #
    # Observability (metrics scrape + GET /debug/quota)
    # ------------------------------------------------------------------ #

    def snapshot(self) -> list[dict]:
        """Per-tenant view: spec, usage, and how much of the usage is
        borrowed beyond the guarantee. Covers every tenant with usage
        OR a spec, sorted by name."""
        with self._lock:
            config = self._config
            usage = dict(self._usage)
        tenants = sorted(set(usage) | set(config.tenants))
        out = []
        for tenant in tenants:
            quota = config.for_tenant(tenant)
            used_h, used_c, count = usage.get(tenant, (0, 0, 0))
            configured = config.configured(tenant)
            entry: dict = {
                "tenant": tenant,
                "usedHBM": used_h,
                "usedChips": used_c,
                "pods": count,
                "configured": configured,
                "borrowedHBM": (max(used_h - (quota.guarantee_hbm or 0), 0)
                                if configured else 0),
                "borrowedChips": (
                    max(used_c - (quota.guarantee_chips or 0), 0)
                    if configured else 0),
                # From the COPIED usage, not a live re-read: every field
                # of a row must describe one ledger moment.
                "dominantShare": self._dominant(quota, used_h, used_c),
            }
            for key, val in (("guaranteeHBM", quota.guarantee_hbm),
                             ("limitHBM", quota.limit_hbm),
                             ("guaranteeChips", quota.guarantee_chips),
                             ("limitChips", quota.limit_chips)):
                if val is not None:
                    entry[key] = val
            out.append(entry)
        return out
