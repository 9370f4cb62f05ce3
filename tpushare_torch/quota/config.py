"""Quota spec: the ``tpushare-quotas`` ConfigMap format.

The port's copy of ``tpushare/quota/config.py``.

Each data key is a tenant name (or ``*`` — the default spec applied to
tenants without their own entry); each value is a JSON object::

    data:
      team-inference: '{"guaranteeHBM": 64, "limitHBM": 128}'
      team-train:     '{"guaranteeChips": 4, "limitChips": 8,
                        "guaranteeHBM": 32}'
      "*":            '{"limitHBM": 256}'

Units match the rest of the system: HBM in GiB, chips in whole chips.
Absent ``limit*`` means unlimited; absent ``guarantee*`` means the
tenant is owed nothing (all of its usage is borrowing). A malformed
entry is skipped with a warning — one tenant's typo must not strip
every other tenant's protection.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass

from tpushare_torch.api.objects import ConfigMap
from tpushare_torch.utils import const

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class TenantQuota:
    """One tenant's spec. ``None`` limit = unlimited; ``None`` guarantee
    = no owed share (every byte/chip the tenant uses is borrowed)."""

    guarantee_hbm: int | None = None
    limit_hbm: int | None = None
    guarantee_chips: int | None = None
    limit_chips: int | None = None


#: The spec applied when no ConfigMap entry covers a tenant and no
#: default ("*") entry exists: unlimited, nothing guaranteed — exactly
#: the pre-quota behavior, so an empty/absent ConfigMap is a no-op.
UNLIMITED = TenantQuota()


@dataclass(frozen=True)
class QuotaConfig:
    """Parsed quota table: tenant name -> spec, plus the default."""

    tenants: dict[str, TenantQuota]
    default: TenantQuota = UNLIMITED

    def for_tenant(self, tenant: str) -> TenantQuota:
        return self.tenants.get(tenant, self.default)

    def configured(self, tenant: str) -> bool:
        """Does any spec (own entry or default) constrain this tenant?
        Compared by VALUE, not identity: an explicit all-empty entry
        (``"{}"``) constrains nothing and must not flip the tenant into
        the everything-is-borrowed regime."""
        return self.for_tenant(tenant) != UNLIMITED


EMPTY = QuotaConfig(tenants={})

_FIELDS = {
    "guaranteeHBM": "guarantee_hbm",
    "limitHBM": "limit_hbm",
    "guaranteeChips": "guarantee_chips",
    "limitChips": "limit_chips",
}


def _parse_entry(tenant: str, raw: str) -> TenantQuota | None:
    """One data value -> TenantQuota, or None when malformed."""
    try:
        doc = json.loads(raw)
    except (ValueError, TypeError):
        log.warning("quota entry for tenant %r is not valid JSON; "
                    "skipping it", tenant)
        return None
    if not isinstance(doc, dict):
        log.warning("quota entry for tenant %r must be a JSON object, "
                    "got %s; skipping it", tenant, type(doc).__name__)
        return None
    unknown = sorted(set(doc) - set(_FIELDS))
    if unknown:
        # Fail safe, loudly: a typo'd key ("guaranteeHbm") silently
        # dropped would leave the tenant looking *configured with no
        # guarantee* — every one of its pods borrowed and first in the
        # reclaim tier, the opposite of the protection intended.
        log.warning("quota entry for tenant %r has unknown key(s) %s "
                    "(want %s); skipping the whole entry", tenant,
                    unknown, sorted(_FIELDS))
        return None
    kwargs: dict[str, int | None] = {}
    for key, field in _FIELDS.items():
        if key not in doc:
            continue
        try:
            val = int(doc[key])
        except (TypeError, ValueError):
            log.warning("quota entry for tenant %r: %s=%r is not an "
                        "integer; skipping the whole entry", tenant, key,
                        doc[key])
            return None
        if val < 0:
            log.warning("quota entry for tenant %r: %s=%d is negative; "
                        "skipping the whole entry", tenant, key, val)
            return None
        kwargs[field] = val
    for dim in ("hbm", "chips"):
        guarantee = kwargs.get(f"guarantee_{dim}")
        limit = kwargs.get(f"limit_{dim}")
        if guarantee is not None and limit is not None and guarantee > limit:
            log.warning("quota entry for tenant %r: guarantee %d exceeds "
                        "limit %d for %s; skipping the whole entry",
                        tenant, guarantee, limit, dim)
            return None
    return TenantQuota(**kwargs)


def parse_configmap(cm: ConfigMap | None) -> QuotaConfig:
    """ConfigMap -> QuotaConfig. None (deleted ConfigMap) -> EMPTY."""
    if cm is None:
        return EMPTY
    tenants: dict[str, TenantQuota] = {}
    default = UNLIMITED
    for key, raw in sorted(cm.data.items()):
        quota = _parse_entry(key, raw)
        if quota is None:
            continue
        if key == const.QUOTA_DEFAULT_KEY:
            default = quota
        else:
            tenants[key] = quota
    return QuotaConfig(tenants=tenants, default=default)
