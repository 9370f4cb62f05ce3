"""The apiserver's RFC-3339 timestamps, parsed in one place.

The port's copy of ``tpushare/utils/k8stime.py``. Kubernetes writes
``metadata.creationTimestamp`` and a Lease's ``renewTime`` in two shapes,
with and without fractional seconds, always in UTC ("Z").
"""

from __future__ import annotations

from datetime import datetime, timezone

#: The shape this package writes (a Lease's renewTime).
RFC3339_FRACTIONAL = "%Y-%m-%dT%H:%M:%S.%fZ"
_FORMATS = (RFC3339_FRACTIONAL, "%Y-%m-%dT%H:%M:%SZ")


def parse_rfc3339(raw: str) -> datetime | None:
    """An apiserver timestamp as an aware UTC datetime; None when absent
    or not in either shape (the caller picks its own fallback)."""
    for fmt in _FORMATS:
        try:
            return datetime.strptime(raw, fmt).replace(tzinfo=timezone.utc)
        except (ValueError, TypeError):
            continue
    return None


def parse_rfc3339_epoch(raw: str) -> float:
    """The same, as epoch seconds; 0.0 when absent or unparseable."""
    dt = parse_rfc3339(raw)
    return dt.timestamp() if dt is not None else 0.0
