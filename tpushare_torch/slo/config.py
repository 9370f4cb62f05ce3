"""SLO spec: the ``tpushare-slos`` ConfigMap format.

The port's copy of ``tpushare/slo/config.py``.

Each data key is an SLO name; each value a JSON object::

    data:
      pod-bind-30s:   '{"signal": "pod_e2e", "objective": 0.99,
                        "thresholdSeconds": 30}'
      filter-p99-5ms: '{"signal": "filter_latency", "objective": 0.99,
                        "thresholdSeconds": 0.005, "fastBurn": 14.4}'

Signals:

* ``pod_e2e`` — the user-facing number: seconds from pod creation to
  bound, per journey (:mod:`tpushare_torch.slo.journey`). An event is *good*
  when the pod bound within ``thresholdSeconds``.
* ``filter_latency`` — one filter verb round-trip; *good* when it took
  at most ``thresholdSeconds``.

``objective`` is the fraction of events that must be good (0.99 = "99%
of pods bind < 30s"); ``fastBurn`` is the burn-rate multiple at which
the ``TPUShareSLOBurn`` alert trips (default 14.4 — the SRE-workbook
fast-burn pair for 5m/1h windows: that rate exhausts ~2% of a 30-day
budget per hour).

A malformed entry is skipped with a warning — one typo must not strip
the rest of the fleet's objectives. An absent (or deleted) ConfigMap
means :data:`DEFAULTS`, so the SLO surface works out of the box.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass

from tpushare_torch.api.objects import ConfigMap

log = logging.getLogger(__name__)

#: Signals an objective may be declared over.
SIGNALS = ("pod_e2e", "filter_latency")

#: Default fast-burn threshold: the multi-window fast-burn rate from the
#: SRE workbook (5m + 1h windows both burning >= 14.4x the sustainable
#: rate pages a human).
DEFAULT_FAST_BURN = 14.4


@dataclass(frozen=True)
class SLOSpec:
    """One declared objective."""

    name: str
    signal: str
    objective: float
    threshold_seconds: float
    fast_burn: float = DEFAULT_FAST_BURN


@dataclass(frozen=True)
class SLOConfig:
    """Parsed objective table: SLO name -> spec."""

    slos: dict[str, SLOSpec]


#: Out-of-the-box objectives (an absent ConfigMap is NOT "no SLOs" —
#: a fleet with no declared objectives still gets the two signals the
#: north star cares about).
DEFAULTS = SLOConfig(slos={
    "pod-bind-30s": SLOSpec(name="pod-bind-30s", signal="pod_e2e",
                            objective=0.99, threshold_seconds=30.0),
    "filter-p99-5ms": SLOSpec(name="filter-p99-5ms",
                              signal="filter_latency",
                              objective=0.99, threshold_seconds=0.005),
})

_FIELDS = ("signal", "objective", "thresholdSeconds", "fastBurn")


def _parse_entry(name: str, raw: str) -> SLOSpec | None:
    """One data value -> SLOSpec, or None when malformed."""
    try:
        doc = json.loads(raw)
    # Not a lost observation: the skip is warned and the caller falls
    # back to a safe table — nothing to count.
    except (ValueError, TypeError):
        log.warning("SLO entry %r is not valid JSON; skipping it", name)
        return None
    if not isinstance(doc, dict):
        log.warning("SLO entry %r must be a JSON object, got %s; "
                    "skipping it", name, type(doc).__name__)
        return None
    unknown = sorted(set(doc) - set(_FIELDS))
    if unknown:
        # Fail safe, loudly (the quota parser's discipline): a typo'd
        # key silently dropped would leave the operator believing an
        # objective is tighter than the one actually evaluated.
        log.warning("SLO entry %r has unknown key(s) %s (want %s); "
                    "skipping the whole entry", name, unknown,
                    sorted(_FIELDS))
        return None
    signal = doc.get("signal")
    if signal not in SIGNALS:
        log.warning("SLO entry %r: signal %r is not one of %s; "
                    "skipping the whole entry", name, signal, SIGNALS)
        return None
    try:
        objective = float(doc.get("objective", 0.99))
        threshold = float(doc.get("thresholdSeconds", 0))
        fast_burn = float(doc.get("fastBurn", DEFAULT_FAST_BURN))
    # Same config-parse shape as above: warned skip, safe fallback.
    except (TypeError, ValueError):
        log.warning("SLO entry %r has a non-numeric field; skipping "
                    "the whole entry", name)
        return None
    if not (0.0 < objective < 1.0):
        log.warning("SLO entry %r: objective %s must sit strictly "
                    "between 0 and 1; skipping the whole entry", name,
                    objective)
        return None
    if threshold <= 0 or fast_burn <= 0:
        log.warning("SLO entry %r: thresholdSeconds/fastBurn must be "
                    "positive; skipping the whole entry", name)
        return None
    return SLOSpec(name=name, signal=signal, objective=objective,
                   threshold_seconds=threshold, fast_burn=fast_burn)


def parse_configmap(cm: ConfigMap | None) -> SLOConfig:
    """ConfigMap -> SLOConfig. None (absent/deleted) -> :data:`DEFAULTS`.
    A present ConfigMap REPLACES the defaults wholesale: declaring any
    objective means the operator owns the table."""
    if cm is None:
        return DEFAULTS
    slos: dict[str, SLOSpec] = {}
    for key, raw in sorted(cm.data.items()):
        spec = _parse_entry(key, raw)
        if spec is not None:
            slos[key] = spec
    if not slos:
        # Every entry malformed (or the map empty): the defaults are
        # strictly better than a fleet with no objectives at all.
        log.warning("tpushare-slos ConfigMap yielded no valid entries; "
                    "falling back to the built-in defaults")
        return DEFAULTS
    return SLOConfig(slos=slos)
