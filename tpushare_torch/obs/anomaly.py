"""Anomaly watchers: declarative rules over the timeline rings.

The port's copy of ``tpushare/obs/anomaly.py``. ``stranded-hbm-high``
reads ``cluster_stranded_hbm_gib``, which the defrag executor's frag
index feeds (``sources.stranded_source``).

A :class:`Rule` names a series and a detector:

* ``threshold`` — the latest sample crosses ``limit``;
* ``roc`` — rate of change: ``latest - oldest`` over the rule window
  crosses ``limit``;
* ``zscore`` — the latest sample sits ``limit`` standard deviations
  above the rolling window mean (needs ``min_points`` history, skips
  degenerate windows where stddev ~ 0).

Rules are evaluated on the sampler tick (the engine registers itself
as a tick hook), so detection latency is one sampler interval. A
firing rule:

1. bumps its monotonic fired counter (scraped as
   ``tpushare_anomaly_fired_total{rule}``),
2. stamps an ``anomaly`` marker onto the timeline (so the renderers
   draw it in the marker lane), and
3. emits one rate-limited ``TPUShareAnomaly`` Event carrying the
   marker's cursor as ``[timeline <cursor>]`` — the operator's jump
   link from ``kubectl describe`` into ``/debug/timeline``.

Like the SLO engine's burn alert, the Event is the page and the
counter is the continuous signal; ``cooldown_s`` keeps a persistently
anomalous series from flooding the apiserver.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable

from tpushare_torch.api.objects import Pod
from tpushare_torch.obs.timeline import TimelineRecorder
from tpushare_torch.trace.recorder import DropCounter
from tpushare_torch.utils import locks

#: Seconds between Events per rule. The marker + counter fire every
#: evaluation; the Event is rate-limited like TPUShareSLOBurn.
ANOMALY_EVENT_INTERVAL_S = 300.0


class Rule:
    """One declarative watcher over one timeline series."""

    __slots__ = ("name", "series", "kind", "limit", "window_s",
                 "min_points", "cooldown_s")

    def __init__(self, name: str, series: str, kind: str, limit: float,
                 window_s: float = 120.0, min_points: int = 10,
                 cooldown_s: float = ANOMALY_EVENT_INTERVAL_S) -> None:
        if kind not in ("threshold", "roc", "zscore"):
            raise ValueError(f"unknown rule kind {kind!r}")
        self.name = name
        self.series = series
        self.kind = kind
        self.limit = limit
        self.window_s = window_s
        self.min_points = min_points
        self.cooldown_s = cooldown_s

    def evaluate(self, points: list[tuple[float, float]],
                 now: float) -> str | None:
        """Detail string when firing, None otherwise."""
        window = [(ts, v) for ts, v in points if ts >= now - self.window_s]
        if not window:
            return None
        latest = window[-1][1]
        if self.kind == "threshold":
            if latest > self.limit:
                return (f"{self.series}={latest:.3f} over threshold "
                        f"{self.limit:.3f}")
            return None
        if len(window) < self.min_points:
            return None
        if self.kind == "roc":
            delta = latest - window[0][1]
            if delta > self.limit:
                return (f"{self.series} rose {delta:.3f} in "
                        f"{self.window_s:.0f}s (limit {self.limit:.3f})")
            return None
        values = [v for _ts, v in window[:-1]]
        mean = sum(values) / len(values)
        variance = sum((v - mean) ** 2 for v in values) / len(values)
        stddev = math.sqrt(variance)
        if stddev < 1e-9:
            return None
        z = (latest - mean) / stddev
        if z > self.limit:
            return (f"{self.series}={latest:.3f} is {z:.1f} sigma over "
                    f"the {self.window_s:.0f}s mean {mean:.3f}")
        return None


#: The stock fleet watch: verb tail latency, unplaceable demand
#: growth, stranded-HBM pressure. Replaceable per-engine for tests.
DEFAULT_RULES: tuple[Rule, ...] = (
    Rule("filter-p99-spike", "verb_p99_ms:filter", "zscore", 4.0),
    Rule("bind-p99-spike", "verb_p99_ms:bind", "zscore", 4.0),
    Rule("unplaceable-demand-rising", "demand_unschedulable_pods",
         "roc", 8.0),
    Rule("stranded-hbm-high", "cluster_stranded_hbm_gib", "threshold",
         64.0),
)


class AnomalyEngine:
    """Evaluates rules on the sampler tick; fires markers + Events."""

    def __init__(self, timeline: TimelineRecorder,
                 rules: tuple[Rule, ...] = DEFAULT_RULES,
                 now_fn: Callable[[], float] = time.time) -> None:
        self._lock = locks.TracingRLock("obs/anomaly")
        self._timeline = timeline
        self._now = now_fn
        with self._lock:
            self._rules: tuple[Rule, ...] = rules
        self._client: object | None = None
        #: rule name -> monotonic fired count (the scrape gauge).
        self._fired: dict[str, int] = locks.guarded_dict(
            self._lock, "AnomalyEngine._fired")
        #: rule name -> last Event emission stamp.
        self._event_at: dict[str, float] = locks.guarded_dict(
            self._lock, "AnomalyEngine._event_at")
        self.drops = DropCounter()

    def set_now(self, now_fn: Callable[[], float]) -> None:
        """Swap the engine's clock (fleet-day scenario clock; see
        :meth:`TimelineRecorder.set_now`)."""
        with self._lock:
            self._now = now_fn

    def set_client(self, client: object) -> None:
        """Arm Event emission (marker + counter fire regardless)."""
        with self._lock:
            self._client = client

    def set_rules(self, rules: tuple[Rule, ...]) -> None:
        with self._lock:
            self._rules = rules

    def rules(self) -> tuple[Rule, ...]:
        with self._lock:
            return self._rules

    # -- evaluation -------------------------------------------------------- #

    def evaluate(self, now: float | None = None) -> list[dict[str, Any]]:
        """One pass over every rule; returns the firings (tests read
        this directly; production reads the markers/Events)."""
        if now is None:
            now = self._now()
        firings: list[dict[str, Any]] = []
        snap = self._timeline.snapshot(markers=False)
        for rule in self.rules():
            try:
                doc = snap["series"].get(rule.series)
                points = [(ts, v) for ts, v in doc["tier0"]] \
                    if doc else []
                detail = rule.evaluate(points, now)
            except Exception:  # noqa: BLE001 - a bad rule must not stop the rest
                self.drops.inc()
                continue
            if detail is None:
                continue
            firings.append(self._fire(rule, detail, now))
        return firings

    def _fire(self, rule: Rule, detail: str, now: float) -> dict[str, Any]:
        with self._lock:
            self._fired[rule.name] = self._fired.get(rule.name, 0) + 1
            last = self._event_at.get(rule.name, 0.0)
            due = now - last >= rule.cooldown_s
            if due:
                self._event_at[rule.name] = now
            client = self._client
        try:
            cursor = self._timeline.mark(
                "anomaly", f"{rule.name}: {detail}",
                attrs={"rule": rule.name, "series": rule.series},
                ts=now)
        except Exception:  # noqa: BLE001 - marking must not stop detection
            self._timeline.mark_drops.inc()
            cursor = 0
        if due and client is not None:
            self._emit_event(client, rule, detail, cursor)
        return {"rule": rule.name, "series": rule.series,
                "detail": detail, "cursor": cursor, "event": due}

    def _emit_event(self, client: object, rule: Rule, detail: str,
                    cursor: int) -> None:
        try:
            from tpushare_torch.k8s import events
            pod = Pod({"metadata": {"name": "tpushare-scheduler-extender",
                                    "namespace": "kube-system",
                                    "uid": ""}})
            events.record(
                client, pod, events.REASON_ANOMALY,
                f"anomaly {rule.name}: {detail} "
                f"(see /debug/timeline and docs/observability.md) "
                f"[timeline {cursor}]",
                event_type="Warning", trace_id="")
        except Exception:  # noqa: BLE001 - alerting must not throw
            self.drops.inc()

    # -- reads ------------------------------------------------------------- #

    def fired_counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._fired)

    def reset(self) -> None:
        with self._lock:
            self._fired.clear()
            self._event_at.clear()
            self._client = None
            self._rules = DEFAULT_RULES
            self.drops = DropCounter()
