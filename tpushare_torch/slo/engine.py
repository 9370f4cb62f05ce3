"""SLO engine: error budgets and multi-window burn-rate alerting.

The port's copy of ``tpushare/slo/engine.py``.

Objectives (:mod:`tpushare_torch.slo.config`) are evaluated over rolling 5m
and 1h windows of good/bad events:

* an event's *badness* is decided at intake (journey closed late, a
  filter call over threshold);
* ``burn rate`` per window = (bad/total) / (1 - objective) — 1.0 means
  the budget burns exactly as fast as the objective allows, 14.4 (the
  default ``fastBurn``) means the month's budget would be gone in ~2
  days;
* ``error budget remaining`` over the 1h window = 1 - bad/(total ×
  (1 - objective)), clamped to [0, 1].

When BOTH windows burn at ≥ ``fastBurn`` (the SRE-workbook multi-window
rule: the short window proves it is still happening, the long window
proves it is not a blip), the engine emits one rate-limited
``TPUShareSLOBurn`` Event (attached to the most recent bad pod, so
``kubectl describe`` lands the operator on a concrete victim) plus a
structured JSON log line. The gauges
``tpushare_slo_error_budget_remaining{slo}`` and
``tpushare_slo_burn_rate{slo,window}`` are refreshed by every
``/metrics`` scrape via :func:`tpushare_torch.routes.metrics.scrape`.

Evaluation is pull-driven (scrape, ``/debug/slo``) and cheap: each SLO
keeps one bounded deque of (timestamp, good) events, pruned to the
longest window as it is read.
"""

from __future__ import annotations

import json
import logging
import time
from collections import deque
from typing import Callable

from tpushare_torch import obs
from tpushare_torch.api.objects import Pod
from tpushare_torch.slo import config as slo_config
from tpushare_torch.trace.recorder import DropCounter
from tpushare_torch.utils import locks

log = logging.getLogger(__name__)

#: (label, seconds) evaluation windows, short first. The pair is the
#: alert contract: fast-burn requires BOTH to exceed the threshold.
WINDOWS: tuple[tuple[str, float], ...] = (("5m", 300.0), ("1h", 3600.0))

#: Seconds between TPUShareSLOBurn Events per SLO. The burn gauge
#: carries the continuous signal; the Event is the page.
BURN_EVENT_INTERVAL_S = 600.0

#: Cap on retained events per SLO — at webhook rates an hour of filter
#: calls can outgrow memory; beyond this the oldest events age out
#: early, which only makes the windows conservative (fewer samples).
MAX_EVENTS = 65536


class SLOEngine:
    """Windowed good/bad accounting per declared SLO."""

    def __init__(self, config: slo_config.SLOConfig | None = None,
                 now_fn: Callable[[], float] = time.time) -> None:
        self._lock = locks.TracingRLock("slo/engine")
        self._now = now_fn
        self._client: object | None = None
        with self._lock:
            self._config = config or slo_config.DEFAULTS
        #: SLO name -> deque[(epoch seconds, good)]
        self._events: dict[str, deque[tuple[float, bool]]] = \
            locks.guarded_dict(self._lock, "SLOEngine._events")
        #: SLO name -> monotonic-ish stamp of its last burn Event.
        self._burn_event_at: dict[str, float] = locks.guarded_dict(
            self._lock, "SLOEngine._burn_event_at")
        #: (ns, name, uid) of the most recent bad pod-journey — the
        #: involved object a burn Event attaches to.
        self._last_bad_pod: tuple[str, str, str] | None = None
        self.drops = DropCounter()

    # -- configuration ---------------------------------------------------- #

    def set_config(self, config: slo_config.SLOConfig) -> None:
        with self._lock:
            self._config = config
            stale = set(self._events) - set(config.slos)
            for name in stale:
                del self._events[name]
        log.info("SLO config applied: %d objective(s): %s",
                 len(config.slos), sorted(config.slos))
        obs.mark("config",
                 f"SLO config applied: {len(config.slos)} objective(s)",
                 configmap="slo",
                 objectives=",".join(sorted(config.slos)))

    def set_client(self, client: object) -> None:
        """Arm Event emission (without a client the burn alert is gauge
        + log only)."""
        with self._lock:
            self._client = client

    def config(self) -> slo_config.SLOConfig:
        with self._lock:
            return self._config

    # -- intake ------------------------------------------------------------ #

    def _record(self, name: str, good: bool) -> None:
        with self._lock:
            series = self._events.get(name)
            if series is None:
                series = deque(maxlen=MAX_EVENTS)
                self._events[name] = series
            series.append((self._now(), good))

    def observe_pod_e2e(self, seconds: float, outcome: str, namespace: str,
                        name: str, uid: str) -> None:
        """One closed journey. *Good* = bound within threshold. A
        journey that ended ``deleted``/``abandoned`` counts as bad only
        when it had already outlived the threshold — a user withdrawing
        a pod early is not the scheduler's miss."""
        try:
            for spec in self.config().slos.values():
                if spec.signal != "pod_e2e":
                    continue
                if outcome == "bound":
                    good = seconds <= spec.threshold_seconds
                elif seconds > spec.threshold_seconds:
                    good = False
                else:
                    continue
                self._record(spec.name, good)
                if not good:
                    with self._lock:
                        self._last_bad_pod = (namespace, name, uid)
        except Exception:  # noqa: BLE001 - telemetry must not throw
            self.drops.inc()

    def observe_filter(self, seconds: float) -> None:
        """One filter verb round-trip (TPU pods only — the pass-through
        path for non-TPU pods is not part of the objective)."""
        try:
            for spec in self.config().slos.values():
                if spec.signal == "filter_latency":
                    self._record(spec.name,
                                 seconds <= spec.threshold_seconds)
        except Exception:  # noqa: BLE001 - telemetry must not throw
            self.drops.inc()

    # -- evaluation -------------------------------------------------------- #

    def _window_counts(self, name: str,
                       now: float) -> dict[str, tuple[int, int]]:
        """window label -> (bad, total); prunes events older than the
        longest window as a side effect."""
        horizon = now - max(seconds for _, seconds in WINDOWS)
        with self._lock:
            series = self._events.get(name)
            if series is None:
                return {label: (0, 0) for label, _ in WINDOWS}
            while series and series[0][0] < horizon:
                series.popleft()
            events = list(series)
        out: dict[str, tuple[int, int]] = {}
        for label, seconds in WINDOWS:
            cut = now - seconds
            bad = total = 0
            for stamp, good in events:
                if stamp >= cut:
                    total += 1
                    if not good:
                        bad += 1
            out[label] = (bad, total)
        return out

    def evaluate(self) -> list[dict]:
        """Per-SLO budget/burn view; fires the (rate-limited) burn
        alert for any SLO whose every window exceeds its fastBurn."""
        now = self._now()
        rows: list[dict] = []
        for spec in sorted(self.config().slos.values(),
                           key=lambda s: s.name):
            allowed = 1.0 - spec.objective
            counts = self._window_counts(spec.name, now)
            windows: dict[str, dict] = {}
            burns: list[float] = []
            for label, _seconds in WINDOWS:
                bad, total = counts[label]
                burn = (bad / total) / allowed if total else 0.0
                burns.append(burn)
                windows[label] = {"bad": bad, "total": total,
                                  "burnRate": round(burn, 3)}
            long_label = WINDOWS[-1][0]
            bad, total = counts[long_label]
            consumed = (bad / (total * allowed)) if total else 0.0
            remaining = max(1.0 - consumed, 0.0)
            burning = bool(burns) and all(b >= spec.fast_burn
                                          for b in burns) \
                and any(counts[label][1] > 0 for label, _ in WINDOWS)
            row = {
                "slo": spec.name,
                "signal": spec.signal,
                "objective": spec.objective,
                "thresholdSeconds": spec.threshold_seconds,
                "fastBurn": spec.fast_burn,
                "errorBudgetRemaining": round(remaining, 4),
                "windows": windows,
                "burning": burning,
            }
            rows.append(row)
            if burning:
                self._alert(spec, row, now)
        return rows

    # -- alerting ---------------------------------------------------------- #

    def _alert(self, spec: slo_config.SLOSpec, row: dict,
               now: float) -> None:
        with self._lock:
            last = self._burn_event_at.get(spec.name, 0.0)
            due = now - last >= BURN_EVENT_INTERVAL_S
            if due:
                self._burn_event_at[spec.name] = now
            client = self._client
            bad_pod = self._last_bad_pod
        payload = {
            "alert": "TPUShareSLOBurn",
            "slo": spec.name,
            "signal": spec.signal,
            "fastBurn": spec.fast_burn,
            "burnRates": {label: w["burnRate"]
                          for label, w in row["windows"].items()},
            "errorBudgetRemaining": row["errorBudgetRemaining"],
        }
        if not due:
            log.debug("SLO %s still burning (event rate-limited): %s",
                      spec.name, json.dumps(payload))
            return
        # The JSON log line of the alert contract: grep-able whether or
        # not TPUSHARE_LOG_JSON is on.
        log.warning("SLO burn: %s", json.dumps(payload, sort_keys=True))
        # Timeline marker (fire-and-forget): the burn joins the series
        # on the fleet clock, and its cursor rides in the Event message
        # so `kubectl describe` resolves to /debug/timeline state at
        # the moment the budget tripped.
        cursor = obs.mark(
            "slo-burn",
            f"SLO {spec.name} burning "
            f"({row['errorBudgetRemaining'] * 100:.1f}% budget left)",
            slo=spec.name, signal=spec.signal)
        if client is None or bad_pod is None:
            return
        try:
            from tpushare_torch.k8s import events
            ns, name, uid = bad_pod
            pod = Pod({"metadata": {"name": name, "namespace": ns,
                                    "uid": uid}})
            events.record(
                client, pod, events.REASON_SLO_BURN,
                f"SLO {spec.name} burning: "
                + ", ".join(f"{label}={w['burnRate']}x"
                            for label, w in row["windows"].items())
                + f" >= fast-burn {spec.fast_burn}x; error budget "
                  f"{row['errorBudgetRemaining'] * 100:.1f}% remaining "
                  "(see /debug/slo and docs/slo.md runbook)"
                + (f" [timeline {cursor}]" if cursor else ""),
                event_type="Warning", trace_id="")
        except Exception:  # noqa: BLE001 - alerting must not throw
            self.drops.inc()

    # -- lifecycle --------------------------------------------------------- #

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._burn_event_at.clear()
            self._last_bad_pod = None
            self._config = slo_config.DEFAULTS
            # Disarm Event emission too: a reset promises a clean
            # slate, and a stale client would both pin the old
            # ApiClient alive and emit alerts into a dead harness.
            self._client = None
            self.drops = DropCounter()
