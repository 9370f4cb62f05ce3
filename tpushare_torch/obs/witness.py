"""FleetDayWitness: conformance engine for the fleet-day gate.

The port's copy of ``tpushare/obs/witness.py``. The fleet-day replay that
drives it (the twin of ``tools/simulate.py``, over the port's autoscaler
and serving router) is not ported yet.

Every other obs module *produces* telemetry; this one puts the
telemetry itself under test. The fleet-day scenario injects a known
schedule of fleet events (a quota ConfigMap apply, a request surge, a
NotReady host, a defrag wave, autoscale up and down) and for each one
declares an :class:`Expectation`: the marker kind that must appear,
optionally an Event reason and a metric delta, and a conformance
window in compressed seconds. The witness taps the marker intake
(``obs.mark`` feeds :meth:`observe_marker` while armed), is fed the
apiserver Event list at poll points (:meth:`observe_events`), and at
end of day :meth:`evaluate` joins schedule against observations into a
per-event verdict:

* **matched** — every declared leg (marker, Event, metric) surfaced
  inside ``[injected, injected + window]``;
* **late** — all legs present, but the marker landed past the window;
* **missing** — at least one declared leg never surfaced (the page
  that would not have fired);
* **spurious** — an observed marker of a witnessed kind that no
  expectation's window explains (the page that fired for nothing).

Monotonic verdict totals feed the ``tpushare_witness_events_*_total``
scrape gauges; the full report renders in ``/debug/fleetday`` and the
simulate/bench verdict tables. Legs are matched on the scenario
clock: marker timestamps come from the injected obs clock, metric
deltas from tier0 ring points, while Event legs are presence-checked
at poll stamps (apiserver Event timestamps are wall-clock strings and
cannot be compared against a compressed scenario clock — see
docs/observability.md §8).

Observation intakes follow the obs fire-and-forget discipline:
exceptions are swallowed into a drop counter, never the emission
site's control flow. Declaration (:meth:`expect`) and judgment
(:meth:`evaluate`) run on the scenario runner and raise loudly — a
typo'd marker kind must fail the gate's author, not silently pass.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable

from tpushare_torch.obs.timeline import MARKER_KINDS
from tpushare_torch.trace.recorder import DropCounter
from tpushare_torch.utils import locks

#: Bounded observation rings. A compressed day emits tens of markers
#: and a few hundred Events; 4096 is an order of magnitude of slack,
#: and overflow is counted, not silent.
MAX_OBSERVED = 4096

#: Default conformance window (compressed seconds): how long after the
#: injected instant a marker/metric may surface and still be on time.
DEFAULT_WINDOW_S = 30.0


class Expectation:
    """One injected event's declared observable surface."""

    __slots__ = ("event_id", "injected_ts", "kind", "detail_substr",
                 "event_reason", "metric", "metric_delta", "window_s")

    def __init__(self, event_id: str, injected_ts: float, kind: str,
                 detail_substr: str, event_reason: str | None,
                 metric: str | None, metric_delta: float,
                 window_s: float) -> None:
        self.event_id = event_id
        self.injected_ts = injected_ts
        self.kind = kind
        self.detail_substr = detail_substr
        self.event_reason = event_reason
        self.metric = metric
        self.metric_delta = metric_delta
        self.window_s = window_s

    def to_json(self) -> dict[str, Any]:
        return {"id": self.event_id, "injectedTs": round(self.injected_ts, 3),
                "kind": self.kind, "detailSubstr": self.detail_substr,
                "eventReason": self.event_reason, "metric": self.metric,
                "metricDelta": self.metric_delta,
                "windowS": self.window_s}


class FleetDayWitness:
    """Schedule of expectations + observation rings + the verdict join."""

    def __init__(self, now_fn: Callable[[], float] = time.time) -> None:
        self._lock = locks.TracingRLock("obs/witness")
        self._now = now_fn
        self._armed = False
        self._expectations: dict[str, Expectation] = locks.guarded_dict(
            self._lock, "FleetDayWitness._expectations")
        #: (kind, ts, detail, attrs) in arrival order; appended under
        #: the lock (the marker path already left the gated handlers).
        self._markers: deque[tuple[str, float, str, dict[str, str]]] = \
            deque(maxlen=MAX_OBSERVED)
        #: Event metadata.name -> (reason, message, first-poll stamp).
        self._events: dict[str, tuple[str, str, float]] = \
            locks.guarded_dict(self._lock, "FleetDayWitness._events")
        #: Monotonic verdict totals (the scrape gauges).
        self._counts: dict[str, int] = locks.guarded_dict(
            self._lock, "FleetDayWitness._counts")
        self._last_report: dict[str, Any] | None = None
        #: Swallowed exceptions on the observation intake.
        self.drops = DropCounter()

    def set_now(self, now_fn: Callable[[], float]) -> None:
        """Swap the witness clock (the fleet-day scenario clock)."""
        with self._lock:
            self._now = now_fn

    # -- arming ------------------------------------------------------------ #

    def arm(self) -> None:
        """Start observing (``obs.mark`` tees markers in while armed)."""
        with self._lock:
            self._armed = True

    def disarm(self) -> None:
        with self._lock:
            self._armed = False

    def armed(self) -> bool:
        with self._lock:
            return self._armed

    # -- the schedule ------------------------------------------------------ #

    def expect(self, event_id: str, *, kind: str, detail_substr: str = "",
               event_reason: str | None = None, metric: str | None = None,
               metric_delta: float = 0.0,
               window_s: float = DEFAULT_WINDOW_S,
               injected_ts: float | None = None) -> Expectation:
        """Declare one injected event's expected surface. Raises on a
        kind outside :data:`~tpushare_torch.obs.timeline.MARKER_KINDS` or a
        duplicate id — schedule bugs must fail the author loudly."""
        if kind not in MARKER_KINDS:
            raise ValueError(f"unknown marker kind {kind!r} "
                             f"(taxonomy: {sorted(MARKER_KINDS)})")
        with self._lock:
            if event_id in self._expectations:
                raise ValueError(f"duplicate expectation id {event_id!r}")
            if injected_ts is None:
                injected_ts = self._now()
            exp = Expectation(event_id, injected_ts, kind, detail_substr,
                              event_reason, metric, metric_delta, window_s)
            self._expectations[event_id] = exp
            return exp

    # -- observation intake (fire-and-forget) ------------------------------ #

    def observe_marker(self, kind: str, ts: float, detail: str,
                       attrs: dict[str, str]) -> None:
        """Tee from ``obs.mark`` — called after the timeline accepted
        the marker, so kinds here are always in the taxonomy."""
        try:
            with self._lock:
                if not self._armed:
                    return
                if len(self._markers) == MAX_OBSERVED:
                    self.drops.inc()
                self._markers.append((kind, ts, detail, dict(attrs)))
        except Exception:  # noqa: BLE001 - witnessing must never reach callers
            self.drops.inc()

    def observe_events(self, raw_events: list[tuple[str, dict[str, Any]]],
                       now: float | None = None) -> None:
        """Fold an apiserver Event listing (``FakeApiServer.events``
        shape: ``(namespace, event-dict)``) into the ring, deduplicated
        by metadata.name; each Event keeps its FIRST poll stamp, so an
        Event created before an expectation was injected cannot satisfy
        it later."""
        try:
            with self._lock:
                if not self._armed:
                    return
                if now is None:
                    now = self._now()
                for _ns, event in raw_events:
                    meta = event.get("metadata") or {}
                    name = str(meta.get("name", ""))
                    if not name or name in self._events:
                        continue
                    if len(self._events) >= MAX_OBSERVED:
                        self.drops.inc()
                        continue
                    self._events[name] = (str(event.get("reason", "")),
                                          str(event.get("message", "")),
                                          float(now))
        except Exception:  # noqa: BLE001 - witnessing must never reach callers
            self.drops.inc()

    # -- the verdict join --------------------------------------------------- #

    def evaluate(self, series: dict[str, Any] | None = None) \
            -> dict[str, Any]:
        """Join the schedule against the observation rings (and the
        timeline series snapshot, for metric legs) into the per-event
        verdict table. Accumulates monotonic verdict totals for the
        scrape and stores the report for ``/debug/fleetday``."""
        with self._lock:
            expectations = list(self._expectations.values())
            markers = list(self._markers)
            events = dict(self._events)

        verdicts: list[dict[str, Any]] = []
        explained: set[int] = set()
        witnessed_kinds = {exp.kind for exp in expectations}
        for exp in expectations:
            verdicts.append(self._judge(exp, markers, events, series,
                                        explained))

        spurious = [
            {"kind": kind, "ts": round(ts, 3), "detail": detail}
            for idx, (kind, ts, detail, _attrs) in enumerate(markers)
            if kind in witnessed_kinds and idx not in explained
        ]

        counts = {"matched": 0, "late": 0, "missing": 0,
                  "spurious": len(spurious)}
        for verdict in verdicts:
            counts[str(verdict["verdict"])] += 1
        total = len(verdicts)
        pct = 100.0 * counts["matched"] / total if total else 100.0
        report: dict[str, Any] = {
            "expectations": total,
            "verdicts": verdicts,
            "spurious": spurious,
            "counts": counts,
            "conformancePct": round(pct, 2),
            "pass": (counts["matched"] == total
                     and counts["spurious"] == 0),
        }
        with self._lock:
            for key, value in counts.items():
                self._counts[key] = self._counts.get(key, 0) + value
            self._last_report = report
        return report

    def _judge(self, exp: Expectation,
               markers: list[tuple[str, float, str, dict[str, str]]],
               events: dict[str, tuple[str, str, float]],
               series: dict[str, Any] | None,
               explained: set[int]) -> dict[str, Any]:
        """One expectation's verdict; marks the marker indices its
        window explains (for the spurious pass)."""
        deadline = exp.injected_ts + exp.window_s
        marker_ts: float | None = None
        for idx, (kind, ts, detail, attrs) in enumerate(markers):
            if kind != exp.kind or ts < exp.injected_ts:
                continue
            if ts <= deadline:
                explained.add(idx)
            haystack = detail + " " + " ".join(
                f"{k}={v}" for k, v in attrs.items())
            if exp.detail_substr and exp.detail_substr not in haystack:
                continue
            if marker_ts is None or ts < marker_ts:
                marker_ts = ts

        legs: dict[str, bool | None] = {
            "marker": marker_ts is not None,
            "event": None,
            "metric": None,
        }
        if exp.event_reason is not None:
            legs["event"] = any(
                reason == exp.event_reason and seen >= exp.injected_ts
                for reason, _message, seen in events.values())
        if exp.metric is not None:
            legs["metric"] = self._metric_leg(exp, series)

        if any(ok is False for ok in legs.values()):
            verdict = "missing"
        elif marker_ts is not None and marker_ts > deadline:
            verdict = "late"
        else:
            verdict = "matched"
        return {
            "id": exp.event_id,
            "kind": exp.kind,
            "injectedTs": round(exp.injected_ts, 3),
            "windowS": exp.window_s,
            "verdict": verdict,
            "markerTs": (round(marker_ts, 3)
                         if marker_ts is not None else None),
            "markerLagS": (round(marker_ts - exp.injected_ts, 3)
                           if marker_ts is not None else None),
            "legs": legs,
        }

    @staticmethod
    def _metric_leg(exp: Expectation,
                    series: dict[str, Any] | None) -> bool:
        """Did ``exp.metric`` move by ``exp.metric_delta`` (signed)
        against its pre-injection baseline inside the window? Reads
        the timeline snapshot's tier0 points on the scenario clock."""
        if series is None or exp.metric not in series:
            return False
        tier0 = [(float(ts), float(v))
                 for ts, v in series[exp.metric].get("tier0", [])]
        if not tier0:
            return False
        before = [v for ts, v in tier0 if ts <= exp.injected_ts]
        baseline = before[-1] if before else tier0[0][1]
        window = [v for ts, v in tier0
                  if exp.injected_ts <= ts
                  <= exp.injected_ts + exp.window_s]
        if not window:
            return False
        if exp.metric_delta >= 0:
            return max(window) - baseline >= exp.metric_delta
        return min(window) - baseline <= exp.metric_delta

    # -- reads -------------------------------------------------------------- #

    def counts(self) -> dict[str, int]:
        """Monotonic verdict totals across every evaluate() — the
        ``tpushare_witness_events_*_total`` scrape gauges."""
        with self._lock:
            return {"matched": self._counts.get("matched", 0),
                    "late": self._counts.get("late", 0),
                    "missing": self._counts.get("missing", 0),
                    "spurious": self._counts.get("spurious", 0)}

    def snapshot(self) -> dict[str, Any]:
        """The ``GET /debug/fleetday`` document."""
        with self._lock:
            return {
                "armed": self._armed,
                "expectations": [exp.to_json()
                                 for exp in self._expectations.values()],
                "observedMarkers": len(self._markers),
                "observedEvents": len(self._events),
                "counts": {key: self._counts.get(key, 0)
                           for key in ("matched", "late", "missing",
                                       "spurious")},
                "report": self._last_report,
                "drops": self.drops.value,
            }

    def reset(self) -> None:
        with self._lock:
            self._armed = False
            self._expectations.clear()
            self._markers.clear()
            self._events.clear()
            self._counts.clear()
            self._last_report = None
            self._now = time.time
            self.drops = DropCounter()
