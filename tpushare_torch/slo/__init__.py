"""tpushare_torch.slo — pod-journey SLOs, module-level face.

The port's copy of ``tpushare/slo/__init__.py``.

One process-wide :class:`~tpushare_torch.slo.journey.JourneyTracker` and
:class:`~tpushare_torch.slo.engine.SLOEngine` (module singletons, like
:mod:`tpushare_torch.trace`'s recorder) so the routes layer, the controller,
and the metrics scrape all reach the same journey table and budget
windows without constructor plumbing. The tracker's close path feeds
the engine automatically.

Usage map:

* routes link attempts:   ``slo.note_decision(ns, name, uid, dec, pod)``
* routes time the filter: ``slo.observe_filter(seconds)``
* controller opens:       ``slo.tracker().open_journey(pod)``
* controller closes:      ``slo.tracker().pod_bound(pod)`` /
  ``pod_deleted(pod)`` (bound also reconstructs after a restart)
* the scrape evaluates:   ``slo.engine().evaluate()`` → gauges + alert
* debug surfaces:         ``slo.get_journey(ns, pod)``, ``slo.snapshot()``

See docs/slo.md for the objective format and the burn-rate runbook.
"""

from __future__ import annotations

from tpushare_torch.api.objects import Pod
from tpushare_torch.slo import config
from tpushare_torch.slo.engine import SLOEngine
from tpushare_torch.slo.journey import Journey, JourneyTracker
from tpushare_torch.trace.recorder import Decision

__all__ = [
    "Journey", "JourneyTracker", "SLOEngine", "config", "engine",
    "get_journey", "note_decision", "observe_filter", "reset",
    "snapshot", "tracker",
]

_engine = SLOEngine()


def _feed_engine(journey: Journey) -> None:
    _engine.observe_pod_e2e(journey.e2e_seconds(journey.closed_at),
                            journey.outcome, journey.namespace,
                            journey.name, journey.uid)


_tracker = JourneyTracker(on_close=_feed_engine)


def tracker() -> JourneyTracker:
    return _tracker


def engine() -> SLOEngine:
    return _engine


def note_decision(namespace: str, name: str, uid: str,
                  dec: Decision | None, pod: Pod | None = None,
                  open_new: bool = True) -> None:
    _tracker.note_decision(namespace, name, uid, dec, pod=pod,
                           open_new=open_new)


def observe_filter(seconds: float) -> None:
    _engine.observe_filter(seconds)


def get_journey(namespace: str, name: str) -> dict | None:
    return _tracker.get_journey(namespace, name)


def snapshot() -> dict:
    """The ``/debug/slo`` document: objectives + journey aggregates +
    the recording-drop counters (the flight recorder surfaces its
    drops the same way — silent telemetry loss is the one failure this
    whole layer exists to prevent)."""
    return {"slos": _engine.evaluate(),
            "journeys": _tracker.stats(),
            "recordingDrops": {"journeys": _tracker.drops.value,
                               "engine": _engine.drops.value}}


def reset() -> None:
    """Drop every journey and budget window (tests)."""
    _tracker.reset()
    _engine.reset()
