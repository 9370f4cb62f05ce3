"""tpushare_torch.obs: retrospective observability, module-level face.

The port's copy of ``tpushare/obs/__init__.py``. One process-wide
:class:`~tpushare_torch.obs.timeline.TimelineRecorder`,
:class:`~tpushare_torch.obs.anomaly.AnomalyEngine`,
:class:`~tpushare_torch.obs.exemplars.ExemplarStore` and
:class:`~tpushare_torch.obs.witness.FleetDayWitness` (module singletons,
like :mod:`tpushare_torch.trace`'s recorder), so emission sites, the
routes layer and the tools all reach the same rings without constructor
plumbing.

* stack wiring: ``obs.wire(client=..., demand=..., workqueue=...,
  nodes=...)`` then ``obs.start()`` (no-op under ``TPUSHARE_TIMELINE=off``)
* fleet events: ``obs.mark("leader", detail, identity=...)``,
  fire-and-forget at every emission site: exceptions are swallowed into
  a drop counter, never the caller's control flow
* verb hot path: ``obs.note_verb("bind", seconds, trace_id)`` feeds the
  p99 series and files the bucket exemplar
* the metrics render: ``obs.annotate_metrics(text)`` appends the
  OpenMetrics ``# {trace_id="..."}`` exemplars
* debug surface: ``obs.snapshot(window_s=...)`` is ``/debug/timeline``
* crash forensics: ``TPUSHARE_BLACKBOX_DIR`` arms the journal;
  ``replay_startup()`` (the controller's start) replays it

``build_stack`` passes ``defrag=``, and ``serve_stack`` passes
``router=`` when it holds a serving router. See docs/observability.md for
the tier math, marker taxonomy and runbook.
"""

from __future__ import annotations

import time
from typing import Any, Callable

from tpushare_torch.obs import sources
from tpushare_torch.obs.anomaly import AnomalyEngine, Rule
from tpushare_torch.obs.blackbox import BlackboxJournal, journal_dir, replay
from tpushare_torch.obs.exemplars import ExemplarStore
from tpushare_torch.obs.export import Exporter, export_url
from tpushare_torch.obs.timeline import (MARKER_KINDS, TimelineRecorder,
                                   enabled)
from tpushare_torch.obs.witness import FleetDayWitness

__all__ = [
    "AnomalyEngine", "BlackboxJournal", "ExemplarStore", "Exporter",
    "FleetDayWitness", "MARKER_KINDS", "Rule", "TimelineRecorder",
    "anomalies", "annotate_metrics", "blackbox", "blackbox_snapshot",
    "enabled", "exemplars", "exporter", "flush_blackbox", "mark",
    "mark_drops", "note_verb", "replay_startup", "reset", "set_clock",
    "snapshot", "sources", "start", "stop", "stop_blackbox",
    "timeline", "wire", "witness",
]

_timeline = TimelineRecorder()
_anomalies = AnomalyEngine(_timeline)
_exemplars = ExemplarStore()
_witness = FleetDayWitness()
#: The observability clock. mark() stamps with this; set_clock() swaps
#: it (and the recorder/anomaly/witness clocks) for the fleet-day
#: scenario's compressed day. Always time.time outside that replay.
_clock: Callable[[], float] = time.time
#: Armed iff TPUSHARE_BLACKBOX_DIR / TPUSHARE_EXPORT_URL are set —
#: None otherwise, and every tee below checks before touching them.
_blackbox: BlackboxJournal | None = None
_exporter: Exporter | None = None
#: replay_startup() runs once per process (the restart boundary marker
#: must not multiply when Controller.start is retried in tests).
_replayed = False


def _hook_anomalies() -> None:
    _timeline.add_tick_hook(lambda now: _anomalies.evaluate(now))


_hook_anomalies()


def timeline() -> TimelineRecorder:
    return _timeline


def anomalies() -> AnomalyEngine:
    return _anomalies


def exemplars() -> ExemplarStore:
    return _exemplars


def blackbox() -> BlackboxJournal | None:
    return _blackbox


def exporter() -> Exporter | None:
    return _exporter


def witness() -> FleetDayWitness:
    return _witness


def set_clock(now_fn: Callable[[], float] | None) -> None:
    """Swap the observability clock — marker stamps, sampler ticks,
    anomaly evaluation, and the witness all read it — so the fleet-day
    scenario's compressed day lands in the tiered rings on the
    scenario clock, not wall time. ``None`` restores ``time.time``.
    Callers must restore in a finally: every other consumer of the
    rings assumes wall-clock timestamps."""
    global _clock
    _clock = now_fn if now_fn is not None else time.time
    _timeline.set_now(_clock)
    _anomalies.set_now(_clock)
    _witness.set_now(_clock)


# -- wiring ---------------------------------------------------------------- #


def wire(client: object | None = None, demand: object | None = None,
         defrag: object | None = None, workqueue: object | None = None,
         router: object | None = None,
         nodes: object | None = None) -> None:
    """Register sample sources for whatever subsystems exist (replaces
    any prior registration under the same name) and arm anomaly Event
    emission. Called from ``build_stack``; safe to call repeatedly."""
    _timeline.add_source("registry", sources.registry_source())
    if demand is not None:
        _timeline.add_source("demand", sources.demand_source(demand))
    if defrag is not None:
        _timeline.add_source("frag", sources.stranded_source(defrag))
    if workqueue is not None:
        _timeline.add_source("workqueue",
                             sources.workqueue_source(workqueue))
    if router is not None:
        _timeline.add_source("router", sources.router_source(router))
    if nodes is not None:
        _timeline.add_source("fleet", sources.fleet_source(nodes))
    if client is not None:
        _anomalies.set_client(client)


def start() -> bool:
    """Arm the background sampler (idempotent; False under the
    ``TPUSHARE_TIMELINE=off`` kill switch) and, when
    ``TPUSHARE_BLACKBOX_DIR`` / ``TPUSHARE_EXPORT_URL`` are set, the
    black-box journal and push exporter."""
    armed = _timeline.start()
    _arm_blackbox()
    return armed


def stop() -> None:
    _timeline.stop()
    stop_blackbox()


# -- black-box journal + push export ---------------------------------------- #


def _tee(doc: dict[str, Any]) -> None:
    """Offer one record to the durable journal and the exporter
    (whichever are armed). Both intakes are fire-and-forget already;
    the try is for the encode path here."""
    try:
        if _blackbox is not None:
            _blackbox.append(doc)
        if _exporter is not None:
            _exporter.offer(doc)
    except Exception:  # noqa: BLE001 - teeing must never reach callers
        _timeline.mark_drops.inc()


def _on_decision_complete(dec: Any) -> None:
    """trace complete-hook: journal every finalized flight-recorder
    decision (the crash story's "what was bound when we died")."""
    _tee({"t": "decision", "ts": time.time(), "doc": dec.to_json()})


def _journal_tick(now: float) -> None:
    """Timeline tick-hook: journal a compact last-value sample of
    every series (the crash story's "what the gauges said")."""
    if _blackbox is None and _exporter is None:
        return
    values = _timeline.last_values()
    if values:
        _tee({"t": "sample", "ts": now, "series": values})


def _arm_blackbox() -> None:
    """Build and start the journal/exporter from the environment
    (idempotent; either can be armed without the other)."""
    global _blackbox, _exporter
    directory, url = journal_dir(), export_url()
    if directory and _blackbox is None:
        journal = BlackboxJournal(directory)
        journal.on_rotate = lambda seq: mark(
            "journal-rotate", f"segment {seq}", segment=seq)
        journal.start()
        _blackbox = journal
    if url and _exporter is None:
        exp = Exporter(url)
        exp.on_stall = lambda failures: mark(
            "export-stall", f"{failures} consecutive failed posts",
            failures=failures)
        exp.start()
        _exporter = exp
    if _blackbox is not None or _exporter is not None:
        from tpushare_torch import trace
        trace.add_complete_hook(_on_decision_complete)
        if _journal_tick not in _timeline._tick_hooks:
            _timeline.add_tick_hook(_journal_tick)


def stop_blackbox() -> None:
    """Disarm the journal and exporter (flushing both), leaving the
    timeline itself alone — the bench overhead probe's off-arm, and
    part of reset()."""
    global _blackbox, _exporter
    from tpushare_torch import trace
    trace.remove_complete_hook(_on_decision_complete)
    journal, exp = _blackbox, _exporter
    _blackbox = None
    _exporter = None
    if exp is not None:
        exp.stop()
    if journal is not None:
        journal.stop()


def flush_blackbox() -> bool:
    """Synchronously fsync the journal — the SIGTERM/atexit durability
    point (cmd/main). Never raises; False means the flush could not
    complete (counted) and shutdown should proceed anyway."""
    try:
        journal = _blackbox
        if journal is None:
            return True
        return journal.flush()
    except Exception:  # noqa: BLE001 - a failed flush must not wedge exit
        _timeline.mark_drops.inc()
        return False


def blackbox_snapshot() -> dict[str, Any]:
    """The ``GET /debug/blackbox`` document: journal + export health."""
    return {
        "armed": _blackbox is not None,
        "replayed": _replayed,
        "journal": (_blackbox.snapshot()
                    if _blackbox is not None else None),
        "export": (_exporter.stats()
                   if _exporter is not None else None),
    }


def replay_startup() -> int:
    """Replay the previous process's journal tail onto this process's
    surfaces: markers and samples back onto the timeline (original
    timestamps), decisions into the flight recorder's restored buffer
    — then stamp the ``restart`` boundary marker. Called from
    ``Controller.start()``; once per process; returns the number of
    records replayed."""
    global _replayed
    if _replayed:
        return 0
    directory = journal_dir()
    if not directory:
        return 0
    _replayed = True
    from tpushare_torch import trace
    replayed = 0
    for doc in replay(directory):
        try:
            kind = doc.get("t")
            ts = float(doc.get("ts", 0.0))
            if kind == "marker":
                _timeline.mark(doc.get("kind", ""),
                               doc.get("detail", ""),
                               dict(doc.get("attrs") or {}), ts=ts)
            elif kind == "sample":
                for name, value in (doc.get("series") or {}).items():
                    _timeline.record(str(name), float(value), ts=ts)
            elif kind == "decision":
                trace.restore(doc.get("doc") or {})
            else:
                continue
            replayed += 1
        except Exception:  # noqa: BLE001 - a bad frame must not stop replay
            _timeline.mark_drops.inc()
    # The boundary goes through mark() so it is journaled too: the
    # NEXT restart replays it as history, separating the epochs.
    mark("restart", f"replayed {replayed} journal records",
         replayed=replayed)
    return replayed


# -- fire-and-forget intake ------------------------------------------------- #


def mark(kind: str, detail: str = "", trace_id: str | None = None,
         **attrs: object) -> int | None:
    """Stamp a typed marker onto the fleet timeline; returns its
    cursor, or None when disabled or on any internal failure. This is
    the ONLY marker entry point emission sites may call: whatever goes
    wrong inside the timeline layer is swallowed into the drop counter
    — a leadership flip must never fail because history-keeping did."""
    try:
        if not enabled():
            return None
        str_attrs = {key: str(value) for key, value in attrs.items()}
        if trace_id is None:
            from tpushare_torch import trace
            trace_id = trace.current_trace_id()
        if trace_id:
            str_attrs["trace_id"] = trace_id
        ts = _clock()
        cursor = _timeline.mark(kind, detail, str_attrs, ts=ts)
        # Tee the marker to the durable journal/exporter AFTER the
        # timeline accepted it (an invalid kind raised above and is
        # never journaled, so replay can trust journaled kinds) —
        # and to the fleet-day witness, which no-ops unless armed.
        _witness.observe_marker(kind, ts, detail, str_attrs)
        _tee({"t": "marker", "ts": ts, "cursor": cursor, "kind": kind,
              "detail": detail, "attrs": str_attrs})
        return cursor
    except Exception:  # noqa: BLE001 - marking must never reach callers
        _timeline.mark_drops.inc()
        return None


def note_verb(verb: str, seconds: float, trace_id: str = "") -> None:
    """Hot-path verb observation: feeds the ``verb_p99_ms:<verb>``
    series and files the histogram-bucket exemplar. Lock-free,
    fire-and-forget (see mark())."""
    try:
        if not enabled():
            return
        _timeline.note_verb(verb, seconds)
        if trace_id:
            _exemplars.record(verb, seconds, trace_id)
    except Exception:  # noqa: BLE001 - telemetry must never reach callers
        _timeline.mark_drops.inc()


def mark_drops() -> int:
    """Swallowed-exception count across the fire-and-forget surface."""
    return _timeline.mark_drops.value


# -- render/read ------------------------------------------------------------ #


def annotate_metrics(text: bytes) -> bytes:
    """Append OpenMetrics exemplars to a rendered exposition;
    fire-and-forget (the scrape must never fail because of us)."""
    try:
        if not enabled():
            return text
        return _exemplars.annotate(text)
    except Exception:  # noqa: BLE001 - rendering must never break /metrics
        _exemplars.drops.inc()
        return text


def snapshot(window_s: float | None = None,
             series: list[str] | None = None,
             markers: bool = True) -> dict[str, Any]:
    """The ``/debug/timeline`` document: series + markers + exemplars
    + anomaly state."""
    doc = _timeline.snapshot(window_s=window_s, series=series,
                             markers=markers)
    doc["exemplars"] = _exemplars.snapshot()
    doc["anomalies"] = {"fired": _anomalies.fired_counts(),
                        "rules": [r.name for r in _anomalies.rules()]}
    doc["drops"]["exemplars"] = _exemplars.drops.value
    doc["drops"]["anomaly"] = _anomalies.drops.value
    return doc


def reset() -> None:
    """Stop the sampler and drop all retrospective state (tests)."""
    global _replayed
    stop_blackbox()
    set_clock(None)
    _replayed = False
    _timeline.reset()
    _anomalies.reset()
    _exemplars.reset()
    _witness.reset()
    _hook_anomalies()
