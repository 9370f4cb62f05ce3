"""TimelineRecorder: bounded per-series history with annotation markers.

The port's copy of ``tpushare/obs/timeline.py``.

Everything else in the observability stack is point-in-time — gauges
are computed at scrape, the profiler keeps 60s windows, the flight ring
holds recent decisions. This module keeps *history*: a background
sampler walks registered sources on a fixed cadence (~2s) into
per-series ring buffers with tiered downsampling:

* **tier0** — raw samples at the sampler cadence, sized for the last
  ~5 minutes;
* **tier1** — 30s ``(ts, min, avg, max)`` aggregates, sized for the
  last ~1 hour. A tier0 sample also lands in the series' current 30s
  bucket; crossing a bucket boundary flushes the aggregate to tier1.

**Markers** are discrete fleet events (leader acquire/loss, defrag
plan/abort, router scale-out, SLO burn, ConfigMap change, gang
commit/rollback) stamped onto the same clock with a monotonically
increasing *cursor* id — the join key an Event message carries as
``[timeline <cursor>]`` so a page at 14:07 resolves to the series state
at 14:02.

Bounds are hard: at most ``max_series`` series (oldest-written evicted
first), fixed-depth rings per tier, a bounded marker ring — every
eviction or refusal is counted into drop counters surfaced as
``tpushare_timeline_dropped_total``. Reads are copy-on-write: snapshots
materialize plain lists under the lock and never hand out live rings.

The verb hot path feeds latency samples through :meth:`note_verb`,
which appends to a bounded ``deque`` (GIL-atomic, no lock — the same
discipline as :class:`tpushare_torch.trace.recorder.DropCounter`) so the
gated filter/bind handlers never contend with the sampler.
"""

from __future__ import annotations

import math
import os
import threading
import time
from collections import deque
from typing import Any, Callable

from tpushare_torch.trace.recorder import DropCounter
from tpushare_torch.utils import locks

#: Sampler cadence (seconds). ~150 tier0 points cover 5 minutes.
SAMPLE_INTERVAL_S = 2.0

#: tier0 depth: last ~5m of raw samples at the 2s cadence.
TIER0_POINTS = 150

#: tier1 bucket width and depth: 120 aggregates of 30s = last hour.
TIER1_BUCKET_S = 30.0
TIER1_POINTS = 120

#: Hard cap on concurrently tracked series — the memory bound. New
#: series past the cap evict the least-recently-written one.
MAX_SERIES = 64

#: Bounded marker ring. Markers are rare (leadership flips, defrag
#: plans, burns); 512 is hours of fleet history.
MAX_MARKERS = 512

#: Per-verb bounded sample buffer the hot path appends into. At 2s
#: ticks a verb would need >2000 calls/s to overflow between drains —
#: past that, losing tail samples only flattens the p99 estimate.
VERB_BUFFER = 4096

#: The marker taxonomy. ``mark()`` refuses kinds outside it (counted
#: as drops) so the timeline lanes stay enumerable for renderers.
MARKER_KINDS = frozenset({
    "leader", "defrag-plan", "defrag-abort", "router-scaleout",
    "slo-burn", "config", "gang-commit", "gang-rollback", "anomaly",
    "autoscale-up", "autoscale-down", "autoscale-abort",
    "restart", "journal-rotate", "export-stall", "node-notready",
})


def enabled() -> bool:
    """The kill switch: ``TPUSHARE_TIMELINE=off`` disarms the recorder
    (sampling, markers, exemplars) without touching any caller."""
    return os.environ.get("TPUSHARE_TIMELINE", "").lower() not in (
        "off", "0", "false", "disabled")


class _Series:
    """One metric's tiered rings + the in-progress tier1 bucket.
    Mutated only under the recorder's lock."""

    __slots__ = ("tier0", "tier1", "bucket_start", "count", "total",
                 "minimum", "maximum", "written_at")

    def __init__(self) -> None:
        self.tier0: deque[tuple[float, float]] = deque(maxlen=TIER0_POINTS)
        self.tier1: deque[tuple[float, float, float, float]] = \
            deque(maxlen=TIER1_POINTS)
        self.bucket_start: float = 0.0
        self.count: int = 0
        self.total: float = 0.0
        self.minimum: float = 0.0
        self.maximum: float = 0.0
        self.written_at: float = 0.0

    def add(self, ts: float, value: float) -> None:
        bucket = ts - math.fmod(ts, TIER1_BUCKET_S)
        if self.count and bucket != self.bucket_start:
            self.flush()
        if not self.count:
            self.bucket_start = bucket
            self.minimum = self.maximum = value
        else:
            self.minimum = min(self.minimum, value)
            self.maximum = max(self.maximum, value)
        self.count += 1
        self.total += value
        self.tier0.append((ts, value))
        self.written_at = ts

    def flush(self) -> None:
        """Roll the open 30s bucket into tier1."""
        if self.count:
            self.tier1.append((self.bucket_start, self.minimum,
                               self.total / self.count, self.maximum))
            self.count = 0
            self.total = 0.0


class Marker:
    """One annotation on the fleet clock."""

    __slots__ = ("cursor", "ts", "kind", "detail", "attrs")

    def __init__(self, cursor: int, ts: float, kind: str, detail: str,
                 attrs: dict[str, str]) -> None:
        self.cursor = cursor
        self.ts = ts
        self.kind = kind
        self.detail = detail
        self.attrs = attrs

    def to_json(self) -> dict[str, Any]:
        return {"cursor": self.cursor, "ts": round(self.ts, 3),
                "kind": self.kind, "detail": self.detail,
                "attrs": dict(self.attrs)}


class TimelineRecorder:
    """Tiered ring buffers + markers + the background sampler."""

    def __init__(self, now_fn: Callable[[], float] = time.time) -> None:
        self._lock = locks.TracingRLock("obs/timeline")
        self._now = now_fn
        self._series: dict[str, _Series] = locks.guarded_dict(
            self._lock, "TimelineRecorder._series")
        self._markers: deque[Marker] = deque(maxlen=MAX_MARKERS)
        self._cursor = 0
        #: name -> callable returning {series: value}; sampled per tick.
        self._sources: dict[str, Callable[[], dict[str, float]]] = \
            locks.guarded_dict(self._lock, "TimelineRecorder._sources")
        #: verb -> bounded (ts, seconds) buffer. Hot-path appends are
        #: GIL-atomic deque writes; the sampler reads without draining
        #: (old entries age out by maxlen). Deliberately NOT guarded —
        #: taking the recorder lock in the gated verb handlers is the
        #: one cost the overhead gate exists to forbid.
        self._verb_samples: dict[str, deque[tuple[float, float]]] = {}
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._started_at = 0.0
        #: Evicted points/series/markers — the memory cap biting.
        self.drops = DropCounter()
        #: Exceptions swallowed on the record/mark path.
        self.mark_drops = DropCounter()
        #: Per-tick callbacks (the anomaly engine hooks in here).
        self._tick_hooks: list[Callable[[float], None]] = []

    def set_now(self, now_fn: Callable[[], float]) -> None:
        """Swap the recorder's clock. The fleet-day gate replays a
        compressed day on a scenario clock so samples and markers land
        in the tiered rings at scenario time, not wall time; tests and
        the gate restore ``time.time`` via ``obs.set_clock(None)``."""
        with self._lock:
            self._now = now_fn

    # -- lifecycle -------------------------------------------------------- #

    def start(self, interval_s: float = SAMPLE_INTERVAL_S) -> bool:
        """Arm the background sampler (idempotent). Returns False when
        the kill switch disables the recorder or it is already
        running."""
        if not enabled():
            return False
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return False
            self._stop.clear()
            self._started_at = self._now()
            self._thread = threading.Thread(
                target=self._run, args=(interval_s,),
                name="tpushare-timeline", daemon=True)
            self._thread.start()
        return True

    def stop(self) -> None:
        with self._lock:
            thread = self._thread
            self._thread = None
        self._stop.set()
        if thread is not None and thread.is_alive():
            thread.join(timeout=2.0)

    def running(self) -> bool:
        with self._lock:
            return self._thread is not None and self._thread.is_alive()

    def _run(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - sampling must not die
                self.mark_drops.inc()

    # -- sources ---------------------------------------------------------- #

    def add_source(self, name: str,
                   fn: Callable[[], dict[str, float]]) -> None:
        """Register (or replace) a sample source. Sources run on the
        sampler thread only, so they may take their own locks but must
        never block on I/O."""
        with self._lock:
            self._sources[name] = fn

    def remove_source(self, name: str) -> None:
        with self._lock:
            self._sources.pop(name, None)

    def tick(self, now: float | None = None) -> None:
        """One sampler pass: pull every source, fold verb latency
        buffers into p99/rate series, run tick hooks (anomalies)."""
        if now is None:
            now = self._now()
        with self._lock:
            sources = list(self._sources.items())
            hooks = list(self._tick_hooks)
        for name, fn in sources:
            try:
                values = fn()
            except Exception:  # noqa: BLE001 - a broken source drops
                self.mark_drops.inc()
                continue
            for series, value in values.items():
                self.record(series, float(value), now)
        for verb, buf in list(self._verb_samples.items()):
            window = [s for ts, s in list(buf)
                      if ts >= now - TIER1_BUCKET_S]
            if window:
                window.sort()
                p99 = window[min(len(window) - 1,
                                 int(0.99 * len(window)))]
                self.record(f"verb_p99_ms:{verb}", p99 * 1000.0, now)
                self.record(f"verb_rate:{verb}",
                            len(window) / TIER1_BUCKET_S, now)
        for hook in hooks:
            try:
                hook(now)
            except Exception:  # noqa: BLE001 - a hook must not stop ticks
                self.mark_drops.inc()

    def add_tick_hook(self, hook: Callable[[float], None]) -> None:
        with self._lock:
            self._tick_hooks.append(hook)

    # -- intake ----------------------------------------------------------- #

    def record(self, name: str, value: float,
               ts: float | None = None) -> None:
        """One sample into ``name``'s rings, evicting the coldest
        series when the cap is hit."""
        if ts is None:
            ts = self._now()
        with self._lock:
            series = self._series.get(name)
            if series is None:
                if len(self._series) >= MAX_SERIES:
                    coldest = min(self._series,
                                  key=lambda n:
                                  self._series[n].written_at)
                    evicted = self._series.pop(coldest)
                    self.drops.inc(len(evicted.tier0)
                                   + len(evicted.tier1) + 1)
                series = _Series()
                self._series[name] = series
            if len(series.tier0) == TIER0_POINTS:
                self.drops.inc()  # the ring is full: oldest point falls
            series.add(ts, value)

    def note_verb(self, verb: str, seconds: float) -> None:
        """Hot-path verb latency sample (lock-free append; see
        ``_verb_samples``)."""
        buf = self._verb_samples.get(verb)
        if buf is None:
            # Benign race: two threads may both build the deque; one
            # assignment wins and the loser's single sample is dropped.
            buf = deque(maxlen=VERB_BUFFER)
            self._verb_samples[verb] = buf
        buf.append((self._now(), seconds))

    # -- markers ---------------------------------------------------------- #

    def mark(self, kind: str, detail: str = "",
             attrs: dict[str, str] | None = None,
             ts: float | None = None) -> int:
        """Stamp a marker; returns its cursor id. Raises on unknown
        kinds — callers go through :func:`tpushare_torch.obs.mark`, which
        swallows into the drop counter."""
        if kind not in MARKER_KINDS:
            raise ValueError(f"unknown marker kind {kind!r} "
                             f"(taxonomy: {sorted(MARKER_KINDS)})")
        if ts is None:
            ts = self._now()
        with self._lock:
            self._cursor += 1
            if len(self._markers) == MAX_MARKERS:
                self.drops.inc()
            marker = Marker(self._cursor, ts, kind, detail,
                            dict(attrs or {}))
            self._markers.append(marker)
            return marker.cursor

    def get_marker(self, cursor: int) -> dict[str, Any] | None:
        with self._lock:
            for marker in self._markers:
                if marker.cursor == cursor:
                    return marker.to_json()
        return None

    # -- reads ------------------------------------------------------------ #

    def snapshot(self, window_s: float | None = None,
                 series: list[str] | None = None,
                 markers: bool = True) -> dict[str, Any]:
        """The ``/debug/timeline`` document: copy-on-write — plain
        lists built under the lock, never the live rings."""
        now = self._now()
        cut = now - window_s if window_s else None
        with self._lock:
            out_series: dict[str, Any] = {}
            for name, s in self._series.items():
                if series is not None and not any(
                        sel == name or name.startswith(sel)
                        for sel in series):
                    continue
                tier0 = [(round(ts, 3), value) for ts, value in s.tier0
                         if cut is None or ts >= cut]
                tier1 = [(round(ts, 3), lo, round(avg, 6), hi)
                         for ts, lo, avg, hi in s.tier1
                         if cut is None or ts + TIER1_BUCKET_S >= cut]
                out_series[name] = {
                    "tier0": tier0, "tier1": tier1,
                    "last": s.tier0[-1][1] if s.tier0 else None,
                }
            out_markers = [m.to_json() for m in self._markers
                           if markers and (cut is None or m.ts >= cut)]
            doc: dict[str, Any] = {
                "enabled": enabled(),
                "running": (self._thread is not None
                            and self._thread.is_alive()),
                "now": round(now, 3),
                "intervalSeconds": SAMPLE_INTERVAL_S,
                "tiers": {"tier0": {"resolutionSeconds":
                                    SAMPLE_INTERVAL_S,
                                    "points": TIER0_POINTS},
                          "tier1": {"resolutionSeconds": TIER1_BUCKET_S,
                                    "points": TIER1_POINTS}},
                "series": out_series,
                "markers": out_markers,
                "cursorLatest": self._cursor,
                "drops": {"evicted": self.drops.value,
                          "swallowed": self.mark_drops.value},
            }
        return doc

    def series_count(self) -> int:
        with self._lock:
            return len(self._series)

    def last_values(self) -> dict[str, float]:
        """The newest sample of every series — the cheap per-tick
        snapshot the black-box journal records as its ``sample``
        frames (full rings would make every tick a megabyte)."""
        with self._lock:
            return {name: s.tier0[-1][1]
                    for name, s in self._series.items() if s.tier0}

    def reset(self) -> None:
        """Tests: drop all state, keep the thread/source registration
        decision to the caller (stop() first for a full teardown)."""
        self.stop()
        with self._lock:
            self._series.clear()
            self._markers.clear()
            self._cursor = 0
            self._sources.clear()
            self._tick_hooks.clear()
            self._verb_samples = {}
            self.drops = DropCounter()
            self.mark_drops = DropCounter()
