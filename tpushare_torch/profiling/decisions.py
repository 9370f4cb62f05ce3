"""Duty-cycled deterministic verb profiler: exact frames for short verbs.

The port's copy of ``tpushare/profiling/decisions.py``.

The statistical sampler (:mod:`tpushare_torch.profiling.sampler`) sees other
threads only at GIL-yield points — physics of in-process profiling: a
filter verb that runs ~0.3 ms completes inside one GIL slice, so no
cross-thread sampler (signal- or thread-driven) can ever catch it
mid-flight. Those sub-slice verbs are the extender's hot path.

So verbs get the complementary engine: every Nth decision per verb
(``DEFAULT_DUTY``, plus the first ever, so surfaces are never empty)
runs under ``cProfile`` — a COMPLETE, exact self-time-per-frame profile
of that one decision, folded into per-verb frame distributions. The
math: the distribution comes from the profiled decisions; the absolute
totals come from the cost ledger's exact per-verb CPU seconds; their
product is the exported ``tpushare_verb_self_cpu_seconds_total``. A
deterministic profile's coverage is total by construction — the
≥90% attribution check of ``chip_smoke.py``'s churn reads it off this
engine.

Overhead shape: a profiled decision pays ~4× its own latency; at
1/512 duty that is ~0.6% mean CPU overhead, and the slowed calls are
rare enough to sit ABOVE the p99 rank (0.2% of calls cannot move a
nearest-rank p99) — measured by the on/off overhead gate of
``tools/extender_phases.py --overhead``.
"""

from __future__ import annotations

import cProfile
from collections import Counter
from contextlib import contextmanager
from typing import Any, Iterator

from tpushare_torch.utils import locks

#: Profile one decision in this many, per verb (plus each verb's first).
DEFAULT_DUTY = 512


def _label_of(code: Any) -> str:
    """lsprof entry code -> the sampler's frame-label format; C-level
    entries (builtins) keep their descriptive repr tagged [C]."""
    if hasattr(code, "co_name"):
        return (f"{code.co_name} "
                f"({code.co_filename.rsplit('/', 1)[-1]})")
    return f"{code} [C]"


class DecisionProfiler:
    """Per-verb duty counter + cProfile fold-in aggregates."""

    def __init__(self, duty: int = DEFAULT_DUTY) -> None:
        self.duty = max(int(duty), 1)
        self.armed = False
        #: Per-verb decision counters for the duty cycle. Plain dict:
        #: GIL-atomic increments; a rare lost increment shifts WHICH
        #: decision gets profiled, never correctness.
        self._counts: dict[str, int] = {}
        self._lock = locks.TracingRLock("profiling/decisions")
        #: verb -> frame -> exact self seconds over profiled decisions.
        self._self_s: dict[str, Counter[str]] = locks.guarded_dict(
            self._lock, "DecisionProfiler._self_s")
        #: verb -> profiled decision count / their total self seconds.
        self._profiled: dict[str, int] = locks.guarded_dict(
            self._lock, "DecisionProfiler._profiled")
        self.drops = 0

    def probe(self, verb: str) -> Any | None:
        """The flight recorder's phase probe: a context manager for the
        decisions this duty cycle elects, None for the rest (the
        overwhelmingly common case — two dict ops and out)."""
        if not self.armed:
            return None
        count = self._counts.get(verb, 0) + 1
        self._counts[verb] = count
        if (count - 1) % self.duty:
            return None
        return self._profiled_ctx(verb)

    @contextmanager
    def _profiled_ctx(self, verb: str) -> Iterator[None]:
        pr = cProfile.Profile()
        pr.enable()
        try:
            yield
        finally:
            pr.disable()
            try:
                self._fold(verb, pr)
            except Exception:  # noqa: BLE001 - profiling must not die
                self.drops += 1

    def _fold(self, verb: str, pr: cProfile.Profile) -> None:
        rows: list[tuple[str, float]] = []
        for entry in pr.getstats():
            label = _label_of(entry.code)
            if "_lsprof" in label or "cProfile" in label:
                continue  # the profiler observing itself
            if entry.inlinetime > 0:
                rows.append((label, entry.inlinetime))
        with self._lock:
            per_frame = self._self_s.get(verb)
            if per_frame is None:
                per_frame = self._self_s[verb] = Counter()
            for label, self_s in rows:
                per_frame[label] += self_s
            self._profiled[verb] = self._profiled.get(verb, 0) + 1

    # -- readers ---------------------------------------------------------- #

    def snapshot(self, top: int = 5) -> dict[str, dict[str, object]]:
        """verb -> exact-engine hotspot view: profiled decision count,
        their total self seconds, top frames by self-time share, and
        the listed frames' combined coverage."""
        with self._lock:
            data = {verb: Counter(frames)
                    for verb, frames in self._self_s.items()}
            profiled = dict(self._profiled)
        out: dict[str, dict[str, object]] = {}
        for verb, frames in data.items():
            total = sum(frames.values())
            if total <= 0:
                continue
            listed = [{
                "frame": frame,
                "seconds": round(self_s, 6),
                "share": round(self_s / total, 4),
            } for frame, self_s in frames.most_common(top)]
            out[verb] = {
                "engine": "decision-probe",
                "profiledDecisions": profiled.get(verb, 0),
                "profiledSeconds": round(total, 6),
                "duty": self.duty,
                "frames": listed,
                "coverage": round(
                    sum(float(f["seconds"]) for f in listed) / total, 4),
            }
        return out

    def frame_distribution(self, top: int = 10) -> dict[str, dict[str, float]]:
        """verb -> {frame: share} over the profiled decisions (top
        frames plus an 'other' residue; shares sum to 1.0) — the
        distribution half of the self-CPU export (the ledger's exact
        per-verb CPU totals are the magnitude half)."""
        with self._lock:
            data = {verb: Counter(frames)
                    for verb, frames in self._self_s.items()}
        out: dict[str, dict[str, float]] = {}
        for verb, frames in data.items():
            total = sum(frames.values())
            if total <= 0:
                continue
            shares = {frame: round(self_s / total, 4)
                      for frame, self_s in frames.most_common(top)}
            residue = 1.0 - sum(shares.values())
            if residue > 0.0001:
                shares["other"] = round(residue, 4)
            out[verb] = shares
        return out

    def reset(self) -> None:
        with self._lock:
            self._self_s.clear()
            self._profiled.clear()
        self._counts.clear()
