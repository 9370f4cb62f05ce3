"""tpushare_torch.profiling — continuous profiling + per-verb cost ledger.

The port's copy of ``tpushare/profiling/__init__.py``.

Module singletons, like :mod:`tpushare_torch.trace`: one
:class:`~tpushare_torch.profiling.sampler.ContinuousProfiler`, one
:class:`~tpushare_torch.profiling.decisions.DecisionProfiler` and one
:class:`~tpushare_torch.profiling.ledger.VerbCostLedger` per process,
reached from the routes and ``chip_smoke.py`` without constructor
plumbing.

Importing this package registers the flight-recorder phase hook that
feeds the ledger — the exact wall/CPU/lock-wait/apiserver splits accrue
from the first verb served, whether or not the sampler is armed. The
sampler itself is armed by :func:`arm_from_env` (``TPUSHARE_PROFILE``,
default on — it is designed to be ALWAYS on; ``off``/``0`` disarms) or
explicitly by :func:`start`.

Surfaces: ``GET /debug/profile/continuous`` (collapsed stacks,
speedscope-ready), ``GET /debug/hotspots`` (top-N frames per verb +
ledger splits), ``kubectl inspect tpushare hotspots``, and the
``tpushare_verb_*`` series on ``/metrics``.

On Python 3.12 ``cProfile`` runs on ``sys.monitoring``, which is
process-wide: a second thread's probe raises while another is enabled
(the recorder drop-counts it) and a profiled decision folds in other
threads' frames. The reference behaves the same way.
"""

from __future__ import annotations

import os

from tpushare_torch import trace
from tpushare_torch.profiling.decisions import DecisionProfiler
from tpushare_torch.profiling.ledger import VerbCostLedger
from tpushare_torch.profiling.sampler import (DEFAULT_HZ, DEFAULT_WINDOW_S,
                                        ContinuousProfiler)

__all__ = [
    "ContinuousProfiler", "DecisionProfiler", "VerbCostLedger",
    "arm_from_env", "decisions", "hotspots_report", "ledger",
    "profiler", "reset", "running", "start", "stop",
    "verb_frame_distribution",
]

_ledger = VerbCostLedger()
_decisions = DecisionProfiler()
_profiler: ContinuousProfiler | None = None


def ledger() -> VerbCostLedger:
    return _ledger


def decisions() -> DecisionProfiler:
    return _decisions


def profiler() -> ContinuousProfiler:
    """The process-wide sampler (constructed on first use; NOT armed —
    see :func:`start` / :func:`arm_from_env`)."""
    global _profiler
    if _profiler is None:
        _profiler = ContinuousProfiler()
    return _profiler


def start(hz: int | None = None,
          window_s: float | None = None) -> bool:
    """Arm the continuous sampler; False when already running. ``hz`` /
    ``window_s`` rebuild the sampler only while it is stopped (an armed
    sampler's cadence is never hot-swapped under the reader surfaces)."""
    global _profiler
    if _profiler is not None and _profiler.running():
        return False
    if hz is not None or window_s is not None or _profiler is None:
        _profiler = ContinuousProfiler(
            hz=hz if hz is not None else DEFAULT_HZ,
            window_s=window_s if window_s is not None
            else DEFAULT_WINDOW_S)
    _decisions.armed = True
    return _profiler.start()


def stop() -> None:
    _decisions.armed = False
    if _profiler is not None:
        _profiler.stop()


def running() -> bool:
    return _profiler is not None and _profiler.running()


def reset() -> None:
    """Stop the sampler and drop every counter (tests; the ledger's
    monotonic totals clear too)."""
    stop()
    if _profiler is not None:
        _profiler.reset()
    _decisions.reset()
    _ledger.reset()


def arm_from_env() -> bool:
    """Arm per ``TPUSHARE_PROFILE`` (default ON — the profiler exists
    to be running BEFORE the incident) and ``TPUSHARE_PROFILE_HZ``.
    Returns whether the sampler is running afterwards."""
    mode = os.environ.get("TPUSHARE_PROFILE", "on").lower()
    if mode in ("off", "0", "false", "no"):
        return running()
    hz_raw = os.environ.get("TPUSHARE_PROFILE_HZ", "")
    hz: int | None = None
    if hz_raw.isdigit():
        hz = max(1, min(int(hz_raw), 1000))
    start(hz=hz)
    return running()


def hotspots_report(top: int = 5,
                    window_s: float | None = None) -> dict[str, object]:
    """The ``/debug/hotspots`` document, all three engines joined:

    * the statistical sampler's view (background subsystems, waits,
      anything long enough to cross a GIL yield),
    * the duty-cycled decision probe's EXACT per-frame view of the
      verbs (which overrides the sampler's entry for a verb it has
      data on — sub-millisecond verbs are invisible to cross-thread
      sampling, see tpushare/profiling/decisions.py),
    * the cost ledger's exact wall/CPU/lock-wait/apiserver splits.
    """
    doc = profiler().hotspots(top=top, window_s=window_s)
    verbs = doc["verbs"]
    assert isinstance(verbs, dict)
    for vdoc in verbs.values():
        vdoc["engine"] = "sampler"
    for verb, vdoc in _decisions.snapshot(top=top).items():
        verbs[verb] = vdoc
    doc["verbCosts"] = _ledger.snapshot()
    return doc


def verb_frame_distribution(top: int = 10) -> dict[str, dict[str, float]]:
    """The decision probe's per-verb frame-share distribution — the
    shape half of the self-CPU metric export (metrics.py multiplies it
    by the ledger's exact per-verb CPU totals)."""
    return _decisions.frame_distribution(top=top)


def _on_phase(verb: str, span: object) -> None:
    """Flight-recorder phase hook -> ledger (always on; O(1))."""
    _ledger.observe(verb, span)


trace.add_phase_hook(_on_phase)
trace.set_phase_probe(_decisions.probe)
