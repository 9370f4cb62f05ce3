"""Per-verb cost ledger: exact wall/CPU/lock-wait/apiserver splits.

The port's copy of ``tpushare/profiling/ledger.py``.

The statistical half of the continuous profiler (the sampler) says
WHERE a verb's time goes frame by frame; this ledger says HOW MUCH each
verb costs in total, split the way an operator triages: wall time (what
the latency histograms see), thread-CPU time (the verb's own compute,
from ``time.thread_time_ns`` deltas on the decision spans), lock-wait
(fed by the ``TracingRLock`` contention hook into the span), and
apiserver round-trip time (fed by ``tpushare_torch.k8s.client``). ``wall -
cpu - lock - api`` is the residue: GIL waits and scheduler preemption.

Fed by a flight-recorder phase hook (registered at
:mod:`tpushare_torch.profiling` import), so every verb phase that closes —
filter, prioritize, preempt, bind, and the defrag decisions — lands
here at O(1) cost. Counters are monotonic since process start; the
``/metrics`` scrape exports them as
``tpushare_verb_*_seconds_total``.
"""

from __future__ import annotations

from typing import Any

from tpushare_torch.utils import locks


class VerbCostLedger:
    """Monotonic per-verb cost accumulators, keyed by verb name."""

    def __init__(self) -> None:
        self._lock = locks.TracingRLock("profiling/ledger")
        #: verb -> [decisions, wall_s, cpu_s, lock_wait_s, api_s,
        #: queue_s] — queue_s is the HTTP micro-batch gate's wait
        #: BEFORE the span opened (routes/batch.py), kept separate
        #: because the span wall clock never contains it.
        self._verbs: dict[str, list[float]] = locks.guarded_dict(
            self._lock, "VerbCostLedger._verbs")

    def observe(self, verb: str, span: Any) -> None:
        """Fold one closed verb span in (the recorder phase hook)."""
        with self._lock:
            row = self._verbs.get(verb)
            if row is None:
                row = self._verbs[verb] = [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]
            row[0] += 1
            row[1] += span.seconds
            row[2] += span.cpu_s
            row[3] += span.lock_wait_s
            row[4] += span.api_s
            row[5] += getattr(span, "queue_s", 0.0)

    def snapshot(self) -> dict[str, dict[str, float]]:
        """verb -> cost splits, JSON-shaped (seconds, monotonic)."""
        with self._lock:
            rows = {verb: list(row) for verb, row in self._verbs.items()}
        return {
            verb: {
                "decisions": int(row[0]),
                "wallSeconds": round(row[1], 6),
                "cpuSeconds": round(row[2], 6),
                "lockWaitSeconds": round(row[3], 6),
                "apiSeconds": round(row[4], 6),
                "queueWaitSeconds": round(row[5], 6),
            }
            for verb, row in rows.items()
        }

    def reset(self) -> None:
        with self._lock:
            self._verbs.clear()
