"""Metric→trace exemplars for the verb latency histograms.

The port's copy of ``tpushare/obs/exemplars.py``; the ``le`` text it
matches is what :mod:`tpushare_torch.routes.exposition` renders, which
is what ``prometheus_client`` renders.

``tpushare_<verb>_latency_seconds`` tells you *that* a tail exists;
the flight recorder knows *why* — but nothing joins them. This store
keeps one bounded exemplar per (verb, histogram bucket): the trace-id,
observed latency, and timestamp of the latest observation that landed
in that bucket. Two render paths:

* ``/metrics``: :func:`annotate` appends the OpenMetrics exemplar form
  to each matching ``_bucket`` sample line::

      tpushare_bind_latency_seconds_bucket{le="0.25"} 17 # {trace_id="a1b2..."} 0.181 1722850000.123

  so a Grafana/OpenMetrics-aware scraper (or a human with curl) can
  jump from a bucket to ``/debug/trace?id=``.

* ``/debug/timeline``: :meth:`snapshot` inlines the same exemplars so
  the timeline view resolves a latency spike to concrete decisions.

Bounds by construction: the key space is (4 verbs × len(buckets)+1)
cells, latest-wins. Writes are plain dict assignments (GIL-atomic, no
lock on the gated verb path); reads copy via ``list(items())``.
"""

from __future__ import annotations

import re
import time
from typing import Any, Callable

from tpushare_torch.trace.recorder import DropCounter

_BUCKET_LINE = re.compile(
    rb'^(tpushare_(\w+)_latency_seconds_bucket\{[^}]*le="([^"]+)"[^}]*\})'
    rb'( [0-9eE+.\-]+)$')


def _default_buckets() -> tuple[float, ...]:
    """The verb histograms' upper bounds, read from the metrics module
    (function-level import: metrics lazily calls back into obs at
    render time)."""
    from tpushare_torch.routes import metrics
    return tuple(metrics.LATENCY_BUCKETS)


class ExemplarStore:
    """Latest trace exemplar per (verb, bucket le)."""

    def __init__(self, buckets: tuple[float, ...] | None = None,
                 now_fn: Callable[[], float] = time.time) -> None:
        self._buckets = buckets
        self._now = now_fn
        #: (verb, le string) -> (trace_id, seconds, ts). Latest-wins
        #: dict assignment; deliberately lock-free (see module doc).
        self._cells: dict[tuple[str, str], tuple[str, float, float]] = {}
        self.drops = DropCounter()

    def _bounds(self) -> tuple[float, ...]:
        if self._buckets is None:
            self._buckets = _default_buckets()
        return self._buckets

    @staticmethod
    def _le_str(bound: float) -> str:
        """prometheus_client's label rendering for bucket bounds."""
        if bound == float("inf"):
            return "+Inf"
        return repr(float(bound))

    def record(self, verb: str, seconds: float, trace_id: str) -> None:
        """File one observation under its histogram bucket."""
        if not trace_id:
            return
        le = "+Inf"
        for bound in self._bounds():
            if seconds <= bound:
                le = self._le_str(bound)
                break
        self._cells[(verb, le)] = (trace_id, seconds, self._now())

    # -- render ------------------------------------------------------------ #

    def annotate(self, text: bytes) -> bytes:
        """Append OpenMetrics ``# {trace_id="…"}`` exemplars to the
        matching ``_bucket`` lines of a rendered exposition."""
        cells = dict(self._cells)
        if not cells:
            return text
        out: list[bytes] = []
        for line in text.splitlines(keepends=False):
            match = _BUCKET_LINE.match(line)
            if match:
                verb = match.group(2).decode()
                le = match.group(3).decode()
                cell = cells.get((verb, le))
                if cell is not None:
                    trace_id, seconds, ts = cell
                    line = (line + f' # {{trace_id="{trace_id}"}} '
                            f'{seconds:.6f} {ts:.3f}'.encode())
            out.append(line)
        return b"\n".join(out) + b"\n"

    def snapshot(self) -> dict[str, list[dict[str, Any]]]:
        """Per-verb exemplar list for ``/debug/timeline``."""
        by_verb: dict[str, list[dict[str, Any]]] = {}
        for (verb, le), (trace_id, seconds, ts) in \
                sorted(self._cells.items()):
            by_verb.setdefault(verb, []).append({
                "le": le, "traceId": trace_id,
                "seconds": round(seconds, 6), "ts": round(ts, 3)})
        return by_verb

    def reset(self) -> None:
        self._cells = {}
        self.drops = DropCounter()
