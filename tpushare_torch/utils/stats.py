"""Quantile math: nearest-rank percentiles, ONE home.

The port's copy of ``tpushare/utils/stats.py``.

bench.py computed its p99 as ``latencies[int(len * 0.99) - 1]`` — off
by one whenever ``q * n`` is not integral (at n=150, q=0.99 that reads
rank 148 where nearest-rank is 149), and every new consumer (the
profiling aggregates, the scale bench's overhead gate) would have
re-invented its own variant. Nearest-rank is the standard gate-friendly
definition: the smallest observed value v such that at least
``ceil(q * n)`` observations are ≤ v — always an actual observation,
never an interpolation (a latency gate should trip on a latency that
HAPPENED).
"""

from __future__ import annotations

import math
from typing import Sequence


def quantile_sorted(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank quantile of an ascending-sorted, non-empty
    sequence. ``q`` in (0, 1]; ``q=1.0`` is the maximum."""
    n = len(sorted_vals)
    if n == 0:
        raise ValueError("quantile of an empty sequence")
    if not 0.0 < q <= 1.0:
        raise ValueError(f"q must be in (0, 1], got {q}")
    rank = math.ceil(q * n)
    return sorted_vals[max(rank, 1) - 1]


def quantile(vals: Sequence[float], q: float) -> float:
    """Nearest-rank quantile of an unsorted sequence (sorts a copy)."""
    return quantile_sorted(sorted(vals), q)
