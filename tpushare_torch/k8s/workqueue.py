"""Rate-limited work queue.

The port's copy of ``tpushare/k8s/workqueue.py``, the role client-go's
``workqueue.RateLimitingInterface`` plays: keys are deduplicated, a key a
worker holds is never handed to another, and failures come back with
exponential backoff.
"""

from __future__ import annotations

import heapq
import threading
import time


class RateLimitedQueue:
    def __init__(self, base_delay: float = 0.005, max_delay: float = 10.0):
        self._base = base_delay
        self._max = max_delay
        self._cond = threading.Condition()
        self._queue: list[str] = []          # ready keys, FIFO
        self._dirty: set[str] = set()        # queued or needing requeue
        self._processing: set[str] = set()
        self._failures: dict[str, int] = {}
        self._delayed: list[tuple[float, str]] = []  # (ready_at, key) heap
        self._shutdown = False
        #: Rate-limited requeues over the queue's lifetime (the
        #: ``tpushare_workqueue_retries_total`` gauge).
        self._retries = 0

    # ------------------------------------------------------------------ #

    def add(self, key: str) -> None:
        with self._cond:
            if self._shutdown or key in self._dirty:
                return
            self._dirty.add(key)
            if key not in self._processing:
                self._queue.append(key)
                self._cond.notify()

    def add_after(self, key: str, delay: float) -> None:
        with self._cond:
            if self._shutdown:
                return
            heapq.heappush(self._delayed, (time.monotonic() + delay, key))
            self._cond.notify()

    def add_rate_limited(self, key: str) -> None:
        """Requeue with exponential backoff (failure count scoped per key)."""
        with self._cond:
            fails = self._failures.get(key, 0)
            self._failures[key] = fails + 1
            self._retries += 1
        self.add_after(key, min(self._base * (2 ** fails), self._max))

    def forget(self, key: str) -> None:
        with self._cond:
            self._failures.pop(key, None)

    def get(self, timeout: float | None = None) -> str | None:
        """Block for the next key; None on shutdown/timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                self._promote_delayed_locked()
                if self._queue:
                    key = self._queue.pop(0)
                    self._dirty.discard(key)
                    self._processing.add(key)
                    return key
                if self._shutdown:
                    return None
                wait = self._next_wait_locked(deadline)
                if wait is not None and wait <= 0:
                    return None
                self._cond.wait(wait)

    def done(self, key: str) -> None:
        with self._cond:
            self._processing.discard(key)
            if key in self._dirty:
                self._queue.append(key)
                self._cond.notify()

    def shut_down(self) -> None:
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()

    def __len__(self) -> int:
        with self._cond:
            return len(self._queue) + len(self._delayed)

    # ------------------------------------------------------------------ #

    def stats(self) -> dict:
        """One consistent snapshot for the /metrics scrape: ready keys,
        keys in backoff, keys a worker holds, lifetime requeues."""
        with self._cond:
            return {
                "depth": len(self._queue),
                "delayed": len(self._delayed),
                "in_flight": len(self._processing),
                "retries": self._retries,
            }

    def _promote_delayed_locked(self) -> None:
        now = time.monotonic()
        while self._delayed and self._delayed[0][0] <= now:
            _, key = heapq.heappop(self._delayed)
            if key not in self._dirty:
                self._dirty.add(key)
                if key not in self._processing:
                    self._queue.append(key)

    def _next_wait_locked(self, deadline: float | None) -> float | None:
        """Seconds to sleep before the next actionable moment."""
        candidates = []
        if self._delayed:
            candidates.append(self._delayed[0][0] - time.monotonic())
        if deadline is not None:
            candidates.append(deadline - time.monotonic())
        if not candidates:
            return None
        return min(candidates)
