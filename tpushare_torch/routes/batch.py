"""Micro-batch gate for the read verbs (filter and prioritize).

The port's copy of ``tpushare/routes/batch.py``. N simultaneous
scheduling cycles would each take a ``node_table()`` snapshot and probe
the admission index; the verbs are pure reads of the same ledger, so
requests that arrive while a drain is in flight form the next batch, run
on one thread against one snapshot (the per-shape memos then collapse
the probes of same-shape pods), and every waiter's response flushes as
the batch completes.

* A lone request bypasses the gate (one uncontended Condition acquire,
  no window), so single-client latency is the handler's.
* A batch closes at ``max_batch`` requests or the ``window_s`` fill
  window (0.5 ms), and the window runs only when two requests are
  already concurrent.
* Each request's gate wait is reported back (``queue;dur=`` in
  ``Server-Timing``, and the decision span's ``queueSeconds``), so
  batching never hides latency it added.
* Each drain's size goes to ``tpushare_http_batch_size``, and
  :meth:`VerbBatcher.stats` feeds ``/debug/http``. The request's
  ``traceparent`` rides on its item, so the decision the executor opens
  keeps its causal parent.

A handler that raises fails its whole batch loudly: every waiter
re-raises.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

from tpushare_torch.routes import metrics

#: Default fill window: long enough for a concurrent burst to coalesce,
#: short enough to be invisible next to a 1-2 ms handler clock.
DEFAULT_WINDOW_S = 0.0005
DEFAULT_MAX_BATCH = 16


class WorkItem:
    __slots__ = ("args", "t0", "done", "result", "error", "queue_s",
                 "parent")

    def __init__(self, args: Any, parent: str = "") -> None:
        self.args = args
        self.t0 = time.perf_counter()
        self.done = False
        self.result: Any = None
        self.error: BaseException | None = None
        self.queue_s = 0.0
        #: The causal parent trace id of the request's ``traceparent``.
        self.parent = parent


class VerbBatcher:
    """One gate per verb. ``run_batch`` is the verb's batch executor:
    ``run_batch(items: list[WorkItem]) -> list[result]`` (same order),
    with the shared-snapshot sharing inside it; each item carries the
    request (``item.args``) and its measured gate wait
    (``item.queue_s``) for the cost ledger's queue split."""

    def __init__(self, run_batch: Callable[[list[WorkItem]], list[Any]],
                 max_batch: int = DEFAULT_MAX_BATCH,
                 window_s: float = DEFAULT_WINDOW_S,
                 enabled: bool = True) -> None:
        self.run_batch = run_batch
        self.max_batch = max(1, max_batch)
        self.window_s = max(0.0, window_s)
        #: Off: every request runs alone (the un-batched path).
        self.enabled = enabled
        self._cond = threading.Condition()
        self._pending: list[WorkItem] = []
        self._draining = False
        # GIL-bumped stats for /debug/http: drains, requests that shared
        # a batch, and the largest batch seen.
        self.drains = 0
        self.batched = 0
        self.max_batch_seen = 0

    # -- public API -------------------------------------------------------- #

    def submit(self, args: Any, parent: str = "") -> tuple[Any, float]:
        """Run ``args`` through the gate; returns ``(result,
        queue_wait_seconds)``. Raises whatever the executor raised."""
        if not self.enabled:
            return self.run_batch([WorkItem(args, parent)])[0], 0.0
        item = WorkItem(args, parent)
        with self._cond:
            if not self._draining and not self._pending:
                # Depth 1: nothing queued, nothing in flight — the
                # direct path. _draining marks the gate busy so a
                # concurrent arrival queues behind us (and becomes
                # the seed of the next batch).
                self._draining = True
                direct = True
            else:
                self._pending.append(item)
                # Wake a drainer holding its fill window open: the
                # whole point of the window is catching this arrival.
                self._cond.notify_all()
                direct = False
        if direct:
            try:
                self._observe(1)
                return self.run_batch([item])[0], 0.0
            finally:
                self._release()
        return self._wait(item)

    def stats(self) -> dict[str, int | float]:
        return {"drains": self.drains, "batchedRequests": self.batched,
                "maxBatch": self.max_batch_seen,
                "pending": len(self._pending),
                "windowMs": self.window_s * 1e3,
                "maxBatchLimit": self.max_batch,
                "enabled": self.enabled}

    # -- internals --------------------------------------------------------- #

    def _release(self) -> None:
        with self._cond:
            self._draining = False
            if self._pending:
                self._cond.notify_all()

    def _wait(self, item: WorkItem) -> tuple[Any, float]:
        """Follower path: park until our batch completes, or inherit
        the drainer role when the gate frees up first."""
        while True:
            with self._cond:
                while not item.done and self._draining:
                    # Bounded wait: a drainer that dies without
                    # notifying (thread killed mid-teardown) must not
                    # park us forever — re-check on a coarse tick.
                    self._cond.wait(0.05)
                if item.done:
                    break
                # Gate is free and our item is still pending: become
                # the drainer for the batch that accumulated.
                self._draining = True
                batch = self._pending[:self.max_batch]
                del self._pending[:len(batch)]
                # Our item may have been crowded out of this batch
                # (arrived past max_batch): drain for the others
                # anyway, then loop again for our own.
            try:
                self._drain(batch)
            finally:
                self._release()
            if item.done:
                break
        if item.error is not None:
            raise item.error
        return item.result, item.queue_s

    #: One straggler tick of the fill window. The window is an upper
    #: bound, not a sentence: when a tick passes with no arrival, the
    #: batch closes immediately — synchronous callers whose requests
    #: are all already IN the batch can never send another until we
    #: answer, and waiting the full window for them is a convoy.
    FILL_TICK_S = 0.0001

    def _fill(self, batch: list[WorkItem], deadline: float) -> None:
        """Hold the batch open for stragglers, up to the window —
        entered only when >= 2 requests were already concurrent, and
        closed at the first idle tick (see FILL_TICK_S)."""
        with self._cond:
            while len(batch) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    return
                self._cond.wait(min(remaining, self.FILL_TICK_S))
                if not self._pending:
                    return  # idle tick: nobody else is coming
                take = self.max_batch - len(batch)
                grabbed = self._pending[:take]
                del self._pending[:len(grabbed)]
                batch.extend(grabbed)

    def _drain(self, batch: list[WorkItem]) -> None:
        if not batch:
            return
        if len(batch) < self.max_batch and self.window_s > 0:
            self._fill(batch, time.perf_counter() + self.window_s)
        t_start = time.perf_counter()
        for it in batch:
            it.queue_s = max(t_start - it.t0, 0.0)
        self._observe(len(batch))
        try:
            results = self.run_batch(batch)
            if len(results) != len(batch):  # executor contract breach
                raise RuntimeError(
                    f"batch executor returned {len(results)} results "
                    f"for {len(batch)} items")
        except BaseException as e:  # noqa: BLE001 - fanned out to waiters
            with self._cond:
                for it in batch:
                    it.error = e
                    it.done = True
                self._cond.notify_all()
            return
        with self._cond:
            for it, res in zip(batch, results):
                it.result = res
                it.done = True
            self._cond.notify_all()

    def _observe(self, size: int) -> None:
        self.drains += 1
        if size > 1:
            self.batched += size
        if size > self.max_batch_seen:
            self.max_batch_seen = size
        metrics.safe_observe(metrics.HTTP_BATCH_SIZE, size)
