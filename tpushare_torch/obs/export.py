"""Push export pipeline: journal frames and metric snapshots over HTTP.

The port's copy of ``tpushare/obs/export.py``.

The black-box journal (:mod:`tpushare_torch.obs.blackbox`) keeps the crash
story on the node's disk; this module ships the same records off the
node while the process is healthy. A background exporter drains a
bounded queue and POSTs JSON-lines batches to ``TPUSHARE_EXPORT_URL``
(off by default — no URL, no exporter, no thread).

The contract mirrors every other obs intake: :meth:`Exporter.offer` is
fire-and-forget (full queue drops and counts, never blocks a verb), the
sink being down costs retries with exponential backoff — never caller
latency — and a sustained outage past ``stall_after`` consecutive
failures raises the ``export-stall`` marker via the ``on_stall`` hook
so the operator sees the gap in the timeline rather than discovering
it in the sink.

Unit-testability is wired in: ``post``, ``clock``, and ``sleep`` are
injectable, so retry/backoff schedules are asserted against a fake
clock with no sockets and no real time (tests/test_blackbox.py).
"""

from __future__ import annotations

import json
import os
import threading
import urllib.request
from collections import deque
from typing import Any, Callable

from tpushare_torch.trace.recorder import DropCounter
from tpushare_torch.utils import locks

#: Bounded intake between emission sites and the exporter thread.
QUEUE_DEPTH = 2048
#: Records per POST; a burst drains in ceil(burst/BATCH_MAX) requests.
BATCH_MAX = 64
#: Backoff schedule on sink failure: base doubles per consecutive
#: failure, capped. 0.5 → 1 → 2 → ... → 30s.
BACKOFF_BASE_S = 0.5
BACKOFF_CAP_S = 30.0
#: Consecutive failures before the exporter declares a stall (the
#: ``export-stall`` marker fires once per outage, not per retry).
STALL_AFTER = 3
#: Idle poll interval when the queue is empty and the sink healthy.
POLL_INTERVAL_S = 1.0
_POST_TIMEOUT_S = 5.0


def export_url() -> str:
    """The arming switch: an exporter exists iff
    ``TPUSHARE_EXPORT_URL`` names a sink."""
    return os.environ.get("TPUSHARE_EXPORT_URL", "")


def _default_post(url: str, body: bytes) -> None:
    """POST one JSON-lines batch; any non-2xx or transport error
    raises (the loop's retry/backoff handles it)."""
    req = urllib.request.Request(
        url, data=body, method="POST",
        headers={"Content-Type": "application/x-ndjson"})
    with urllib.request.urlopen(req, timeout=_POST_TIMEOUT_S) as resp:
        resp.read()


class Exporter:
    """Background JSON-lines push exporter with bounded queue,
    exponential backoff, and stall detection.

    The queue is a lock-free bounded deque (GIL-atomic, like the
    journal intake); ``_pending`` — the batch popped but not yet
    acknowledged by the sink — is shared between the loop thread and
    the shutdown flush, so it mutates only under ``self._lock``.
    """

    def __init__(self, url: str, *,
                 post: Callable[[str, bytes], None] | None = None,
                 clock: Callable[[], float] | None = None,
                 sleep: Callable[[float], bool] | None = None,
                 batch_max: int = BATCH_MAX,
                 queue_cap: int = QUEUE_DEPTH,
                 backoff_base: float = BACKOFF_BASE_S,
                 backoff_cap: float = BACKOFF_CAP_S,
                 stall_after: int = STALL_AFTER) -> None:
        self.url = url
        self._post = post if post is not None else _default_post
        self._stop = threading.Event()
        # Default sleep rides the stop event so stop() interrupts a
        # long backoff immediately; returns True when stopping.
        self._sleep = (sleep if sleep is not None
                       else lambda s: self._stop.wait(timeout=s))
        self._clock = clock
        self.batch_max = batch_max
        self.queue_cap = queue_cap
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.stall_after = stall_after
        self._lock = locks.TracingRLock("obs/export")
        self._queue: deque[dict[str, Any]] = deque()
        self._pending: list[dict[str, Any]] = []
        self._thread: threading.Thread | None = None
        self._failures = 0
        self._stalled = False
        self.drops = DropCounter()
        self.sent_batches = 0
        self.sent_records = 0
        self.failed_posts = 0
        self.stalls = 0
        #: Stall hook (``hook(consecutive_failures)``) — obs wires the
        #: ``export-stall`` marker here; failures are drop-counted.
        self.on_stall: Callable[[int], None] | None = None

    # -- lifecycle -------------------------------------------------------- #

    def start(self) -> bool:
        if self._thread is not None and self._thread.is_alive():
            return False
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="tpushare-export", daemon=True)
        self._thread.start()
        return True

    def stop(self) -> None:
        """Stop the loop; one last best-effort flush of what's queued
        (a dead sink at shutdown drops the tail, counted)."""
        self._stop.set()
        thread = self._thread
        self._thread = None
        if thread is not None and thread.is_alive():
            thread.join(timeout=2.0)
        leftover = len(self._pending) + len(self._queue)
        if leftover:
            try:
                self._tick()
            except Exception:  # noqa: BLE001 - shutdown flush is best-effort
                pass
            leftover = len(self._pending) + len(self._queue)
            if leftover:
                with self._lock:
                    self._pending.clear()
                self._queue.clear()
                self.drops.inc(leftover)

    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- intake ------------------------------------------------------------ #

    def offer(self, doc: dict[str, Any]) -> None:
        """Fire-and-forget: enqueue one record for the sink. A full
        queue (sink behind, or down and backing off) drops the record
        and counts it."""
        try:
            if len(self._queue) >= self.queue_cap:
                self.drops.inc()
                return
            self._queue.append(doc)
        except Exception:  # noqa: BLE001 - export must never reach callers
            self.drops.inc()

    # -- loop -------------------------------------------------------------- #

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                sent = self._tick()
            except Exception:  # noqa: BLE001 - loop must survive anything
                self.drops.inc()
                sent = False
            if self._failures:
                if self._sleep(self._backoff(self._failures)):
                    break
            elif not sent and self._sleep(POLL_INTERVAL_S):
                break

    def _tick(self) -> bool:
        """One attempt: take (or retake) a batch, POST it. Returns
        True when a batch was delivered. The pending batch is re-sent
        after a failure so a flaky sink loses nothing (dedup is the
        sink's problem — frames carry cursors/timestamps)."""
        with self._lock:
            if not self._pending:
                while len(self._pending) < self.batch_max:
                    try:
                        self._pending.append(self._queue.popleft())
                    except IndexError:
                        break
            batch = list(self._pending)
        if not batch:
            return False
        body = "\n".join(
            json.dumps(doc, separators=(",", ":"))
            for doc in batch).encode() + b"\n"
        try:
            self._post(self.url, body)
        except Exception:  # noqa: BLE001 - sink down: back off and retry
            self.failed_posts += 1
            self._failures += 1
            if self._failures >= self.stall_after and not self._stalled:
                self._stalled = True
                self.stalls += 1
                hook = self.on_stall
                if hook is not None:
                    try:
                        hook(self._failures)
                    except Exception:  # noqa: BLE001 - hook is telemetry
                        self.drops.inc()
            return False
        self.sent_batches += 1
        self.sent_records += len(batch)
        with self._lock:
            self._pending.clear()
        self._failures = 0
        self._stalled = False
        return True

    def _backoff(self, failures: int) -> float:
        """Exponential: base * 2^(failures-1), capped."""
        return min(self.backoff_base * (2 ** (failures - 1)),
                   self.backoff_cap)

    # -- surface ----------------------------------------------------------- #

    def stats(self) -> dict[str, Any]:
        """The ``/debug/blackbox`` export half."""
        return {
            "url": self.url,
            "running": self.running(),
            "queued": len(self._queue) + len(self._pending),
            "sentBatches": self.sent_batches,
            "sentRecords": self.sent_records,
            "failedPosts": self.failed_posts,
            "consecutiveFailures": self._failures,
            "stalled": self._stalled,
            "stalls": self.stalls,
            "drops": self.drops.value,
        }
