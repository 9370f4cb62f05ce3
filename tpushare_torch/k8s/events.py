"""Kubernetes Event emission, the port's copy of the recorder of
``tpushare/k8s/events.py``.

``record`` enqueues and returns; a daemon thread posts to the apiserver,
so a sweep never waits on an apiserver round trip for its telemetry. The
queue is bounded, and under a backlog events are dropped (as client-go's
broadcaster drops them): an Event is telemetry, and each drop, or failed
POST, counts ``tpushare_events_dropped_total``. The message ends in
``[trace <id>]``, the decision trace that ``/debug/trace`` looks up.
"""

from __future__ import annotations

import datetime
import itertools
import logging
import queue
import threading
import time

from tpushare_torch import trace
from tpushare_torch.api.objects import Pod
from tpushare_torch.utils import locks

log = logging.getLogger(__name__)

COMPONENT = "tpushare-scheduler-extender"

_seq = itertools.count(1)
_queue: "queue.Queue[tuple[object, str, dict]]" = queue.Queue(maxsize=1024)
_worker: threading.Thread | None = None
_worker_lock = locks.TracingRLock("events/worker")
#: A saturated queue drops many events: one warning a window, the rest
#: debug (the counter carries the rate).
_drop_warn_interval_s = 30.0
_last_drop_warn = 0.0


def _dropped() -> None:
    from tpushare_torch.routes import metrics
    metrics.safe_inc(metrics.EVENTS_DROPPED)


def queue_depth() -> int:
    """Events accepted and not yet posted (the
    ``tpushare_events_queue_depth`` gauge)."""
    return _queue.qsize()


def _drain() -> None:
    while True:
        client, namespace, event = _queue.get()
        try:
            client.create_event(namespace, event)
        except Exception as exc:  # noqa: BLE001 - telemetry never throws
            # A failed POST is a dropped event.
            _dropped()
            log.debug("event emission failed for %s/%s: %s", namespace,
                      event["metadata"]["name"], exc)
        finally:
            _queue.task_done()


def _ensure_worker() -> None:
    global _worker
    with _worker_lock:
        if _worker is None or not _worker.is_alive():
            _worker = threading.Thread(target=_drain,
                                       name="tpushare-events", daemon=True)
            _worker.start()


def flush(timeout: float = 2.0) -> bool:
    """Wait until every queued event was posted, or ``timeout``; True
    when drained."""
    deadline = time.monotonic() + timeout
    while _queue.unfinished_tasks:
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.001)
    return True


def record(client, pod: Pod, reason: str, message: str,
           event_type: str = "Normal", trace_id: str | None = None) -> None:
    """Queue a v1 Event about ``pod``; never blocks, never raises. The
    message ends in ``[trace <id>]``: the decision active on this thread,
    or ``trace_id`` when recording about another pod's decision (a gang's
    commit and expiry emit for every member from one thread, and each
    Event must carry its own member's id, the one in its annotation)."""
    if trace_id is None:
        trace_id = trace.current_trace_id()
    if trace_id:
        message = f"{message} [trace {trace_id}]"
    now_dt = datetime.datetime.now(datetime.timezone.utc)
    now = now_dt.strftime("%Y-%m-%dT%H:%M:%SZ")
    # Named as client-go's recorder names them: the pod, a time-derived
    # part and a counter, unique across daemon restarts.
    stamp = int(now_dt.timestamp() * 1e9)
    event = {
        "apiVersion": "v1",
        "kind": "Event",
        "metadata": {"name": f"{pod.name}.{stamp:x}.{next(_seq):x}",
                     "namespace": pod.namespace},
        "involvedObject": {"apiVersion": "v1", "kind": "Pod",
                           "name": pod.name, "namespace": pod.namespace,
                           "uid": pod.uid},
        "reason": reason,
        "message": message,
        "type": event_type,
        "source": {"component": COMPONENT},
        "firstTimestamp": now,
        "lastTimestamp": now,
        "count": 1,
    }
    try:
        _queue.put_nowait((client, pod.namespace, event))
    except queue.Full:
        global _last_drop_warn
        _dropped()
        now_s = time.monotonic()
        if now_s - _last_drop_warn >= _drop_warn_interval_s:
            _last_drop_warn = now_s
            log.warning("event queue full; dropping %s for %s", reason,
                        pod.key())
        else:
            log.debug("event queue full; dropping %s for %s", reason,
                      pod.key())
        return
    _ensure_worker()

#: The extender's reasons (the reference's names).
REASON_BOUND = "TPUShareBound"
REASON_BIND_FAILED = "TPUShareBindFailed"
REASON_GANG_PENDING = "TPUShareGangPending"
REASON_GANG_EXPIRED = "TPUShareGangExpired"
REASON_GANG_REAPED = "TPUShareGangReaped"
REASON_GANG_COMMITTED = "TPUShareGangCommitted"
REASON_QUOTA_DENIED = "TPUShareQuotaDenied"
REASON_SLO_BURN = "TPUShareSLOBurn"
REASON_DEFRAG_MOVE = "TPUShareDefragMove"
REASON_DEFRAG_ABORTED = "TPUShareDefragAborted"
REASON_ANOMALY = "TPUShareAnomaly"
REASON_NODE_NOTREADY = "TPUShareNodeNotReady"
