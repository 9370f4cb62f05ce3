"""Kubernetes Event emission, the port's copy of the recorder of
``tpushare/k8s/events.py``.

``record`` enqueues and returns; a daemon thread posts to the apiserver,
so a sweep never waits on an apiserver round trip for its telemetry. The
queue is bounded, and under a backlog events are dropped (as client-go's
broadcaster drops them): an Event is telemetry.
"""

from __future__ import annotations

import datetime
import itertools
import logging
import queue
import threading
import time

from tpushare_torch.api.objects import Pod

log = logging.getLogger(__name__)

COMPONENT = "tpushare-scheduler-extender"

_seq = itertools.count(1)
_queue: "queue.Queue[tuple[object, str, dict]]" = queue.Queue(maxsize=1024)
_worker: threading.Thread | None = None
_worker_lock = threading.Lock()


def _drain() -> None:
    while True:
        client, namespace, event = _queue.get()
        try:
            client.create_event(namespace, event)
        except Exception as exc:  # noqa: BLE001 - telemetry never throws
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
           event_type: str = "Normal") -> None:
    """Queue a v1 Event about ``pod``; never blocks, never raises."""
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
        log.warning("event queue full; dropping %s for %s", reason,
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
