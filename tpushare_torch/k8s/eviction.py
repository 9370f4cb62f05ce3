"""Budgeted, retrying eviction through ``pods/eviction``: the port's
copy of ``EvictionBudget`` and ``evict_with_retry`` of
``tpushare/k8s/eviction.py``.

The apiserver answers 429 while a matching PodDisruptionBudget has no
disruption left; the caller retries with backoff rather than hammering
the apiserver or giving up. The grant watchdog's node-local policy runs
an unlimited budget: its streak of overrun sweeps is the rate limit.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable

from tpushare_torch.k8s.errors import ApiError, NotFoundError
from tpushare_torch.utils import locks

#: Terminal statuses of :func:`evict_with_retry`; DENIED_PREFIX is
#: followed by the budget's reason.
EVICTED = "evicted"
GONE = "gone"
BLOCKED = "blocked"
DENIED_PREFIX = "denied:"

REASON_CONCURRENT = "concurrent"
REASON_PER_HOUR = "moves-per-hour"
REASON_NODE_COOLDOWN = "node-cooldown"

_HOUR_S = 3600.0


class EvictionBudget:
    """Caps every eviction passes through; a zero limit is unlimited."""

    def __init__(self, max_concurrent: int = 0,
                 node_cooldown_s: float = 0.0, per_hour: int = 0,
                 now: Callable[[], float] = time.monotonic) -> None:
        self.max_concurrent = max_concurrent
        self.node_cooldown_s = node_cooldown_s
        self.per_hour = per_hour
        self._now = now
        self._lock = locks.TracingRLock("k8s/eviction-budget")
        self._in_flight = 0
        self._node_last: dict[str, float] = locks.guarded_dict(
            self._lock, "EvictionBudget._node_last")
        self._recent: deque[float] = deque()

    def acquire(self, node: str = "") -> str:
        """Admit one attempt: "" when admitted, else the denial reason. An
        admitted attempt is paired with :meth:`release`."""
        now = self._now()
        with self._lock:
            if (self.max_concurrent > 0
                    and self._in_flight >= self.max_concurrent):
                return REASON_CONCURRENT
            while self._recent and now - self._recent[0] > _HOUR_S:
                self._recent.popleft()
            if self.per_hour > 0 and len(self._recent) >= self.per_hour:
                return REASON_PER_HOUR
            if (self.node_cooldown_s > 0 and node
                    and now - self._node_last.get(node, float("-inf"))
                    < self.node_cooldown_s):
                return REASON_NODE_COOLDOWN
            self._in_flight += 1
            return ""

    def release(self, node: str = "", evicted: bool = False) -> None:
        """End an admitted attempt; an eviction uses up the hour's budget
        and starts the node's cooldown."""
        with self._lock:
            self._in_flight = max(self._in_flight - 1, 0)
            if evicted:
                self._recent.append(self._now())
                if node:
                    self._node_last[node] = self._now()


def evict_with_retry(client: Any, namespace: str, name: str, *,
                     budget: EvictionBudget, node: str = "",
                     attempts: int = 3, backoff_s: float = 0.2,
                     sleep: Callable[[float], None] = time.sleep) -> str:
    """Evict ``namespace/name``, retrying 429 with exponential backoff.
    Returns :data:`EVICTED`, :data:`GONE` (the pod vanished first),
    :data:`BLOCKED` (still refused after every attempt) or
    ``denied:<reason>``. Other ApiErrors propagate: the caller owns the
    fallback."""
    denied = budget.acquire(node)
    if denied:
        return DENIED_PREFIX + denied
    evicted = False
    try:
        for i in range(max(attempts, 1)):
            try:
                client.evict_pod(namespace, name)
                evicted = True
                return EVICTED
            except NotFoundError:
                return GONE
            except ApiError as e:
                if e.status != 429:
                    raise
                if i + 1 < max(attempts, 1):
                    sleep(backoff_s * (2 ** i))
        return BLOCKED
    finally:
        budget.release(node, evicted=evicted)
