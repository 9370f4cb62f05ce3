"""Pod journeys: end-to-end scheduling latency, per pod.

The port's copy of ``tpushare/slo/journey.py``.

Every latency number the extender exported before this module was
per-HTTP-request: ``tpushare_filter_latency_seconds`` can say a filter
call took 0.4 ms while a pod that was denied forty times over ten
minutes before finally binding stays invisible — the aggregate-histogram
gap, and the signal kube-scheduler itself treats
as primary (``e2e_scheduling_duration``). A **journey** is the missing
record: one pod's story from creation to bound (or deleted/abandoned),
linking every placement attempt's trace-id from the flight recorder
(:mod:`tpushare_torch.trace`) and splitting *queue wait* (time parked between
attempts) from *in-verb* time (time inside the extender's handlers).

Journeys open when the informer first delivers an unassigned TPU-share
pod — or on its first filter attempt, whichever comes first — and close
on bind, delete-unbound, or table-pressure abandonment. The clock is
the pod's ``metadata.creationTimestamp`` (apiserver truth), not local
first-sight, so the number is the user's experienced wait and survives
extender restarts: a **bound** pod's journey is reconstructed after a
cache rebuild from ``tpushare.io/assume-time`` minus the creation
timestamp — annotation truth, the same discipline as the chip ledger.

Closed journeys feed ``tpushare_pod_e2e_scheduling_seconds`` and
``tpushare_pod_scheduling_attempts`` (labels: tenant, outcome — both
bounded sets; pod names, uids and trace-ids never become labels) and
the SLO engine's
error-budget windows (:mod:`tpushare_torch.slo.engine`).

Design constraints match the flight recorder's: recording trouble
increments a drop counter and the scheduling path goes on without it;
both tables are bounded; the metrics module is imported lazily so this
module stays importable from the informer/controller layer.
"""

from __future__ import annotations

import datetime
import time
from collections import deque
from typing import Any, Callable

from tpushare_torch.api.objects import Pod
from tpushare_torch.trace.recorder import Decision, DropCounter
from tpushare_torch.utils import k8stime, locks
from tpushare_torch.utils import pod as podutils

#: Closed journeys kept for ``GET /debug/journey`` lookups.
DEFAULT_CAPACITY = 256
#: Open journeys tracked at once; beyond this the oldest is retired as
#: "abandoned" so pods that never bind cannot grow the table unbounded.
DEFAULT_MAX_OPEN = 512
#: Per-journey attempt refs kept verbatim (half oldest, half newest); a
#: pod denied for days must not pin thousands of Decision objects.
MAX_ATTEMPT_REFS = 64

#: Journey outcomes that feed the histograms and the SLO engine
#: ("superseded" is bookkeeping — a missed delete — not an experience).
MEASURED_OUTCOMES = ("bound", "deleted", "abandoned")


def parse_k8s_time(stamp: str) -> float:
    """RFC-3339 apiserver timestamp -> epoch seconds (0.0 when absent
    or unparseable — callers fall back to their local clock). One
    parser shared with the leader elector (utils/k8stime)."""
    return k8stime.parse_rfc3339_epoch(stamp)


def _iso(epoch_s: float) -> str:
    return datetime.datetime.fromtimestamp(
        epoch_s, datetime.timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")


class Journey:
    """One pod's end-to-end scheduling story."""

    def __init__(self, namespace: str, name: str, uid: str, tenant: str,
                 opened_at: float, source: str) -> None:
        self.namespace = namespace
        self.name = name
        self.uid = uid
        self.tenant = tenant
        #: Epoch seconds the user-facing clock starts at (the pod's
        #: creationTimestamp when known, else first sight).
        self.opened_at = opened_at
        #: "informer" | "filter" | "reconstructed" — where the journey
        #: was first seen (reconstructed = rebuilt from annotations).
        self.source = source
        #: Flight-recorder decisions, oldest first (capped; see
        #: ``attempts_total`` for the true count).
        self.attempts: list[Decision] = []
        self.attempts_total = 0
        #: In-verb seconds folded in from attempt refs the cap evicted.
        self._in_verb_folded = 0.0
        self.outcome = "open"
        self.closed_at = 0.0
        self.done = False

    # -- accounting ------------------------------------------------------ #

    def link(self, dec: Decision) -> bool:
        """Append ``dec`` as a new attempt (False when it is already the
        latest — one decision spans several verbs/HTTP requests)."""
        if self.attempts and self.attempts[-1] is dec:
            return False
        self.attempts_total += 1
        self.attempts.append(dec)
        if len(self.attempts) > MAX_ATTEMPT_REFS:
            # Keep the first half (how the journey started) and the
            # newest half (how it is going); fold the evicted middle's
            # verb time so the queue-wait split stays truthful.
            evict = self.attempts.pop(MAX_ATTEMPT_REFS // 2)
            self._in_verb_folded += _in_verb_of(evict)
        return True

    def in_verb_seconds(self) -> float:
        return self._in_verb_folded + sum(
            _in_verb_of(dec) for dec in self.attempts)

    def e2e_seconds(self, now: float) -> float:
        end = self.closed_at if self.done else now
        return max(end - self.opened_at, 0.0)

    def queue_wait_seconds(self, now: float) -> float:
        return max(self.e2e_seconds(now) - self.in_verb_seconds(), 0.0)

    def finish(self, outcome: str, closed_at: float) -> None:
        if self.done:
            return
        self.done = True
        self.outcome = outcome
        self.closed_at = closed_at

    def to_json(self, now: float) -> dict:
        # Round once and derive the split from the ROUNDED halves:
        # rounding all three independently can break the published
        # e2e = queueWait + inVerb identity by 1e-6.
        e2e = round(self.e2e_seconds(now), 6)
        in_verb = round(self.in_verb_seconds(), 6)
        doc: dict[str, Any] = {
            "namespace": self.namespace,
            "name": self.name,
            "uid": self.uid,
            "tenant": self.tenant,
            "openedAt": _iso(self.opened_at),
            "source": self.source,
            "outcome": self.outcome,
            "e2eSeconds": e2e,
            "inVerbSeconds": in_verb,
            "queueWaitSeconds": max(round(e2e - in_verb, 6), 0.0),
            "attemptsTotal": max(self.attempts_total,
                                 1 if self.source == "reconstructed"
                                 else self.attempts_total),
            # list() snapshots against concurrent link() from a handler
            # thread; Decision objects are safe to read concurrently.
            "attempts": [{
                "traceId": dec.trace_id,
                "startedAt": _iso(dec.started_at),
                "outcome": dec.outcome,
                "node": dec.node,
                "inVerbSeconds": round(_in_verb_of(dec), 6),
            } for dec in list(self.attempts)],
        }
        if self.done:
            doc["closedAt"] = _iso(self.closed_at)
        if self.source == "reconstructed":
            doc["reconstructed"] = True
        return doc


def _in_verb_of(dec: Decision) -> float:
    """Seconds this decision spent inside extender verbs: the sum of
    its top-level spans (nested spans are already contained)."""
    return sum(sp.seconds for sp in list(dec.spans) if sp.depth == 0)


class JourneyTracker:
    """Open-journey table + ring of closed journeys.

    Thread model: the recorder's — handlers and informer threads mutate
    under one lock; readers snapshot under it and serialize outside.
    ``on_close`` (the SLO engine's intake) runs OUTSIDE the lock.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 max_open: int = DEFAULT_MAX_OPEN,
                 on_close: Callable[[Journey], None] | None = None,
                 now_fn: Callable[[], float] = time.time) -> None:
        self._lock = locks.TracingRLock("slo/journeys")
        self._capacity = capacity
        self._max_open = max_open
        self._on_close = on_close
        self._now = now_fn
        self._open: dict[tuple[str, str], Journey] = locks.guarded_dict(
            self._lock, "JourneyTracker._open")
        self._ring: deque[Journey] = deque()
        #: uids with a closed journey in the ring — dedupes the bind
        #: echo (routes close, then the informer's sync re-delivers).
        self._closed_uids: set[str] = locks.guarded_set(
            self._lock, "JourneyTracker._closed_uids")
        self.drops = DropCounter()

    # -- opening --------------------------------------------------------- #

    def _opened_at(self, pod: Pod) -> float:
        created = parse_k8s_time(pod.creation_timestamp)
        return created if created > 0 else self._now()

    def open_journey(self, pod: Pod, source: str = "informer") -> None:
        """Start (idempotently) tracking an unassigned TPU-share pod.
        Guarded: journey trouble increments the drop counter, never the
        informer handler's problem."""
        try:
            retired: list[tuple[Journey, str]] = []
            key = (pod.namespace, pod.name)
            with self._lock:
                if pod.uid and pod.uid in self._closed_uids:
                    return
                cur = self._open.get(key)
                if cur is not None:
                    if pod.uid and cur.uid and cur.uid != pod.uid:
                        # Same name, new uid: the delete event was
                        # missed — retire the stale journey as
                        # bookkeeping.
                        del self._open[key]
                        retired.append((cur, "superseded"))
                    else:
                        if pod.uid and not cur.uid:
                            cur.uid = pod.uid
                        return
                journey = Journey(pod.namespace, pod.name, pod.uid,
                                  podutils.get_tenant(pod),
                                  self._opened_at(pod), source)
                retired.extend(self._insert_open_locked(key, journey))
            for old, outcome in retired:
                self._close(old, outcome)
        except Exception:  # noqa: BLE001 - telemetry must not throw
            self.drops.inc()

    def _insert_open_locked(
            self, key: tuple[str, str],
            journey: Journey) -> list[tuple[Journey, str]]:
        """Insert under the (held) lock; RETURNS the table-pressure
        evictions for the caller to close AFTER releasing the lock —
        closing runs histogram observes and the engine intake, which
        must never run under the tracker lock (the class contract)."""
        evicted: list[tuple[Journey, str]] = []
        with self._lock:
            while len(self._open) >= self._max_open:
                oldest = min(self._open,
                             key=lambda k: self._open[k].opened_at)
                evicted.append((self._open.pop(oldest), "abandoned"))
            self._open[key] = journey
        return evicted

    # -- attempts (routes layer) ----------------------------------------- #

    def note_decision(self, namespace: str, name: str, uid: str,
                      dec: Decision | None, pod: Pod | None = None,
                      open_new: bool = True) -> None:
        """Link a flight-recorder decision to its pod's journey, opening
        one on the first filter attempt if the informer has not yet
        (``pod`` supplies the creation clock when available). A decision
        already finished as *bound* closes the journey.

        ``open_new=False`` (the bind verb) links and closes but never
        STARTS a journey: a bind with no journey means this replica
        restarted mid-story, and the controller's annotation-truth
        reconstruction owns that case — opening here would stamp a
        ~zero e2e over the pod's real wait."""
        if dec is None:
            return
        try:
            retired: list[tuple[Journey, str]] = []
            key = (namespace, name)
            with self._lock:
                journey = self._open.get(key)
                if journey is None:
                    if not open_new:
                        return
                    if uid and uid in self._closed_uids:
                        return
                    opened_at = (self._opened_at(pod) if pod is not None
                                 else self._now())
                    tenant = (podutils.get_tenant(pod) if pod is not None
                              else namespace)
                    journey = Journey(namespace, name, uid, tenant,
                                      opened_at, "filter")
                    retired.extend(
                        self._insert_open_locked(key, journey))
                elif uid and journey.uid and journey.uid != uid:
                    # Recreated pod racing a missed delete: retire the
                    # old story; the new pod's own journey starts here
                    # only when this verb MAY open one (the bind verb
                    # may not — it has no creation clock or tenant in
                    # hand, and a now-opened journey would stamp a ~0s
                    # "good" e2e over the pod's real wait).
                    del self._open[key]
                    retired.append((journey, "superseded"))
                    journey = None
                    if open_new:
                        journey = Journey(
                            namespace, name, uid,
                            podutils.get_tenant(pod) if pod is not None
                            else namespace,
                            self._opened_at(pod) if pod is not None
                            else self._now(), "filter")
                        retired.extend(
                            self._insert_open_locked(key, journey))
                if journey is not None:
                    journey.link(dec)
            for old, outcome in retired:
                self._close(old, outcome)
            if dec.done and dec.outcome == "bound":
                self.pod_bound_key(namespace, name)
        except Exception:  # noqa: BLE001 - telemetry must not throw
            self.drops.inc()

    # -- closing --------------------------------------------------------- #

    def pod_bound_key(self, namespace: str, name: str) -> None:
        """Close the open journey for ``namespace/name`` as bound (the
        routes-layer path: bind succeeded on this replica)."""
        try:
            with self._lock:
                journey = self._open.pop((namespace, name), None)
            if journey is not None:
                self._close(journey, "bound")
        except Exception:  # noqa: BLE001 - telemetry must not throw
            self.drops.inc()

    def pod_bound(self, pod: Pod) -> None:
        """Controller-side close: the informer confirmed ``pod`` is
        assumed on a node. Closes the live journey if one is open (gang
        members committed by the planner thread and binds taken by an
        HA peer arrive here, not through this replica's /bind route);
        a pod with no open journey — already closed by the routes
        layer, or a sync echo — is a no-op."""
        self.pod_bound_key(pod.namespace, pod.name)

    def reconstruct(self, pod: Pod) -> None:
        """Cache-rebuild path (controller start): rebuild a BOUND pod's
        journey from annotation truth — e2e = ``tpushare.io/assume-time``
        minus ``creationTimestamp`` — so the e2e histogram survives
        restarts the same way the chip ledger does. Called exactly once
        per pod per process start; attempts before the restart are
        unknowable, so the attempt count floors at 1. Reconstructed
        journeys feed the HISTOGRAM only, never the SLO engine's
        rolling windows (``_retire``): those binds happened before the
        restart, and replaying them stamped "now" would fire — or mask
        — a burn alert about the past."""
        try:
            with self._lock:
                if pod.uid and pod.uid in self._closed_uids:
                    return
                self._open.pop((pod.namespace, pod.name), None)
            assume_ns = podutils.get_assume_time(pod)
            created = parse_k8s_time(pod.creation_timestamp)
            if assume_ns <= 0 or created <= 0:
                return  # not enough annotation truth to reconstruct
            journey = Journey(pod.namespace, pod.name, pod.uid,
                              podutils.get_tenant(pod), created,
                              "reconstructed")
            journey.finish("bound", assume_ns / 1e9)
            self._retire(journey)
        except Exception:  # noqa: BLE001 - telemetry must not throw
            self.drops.inc()

    def pod_deleted(self, pod: Pod) -> None:
        """A pod vanished; if its journey is still open (never bound),
        that is the ``deleted`` outcome — the user gave up, or an
        operator/controller withdrew the pod mid-journey."""
        try:
            with self._lock:
                journey = self._open.get((pod.namespace, pod.name))
                if journey is None or (pod.uid and journey.uid
                                       and journey.uid != pod.uid):
                    return
                del self._open[(pod.namespace, pod.name)]
            self._close(journey, "deleted")
        except Exception:  # noqa: BLE001 - telemetry must not throw
            self.drops.inc()

    def _close(self, journey: Journey, outcome: str) -> None:
        journey.finish(outcome, self._now())
        self._retire(journey)

    def _retire(self, journey: Journey) -> None:
        with self._lock:
            self._ring.append(journey)
            if journey.uid:
                self._closed_uids.add(journey.uid)
            while len(self._ring) > self._capacity:
                evicted = self._ring.popleft()
                if evicted.uid:
                    self._closed_uids.discard(evicted.uid)
        self._observe(journey)
        # Reconstructed journeys are HISTORY: they refill the histogram
        # a restart wiped, but must not enter the engine's rolling
        # windows as if they closed now — yesterday's slow binds would
        # fire today's burn alert (and yesterday's fast ones would mask
        # a live burn).
        if self._on_close is not None \
                and journey.outcome in MEASURED_OUTCOMES \
                and journey.source != "reconstructed":
            try:
                self._on_close(journey)
            except Exception:  # noqa: BLE001 - engine trouble stays here
                self.drops.inc()

    def _observe(self, journey: Journey) -> None:
        """Feed the prometheus histograms (lazy import: this module is
        loaded by informer-layer consumers that must not pay for
        prometheus_client at import time)."""
        if journey.outcome not in MEASURED_OUTCOMES:
            return
        try:
            from tpushare_torch.routes import metrics
            e2e = journey.e2e_seconds(journey.closed_at)
            metrics.POD_E2E.labels(
                tenant=journey.tenant,
                outcome=journey.outcome).observe(e2e)
            metrics.POD_ATTEMPTS.labels(
                tenant=journey.tenant, outcome=journey.outcome).observe(
                max(journey.attempts_total, 1))
        except Exception:  # noqa: BLE001 - metrics must not throw
            self.drops.inc()

    # -- readers --------------------------------------------------------- #

    def get_journey(self, namespace: str, name: str) -> dict | None:
        """The pod's journey: the open one if still in flight, else the
        newest closed one."""
        now = self._now()
        with self._lock:
            journey = self._open.get((namespace, name))
            if journey is None:
                for closed in reversed(self._ring):
                    if (closed.namespace == namespace
                            and closed.name == name):
                        journey = closed
                        break
        return journey.to_json(now) if journey is not None else None

    def stats(self) -> dict:
        """Aggregate view for ``/debug/slo`` and the simulator report."""
        now = self._now()
        with self._lock:
            open_n = len(self._open)
            closed = list(self._ring)
        by_outcome: dict[str, int] = {}
        e2e_bound: list[float] = []
        attempts_bound: list[int] = []
        for j in closed:
            by_outcome[j.outcome] = by_outcome.get(j.outcome, 0) + 1
            if j.outcome == "bound":
                e2e_bound.append(j.e2e_seconds(now))
                attempts_bound.append(max(j.attempts_total, 1))
        e2e_bound.sort()

        def pct(q: float) -> float | None:
            if not e2e_bound:
                return None
            idx = min(int(len(e2e_bound) * q), len(e2e_bound) - 1)
            return round(e2e_bound[idx], 6)

        return {
            "open": open_n,
            "closed": by_outcome,
            "meanAttempts": (round(sum(attempts_bound)
                                   / len(attempts_bound), 2)
                             if attempts_bound else None),
            "p50E2eSeconds": pct(0.50),
            "p99E2eSeconds": pct(0.99),
        }

    def reset(self) -> None:
        with self._lock:
            self._open.clear()
            self._ring.clear()
            self._closed_uids.clear()
            self.drops = DropCounter()
