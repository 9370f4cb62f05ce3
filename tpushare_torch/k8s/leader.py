"""Lease-based leader election: safe multi-replica extender deployment.

The port's copy of ``tpushare/k8s/leader.py``, with a plain
``threading.RLock``; the timeline mark of a leadership change waits for
the port's observability slice (the log line stays).

gpushare runs exactly one replica because two extenders cannot safely
bind concurrently: each replica's ledger is an eventually-
consistent informer view, so two replicas can both see a chip as free
and bind two pods into the same HBM — the oversubscription the whole
system exists to prevent. The optimistic-concurrency annotation write
narrows but does not close the window (the two pods' annotation updates
don't conflict with *each other*).

Leader election closes it the way kube-scheduler itself does HA: every
replica runs, but only the holder of a ``coordination.k8s.io/v1 Lease``
serves bind. Followers answer bind with 503 so the scheduler retries
(the Service round-robins onto the leader); read paths (filter,
prioritize, preempt, validate, inspect) are served by every replica.
Failover = the old leader stops renewing, the lease expires, a follower
acquires it. The lease's optimistic-concurrency update is the safety
argument: two candidates racing to acquire produce one 409.

Liveness guard: ``is_leader()`` is true only while the *local* clock
confirms a renewal within the lease duration — a leader wedged on
apiserver I/O demotes itself before a follower can legitimately take
over (clock-skew bounded, same argument as client-go's leaderelection
package). The residual exposure is a bind WRITE already in flight when
leadership decays: it can land after a standby has taken over, so the
apiserver request timeout on the bind path must stay below the lease
duration — then any write that lands was issued while the lease was
provably held.
"""

from __future__ import annotations

import logging
import threading
import time
from datetime import datetime, timedelta, timezone

from tpushare_torch.k8s.errors import ApiError, ConflictError
from tpushare_torch.utils.k8stime import parse_rfc3339

log = logging.getLogger(__name__)

_RFC3339 = "%Y-%m-%dT%H:%M:%S.%fZ"


def _now_utc() -> datetime:
    return datetime.now(timezone.utc)


def _fmt(dt: datetime) -> str:
    return dt.strftime(_RFC3339)


def _parse(raw: str) -> datetime | None:
    return parse_rfc3339(raw)


class LeaderElector:
    def __init__(self, client, identity: str,
                 namespace: str = "kube-system",
                 name: str = "tpushare-schd-extender",
                 lease_duration: float = 15.0,
                 renew_period: float = 5.0):
        self.client = client
        self.identity = identity
        self.namespace = namespace
        self.name = name
        self.lease_duration = lease_duration
        self.renew_period = renew_period
        self._leader = False
        self._last_renew = 0.0  # monotonic time of last confirmed renewal
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------ #

    def is_leader(self) -> bool:
        """Leadership with a local-clock liveness guard: confirmed by the
        apiserver within the last lease_duration, or not at all."""
        with self._lock:
            return (self._leader and
                    time.monotonic() - self._last_renew < self.lease_duration)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run,
                                        name="tpushare-leader", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop renewing. The lease is left to expire rather than being
        released: a crash gives no chance to release either, so failover
        time must not depend on a graceful exit."""
        self._stop.set()
        with self._lock:
            self._leader = False

    # ------------------------------------------------------------------ #

    def _lease_doc(self, transitions: int, acquire_time: str) -> dict:
        now = _fmt(_now_utc())
        # Whole-second durations go on the wire as the int32 the real
        # apiserver requires; sub-second (test) durations stay float —
        # int() truncation would make a 0.5s lease "0 seconds" and thus
        # permanently expired, i.e. permanently stealable.
        dur = self.lease_duration
        wire_dur = int(dur) if float(dur).is_integer() else dur
        return {
            "apiVersion": "coordination.k8s.io/v1",
            "kind": "Lease",
            "metadata": {"name": self.name, "namespace": self.namespace},
            "spec": {
                "holderIdentity": self.identity,
                "leaseDurationSeconds": wire_dur,
                "acquireTime": acquire_time or now,
                "renewTime": now,
                "leaseTransitions": transitions,
            },
        }

    def _try_acquire_or_renew(self) -> None:
        lease = self.client.get_lease(self.namespace, self.name)
        if lease is None:
            # Stamp the local clock BEFORE the round-trip: the wire's
            # renewTime is also pre-request, so the local leadership
            # window can only be SHORTER than the server-side lease —
            # never longer by an apiserver RTT (client-go's discipline;
            # stamping after a slow PUT would let is_leader() outlive
            # the lease while a peer legitimately takes over).
            attempt_at = time.monotonic()
            try:
                self.client.create_lease(
                    self.namespace, self._lease_doc(0, ""))
            except (ConflictError, ApiError):
                return  # lost the creation race; observe next tick
            self._became(True, "created lease", renew_at=attempt_at)
            return

        spec = lease.get("spec") or {}
        holder = spec.get("holderIdentity", "")
        renew = _parse(spec.get("renewTime", ""))
        duration = float(spec.get("leaseDurationSeconds",
                                  self.lease_duration))
        # A lease with no parseable renewTime (hand-created, or written
        # by a broken tool) must be acquirable — treating it as "renewed
        # now" on every tick would deadlock the election forever.
        expired = (renew is None
                   or _now_utc() > renew + timedelta(seconds=duration))

        if holder == self.identity or expired or not holder:
            doc = self._lease_doc(
                int(spec.get("leaseTransitions", 0))
                + (0 if holder == self.identity else 1),
                spec.get("acquireTime", "")
                if holder == self.identity else "")
            # Carry the resourceVersion: the conflict on concurrent
            # acquisition attempts is what makes election safe.
            doc["metadata"]["resourceVersion"] = \
                lease.get("metadata", {}).get("resourceVersion", "")
            attempt_at = time.monotonic()
            try:
                self.client.update_lease(self.namespace, self.name, doc)
            except ConflictError:
                self._became(False, "lost acquisition race")
                return
            except ApiError as e:
                log.warning("lease renew failed: %s", e)
                return  # no renewal recorded; is_leader decays
            self._became(True, "took over expired lease"
                         if holder != self.identity else None,
                         renew_at=attempt_at)
        else:
            self._became(False, None)

    def _became(self, leader: bool, why: str | None,
                renew_at: float | None = None) -> None:
        with self._lock:
            if self._stop.is_set():
                # stop() raced an in-flight tick: a stopped elector must
                # never re-assert leadership.
                leader = False
            changed = leader != self._leader
            self._leader = leader
            if leader and renew_at is not None:
                self._last_renew = renew_at
        if changed or why:
            log.info("leader election [%s]: %s (%s)", self.identity,
                     "LEADER" if leader else "follower", why or "observed")

    def _run(self) -> None:
        first = True
        while not self._stop.wait(0.0 if first else self.renew_period):
            first = False
            try:
                self._try_acquire_or_renew()
            except Exception:  # pragma: no cover - defensive
                log.exception("leader election tick failed")
            if self._stop.is_set():
                return
