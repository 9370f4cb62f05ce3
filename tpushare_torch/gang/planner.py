"""Gang scheduling: all-or-nothing placement of pod groups.

The port's copy of ``tpushare/gang/planner.py``. A job spanning hosts is
useless until all its workers run, so binding members one by one can
deadlock two half-placed jobs. The protocol (assume and commit, with a
rollback on timeout):

1. A gang member arrives at bind. Its cards are **reserved**: the ledger
   charge and the annotation write happen (capacity is held and a
   restart rebuilds it), but no binding is posted.
2. While the group is below ``tpushare.io/pod-group-min`` members, bind
   answers an error carrying :data:`QUORUM_HOLD_MARKER`; kube-scheduler
   keeps the pod pending and retries.
3. When the minimum-th member reserves, the group **commits**: a binding
   is posted for every reserved member. A member whose POST fails stays
   tracked and is retried, by the scheduler's retry of the pod and by the
   housekeeping tick, until bound; the group is forgotten once every
   member is bound.
4. Reservations not committed after ``ttl`` seconds expire: the group is
   rolled back (ledger freed, annotations stripped) on the housekeeping
   thread (:meth:`GangPlanner.start`).

A lock a group guards the reserve and commit path, and a table lock only
the group table; no apiserver round trip runs under either, so one
gang's writes never stall another gang's bind. Every annotation, Event,
binding and error string is the reference's. The reference's decision
trace notes, timeline marks and topology gauges come with the
observability slice. With a quota ledger, a gang whose outstanding
members must take its tenant past the hard limit is refused at its
quorum pre-check, before it reserves; the group's charge needs nothing
more, since each reservation goes through the cache (which charges) and
the rollback through ``remove_pod`` (which uncharges).
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait

from tpushare_torch.api.objects import Pod, binding_doc
from tpushare_torch.cache.nodeinfo import AllocationError
from tpushare_torch.k8s import commit, events
from tpushare_torch.k8s.errors import ApiError, NotFoundError
from tpushare_torch.topology import fleet
from tpushare_torch.utils import const
from tpushare_torch.utils import node as nodeutils
from tpushare_torch.utils import pod as podutils

log = logging.getLogger(__name__)

#: Substring every GangPending message carries: the wire has no
#: structured "pending" field, so a client outside the process tells an
#: expected hold from a failed bind by it.
QUORUM_HOLD_MARKER = "pending quorum"


class GangPending(AllocationError):
    """Member reserved; group below quorum: the scheduler should retry."""


class _Group:
    def __init__(self, name: str, minimum: int, ttl: float):
        self.name = name
        self.minimum = minimum
        self.deadline = time.monotonic() + ttl
        self.committed = False
        #: The elected host block (``fleet.Placement``) of a slice-shape
        #: gang; None with no placer, no shape, or no contiguous block at
        #: election time (members then place unconstrained).
        self.placement = None
        #: uid -> elected host claimed for that member; released when its
        #: reservation fails, so a sibling can take the host.
        self.claimed: dict[str, str] = {}
        #: Expiry detached this group and its rollback runs or ran. The
        #: group stays in the table until the rollback's writes finish, so
        #: a re-reservation of a victim fails the liveness check instead
        #: of charging uids the stale rollback then frees.
        self.rolled_back = False
        self.lock = threading.RLock()
        #: uid -> (annotated pod, node name)
        self.reservations: dict[str, tuple[Pod, str]] = {}
        #: uids whose reservation is being allocated now (lock released
        #: around the writes): a second bind of the same member meanwhile
        #: is refused, or it would be charged twice.
        self.reserving: set[str] = set()
        #: uids whose binding POST succeeded
        self.bound: set[str] = set()

    def fully_bound(self) -> bool:
        return self.committed and self.bound >= set(self.reservations)


class GangPlanner:
    def __init__(self, cache, client, ttl: float = 120.0,
                 housekeeping_interval: float = 5.0, node_lister=None,
                 is_leader=None, quota=None, placer=None):
        self.cache = cache
        self.client = client
        #: A QuotaManager, or None: the quorum pre-check's doomed-gang
        #: test against the tenant's hard limit.
        self.quota = quota
        #: Optional ``fleet.SlicePlacer``: a gang with
        #: ``tpushare.io/slice-shape`` gets a contiguous host block
        #: elected at its first member's quorum pre-check, later members
        #: are steered onto it, and prioritize reads the same election.
        #: A failed election places unconstrained, never rejects.
        self.placer = placer
        #: ``() -> list[Node]`` for the quorum pre-check: the informer's
        #: store when wired, else the client's LIST.
        self._node_lister = node_lister or client.list_nodes
        #: ``() -> bool``: binding retries of the housekeeping tick are
        #: the leader's; every replica expires what it holds.
        self._is_leader = is_leader or (lambda: True)
        self.ttl = ttl
        self._interval = housekeeping_interval
        self._groups: dict[tuple[str, str], _Group] = {}
        self._table_lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        #: The binding-POST pool, made at first use and kept (a pool a
        #: commit would put its start-up inside every commit).
        self._pool: ThreadPoolExecutor | None = None
        self._pool_lock = threading.RLock()

    def _executor(self) -> ThreadPoolExecutor | None:
        """The POST pool, or None once :meth:`stop` ran: a commit racing
        shutdown posts serially rather than start a pool nobody stops."""
        with self._pool_lock:
            if self._pool is None and not self._stop.is_set():
                self._pool = ThreadPoolExecutor(
                    max_workers=32, thread_name_prefix="tpushare-gang-bind")
            return self._pool

    # -- housekeeping ----------------------------------------------------- #

    def start(self) -> None:
        """Run the expiry and retry tick on a daemon thread."""
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._housekeeping_loop,
                                        name="tpushare-gang", daemon=True)
        self._thread.start()
        # Start the POST workers now, not inside the first gang's commit.
        ex = self._executor()
        if ex is not None:
            wait([ex.submit(time.sleep, 0.002) for _ in range(32)],
                 timeout=2.0)

    def stop(self) -> None:
        self._stop.set()
        with self._pool_lock:
            if self._pool is not None:
                self._pool.shutdown(wait=False)
                self._pool = None
        if self._thread is not None:
            self._thread.join(timeout=2 * self._interval + 1)

    def snapshot(self) -> list[dict]:
        """The groups in flight, for the inspect document: name,
        namespace, quorum progress, commit state, seconds until the
        reservations expire, and the members' nodes."""
        with self._table_lock:
            groups = list(self._groups.items())
        now = time.monotonic()
        out = []
        for (namespace, _name), group in groups:
            with group.lock:
                out.append({
                    "name": group.name,
                    "namespace": namespace,
                    "reserved": len(group.reservations),
                    "minimum": group.minimum,
                    "committed": group.committed,
                    "bound": len(group.bound),
                    "ttlRemaining": (None if group.committed else
                                     max(round(group.deadline - now, 1), 0)),
                    "members": [
                        {"pod": pod.name, "node": node}
                        for pod, node in group.reservations.values()
                    ],
                })
        return sorted(out, key=lambda g: (g["namespace"], g["name"]))

    def housekeeping_tick(self) -> None:
        """One pass: expiry always (a demoted leader sheds what it holds),
        binding retries on the leader alone."""
        self.expire_stale()
        if self._is_leader():
            self.retry_unbound()

    def _housekeeping_loop(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.housekeeping_tick()
            except Exception:  # pragma: no cover - defensive
                log.exception("gang housekeeping tick failed")

    # -- groups and quorum ------------------------------------------------ #

    def _bound_members(self, group: _Group, namespace: str) -> int:
        """Members already bound (running or starting) that no local
        reservation tracks: quorum met in an earlier planner life."""
        return sum(
            1 for p in self.cache.gang_members(namespace, group.name)
            if p.node_name and p.uid not in group.reservations
            and not podutils.is_complete_pod(p))

    def _get_group(self, pod: Pod) -> tuple[tuple[str, str], _Group]:
        group_name, minimum = podutils.get_pod_group(pod)
        minimum = max(minimum, 1)
        key = (pod.namespace, group_name)
        with self._table_lock:
            group = self._groups.get(key)
            if group is None:
                group = self._groups[key] = _Group(group_name, minimum,
                                                   self.ttl)
            group.minimum = max(group.minimum, minimum)
        return key, group

    def quorum_feasible(self, pod: Pod, group: _Group) -> tuple[bool, str]:
        """Can the fleet host enough members for quorum now? A doomed gang
        is refused before it holds anything, instead of holding cards
        until its TTL.

        The outstanding members are modelled as clones of this pod's
        request, and each node's capacity is over-estimated
        (``count_fits_preemptable``: free capacity plus what residents of
        lower priority hold). For a uniform gang a False is definitive; a
        heterogeneous gang converges, since each member that reserves
        shrinks what is still needed."""
        bound_n = self._bound_members(group, pod.namespace)
        needed = group.minimum - len(group.reservations) - bound_n
        if needed <= 0:
            return True, ""
        if self.quota is not None:
            # The hard limit over the whole outstanding group (clones of
            # this pod, as below): a per-member check would admit the
            # first members and leave the gang squatting.
            ok, reason = self.quota.admit(pod, count=needed)
            if not ok:
                return False, (
                    f"gang {group.name}: quorum {group.minimum} can never "
                    f"assemble under its tenant's quota ({reason}); "
                    "rejecting without reserving")
        # A slice-shape gang elects its block here, while the group holds
        # nothing. An elected block of enough hosts proves capacity; a
        # failed election is no infeasibility (the walk below decides).
        placement = self._elect_placement(pod, group)
        if placement is not None and len(placement.hosts) >= needed:
            return True, ""
        try:
            nodes = self._node_lister()
        except ApiError:
            # The fleet cannot be listed: fail open; the TTL bounds a
            # wrong guess.
            return True, ""
        if not nodes:
            # An empty list reads as an informer not yet synced (an empty
            # fleet never reaches bind): fail open as well.
            return True, ""
        copies = 0
        for node in nodes:
            if not nodeutils.is_schedulable(node, pod):
                # kube-scheduler never offers a cordoned or untolerated
                # node, so its capacity cannot be bound.
                continue
            info = (self.cache.peek_node_info(node.name)
                    or self.cache.get_node_info(node.name))
            if info is None:
                continue
            copies += info.count_fits_preemptable(pod)
            if copies >= needed:
                return True, ""
        return False, (
            f"gang {group.name}: quorum {group.minimum} is infeasible — "
            f"cluster currently fits "
            f"{copies + len(group.reservations) + bound_n} "
            f"member(s) even counting lower-priority preemptable "
            f"capacity; rejecting without reserving")

    def member_nodes(self, pod: Pod) -> set[str]:
        """Nodes holding reserved members of ``pod``'s group (the
        prioritizer's consolidation term)."""
        group_name, _ = podutils.get_pod_group(pod)
        key = (pod.namespace, group_name)
        with self._table_lock:
            group = self._groups.get(key)
        if group is None:
            return set()
        with group.lock:
            return {node for _, node in group.reservations.values()}

    # -- topology --------------------------------------------------------- #

    def _elect_placement(self, pod: Pod, group: _Group):
        """The placer's (memoized) election for ``pod``'s group, stashed
        on the group; None without a placer or a block."""
        if self.placer is None:
            return None
        placement = self.placer.elect((pod.namespace, group.name), pod)
        with group.lock:
            group.placement = placement
        if placement is None and podutils.get_slice_shape(pod) is not None:
            log.info("gang %s/%s: no contiguous host block for slice "
                     "shape %r; placing unconstrained", pod.namespace,
                     group.name, pod.annotations.get(const.ANN_SLICE_SHAPE))
        return placement

    def _steer(self, group: _Group, pod: Pod, node_name: str) -> str:
        """Steer a slice-shape member onto its group's elected block: onto
        its ring slot when the name carries a worker ordinal (``w-3`` to
        ``placement.hosts[3]``), else onto the first unclaimed host in
        ring order. Falls back to the scheduler's choice when no host of
        the block takes the member: a topology miss costs placement
        quality, never the gang."""
        if podutils.get_slice_shape(pod) is None:
            return node_name
        with group.lock:
            placement = group.placement
            if placement is None:
                return node_name
            already = group.claimed.get(pod.uid)
            if already is not None:
                return already  # a retry of this member
            taken = set(group.claimed.values())
            candidates = [h for h in placement.hosts if h not in taken]
            slot = fleet.worker_ordinal(pod.name)
            if slot is not None and slot < len(placement.hosts):
                slot_host = placement.hosts[slot]
                if slot_host in candidates:
                    candidates.remove(slot_host)
                    candidates.insert(0, slot_host)
        for host in candidates:
            # A stale yes costs one retry: allocate checks the live ledger.
            info = (self.cache.peek_node_info(host)
                    or self.cache.get_node_info(host))
            if info is None or not info.assume(pod)[0]:
                continue
            with group.lock:
                if host in set(group.claimed.values()):
                    continue  # a sibling claimed it meanwhile
                group.claimed[pod.uid] = host
            return host
        log.info("gang %s: elected block unavailable for %s; placing on %s",
                 group.name, pod.key(), node_name)
        return node_name

    def elected_hosts(self, pod: Pod) -> frozenset[str]:
        """The elected hosts of ``pod``'s group (the prioritizer's
        contiguity term). Before the group exists (prioritize runs before
        the first bind) the election runs now, memoized, so the bind's
        election reads it back."""
        if self.placer is None or podutils.get_slice_shape(pod) is None:
            return frozenset()
        group_name, _ = podutils.get_pod_group(pod)
        key = (pod.namespace, group_name)
        with self._table_lock:
            group = self._groups.get(key)
        if group is not None:
            with group.lock:
                placement = group.placement
            if placement is not None:
                return placement.host_set()
            return frozenset()
        placement = self.placer.elect(key, pod)
        return placement.host_set() if placement is not None \
            else frozenset()

    # -- bind ------------------------------------------------------------- #

    def bind_member(self, pod: Pod, node_name: str) -> None:
        """Reserve or commit one gang member; raises GangPending below
        quorum and AllocationError or ApiError on real failures. No
        apiserver round trip of this path (the quorum walk, the ledger's
        annotation write, a failed adoption's strip, the binding POSTs)
        runs under a gang lock."""
        if podutils.is_assumed(pod) and pod.node_name:
            return  # already placed: a retry

        key, group = self._get_group(pod)
        self._reserve_member(key, group, pod, node_name)
        newly_committed = self._note_quorum(key, group)

        if newly_committed and self.placer is not None:
            # A committed gang's election is never read again.
            self.placer.forget(key)
        for member_pod, member_node in newly_committed:
            events.record(
                self.client, member_pod, events.REASON_GANG_COMMITTED,
                f"gang {group.name} reached quorum; "
                f"committing to node {member_node}")
        # Raises only if this member's own binding failed.
        self._commit(key, group, current_uid=pod.uid)

    def _reserve_member(self, key: tuple[str, str], group: _Group,
                        pod: Pod, node_name: str) -> None:
        """Make sure ``pod`` holds a reservation in ``group``, allocating
        (or adopting) its grant with the group lock released."""
        with group.lock:
            if group.rolled_back:
                # Expiry is rolling this group back; a reservation made
                # into it would be destroyed.
                raise AllocationError(
                    f"gang {group.name}: expired-reservation rollback "
                    "in progress; scheduler will retry")
            if pod.uid in group.reservations:
                return
            if pod.uid in group.reserving:
                # A duplicate bind of a member mid-allocate.
                raise AllocationError(
                    f"gang {group.name}: reservation for {pod.key()} "
                    "already in flight; scheduler will retry")
            group.reserving.add(pod.uid)
            first = not group.reservations and not group.committed
        try:
            self._reserve_member_unlocked(key, group, pod, node_name,
                                          first)
        finally:
            with group.lock:
                group.reserving.discard(pod.uid)
                if pod.uid not in group.reservations:
                    # Failed: free the member's claimed host for a sibling.
                    group.claimed.pop(pod.uid, None)

    def _reserve_member_unlocked(self, key: tuple[str, str],
                                 group: _Group, pod: Pod,
                                 node_name: str, first: bool) -> None:
        """The allocate or adopt half of :meth:`_reserve_member`, under no
        gang lock (``group.reserving`` keeps duplicates out)."""
        if podutils.is_assumed(pod):
            # Reserved in an earlier life (a restart): adopt the grant.
            self._adopt(group, pod)
            return
        if first:
            # The doomed-gang check runs while the group holds nothing;
            # later members are checked by allocate itself, and a fleet
            # that shrinks mid-gang is bounded by the TTL.
            feasible, reason = self.quorum_feasible(pod, group)
            if not feasible:
                with group.lock:
                    still_empty = (not group.reservations
                                   and not group.committed)
                    if still_empty:
                        # Never held anything: drop the empty group.
                        with self._table_lock:
                            if self._groups.get(key) is group:
                                del self._groups[key]
                if still_empty:
                    raise AllocationError(reason)
                # A sibling reserved meanwhile: the group lives.
        node_name = self._steer(group, pod, node_name)
        info = self.cache.get_node_info(node_name)
        if info is None:
            raise AllocationError(f"unknown node {node_name}")
        reserved = info.allocate(self.client, pod, bind=False)
        try:
            self.cache.add_or_update_pod(reserved)
            with group.lock:
                with self._table_lock:
                    live = (self._groups.get(key) is group
                            and not group.rolled_back)
                if live:
                    group.reservations[pod.uid] = (reserved, node_name)
                    log.info("gang %s/%s: reserved member %s on %s "
                             "(%d/%d)", pod.namespace, group.name,
                             pod.name, node_name,
                             len(group.reservations), group.minimum)
                    return
        except BaseException:
            # Between the allocate and the table insert nothing else would
            # ever free the charge or the annotations: undo both.
            self.cache.remove_pod(reserved)
            self._strip_annotations(reserved)
            raise
        # The group expired while the allocate was in flight.
        self.cache.remove_pod(reserved)
        self._strip_annotations(reserved)
        raise AllocationError(
            f"gang {group.name}: reservation window expired during "
            "allocation; rolled back — scheduler will retry")

    def _note_quorum(self, key: tuple[str, str],
                     group: _Group) -> list[tuple[Pod, str]]:
        """Flip ``committed`` at quorum; returns the members this call
        committed (none for a group already committed). Raises
        GangPending below quorum."""
        with group.lock:
            reserved_n = len(group.reservations)
            if not group.committed and reserved_n < group.minimum:
                # Members already bound count towards quorum: after a
                # failover mid-commit a reset member re-enters alone, and
                # reservations alone would never reach quorum again.
                reserved_n += self._bound_members(group, key[0])
            if group.committed or reserved_n >= group.minimum:
                newly_committed: list[tuple[Pod, str]] = []
                if not group.committed:
                    # Under the lock, so expiry never rolls back a group
                    # that reached quorum.
                    log.info("gang %s/%s: quorum reached (%d/%d incl. "
                             "already-bound members), committing %d "
                             "binding(s)", key[0], group.name, reserved_n,
                             group.minimum, len(group.reservations))
                    group.committed = True
                    newly_committed = list(group.reservations.values())
                return newly_committed
            raise GangPending(
                f"gang {group.name}: {reserved_n}/{group.minimum} "
                f"members reserved; pod held {QUORUM_HOLD_MARKER}")

    def _adopt(self, group: _Group, pod: Pod) -> None:
        """Re-register an annotated, unbound member after a restart."""
        node_name = pod.node_name
        if not node_name:
            # The annotations were written but the node choice is lost:
            # strip them and let the scheduler start over.
            self._strip_annotations(pod)
            raise AllocationError(
                f"gang member {pod.key()} had a stale reservation; reset")
        with group.lock:
            group.reservations.setdefault(pod.uid, (pod, node_name))

    # -- commit ----------------------------------------------------------- #

    def _post_binding(self, pod: Pod, node_name: str):
        """POST one member's binding; the outcome, with no group state
        touched."""
        try:
            self.client.bind_pod(binding_doc(pod, node_name))
        except NotFoundError:
            return "gone"
        except ApiError as e:
            if e.status != 409:  # 409: already bound
                return e
        return "bound"

    def _apply_binding_outcome(self, group: _Group, uid: str,
                               outcome) -> ApiError | None:
        """Fold one POST outcome into the group (group lock held); the
        error when the binding failed."""
        if outcome == "bound":
            group.bound.add(uid)
            return None
        if outcome == "gone":
            # Deleted while awaiting its binding: drop the reservation and
            # its charge, so the group can complete.
            entry = group.reservations.pop(uid, None)
            if entry is not None:
                pod, _ = entry
                log.warning("gang %s: member %s vanished before binding; "
                            "dropping its reservation", group.name,
                            pod.key())
                self.cache.remove_pod(pod)
            group.bound.discard(uid)
            return None
        return outcome  # ApiError

    def _commit(self, key, group: _Group,
                current_uid: str | None = None) -> int:
        """Post a binding for every reserved member not yet bound, on the
        pool and with the group lock released; returns the POSTs tried. A
        failed member stays tracked for the retries; only the calling
        member's own failure is raised."""
        with group.lock:
            pending = [(uid, pod, node)
                       for uid, (pod, node) in group.reservations.items()
                       if uid not in group.bound]
        current_error: ApiError | None = None
        if pending:
            ex = self._executor() if len(pending) > 1 else None
            if ex is None:
                outcomes = [(uid, self._post_binding(pod, node))
                            for uid, pod, node in pending]
            else:
                try:
                    outcomes = list(ex.map(
                        lambda t: (t[0], self._post_binding(t[1], t[2])),
                        pending))
                except RuntimeError:
                    # The pool shut down mid-commit: finish serially.
                    outcomes = [(uid, self._post_binding(pod, node))
                                for uid, pod, node in pending]
            with group.lock:
                for uid, outcome in outcomes:
                    err = self._apply_binding_outcome(group, uid, outcome)
                    if err is not None:
                        entry = group.reservations.get(uid)
                        log.warning("gang %s/%s: binding %s failed (%s); "
                                    "will retry", key[0], group.name,
                                    entry[0].name if entry else uid, err)
                        if uid == current_uid:
                            current_error = err
        with group.lock:
            done = group.fully_bound()
        if done:
            with self._table_lock:
                self._groups.pop(key, None)
        if current_error is not None:
            raise current_error
        return len(pending)

    def retry_unbound(self) -> int:
        """Retry the bindings of committed members not yet bound; returns
        the POSTs tried."""
        with self._table_lock:
            committed = [(k, g) for k, g in self._groups.items()
                         if g.committed]
        attempts = 0
        for key, group in committed:
            attempts += self._commit(key, group)
        return attempts

    # -- expiry ----------------------------------------------------------- #

    def expire_stale(self) -> int:
        """Roll back the groups not committed by their deadline: free the
        ledger and strip the grant annotations so the pods schedule afresh
        on retry. Committed groups are never rolled back. Returns the
        groups rolled back.

        The group lock covers only the detach; the per-member rollback is
        apiserver traffic under no gang lock. The table entry goes only
        after the rollback, so a retry of a victim meanwhile finds the
        dying group and is refused."""
        now = time.monotonic()
        with self._table_lock:
            expired = [(k, g) for k, g in self._groups.items()
                       if not g.committed and now >= g.deadline]
        rolled = 0
        for key, group in expired:
            with group.lock:
                if group.committed:  # raced with a commit
                    continue
                group.rolled_back = True
                victims = list(group.reservations.values())
                group.reservations.clear()
            log.warning("gang %s/%s: expired at %d/%d members; rolling "
                        "back", key[0], group.name, len(victims),
                        group.minimum)
            for pod, _node in victims:
                self.cache.remove_pod(pod)
                self._strip_annotations(pod)
                events.record(
                    self.client, pod, events.REASON_GANG_EXPIRED,
                    f"gang {group.name} expired at "
                    f"{len(victims)}/{group.minimum} members; "
                    "reservation rolled back", event_type="Warning")
            with self._table_lock:
                if self._groups.get(key) is group:
                    del self._groups[key]
            if self.placer is not None:
                # The next try elects against the fleet as it is now.
                self.placer.forget(key)
            rolled += 1
        return rolled

    def _strip_annotations(self, pod: Pod) -> None:
        try:
            fresh = self.client.get_pod(pod.namespace, pod.name)
            ann = fresh.metadata.get("annotations") or {}
            for k in const.GRANT_ANNOTATIONS:
                ann.pop(k, None)
            fresh.raw.setdefault("spec", {}).pop("nodeName", None)
            commit.committed_update_pod(self.client, fresh)
        except ApiError as e:
            log.debug("gang rollback: annotation strip for %s failed (%s); "
                      "sync will reconcile", pod.key(), e)

    def stats(self) -> dict:
        with self._table_lock:
            groups = dict(self._groups)
        return {
            f"{ns}/{g.name}": {
                "reserved": len(g.reservations),
                "bound": len(g.bound),
                "min": g.minimum,
                "committed": g.committed,
            }
            for (ns, _), g in groups.items()
        }
