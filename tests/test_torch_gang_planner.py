"""The port's gang planner against the JAX package's, on the CPU.

Each story runs twice, once on each package's planner, cache and fake
apiserver, fed the same documents; it returns a record (errors raised,
free cards, pods' nodes and grant annotations, the planner's stats, the
Events written), and the two records must be equal, besides the story's
own assertions. Tolerance: exact. Each ``bind_member`` runs inside a
decision's ``bind`` phase of the side's own recorder, finalized as the
server finalizes it (``TracedPlanner``). Left out of the comparison: the
assume time (a clock); the decision trace's ids, random on each side,
are compared by presence, and on each side every ``trace-id``
annotation and ``[trace ...]`` Event suffix must name a decision of that
pod in the side's recorder, a commit's Event its own member's. Each
record ends with the decisions of the flight ring, clocks and ids aside.
The stories are the
reference's: TTL rollback with its freed cards and stripped annotations
(``tests/test_e2e.py:177``), a reserve retried during a rollback and a
duplicate reserve in flight (``tests/test_gang_lifecycle.py:601``,
``:648``), ``retry_unbound`` after a failed binding POST, a member's own
failure, a member deleted before its binding, the leader-gated tick, and
the housekeeping thread's ``start`` / ``stop``.
"""

from __future__ import annotations

import re
import threading
import time

import pytest

from tests.test_torch_extender_e2e import normal_trace
from tests.torch_obs_reset import fresh_port_obs  # noqa: F401
from tpushare import trace as jtrace
from tpushare.cache.cache import SchedulerCache as JCache
from tpushare.cache.nodeinfo import AllocationError as JAllocationError
from tpushare.gang import planner as jplanner
from tpushare.k8s import events as jevents
from tpushare.k8s.builders import make_node, make_pod
from tpushare.k8s.errors import ApiError as JApiError
from tpushare.k8s.fake import FakeApiServer as JFake
from tpushare_torch import trace as ttrace
from tpushare_torch.cache.cache import SchedulerCache as TCache
from tpushare_torch.cache.nodeinfo import AllocationError as TAllocationError
from tpushare_torch.gang import planner as tplanner
from tpushare_torch.k8s import events as tevents
from tpushare_torch.k8s.errors import ApiError as TApiError
from tpushare_torch.k8s.fake import FakeApiServer as TFake
from tpushare_torch.utils import const

ANN = {const.ANN_POD_GROUP: "train", const.ANN_POD_GROUP_MIN: "2"}
UNCOMPARED = (const.ANN_ASSUME_TIME,)
RANDOM_IDS = (const.ANN_TRACE_ID, const.ANN_TRACE_PARENT)
SUFFIX = re.compile(r" \[trace ([^\]]*)\]$")


class TracedPlanner:
    """A planner whose ``bind_member`` runs in a ``bind`` phase of the
    side's recorder and finalizes the decision as the server does:
    ``bound``, ``gang-pending`` or ``failed``."""

    def __init__(self, planner, trace, pending):
        self._planner, self._trace, self._pending = planner, trace, pending

    def __getattr__(self, name):
        return getattr(self._planner, name)

    def bind_member(self, pod, node_name):
        dec = None
        try:
            with self._trace.phase("bind", pod.namespace, pod.name,
                                   pod.uid) as dec:
                self._planner.bind_member(pod, node_name)
        except self._pending as e:
            self._trace.complete(dec, "gang-pending", node=node_name,
                                 error=str(e))
            raise
        except Exception as e:
            self._trace.complete(dec, "failed", node=node_name,
                                 error=str(e))
            raise
        self._trace.complete(dec, "bound", node=node_name)


class Side:
    """One package's planner over its own cache and fake apiserver."""

    def __init__(self, fake, cache_cls, planner_mod, events_mod,
                 alloc_error, api_error, trace):
        self.api = fake()
        self.cache_cls = cache_cls
        self.mod = planner_mod
        self.events = events_mod
        self.AllocationError = alloc_error
        self.ApiError = api_error
        self.trace = trace
        trace.reset()

    def resolves(self, name: str, trace_id: str) -> bool:
        """``trace_id`` names a decision of pod ``name`` on this side."""
        return self.trace.get_trace("default", name,
                                    trace_id=trace_id) is not None

    def cluster(self, hosts=2):
        for i in range(hosts):
            self.api.create_node(make_node(f"host-{i}", chips=4,
                                           hbm_per_chip=95,
                                           topology="2x2x1", tpu_type="v5p"))
        self.cache = self.cache_cls(self.api.get_node, self.api.list_pods)
        return self.cache

    def planner(self, client=None, **kw):
        return TracedPlanner(
            self.mod.GangPlanner(self.cache, client or self.api, **kw),
            self.trace, self.mod.GangPending)

    def free(self, node):
        return len(self.cache.get_node_info(node).get_free_chips())

    def pod_view(self, name):
        pod = self.api.get_pod("default", name)
        tid = pod.annotations.get(const.ANN_TRACE_ID)
        assert tid is None or self.resolves(name, tid), (name, tid)
        return pod.node_name, {k: "<id>" if k in RANDOM_IDS else v
                               for k, v in pod.annotations.items()
                               if k not in UNCOMPARED}

    def event_view(self):
        """The Events, each suffix held to this side's recorder (a
        commit's to its member's own annotation) and then marked."""
        assert self.events.flush()
        out = []
        for _, e in self.api.events:
            name = e["involvedObject"]["name"]
            m = SUFFIX.search(e["message"])
            if m:
                assert self.resolves(name, m.group(1)), (name, e)
                if e["reason"] == self.events.REASON_GANG_COMMITTED:
                    assert self.api.get_pod("default", name).annotations[
                        const.ANN_TRACE_ID] == m.group(1), e
            out.append((name, e["reason"],
                        SUFFIX.sub(" [trace]", e["message"]), e["type"]))
        return sorted(out)

    def decisions(self):
        """The flight ring, oldest first, clocks and ids aside."""
        return [normal_trace(d) for d in reversed(self.trace.flight())]

    def outcome(self, fn):
        """What ``fn()`` did: "ok", or the error's kind and message."""
        try:
            fn()
        except self.mod.GangPending as e:
            return ("pending", str(e))
        except self.AllocationError as e:
            return ("allocation", str(e))
        except self.ApiError as e:
            return ("api", e.status)
        return "ok"


def sides():
    return (Side(JFake, JCache, jplanner, jevents, JAllocationError,
                 JApiError, jtrace),
            Side(TFake, TCache, tplanner, tevents, TAllocationError,
                 TApiError, ttrace))


class FlakyBindClient:
    """The fake apiserver, failing bind_pod once for the pods named."""

    def __init__(self, api, fail_names, api_error):
        self._api = api
        self.fail_names = set(fail_names)
        self.api_error = api_error

    def __getattr__(self, name):
        return getattr(self._api, name)

    def bind_pod(self, binding):
        name = binding["metadata"]["name"]
        if name in self.fail_names:
            self.fail_names.discard(name)
            raise self.api_error(503, reason="transient apiserver hiccup")
        return self._api.bind_pod(binding)


# -- stories: each returns its record ---------------------------------------- #

def story_ttl_rollback_frees_and_strips(side):
    """tests/test_e2e.py:177: the second member never shows; expiry frees
    the cards and strips the annotations, with a Warning Event."""
    side.cluster()
    planner = side.planner(ttl=0.05)
    pod = side.api.create_pod(make_pod("worker-0", chips=4, annotations=ANN))
    first = side.outcome(lambda: planner.bind_member(pod, "host-0"))
    assert first[0] == "pending" and jplanner.QUORUM_HOLD_MARKER in first[1]
    held = side.free("host-0")
    before = side.pod_view("worker-0")
    time.sleep(0.06)
    rolled = planner.expire_stale()
    after = side.pod_view("worker-0")
    assert (held, rolled, side.free("host-0")) == (0, 1, 4)
    assert after == ("", {const.ANN_POD_GROUP: "train",
                          const.ANN_POD_GROUP_MIN: "2"})
    return (first, held, before, rolled, side.free("host-0"), after,
            planner.stats(), side.event_view())


def story_reserve_retry_during_rollback_is_refused(side):
    """tests/test_gang_lifecycle.py:601: a retry while the rollback's
    writes are in flight is refused; after it, the retry reserves."""
    side.cluster()
    entered, hold = threading.Event(), threading.Event()
    api = side.api

    class SlowStripClient:
        def __getattr__(self, name):
            return getattr(api, name)

        def get_pod(self, ns, name):
            entered.set()
            hold.wait(5)
            return api.get_pod(ns, name)

    planner = side.planner(SlowStripClient(), ttl=0.01)
    w0 = api.create_pod(make_pod("w0", chips=4, annotations=ANN))
    first = side.outcome(lambda: planner.bind_member(w0, "host-0"))
    time.sleep(0.02)
    t = threading.Thread(target=planner.expire_stale)
    t.start()
    assert entered.wait(5)
    fresh = api.get_pod("default", "w0")
    during = side.outcome(lambda: planner.bind_member(fresh, "host-0"))
    assert during[0] == "allocation" and "rollback in progress" in during[1]
    hold.set()
    t.join(5)
    stats, free = planner.stats(), side.free("host-0")
    fresh2 = api.get_pod("default", "w0")
    stripped = const.ANN_CHIP_IDX not in fresh2.annotations
    again = side.outcome(lambda: planner.bind_member(fresh2, "host-0"))
    assert (stats, free, stripped, again[0]) == ({}, 4, True, "pending")
    return first, during, stats, free, stripped, again


def story_duplicate_reserve_in_flight_is_refused(side):
    """tests/test_gang_lifecycle.py:648: a second bind of a member whose
    reservation is mid-allocate is refused; one charge only."""
    side.cluster()
    entered, hold = threading.Event(), threading.Event()
    api = side.api

    class SlowWriteClient:
        def __getattr__(self, name):
            return getattr(api, name)

        def update_pod(self, pod):
            entered.set()
            hold.wait(5)
            return api.update_pod(pod)

    planner = side.planner(SlowWriteClient(), ttl=60)
    w0 = api.create_pod(make_pod("w0", chips=4, annotations=ANN))
    results = []
    t = threading.Thread(target=lambda: results.append(side.outcome(
        lambda: planner.bind_member(w0, "host-0"))))
    t.start()
    assert entered.wait(5)
    dup = side.outcome(lambda: planner.bind_member(w0, "host-1"))
    assert dup[0] == "allocation" and "already in flight" in dup[1]
    hold.set()
    t.join(5)
    assert results[0][0] == "pending"
    return dup, results, side.free("host-0"), side.free("host-1")


def story_retry_unbound_after_a_failed_post(side):
    """tests/test_gang_lifecycle.py:48: w0's binding POST fails at the
    commit; w1's bind still succeeds; the retry binds w0 and the group is
    forgotten."""
    side.cluster()
    planner = side.planner(FlakyBindClient(side.api, {"w0"}, side.ApiError),
                           ttl=60)
    p0 = side.api.create_pod(make_pod("w0", chips=4, annotations=ANN))
    p1 = side.api.create_pod(make_pod("w1", chips=4, annotations=ANN))
    rec = [side.outcome(lambda: planner.bind_member(p0, "host-0")),
           side.outcome(lambda: planner.bind_member(p1, "host-1")),
           side.pod_view("w0"), side.pod_view("w1"), planner.stats()]
    assert rec[1] == "ok" and rec[2][0] == "" and rec[3][0] == "host-1"
    rec += [planner.retry_unbound(), side.pod_view("w0"), planner.stats()]
    assert rec[5] == 1 and rec[6][0] == "host-0" and rec[7] == {}
    return rec + [side.event_view()]


def story_own_binding_failure_is_raised(side):
    """tests/test_gang_lifecycle.py:264: only the member whose own POST
    failed sees the failure; the retry binds it."""
    side.cluster()
    planner = side.planner(FlakyBindClient(side.api, {"w1"}, side.ApiError),
                           ttl=60)
    p0 = side.api.create_pod(make_pod("w0", chips=4, annotations=ANN))
    p1 = side.api.create_pod(make_pod("w1", chips=4, annotations=ANN))
    rec = [side.outcome(lambda: planner.bind_member(p0, "host-0")),
           side.outcome(lambda: planner.bind_member(p1, "host-1")),
           side.pod_view("w0")[0], planner.retry_unbound(),
           side.pod_view("w1")[0]]
    assert rec[1] == ("api", 503) and rec[2:] == ["host-0", 1, "host-1"]
    return rec


def story_deleted_member_is_dropped(side):
    """tests/test_gang_lifecycle.py:296: a committed member deleted
    before its binding lands frees its cards and lets the group go."""
    side.cluster()
    planner = side.planner(FlakyBindClient(side.api, {"w0"}, side.ApiError),
                           ttl=60)
    p0 = side.api.create_pod(make_pod("w0", chips=4, annotations=ANN))
    p1 = side.api.create_pod(make_pod("w1", chips=4, annotations=ANN))
    side.outcome(lambda: planner.bind_member(p0, "host-0"))
    side.outcome(lambda: planner.bind_member(p1, "host-1"))
    side.api.delete_pod("default", "w0")
    tried = planner.retry_unbound()
    assert (planner.stats(), side.free("host-0")) == ({}, 4)
    return tried, planner.stats(), side.free("host-0")


def story_follower_tick_expires_but_never_binds(side):
    """tests/test_gang_lifecycle.py:316, :344: a follower's tick retries
    no binding but still rolls back what it holds."""
    side.cluster()
    leading = [True]
    planner = side.planner(FlakyBindClient(side.api, {"w0"}, side.ApiError),
                           ttl=60, is_leader=lambda: leading[0])
    p0 = side.api.create_pod(make_pod("w0", chips=4, annotations=ANN))
    p1 = side.api.create_pod(make_pod("w1", chips=4, annotations=ANN))
    side.outcome(lambda: planner.bind_member(p0, "host-0"))
    side.outcome(lambda: planner.bind_member(p1, "host-1"))
    leading[0] = False
    planner.housekeeping_tick()
    rec = [side.pod_view("w0")[0], planner.stats()]
    leading[0] = True
    planner.housekeeping_tick()
    rec += [side.pod_view("w0")[0], planner.stats()]
    assert rec[0] == "" and rec[2] == "host-0" and rec[3] == {}
    follower = side.planner(ttl=0.01, is_leader=lambda: False)
    p2 = side.api.create_pod(make_pod(
        "x0", chips=4, annotations={const.ANN_POD_GROUP: "solo",
                                    const.ANN_POD_GROUP_MIN: "2"}))
    rec.append(side.outcome(lambda: follower.bind_member(p2, "host-0")))
    time.sleep(0.02)
    follower.housekeeping_tick()
    rec += [follower.stats(), side.free("host-0")]
    assert rec[-2:] == [{}, 0]  # host-0 holds w0, bound; x0 rolled back
    return rec


def story_expiry_never_rolls_back_committed(side):
    """tests/test_gang_lifecycle.py:87."""
    side.cluster()
    planner = side.planner(FlakyBindClient(side.api, {"w0"}, side.ApiError),
                           ttl=0.01)
    p0 = side.api.create_pod(make_pod("w0", chips=4, annotations=ANN))
    p1 = side.api.create_pod(make_pod("w1", chips=4, annotations=ANN))
    side.outcome(lambda: planner.bind_member(p0, "host-0"))
    side.outcome(lambda: planner.bind_member(p1, "host-1"))
    time.sleep(0.02)
    rolled = planner.expire_stale()
    planner.retry_unbound()
    assert (rolled, side.pod_view("w0")[0]) == (0, "host-0")
    return rolled, side.pod_view("w0")


def story_housekeeping_thread_expires_and_stops(side):
    """tests/test_gang_lifecycle.py:103: the thread rolls the lone member
    back; stop ends it."""
    side.cluster()
    planner = side.planner(ttl=0.05, housekeeping_interval=0.02)
    planner.start()
    try:
        p0 = side.api.create_pod(make_pod("w0", chips=4, annotations=ANN))
        first = side.outcome(lambda: planner.bind_member(p0, "host-0"))
        held = side.free("host-0")
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and side.free("host-0") != 4:
            time.sleep(0.01)
    finally:
        planner.stop()
    thread = planner._thread
    thread.join(2)
    assert (held, side.free("host-0"), thread.is_alive()) == (0, 4, False)
    assert planner._executor() is None  # no pool after stop
    return first, held, side.free("host-0"), planner.stats()


STORIES = [story_ttl_rollback_frees_and_strips,
           story_reserve_retry_during_rollback_is_refused,
           story_duplicate_reserve_in_flight_is_refused,
           story_retry_unbound_after_a_failed_post,
           story_own_binding_failure_is_raised,
           story_deleted_member_is_dropped,
           story_follower_tick_expires_but_never_binds,
           story_expiry_never_rolls_back_committed,
           story_housekeeping_thread_expires_and_stops]


@pytest.mark.parametrize("story", STORIES, ids=[s.__name__[6:]
                                                for s in STORIES])
def test_planner_story_matches_the_reference(story):
    jax_side, port_side = sides()
    got = story(port_side), port_side.decisions()
    want = story(jax_side), jax_side.decisions()
    assert got == want


def test_quorum_marker_and_reasons_are_the_reference_s():
    assert tplanner.QUORUM_HOLD_MARKER == jplanner.QUORUM_HOLD_MARKER
    for name in ("REASON_GANG_PENDING", "REASON_GANG_EXPIRED",
                 "REASON_GANG_REAPED", "REASON_GANG_COMMITTED"):
        assert getattr(tevents, name) == getattr(jevents, name)
    assert issubclass(tplanner.GangPending, TAllocationError)
