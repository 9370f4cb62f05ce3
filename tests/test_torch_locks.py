"""The port's contention-traced locks (``tpushare_torch/utils/locks.py``)
against the JAX package's (``tpushare/utils/locks.py``), the same inputs
through both.

* Reentrancy: nested acquires by the holder record no contention, a
  second thread's non-blocking acquire fails until the last release, the
  owner and the held-site stack follow.
* Contention that a second thread forces on the scheduler cache's
  ``cache/table`` lock, while a verb's decision is open on the waiting
  thread: the span's ``worstLockSite`` is ``cache/table`` in both
  packages, and its ``lockWaitSeconds`` is at least the forced wait.
* The armed race detector, fed the same seeded acquisition orders and
  guarded mutations: the same lock-order edges, ``lock_order_cycles``,
  guard-violation messages and ``race_report``.
* The same contention registry renders the same ``render_mutex_profile``.
"""

from __future__ import annotations

import inspect
import sys
import threading
import time

import numpy as np
import pytest

from tests.torch_obs_reset import fresh_port_obs  # noqa: F401
from tpushare import trace as jtrace
from tpushare.cache.cache import SchedulerCache as JCache
from tpushare.k8s.fake import FakeApiServer as JFake
from tpushare.utils import locks as jlocks
from tpushare_torch import trace as ttrace
from tpushare_torch.cache.cache import SchedulerCache as TCache
from tpushare_torch.k8s.fake import FakeApiServer as TFake
from tpushare_torch.utils import locks as tlocks

SIDES = {"jax": (jlocks, jtrace, JCache, JFake),
         "port": (tlocks, ttrace, TCache, TFake)}


@pytest.fixture(autouse=True)
def fresh_locks():
    for locks, trace, _, _ in SIDES.values():
        locks.reset_contention()
        locks.disarm_race_detector()
        locks.reset_race_detector()
        trace.reset()
    yield
    for locks, trace, _, _ in SIDES.values():
        locks.reset_contention()
        locks.disarm_race_detector()
        locks.reset_race_detector()
        trace.reset()


def test_the_module_is_the_reference_s():
    """The same public names and declared sites."""
    public = lambda mod: sorted(n for n in vars(mod) if not n.startswith("_")
                                and not inspect.ismodule(getattr(mod, n)))
    assert public(tlocks) == public(jlocks)
    assert tlocks.FLOW_DECLARED_SITES == jlocks.FLOW_DECLARED_SITES


# -- reentrancy ---------------------------------------------------------------- #

def _reentrancy(locks) -> list:
    lock = locks.TracingRLock("fixture/reentrant")
    seen = []
    other = []

    def try_from_another_thread():
        got = lock.acquire(blocking=False)
        if got:
            lock.release()
        other.append(got)

    for depth in range(1, 4):
        assert lock.acquire()
        seen.append((depth, lock._depth, lock.held_by_current_thread(),
                     locks.held_sites()))
    with lock:
        seen.append(("with", lock._depth, locks.held_sites()))
    for _ in range(3):
        t = threading.Thread(target=try_from_another_thread)
        t.start()
        t.join()
        lock.release()
        seen.append(("released", lock._depth, lock.held_by_current_thread(),
                     locks.held_sites()))
    t = threading.Thread(target=try_from_another_thread)
    t.start()
    t.join()
    seen.append(("other", other, locks.contention_snapshot()))
    return seen


def test_reentrancy_records_no_contention():
    want = _reentrancy(jlocks)
    got = _reentrancy(tlocks)
    assert got == want
    assert got[-1] == ("other", [False, False, False, True], {})
    assert got[3] == ("with", 4, ("fixture/reentrant",))


def test_a_failed_timed_acquire_is_recorded_and_returns_false():
    answers = []
    for locks in (jlocks, tlocks):
        lock = locks.TracingRLock("fixture/timed")
        held, done = threading.Event(), threading.Event()

        def hold():
            with lock:
                held.set()
                done.wait(10)

        t = threading.Thread(target=hold)
        t.start()
        assert held.wait(10)
        got = lock.acquire(timeout=0.01)
        done.set()
        t.join()
        snap = locks.contention_snapshot()
        answers.append((got, sorted(snap), snap["fixture/timed"][0],
                        snap["fixture/timed"][1] >= 0.01))
        locks.reset_contention()
    assert answers[1] == answers[0] == (False, ["fixture/timed"], 1, True)


# -- contention on cache/table lands in the decision span ----------------------- #

def _blocking_line(locks) -> int:
    """The line of ``TracingRLock.acquire``'s timed blocking acquire."""
    src, start = inspect.getsourcelines(locks.TracingRLock.acquire)
    for i, line in enumerate(src):
        if "self._lock.acquire(timeout=timeout)" in line:
            return start + i
    raise AssertionError("no blocking acquire")


def _forced_wait(side: str, forced_s: float) -> dict:
    """A cache's ``cache/table`` lock held by this thread while a worker
    opens a filter decision and reads the cache; released ``forced_s``
    after the worker is seen parked in the blocking acquire. Returns the
    worker's filter span."""
    locks, trace, cache_cls, fake_cls = SIDES[side]
    api = fake_cls()
    cache = cache_cls(api.get_node, api.list_pods)
    assert cache._lock.site == "cache/table"
    line = _blocking_line(locks)
    opened = threading.Event()
    out: dict = {}

    def verb():
        with trace.phase("filter", "default", f"{side}-pod", "uid") as dec:
            opened.set()
            out["known"] = cache.known_pod("nobody")
        trace.complete(dec, "unschedulable")

    with cache._lock:
        worker = threading.Thread(target=verb)
        worker.start()
        assert opened.wait(10)
        deadline = time.monotonic() + 10
        while True:
            frame = sys._current_frames().get(worker.ident)
            if (frame is not None and frame.f_code.co_name == "acquire"
                    and frame.f_code.co_filename == inspect.getsourcefile(
                        locks) and frame.f_lineno == line):
                break
            assert time.monotonic() < deadline, "the worker never parked"
            time.sleep(0.001)
        time.sleep(forced_s)
    worker.join(10)
    assert out["known"] is False
    doc = trace.get_trace("default", f"{side}-pod")
    [span] = doc["spans"]
    return span


@pytest.mark.parametrize("forced_s", [0.02, 0.05])
def test_forced_contention_on_cache_table_lands_in_both_spans(forced_s):
    spans = {side: _forced_wait(side, forced_s) for side in SIDES}
    for side, span in spans.items():
        site, waited = span["attrs"]["worstLockSite"]
        assert site == "cache/table", side
        assert span["lockWaitSeconds"] >= forced_s, (side, span)
        assert waited >= forced_s, (side, span)
        assert span["lockWaitSeconds"] == pytest.approx(waited, abs=1e-6)
    assert ({k: v for k, v in spans["port"].items() if "econds" not in k
             and k != "attrs"}
            == {k: v for k, v in spans["jax"].items() if "econds" not in k
                and k != "attrs"})
    for locks, _, _, _ in SIDES.values():
        assert list(locks.contention_snapshot()) == ["cache/table"]


# -- the race detector ---------------------------------------------------------- #

SITES = ("cache/table", "node/n0", "node/n1", "chip/0", "quota/ledger",
         "gang/table")


def _race_stream(locks, seed: int) -> dict:
    """A seeded stream of nested acquisitions over ``SITES`` and of
    mutations of guarded containers, under their lock or not, with the
    detector armed; what the detector then answers."""
    rng = np.random.default_rng(seed)
    pool = {site: locks.TracingRLock(site) for site in SITES}
    guarded = {site: (locks.guarded_dict(pool[site], f"dict({site})"),
                      locks.guarded_set(pool[site], f"set({site})"))
               for site in SITES}
    locks.arm_race_detector()
    for step in range(int(rng.integers(20, 60))):
        depth = int(rng.integers(1, 4))
        order = [SITES[int(i)] for i in rng.choice(len(SITES), depth,
                                                   replace=False)]
        held = []
        for site in order:
            pool[site].acquire()
            held.append(site)
        target = SITES[int(rng.integers(len(SITES)))]
        d, s = guarded[target]
        op = int(rng.integers(8))
        if op == 0:
            d[step] = step
        elif op == 1:
            d.pop(step - 1, None)
        elif op == 2:
            d |= {step: -step}
        elif op == 3:
            d.setdefault(step, 0)
        elif op == 4:
            s.add(step)
        elif op == 5:
            s |= {step, step + 1}
        elif op == 6:
            s.discard(step - 1)
        else:
            s -= {step}
        for site in reversed(held):
            pool[site].release()
    out = {"edges": sorted(locks.lock_order_edges()),
           "cycles": locks.lock_order_cycles(),
           "violations": locks.guard_violations(),
           "report": locks.race_report(),
           "contents": {site: (dict(d), sorted(s))
                        for site, (d, s) in guarded.items()}}
    try:
        locks.assert_race_free()
        out["raised"] = None
    except AssertionError as exc:
        out["raised"] = str(exc)
    locks.disarm_race_detector()
    locks.reset_race_detector()
    return out


@pytest.mark.parametrize("seed", range(6))
def test_the_race_detector_answers_alike(seed):
    want = _race_stream(jlocks, seed)
    got = _race_stream(tlocks, seed)
    assert got == want
    assert got["violations"] and got["cycles"]
    assert got["raised"].startswith("race detector:\n")


def test_a_disarmed_detector_records_nothing():
    for locks in (jlocks, tlocks):
        lock = locks.TracingRLock("fixture/a")
        other = locks.TracingRLock("fixture/b")
        d = locks.guarded_dict(lock, "d")
        d["x"] = 1
        with other, lock:
            pass
        with lock, other:
            pass
        assert (locks.lock_order_cycles(), locks.guard_violations()) == (
            [], [])
        locks.assert_race_free()


# -- the mutex profile -------------------------------------------------------- #

@pytest.mark.parametrize("seed", range(4))
def test_the_same_registry_renders_the_same_mutex_profile(seed):
    rng = np.random.default_rng(seed)
    events = [(SITES[int(rng.integers(len(SITES)))],
               float(rng.exponential(0.002)))
              for _ in range(int(rng.integers(1, 200)))]
    renders = []
    for locks in (jlocks, tlocks):
        for site, waited in events:
            locks.record_contention(site, waited)
        renders.append((locks.render_mutex_profile(),
                        locks.contention_snapshot()))
        locks.reset_contention()
    assert renders[1] == renders[0]
    assert renders[1][0].startswith(
        f"# mutex profile: {len(renders[1][1])} contended sites")


def test_a_failing_hook_never_fails_an_acquire():
    calls = []

    def broken(site, waited):
        calls.append(site)
        raise RuntimeError("broken hook")

    for locks in (jlocks, tlocks):
        locks.add_contention_hook(broken)
        try:
            locks.record_contention("fixture/hooked", 0.001)
        finally:
            locks.remove_contention_hook(broken)
        assert locks.contention_snapshot()["fixture/hooked"][0] == 1
        locks.reset_contention()
    assert calls == ["fixture/hooked"] * 2
