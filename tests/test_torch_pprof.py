"""The port's pprof suite (``tpushare_torch/routes/pprof.py``) and its
routes against the JAX package's.

* ``index()`` is the reference's, letter for letter; ``thread_dump``
  names every live thread in both.
* The time-boxed samplers on an injected clock (a sampler's ``clock``
  and ``sleep``): the same number of passes and the same headers on both,
  the block profile shows a thread parked in a wait, the execution trace
  parses with a lane per thread; a second profile while one runs raises
  ``ProfileBusyError`` on both; the heap snapshot's start, snapshot and
  stop answers alike.
* The wire: each package's ``serve_stack`` answers every
  ``/debug/pprof*``, ``/debug/threads``, ``/debug/profile/continuous``
  and ``/debug/hotspots`` request with the same status and content type
  (400 for a non-numeric or NaN ``seconds`` / ``hz``, ``top`` or
  ``window``; 409 while another profile runs; 404 while the continuous
  profiler is not running); ``/debug/pprof`` and ``/debug/pprof/mutex``
  with the same body. ``debug_routes=False`` answers each with 404.
* The reference's ``tests/test_profiling.py::TestWire`` stories over the
  port (``tests/torch_reference_stories.py``).
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request

import pytest

from tests import torch_reference_stories as R
from tests.torch_obs_reset import fresh_port_obs  # noqa: F401
from tpushare import profiling as jprofiling
from tpushare.cmd import main as jmain
from tpushare.k8s.builders import make_node
from tpushare.k8s.fake import FakeApiServer as JFake
from tpushare.routes import pprof as jpprof
from tpushare.routes import server as jserver
from tpushare.utils import locks as jlocks
from tpushare_torch import profiling as tprofiling
from tpushare_torch.cmd import main as tmain
from tpushare_torch.k8s.fake import FakeApiServer as TFake
from tpushare_torch.routes import pprof as tpprof
from tpushare_torch.routes import server as tserver
from tpushare_torch.utils import locks as tlocks

PPROF = {"jax": jpprof, "port": tpprof}
SERVERS = {jmain: jserver, tmain: tserver}
PROFILING = {"jax": jprofiling, "port": tprofiling}

# -- the reference's wire stories over the port ------------------------------- #

_STORIES = R.load("test_profiling")
fresh_profiling = _STORIES.fresh_profiling
wired_stack = _STORIES.wired_stack
globals().update(R.pick(_STORIES, ["TestWire"]))


@pytest.fixture(autouse=True)
def both_profilers_stopped():
    """Neither package's profiler armed outside the test that arms it,
    and only one at a time within it."""
    jprofiling.reset()
    yield
    jprofiling.reset()
    tprofiling.reset()


# -- the module ---------------------------------------------------------------- #

def test_index_is_the_reference_s():
    assert tpprof.index() == jpprof.index()
    assert tpprof.index("/x") == jpprof.index("/x")
    assert tpprof._BLOCKED_LEAVES == jpprof._BLOCKED_LEAVES


def test_thread_dump_names_every_live_thread():
    for pprof in PPROF.values():
        dump = pprof.thread_dump()
        for t in threading.enumerate():
            assert f"--- {t.name} ({t.ident}) ---" in dump


class _Clock:
    """An injected clock: ``sleep`` advances it, nothing else does."""

    def __init__(self):
        self.now = 1000.0
        self.sleeps = 0

    def clock(self) -> float:
        return self.now

    def sleep(self, seconds: float) -> None:
        self.sleeps += 1
        self.now += seconds


@pytest.fixture
def parked():
    """For each package a thread holding one of its locks while parked
    in an Event's wait, and a thread parked on that lock; released at
    teardown."""
    release = threading.Event()
    held = {}
    threads = []
    for side, locks in (("jax", jlocks), ("port", tlocks)):
        lock = locks.TracingRLock(f"fixture/{side}-parked")
        got = threading.Event()

        def hold(lock=lock, got=got):
            with lock:
                got.set()
                release.wait(30)

        def park(lock=lock):
            with lock:
                pass

        holder = threading.Thread(target=hold, name=f"holder-{side}")
        holder.start()
        assert got.wait(10)
        parker = threading.Thread(target=park, name=f"parked-{side}")
        parker.start()
        threads += [holder, parker]
        held[side] = lock
    yield held
    release.set()
    for t in threads:
        t.join(10)


@pytest.mark.parametrize("seconds,hz", [(0.5, 100), (2.0, 10), (0.1, 1000)])
def test_samplers_run_on_an_injected_clock(parked, seconds, hz):
    heads = {}
    for side, pprof in PPROF.items():
        got = []
        for sampler in (pprof.sample_profile, pprof.sample_block_profile):
            clk = _Clock()
            text = sampler(seconds, hz, clock=clk.clock, sleep=clk.sleep)
            head, _, body = text.partition("\n")
            got.append((head, clk.sleeps))
            assert body, text
            threads = len(threading.enumerate())
            for line in body.splitlines():
                stack, _, count = line.rpartition(" ")
                assert (count.isdigit()
                        and int(count) <= clk.sleeps * threads), line
            if sampler is pprof.sample_block_profile:
                # A thread parked in an Event's wait shows; one parked
                # in a TracingRLock's C-level acquire leaves locks.py on
                # top, which the mutex profile covers instead.
                assert "hold (test_torch_pprof.py:" in body, body
                assert "park (test_torch_pprof.py:" not in body, body
            else:
                assert any("park (test_torch_pprof.py:" in line
                           and ";acquire (locks.py:" in line
                           for line in body.splitlines()), body
        clk = _Clock()
        doc = json.loads(pprof.sample_trace(seconds, hz, clock=clk.clock,
                                            sleep=clk.sleep))
        lanes = {e["args"]["name"] for e in doc["traceEvents"]
                 if e["ph"] == "M"}
        assert {f"parked-{side}", f"holder-{side}"} <= lanes, lanes
        assert all(e["dur"] >= 1.0 for e in doc["traceEvents"]
                   if e["ph"] == "X")
        got.append((doc["displayTimeUnit"], clk.sleeps))
        heads[side] = got
    assert heads["port"] == heads["jax"]
    passes = heads["port"][0][1]
    assert abs(passes - seconds * hz) <= 1
    assert heads["port"][0][0] == (
        f"# collapsed-stack profile: {passes} samples at {hz}Hz over "
        f"{seconds:.1f}s")
    assert heads["port"][1][0].startswith("# lock-wait profile:")


def test_a_second_profile_is_refused_while_one_runs():
    answers = []
    for side, pprof in PPROF.items():
        holding, done = threading.Event(), threading.Event()

        def hold():
            with pprof._profile_lock:
                holding.set()
                done.wait(30)

        t = threading.Thread(target=hold)
        t.start()
        assert holding.wait(10)
        try:
            refused = []
            for sampler in (pprof.sample_profile,
                            pprof.sample_block_profile, pprof.sample_trace):
                with pytest.raises(pprof.ProfileBusyError) as exc:
                    sampler(0.1, 10)
                refused.append(str(exc.value))
        finally:
            done.set()
            t.join(10)
        answers.append(refused)
    assert answers[1] == answers[0]
    assert tpprof._profile_lock.site == jpprof._profile_lock.site
    assert tpprof._heap_lock.site == jpprof._heap_lock.site


def test_heap_snapshot_answers_alike():
    import tracemalloc

    was = tracemalloc.is_tracing()
    try:
        answers = []
        for pprof in PPROF.values():
            stop = pprof.heap_snapshot(stop=True)
            start = pprof.heap_snapshot()
            blob = [bytes(1000) for _ in range(100)]
            snap = pprof.heap_snapshot(top=5)
            del blob
            stopped = pprof.heap_snapshot(stop=True)
            answers.append((stop, start, snap.split(":")[0],
                            len(snap.splitlines()) <= 6, stopped,
                            tracemalloc.is_tracing()))
        assert answers[1] == answers[0]
        assert answers[0][0] == "# tracemalloc stopped; heap tracing is off.\n"
        assert answers[0][5] is False
    finally:
        if was:
            tracemalloc.start()


# -- both stacks over HTTP ------------------------------------------------------ #

class _Side:
    """One package's stack over HTTP: its ``serve_stack``, or with
    ``debug_routes=False`` its server made as the reference's
    ``test_debug_routes_off_hides_surfaces`` makes it."""

    def __init__(self, main, fake, debug_routes: bool = True):
        self.api = fake()
        self.api.create_node(make_node("n0", chips=8, hbm_per_chip=79,
                                       topology="", tpu_type="h100-80gb"))
        self.main = main
        if debug_routes:
            self.stack, self.server = main.serve_stack(self.api)
        else:
            routes = SERVERS[main]
            self.stack = main.build_stack(self.api)
            self.stack.controller.start(workers=1)
            self.server = routes.ExtenderHTTPServer(
                ("127.0.0.1", 0), self.stack.predicate, self.stack.binder,
                self.stack.inspect, debug_routes=False)
            routes.serve_forever(self.server)
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"

    def get(self, path: str) -> tuple[int, str, bytes]:
        try:
            with urllib.request.urlopen(self.base + path, timeout=60) as r:
                return r.status, r.headers["Content-Type"], r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.headers["Content-Type"], e.read()

    def close(self) -> None:
        self.main.shutdown_stack(self.stack, self.server)


@pytest.fixture
def sides():
    out = {"jax": _Side(jmain, JFake), "port": _Side(tmain, TFake)}
    yield out
    for side in out.values():
        side.close()


#: Requests answered the same with the continuous profiler stopped:
#: (path, status, content type, whether the bodies must be equal).
STOPPED = [
    ("/debug/pprof", 200, "text/plain; charset=utf-8", True),
    ("/debug/pprof/", 200, "text/plain; charset=utf-8", True),
    ("/debug/pprof/mutex", 200, "text/plain; charset=utf-8", True),
    ("/debug/pprof/goroutine", 200, "text/plain; charset=utf-8", False),
    ("/debug/threads", 200, "text/plain; charset=utf-8", False),
    ("/debug/pprof/profile?seconds=0.1&hz=50", 200,
     "text/plain; charset=utf-8", False),
    ("/debug/pprof/block?seconds=0.05&hz=2000", 200,
     "text/plain; charset=utf-8", False),
    ("/debug/pprof/trace?seconds=0.1&hz=50", 200, "application/json",
     False),
    ("/debug/pprof/profile?seconds=x", 400, "application/json", True),
    ("/debug/pprof/profile?seconds=nan", 400, "application/json", True),
    ("/debug/pprof/block?hz=fast", 400, "application/json", True),
    ("/debug/pprof/trace?seconds=inf", 400, "application/json", True),
    ("/debug/pprof/heap?stop=1", 200, "text/plain; charset=utf-8", True),
    ("/debug/hotspots", 404, "application/json", True),
    ("/debug/profile/continuous", 404, "application/json", True),
    ("/debug/hotspots?top=x", 404, "application/json", True),
]
#: The same with the side's own profiler armed.
ARMED = [
    ("/debug/hotspots", 200, "application/json", False),
    ("/debug/hotspots?top=3&window=30", 200, "application/json", False),
    ("/debug/profile/continuous?window=10", 200,
     "text/plain; charset=utf-8", False),
    ("/debug/hotspots?top=x", 400, "application/json", True),
    ("/debug/hotspots?window=x", 400, "application/json", True),
    ("/debug/profile/continuous?window=x", 400, "application/json", True),
]


def _answers(side, requests) -> list:
    out = []
    for path, status, ctype, _ in requests:
        got = side.get(path)
        assert (got[0], got[1]) == (status, ctype), (path, got)
        out.append(got)
    return out


def test_routes_answer_as_the_reference_s(sides):
    tlocks.reset_contention()
    jlocks.reset_contention()
    stopped = {name: _answers(side, STOPPED) for name, side in sides.items()}
    for (path, _, _, same), want, got in zip(STOPPED, stopped["jax"],
                                             stopped["port"]):
        if same:
            assert got[2] == want[2], path
    armed = {}
    for name, side in sides.items():
        prof = PROFILING[name]
        prof.start(hz=100)
        try:
            armed[name] = _answers(side, ARMED)
        finally:
            prof.reset()
    for (path, _, _, same), want, got in zip(ARMED, armed["jax"],
                                             armed["port"]):
        if same:
            assert got[2] == want[2], path
    hot = json.loads(armed["port"][1][2])
    assert sorted(hot) == sorted(json.loads(armed["jax"][1][2]))
    assert hot["hz"] == 100 and hot["driver"] == "signal"


def test_an_overlapping_profile_answers_409(sides):
    for name, side in sides.items():
        holding, done = threading.Event(), threading.Event()

        def hold():
            with PPROF[name]._profile_lock:
                holding.set()
                done.wait(30)

        t = threading.Thread(target=hold)
        t.start()
        assert holding.wait(10)
        try:
            for path in ("/debug/pprof/profile?seconds=0.1",
                         "/debug/pprof/block", "/debug/pprof/trace"):
                status, ctype, body = side.get(path)
                assert (status, ctype) == (409, "application/json"), path
                assert "in progress" in json.loads(body)["Error"]
        finally:
            done.set()
            t.join(10)


@pytest.mark.parametrize("path", [
    "/debug/pprof", "/debug/pprof/profile", "/debug/pprof/mutex",
    "/debug/pprof/heap", "/debug/pprof/trace", "/debug/pprof/block",
    "/debug/pprof/goroutine", "/debug/threads", "/debug/hotspots",
    "/debug/profile/continuous"])
def test_debug_routes_off_answers_404(path):
    answers = []
    for main, fake in ((jmain, JFake), (tmain, TFake)):
        side = _Side(main, fake, debug_routes=False)
        try:
            answers.append(side.get(path))
        finally:
            side.close()
    assert answers[1] == answers[0]
    assert answers[1][0] == 404
    assert json.loads(answers[1][2]) == {"Error": "debug routes disabled"}
