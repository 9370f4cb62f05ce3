"""The port's decision traces (``tpushare_torch/trace/``, and where the
extender records them) against the JAX package's.

* The reference's stories of ``tests/test_trace.py`` over the port's
  modules (``tests/torch_reference_stories.py``): the recorder (spans,
  completion, a span that cannot leak, the bounded ring and open table,
  a recreated pod superseding its old attempt, ``flight(n)``), the
  acceptance contract over HTTP (filter, prioritize, bind and allocate
  spans, a reason for every refused node, the trace id in the bind
  annotation and in the ``TPUShareBound`` Event), ``/debug/flight``,
  an unschedulable pod's decision, no decision for a pod that asks for
  no card, the 404s and ``debug_routes=False``, a gang commit's Events
  each carrying its own member's id, the round trip over the real
  apiserver dialect (``tests/miniapiserver.py``: the allocate span
  counts the PUT and the binding), the JSON log formatter, and
  ``TestLockWaitAttribution``: a contended ``TracingRLock`` charges its
  wait to the open span, and the recorder never attributes its own lock.
* Both recorders fed the same seeded streams of phases, spans, notes,
  parents and completions (across pods, uid changes and table
  pressure): the same flight documents, clocks and ids aside, the same
  causal chains, the same ``get_trace`` answers.
* ``parse_traceparent`` / ``format_traceparent`` on a table of headers,
  and the JSON log line, against the reference's.
* ``DEBUG_ROUTES=0`` and ``TPUSHARE_LOG_JSON=1`` through the port's
  ``main``; ``/debug/trace?id=`` and ``/debug/http`` on both stacks.
"""

from __future__ import annotations

import importlib
import json
import logging
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from tests import torch_reference_stories as R
from tests.test_torch_extender_e2e import H100, Pair, normal_trace
from tests.torch_obs_reset import fresh_port_obs  # noqa: F401
from tpushare import trace as jtrace
from tpushare.utils import locks as jlocks
from tpushare.k8s.builders import make_node, make_pod
from tpushare.trace.jsonlog import TraceJsonFormatter as JFormatter
from tpushare_torch import trace as ttrace
from tpushare_torch.cmd import main as M
from tpushare_torch.k8s.fake import FakeApiServer
from tpushare_torch.trace.jsonlog import TraceJsonFormatter as TFormatter
from tpushare_torch.utils import const
from tpushare_torch.utils import locks as tlocks

# The packages' ``recorder()`` function shadows the submodule's name.
jrecorder = importlib.import_module("tpushare.trace.recorder")
trecorder = importlib.import_module("tpushare_torch.trace.recorder")

# The story module's fixtures build their stacks from its (redirected)
# imports: ``tests/test_handlers.py``'s ``build_stack`` and
# ``tests/test_e2e.py``'s ``Cluster``, over the port.
R.load("test_handlers")
R.load("test_e2e")
_STORIES = R.load("test_trace")
fresh_recorder = _STORIES.fresh_recorder
http_stack = _STORIES.http_stack
globals().update(R.pick(_STORIES, [
    "TestRecorder", "TestLockWaitAttribution", "TestEndToEndTrace",
    "TestGangEventCorrelation", "TestMiniApiServerRoundTrip",
    "TestJsonLogging"]))


@pytest.fixture
def api():
    """The reference's stories run over the port's fake apiserver."""
    return FakeApiServer()


# -- the recorders on the same streams --------------------------------------- #

VERBS = ("filter", "prioritize", "preempt", "bind")
INNER = ("allocate", "gang", "quota")


def _drive(trace, seed: int, pods: int, steps: int) -> dict:
    """A seeded stream of recorder operations; returns what the recorder
    then answers, clocks and ids aside. The process-wide recorder's open
    table is cut to 6 for the stream and given its bound back after."""
    rec = trace.recorder()
    max_open, rec._max_open = rec._max_open, 6
    try:
        return _stream(trace, seed, pods, steps)
    finally:
        rec._max_open = max_open


def _stream(trace, seed: int, pods: int, steps: int) -> dict:
    rng = np.random.default_rng(seed)
    trace.reset()
    ids: list[str] = []
    uids = {f"p{i}": f"u{i}-0" for i in range(pods)}
    for step in range(steps):
        name = f"p{int(rng.integers(pods))}"
        if rng.random() < 0.08:  # the pod recreated under a new uid
            uids[name] = f"{name}-{step}"
        verb = VERBS[int(rng.integers(len(VERBS)))]
        with trace.phase(verb, "default", name, uids[name]) as dec:
            if dec.trace_id not in ids:
                ids.append(dec.trace_id)
            if rng.random() < 0.3:
                trace.set_parent(ids[int(rng.integers(len(ids)))])
            trace.note("step", step)
            for _ in range(int(rng.integers(3))):
                with trace.span(INNER[int(rng.integers(len(INNER)))],
                                node=f"n{int(rng.integers(4))}"):
                    trace.note("chips", [int(rng.integers(8))])
                    trace.note_api_call(0.001, "PUT", "/x")
            trace.note_queue_wait(0.0005)
        roll = rng.random()
        if roll < 0.25:
            trace.complete(dec, "bound", node="n0")
        elif roll < 0.35:
            trace.complete(dec, "failed", node="n1", error="boom")
        elif roll < 0.45:
            trace.complete(dec, "gang-pending", error="pending quorum")
        elif roll < 0.55:
            trace.complete(dec, "unschedulable", error="nowhere")
    flight = trace.flight()
    chains = []
    for doc in flight[:20]:
        chain = trace.causal_chain(doc["traceId"])
        chains.append({k: [normal_trace(d) if "spans" in d else
                           {"missing": d.get("missing", False)}
                           for d in (v if isinstance(v, list) else [v])]
                       for k, v in chain.items()})
    latest = {n: normal_trace(trace.get_trace("default", n))
              for n in uids}
    by_id = [normal_trace(trace.get_trace(d["namespace"], d["name"],
                                          trace_id=d["traceId"]))
             for d in flight[::7]]
    out = {"flight": [normal_trace(d) for d in flight], "chains": chains,
           "latest": latest, "by_id": by_id,
           "drops": trace.recorder().drops.value}
    trace.reset()
    return out


@pytest.mark.parametrize("seed", range(6))
def test_recorders_answer_alike_on_a_seeded_stream(seed):
    want = _drive(jtrace, seed, pods=9, steps=700)
    got = _drive(ttrace, seed, pods=9, steps=700)
    assert got == want
    assert len(got["flight"]) == jtrace.DEFAULT_CAPACITY
    assert {d["outcome"] for d in got["flight"]} >= {
        "bound", "abandoned", "superseded"}


def test_recorder_constants_are_the_reference_s():
    assert ttrace.DEFAULT_CAPACITY == jtrace.DEFAULT_CAPACITY == 256
    assert trecorder.DEFAULT_MAX_OPEN == jrecorder.DEFAULT_MAX_OPEN == 512
    assert (trecorder.DEFAULT_MAX_RESTORED
            == jrecorder.DEFAULT_MAX_RESTORED)
    assert sorted(ttrace.__all__) == sorted(jtrace.__all__)


def test_recorder_lock_is_a_plain_rlock():
    """The port's recorder takes the reference's ``TracingRLock``
    ("trace/recorder"), and both packages register the contention hook:
    the same contention reported on each lands alike in the open span,
    the worst site as ``worstLockSite``, and a ``trace/`` site is never
    charged."""
    assert isinstance(trecorder.FlightRecorder()._lock, tlocks.TracingRLock)
    assert (trecorder.FlightRecorder()._lock.site
            == jrecorder.FlightRecorder()._lock.site == "trace/recorder")
    spans = []
    for trace, locks in ((jtrace, jlocks), (ttrace, tlocks)):
        trace.reset()
        assert trace._on_contention in locks._contention_hooks
        with trace.phase("bind", "default", "p", "u") as dec:
            locks.record_contention("cache/table", 0.25)
            locks.record_contention("trace/recorder", 1.0)
            locks.record_contention("node/h100-00", 0.5)
            with trace.span("allocate"):
                locks.record_contention("chip/3", 0.125)
        trace.complete(dec, "bound")
        spans.append(trace.get_trace("default", "p")["spans"])
        locks.reset_contention()
        trace.reset()
    assert spans[1] == [{**sp, "seconds": spans[1][i]["seconds"],
                         "cpuSeconds": spans[1][i]["cpuSeconds"],
                         "startOffsetSeconds":
                             spans[1][i]["startOffsetSeconds"]}
                        for i, sp in enumerate(spans[0])]
    assert spans[1][0]["lockWaitSeconds"] == 0.75
    assert spans[1][0]["attrs"]["worstLockSite"] == ("node/h100-00", 0.5)
    assert spans[1][1]["lockWaitSeconds"] == 0.125


def test_restored_documents_resolve_alike():
    docs = [{"traceId": "aaaaaaaaaaaa", "namespace": "d", "name": "p",
             "outcome": "bound", "spans": []},
            {"traceId": "bbbbbbbbbbbb", "parentId": "aaaaaaaaaaaa",
             "namespace": "d", "name": "p", "outcome": "evicted",
             "spans": []},
            {"no": "id"}, "not a dict"]
    answers = []
    for trace in (jtrace, ttrace):
        trace.reset()
        for doc in docs:
            trace.restore(doc)
        answers.append((trace.causal_chain("aaaaaaaaaaaa"),
                        trace.causal_chain("bbbbbbbbbbbb"),
                        trace.get_trace("d", "p", trace_id="bbbbbbbbbbbb"),
                        trace.recorder().drops.value))
        trace.reset()
    assert answers[1] == answers[0]
    assert answers[1][3] == 2


HEADERS = [
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-abcdef0123450000000000000000000000-abcdef0123450000-01",
    "00-abcdef012345" + "0" * 20 + "-abcdef0123450000-01",
    "00-" + "0" * 32 + "-00f067aa0ba902b7-01",
    "ff-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-4BF92F3577B34DA6A3CE929D0E0E4736-00F067AA0BA902B7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e473-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7",
    "zz-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    " 00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01 ",
    "", "garbage", "00-g" + "0" * 31 + "-00f067aa0ba902b7-01",
]


@pytest.mark.parametrize("header", HEADERS)
def test_traceparent_parse_is_the_reference_s(header):
    assert ttrace.parse_traceparent(header) == \
        jtrace.parse_traceparent(header)


@pytest.mark.parametrize("seed", range(4))
def test_traceparent_round_trips_a_native_id(seed):
    tid = np.random.default_rng(seed).bytes(6).hex()
    header = ttrace.format_traceparent(tid)
    assert header == jtrace.format_traceparent(tid)
    assert ttrace.parse_traceparent(header) == tid
    assert len(ttrace.new_trace_id()) == len(jtrace.new_trace_id()) == 12


def test_json_log_line_is_the_reference_s():
    record = logging.LogRecord("tpushare.test", logging.WARNING, __file__,
                               1, "placed %s on %s", ("default/p", {"n": 1}),
                               None)
    lines = []
    for trace, fmt in ((jtrace, JFormatter()), (ttrace, TFormatter())):
        outside = json.loads(fmt.format(record))
        with trace.phase("bind", "default", "p", "u1") as dec:
            inside = json.loads(fmt.format(record))
        trace.complete(dec, "bound")
        assert inside.pop("traceId") == dec.trace_id
        lines.append((outside, inside))
        trace.reset()
    (j_out, j_in), (t_out, t_in) = lines
    for want, got in ((j_out, t_out), (j_in, t_in)):
        assert len(got.pop("ts")) == len(want.pop("ts"))
        assert got == want


# -- the port's main ---------------------------------------------------------- #

_REAL_CONFIGURE_LOGGING = M.configure_logging

@pytest.fixture
def no_cluster(monkeypatch):
    api = FakeApiServer()
    monkeypatch.setattr(M.ClusterConfig, "auto",
                        classmethod(lambda cls: None))
    monkeypatch.setattr(M, "ApiClient", lambda cfg: api)
    monkeypatch.setattr(M, "configure_logging", lambda: None)
    for key in ("TLS_CERT_FILE", "TLS_KEY_FILE", "LEADER_ELECT",
                "DEBUG_ROUTES", "TPUSHARE_LOG_JSON"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("PORT", "0")
    monkeypatch.setenv("TPUSHARE_GC_TUNE", "off")
    return api


@pytest.mark.parametrize("value,on", [("0", False), ("false", False),
                                      ("no", False), ("1", True)])
def test_main_reads_debug_routes(no_cluster, monkeypatch, value, on):
    """``DEBUG_ROUTES`` through ``main``: the server it serves answers
    ``/debug/*`` or 404s "debug routes disabled"; ``/metrics`` and the
    verbs answer either way."""
    monkeypatch.setenv("DEBUG_ROUTES", value)
    seen = {}
    ready, release = threading.Event(), threading.Event()

    def signals(stop, flush=None):
        def wait():
            ready.wait(30)
            release.wait(30)
            stop.set()
        threading.Thread(target=wait, daemon=True).start()
    monkeypatch.setattr(M, "setup_signals", signals)
    real = M.make_server

    def make_server(*a, **kw):
        seen["server"] = real(*a, **kw)
        return seen["server"]
    monkeypatch.setattr(M, "make_server", make_server)
    real_serve = M.serve_forever

    def serve(server):
        t = real_serve(server)
        ready.set()
        return t
    monkeypatch.setattr(M, "serve_forever", serve)
    runner = threading.Thread(target=M.main)
    runner.start()
    try:
        assert ready.wait(30)
        server = seen["server"]
        assert server.debug_routes is on
        base = f"http://127.0.0.1:{server.server_address[1]}"
        for path in ("/debug/flight", "/debug/http", "/debug/quota",
                     "/debug/trace/default/p", "/debug/pprof",
                     "/debug/pprof/mutex", "/debug/threads",
                     "/debug/hotspots", "/debug/profile/continuous"):
            try:
                with urllib.request.urlopen(f"{base}{path}") as resp:
                    status, body = resp.status, resp.read()
            except urllib.error.HTTPError as e:
                status, body = e.code, e.read()
            try:
                doc = json.loads(body)
            except ValueError:
                doc = {"text": body.decode()}
            if on:
                assert doc.get("Error") != "debug routes disabled", path
            else:
                assert (status, doc) == (
                    404, {"Error": "debug routes disabled"}), path
        with urllib.request.urlopen(f"{base}/metrics") as resp:
            assert b"tpushare_leader 1.0" in resp.read()
    finally:
        release.set()
        runner.join(30)
    assert not runner.is_alive()


def test_main_installs_the_json_formatter(no_cluster, monkeypatch):
    """``TPUSHARE_LOG_JSON=1``: ``main``'s ``configure_logging`` puts the
    trace-tagged formatter on its console handler, and a line logged
    inside a decision carries the decision's id."""
    monkeypatch.setattr(M, "configure_logging", _REAL_CONFIGURE_LOGGING)
    monkeypatch.setenv("TPUSHARE_LOG_JSON", "1")
    monkeypatch.setattr(M, "setup_signals",
                        lambda stop, flush=None: stop.set())
    root = logging.getLogger()
    saved = list(root.handlers)
    for h in saved:
        root.removeHandler(h)
    try:
        M.main()
        ours = [h for h in root.handlers
                if getattr(h, "_tpushare_console", False)]
        assert ours and isinstance(ours[0].formatter, TFormatter)
        record = logging.LogRecord("x", logging.INFO, __file__, 1, "m",
                                   (), None)
        with ttrace.phase("bind", "default", "p", "u") as dec:
            line = json.loads(ours[0].format(record))
        ttrace.complete(dec, "bound")
        assert line["traceId"] == dec.trace_id
    finally:
        for h in list(root.handlers):
            root.removeHandler(h)
        for h in saved:
            root.addHandler(h)
        ttrace.reset()



# -- both stacks over HTTP ----------------------------------------------------- #

@pytest.fixture
def pair():
    p = Pair()
    yield p
    p.close()


def test_causal_chain_and_http_debug_routes_on_both_stacks(pair):
    """A bind sent with the scheduler's ``traceparent``: its decision's
    parent is the caller's id on both; ``/debug/trace?id=`` resolves the
    same chain (the caller's id missing from both rings); ``/debug/http``
    has the reference's keys and gate counts."""
    pair.create_node(make_node("h100-0", **H100))
    doc = pair.create_pod(make_pod("w", hbm=8))
    root = "0123456789ab"
    header = {"traceparent": jtrace.format_traceparent(root)}
    chains, https = [], []
    for side in pair.sides:
        req = urllib.request.Request(
            f"{side.base}/tpushare-scheduler/bind",
            data=json.dumps({"PodName": "w", "PodNamespace": "default",
                             "PodUID": doc["metadata"]["uid"],
                             "Node": "h100-0"}).encode(),
            headers={"Content-Type": "application/json", **header})
        with urllib.request.urlopen(req) as resp:
            assert resp.status == 200
            tid = side.trace.parse_traceparent(resp.headers["traceparent"])
        dec = side.decision("default", "w")
        assert dec["traceId"] == tid and dec["parentId"] == root
        assert side.api.get_pod("default", "w").annotations[
            const.ANN_TRACE_PARENT] == root
        status, body = side.get(f"/debug/trace?id={tid}")
        assert status == 200
        chain = json.loads(body)
        chains.append({"target": normal_trace(chain["target"]),
                       "ancestors": chain["ancestors"],
                       "descendants": chain["descendants"]})
        assert side.get("/debug/trace?id=ffffffffffff")[0] == 404
        assert side.get("/debug/trace")[0] == 404
        status, body = side.get("/debug/http")
        assert status == 200
        https.append(json.loads(body))
    assert chains[1] == chains[0]
    assert chains[0]["ancestors"] == [{"traceId": root, "missing": True}]
    assert set(https[1]) == set(https[0])
    for key in ("filterGate", "prioritizeGate", "wireMemos"):
        assert set(https[1][key]) == set(https[0][key])
    assert https[1]["workers"] == https[0]["workers"]
