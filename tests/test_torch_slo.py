"""The port's pod-journey SLOs (``tpushare_torch/slo/``) against the JAX
package's.

* The reference's stories of ``tests/test_slo.py`` over the port's modules
  (``tests/torch_reference_stories.py``): the ConfigMap parser and its
  refusals (``TestConfig``), the journey tracker's lifecycle, supersede,
  reconstruct and bounds (``TestJourneyTracker``), the engine's window,
  burn and budget math and its rate-limited Event (``TestEngine``), the
  restart semantics and the ConfigMap watch over ``tests/miniapiserver.py``
  and the namespace pin (``TestRestartSemantics``), the quota-pressure
  acceptance story (``TestAcceptanceQuotaPressure``) and the debug routes
  (``TestDebugSurfaces``). The kubectl plugin's and the simulator's
  (``TestKubectlSlo``, ``TestToolingSurfaces``) are tools of the reference.
* Both parsers on the same ConfigMaps: the same objective tables.
* Both ``JourneyTracker``s driven through the same seeded stream of opens,
  attempts, binds, deletes, reconstructions and table pressure on pinned
  clocks: the same journey documents (the attempts' trace ids aside), the
  same stats and drops, and the same journeys handed to the engine.
* Both ``SLOEngine``s fed the same seeded stream of pod journeys and
  filter latencies on pinned clocks: the same rows after every step, the
  same ``TPUShareSLOBurn`` Events on each side's fake apiserver, and the
  same ``/debug/slo`` document.
* Both ``serve_stack``s (``tests/test_torch_extender_e2e.py``'s ``Pair``)
  after a seeded churn with pods left pending: the same ``/debug/slo``
  objectives and journey counts and the same ``/debug/journey`` document
  for every pod, clocks and ids aside.
"""

from __future__ import annotations

import datetime
import importlib
import json
import random

import numpy as np
import pytest

from tests import torch_reference_stories as R
from tests.test_torch_extender_e2e import (ARRIVALS, H100, TTL_ROUNDS, Pair,
                                           _draw_shape)
from tests.torch_obs_reset import fresh_port_obs  # noqa: F401
from tpushare import slo as jslo
from tpushare.api.objects import ConfigMap as JConfigMap, Pod as JPod
from tpushare.k8s import events as jevents
from tpushare.k8s.builders import make_node, make_pod
from tpushare.k8s.fake import FakeApiServer as JFake
from tpushare.slo import config as jconfig
from tpushare.slo.engine import SLOEngine as JEngine
from tpushare.slo.journey import JourneyTracker as JTracker
from tpushare_torch import slo as tslo
from tpushare_torch.api.objects import ConfigMap as TConfigMap, Pod as TPod
from tpushare_torch.k8s import events as tevents
from tpushare_torch.k8s.fake import FakeApiServer as TFake
from tpushare_torch.routes import metrics as tmetrics
from tpushare_torch.slo import config as tconfig
from tpushare_torch.slo.engine import SLOEngine as TEngine
from tpushare_torch.slo.journey import JourneyTracker as TTracker
from tpushare_torch.utils import const

# The packages' ``recorder()`` functions shadow their submodules' names.
jrecorder = importlib.import_module("tpushare.trace.recorder")
trecorder = importlib.import_module("tpushare_torch.trace.recorder")

# -- the reference's stories over the port ------------------------------------ #

R.load("test_quota")  # the acceptance story's Cluster
R.load("test_handlers")  # the debug story's build_stack
_STORIES = R.load("test_slo")
fresh_slo_and_trace = _STORIES.fresh_slo_and_trace
globals().update(R.pick(
    _STORIES,
    ["TestConfig", "TestJourneyTracker", "TestEngine",
     "TestRestartSemantics", "TestAcceptanceQuotaPressure",
     "TestDebugSurfaces"]))


@pytest.fixture
def api():
    """The reference's stories run over the port's fake apiserver, each
    from a fresh metrics registry (its histograms are read by counts)."""
    tmetrics.reset()
    return TFake()


SIDES = {
    "jax": dict(tracker=JTracker, engine=JEngine, config=jconfig,
                recorder=jrecorder, pod=JPod, cm=JConfigMap, fake=JFake,
                events=jevents),
    "port": dict(tracker=TTracker, engine=TEngine, config=tconfig,
                 recorder=trecorder, pod=TPod, cm=TConfigMap, fake=TFake,
                 events=tevents),
}

# -- the parser ---------------------------------------------------------------- #

CONFIGS = {
    "one": {"bind-5s": {"signal": "pod_e2e", "objective": 0.95,
                        "thresholdSeconds": 5, "fastBurn": 2}},
    "both_signals": {"bind-60s": {"signal": "pod_e2e",
                                  "thresholdSeconds": 60},
                     "filter-1ms": {"signal": "filter_latency",
                                    "objective": 0.999,
                                    "thresholdSeconds": 0.001}},
    "malformed": {"bad": "not json", "nope": '{"signal": "nope"}',
                  "ok": {"signal": "pod_e2e", "thresholdSeconds": 1}},
    "unknown_key": {"typo": {"signal": "pod_e2e", "thresholdSecond": 1},
                    "ok": {"signal": "filter_latency",
                           "thresholdSeconds": 0.01}},
    "bounds": {"one": {"signal": "pod_e2e", "objective": 1,
                       "thresholdSeconds": 1},
               "zero": {"signal": "pod_e2e", "thresholdSeconds": 0},
               "burn": {"signal": "pod_e2e", "thresholdSeconds": 1,
                        "fastBurn": -1},
               "text": {"signal": "pod_e2e", "thresholdSeconds": "soon"},
               "list": "[1, 2]"},
    "empty": {},
    "deleted": None,
}


def _table(config_mod, cfg) -> tuple:
    specs = {name: (s.name, s.signal, s.objective, s.threshold_seconds,
                    s.fast_burn) for name, s in cfg.slos.items()}
    return cfg is config_mod.DEFAULTS, specs


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_configmaps_parse_alike(case):
    data = CONFIGS[case]
    out = []
    for side in SIDES.values():
        cm = None if data is None else side["cm"]({
            "metadata": {"name": const.SLO_CONFIGMAP,
                         "namespace": "kube-system"},
            "data": {k: v if isinstance(v, str) else json.dumps(v)
                     for k, v in data.items()}})
        out.append(_table(side["config"],
                          side["config"].parse_configmap(cm)))
    assert out[1] == out[0]
    assert _table(tconfig, tconfig.DEFAULTS)[1] == \
        _table(jconfig, jconfig.DEFAULTS)[1]
    assert tconfig.SIGNALS == jconfig.SIGNALS
    assert tconfig.DEFAULT_FAST_BURN == jconfig.DEFAULT_FAST_BURN


# -- the journey tracker -------------------------------------------------------- #

EPOCH = 1_790_000_000.0


def _stamp(epoch_s: float) -> str:
    return datetime.datetime.fromtimestamp(
        epoch_s, datetime.timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")


def _decision(recorder, n: int, name: str, uid: str, started: float,
              seconds: list[float], outcome: str | None) -> object:
    """A decision with pinned start and span seconds (its trace id is
    ``n``, on both sides)."""
    dec = recorder.Decision(f"{n:032x}", "default", name, uid)
    dec.started_at = started
    for depth, secs in enumerate(seconds):
        span = recorder.Span("filter" if depth == 0 else "allocate",
                             0 if depth == 0 else 1, 0.0)
        span.seconds = secs
        dec.spans.append(span)
    if outcome is not None:
        dec.outcome, dec.done = outcome, True
    return dec


def _tracker_story(side: dict, seed: int) -> list:
    """Drive one package's tracker through a seeded stream of journey
    events on a pinned clock; return what it shows after each step."""
    rng = np.random.default_rng(seed)
    clock = [EPOCH]
    closed: list = []
    tracker = side["tracker"](capacity=24, max_open=6,
                              on_close=lambda j: closed.append(
                                  (j.name, j.uid, j.outcome,
                                   round(j.e2e_seconds(j.closed_at), 6))),
                              now_fn=lambda: clock[0])
    names = [f"p{i}" for i in range(9)]
    uids: dict = {}
    decisions = 0
    seen = []
    for step in range(160):
        clock[0] += float(rng.choice([0.0, 0.5, 3.0, 40.0]))
        name = str(rng.choice(names))
        if rng.random() < 0.1 or name not in uids:
            uids[name] = f"u-{name}-{step}"
        uid = uids[name]
        created = _stamp(clock[0] - float(rng.integers(0, 120)))
        doc = make_pod(name, hbm=8, uid=uid)
        if rng.random() < 0.8:
            doc["metadata"]["creationTimestamp"] = created
        pod = side["pod"](doc)
        roll = rng.random()
        if roll < 0.25:
            tracker.open_journey(pod)
        elif roll < 0.6:
            decisions += 1
            outcome = str(rng.choice([None, "unschedulable", "bound"],
                                     p=[0.5, 0.3, 0.2]))
            dec = _decision(side["recorder"], decisions, name, uid,
                            clock[0], [float(rng.integers(1, 5)) / 1000,
                                       0.0005], None
                            if outcome == "None" else outcome)
            tracker.note_decision("default", name, uid, dec,
                                  pod=pod if rng.random() < 0.7 else None,
                                  open_new=bool(rng.random() < 0.8))
        elif roll < 0.72:
            tracker.pod_bound(pod)
        elif roll < 0.84:
            tracker.pod_deleted(pod)
        else:
            ann = {const.ANN_CHIP_IDX: "0", const.ANN_HBM_POD: "8",
                   const.ANN_HBM_CHIP: "79",
                   const.ANN_ASSIGNED: const.ASSIGNED_TRUE,
                   const.ANN_ASSUME_TIME: str(int(clock[0] * 1e9))}
            bound = make_pod(name, hbm=8, uid=uid, node_name="h100-0",
                             annotations=ann)
            bound["metadata"]["creationTimestamp"] = created
            tracker.reconstruct(side["pod"](bound))
        seen.append(tracker.stats())
        seen.append({n: tracker.get_journey("default", n) for n in names})
    seen += [tracker.drops.value, closed]
    return seen


@pytest.mark.parametrize("seed", range(6))
def test_trackers_tell_the_same_journeys(seed):
    got = [_tracker_story(side, seed) for side in SIDES.values()]
    assert got[1] == got[0]
    assert any(doc and doc["outcome"] == "bound"
               for step in got[0][1::2] if isinstance(step, dict)
               for doc in step.values())


# -- the engine ----------------------------------------------------------------- #

def _engine_story(side: dict, seed: int) -> list:
    rng = np.random.default_rng(seed)
    clock = [EPOCH]
    api = side["fake"]()
    cfg = side["config"].SLOConfig(slos={
        "bind-2s": side["config"].SLOSpec(
            name="bind-2s", signal="pod_e2e", objective=0.9,
            threshold_seconds=2.0, fast_burn=2.0),
        "bind-60s": side["config"].SLOSpec(
            name="bind-60s", signal="pod_e2e", objective=0.99,
            threshold_seconds=60.0),
        "filter-5ms": side["config"].SLOSpec(
            name="filter-5ms", signal="filter_latency", objective=0.5,
            threshold_seconds=0.005, fast_burn=1.5)})
    engine = side["engine"](config=cfg, now_fn=lambda: clock[0])
    engine.set_client(api)
    rows = []
    for step in range(300):
        clock[0] += float(rng.choice([0.1, 1.0, 30.0, 400.0],
                                     p=[0.5, 0.3, 0.15, 0.05]))
        if rng.random() < 0.6:
            engine.observe_pod_e2e(
                float(rng.exponential(8.0)),
                str(rng.choice(["bound", "deleted", "abandoned"])),
                "team-a", f"p{int(rng.integers(40))}", f"u{step}")
        else:
            engine.observe_filter(float(rng.exponential(0.004)))
        if step % 7 == 0:
            rows.append(engine.evaluate())
    assert side["events"].flush()
    burns = [(ns, e["reason"], e["type"], e["involvedObject"]["name"],
              e["message"].split(" [timeline ")[0])
             for ns, e in api.events]
    return [rows, burns, engine.drops.value]


@pytest.mark.parametrize("seed", range(4))
def test_engines_burn_alike(seed):
    got = [_engine_story(side, seed) for side in SIDES.values()]
    assert got[1] == got[0]
    assert any(row["burning"] for rows in got[0][0] for row in rows)
    assert got[0][1] and {b[1] for b in got[0][1]} == {"TPUShareSLOBurn"}


def test_the_module_face_and_debug_document_are_the_reference_s():
    assert sorted(tslo.__all__) == sorted(jslo.__all__)
    for mod in (jslo, tslo):
        mod.reset()
        for i in range(40):
            mod.engine().observe_pod_e2e(120.0 if i % 3 else 1.0, "bound",
                                         "ns", f"p{i}", f"u{i}")
            mod.observe_filter(0.001 * (i % 9))
    docs = [mod.snapshot() for mod in (jslo, tslo)]
    for mod in (jslo, tslo):
        mod.reset()
    assert docs[1] == docs[0]
    assert [r["burning"] for r in docs[0]["slos"]] == [True, True]
    assert tslo.engine()._lock.site == "slo/engine"
    assert tslo.tracker()._lock.site == "slo/journeys"


# -- both stacks ---------------------------------------------------------------- #

_CLOCK_KEYS = ("openedAt", "closedAt", "startedAt", "traceId")


def _no_clocks(doc):
    """A journey or /debug/slo document less its clocks and ids."""
    if isinstance(doc, dict):
        return {k: _no_clocks(v) for k, v in doc.items()
                if k not in _CLOCK_KEYS
                and not k.lower().endswith("seconds")}
    if isinstance(doc, list):
        return [_no_clocks(v) for v in doc]
    return doc


def test_debug_slo_and_journeys_over_both_stacks():
    pair = Pair()
    try:
        nodes = [f"h100-{i:02d}" for i in range(8)]
        for n in nodes:
            pair.create_node(make_node(n, **H100))
        rng = random.Random(5)
        backlog, seq, names = [], 0, []
        for rnd in range(4):
            for _ in range(ARRIVALS // 2):
                kind, size = _draw_shape(rng)
                name = f"sp-{seq:04d}"
                seq += 1
                names.append(name)
                pair.create_pod(make_pod(name, chips=size) if kind == "chip"
                                else make_pod(name, hbm=size))
                backlog.append((name, rng.randint(*TTL_ROUNDS)))
            kept = []
            for name, ttl in backlog:
                if not pair.schedule(name, nodes)[0]:
                    kept.append((name, ttl))
            backlog = kept
            pair.idle()
        assert backlog, "no pod left pending"
        for name, _ in backlog[::2]:
            pair.delete_pod(name)
        pair.idle()
        docs = [json.loads(side.get("/debug/slo")[1])
                for side in pair.sides]
        assert docs[1]["journeys"]["closed"] == docs[0]["journeys"]["closed"]
        assert docs[1]["journeys"]["open"] == docs[0]["journeys"]["open"]
        assert docs[1]["journeys"]["meanAttempts"] == \
            docs[0]["journeys"]["meanAttempts"]
        assert docs[1]["recordingDrops"] == docs[0]["recordingDrops"] == {
            "journeys": 0, "engine": 0}
        rows = [{r["slo"]: r for r in doc["slos"]} for doc in docs]
        assert rows[1]["pod-bind-30s"] == rows[0]["pod-bind-30s"]
        # The filter-latency objective: as many filter calls in each
        # window on both; which ones took over 5 ms is each side's clock.
        assert {w: v["total"] for w, v in
                rows[1]["filter-p99-5ms"]["windows"].items()} == \
            {w: v["total"] for w, v in
             rows[0]["filter-p99-5ms"]["windows"].items()}
        assert {k: v for k, v in rows[1]["filter-p99-5ms"].items()
                if k not in ("windows", "errorBudgetRemaining",
                             "burning")} == \
            {k: v for k, v in rows[0]["filter-p99-5ms"].items()
             if k not in ("windows", "errorBudgetRemaining", "burning")}
        assert docs[0]["journeys"]["closed"].get("bound", 0) > 10
        assert docs[0]["journeys"]["closed"].get("deleted", 0) > 0
        for name in names:
            got = [side.get(f"/debug/journey/default/{name}")
                   for side in pair.sides]
            assert got[1][0] == got[0][0] == 200, name
            j = [json.loads(body) for _, body in got]
            assert _no_clocks(j[1]) == _no_clocks(j[0]), name
            assert len(j[1]["attempts"]) == len(j[0]["attempts"])
            for side, doc in zip(pair.sides, j):
                for attempt in doc["attempts"]:
                    status, chain = side.get(
                        f"/debug/trace?id={attempt['traceId']}")
                    assert status == 200, (name, attempt)
    finally:
        pair.close()
