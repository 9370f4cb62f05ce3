"""The port's fleet timeline (``tpushare_torch/obs/``: the timeline, the
anomaly engine, the exemplar store, and where the extender feeds them)
against the JAX package's.

* The reference's stories of ``tests/test_timeline.py`` over the port's
  modules (``tests/torch_reference_stories.py``): the tier rollover under
  an injected clock, every hard bound counting its drops, the
  fire-and-forget contract at the leader's and the controller's quota
  ConfigMap sites, ``/debug/timeline`` over the port's stack with its
  query filters and the ``TPUSHARE_TIMELINE=off`` kill switch, and the
  timeline's families in the scrape, the SLO config site, and the
  acceptance story: a burning pod-journey SLO's Event names a timeline
  cursor that resolves to its ``slo-burn`` marker and on to a decision,
  and the serving router's scale-out site (``TestFireAndForget.
  test_router_scaleout_site``, over the port's ``Router``).
* Both ``TimelineRecorder``s fed the same seeded streams of samples,
  markers, verb latencies and ticks on injected clocks: equal snapshots,
  drops and last values.
* Both ``AnomalyEngine``s over the same seeded series: the same rules
  fire at the same ticks, with the same markers and the same
  ``TPUShareAnomaly`` Events.
* Both ``ExemplarStore``s fed the same observations annotate the same
  histograms, each rendered by its own package, to the same bytes.
* ``/metrics`` of both stacks after the same traffic: the same verb
  families carry exemplars, each names a decision of its own side, and
  its latency lies in its bucket.
"""

from __future__ import annotations

import importlib
import json
import re

import numpy as np
import prometheus_client as prom
import pytest

from tests import torch_reference_stories as R
from tests.test_torch_extender_e2e import H100, Pair
from tests.torch_obs_reset import fresh_port_obs  # noqa: F401
from tpushare.k8s import events as jevents
from tpushare.k8s.builders import make_node, make_pod
from tpushare.k8s.fake import FakeApiServer as JFake
from tpushare.obs import anomaly as janomaly
from tpushare.routes import metrics as jmetrics
from tpushare_torch.k8s import events as tevents
from tpushare_torch.k8s.fake import FakeApiServer as TFake
from tpushare_torch.obs import anomaly as tanomaly
from tpushare_torch.routes import exposition as X
from tpushare_torch.routes import metrics as tmetrics

# The packages' ``timeline()`` and ``exemplars()`` functions shadow their
# submodules' names.
jtimeline = importlib.import_module("tpushare.obs.timeline")
ttimeline = importlib.import_module("tpushare_torch.obs.timeline")
jexemplars = importlib.import_module("tpushare.obs.exemplars")
texemplars = importlib.import_module("tpushare_torch.obs.exemplars")

# -- the reference's stories over the port ------------------------------------ #

R.load("test_quota")  # the stories' ``cluster`` fixture builds its Cluster
R.load("test_slo")  # the burn story's aged pod
R.load("test_router")  # the scale-out site's router
_STORIES = R.load("test_timeline")
fresh_retrospective = _STORIES.fresh_retrospective
cluster = _STORIES.cluster
globals().update(R.pick(
    _STORIES,
    ["TestTierRollover", "TestBounds", "TestFireAndForget",
     "TestDebugTimelineOverStack", "TestAcceptanceRetrospective"]))


@pytest.fixture
def api():
    """The reference's stories run over the port's fake apiserver."""
    return TFake()


# -- both recorders on the same streams --------------------------------------- #

SOURCES = ("workqueue_depth", "demand_hbm_gib", "fleet_nodes")
VERBS = ("filter", "prioritize", "bind", "preempt")


def _recorder_stream(mod, seed: int) -> list:
    """Drive one package's TimelineRecorder through a seeded stream and
    return what it shows after each phase of it."""
    rng = np.random.default_rng(seed)
    clock = [1000.0 * mod.TIER1_BUCKET_S + float(rng.integers(0, 30))]
    rec = mod.TimelineRecorder(now_fn=lambda: clock[0])
    fed: dict = {}
    rec.add_source("seeded", lambda: dict(fed))
    ticks: list = []
    rec.add_tick_hook(ticks.append)
    seen = []
    # Past MAX_SERIES names, so the coldest series are evicted.
    names = [f"s{i:03d}" for i in range(mod.MAX_SERIES + 12)]
    kinds = sorted(mod.MARKER_KINDS) + ["not-a-kind"]
    for step in range(600):
        roll = rng.random()
        if roll < 0.35:
            rec.record(str(rng.choice(names)), float(rng.normal(10, 3)))
        elif roll < 0.5:
            kind = str(rng.choice(kinds))
            attrs = {"k": str(int(rng.integers(5)))}
            if kind == "not-a-kind":
                with pytest.raises(ValueError):
                    rec.mark(kind, "x", attrs)
            else:
                seen.append(rec.mark(kind, f"m{step}", attrs))
        elif roll < 0.75:
            rec.note_verb(str(rng.choice(VERBS)),
                          float(rng.exponential(0.004)))
        elif roll < 0.85:
            for name in SOURCES:
                fed[name] = float(rng.integers(0, 100))
            rec.tick()
        else:
            clock[0] += float(rng.choice([0.01, 0.5, 2.0, 31.0]))
        if step % 97 == 0:
            window = float(rng.choice([5.0, 45.0, 600.0]))
            seen.append(rec.snapshot(window_s=window))
            seen.append(rec.snapshot(series=["verb_", "s00"],
                                     markers=False))
    seen += [rec.snapshot(), rec.last_values(), rec.series_count(),
             rec.drops.value, rec.mark_drops.value, ticks,
             [rec.get_marker(c) for c in range(0, 600, 7)]]
    return seen


@pytest.mark.parametrize("seed", range(4))
def test_recorders_on_the_same_stream(seed):
    assert _recorder_stream(ttimeline, seed) == \
        _recorder_stream(jtimeline, seed)


def test_marker_taxonomy_and_bounds_are_the_reference_s():
    for name in ("SAMPLE_INTERVAL_S", "TIER0_POINTS", "TIER1_BUCKET_S",
                 "TIER1_POINTS", "MAX_SERIES", "MAX_MARKERS",
                 "VERB_BUFFER", "MARKER_KINDS"):
        assert getattr(ttimeline, name) == getattr(jtimeline, name), name


# -- both anomaly engines ------------------------------------------------------ #

def _rules(mod) -> tuple:
    return mod.DEFAULT_RULES + (
        mod.Rule("queue-high", "workqueue_depth", "threshold", 50.0,
                 cooldown_s=30.0),
        mod.Rule("queue-rising", "workqueue_depth", "roc", 20.0,
                 window_s=40.0, min_points=5, cooldown_s=0.0))


def _anomaly_stream(tl, an, fake, events, seed: int) -> list:
    rng = np.random.default_rng(seed)
    clock = [5000.0]
    rec = tl.TimelineRecorder(now_fn=lambda: clock[0])
    engine = an.AnomalyEngine(rec, rules=_rules(an),
                              now_fn=lambda: clock[0])
    api = fake()
    engine.set_client(api)
    out = []
    for tick in range(150):
        clock[0] += 2.0
        # Calm series with seeded spikes, a demand ramp and a stranded
        # level that crosses its threshold.
        spike = rng.random() < 0.08
        rec.record("verb_p99_ms:filter",
                   float(rng.normal(3.0, 0.2) + (40.0 if spike else 0.0)))
        rec.record("verb_p99_ms:bind", float(rng.normal(6.0, 0.5)))
        rec.record("demand_unschedulable_pods",
                   float(tick // 3 if tick > 60 else 0))
        rec.record("cluster_stranded_hbm_gib", float(40 + tick // 2))
        rec.record("workqueue_depth", float(rng.integers(0, 80)))
        out.append((tick, engine.evaluate()))
    assert events.flush()
    out.append(engine.fired_counts())
    out.append([(e["reason"], e["type"], e["message"],
                 e["involvedObject"]["name"]) for _, e in api.events])
    out.append([(m["cursor"], m["kind"], m["detail"], m["attrs"])
                for m in rec.snapshot()["markers"]])
    return out


@pytest.mark.parametrize("seed", range(3))
def test_anomaly_engines_fire_alike(seed):
    got = _anomaly_stream(ttimeline, tanomaly, TFake, tevents, seed)
    want = _anomaly_stream(jtimeline, janomaly, JFake, jevents, seed)
    assert got == want
    assert got[-3], "no rule fired"
    assert any(reason == "TPUShareAnomaly" for reason, *_ in got[-2])


# -- both exemplar stores ------------------------------------------------------ #

def _histograms(lib, registry, observations) -> None:
    hists = {verb: lib.Histogram(f"tpushare_{verb}_latency_seconds",
                                 f"Latency of extender {verb} requests",
                                 registry=registry,
                                 buckets=tmetrics.LATENCY_BUCKETS)
             for verb in VERBS}
    for verb, seconds, _tid in observations:
        hists[verb].observe(seconds)


def _mask_created(text: bytes) -> bytes:
    return re.sub(rb"^(\S+_created(\{[^}]*\})?) \S+$", rb"\1 <t>", text,
                  flags=re.M)


@pytest.mark.parametrize("seed", range(4))
def test_exemplar_stores_annotate_alike(seed):
    rng = np.random.default_rng(seed)
    clock = [1.7e9]
    stores = [mod.ExemplarStore(now_fn=lambda: clock[0])
              for mod in (jexemplars, texemplars)]
    observations = []
    for i in range(int(rng.integers(20, 120))):
        clock[0] += float(rng.exponential(0.3))
        seconds = float(rng.choice([rng.exponential(0.002),
                                    rng.exponential(0.2), 3.0, 0.0001,
                                    0.25]))
        tid = ("" if rng.random() < 0.1
               else f"{int(rng.integers(1 << 60)):032x}")
        verb = str(rng.choice(VERBS))
        observations.append((verb, seconds, tid))
        for store in stores:
            store.record(verb, seconds, tid)
    want_reg = prom.CollectorRegistry()
    _histograms(prom, want_reg, observations)
    got_reg = X.Registry()
    _histograms(X, got_reg, observations)
    want = stores[0].annotate(prom.generate_latest(want_reg))
    got = stores[1].annotate(got_reg.render())
    assert _mask_created(got) == _mask_created(want)
    assert b' # {trace_id="' in got
    assert stores[1].snapshot() == stores[0].snapshot()


def test_latency_buckets_are_the_reference_s():
    assert tmetrics.LATENCY_BUCKETS == jmetrics.LATENCY_BUCKETS


# -- /metrics exemplars on both stacks ---------------------------------------- #

_EXEMPLAR = re.compile(
    r'^tpushare_(\w+)_latency_seconds_bucket\{le="([^"]+)"\} \S+'
    r' # \{trace_id="([0-9a-f]+)"\} ([0-9.]+) ([0-9.]+)$')


#: The exemplar's latency is printed to 6 decimals (``{seconds:.6f}``).
PRINTED_DECIMALS = 6


def _in_bucket(printed: float, le: str) -> bool:
    """Whether an exemplar's latency, as printed, lies in the bucket
    ``le`` names. The true latency lies in (lower, upper]; printed to 6
    decimals it may round onto ``lower`` (0.0010000004 prints 0.001000),
    so at the printed precision the bucket is [lower, upper]."""
    bounds = [0.0] + [float(b) for b in tmetrics.LATENCY_BUCKETS]
    upper = float("inf") if le == "+Inf" else float(le)
    lower = max(b for b in bounds if b < upper)
    return (round(lower, PRINTED_DECIMALS) <= printed
            <= round(upper, PRINTED_DECIMALS))


def _exemplars(side) -> dict:
    status, body = side.get("/metrics")
    assert status == 200
    out: dict = {}
    for line in body.decode().splitlines():
        if "# {" not in line:
            continue
        m = _EXEMPLAR.match(line)
        assert m, line
        verb, le, tid, seconds = m.group(1), m.group(2), m.group(3), \
            float(m.group(4))
        # Its latency lies in its bucket.
        assert _in_bucket(seconds, le), line
        # It names a decision of its own side.
        status, chain = side.get(f"/debug/trace?id={tid}")
        assert status == 200, (verb, tid)
        assert json.loads(chain)["target"]["traceId"] == tid
        out.setdefault(verb, []).append(le)
    return out


def _exemplar_line(seconds: float) -> tuple[str, float]:
    """A filter bucket line annotated by the port's exemplar store with
    one observation of ``seconds``: its ``le`` and its printed latency."""
    store = texemplars.ExemplarStore()
    store.record("filter", seconds, "ab" * 16)
    text = store.annotate(tmetrics.FILTER_LATENCY.render().encode())
    (line,) = [ln for ln in text.decode().splitlines() if "# {" in ln]
    m = _EXEMPLAR.match(line)
    assert m, line
    return m.group(2), float(m.group(4))


@pytest.mark.parametrize("seconds", [0.0010000004, 0.0012, 0.0025,
                                     0.00000001])
def test_an_exemplar_printed_onto_its_bucket_s_lower_bound_lies_in_it(
        seconds):
    le, printed = _exemplar_line(seconds)
    assert _in_bucket(printed, le)
    if seconds == 0.0010000004:
        # The strict comparison this check replaced refuses it.
        bounds = [0.0] + [float(b) for b in tmetrics.LATENCY_BUCKETS]
        upper = float(le)
        lower = max(b for b in bounds if b < upper)
        assert (le, printed) == ("0.0025", 0.001)
        assert not (lower < printed <= upper
                    or (lower == 0.0 and printed == 0))


def test_metrics_exemplars_name_decisions_on_both_stacks():
    pair = Pair()
    try:
        for i in range(4):
            pair.create_node(make_node(f"h100-{i}", **H100))
        for side in pair.sides:
            side.idle()
        for i, gib in enumerate((16, 24, 44, 8, 79, 30)):
            pair.create_pod(make_pod(f"p-{i}", hbm=gib))
            bound, _ = pair.schedule(f"p-{i}")
            assert bound
        found = [_exemplars(side) for side in pair.sides]
        assert set(found[1]) == set(found[0]) == {"filter", "prioritize",
                                                  "bind"}
    finally:
        pair.close()
