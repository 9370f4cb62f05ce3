"""The port's ``/metrics`` (``tpushare_torch/routes/metrics.py`` over
``tpushare_torch/routes/exposition.py``) against the JAX package's.

* The exposition against ``prometheus_client``'s ``generate_latest`` on
  seeded families: counters with and without labels (``_total``, the
  ``_created`` family), gauges, histograms with and without labels,
  label values and HELP texts that need escaping, empty labelled
  families. Equal line for line once each ``_created`` timestamp (a
  clock) is masked.
* The families the port declares against the reference's: the same
  names, HELP, TYPE, labels and buckets, in the reference's order; the
  reference's families the port leaves out are exactly ``UNPORTED``, each
  with the ROADMAP item that brings its source (none is left out since
  the autoscaler and the router came).
* ``/metrics`` of both ``serve_stack``s (``tests/test_torch_extender_e2e``
  's ``Pair``) before and after the seeded churns over 16 H100 nodes
  (with a gang) and under a quota ConfigMap, a preemption and an
  admission refusal: the same families less ``UNPORTED``, and for each
  the same HELP, TYPE and label sets; every gauge's value and every
  counter's and histogram ``_count``'s rise equal. Clocks are not
  compared: ``_created``, the histograms' ``_sum`` and buckets, the
  process's own gauges (resident set, descriptors, threads, GC, uptime),
  the timeline's (series, drops, anomaly firings), the per-verb cost
  ledger's seconds and each demand shape's oldest wait
  (``tpushare_unschedulable_demand_oldest_age_seconds``, read on each
  side's clock), whose label sets still are; the ledger's decision
  counts per verb are (both ledgers start empty with the pair). The
  autoscaler's fleet-size gauges and counters are held as the others are.
  The OpenMetrics exemplars on the verbs' buckets: the same
  families carry them on both sides, each names a decision of its own
  side, and its latency lies in its bucket. The pod-journey and
  fragmentation families (the journeys' histograms, the SLO gauges, the
  stranded GiB and each node's score, the defrag counters) are held as
  the others are, but the filter-latency objective's gauges, whose
  events are each side's clock, by label set.
* ``/metrics`` of two ``serve_stack``s that each hold a router (the
  port's and the reference's ``Router`` on one virtual clock, fed the same
  seeded stream of three tenants, one of them past its standing): every
  ``tpushare_router_*`` series equal, value for value, besides the rest
  held as above.
* The demand tracker's views that ``/metrics`` reads (``snapshot``,
  ``by_tenant``, ``shapes``, ``oldest_age_by_shape``) on seeded streams
  of unplaceable pods and clears, against the reference's.
* A scrape that raises answers 500 and counts
  ``tpushare_scrape_errors_total`` on both; ``safe_inc`` /
  ``safe_observe`` never raise; the watchdog renders through the same
  module.
"""

from __future__ import annotations

import json
import re

import numpy as np
import prometheus_client as prom
import pytest

from tests.test_torch_extender_e2e import (H100, TIMED_RULES, Pair,
                                           test_seeded_churn_on_h100_nodes,
                                           test_seeded_churn_under_a_quota_configmap)
from tests.torch_obs_reset import fresh_port_obs  # noqa: F401
from tpushare.api.objects import Pod as JPod
from tpushare.k8s.builders import make_node, make_pod
from tpushare import profiling as jprofiling
from tpushare.routes import metrics as jmetrics
from tpushare.scheduler.predicate import DemandTracker as JTracker
from tpushare_torch import profiling as tprofiling
from tpushare_torch.deviceplugin import watchdog
from tpushare_torch.routes import exposition as X
from tpushare_torch.api.objects import Pod as TPod
from tpushare_torch.routes import metrics as tmetrics
from tpushare_torch.scheduler.predicate import DemandTracker as TTracker
from tpushare_torch.utils import const

#: The reference's families whose sources the port has not yet, by the
#: ROADMAP §A item that brings each: none since A3 (the autoscaler's and
#: the router's, A5 merged into A3) was ported.
UNPORTED: dict[str, tuple[str, ...]] = {}
UNPORTED_NAMES = {n for names in UNPORTED.values() for n in names}

#: The SLO gauges of an objective over the filter verb's latency: its
#: good and bad events are each side's clock, so their label sets are
#: compared, not their values (the pod-journey objectives' values are).
CLOCKED_SLOS = ("filter-p99-5ms",)

#: Samples of the process itself, of each package's timeline, whose
#: sampler ticks on its own clock, and of each ledger's clocks: label sets
#: compared, values not.
PROCESS = ("tpushare_process_rss_bytes", "tpushare_process_open_fds",
           "tpushare_process_threads", "tpushare_gc_tracked_objects",
           "tpushare_gc_collections_total", "tpushare_uptime_seconds",
           "tpushare_timeline_series", "tpushare_timeline_dropped_total",
           "tpushare_anomaly_fired_total",
           # each demand shape's oldest wait, on each side's clock
           "tpushare_unschedulable_demand_oldest_age_seconds",
           # the per-verb cost ledger's clocks (its decision counts,
           # tpushare_verb_decisions_total, are compared by value)
           "tpushare_verb_wall_seconds_total",
           "tpushare_verb_cpu_seconds_total",
           "tpushare_verb_lock_wait_seconds_total",
           "tpushare_verb_apiserver_seconds_total",
           "tpushare_verb_queue_wait_seconds_total")

_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? (\S+)'
                     r'( # \{.*)?$')
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse(text: str) -> dict:
    """Text format 0.0.4 into ``{family: {"help", "type", "samples":
    {(sample name, labels): value}}}``; a sample's exemplar (the JAX
    side's ``# {trace_id=...}``) is dropped."""
    fams: dict = {}
    current = None
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# HELP "):
            name, _, doc = line[7:].partition(" ")
            current = fams.setdefault(name, {"samples": {}})
            current["help"] = doc
        elif line.startswith("# TYPE "):
            name, _, kind = line[7:].partition(" ")
            assert name in fams, line
            fams[name]["type"] = kind
        else:
            m = _SAMPLE.match(line)
            assert m and current is not None, line
            labels = tuple(sorted(_LABEL.findall(m.group(3) or "")))
            current["samples"][(m.group(1), labels)] = float(m.group(4))
    return fams


def _mask_created(text: str) -> str:
    return re.sub(r"^(\S+_created(\{[^}]*\})?) \S+$", r"\1 <t>", text,
                  flags=re.M)


def _base(family: str) -> str:
    return family[:-len("_created")] if family.endswith("_created") \
        else family


def _unported(family: str) -> bool:
    """``family``, or the counter or histogram whose ``_created``
    companion it is, is one of ``UNPORTED``."""
    return (_base(family) in UNPORTED_NAMES
            or _base(family) + "_total" in UNPORTED_NAMES)


# -- the exposition against prometheus_client --------------------------------- #

def _families(lib, registry, seed: int):
    rng = np.random.default_rng(seed)
    plain = lib.Counter("tpushare_plain_total", "A \\ plain\ncounter",
                        registry=registry)
    tenants = lib.Counter("tpushare_by_tenant_total", "Per tenant",
                          ["tenant"], registry=registry)
    never = lib.Counter("tpushare_never_total", "Never labelled",
                        ["tenant"], registry=registry)
    gauge = lib.Gauge("tpushare_level", "A gauge", registry=registry)
    nodes = lib.Gauge("tpushare_node_level", "Per node", ["node", "kind"],
                      registry=registry)
    empty = lib.Gauge("tpushare_empty", "Nothing set", ["node"],
                      registry=registry)
    hist = lib.Histogram("tpushare_latency_seconds", "Latency",
                         registry=registry, buckets=tmetrics._BUCKETS)
    sized = lib.Histogram("tpushare_size", "Sizes", ["verb"],
                          registry=registry,
                          buckets=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32))
    del never, empty
    for _ in range(int(rng.integers(5, 40))):
        roll = rng.random()
        if roll < 0.2:
            plain.inc(float(rng.integers(0, 3)))
        elif roll < 0.4:
            tenants.labels(tenant=f't"{int(rng.integers(3))}\\x').inc()
        elif roll < 0.55:
            gauge.set(float(rng.choice([0.0, 1e-5, 12345678.0, 3.25, -2.0,
                                        1e21])))
        elif roll < 0.7:
            nodes.labels(node=f"n{int(rng.integers(3))}",
                         kind="a\nb").set(float(rng.integers(0, 1 << 34)))
        elif roll < 0.85:
            hist.observe(float(rng.exponential(0.01)))
        else:
            sized.labels(verb=str(rng.choice(["filter", "prioritize"]))
                         ).observe(float(rng.integers(1, 40)))
    if seed % 2:
        nodes.clear()


@pytest.mark.parametrize("seed", range(8))
def test_exposition_matches_generate_latest(seed):
    want = prom.CollectorRegistry()
    _families(prom, want, seed)
    got = X.Registry()
    _families(X, got, seed)
    assert _mask_created(got.render().decode()) == _mask_created(
        prom.generate_latest(want).decode())


def test_exposition_refuses_what_prometheus_client_refuses():
    reg = X.Registry()
    c = X.Counter("tpushare_c_total", "c", ["tenant"], registry=reg)
    with pytest.raises(ValueError):
        c.labels(tenant="a").inc(-1)
    with pytest.raises(ValueError):
        c.labels(node="a")
    with pytest.raises(ValueError):
        X.Counter("tpushare_c", "again", registry=reg)
    g = X.Gauge("tpushare_g", "g", registry=reg)
    with pytest.raises(ValueError):
        g.labels("x")
    h = X.Histogram("tpushare_h", "h", registry=reg, buckets=(1.0,))
    with h.time():
        pass
    assert "tpushare_h_count 1.0\n" in h.render()


def test_watchdog_renders_through_the_exposition():
    assert watchdog.GaugeFamily is X.GaugeFamily


def test_safe_inc_and_observe_never_raise():
    class Broken:
        def inc(self, n=1):
            raise RuntimeError("broken")

        observe = inc
    tmetrics.safe_inc(Broken())
    tmetrics.safe_observe(Broken(), 1.0)
    tmetrics.safe_inc(tmetrics.FILTER_REQUESTS, -1)  # refused, swallowed


# -- the declared families against the reference's ------------------------------ #

def _declared(text: str) -> list[tuple]:
    fams = parse(text)
    out = []
    for name, fam in fams.items():
        les = sorted({dict(labels).get("le") for (_, labels) in fam["samples"]
                      if dict(labels).get("le")}, key=lambda v: float(v))
        out.append((name, fam["help"], fam["type"], les))
    return out


def test_declared_families_are_the_reference_s():
    """Before any traffic: the port declares the reference's families,
    HELP, TYPE and histogram buckets, in its order, less ``UNPORTED``."""
    reference = _declared(prom.generate_latest(jmetrics.REGISTRY).decode())
    want = [f for f in reference if not _unported(f[0])]
    got = _declared(tmetrics.REGISTRY.render().decode())
    # A labelled family's _created companion appears once a child does.
    assert [f for f in got if not f[0].endswith("_created")] == \
        [f for f in want if not f[0].endswith("_created")]
    assert UNPORTED_NAMES <= {_base(f[0]) for f in reference}
    for name in UNPORTED_NAMES:
        assert not any(_unported(f[0]) for f in got), name


def test_label_names_are_the_reference_s():
    """Each labelled family takes the reference's label names."""
    want = {m._name: tuple(m._labelnames)
            for m in jmetrics.REGISTRY._collector_to_names}
    got = {f.name if f.kind != "counter" else f.base: f.labelnames
           for f in tmetrics.REGISTRY.families()}
    for name, labels in got.items():
        assert want[name] == labels, name


def _demand_views(tracker_cls, pod_cls, seed: int) -> list:
    rng = np.random.default_rng(seed)
    tracker = tracker_cls()
    views = []
    for step in range(60):
        uid = f"u{int(rng.integers(12))}"
        if rng.random() < 0.7:
            ns = str(rng.choice(["team-a", "team-b", "default"]))
            labels = ({const.LABEL_TENANT: "team-c"} if rng.random() < 0.2
                      else None)
            doc = (make_pod(uid, chips=int(rng.integers(1, 5)),
                            namespace=ns, uid=uid, labels=labels)
                   if rng.random() < 0.3 else
                   make_pod(uid, hbm=int(rng.choice([8, 16, 24, 44])),
                            namespace=ns, uid=uid, labels=labels))
            tracker.record_unplaceable(pod_cls(doc))
        else:
            tracker.clear(uid)
        ages = tracker.oldest_age_by_shape()
        assert all(a >= 0 for a in ages.values())
        views.append((tracker.snapshot(), tracker.by_tenant(),
                      tracker.shapes(), sorted(ages)))
    return views


@pytest.mark.parametrize("seed", range(4))
def test_demand_views_are_the_reference_s(seed):
    assert _demand_views(TTracker, TPod, seed) == _demand_views(
        JTracker, JPod, seed)


# -- both stacks over HTTP ----------------------------------------------------- #

def _scrape(side) -> dict:
    status, body = side.get("/metrics")
    assert status == 200, body
    return parse(body.decode())


def _kind(sample: str, fam: dict) -> str:
    if fam["type"] == "histogram":
        return "count" if sample.endswith("_count") else "clock"
    return fam["type"]


def compare(before: list[dict], after: list[dict]) -> dict:
    """Both sides' scrapes, held alike (see the module's docstring);
    returns the port's families that were compared."""
    jax, port = after
    families = {n for n in jax if not _unported(n)}
    # A labelled counter's _created family appears with its first child,
    # which an earlier test in this process may have made on the
    # reference's side alone (the counters' rises below stay compared).
    missing = {n for n in families - set(port) if n.endswith("_created")}
    assert set(port) == families - missing, (set(port) ^ families)
    for name in families - missing:
        j, t = jax[name], port[name]
        assert (t["help"], t["type"]) == (j["help"], j["type"]), name
        if name.endswith("_created"):
            # Every child the port made, the reference made (the
            # reference's process may hold children of earlier tests).
            assert set(t["samples"]) <= set(j["samples"]), name
            continue
        if name in PROCESS:
            want, got = ({k for k in side["samples"]
                          if dict(k[1]).get("rule") not in TIMED_RULES}
                         for side in (j, t))
            assert got == want, name
            continue
        for key in set(j["samples"]) | set(t["samples"]):
            kind = _kind(key[0], j)
            if dict(key[1]).get("slo") in CLOCKED_SLOS:
                kind = "clock"
            if kind == "clock":
                assert key in t["samples"] and key in j["samples"], key
                continue
            if kind in ("counter", "count"):
                rise = [a[name]["samples"].get(key, 0.0)
                        - b.get(name, {"samples": {}})["samples"].get(
                            key, 0.0)
                        for a, b in zip(after, before)]
                assert rise[1] == rise[0], (key, rise)
            else:
                assert t["samples"].get(key) == j["samples"].get(key), (
                    key, j["samples"].get(key), t["samples"].get(key))
    return port


def _value(fams: dict, name: str, **labels) -> float:
    key = (name, tuple(sorted(labels.items())))
    for fam in fams.values():
        if key in fam["samples"]:
            return fam["samples"][key]
    raise KeyError(key)


@pytest.fixture
def pair():
    # Each package's cost ledger is a process singleton fed by every
    # decision since its import: start both empty, so the verb counts
    # are this pair's alone.
    jprofiling.reset()
    tprofiling.reset()
    p = Pair()
    yield p
    p.close()
    jprofiling.reset()


def test_metrics_after_the_h100_churn(pair):
    before = [_scrape(side) for side in pair.sides]
    test_seeded_churn_on_h100_nodes(pair)
    after = [_scrape(side) for side in pair.sides]
    port = compare(before, after)
    filters = _value(port, "tpushare_filter_requests_total") - _value(
        before[1], "tpushare_filter_requests_total")
    assert filters > 100
    assert _value(port, "tpushare_filter_latency_seconds_count") - _value(
        before[1], "tpushare_filter_latency_seconds_count") == filters
    # The ledger's used GiB, node by node.
    live = pair.port.stack.controller.cache
    for info in live.get_node_infos():
        used = sum(c.get_used_hbm() for c in info.chips.values())
        assert _value(port, "tpushare_node_hbm_used_gib",
                      node=info.name) == used
    assert _value(port, "tpushare_leader") == 1.0
    assert _value(port, "tpushare_unschedulable_pods") > 0


def test_metrics_under_quota_preemption_and_admission(pair):
    before = [_scrape(side) for side in pair.sides]
    test_seeded_churn_under_a_quota_configmap(pair)
    # A preemption the quota ledger answers, and an admission refusal.
    pod = pair.create_pod(make_pod("big", hbm=70, namespace="team-b",
                                   annotations={}))
    names = [n.name for n in pair.jax.api.list_nodes()]
    outs = [side.post("/preempt", {
        "Pod": side.api.get_pod("team-b", "big").raw,
        "NodeNameToMetaVictims": {n: {"Pods": []} for n in names}})
        for side in pair.sides]
    assert outs[1] == outs[0] and outs[0][0] == 200
    pair.same_decision("team-b", pod["metadata"]["name"])
    review = {"request": {"uid": "r1", "operation": "CREATE",
                          "object": make_pod("huge", hbm=10 ** 4)}}
    outs = [side.post("/validate", review) for side in pair.sides]
    assert outs[1] == outs[0]
    assert json.loads(outs[0][1])["response"]["allowed"] is False
    after = [_scrape(side) for side in pair.sides]
    port = compare(before, after)
    assert _value(port, "tpushare_admission_rejected_total") - _value(
        before[1], "tpushare_admission_rejected_total") == 1
    denied = [v for (s, _), v in
              port["tpushare_quota_denied_total"]["samples"].items()]
    assert denied and sum(denied) > 0
    quota = json.loads(pair.port.get("/debug/quota")[1])["tenants"]
    for row in quota:
        assert _value(port, "tpushare_quota_used_hbm_gib",
                      tenant=row["tenant"]) == row["usedHBM"]
        if "limitHBM" in row:
            assert _value(port, "tpushare_quota_limit_hbm_gib",
                          tenant=row["tenant"]) == row["limitHBM"]


def test_a_scrape_that_raises_is_a_counted_500(pair, monkeypatch):
    pair.create_node(make_node("h100-0", **H100))

    def broken(cache):
        raise RuntimeError("ledger unreadable")

    def errors(mod):
        return (jmetrics.REGISTRY.get_sample_value(
            "tpushare_scrape_errors_total") if mod is jmetrics
            else tmetrics.SCRAPE_ERRORS.get())
    statuses = []
    for side, mod in zip(pair.sides, (jmetrics, tmetrics)):
        before = errors(mod)
        monkeypatch.setattr(mod, "observe_cache", broken)
        status, body = side.get("/metrics")
        statuses.append((status, json.loads(body)))
        assert errors(mod) == before + 1
        monkeypatch.undo()
    assert statuses[1] == statuses[0]
    assert statuses[0] == (500, {"Error": "ledger unreadable"})
    for side in pair.sides:
        assert side.get("/metrics")[0] == 200


def test_metrics_of_two_routers_on_one_stream():
    """Both ``serve_stack``s, each holding a router on one virtual clock,
    fed the same seeded stream: every ``tpushare_router_*`` series and the
    rest of ``/metrics`` held as ``compare`` holds them."""
    from tests.test_torch_router import (TENANTS, Clock, make_replicas,
                                         router_pair)
    from tpushare.router import DecodeReplica as JReplica
    from tpushare_torch.router import DecodeReplica as TReplica

    jprofiling.reset()
    tprofiling.reset()
    clock = Clock()
    pair = router_pair(clock)
    try:
        for side, cls in ((pair.jax, JReplica), (pair.port, TReplica)):
            for rep in make_replicas(np.random.default_rng(7), cls):
                side.router.add_replica(rep)
        before = [_scrape(side) for side in pair.sides]
        rngs = [np.random.default_rng(3) for _ in pair.sides]
        for step in range(80):
            clock.now = round(clock.now + 0.05, 6)
            for side, rng in zip(pair.sides, rngs):
                for name, rate, _ in TENANTS:
                    for _ in range(int(rng.poisson(rate * 0.05))):
                        kw = ({"prefix_key": "sys", "prefix_len": 256}
                              if rng.random() < 0.3 else {})
                        side.router.submit(
                            name, int(rng.choice([20, 100, 300, 700])),
                            int(rng.integers(4, 200)), **kw)
                side.router.tick()
        after = [_scrape(side) for side in pair.sides]
        port = compare(before, after)
        router = {n for n in port if n.startswith("tpushare_router_")}
        assert len({n for n in router if not n.endswith("_created")}) == 14
        for name in ("tpushare_router_fleet_slots",
                     "tpushare_router_pages_total",
                     "tpushare_router_replicas"):
            assert _value(port, name) > 0, name
        shed = port["tpushare_router_shed_total"]["samples"]
        assert {dict(k[1])["tenant"] for k in shed} == {
            name for name, _, _ in TENANTS}
        assert _value(port, "tpushare_router_requests_total",
                      tenant="burst") > 0
        assert _value(port, "tpushare_router_ttft_seconds",
                      quantile="p99") > 0
    finally:
        pair.close()
        jprofiling.reset()
