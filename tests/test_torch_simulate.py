"""The port's capacity planner (``tools/simulate_torch.py``) against the
reference's (``tools/simulate.py``).

* The reference's simulator stories over the twin
  (``tests/torch_reference_stories.py`` points their ``import simulate``
  and ``from tools import simulate as sim`` at it): ``TestSimulator``,
  ``TestSimulateDefragScenario``, ``TestSimulateServing``,
  ``TestDefragAdvisor`` and ``TestDrainAdvisor`` of ``tests/test_tools.py``
  (the ring-price assert of the topology example among them, on the
  reference's TPU ring model), ``TestSimulateTenants`` of
  ``tests/test_quota.py`` and
  ``TestToolingSurfaces::test_simulate_report_carries_slo_section`` of
  ``tests/test_slo.py``.
* Each ``EXAMPLE*`` scenario through both tools' CLI (``--json --seed
  1234``; the topology example with its placer-off replay): the same
  report document. Left out, because they read the wall clock or a
  random id, and nothing else:

  - ``p50_schedule_ms`` (the replay's verb latencies);
  - ``slo.journeys.p50E2eSeconds`` / ``p99E2eSeconds`` (journey times);
  - of each ``filter_latency`` objective in ``slo.slos``, its windows'
    ``bad`` and ``burnRate``, ``errorBudgetRemaining`` and ``burning``
    (they judge filter latencies);
  - in ``timeline``: ``now``; the ``verb_p99_ms:*`` and ``verb_rate:*``
    series (latencies and rates over the sampler's wall-clock interval);
    the ``events_queue_depth``, ``workqueue_depth`` and
    ``http_accept_queue_depth`` series (read at an instant while the
    Event poster, the workers and the acceptor run); every series' points
    (``tier0``, ``tier1``), whose ``last`` is compared: where no fleet
    day plays, the sampler thread takes them every 2 s of wall clock, so
    their count and stamps are a wall-clock reading; in a fleet day the
    reference samples while its informer may not yet have seen the last
    bind (under 40 CPU spinners ``cluster_stranded_hbm_gib`` read 200 GiB
    on one side and 0 on the other at the scale-up hour, either side), so
    the twin's points are held to its own second run instead
    (``test_fleet_day_timeline_is_the_same_each_run``);
    ``exemplars`` but their verbs (latencies, stamps, trace ids); the
    markers and ``anomalies.fired`` entries of the anomaly rules that
    judge latencies (``TIMED_RULES``), and where no fleet day plays those
    of every rule (they are judged on the sampler thread's wall-clock
    ticks: under 40 CPU spinners ``EXAMPLE_SERVING``'s marker lists
    differed by such a firing); the markers of a burning objective of the
    ``filter_latency`` signal (they judge the test host's own latency:
    under the same load the reference's replay of ``EXAMPLE_SERVING``
    stamped one); every marker's ``cursor`` and
    ``cursorLatest`` (they count those markers), each marker's ``ts``
    where no fleet day plays, and a marker's ``trace_id`` attribute by
    presence;
  - a defrag plan's random ``id`` (in ``defrag.plan``, and in its
    marker's ``plan`` attribute and detail), and in ``defrag.plan``
    ``createdAt`` and each move's ``traceId``.
* The reference's replay reads its informer and its SLO engine without
  waiting for them, and under load it reads them early (one gang
  member's journey still open, the evening scale-up's wave pods not yet
  listed; ROADMAP §C3), where the twin settles first. So a comparison
  takes the twin's replay once and the reference's up to three times
  (``REFERENCE_TRIES``), until one equals the twin's; the same holds in
  ``tests/test_torch_witness.py``'s full day.
* Both tools keep the reference's SLO veto: a defrag or autoscale
  executor does not act while an objective burns. The ``filter_latency``
  objectives judge the test host's own latency, and a loaded host burns
  them and aborts the replays' defrag rounds and fleet-day acts, on
  either side alone. So in this file and in the files that import
  ``host_latency_vetoes_nothing`` (autouse), both packages' executors
  leave those objectives out of their veto, as the reference's own
  stories wire theirs (``_burning_fn``) to veto nothing; a test that
  takes ``real_veto`` keeps both vetoes whole: with every filter 8 ms
  slow on both sides, the twin's day is the reference's.
* ``FLEET_DAY_EXPECTED_KINDS`` is the reference's and lies in
  ``tpushare_torch/obs/timeline.py``'s ``MARKER_KINDS``, read by AST as
  ``tests/test_docs.py`` reads the reference's.
* The ring prices: the copied TPU model (``tpushare_torch/topology/ici.py``)
  equals the reference's on seeded hop lists, and a gang placed on H100
  nodes is priced by the port's NVLink/NIC model.
"""

from __future__ import annotations

import ast
import copy
import importlib
import json
import os
import sys
import time

import numpy as np
import pytest
import yaml

from tests import torch_reference_stories as R
from tests.test_torch_extender_e2e import TIMED_RULES
from tests.torch_obs_reset import fresh_port_obs  # noqa: F401
from tpushare import obs as jobs
from tpushare import slo as jslo
from tpushare_torch import obs as tobs
from tpushare_torch import slo as tslo
from tpushare_torch.k8s.fake import FakeApiServer
from tpushare_torch.routes import metrics as tmetrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

JSIM = importlib.import_module("tools.simulate")
TSIM = importlib.import_module("tools.simulate_torch")

# -- the reference's stories over the twin ---------------------------------- #

R.load("test_e2e")  # test_tools' Cluster
_TOOLS = R.load("test_tools")
globals().update(R.pick(
    _TOOLS, ["TestSimulator", "TestSimulateDefragScenario",
             "TestSimulateServing", "TestDefragAdvisor",
             "TestDrainAdvisor"]))
globals().update(R.pick(R.load("test_quota"), ["TestSimulateTenants"]))
globals().update(R.pick(
    R.load("test_slo"), ["TestToolingSurfaces"],
    leave_out=("TestToolingSurfaces."
               "test_bench_pod_e2e_quantile_reads_the_histogram",)))


def _veto_without_host_latency(slo_mod):
    """An executor's ``_engine_burning`` over ``slo_mod``'s engine, less
    the objectives of the ``filter_latency`` signal."""
    def burning(self) -> list[str]:
        try:
            return [row["slo"] for row in slo_mod.engine().evaluate()
                    if row.get("burning")
                    and row.get("signal") != "filter_latency"]
        except Exception:  # noqa: BLE001 - the executors' fail-safe veto
            slo_mod.engine().drops.inc()
            return ["slo-engine-unreadable"]
    return burning


@pytest.fixture
def real_veto():
    """Keeps both packages' SLO vetoes whole in the test that takes it."""


@pytest.fixture(autouse=True)
def host_latency_vetoes_nothing(request, monkeypatch):
    """Both packages' defrag and autoscale executors veto on every burning
    objective but the ``filter_latency`` ones (the module's docstring),
    unless the test takes ``real_veto``."""
    if "real_veto" in request.fixturenames:
        return
    from tpushare.autoscale.executor import AutoscaleExecutor as JAuto
    from tpushare.defrag.executor import DefragExecutor as JDefrag
    from tpushare_torch.autoscale.executor import AutoscaleExecutor as TAuto
    from tpushare_torch.defrag.executor import DefragExecutor as TDefrag

    for classes, slo_mod in (((JDefrag, JAuto), jslo),
                             ((TDefrag, TAuto), tslo)):
        for cls in classes:
            monkeypatch.setattr(cls, "_engine_burning",
                                _veto_without_host_latency(slo_mod))


@pytest.fixture
def api():
    """The stories' fleets on the port's fake apiserver."""
    tmetrics.reset()
    return FakeApiServer()


# -- each example's report, both tools -------------------------------------- #

EXAMPLES = sorted(n for n in dir(JSIM) if n.startswith("EXAMPLE"))
#: Runs of the reference's replay a comparison may take (the module's
#: docstring): the twin's is taken once.
REFERENCE_TRIES = 3
_QUEUES = ("events_queue_depth", "workqueue_depth", "http_accept_queue_depth")


def _cli_report(sim, path: str, capsys, monkeypatch) -> dict:
    """``<tool> <path> --json --seed 1234`` in this process, each package's
    singletons fresh."""
    jobs.reset()
    tobs.reset()
    jslo.reset()
    tslo.reset()
    monkeypatch.setattr(sys, "argv", ["simulate", path, "--json",
                                      "--seed", "1234"])
    sim.main()
    return json.loads(capsys.readouterr().out)


def _steady_series(series: dict) -> dict:
    """The timeline's series less those that read verb latencies or a
    queue at a wall-clock instant."""
    return {name: s for name, s in series.items()
            if not name.startswith(("verb_p99_ms:", "verb_rate:"))
            and name not in _QUEUES}


def _host_latency(marker: dict) -> bool:
    """A burning ``filter_latency`` objective's marker."""
    return marker["attrs"].get("signal") == "filter_latency"


def _comparable(report: dict, fleet_day: bool) -> dict:
    """``report`` less what reads the wall clock or a random id (the
    module docstring names each)."""
    r = copy.deepcopy(report)
    r.pop("p50_schedule_ms")
    journeys = r["slo"].get("journeys") or {}
    journeys.pop("p50E2eSeconds", None)
    journeys.pop("p99E2eSeconds", None)
    for s in r["slo"].get("slos", []):
        if s["signal"] == "filter_latency":
            for window in s["windows"].values():
                window.pop("bad")
                window.pop("burnRate")
            s.pop("errorBudgetRemaining")
            s.pop("burning")
    plan = (r.get("defrag") or {}).get("plan")
    if plan:
        plan.pop("id")
        plan.pop("createdAt")
        for move in plan.get("moves", []):
            move.pop("traceId")
    tl = r.get("timeline")
    if tl:
        tl.pop("now")
        tl.pop("cursorLatest")
        tl["exemplars"] = sorted(tl["exemplars"])
        judged = [r for r in tl["anomalies"]["rules"]
                  if r in TIMED_RULES or not fleet_day]
        tl["anomalies"]["fired"] = {
            rule: n for rule, n in tl["anomalies"]["fired"].items()
            if rule not in judged}
        tl["series"] = {
            name: {k: v for k, v in s.items() if not k.startswith("tier")}
            for name, s in _steady_series(tl["series"]).items()}
        markers = []
        for m in tl["markers"]:
            if m["attrs"].get("rule") in judged or _host_latency(m):
                continue
            m.pop("cursor")
            if not fleet_day:
                m.pop("ts")
            attrs = m["attrs"]
            if "trace_id" in attrs:
                attrs["trace_id"] = "<id>"
            if "plan" in attrs:
                m["detail"] = m["detail"].replace(attrs["plan"], "<plan>")
                attrs["plan"] = "<plan>"
            markers.append(m)
        tl["markers"] = markers
    return r


def _differences(got, want, path: str = "") -> list[str]:
    """The paths at which ``got`` and ``want`` differ, with both values."""
    if isinstance(got, dict) and isinstance(want, dict):
        return [d for k in sorted(set(got) | set(want), key=str)
                for d in _differences(got.get(k), want.get(k),
                                      f"{path}.{k}")]
    if isinstance(got, list) and isinstance(want, list):
        if len(got) != len(want):
            return [f"{path}: {len(got)} items != {len(want)}: "
                    f"{got!r}"[:800] + f" != {want!r}"[:800]]
        return [d for i, (g, w) in enumerate(zip(got, want))
                for d in _differences(g, w, f"{path}[{i}]")]
    return [] if got == want else [f"{path}: {got!r} != {want!r}"[:400]]


@pytest.mark.parametrize("example", EXAMPLES)
def test_each_example_reports_as_the_reference(example, tmp_path, capsys,
                                               monkeypatch):
    text = getattr(JSIM, example)
    assert getattr(TSIM, example) == text
    path = tmp_path / "scenario.yaml"
    path.write_text(text)
    fleet_day = "fleet_day" in yaml.safe_load(text)
    got = _cli_report(TSIM, str(path), capsys, monkeypatch)
    assert not got.get("error"), got
    for _ in range(REFERENCE_TRIES):
        want = _cli_report(JSIM, str(path), capsys, monkeypatch)
        diffs = _differences(_comparable(got, fleet_day),
                             _comparable(want, fleet_day))
        if not diffs:
            break
    assert not diffs, diffs
    if fleet_day:
        assert got["fleet_day"] == want["fleet_day"]


def test_fleet_day_timeline_is_the_same_each_run():
    """The twin samples its fleet day's timeline once the controller has
    settled: two runs of the same seed give the same points, stamped on
    the scenario clock, and the same markers."""
    scenario = yaml.safe_load(TSIM.EXAMPLE_FLEET_DAY)
    scenario["fleet_day"]["hours"] = 8
    runs = []
    for _ in range(2):
        tl = TSIM.simulate(scenario, seed=555)["timeline"]
        markers = [(m["ts"], m["kind"],
                    m["detail"].replace(m["attrs"].get("plan") or "<plan>",
                                        "<plan>"))
                   for m in tl["markers"]
                   if m["attrs"].get("rule") not in TIMED_RULES
                   and not _host_latency(m)]
        runs.append((_steady_series(tl["series"]), markers))
    assert runs[0] == runs[1]
    series = runs[0][0]
    assert max(v for _, v in series["fleet_nodes"]["tier0"]) == 7


def test_slow_filters_veto_the_day_as_the_reference_s(monkeypatch,
                                                     real_veto):
    """Every filter 8 ms slow on both sides, both SLO vetoes whole: the
    ``filter-p99-5ms`` objective burns on both, each executor aborts the
    same defrag wave and autoscale acts, and the twin's day is the
    reference's (short of 6 matched)."""
    from tpushare.scheduler import predicate as jpredicate
    from tpushare_torch.scheduler import predicate as tpredicate

    scenario = yaml.safe_load(TSIM.EXAMPLE_FLEET_DAY)
    scenario["fleet_day"]["hours"] = 8
    for mod in (jpredicate, tpredicate):
        real = mod.Predicate.handle

        def slow(self, *args, _real=real, **kwargs):
            time.sleep(0.008)
            return _real(self, *args, **kwargs)

        monkeypatch.setattr(mod.Predicate, "handle", slow)
    report = TSIM.simulate(scenario, seed=1234)
    got = report["fleet_day"]
    assert [s["slo"] for s in report["slo"]["slos"] if s["burning"]] == \
        ["filter-p99-5ms"]
    for _ in range(REFERENCE_TRIES):
        report = JSIM.simulate(scenario, seed=1234)
        want = report["fleet_day"]
        if want == got:
            break
    assert [s["slo"] for s in report["slo"]["slos"] if s["burning"]] == \
        ["filter-p99-5ms"]
    assert got == want
    assert got["witness"]["counts"]["matched"] < 6


# -- the expected marker kinds ---------------------------------------------- #


def _literal(path: str, name: str) -> list[str]:
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign)
                and any(getattr(t, "id", "") == name for t in node.targets)):
            value = node.value
            if isinstance(value, ast.Call):  # frozenset({...})
                value = value.args[0]
            return [c.value for c in value.elts]
    raise AssertionError(f"{name} literal not found in {path}")


def test_fleet_day_expected_kinds_are_the_reference_s_and_in_the_taxonomy():
    expected = _literal(os.path.join(REPO, "tools", "simulate_torch.py"),
                        "FLEET_DAY_EXPECTED_KINDS")
    assert expected == _literal(os.path.join(REPO, "tools", "simulate.py"),
                                "FLEET_DAY_EXPECTED_KINDS")
    assert tuple(expected) == TSIM.FLEET_DAY_EXPECTED_KINDS
    taxonomy = _literal(os.path.join(REPO, "tpushare_torch", "obs",
                                     "timeline.py"), "MARKER_KINDS")
    assert sorted(set(expected) - set(taxonomy)) == []


# -- ring prices ------------------------------------------------------------ #


@pytest.mark.parametrize("seed", range(4))
def test_ici_copy_prices_as_the_reference(seed):
    from tpushare.workload import parallel as JP
    from tpushare_torch.topology import ici

    rng = np.random.default_rng(seed)
    for _ in range(20):
        rings = [[None if rng.random() < 0.2 else int(rng.integers(0, 6))
                  for _ in range(int(rng.integers(1, 9)))]
                 for _ in range(int(rng.integers(1, 4)))]
        links = [None if rng.random() < 0.2 else int(rng.integers(0, 4))
                 for _ in range(int(rng.integers(0, 4)))]
        kw = dict(layers=int(rng.integers(1, 64)),
                  microbatches=int(rng.integers(1, 16)),
                  kv_block_bytes=float(rng.integers(1, 1 << 28)),
                  act_bytes=float(rng.integers(1, 1 << 27)),
                  compute_ms=float(rng.uniform(0, 50)))
        assert ici.predicted_step_time_ms(rings, links, **kw) == \
            JP.predicted_step_time_ms(rings, links, **kw)
        assert ici.predicted_step_time_ms(rings, links) == \
            JP.predicted_step_time_ms(rings, links)


def test_h100_gang_is_priced_by_the_port_s_model():
    """Four whole-node members on four H100 nodes of one slice grid (8
    cards a node, four nodes in a row), a fifth node to spare: the
    report's ring is off-node at every hop, so the port's NVLink/NIC model
    prices it through the NIC, and not the copied ICI model."""
    from tpushare_torch.topology import fleet, ici
    from tpushare_torch.topology import topology as T
    from tpushare_torch.workload import parallel as PL

    report = TSIM.simulate({
        "fleet": [{"count": 4, "prefix": "h100", "chips": 8,
                   "hbm_per_chip": 79, "tpu_type": "h100-80gb",
                   "topology": "8", "slice_id": "nvl-a",
                   "slice_topology": "32"}],
        "workload": [{"count": 4, "name": "rank", "chips": 8,
                      "group": "tp-ring", "group_min": 4}],
    })
    assert report["unschedulable"] == 0, report["unschedulable_pods"]
    (ring,) = report["topology"]
    assert ring["gang"] == "tp-ring"
    assert len(set(ring["nodes"])) == 4
    nic = [None] * 4
    assert ring["predictedStepMs"] == round(
        PL.predicted_step_time_ms([nic], []), 3)
    grid = T.slice_host_grid("32", "8", "h100-80gb")
    coords = [tuple(c) for c in ring["coords"]]
    assert ring["ringContiguity"] == fleet.ring_stats(coords, grid)[
        "contiguity"]
    assert ring["predictedStepMs"] != round(ici.predicted_step_time_ms(
        [fleet.ring_hops(coords, grid)], []), 3)
