"""The port's fleet-day witness (``tpushare_torch/obs/witness.py``, its
tee from ``obs.mark`` and ``/debug/fleetday``) against the JAX package's.

* The reference's stories of ``tests/test_witness.py`` over the port's
  modules (``tests/torch_reference_stories.py``): each verdict leg
  (marker, Event, metric), late, missing and spurious verdicts, the
  schedule's loud failures, arming, the counts across evaluations and
  the injected clock, and ``TestFleetDayReplay``: a compressed fleet day
  through the capacity planner's twin, ``tools/simulate_torch.py`` (the
  loader points the stories' ``from tools import simulate`` at it): 6 of
  6 matched, the same seed giving the same day bit for bit, a dropped
  marker and Event named as exactly those legs, and the scrape counters.
* The twin's full 24-hour day at seed 1234 against the reference's
  ``simulate`` day (taken up to ``REFERENCE_TRIES`` times, as
  ``tests/test_torch_simulate.py`` takes it) and ``BENCH_FLEETDAY.json``'s
  ``day``.
* Here, as in ``tests/test_torch_simulate.py``, both packages' defrag and
  autoscale executors leave the ``filter_latency`` objectives, which
  judge the test host's own latency, out of their SLO veto
  (``host_latency_vetoes_nothing``).
* Both witnesses fed the same seeded schedules, markers, Event listings
  and series on injected clocks: the same reports, counts and snapshots.
"""

from __future__ import annotations

import importlib
import json
import os

import numpy as np
import pytest

import yaml

from tests import torch_reference_stories as R
from tests.test_torch_simulate import REFERENCE_TRIES
from tests.test_torch_simulate import host_latency_vetoes_nothing  # noqa: F401
from tests.torch_obs_reset import fresh_port_obs  # noqa: F401
from tpushare_torch import obs as tobs

jwitness = importlib.import_module("tpushare.obs.witness")
twitness = importlib.import_module("tpushare_torch.obs.witness")

_STORIES = R.load("test_witness")
fresh_witness = _STORIES.fresh_witness
globals().update(R.pick(
    _STORIES, ["TestVerdictLegs", "TestSpuriousAndSchedule",
               "TestClockInjection", "TestFleetDayReplay"]))


def _witness_stream(mod, seed: int) -> list:
    rng = np.random.default_rng(seed)
    clock = [100.0]
    w = mod.FleetDayWitness(now_fn=lambda: clock[0])
    w.arm()
    kinds = ("config", "leader", "node-notready", "gang-commit")
    series = {"fleet_nodes_ready": {"tier0": []}}
    out = []
    for i in range(int(rng.integers(10, 30))):
        kind = str(rng.choice(kinds))
        w.expect(f"e{i}", kind=kind,
                 detail_substr=str(rng.choice(["", "node", "n3", "zz"])),
                 event_reason=(None if rng.random() < 0.5
                               else "TPUShareNodeNotReady"),
                 metric=(None if rng.random() < 0.6
                         else "fleet_nodes_ready"),
                 metric_delta=float(rng.choice([-1.0, 1.0])),
                 window_s=float(rng.choice([5.0, 30.0])))
        for _ in range(int(rng.integers(0, 4))):
            clock[0] += float(rng.exponential(6.0))
            w.observe_marker(str(rng.choice(kinds)), clock[0],
                             f"node n{int(rng.integers(5))}",
                             {"node": f"n{int(rng.integers(5))}"})
            series["fleet_nodes_ready"]["tier0"].append(
                (clock[0], float(rng.integers(0, 4))))
        if rng.random() < 0.4:
            w.observe_events([("kube-system", {
                "metadata": {"name": f"ev{int(rng.integers(8))}"},
                "reason": str(rng.choice(["TPUShareNodeNotReady",
                                          "TPUShareAnomaly"])),
                "message": "m"})])
        if rng.random() < 0.2:
            out.append(w.evaluate(series))
    out += [w.evaluate(series), w.counts(), w.snapshot()]
    return out


@pytest.mark.parametrize("seed", range(4))
def test_witnesses_judge_alike(seed):
    assert _witness_stream(twitness, seed) == \
        _witness_stream(jwitness, seed)


def test_mark_tees_the_port_s_witness():
    """``obs.mark`` hands the port's witness each marker while armed."""
    w = tobs.witness()
    w.arm()
    w.expect("cm", kind="config", window_s=60.0)
    tobs.mark("config", "quota ConfigMap applied", configmap="quota")
    assert w.evaluate()["verdicts"][0]["verdict"] == "matched"


def test_full_day_is_the_reference_s_and_the_committed_one():
    """``EXAMPLE_FLEET_DAY`` at its 24 hours and seed 1234 through both
    capacity planners: the same ``fleet_day`` document, 6 of 6 matched,
    no guarantee evicted, and ``BENCH_FLEETDAY.json``'s ``day``."""
    from tools import simulate as jsim
    from tools import simulate_torch as tsim

    scenario = yaml.safe_load(tsim.EXAMPLE_FLEET_DAY)
    got = tsim.simulate(scenario, seed=1234)["fleet_day"]
    assert got["witness"]["counts"] == {"matched": 6, "late": 0,
                                        "missing": 0, "spurious": 0}
    assert got["scalars"]["guarantee_evictions"] == 0
    for _ in range(REFERENCE_TRIES):
        want = jsim.simulate(scenario, seed=1234)["fleet_day"]
        if want == got:
            break
    assert got == want
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "BENCH_FLEETDAY.json"),
              encoding="utf-8") as f:
        assert got == json.load(f)["day"]
