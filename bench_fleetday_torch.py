"""The port's twin of ``bench.py --fleet-day``: the committed fleet day over
the port's extender, through ``tools/simulate_torch.py``.

One seeded, clock-compressed 24-hour day (a quota ConfigMap apply, a
router surge and its scale-out bind, a NotReady host, an active defrag
wave, an autoscale up and down) through the port's stack, graded act by
act by the port's fleet-day witness, plus the witness's overhead probe on
a quiet fleet of the reference bench's v5p node documents
(``bench_autoscale_torch.py``'s ``_Fleet``). The gates are
those of ``BENCH_FLEETDAY.json``: 100% witness conformance, pod-SLO
compliance >= 95%, router fairness (Jain) >= 0.9, node-hours <= the
peak-static fleet's, zero guarantee evictions, and the witness's overhead
within its allowance. They are reported, and enforced only with
``--gate``. Prints ONE JSON line and writes no file::

    python3 bench_fleetday_torch.py --smoke --gate
    python3 bench_fleetday_torch.py
"""

from __future__ import annotations

import json
import os
import random
import sys

from bench_autoscale_torch import _Fleet

#: The committed fleet-day seed: BENCH_FLEETDAY.json is the verdict of
#: THIS day; same seed -> same witness verdicts and scalars, bit for bit.
FLEETDAY_SEED = 1234
#: Smoke compresses the day, not the story: every injected act still
#: runs (the scale_up/scale_down fractions land on distinct hours down
#: to 8; CI uses 12).
FLEETDAY_SMOKE_HOURS = 12
#: End-of-day pod-SLO floor: every workload pod the day admitted must
#: end bound.
FLEETDAY_GATE_SLO_PCT = 95.0
#: Router fairness floor across the steady tenants' served share
#: (Jain index; the flooder is excluded — shedding IT is the point).
FLEETDAY_GATE_JAIN = 0.9
#: Elasticity gate: the day's node-hours may not exceed the
#: peak-static fleet's (max fleet size x hours).
FLEETDAY_GATE_NODE_HOURS = 1.0

#: The overhead probe's allowance: max(5% of the disarmed p99, 0.2 ms).
SCALE_GATE_OVERHEAD = 0.05
SCALE_GATE_OVERHEAD_FLOOR_MS = 0.2


def scale_candidates(rng, names: list[str]) -> list[str]:
    """The candidate list kube-scheduler offers the extender a pod at
    this fleet size: its adaptive percentageOfNodesToScore, max(50 -
    nodes/125, 5)% with a 100-node floor."""
    n = len(names)
    pct = max(50.0 - n / 125.0, 5.0)
    k = int(max(n * pct / 100.0, min(100, n)))
    if k >= n:
        return names
    return rng.sample(names, k)


def _probe_batch(fleet: _Fleet, rng, pod, per_batch: int) -> float:
    """One batch of the mutation-free filter -> prioritize sequence; its
    handler-clock p99 (ms)."""
    from tpushare_torch.utils import stats

    lat = []
    for _ in range(per_batch):
        cands = scale_candidates(rng, fleet.names)
        _, res, h_f = fleet.client.post_timed(
            "/tpushare-scheduler/filter",
            {"Pod": pod.raw, "NodeNames": cands})
        passing = res["NodeNames"]
        h_p = 0.0
        if passing:
            _, _, h_p = fleet.client.post_timed(
                "/tpushare-scheduler/prioritize",
                {"Pod": pod.raw, "NodeNames": passing})
        lat.append((h_f or 0.0) + (h_p or 0.0))
    return stats.quantile(lat, 0.99)


def _witness_overhead_probe(fleet: _Fleet, rng, batches: int = 5,
                            per_batch: int = 500) -> dict:
    """The witness's overhead gate: interleaved mutation-free batches with
    the fleet-day witness armed (carrying a staked day of expectations)
    vs disarmed; the min-of-batch-p99s delta against max(5%, 0.2 ms)."""
    from tpushare_torch import obs
    from tpushare_torch.k8s.builders import make_pod

    pod = fleet.api.create_pod(make_pod("witness-probe", hbm=24))
    witness = obs.witness()
    was_armed = witness.armed()
    witness.reset()

    p99s: dict[bool, list[float]] = {True: [], False: []}
    try:
        for _ in range(batches):
            for armed in (False, True):
                if armed:
                    witness.arm()
                    for i in range(6):
                        witness.expect(f"probe-act-{i}", kind="config",
                                       window_s=30.0, injected_ts=0.0)
                else:
                    witness.reset()
                p99s[armed].append(_probe_batch(fleet, rng, pod,
                                                per_batch))
    finally:
        witness.reset()
        if was_armed:  # pragma: no cover - probe owns the singleton
            witness.arm()

    p99_off = min(p99s[False])
    p99_on = min(p99s[True])
    delta_ms = max(p99_on - p99_off, 0.0)
    allowance_ms = max(SCALE_GATE_OVERHEAD * p99_off,
                       SCALE_GATE_OVERHEAD_FLOOR_MS)
    return {
        "value": round(delta_ms, 3),
        "limit": round(allowance_ms, 3),
        "pass": delta_ms <= allowance_ms,
        "p99_off_ms": round(p99_off, 3),
        "p99_on_ms": round(p99_on, 3),
        "p99_delta": round(delta_ms / p99_off if p99_off else 0.0, 4),
    }


def bench_fleet_day(smoke: bool) -> dict:
    """The committed fleet-day scenario through the port's stack, and the
    witness overhead probe on a quiet fleet."""
    import yaml

    from tools import simulate_torch as sim

    scenario = yaml.safe_load(sim.EXAMPLE_FLEET_DAY)
    if smoke:
        scenario["fleet_day"]["hours"] = FLEETDAY_SMOKE_HOURS
    report = sim.simulate(scenario, seed=FLEETDAY_SEED)
    day = report.get("fleet_day") or {}
    if day.get("error"):
        raise SystemExit(f"fleet-day scenario failed: {day['error']}")

    rng = random.Random(97)
    fleet = _Fleet("fw", 64 if smoke else 256)
    try:
        overhead = _witness_overhead_probe(
            fleet, rng, batches=3 if smoke else 5,
            per_batch=120 if smoke else 500)
    finally:
        fleet.close()
    return {"day": day, "witness_overhead": overhead}


def day_gates(day: dict) -> dict:
    """``bench.py --fleet-day``'s five gates of a day, with pass flags."""
    witness = day.get("witness") or {}
    scalars = day.get("scalars") or {}
    conformance = float(witness.get("conformancePct") or 0.0)
    return {
        # Every injected act matched in its window, nothing unexplained.
        "witness_conformance": {
            "value": conformance, "limit": 100.0,
            "pass": bool(witness.get("pass")) and conformance >= 100.0},
        "pod_slo_compliance": {
            "value": scalars.get("pod_slo_compliance_pct"),
            "limit": FLEETDAY_GATE_SLO_PCT,
            "pass": (scalars.get("pod_slo_compliance_pct") or 0.0)
            >= FLEETDAY_GATE_SLO_PCT},
        "router_fairness_jain": {
            "value": scalars.get("router_fairness_jain"),
            "limit": FLEETDAY_GATE_JAIN,
            "pass": (scalars.get("router_fairness_jain") or 0.0)
            >= FLEETDAY_GATE_JAIN},
        "node_hours_ratio": {
            "value": scalars.get("node_hours_ratio"),
            "limit": FLEETDAY_GATE_NODE_HOURS,
            "pass": (scalars.get("node_hours_ratio") or 2.0)
            <= FLEETDAY_GATE_NODE_HOURS},
        "guarantee_evictions": {
            "value": scalars.get("guarantee_evictions"),
            "limit": 0,
            "pass": scalars.get("guarantee_evictions") == 0},
    }


def document(smoke: bool) -> dict:
    """The reference's ``--fleet-day`` document over the port."""
    result = bench_fleet_day(smoke)
    conformance = float((result["day"].get("witness") or {}).get(
        "conformancePct") or 0.0)
    gates = {**day_gates(result["day"]),
             "witness_overhead": result["witness_overhead"]}
    return {
        "metric": "fleet_day_witness_conformance_pct",
        "value": round(conformance, 2),
        "unit": "%",
        "vs_baseline": round(conformance / 100.0, 4),
        "smoke": smoke,
        "seed": FLEETDAY_SEED,
        "gates": gates,
        **result,
    }


def main() -> int:
    import logging

    logging.disable(logging.WARNING)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    doc = document(smoke="--smoke" in sys.argv)
    print(json.dumps(doc))
    if "--gate" in sys.argv and not all(g["pass"]
                                        for g in doc["gates"].values()):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
