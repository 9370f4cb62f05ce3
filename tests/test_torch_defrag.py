"""The port's defragmentation (``tpushare_torch/defrag/``: the frag index,
the rebalance planner and the budgeted executor) against the JAX
package's.

* The reference's stories of ``tests/test_defrag.py`` over the port's
  modules (``tests/torch_reference_stories.py``): the frag index
  (``TestFragIndex``), the planner's invariants: gang-atomic, quota-safe,
  checkpoint-aware, budgeted (``TestPlanner``), the executor's postures,
  budgets and SLO abort (``TestExecutor``), the evict → recreate race
  (``TestEvictRecreateRace``) and the acceptance story over
  ``tests/miniapiserver.py`` (``TestAcceptanceStory``); and the ring
  repair's stories of ``tests/test_topology.py`` on the reference's v5p
  slice fleets (``TestDefragRingRepair``, ``TestRingRepairHardening``).
* Both frag indexes over the same seeded fleets and demand shapes: the
  same cluster reports.
* Both planners over the same seeded fragmented fleets (H100 and TPU
  nodes, gangs, checkpoints in flight, a quota table): the same plans,
  and both over a scattered slice gang: the same ring repairs. Plan ids,
  their creation time and the moves' trace ids are random or clocks.
* Both executors, active, each over its own fake apiserver, with an SLO
  that starts to burn mid-plan or an hourly budget that runs out: the
  same plan documents, the same pods evicted, the same Events, the same
  ``/debug/defrag`` status and the same counter rises.
* Both ``serve_stack``s (``tests/test_torch_extender_e2e.py``'s ``Pair``)
  after the seeded churn over 16 H100 nodes, with pods left pending: the
  same ``/debug/defrag`` frag report and the same dry-run plan.
* Each of the seven variables of the reference's main that the port now
  reads (``TPUSHARE_SLO_NAMESPACE``, ``TPUSHARE_DEFRAG_*``): the port's
  main reads it without a warning, and it sets the port's executor and
  engine as it sets the reference's.
"""

from __future__ import annotations

import json
import logging
import re

import numpy as np
import pytest

from tests import torch_reference_stories as R
from tests.test_torch_extender_e2e import H100, Pair
from tests.test_torch_extender_e2e import test_seeded_churn_on_h100_nodes \
    as churn
from tests.test_torch_gc_runtime import no_cluster  # noqa: F401
from tests.torch_obs_reset import fresh_port_obs  # noqa: F401
from tpushare import slo as jslo
from tpushare.api.objects import ConfigMap as JConfigMap, Pod as JPod
from tpushare.cache.cache import SchedulerCache as JCache
from tpushare.cmd import main as jmain
from tpushare.defrag import frag as jfrag
from tpushare.defrag.executor import DefragExecutor as JExecutor
from tpushare.defrag.planner import RebalancePlanner as JPlanner
from tpushare.k8s import eviction as jeviction
from tpushare.k8s import events as jevents
from tpushare.k8s.builders import make_node, make_pod
from tpushare.k8s.fake import FakeApiServer as JFake
from tpushare.quota import config as jquota_config
from tpushare.quota.manager import QuotaManager as JQuota
from tpushare.routes import metrics as jmetrics
from tpushare_torch import slo as tslo
from tpushare_torch.api.objects import ConfigMap as TConfigMap, Pod as TPod
from tpushare_torch.cache.cache import SchedulerCache as TCache
from tpushare_torch.cmd import main as tmain
from tpushare_torch.defrag import frag as tfrag
from tpushare_torch.defrag.executor import DefragExecutor as TExecutor
from tpushare_torch.defrag.planner import RebalancePlanner as TPlanner
from tpushare_torch.k8s import eviction as teviction
from tpushare_torch.k8s import events as tevents
from tpushare_torch.k8s.fake import FakeApiServer as TFake
from tpushare_torch.quota import config as tquota_config
from tpushare_torch.quota.manager import QuotaManager as TQuota
from tpushare_torch.routes import metrics as tmetrics
from tpushare_torch.utils import const

# -- the reference's stories over the port ------------------------------------ #

_STORIES = R.load("test_defrag")


def _counter(counter, **labels):
    """The stories' counter reader over the port's exposition."""
    return (counter.labels(**labels) if labels else counter).get()


_STORIES._counter = _counter
_fresh_trace = _STORIES._fresh_trace
globals().update(R.pick(
    _STORIES,
    ["TestFragIndex", "TestPlanner", "TestExecutor",
     "TestEvictRecreateRace", "TestAcceptanceStory"]))
_TOPOLOGY = R.load("test_topology")
globals().update(R.pick(
    _TOPOLOGY, ["TestDefragRingRepair", "TestRingRepairHardening"]))


@pytest.fixture
def api():
    """The reference's stories run over the port's fake apiserver."""
    return TFake()


SIDES = {
    "jax": dict(fake=JFake, cache=JCache, frag=jfrag, planner=JPlanner,
                executor=JExecutor, eviction=jeviction, events=jevents,
                pod=JPod, quota=JQuota, quota_config=jquota_config,
                cm=JConfigMap, metrics=jmetrics, slo=jslo, main=jmain),
    "port": dict(fake=TFake, cache=TCache, frag=tfrag, planner=TPlanner,
                 executor=TExecutor, eviction=teviction, events=tevents,
                 pod=TPod, quota=TQuota, quota_config=tquota_config,
                 cm=TConfigMap, metrics=tmetrics, slo=tslo, main=tmain),
}


def _jax_counter(counter, **labels):
    child = counter.labels(**labels) if labels else counter
    return child._value.get()


def _read_counter(side: dict, name: str, **labels) -> float:
    counter = getattr(side["metrics"], name)
    return (_jax_counter(counter, **labels) if side is SIDES["jax"]
            else _counter(counter, **labels))


# -- seeded fragmented fleets ------------------------------------------------- #

def _bound(name: str, node: str, chips: list[int], hbm: int, hbm_chip: int,
           whole: int = 0, namespace: str = "default",
           annotations: dict | None = None) -> dict:
    ann = {const.ANN_CHIP_IDX: ",".join(str(c) for c in chips),
           const.ANN_HBM_POD: str(hbm), const.ANN_HBM_CHIP: str(hbm_chip),
           const.ANN_ASSIGNED: const.ASSIGNED_TRUE,
           const.ANN_ASSUME_TIME: "1"}
    ann.update(annotations or {})
    if whole:
        return make_pod(name, chips=whole, namespace=namespace,
                        node_name=node, phase="Running", uid=f"u-{name}",
                        annotations=ann)
    return make_pod(name, hbm=hbm, namespace=namespace, node_name=node,
                    phase="Running", uid=f"u-{name}", annotations=ann)


def _fleet(seed: int) -> tuple[list[dict], list[dict], list[dict], dict]:
    """Nodes, bound pods, pending pods and a quota table (or None), drawn
    from ``seed``: H100 nodes (8 × 79 GiB) and v5e nodes (4 × 16 GiB),
    each card filled with slices that leave splinters, a few whole-card
    pods, a gang of two, pods with a checkpoint in flight, and pending
    slices and whole-card pods larger than most splinters."""
    rng = np.random.default_rng(seed)
    nodes, pods, pending = [], [], []
    n_h100 = int(rng.integers(3, 7))
    n_v5e = int(rng.integers(0, 3))
    seq = 0
    gang = {const.ANN_POD_GROUP: "pair", const.ANN_POD_GROUP_MIN: "2"}
    gang_left = 2
    for i in range(n_h100 + n_v5e):
        h100 = i < n_h100
        name = f"h100-{i}" if h100 else f"v5e-{i}"
        chips, cap = (8, 79) if h100 else (4, 16)
        nodes.append(make_node(name, **H100) if h100 else make_node(name))
        sizes = (16, 24, 30) if h100 else (4, 6)
        for c in range(chips):
            roll = rng.random()
            if roll < 0.12 and c + 1 < chips:
                continue  # a free card
            if roll < 0.2:
                seq += 1
                pods.append(_bound(f"w{seq}", name, [c], cap, cap, whole=1))
                continue
            used = 0
            for _ in range(int(rng.integers(1, 3))):
                size = int(rng.choice(sizes))
                if used + size > cap - 5:
                    break
                used += size
                seq += 1
                ann = {}
                if rng.random() < 0.15:
                    ann[const.ANN_CKPT_IN_FLIGHT] = "true"
                elif gang_left and rng.random() < 0.2:
                    ann.update(gang)
                    gang_left -= 1
                ns = str(rng.choice(["default", "team-a", "team-b"]))
                pods.append(_bound(f"s{seq}", name, [c], size, cap,
                                   namespace=ns, annotations=ann))
    for j in range(int(rng.integers(1, 5))):
        if rng.random() < 0.5:
            pending.append(make_pod(f"want-{j}",
                                    hbm=int(rng.choice([44, 60, 70])),
                                    uid=f"u-want-{j}"))
        else:
            pending.append(make_pod(f"want-{j}",
                                    chips=int(rng.choice([2, 4, 8])),
                                    uid=f"u-want-{j}"))
    quota = None
    if seed % 3 == 2:
        quota = {"team-a": {"guaranteeHBM": 40},
                 "team-b": {"guaranteeHBM": 0, "limitHBM": 4000}}
    return nodes, pods, pending, quota


def _build(side: dict, seed: int):
    """One side's fake apiserver, warm cache and quota ledger over
    ``_fleet(seed)``; returns (api, cache, quota, pending pods)."""
    nodes, pods, pending, table = _fleet(seed)
    api = side["fake"]()
    for doc in nodes:
        api.create_node(json.loads(json.dumps(doc)))
    for doc in pods:
        api.create_pod(json.loads(json.dumps(doc)))
    cache = side["cache"](api.get_node, api.list_pods)
    for node in api.list_nodes():
        cache.get_node_info(node.name)
    cache.build()
    quota = None
    if table is not None:
        quota = side["quota"]()
        quota.set_config(side["quota_config"].parse_configmap(side["cm"]({
            "metadata": {"name": const.QUOTA_CONFIGMAP,
                         "namespace": "kube-system"},
            "data": {k: json.dumps(v) for k, v in table.items()}})))
        for pod in api.list_pods():
            quota.charge(pod)
    return api, cache, quota, [side["pod"](json.loads(json.dumps(d)))
                               for d in pending]


def _shapes(pending: list[dict]) -> list[tuple[int, int]]:
    out = set()
    for doc in pending:
        limits = doc["spec"]["containers"][0]["resources"]["limits"]
        out.add((int(limits.get(const.HBM_RESOURCE, 0)),
                 int(limits.get(const.CHIP_RESOURCE, 0))))
    return sorted(out)


def _plan_doc(doc: dict | None) -> dict | None:
    """A plan document less its random id, creation time and trace ids."""
    if doc is None:
        return None
    out = {k: v for k, v in doc.items() if k not in ("id", "createdAt")}
    out["moves"] = [{k: v for k, v in m.items() if k != "traceId"}
                    for m in doc["moves"]]
    return out


@pytest.mark.parametrize("seed", range(8))
def test_frag_reports_alike(seed):
    _, _, pending, _ = _fleet(seed)
    reports = []
    for side in SIDES.values():
        _, cache, _, _ = _build(side, seed)
        infos = cache.sharing_node_infos()
        reports.append([side["frag"].cluster_report(infos, shapes)
                        for shapes in ([], _shapes(pending), [(0, 8)],
                                       [(44, 0), (0, 2)])])
        reports[-1].append([side["frag"].node_report(i, _shapes(pending))
                            for i in sorted(infos, key=lambda i: i.name)])
    assert reports[1] == reports[0]
    assert reports[0][1]["strandedHBM"] > 0


@pytest.mark.parametrize("seed", range(10))
def test_plans_alike(seed):
    plans, movable = [], []
    for side in SIDES.values():
        _, cache, quota, pending = _build(side, seed)
        planner = side["planner"](cache, quota=quota,
                                  max_moves=int(seed % 4) + 2)
        plan = planner.plan(pending)
        plans.append(_plan_doc(plan.to_json() if plan else None))
        movable.append({p.name: planner.movable(p)
                        for info in cache.sharing_node_infos()
                        for chip in info.chips.values()
                        for p in chip.snapshot_pods()})
    assert plans[1] == plans[0]
    assert movable[1] == movable[0]
    if plans[0] is not None:
        names = {m["pod"].split("/", 1)[1] for m in plans[0]["moves"]}
        assert all(movable[0][n][0] for n in names)


def _slice_fleet(side: dict):
    """The reference's v5p slice (``tests/test_topology.py``'s
    ``_slice_cache``) with a gang of four scattered across it."""
    api = side["fake"]()
    for i in range(8):
        api.create_node(make_node(f"h-{i:02d}", chips=4, hbm_per_chip=95,
                                  topology="2x2x1", tpu_type="v5p",
                                  slice_id="pod-a", slice_topology="4x4x2",
                                  worker_index=i))
    ann = {const.ANN_POD_GROUP: "ring", const.ANN_POD_GROUP_MIN: "4",
           const.ANN_SLICE_SHAPE: "4x4x1"}
    for i, host in enumerate(["h-00", "h-03", "h-05", "h-06"]):
        api.create_pod(_bound(f"w-{i}", host, [0, 1, 2, 3], 380, 95,
                              whole=4, annotations=ann))
    cache = side["cache"](api.get_node, api.list_pods)
    for i in range(8):
        cache.get_node_info(f"h-{i:02d}")
    cache.build()
    return api, cache


def test_ring_repairs_alike():
    plans = []
    for side in SIDES.values():
        _, cache = _slice_fleet(side)
        plan = side["planner"](cache).plan([])
        plans.append(_plan_doc(plan.to_json() if plan else None))
    assert plans[1] == plans[0]
    assert plans[0]["moves"] and all(
        "ring-repair" in m["detail"] for m in plans[0]["moves"])


def test_h100_nodes_author_no_ring_repair():
    """An H100 node has no host grid: a scattered slice-shape gang on
    them is left where it is, on both."""
    for side in SIDES.values():
        api = side["fake"]()
        for i in range(4):
            api.create_node(make_node(f"h100-{i}", **H100))
        ann = {const.ANN_POD_GROUP: "ring", const.ANN_POD_GROUP_MIN: "2",
               const.ANN_SLICE_SHAPE: "2x2x1"}
        for i, host in enumerate(["h100-0", "h100-3"]):
            api.create_pod(_bound(f"w-{i}", host, [0, 1, 2, 3], 316, 79,
                                  whole=4, annotations=ann))
        cache = side["cache"](api.get_node, api.list_pods)
        for i in range(4):
            cache.get_node_info(f"h100-{i}")
        cache.build()
        assert side["planner"](cache).plan([]) is None


def _executor_story(side: dict, seed: int, burn_after: int | None,
                    per_hour: int) -> list:
    api, cache, quota, pending = _build(side, seed)
    for pod in pending:
        api.create_pod(json.loads(json.dumps(pod.raw)))
    calls = []

    def burning():
        calls.append(1)
        if burn_after is not None and len(calls) > burn_after:
            return ["pod-bind-30s"]
        return []

    before = {o: _read_counter(side, "DEFRAG_MOVES", outcome=o)
              for o in ("evicted", "aborted", "deferred", "dry-run")}
    aborted = {r: _read_counter(side, "DEFRAG_PLANS_ABORTED", reason=r)
               for r in ("slo-burn", "budget")}
    clock = [100.0]
    ex = side["executor"](
        cache, api, quota=quota, pod_lister=api.list_pods, mode="active",
        burning_fn=burning, now=lambda: clock[0],
        budget=side["eviction"].EvictionBudget(
            max_concurrent=2, node_cooldown_s=300.0, per_hour=per_hour,
            now=lambda: clock[0]))
    doc = ex.tick()
    plan_id = doc["id"] if doc else ""
    assert side["events"].flush()
    events = [(e["reason"], e["type"], e["involvedObject"]["name"],
               re.sub(r"\[trace [0-9a-f]+\]", "[trace <id>]",
                      e["message"].replace(plan_id, "<plan>")))
              for _, e in api.events]
    status = ex.status()
    status["lastPlan"] = _plan_doc(status["lastPlan"])
    rises = {o: _read_counter(side, "DEFRAG_MOVES", outcome=o) - v
             for o, v in before.items()}
    rises.update({r: _read_counter(side, "DEFRAG_PLANS_ABORTED", reason=r)
                  - v for r, v in aborted.items()})
    return [_plan_doc(doc), sorted(p.name for p in api.list_pods()),
            events, status, rises]


@pytest.mark.parametrize("seed,burn_after,per_hour,outcome", [
    (0, None, 20, None), (1, 1, 20, ("aborted", "slo-burn")),
    (3, None, 1, ("aborted", "budget")), (4, 0, 20, ("aborted", "slo-burn")),
    (5, None, 20, ("executed", "")), (6, 2, 20, ("executed", "")),
    (7, None, 2, ("executed", "")), (9, None, 20, ("executed", ""))])
def test_executors_alike(seed, burn_after, per_hour, outcome):
    """Each case reaches its outcome on both: no plan, an abort on a
    burning SLO before or after the first eviction, an abort on the
    hourly budget, a plan executed (with moves deferred by the node
    cooldown)."""
    got = [_executor_story(side, seed, burn_after, per_hour)
           for side in SIDES.values()]
    assert got[1] == got[0]
    doc = got[0][0]
    assert (doc and (doc["status"], doc.get("abortReason", ""))) == outcome


# -- both stacks ---------------------------------------------------------------- #

def test_churn_frag_reports_and_dry_run_plans_alike():
    pair = Pair()
    try:
        churn(pair)
        docs = [json.loads(side.get("/debug/defrag")[1])
                for side in pair.sides]
        assert docs[1]["frag"] == docs[0]["frag"]
        assert docs[0]["frag"]["pendingShapes"]
        for doc in docs:
            doc.pop("frag")
        assert docs[1] == docs[0]
        assert docs[0]["mode"] == "dry-run" and docs[0]["ticks"] == 0
        plans = [side.stack.controller.defrag.tick() for side in pair.sides]
        assert _plan_doc(plans[1]) == _plan_doc(plans[0])
        after = [json.loads(side.get("/debug/defrag")[1])
                 for side in pair.sides]
        for doc in after:
            doc["lastPlan"] = _plan_doc(doc["lastPlan"])
        assert after[1] == after[0]
        assert after[0]["ticks"] == 1
    finally:
        pair.close()


# -- the variables the port's main now reads ------------------------------------ #

#: Each variable and a value that moves what it sets off its default.
KNOBS = {"TPUSHARE_SLO_NAMESPACE": "team-slos",
         "TPUSHARE_DEFRAG_MODE": "active",
         "TPUSHARE_DEFRAG_MAX_MOVES": "3",
         "TPUSHARE_DEFRAG_MOVES_PER_HOUR": "5",
         "TPUSHARE_DEFRAG_NODE_COOLDOWN_S": "7.5",
         "TPUSHARE_DEFRAG_MAX_CONCURRENT": "4",
         "TPUSHARE_DEFRAG_INTERVAL_S": "45.5"}


def _knob_effect(side: dict) -> tuple:
    """The defrag executor's posture and budget, and the SLO objectives a
    ConfigMap in ``team-slos`` and one in ``kube-system`` leave, of a
    stack built under the current environment."""
    api = side["fake"]()
    for ns, name in (("team-slos", "bind-9s"), ("kube-system", "bind-1s")):
        api.create_configmap({
            "metadata": {"name": const.SLO_CONFIGMAP, "namespace": ns},
            "data": {name: json.dumps({"signal": "pod_e2e",
                                       "thresholdSeconds": 9})}})
    side["slo"].reset()
    stack, server = side["main"].serve_stack(api)
    try:
        status = stack.controller.defrag.status()
        status.pop("frag")
        return status, sorted(side["slo"].engine().config().slos)
    finally:
        side["main"].shutdown_stack(stack, server)
        side["slo"].reset()


@pytest.mark.parametrize("name", sorted(KNOBS))
def test_main_reads_each_slo_and_defrag_variable(no_cluster, monkeypatch,
                                                 caplog, name):
    defaults = [_knob_effect(side) for side in SIDES.values()]
    monkeypatch.setenv(name, KNOBS[name])
    assert name not in tmain.NOT_PORTED
    monkeypatch.setenv("TPUSHARE_GC_TUNE", "off")
    with caplog.at_level(logging.WARNING, logger=tmain.log.name):
        tmain.main()
    assert not [r for r in caplog.records if r.name == tmain.log.name
                and r.levelno >= logging.WARNING]
    got = [_knob_effect(side) for side in SIDES.values()]
    assert got[1] == got[0]
    assert got[0] != defaults[0]
