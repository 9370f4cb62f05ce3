"""The port's fleet autoscaler (``tpushare_torch/autoscale/``: the node
template election and the budgeted executor) against the JAX package's.

* The reference's stories of ``tests/test_autoscale.py`` over the port's
  modules (``tests/torch_reference_stories.py``): the template election
  and the slice hole (``TestProvision``), the cordon honoured by the
  filter (``TestCordonFilter``), scale-up behind its hysteresis, cooldown,
  ceiling and the defrag-first rule (``TestScaleUp``), scale-down's
  election, drain through the shared budget, deferral and SLO abort with
  its uncordon and Event (``TestScaleDown``), the gauges, the status
  document and ``/debug/autoscale`` (``TestSurfaces``), and both
  acceptance stories over ``tests/miniapiserver.py``
  (``TestAcceptanceStories``). The stories' ``_wire_stack`` hands back a
  client whose ``create_pod`` returns once the stack's informer lists the
  pod: the scale-up story's first tick plans for the pending pods the
  informer lists, and under load the informer lags the create (the
  reference's story races there, ROADMAP §C3).
* Both ``elect_template``s over the same seeded fleets: TPU slice grids
  with holes, H100 nodes (no host grid: the template clone), mixed
  fleets and an empty one: the same node documents and details.
* Both executors, active, each over its own fake apiserver, ticking on
  injected clocks through a seeded story: demand ages and a router's
  scale-out want that come and go, SLOs that burn for a while, an hourly
  budget shared with defrag, and the informer's sync played by hand
  between ticks. The same decisions at every tick, the same nodes (their
  documents and cordons), the same pods, the same Events, the same
  ``status()`` and the same counter rises.
* Both ``serve_stack``s (``tests/test_torch_extender_e2e.py``'s ``Pair``)
  after the seeded churn over 16 H100 nodes: the same
  ``/debug/autoscale`` before and after a dry-run tick, each demand
  shape's oldest wait (each side's clock) by shape only.
* The frozen ``tools/kubectl_inspect_tpushare.py``'s ``autoscale`` view
  of both stacks' ``/debug/autoscale`` after each of two active ticks
  that scale the fleet down: the same text.
* Each of the seven ``TPUSHARE_AUTOSCALE*`` variables of the reference's
  main: the port's main reads it without a warning, and it sets the
  port's executor as it sets the reference's.
"""

from __future__ import annotations

import json
import logging
import re
import time

import numpy as np
import pytest

from tests import torch_reference_stories as R
from tests.test_torch_defrag import SIDES as DEFRAG_SIDES
from tests.test_torch_defrag import _build
from tests.test_torch_extender_e2e import H100, Pair
from tests.test_torch_extender_e2e import test_seeded_churn_on_h100_nodes \
    as churn
from tests.test_torch_gc_runtime import no_cluster  # noqa: F401
from tests.torch_obs_reset import fresh_port_obs  # noqa: F401
from tpushare.autoscale import provision as jprovision
from tpushare.autoscale.executor import AutoscaleExecutor as JExecutor
from tpushare.k8s.builders import make_node
from tpushare_torch.autoscale import provision as tprovision
from tpushare_torch.autoscale.executor import AutoscaleExecutor as TExecutor
from tpushare_torch.cmd import main as tmain
from tpushare_torch.k8s.fake import FakeApiServer as TFake
from tpushare_torch.utils import const

# -- the reference's stories over the port ------------------------------------ #

_STORIES = R.load("test_autoscale")


def _counter(counter, **labels):
    """The stories' counter reader over the port's exposition."""
    return (counter.labels(**labels) if labels else counter).get()


_STORIES._counter = _counter
_reference_wire_stack = _STORIES._wire_stack


def _wire_stack(server):
    """The reference's ``_wire_stack``; its client's ``create_pod``
    returns once the stack's informer lists the new pod."""
    client, stack, http_server = _reference_wire_stack(server)
    create = client.create_pod

    def create_pod(doc):
        pod = create(doc)
        deadline = time.monotonic() + 10
        while (stack.controller.hub.get_pod(pod.namespace, pod.name) is None
               and time.monotonic() < deadline):
            time.sleep(0.01)
        return pod
    client.create_pod = create_pod
    return client, stack, http_server


_STORIES._wire_stack = _wire_stack
_fresh_trace = _STORIES._fresh_trace
globals().update(R.pick(
    _STORIES,
    ["TestProvision", "TestCordonFilter", "TestScaleUp", "TestScaleDown",
     "TestSurfaces", "TestAcceptanceStories"]))


@pytest.fixture
def api():
    """The reference's stories run over the port's fake apiserver."""
    return TFake()


SIDES = {
    "jax": {**DEFRAG_SIDES["jax"], "provision": jprovision,
            "autoscale": JExecutor},
    "port": {**DEFRAG_SIDES["port"], "provision": tprovision,
             "autoscale": TExecutor},
}


def _read_counter(side: dict, name: str, **labels) -> float:
    counter = getattr(side["metrics"], name)
    child = counter.labels(**labels) if labels else counter
    return (child._value.get() if side is SIDES["jax"] else child.get())


# -- the template election ------------------------------------------------------ #

def _election_fleet(seed: int) -> list[dict]:
    """Node documents drawn from ``seed``: up to two v5p slices of eight
    hosts (a 2x2x2 host grid each) with holes, H100 nodes, plain v5e
    nodes; seed 0 is the empty fleet."""
    rng = np.random.default_rng(seed)
    docs: list[dict] = []
    if seed == 0:
        return docs
    for s in range(int(rng.integers(0, 3))):
        holes = set(rng.choice(8, size=int(rng.integers(1, 4)),
                               replace=False).tolist())
        for i in range(8):
            if i in holes:
                continue
            docs.append(make_node(
                f"s{s}-{i:02d}", chips=4, hbm_per_chip=95, topology="2x2x1",
                tpu_type="v5p", slice_id=f"pod-{s}", slice_topology="4x4x2",
                worker_index=i))
    for i in range(int(rng.integers(0, 4))):
        docs.append(make_node(f"h100-{i}", **H100))
    for i in range(int(rng.integers(0, 3))):
        docs.append(make_node(f"v5e-{i}", chips=int(rng.choice([2, 4])),
                              hbm_per_chip=16))
    return docs


SHAPES = [(0, 4), (0, 8), (24, 0), (44, 0), (90, 0), (120, 0), (0, 1),
          (16, 0)]


@pytest.mark.parametrize("seed", range(10))
def test_elections_alike(seed):
    got = []
    for side in SIDES.values():
        api = side["fake"]()
        for doc in _election_fleet(seed):
            api.create_node(json.loads(json.dumps(doc)))
        cache = side["cache"](api.get_node, api.list_pods)
        for node in api.list_nodes():
            cache.get_node_info(node.name)
        cache.build()
        infos = cache.sharing_node_infos()
        existing = frozenset(cache.node_table()) | {"autoscale-1"}
        got.append([side["provision"].elect_template(infos, shape, existing)
                    for shape in SHAPES])
    assert got[1] == got[0]
    kinds = {detail["kind"] for _, detail in got[0]}
    assert kinds <= {"slice-completion", "template", "generic"}


def test_h100_fleets_fall_to_the_template():
    """An H100 node has no host grid: a 4-card shape on an H100 fleet
    clones the roomiest node, on both."""
    for side in SIDES.values():
        api = side["fake"]()
        for i in range(3):
            api.create_node(make_node(f"h100-{i}", **H100))
        cache = side["cache"](api.get_node, api.list_pods)
        for i in range(3):
            cache.get_node_info(f"h100-{i}")
        cache.build()
        doc, detail = side["provision"].elect_template(
            cache.sharing_node_infos(), (0, 4), frozenset(cache.node_table()))
        assert detail == {"kind": "template", "clonedFrom": "h100-0"}
        assert doc["metadata"]["annotations"][const.ANN_NODE_CHIP_HBM] == \
            ",".join(["79"] * 8)


# -- both executors through one seeded story ------------------------------------ #

class Demand:
    """A DemandTracker stand-in whose per-shape ages the story sets."""

    def __init__(self) -> None:
        self.ages: dict = {}

    def snapshot(self):
        return (0, 0, 0)

    def oldest_age_by_shape(self):
        return dict(self.ages)


class RouterWant:
    """A router stand-in whose scale-out want the story sets."""

    def __init__(self) -> None:
        self.spec: dict | None = None

    def snapshot(self) -> dict:
        return {"scaleOut": {"wanted": self.spec is not None,
                             "spec": self.spec or {}}}


def _sync(api, cache) -> None:
    """The informer's sync, played by hand: nodes created or deleted and
    pods evicted since the last tick reach the ledger."""
    live = {n.name for n in api.list_nodes()}
    for name in list(cache.node_table()):
        if name not in live:
            cache.remove_node(name)
    for name in sorted(live):
        cache.get_node_info(name)
    uids = {p.uid for p in api.list_pods()}
    for info in cache.sharing_node_infos():
        for chip in info.chips.values():
            for pod in chip.snapshot_pods():
                if pod.uid not in uids and cache.get_pod(pod.uid) is not None:
                    cache.remove_pod(cache.get_pod(pod.uid))


def _events(side, api) -> list:
    assert side["events"].flush()
    return [(e["reason"], e["type"], e["involvedObject"]["name"],
             re.sub(r"\[trace [0-9a-f]+\]", "[trace <id>]", e["message"]))
            for _, e in api.events]


ACTIONS = ("up", "down", "evicted", "deleted", "hold", "dry-run", "aborted",
           "failed")


def _autoscale_story(side: dict, seed: int) -> list:
    rng = np.random.default_rng(1000 + seed)
    api, cache, quota, _ = _build(side, seed)
    clock = [1000.0]
    burn_from = int(rng.integers(2, 9))
    burn_for = int(rng.integers(0, 3))
    tick_no = [0]

    def burning():
        if burn_from <= tick_no[0] < burn_from + burn_for:
            return ["pod-bind-30s"]
        return []

    budget = side["eviction"].EvictionBudget(
        max_concurrent=2, node_cooldown_s=float(rng.choice([0.0, 300.0])),
        per_hour=int(rng.choice([1, 3, 20])), now=lambda: clock[0])
    ex = side["autoscale"](cache, api, quota=quota, pod_lister=api.list_pods,
                           burning_fn=burning, mode="active",
                           budget=budget, now=lambda: clock[0])
    ex.up_delay_s = float(rng.choice([0.0, 30.0]))
    ex.down_delay_s = float(rng.choice([0.0, 120.0]))
    ex.cooldown_s = float(rng.choice([0.0, 60.0]))
    ex.max_nodes = int(rng.integers(4, 12))
    demand, router = Demand(), RouterWant()
    ex.set_demand(demand)
    ex.set_router(router)
    before = {a: _read_counter(side, "AUTOSCALE_ACTIONS", action=a)
              for a in ACTIONS}
    aborted = _read_counter(side, "AUTOSCALE_ABORTED", reason="slo-burn")
    out = []
    for tick in range(14):
        tick_no[0] = tick
        clock[0] += float(rng.choice([5.0, 40.0, 200.0]))
        roll = rng.random()
        if roll < 0.45 and tick < 8:
            shape = [(0, 8), (0, 4), (70, 0), (44, 0)][int(rng.integers(4))]
            demand.ages = {shape: float(rng.choice([5.0, 45.0, 300.0]))}
        else:
            demand.ages = {}
        router.spec = ({"hbmGiB": 16, "reason": "queue-depth"}
                       if rng.random() < 0.15 and tick < 8 else None)
        out.append(ex.tick())
        _sync(api, cache)
        out.append(sorted((n.name, n.unschedulable,
                           json.dumps(n.raw["metadata"].get("annotations"),
                                      sort_keys=True))
                          for n in api.list_nodes()))
        out.append(sorted(p.name for p in api.list_pods()))
    out.append(_events(side, api))
    out.append(ex.status())
    rises = {a: _read_counter(side, "AUTOSCALE_ACTIONS", action=a) - v
             for a, v in before.items()}
    rises["aborted:slo-burn"] = _read_counter(
        side, "AUTOSCALE_ABORTED", reason="slo-burn") - aborted
    out.append(rises)
    return out


@pytest.mark.parametrize("seed", range(10))
def test_executors_alike(seed):
    got = [_autoscale_story(side, seed) for side in SIDES.values()]
    assert len(got[1]) == len(got[0])
    for i, (want, have) in enumerate(zip(*got)):
        assert have == want, (i, want, have)
    STORY_ACTIONS[seed] = got[0][-1]


#: Counter rises of each seed's story (filled by the test above).
STORY_ACTIONS: dict[int, dict] = {}


def test_the_stories_scale_up_drain_delete_and_abort():
    """Across the seeds the stories reach every branch the executor
    has: a node bought, a drain with evictions, a node deleted, a hold
    and an SLO abort."""
    for seed in range(10):
        if seed not in STORY_ACTIONS:
            STORY_ACTIONS[seed] = _autoscale_story(SIDES["port"], seed)[-1]
    total = {k: sum(r[k] for r in STORY_ACTIONS.values())
             for k in STORY_ACTIONS[0]}
    for key in ("up", "down", "evicted", "deleted", "hold",
                "aborted:slo-burn"):
        assert total[key] > 0, total


# -- both stacks ------------------------------------------------------------------ #

def test_churn_autoscale_status_alike():
    pair = Pair()
    try:
        churn(pair)
        docs = [json.loads(side.get("/debug/autoscale")[1])
                for side in pair.sides]
        assert docs[1] == docs[0]
        assert docs[0]["mode"] == "dry-run" and docs[0]["ticks"] == 0
        assert docs[0]["fleet"]["nodes"] == 16
        for side in pair.sides:
            # Demand of any age counts: the churn's is seconds old.
            side.stack.controller.autoscale.up_delay_s = 0.0
        decisions = [side.stack.controller.autoscale.tick()
                     for side in pair.sides]
        for d in decisions:
            # Each demand shape's oldest wait is each side's clock.
            d["demand"]["tracker"] = sorted(d["demand"]["tracker"])
        assert decisions[1] == decisions[0]
        assert decisions[0]["action"] in ("hold", "scale-up", "scale-down")
        after = [json.loads(side.get("/debug/autoscale")[1])
                 for side in pair.sides]
        for doc in after:
            doc["lastDecision"]["demand"]["tracker"] = sorted(
                doc["lastDecision"]["demand"]["tracker"])
        assert after[1] == after[0]
        assert after[0]["ticks"] == 1
        # Both controllers built the executor over the defrag budget.
        for side in pair.sides:
            ctl = side.stack.controller
            assert ctl.autoscale.budget is ctl.defrag.budget
            assert ctl.autoscale.demand is side.stack.predicate.demand
    finally:
        pair.close()


def test_the_inspect_tool_renders_both_autoscalers_alike():
    import tools.kubectl_inspect_tpushare as cli
    from tpushare.k8s.builders import make_pod

    pair = Pair()
    try:
        for i in range(3):
            pair.create_node(make_node(f"h100-{i}", **H100))
        for name, gib in (("a0", 20), ("a1", 30)):
            pair.create_pod(make_pod(name, hbm=gib))
            assert pair.schedule(name)[0]
        for side in pair.sides:
            side.idle()
            ex = side.stack.controller.autoscale
            ex.mode = "active"
            ex.up_delay_s = ex.down_delay_s = ex.cooldown_s = 0.0
            ex._burning_fn = lambda: []
        views = []
        for _ in range(2):
            decisions = [side.stack.controller.autoscale.tick()
                         for side in pair.sides]
            assert decisions[1] == decisions[0]
            for side in pair.sides:
                side.idle()
            docs = [cli.fetch_autoscale(side.base) for side in pair.sides]
            for doc in docs:
                if doc["draining"]:
                    doc["draining"]["forSeconds"] = 0.0   # each side's clock
            views.append([cli.render_autoscale(doc) for doc in docs])
            assert views[-1][1] == views[-1][0]
        assert "scale-down" in views[0][0] and "active" in views[0][0]
        assert [n.name for n in pair.port.api.list_nodes()] == \
            [n.name for n in pair.jax.api.list_nodes()]
        assert len(pair.port.api.list_nodes()) < 3
    finally:
        pair.close()


# -- the variables the port's main now reads ------------------------------------ #

#: Each variable and a value that moves what it sets off its default.
KNOBS = {"TPUSHARE_AUTOSCALE": "active",
         "TPUSHARE_AUTOSCALE_INTERVAL_S": "45.5",
         "TPUSHARE_AUTOSCALE_MIN_NODES": "3",
         "TPUSHARE_AUTOSCALE_MAX_NODES": "9",
         "TPUSHARE_AUTOSCALE_UP_DELAY_S": "12.5",
         "TPUSHARE_AUTOSCALE_DOWN_DELAY_S": "77",
         "TPUSHARE_AUTOSCALE_COOLDOWN_S": "5"}


def _knob_effect(side: dict) -> dict:
    """The autoscale executor's posture, bounds and hysteresis of a stack
    built under the current environment."""
    api = side["fake"]()
    stack, server = side["main"].serve_stack(api)
    try:
        status = stack.controller.autoscale.status()
        return {k: status[k] for k in ("mode", "intervalSeconds", "bounds",
                                       "hysteresis")}
    finally:
        side["main"].shutdown_stack(stack, server)


@pytest.mark.parametrize("name", sorted(KNOBS))
def test_main_reads_each_autoscale_variable(no_cluster, monkeypatch, caplog,
                                            name):
    defaults = [_knob_effect(side) for side in SIDES.values()]
    monkeypatch.setenv(name, KNOBS[name])
    assert name not in tmain.NOT_PORTED and name in tmain.__doc__
    monkeypatch.setenv("TPUSHARE_GC_TUNE", "off")
    with caplog.at_level(logging.WARNING, logger=tmain.log.name):
        tmain.main()
    assert not [r for r in caplog.records if r.name == tmain.log.name
                and r.levelno >= logging.WARNING]
    got = [_knob_effect(side) for side in SIDES.values()]
    assert got[1] == got[0]
    assert got[0] != defaults[0]
