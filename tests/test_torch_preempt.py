"""The port's preempt verb (``tpushare_torch/scheduler/preempt.py``)
against the JAX package's.

Two parts:

* The reference's stories, unchanged, over the port's modules: every case
  of ``tests/test_preempt.py`` (wire types, victim selection, gang-aware
  costing, the greedy fallback, the HTTP route, the PDB recount) and of
  ``tests/test_gang_preempt.py`` (preemptable capacity, quorum over a
  saturated fleet, nominated-demand accounting, a priority gang of four
  preempting its way in), loaded by ``tests/torch_reference_stories.py``.
* Both ``serve_stack``s over HTTP, fed the same documents
  (``tests/test_torch_extender_e2e.py``'s ``Pair``): a seeded fleet of
  H100 and small nodes filled by the scheduler's verbs with residents of
  mixed priority, tenant, size and gang, a PodDisruptionBudget, and in
  half the seeds a quota ConfigMap; then preemptors of every priority
  POST ``/preempt`` in each wire form (legacy and camelCase keys, uid and
  full-pod victims, with and without the scheduler's own nominations).
  Each answer must be the same bytes on both; then the first preemptor's
  victims are evicted and it is scheduled on both, with the same ledger.
"""

from __future__ import annotations

import json
import time
import urllib.request

import numpy as np
import pytest

from tests import torch_reference_stories as R
from tests.test_torch_extender_e2e import H100, Pair
from tests.torch_obs_reset import fresh_port_obs  # noqa: F401
from tpushare.k8s.builders import make_node, make_pod
from tpushare_torch.k8s.fake import FakeApiServer
from tpushare_torch.utils import const

_PREEMPT = R.load("test_preempt")
_GANG = R.load("test_gang_preempt")

globals().update(R.pick(_PREEMPT, [
    "TestWireTypes", "TestVictimSelection", "TestGangAwareCosting",
    "TestGreedyFallback", "TestPreemptHTTP", "TestPDBRecount"]))
globals().update({f"TestGang{name[4:]}": cls for name, cls in R.pick(_GANG, [
    "TestCountFitsPreemptable", "TestQuorumOverSaturatedFleet",
    "TestNominatedAccounting", "TestGangPreemptsItsWayIn"]).items()})


@pytest.fixture
def api():
    """The reference's stories run over the port's fake apiserver."""
    return FakeApiServer()


# -- both stacks over HTTP ------------------------------------------------ #

SMALL = dict(chips=4, hbm_per_chip=16, topology="2x2x1", tpu_type="v5e")
PDB = {"metadata": {"name": "web-budget", "namespace": "team-a"},
       "spec": {"selector": {"matchLabels": {"app": "web"}}},
       "status": {"disruptionsAllowed": 0}}


def quota_cm(entries: dict) -> dict:
    return {"metadata": {"name": const.QUOTA_CONFIGMAP,
                         "namespace": "kube-system"},
            "data": {t: json.dumps(s) for t, s in entries.items()}}


def wait_quota(pair: Pair, tenants: set[str]) -> None:
    """Both controllers hold a quota table naming ``tenants``."""
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if all(tenants <= {t["tenant"] for t in
                           side.stack.controller.quota.snapshot()}
               for side in pair.sides):
            return
        time.sleep(0.02)
    raise AssertionError("quota ConfigMap never applied")


def debug_quota(side) -> bytes:
    with urllib.request.urlopen(f"{side.base}/debug/quota",
                                timeout=60) as resp:
        return resp.read()


def fill(pair: Pair, rng, nodes: list[str]) -> list[str]:
    """Sixty arrivals placed through the verbs on both sides (lone pods
    and gangs of two, where they fit); returns their names."""
    names = []
    for i in range(60):
        kind = rng.choice(["hbm", "hbm", "chips", "gang"])
        ns = str(rng.choice(["team-a", "team-b"]))
        prio = int(rng.choice([0, 0, 5, 10]))
        labels = {"app": str(rng.choice(["web", "batch"]))}
        if kind == "gang":
            ann = {const.ANN_POD_GROUP: f"g{i}", const.ANN_POD_GROUP_MIN: "2"}
            members = [f"r{i}-{k}" for k in range(2)]
            for m in members:
                pair.create_pod(make_pod(m, chips=4, namespace=ns,
                                         priority=prio, labels=labels,
                                         annotations=ann))
            for m in members:
                pair.schedule(m, nodes, namespace=ns)
            names += members
            continue
        name = f"r{i}"
        if kind == "hbm":
            doc = make_pod(name, hbm=int(rng.choice([8, 16, 24, 40])),
                           namespace=ns, priority=prio, labels=labels)
        else:
            doc = make_pod(name, chips=int(rng.choice([1, 2, 4])),
                           namespace=ns, priority=prio, labels=labels)
        pair.create_pod(doc)
        pair.schedule(name, nodes, namespace=ns)
        names.append(name)
    pair.idle()
    return names


def preempt_doc(pair: Pair, pod_doc: dict, nodes: list[str], rng,
                residents: list) -> dict:
    """A scheduler's /preempt body in a form the seed picks."""
    form = int(rng.integers(4))
    victims = {}
    for n in nodes:
        on = [p for p in residents if p.node_name == n]
        nominated = ([p for p in on if rng.random() < 0.3]
                     if form >= 2 else [])
        if form == 3:
            victims[n] = {"pods": [p.raw for p in nominated],
                          "numPDBViolations": int(rng.integers(2))}
        else:
            victims[n] = {"Pods": [{"UID": p.uid} for p in nominated],
                          "NumPDBViolations": int(rng.integers(2))}
    if form == 3:
        return {"pod": pod_doc, "nodeNameToVictims": victims}
    if form == 1:
        return {"pod": pod_doc, "nodeNameToMetaVictims": victims}
    return {"Pod": pod_doc, "NodeNameToMetaVictims": victims}


@pytest.mark.parametrize("seed", range(6))
def test_preempt_answers_byte_for_byte(seed):
    rng = np.random.default_rng(seed)
    pair = Pair()
    try:
        nodes = []
        for i in range(4):
            pair.create_node(make_node(f"h100-{i}", **H100))
            nodes.append(f"h100-{i}")
        for i in range(3):
            pair.create_node(make_node(f"small-{i}", **SMALL))
            nodes.append(f"small-{i}")
        if seed % 2:
            for side in pair.sides:
                side.api.create_configmap(quota_cm({
                    "team-a": {"guaranteeHBM": 200, "guaranteeChips": 8},
                    "team-b": {"guaranteeHBM": 40, "guaranteeChips": 2,
                               "limitHBM": 2000},
                }))
            wait_quota(pair, {"team-a", "team-b"})
        for side in pair.sides:
            pdb = dict(PDB, status={"disruptionsAllowed":
                                    int(seed % 3 == 0)})
            side.api.create_pdb(pdb)
        fill(pair, rng, nodes)
        residents = [p for p in pair.port.api.list_pods() if p.node_name]
        assert residents
        answers = []
        for j in range(8):
            ns = str(rng.choice(["team-a", "team-b"]))
            if rng.random() < 0.6:
                doc = make_pod(f"pre{j}", hbm=int(rng.choice([16, 40, 79])),
                               namespace=ns,
                               priority=int(rng.choice([0, 5, 10, 20])))
            else:
                doc = make_pod(f"pre{j}", chips=int(rng.choice([1, 4, 8])),
                               namespace=ns,
                               priority=int(rng.choice([5, 10, 20])))
            doc = pair.create_pod(doc)
            body = preempt_doc(pair, doc, nodes, rng, residents)
            outs = [side.post("/preempt", body) for side in pair.sides]
            assert outs[1] == outs[0], (seed, j, outs)
            assert outs[0][0] == 200
            answers.append(json.loads(outs[0][1])["NodeNameToMetaVictims"])
        assert any(answers), "no preemptor was offered a victim"
        if seed % 2:
            docs = [debug_quota(side) for side in pair.sides]
            assert docs[1] == docs[0]
        # Evict the first offered plan's victims and place its preemptor.
        j, victims = next((j, v) for j, v in enumerate(answers) if v)
        node = sorted(victims)[0]
        uids = {p["UID"] for p in victims[node]["Pods"]}
        name = f"pre{j}"
        pre = pair.port.api.list_pods()
        gone = [p for p in pre if p.uid in uids]
        for side in pair.sides:
            for p in gone:
                side.api.delete_pod(p.namespace, p.name)
        pair.idle()
        ns = next(p.namespace for p in pre if p.name == name)
        bound, where = pair.schedule(name, [node], namespace=ns)
        assert bound, where
        pair.same_inspect()
    finally:
        pair.close()
