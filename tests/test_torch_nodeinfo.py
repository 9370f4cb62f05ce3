"""The port's per-node ledger (``tpushare_torch/cache/nodeinfo.py``,
``chipinfo.py``) against the JAX package's, on seeded streams.

One stream of operations, drawn from a numpy seed, runs on both ledgers
of one node: pods added with a grant already written (as the informer
delivers them), pods allocated through each side's fake apiserver (one
of them over a 409 and its retry), admission checks, completions and
removals. After every operation the two must agree on the free GiB of
every card, the free cards, the admission summary, ``count_fits`` for
every request shape, the picked cards (or the refusal) and, for an
allocation, every annotation written but the assume time. Host
integers: no tolerance. Admission is checked with preemption nominees
earmarking capacity too. H100 nodes (8 cards of 79 GiB, flat) and ICI
nodes (v5e 2x2x1, v5p 2x2x1, a 2x4 mesh, a heterogeneous host) both run.
"""

from __future__ import annotations

import numpy as np
import pytest

from tpushare.api.objects import Node as JNode, Pod as JPod
from tpushare.cache.nodeinfo import (AllocationError as JAllocationError,
                                     NodeInfo as JNodeInfo)
from tpushare.k8s.builders import make_node, make_pod
from tpushare.k8s.fake import FakeApiServer as JFake
from tpushare_torch.api.objects import Node as TNode, Pod as TPod
from tpushare_torch.cache.nodeinfo import (AllocationError as TAllocationError,
                                           NodeInfo as TNodeInfo)
from tpushare_torch.k8s.fake import FakeApiServer as TFake
from tpushare_torch.utils import const

NODES = {
    "h100": dict(chips=8, hbm_per_chip=79, topology="", tpu_type="h100-80gb"),
    "v5e": dict(chips=4, hbm_per_chip=16, topology="2x2x1"),
    "v5p": dict(chips=4, hbm_per_chip=95, topology="2x2x1", tpu_type="v5p"),
    "mesh2x4": dict(chips=8, hbm_per_chip=16, topology="2x4"),
    "hetero": dict(chip_hbm=[16, 32, 16, 32], topology="2x2"),
}

#: Request shapes: (GiB, whole cards, scoring annotation).
SHAPES = [(g, 0, s) for g in (1, 2, 4, 7, 8, 15, 16, 24, 44, 79)
          for s in ("", "spread")] + [(0, k, "") for k in (1, 2, 3, 4, 8)]

STEPS = 120


class Side:
    """One package's ledger of the node, and its fake apiserver."""

    def __init__(self, fake, node_cls, pod_cls, info_cls, err_cls, raw):
        self.api = fake()
        self.node = self.api.create_node(raw)
        self.Pod = pod_cls
        self.info = info_cls(node_cls(self.node.raw), "binpack")
        self.err = err_cls

    def view(self) -> dict:
        info = self.info
        return {"avail": info.get_available_hbm(),
                "free": info.get_free_chips(),
                "summary": tuple(info.summary()),
                "fits": [info.count_fits(self.Pod(pod_doc(*s)))
                         for s in SHAPES],
                "topology": (info.topology.dims, info.topology.torus)}

    def pick(self, doc):
        try:
            return self.info.pick_chips(self.Pod(doc))
        except self.err as e:
            return ("refused", str(e))


def pod_doc(gib: int, chips: int, scoring: str, name: str = "probe",
            **kw) -> dict:
    ann = dict(kw.pop("annotations", {}))
    if scoring:
        ann[const.ANN_SCORING] = scoring
    return make_pod(name, hbm=gib, chips=chips, annotations=ann, **kw)


def granted(ann: dict) -> dict:
    return {k: v for k, v in ann.items() if k != const.ANN_ASSUME_TIME}


def run_stream(kind: str, seed: int) -> None:
    raw = make_node(f"node-{kind}", **NODES[kind])
    jax = Side(JFake, JNode, JPod, JNodeInfo, JAllocationError, raw)
    port = Side(TFake, TNode, TPod, TNodeInfo, TAllocationError, raw)
    assert port.view() == jax.view()
    rng = np.random.default_rng(seed)
    live: list[str] = []
    for step in range(STEPS):
        op = rng.choice(["add", "allocate", "allocate", "assume",
                         "remove", "complete", "conflict"])
        gib, chips, scoring = SHAPES[int(rng.integers(len(SHAPES)))]
        name = f"p{step}"
        if op == "add" and not chips:
            # A pod the informer delivers with its grant written.
            cid = int(rng.integers(port.info.chip_count))
            doc = pod_doc(gib, 0, scoring, name, uid=f"u{step}",
                          node_name=raw["metadata"]["name"],
                          phase="Running", annotations={
                              const.ANN_CHIP_IDX: str(cid),
                              const.ANN_HBM_POD: str(gib),
                              const.ANN_ASSIGNED: const.ASSIGNED_TRUE})
            for side in (jax, port):
                side.api.create_pod(doc)
                assert side.info.add_or_update_pod(side.Pod(doc))
            live.append(name)
        elif op in ("allocate", "conflict"):
            doc = pod_doc(gib, chips, scoring, name, uid=f"u{step}")
            picks = [side.pick(doc) for side in (jax, port)]
            assert picks[1] == picks[0], (step, doc)
            pods = []
            for side in (jax, port):
                pod = side.api.create_pod(doc)
                if op == "conflict":
                    # The apiserver moved on: the allocate's first write
                    # gets a 409 and retries on the fresh pod.
                    fresh = side.api.get_pod("default", name)
                    fresh.metadata.setdefault("labels", {})["x"] = "y"
                    side.api.update_pod(fresh)
                pods.append(side.Pod(pod.raw))
            outs = []
            for side, pod in zip((jax, port), pods):
                try:
                    outs.append(side.info.allocate(side.api, pod))
                except side.err as e:
                    outs.append(("refused", str(e)))
            if isinstance(outs[0], tuple):
                assert outs[1] == outs[0]
                continue
            assert granted(outs[1].annotations) == granted(
                outs[0].annotations), step
            assert outs[1].node_name == outs[0].node_name
            stored = [side.api.get_pod("default", name) for side in
                      (jax, port)]
            assert granted(stored[1].annotations) == granted(
                stored[0].annotations)
            assert stored[1].node_name == stored[0].node_name
            assert int(stored[1].annotations[const.ANN_ASSUME_TIME]) > 0
            live.append(name)
        elif op == "assume":
            # With pending pods nominated here by a preemption round, of
            # priorities about the probe's: their demand is earmarked.
            doc = pod_doc(gib, chips, scoring, name, uid=f"u{step}",
                          priority=int(rng.integers(3)))
            nominated = [pod_doc(*SHAPES[int(rng.integers(len(SHAPES)))],
                                 f"n{step}-{k}", uid=f"n{step}-{k}",
                                 priority=int(rng.integers(3)))
                         for k in range(int(rng.integers(3)))]
            got = port.info.assume(TPod(doc),
                                   nominated=[TPod(d) for d in nominated])
            want = jax.info.assume(JPod(doc),
                                   nominated=[JPod(d) for d in nominated])
            assert got == want, (step, doc, nominated)
        elif op in ("remove", "complete") and live:
            victim = live.pop(int(rng.integers(len(live))))
            for side in (jax, port):
                pod = side.api.get_pod("default", victim)
                if op == "complete":
                    pod = side.api.update_pod_status("default", victim,
                                                     "Succeeded")
                    side.info.add_or_update_pod(side.Pod(pod.raw))
                else:
                    side.info.remove_pod(side.Pod(pod.raw))
        assert port.view() == jax.view(), (step, op)
        for s in SHAPES:
            assert port.pick(pod_doc(*s)) == jax.pick(pod_doc(*s)), (step, s)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", sorted(NODES))
def test_seeded_stream_matches(kind, seed):
    run_stream(kind, seed)


def test_h100_node_is_flat_and_binpacks_tightest():
    """An H100 node: 8 cards of 79 GiB on a flat topology; a 7 GiB pod
    goes to card 0 of an empty node on both sides, then fills card 0
    before cracking another (tightest fit, fewest free neighbours)."""
    raw = make_node("h100", **NODES["h100"])
    for info in (TNodeInfo(TNode(raw)), JNodeInfo(JNode(raw))):
        assert (info.topology.dims, info.topology.torus) == ((8,), False)
    jax = Side(JFake, JNode, JPod, JNodeInfo, JAllocationError, raw)
    port = Side(TFake, TNode, TPod, TNodeInfo, TAllocationError, raw)
    for i, gib in enumerate((7, 7, 60, 16)):
        doc = pod_doc(gib, 0, "", f"p{i}", uid=f"u{i}")
        chips = []
        for side in (jax, port):
            pod = side.api.create_pod(doc)
            out = side.info.allocate(side.api, side.Pod(pod.raw))
            chips.append(out.annotations[const.ANN_CHIP_IDX])
        assert chips[0] == chips[1]
    assert port.info.get_available_hbm() == jax.info.get_available_hbm()
    assert port.info.get_available_hbm()[0] == 79 - 74
