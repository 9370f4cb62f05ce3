"""Gangs through the port's scheduler extender against the JAX package's,
both whole and over real HTTP.

Each side runs its own ``serve_stack`` (controller, informer, cache, gang
planner, slice placer, verbs, HTTP server) over its own fake apiserver,
fed the same documents; a minimal kube-scheduler drives both alike
(``tests/test_torch_extender_e2e.py``'s ``Pair``). Held equal, byte for
byte: every filter, prioritize and bind response (a member reserved
below quorum answers 500 with "pending quorum" on both), and after each
step every pod's node and annotations and the Events written. The
inspect documents are equal with ``gangs`` in them, each group's
``ttlRemaining`` (a countdown on each side's clock) within a second.
Each attempt's decision trace is equal on both (``Pair.same_decision``:
spans, the planner's notes, outcome), and so are the
``tpushare_bind_errors_total`` counts. The decision trace's ids are
random on each side: compared by presence, and on each side every
Event's ``[trace ...]`` suffix names a decision of its pod, a commit's
its own member's annotation. Left out: the assume time, and the JAX
planner's timeline marks (the timeline comes with its own slice).

The stories are the reference's, each a case of one test:
``tests/test_e2e.py:144`` (commit at quorum); ``test_gang_lifecycle.py``
``:146``, ``:167``, ``:210``, ``:228``, ``:247``, ``:360``, ``:445``,
``:477``, ``:503``; ``test_prioritize.py`` ``:103`` and ``:125``;
``test_topology.py:599`` (members on the elected contiguous hosts);
``:757``'s two gangs electing disjoint blocks, here at bind; a TTL
rollback over HTTP; and a seeded interleaved churn of gangs and lone pods
over 16 H100 nodes.
"""

from __future__ import annotations

import json
import re
import time

import numpy as np
import pytest

from tests.test_torch_extender_e2e import H100, Pair, granted, same_ttl
from tests.torch_obs_reset import fresh_port_obs  # noqa: F401
from tpushare.api.objects import Node as JNode
from tpushare.k8s import events as jevents
from tpushare.routes import metrics as jmetrics
from tpushare.k8s.builders import make_node, make_pod
from tpushare.topology import fleet as jfleet
from tpushare_torch.api.objects import Node as TNode
from tpushare_torch.k8s import events as tevents
from tpushare_torch.routes import metrics as tmetrics
from tpushare_torch.topology import fleet as tfleet
from tpushare_torch.utils import const

V5P = dict(chips=4, hbm_per_chip=95, topology="2x2x1", tpu_type="v5p")


SUFFIX = re.compile(r" \[trace ([^\]]*)\]$")


def _bind_errors() -> tuple[float, float]:
    """Each package's ``tpushare_bind_errors_total`` (process-wide)."""
    return (jmetrics.REGISTRY.get_sample_value(
        "tpushare_bind_errors_total"), tmetrics.BIND_ERRORS.get())


def gang(name: str, minimum: int, **extra) -> dict:
    return {const.ANN_POD_GROUP: name, const.ANN_POD_GROUP_MIN: str(minimum),
            **extra}


class GangPair(Pair):
    """``Pair`` that also holds every pod and the Events equal, and keeps
    each bind's status and body (equal on both sides by ``schedule``)."""

    def __init__(self):
        super().__init__()
        self.bodies = []
        self.errors0 = _bind_errors()
        self.events_seen = [0, 0]
        post = self.port.post

        def recording(path, doc):
            status, body = post(path, doc)
            if path == "/bind":
                self.bodies.append((status, json.loads(body)))
            return status, body
        self.port.post = recording

    def views(self) -> list:
        out = []
        for side in self.sides:
            out.append(sorted((p.key(), granted(p))
                              for p in side.api.list_pods()))
        assert out[1] == out[0]
        return out[0]

    def bind_errors(self) -> float:
        """Failed binds since the pair began, equal on both sides."""
        now = _bind_errors()
        got = [b - a for a, b in zip(self.errors0, now)]
        assert got[1] == got[0], got
        return got[0]

    def events(self) -> list:
        """The Events, equal on both sides with each ``[trace ...]``
        suffix marked; on each side a new Event's suffix names a decision
        of its pod, and a commit's is its member's annotation."""
        assert jevents.flush() and tevents.flush()
        out = []
        for i, side in enumerate(self.sides):
            rows = []
            for n, (ns, e) in enumerate(list(side.api.events)):
                name = e["involvedObject"]["name"]
                m = SUFFIX.search(e["message"])
                if m and n >= self.events_seen[i]:
                    assert side.decision(ns, name, m.group(1)), e
                    if e["reason"] == tevents.REASON_GANG_COMMITTED:
                        assert side.api.get_pod(ns, name).annotations[
                            const.ANN_TRACE_ID] == m.group(1), e
                rows.append((name, e["reason"],
                             SUFFIX.sub(" [trace]", e["message"]),
                             e["type"]))
            self.events_seen[i] = len(side.api.events)
            out.append(sorted(rows))
        assert out[1] == out[0]
        return out[0]

    def step(self, name: str, candidates: list[str] | None = None):
        """Schedule ``name`` on both; then every pod and the Events must
        be equal. Returns (bound, node or detail, the bind's body)."""
        before = len(self.bodies)
        ok, where = self.schedule(name, candidates)
        self.idle()
        self.views()
        self.events()
        return ok, where, self.bodies[before:]

    def gangs(self) -> list:
        self.idle()
        docs = [side.inspect() for side in self.sides]
        same_ttl(docs)
        assert docs[1] == docs[0]
        return docs[0].get("gangs", [])

    def prioritize(self, name: str, candidates: list[str]) -> dict:
        pods = [side.api.get_pod("default", name) for side in self.sides]
        outs = [side.post("/prioritize", {"Pod": pod.raw,
                                          "NodeNames": candidates})
                for side, pod in zip(self.sides, pods)]
        assert outs[1] == outs[0] and outs[0][0] == 200
        return {e["Host"]: e["Score"] for e in json.loads(outs[0][1])}

    def node_of(self, name: str) -> str:
        return self.port.api.get_pod("default", name).node_name


@pytest.fixture
def pair():
    p = GangPair()
    yield p
    p.close()


def _pending(body) -> bool:
    status, doc = body
    return status == 500 and "pending quorum" in doc["Error"]


# -- the stories --------------------------------------------------------- #

def story_commit_at_quorum(pair):
    """test_e2e.py:144: a 2-host gang binds only when both members are
    placeable; the reserved one is a pending gang, not a bind error."""
    for i in range(2):
        pair.create_node(make_node(f"v5p-host-{i}", **V5P))
    ann = gang("train", 2)
    pair.create_pod(make_pod("worker-0", chips=4, annotations=ann))
    ok, _, [body] = pair.step("worker-0")
    assert not ok and _pending(body) and "1/2" in body[1]["Error"]
    assert pair.node_of("worker-0") == ""
    [g] = pair.gangs()
    assert (g["name"], g["reserved"], g["committed"]) == ("train", 1, False)
    assert pair.bind_errors() == 0
    pair.create_pod(make_pod("worker-1", chips=4, annotations=ann))
    ok, _, _ = pair.step("worker-1")
    assert ok
    assert {pair.node_of(f"worker-{i}") for i in range(2)} == {
        "v5p-host-0", "v5p-host-1"}
    assert pair.gangs() == []
    reasons = [e[1] for e in pair.events()]
    assert reasons.count(tevents.REASON_GANG_COMMITTED) == 2
    assert reasons.count(tevents.REASON_GANG_PENDING) == 1


def story_hbm_slice_gang_commits(pair):
    """test_gang_lifecycle.py:146."""
    for i in range(2):
        pair.create_node(make_node(f"host-{i}", **V5P))
    for i in range(2):
        pair.create_pod(make_pod(f"shard-{i}", hbm=44,
                                 annotations=gang("train", 2)))
    assert not pair.step("shard-0", ["host-0"])[0]
    assert pair.same_inspect("host-0")["nodes"][0]["chips"][0][
        "usedHBM"] == 44
    assert pair.step("shard-1", ["host-1"])[0]
    assert [pair.node_of(f"shard-{i}") for i in range(2)] == [
        "host-0", "host-1"]


def story_colocated_members_share_a_node(pair):
    """test_gang_lifecycle.py:167."""
    pair.create_node(make_node("host-0", **V5P))
    for name in ("a", "b"):
        pair.create_pod(make_pod(name, hbm=40, annotations=gang("train", 2)))
    assert not pair.step("a")[0]
    assert pair.step("b")[0]
    assert pair.node_of("a") == pair.node_of("b") == "host-0"


def story_infeasible_gang_never_reserves(pair):
    """test_gang_lifecycle.py:210."""
    for i in range(2):
        pair.create_node(make_node(f"host-{i}", **V5P))
    pair.create_pod(make_pod("w0", chips=4, annotations=gang("big", 4)))
    ok, _, [body] = pair.step("w0")
    assert not ok and "infeasible" in body[1]["Error"]
    assert not _pending(body)
    assert pair.bind_errors() == 1
    assert pair.gangs() == []
    assert const.ANN_CHIP_IDX not in pair.port.api.get_pod(
        "default", "w0").annotations


def story_feasibility_counts_hbm_slices(pair):
    """test_gang_lifecycle.py:228: 8 slices of 44 GiB fit one host, 9
    do not."""
    pair.create_node(make_node("host-0", **V5P))
    pair.create_pod(make_pod("s0", hbm=44, annotations=gang("s", 8)))
    assert _pending(pair.step("s0")[2][0])
    pair.create_pod(make_pod("t0", hbm=44, annotations=gang("t", 9)))
    body = pair.step("t0")[2][0]
    assert "infeasible" in body[1]["Error"]


def story_reserved_members_count_toward_quorum(pair):
    """test_gang_lifecycle.py:247."""
    for i in range(2):
        pair.create_node(make_node(f"host-{i}", **V5P))
    for i in range(2):
        pair.create_pod(make_pod(f"w{i}", chips=4,
                                 annotations=gang("train", 2)))
    assert not pair.step("w0")[0]
    assert pair.step("w1")[0]
    assert {pair.node_of("w0"), pair.node_of("w1")} == {"host-0", "host-1"}


def story_mixed_request_gang_converges(pair):
    """test_gang_lifecycle.py:360: the clone bound refuses the 3-card
    member first; once the slice member reserved, it commits."""
    pair.create_node(make_node("hetero", **V5P))
    ann = gang("mix", 2)
    pair.create_pod(make_pod("big", chips=3, annotations=ann))
    pair.create_pod(make_pod("small", hbm=44, annotations=ann))
    body = pair.step("big")[2][0]
    assert body[0] == 500 and not _pending(body)
    assert _pending(pair.step("small")[2][0])
    assert pair.step("big")[0]
    assert pair.node_of("big") == pair.node_of("small") == "hetero"


def _bound_member(pair, name, node, ann):
    doc = make_pod(name, chips=4, annotations=dict(ann), node_name=node,
                   phase="Running")
    doc["metadata"]["annotations"].update({
        const.ANN_CHIP_IDX: "0,1,2,3", const.ANN_HBM_POD: "380",
        const.ANN_HBM_CHIP: "95", const.ANN_ASSIGNED: const.ASSIGNED_TRUE,
        const.ANN_ASSUME_TIME: "1"})
    pair.create_pod(doc)
    pair.idle()


def story_reset_member_rejoins_running_gang(pair):
    """test_gang_lifecycle.py:445: the bound sibling counts, so the fresh
    member commits at once."""
    for n in ("h0", "h1"):
        pair.create_node(make_node(n, **V5P))
    _bound_member(pair, "w1", "h1", gang("train", 2))
    pair.create_pod(make_pod("w0", chips=4, annotations=gang("train", 2)))
    assert pair.step("w0", ["h0", "h1"])[0]
    assert pair.node_of("w0") == "h0"


def story_quorum_credits_bound_members(pair):
    """test_gang_lifecycle.py:477: one free host, one running member; a
    min=2 gang is feasible."""
    for n in ("h0", "h1"):
        pair.create_node(make_node(n, **V5P))
    _bound_member(pair, "w1", "h1", gang("train", 2))
    pair.create_pod(make_pod("w0", chips=4, annotations=gang("train", 2)))
    assert pair.step("w0")[0] and pair.node_of("w0") == "h0"


def story_replacement_member_rejoins(pair):
    """test_gang_lifecycle.py:503: reaping opted out, a dead member's
    replacement commits against its running sibling."""
    for n in ("h0", "h1"):
        pair.create_node(make_node(n, **V5P))
    ann = gang("train", 2, **{const.ANN_POD_GROUP_REAP: "false"})
    for i in range(2):
        pair.create_pod(make_pod(f"w{i}", chips=4, annotations=ann))
    assert not pair.step("w0", ["h0"])[0]
    assert pair.step("w1", ["h1"])[0]
    pair.delete_pod("w0")
    pair.idle()
    assert pair.node_of("w1") == "h1"  # not reaped
    pair.create_pod(make_pod("w0-new", chips=4, annotations=ann))
    assert pair.step("w0-new")[0]
    assert pair.node_of("w0-new") == "h0"


def story_member_prefers_peer_node(pair):
    """test_prioritize.py:103: the consolidation bonus."""
    for n in ("a", "b"):
        pair.create_node(make_node(n, **V5P))
    ann = gang("g", 2)
    pair.create_pod(make_pod("m0", hbm=20, annotations=ann))
    assert not pair.step("m0", ["a"])[0]
    pair.create_pod(make_pod("m1", hbm=20, annotations=ann))
    scores = pair.prioritize("m1", ["a", "b"])
    assert scores["a"] > scores["b"]
    assert pair.step("m1", ["a", "b"])[0]
    assert pair.node_of("m1") == "a"


def story_member_prefers_member_slice(pair):
    """test_prioritize.py:125: slice affinity, an exact whole-host pack
    included."""
    for name, sid in (("s1-a", "slice-1"), ("s1-b", "slice-1"),
                      ("s2-a", "slice-2")):
        pair.create_node(make_node(name, slice_id=sid, **V5P))
    ann = gang("train", 3)
    pair.create_pod(make_pod("w0", chips=2, annotations=ann))
    assert not pair.step("w0", ["s1-a"])[0]
    pair.create_pod(make_pod("w1", chips=2, annotations=ann))
    pair.create_pod(make_pod("w2", chips=4, annotations=ann))
    for name in ("w1", "w2"):
        scores = pair.prioritize(name, ["s1-b", "s2-a"])
        assert scores["s1-b"] > scores["s2-a"], (name, scores)
    assert not pair.step("w1", ["s1-b", "s2-a"])[0]
    assert pair.port.api.get_pod("default", "w1").annotations[
        const.ANN_CHIP_IDX]


def _slice_hosts(pair, n, slice_topology):
    names = [f"h-{i:02d}" for i in range(n)]
    for i, name in enumerate(names):
        pair.create_node(make_node(name, slice_id="pod-a",
                                   slice_topology=slice_topology,
                                   worker_index=i, **V5P))
    return names


def _ring(pair, names):
    out = []
    for side, node_cls, fleet in ((pair.jax, JNode, jfleet),
                                  (pair.port, TNode, tfleet)):
        nodes = [node_cls(side.api.get_node(
            side.api.get_pod("default", n).node_name).raw) for n in names]
        out.append(fleet.gang_ring_stats(nodes))
    assert out[1] == out[0]
    return out[0]


def _schedule_gang(pair, names, prefix, shape, members=4):
    ann = gang(prefix, members, **{const.ANN_SLICE_SHAPE: shape})
    for i in range(members):
        pair.create_pod(make_pod(f"{prefix}-{i}", chips=4, annotations=ann))
    for i in range(members):
        ok, _, _ = pair.step(f"{prefix}-{i}", names)
        assert ok == (i == members - 1)
    return [f"{prefix}-{i}" for i in range(members)]


def story_members_on_elected_contiguous_hosts(pair):
    """test_topology.py:599: a 4x4x1 gang on a 2x2x2 host grid lands on
    one plane, its ring one hop everywhere."""
    names = _slice_hosts(pair, 8, "4x4x2")
    members = _schedule_gang(pair, names, "w", "4x4x1")
    stats = _ring(pair, members)
    assert stats["contiguity"] == 1.0 and stats["worstHop"] == 1


def story_two_gangs_elect_disjoint_blocks(pair):
    """test_topology.py:757, at bind: the second gang's election reads
    the first's hosts as taken, so the blocks are disjoint and each ring
    is contiguous."""
    names = _slice_hosts(pair, 16, "4x4x4")
    a = _schedule_gang(pair, names, "a", "4x4x1")
    b = _schedule_gang(pair, names, "b", "4x4x1")
    hosts_a = {pair.node_of(n) for n in a}
    hosts_b = {pair.node_of(n) for n in b}
    assert len(hosts_a) == len(hosts_b) == 4 and not hosts_a & hosts_b
    for members in (a, b):
        assert _ring(pair, members)["contiguity"] == 1.0


def story_ttl_rollback_over_http(pair):
    """test_e2e.py:177 through the stacks: a gang whose last member never
    comes is rolled back by expiry, its reservations freed and stripped,
    a Warning Event on each."""
    for i in range(4):
        pair.create_node(make_node(f"h100-{i}", **H100))
    for side in pair.sides:
        side.stack.binder.gang_planner.ttl = 0.3
    for i in range(3):
        pair.create_pod(make_pod(f"r-{i}", hbm=19, annotations=gang("r", 4)))
        assert _pending(pair.step(f"r-{i}")[2][0])
    assert [g["reserved"] for g in pair.gangs()] == [3]
    time.sleep(0.35)
    assert [side.stack.binder.gang_planner.expire_stale()
            for side in pair.sides] == [1, 1]
    assert pair.gangs() == []
    doc = pair.same_inspect()
    assert sum(n["usedHBM"] for n in doc["nodes"]) == 0
    for view in pair.views():
        assert view[1][0] == "" and const.ANN_CHIP_IDX not in view[1][1]
    reasons = [e[1] for e in pair.events()]
    assert reasons.count(tevents.REASON_GANG_EXPIRED) == 3


def story_seeded_churn_of_gangs_and_lone_pods(pair):
    """16 H100 nodes (no topology: slice shapes place unconstrained);
    gangs of 2-4 whole nodes or 19-44 GiB slices, some with a slice
    shape, arriving interleaved with lone pods as a scheduler's queue
    delivers them; members retried until their gang commits; gangs and
    pods finishing. Every answer equal; every gang bound all or none."""
    nodes = [f"h100-{i:02d}" for i in range(16)]
    for n in nodes:
        pair.create_node(make_node(n, **H100))
    rng = np.random.default_rng(23)
    queue, live, gangs, seq = [], [], {}, 0
    for rnd in range(6):
        for name in [n for n, end in live if end <= rnd]:
            pair.set_phase(name, "Succeeded")
        live = [(n, end) for n, end in live if end > rnd]
        pair.idle()
        arrivals = []
        for g in range(2):
            size = int(rng.integers(2, 5))
            gname = f"g{rnd}{g}"
            whole = rng.random() < 0.4
            extra = ({const.ANN_SLICE_SHAPE: "2x2x1"}
                     if rng.random() < 0.3 else {})
            members = [f"{gname}-{i}" for i in range(size)]
            for m in members:
                pair.create_pod(make_pod(
                    m, chips=8 if whole else 0,
                    hbm=0 if whole else int(rng.choice([19, 24, 44])),
                    annotations=gang(gname, size, **extra)))
            gangs[gname] = members
            arrivals += members
        for _ in range(6):
            name = f"lone-{seq:03d}"
            seq += 1
            pair.create_pod(make_pod(name, hbm=int(rng.choice([7, 16, 44]))))
            arrivals.append(name)
        rng.shuffle(arrivals)
        queue += arrivals
        kept = []
        for name in queue:
            ok, _, _ = pair.step(name, nodes)
            if ok:
                live.append((name, rnd + int(rng.integers(1, 4))))
            elif not pair.node_of(name):
                kept.append(name)
        queue = kept
        pair.gangs()
        for gname, members in gangs.items():
            placed = [bool(pair.node_of(m)) for m in members
                      if pair.port.api.get_pod("default", m).phase
                      != "Succeeded"]
            assert all(placed) or not any(placed), (gname, placed)
    committed = sum(all(pair.node_of(m) for m in ms)
                    for ms in gangs.values())
    assert committed >= 4, committed
    pair.same_rebuilt_cache()


STORIES = [story_commit_at_quorum, story_hbm_slice_gang_commits,
           story_colocated_members_share_a_node,
           story_infeasible_gang_never_reserves,
           story_feasibility_counts_hbm_slices,
           story_reserved_members_count_toward_quorum,
           story_mixed_request_gang_converges,
           story_reset_member_rejoins_running_gang,
           story_quorum_credits_bound_members,
           story_replacement_member_rejoins,
           story_member_prefers_peer_node,
           story_member_prefers_member_slice,
           story_members_on_elected_contiguous_hosts,
           story_two_gangs_elect_disjoint_blocks,
           story_ttl_rollback_over_http,
           story_seeded_churn_of_gangs_and_lone_pods]


@pytest.mark.parametrize("story", STORIES, ids=[s.__name__[6:]
                                                for s in STORIES])
def test_gang_story(pair, story):
    story(pair)
    pair.same_inspect()
    pair.views()
    pair.events()
