"""The port's scheduler extender against the JAX package's, both whole
and over real HTTP.

Each side runs its own ``serve_stack`` (controller, informer, cache,
verbs, HTTP server) over its own fake apiserver, and both are fed the
same documents: nodes, and pods with the same uids. A minimal
kube-scheduler drives both alike: filter, then prioritize over the nodes
that passed, then bind to the first of the best scores. For every pod
the two must give the same filter response (``NodeNames`` and
``FailedNodes``, byte for byte), the same prioritize scores (byte for
byte), the same bind status, and leave the same node, cards and
annotations in the apiserver (the assume time aside; the decision
trace's ids, random on each side, by presence). After each attempt the
pod's ``/debug/trace`` document is the same on both, clocks and ids
aside (``normal_trace``), and on each side the bound pod's ``trace-id``
annotation, the bind reply's ``traceparent`` and ``/debug/trace`` name
one decision. At the end the inspect documents are equal, after deletes
too, a cache rebuilt from each apiserver equals the live ledger of both,
and ``/debug/flight`` lists the same decisions in the same order.

The traffic: one seeded churn of ``bench.py``'s ``SIZE_MIX`` (16, 24
and 44 GiB slices and whole 4-card pods, TTLs of 2-5 rounds) over 16 H100
nodes (8 cards of 79 GiB, no topology), with one gang of three 24 GiB
members among its pods; the same churn over three tenants under a
``tpushare-quotas`` ConfigMap (limits that refuse pods mid-churn,
guarantees that bias the scores), with ``/debug/quota`` equal after every
round; and the single-pod stories of ``tests/test_e2e.py``. Both stacks
wire the gang planner, the quota ledger, the timeline, the pod journeys
and the defrag executor (dry-run, its first tick a minute away); a
gang's ``ttlRemaining`` in inspect is a clock, held within a second
across the two. The JAX stack also wires the autoscaler, which changes
no answer and no decision document.
``tests/test_torch_gang_e2e.py`` holds the gang stories,
``tests/test_torch_quota.py`` the quota stories.
"""

from __future__ import annotations

import json
import random
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from tests.torch_obs_reset import fresh_port_obs  # noqa: F401
from tpushare.api.extender import (ExtenderArgs as JArgs,
                                   ExtenderFilterResult as JFilterResult,
                                   HostPriority as JHostPriority)
from tpushare.cache.cache import SchedulerCache as JCache
from tpushare.cmd import main as jmain
from tpushare.k8s.builders import make_node, make_pod
from tpushare.k8s.fake import FakeApiServer as JFake
from tpushare import slo as jslo
from tpushare import trace as jtrace
from tpushare.routes import wire as jwire
from tpushare_torch.api.extender import (ExtenderArgs as TArgs,
                                         ExtenderFilterResult as TFilterResult,
                                         HostPriority as THostPriority)
from tpushare_torch.cache.cache import SchedulerCache as TCache
from tpushare_torch import slo as tslo
from tpushare_torch import trace as ttrace
from tpushare_torch.cmd import main as tmain
from tpushare_torch.k8s.fake import FakeApiServer as TFake
from tpushare_torch.routes import server as tserver
from tpushare_torch.routes import wire as twire
from tpushare_torch.utils import const
from tpushare_torch.utils import pod as podutils

PREFIX = "/tpushare-scheduler"

#: A copy of bench.py's SIZE_MIX and its scale TTLs.
SIZE_MIX = [("hbm", 16, 20), ("hbm", 24, 15), ("hbm", 44, 20),
            ("chip", 4, 45)]
TTL_ROUNDS = (2, 5)
#: Arrivals a round: more than the 16 nodes hold, so pods wait in the
#: backlog and filter refuses some on every node.
ARRIVALS = 24
H100 = dict(chips=8, hbm_per_chip=79, topology="", tpu_type="h100-80gb")


class Side:
    """One package's extender over HTTP on its own fake apiserver.
    ``trace`` is the package's decision recorder."""

    def __init__(self, fake, main, trace):
        self.api = fake()
        self.main = main
        self.trace = trace
        self.stack, self.server = main.serve_stack(self.api)
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"
        #: The last POST's response headers.
        self.headers: dict = {}

    def post(self, path: str, doc: dict) -> tuple[int, bytes]:
        req = urllib.request.Request(
            f"{self.base}{PREFIX}{path}", data=json.dumps(doc).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                self.headers = dict(resp.headers)
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            self.headers = dict(e.headers)
            return e.code, e.read()

    def get(self, path: str) -> tuple[int, bytes]:
        """GET a path of the server's root (not the verbs' prefix)."""
        try:
            with urllib.request.urlopen(f"{self.base}{path}",
                                        timeout=60) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def decision(self, namespace: str, name: str,
                 trace_id: str = "") -> dict | None:
        """``/debug/trace/<ns>/<pod>[?id=]``, or None on a 404."""
        query = f"?id={trace_id}" if trace_id else ""
        status, body = self.get(f"/debug/trace/{namespace}/{name}{query}")
        assert status in (200, 404), (status, body)
        return json.loads(body) if status == 200 else None

    def flight(self) -> list[dict]:
        status, body = self.get("/debug/flight")
        assert status == 200, body
        doc = json.loads(body)
        assert doc["recordingDrops"] == 0
        return doc["decisions"]

    def inspect(self, node: str | None = None) -> dict:
        path = f"{self.base}{PREFIX}/inspect" + (f"/{node}" if node else "")
        with urllib.request.urlopen(path, timeout=60) as resp:
            return json.loads(resp.read())

    def idle(self) -> None:
        assert self.stack.controller.wait_idle(timeout=60)

    def close(self) -> None:
        self.main.shutdown_stack(self.stack, self.server)


#: The anomaly rule over the stranded GiB fires on a sampler tick that
#: finds the fleet stranding more than 64 GiB. Both stacks feed it (the
#: defrag executor's frag index), and each side's sampler ticks on its
#: own clock, so whether a tick lands while the traffic strands that much
#: differs between the two: its firings (markers, Events, counts) are not
#: compared.
TIMED_RULES = ("stranded-hbm-high",)


def timed_anomaly(event: dict) -> bool:
    """An Event of an anomaly rule in ``TIMED_RULES``."""
    return event["reason"] == "TPUShareAnomaly" and any(
        event["message"].startswith(f"anomaly {rule}:")
        for rule in TIMED_RULES)


#: Annotations whose values the two sides cannot share: the assume time
#: (a clock) is left out.
UNCOMPARED = (const.ANN_ASSUME_TIME,)
#: The decision trace's ids, random on each side: compared by presence,
#: and held on each side to that side's own ``/debug/trace``.
RANDOM_IDS = (const.ANN_TRACE_ID, const.ANN_TRACE_PARENT)


def normal_trace(doc: dict | None) -> dict | None:
    """A ``/debug/trace`` document less what differs between two runs of
    the same traffic: the ids, the start time and every clock
    (``seconds`` and each ``*Seconds``). ``worstLockSite`` is lock-wait
    attribution: which lock a span waited on, if any, depends on how the
    two sides' threads interleave, so it is left out (and a span's
    ``attrs`` with it when nothing else is left)."""
    if doc is None:
        return None
    out = {k: v for k, v in doc.items()
           if k not in ("traceId", "parentId", "startedAt")
           and not k.lower().endswith("seconds")}
    out["spans"] = []
    for span in doc["spans"]:
        sp = {k: v for k, v in span.items()
              if not k.lower().endswith("seconds")}
        if "attrs" in sp:
            sp["attrs"] = {k: v for k, v in sp["attrs"].items()
                           if k != "worstLockSite"}
            if not sp["attrs"]:
                del sp["attrs"]
        out["spans"].append(sp)
    return out


def flight_order(side: "Side") -> list[tuple[str, str, str]]:
    return [(d["namespace"], d["name"], d["outcome"])
            for d in side.flight()]


def same_ttl(docs: list[dict]) -> None:
    """A gang's ``ttlRemaining`` counts down on each side's clock: hold
    the two within a second, then take the reference's."""
    gangs = [doc.get("gangs", []) for doc in docs]
    assert [len(g) for g in gangs] == [len(gangs[0])] * len(gangs)
    for want, got in zip(gangs[0], gangs[1]):
        a, b = want.get("ttlRemaining"), got.get("ttlRemaining")
        assert (a is None) == (b is None), (want, got)
        if a is not None:
            assert abs(a - b) <= 1.0, (want, got)
            got["ttlRemaining"] = a


def granted(pod) -> tuple:
    ann = {k: "<id>" if k in RANDOM_IDS else v
           for k, v in pod.annotations.items() if k not in UNCOMPARED}
    return pod.node_name, ann


class Pair:
    """The JAX side and the port's, driven alike and compared."""

    def __init__(self):
        # Each package's recorder and SLO tracker are process singletons:
        # start both empty, so the flight rings hold this pair's decisions
        # alone and the journeys and SLO windows its pods alone.
        jtrace.reset()
        ttrace.reset()
        jslo.reset()
        tslo.reset()
        self.jax = Side(JFake, jmain, jtrace)
        self.port = Side(TFake, tmain, ttrace)
        self.sides = (self.jax, self.port)
        self.uids = 0

    def close(self):
        for side in self.sides:
            side.close()

    def create_node(self, doc: dict) -> None:
        for side in self.sides:
            side.api.create_node(doc)

    def create_pod(self, doc: dict) -> dict:
        self.uids += 1
        doc = json.loads(json.dumps(doc))
        doc["metadata"].setdefault("uid", f"uid-{self.uids}")
        for side in self.sides:
            side.api.create_pod(doc)
        return doc

    def schedule(self, name: str, candidates: list[str] | None = None,
                 namespace: str = "default") -> tuple[bool, object]:
        """filter, prioritize, bind on both; every response compared.
        Returns (bound, node or the filter's FailedNodes)."""
        pods = [side.api.get_pod(namespace, name) for side in self.sides]
        names = candidates or [n.name for n in self.jax.api.list_nodes()]
        outs = [side.post("/filter", {"Pod": pod.raw, "NodeNames": names})
                for side, pod in zip(self.sides, pods)]
        assert outs[1] == outs[0], (name, outs)
        status, body = outs[0]
        assert status == 200, body
        result = json.loads(body)
        passing = result["NodeNames"] or []
        if not passing:
            self.same_decision(namespace, name)
            return False, result["FailedNodes"]
        outs = [side.post("/prioritize", {"Pod": pod.raw,
                                          "NodeNames": passing})
                for side, pod in zip(self.sides, pods)]
        assert outs[1] == outs[0], (name, outs)
        assert outs[0][0] == 200
        ranked = json.loads(outs[0][1])
        best = max(ranked, key=lambda e: e["Score"])["Host"]
        outs = [side.post("/bind", {"PodName": name,
                                    "PodNamespace": namespace,
                                    "PodUID": pod.uid, "Node": best})
                for side, pod in zip(self.sides, pods)]
        assert outs[1] == outs[0], (name, outs)
        after = [granted(side.api.get_pod(namespace, name))
                 for side in self.sides]
        assert after[1] == after[0], name
        docs = self.same_decision(namespace, name)
        for side, doc in zip(self.sides, docs):
            # The bind's decision is the pod's newest, and its reply names
            # it; a lone pod's grant carries its id.
            assert side.headers["traceparent"] == \
                side.trace.format_traceparent(doc["traceId"])
            pod = side.api.get_pod(namespace, name)
            if (outs[0][0] == 200
                    and const.ANN_POD_GROUP not in pod.annotations):
                assert pod.annotations[const.ANN_TRACE_ID] == \
                    doc["traceId"], name
        return outs[0][0] == 200, best

    def same_decision(self, namespace: str, name: str) -> list:
        """The pod's newest decision on each side: equal but for clocks
        and ids. Returns the two documents."""
        docs = [side.decision(namespace, name) for side in self.sides]
        assert normal_trace(docs[1]) == normal_trace(docs[0]), (name, docs)
        return docs

    def same_flight(self) -> list:
        """``/debug/flight`` lists the same decisions in the same order
        on both sides."""
        orders = [flight_order(side) for side in self.sides]
        assert orders[1] == orders[0]
        return orders[0]

    def set_phase(self, name: str, phase: str,
                  namespace: str = "default") -> None:
        for side in self.sides:
            side.api.update_pod_status(namespace, name, phase)

    def delete_pod(self, name: str) -> None:
        for side in self.sides:
            side.api.delete_pod("default", name)

    def idle(self) -> None:
        for side in self.sides:
            side.idle()

    def same_inspect(self, node: str | None = None) -> dict:
        self.idle()
        docs = [side.inspect(node) for side in self.sides]
        same_ttl(docs)
        assert docs[1] == docs[0]
        return docs[0]

    def same_rebuilt_cache(self) -> None:
        """A cache rebuilt from each apiserver (as after a restart)
        equals the live ledger, on both sides."""
        self.idle()
        views = []
        for side, cache_cls in zip(self.sides, (JCache, TCache)):
            live = side.stack.controller.cache
            rebuilt = cache_cls(side.api.get_node, side.api.list_pods)
            rebuilt.build()
            names = sorted(n.name for n in side.api.list_nodes())
            view = {n: rebuilt.get_node_info(n).get_available_hbm()
                    for n in names}
            assert view == {n: live.get_node_info(n).get_available_hbm()
                            for n in names}
            views.append(view)
        assert views[1] == views[0]


@pytest.fixture
def pair():
    p = Pair()
    yield p
    p.close()


def _draw_shape(rng: random.Random) -> tuple[str, int]:
    """bench.py's ``_draw_shape`` over the copy of its SIZE_MIX."""
    total = sum(w for _, _, w in SIZE_MIX)
    roll = rng.uniform(0, total)
    for kind, size, w in SIZE_MIX:
        roll -= w
        if roll <= 0:
            return kind, size
    return SIZE_MIX[-1][0], SIZE_MIX[-1][1]


def test_seeded_churn_on_h100_nodes(pair):
    nodes = [f"h100-{i:02d}" for i in range(16)]
    for n in nodes:
        pair.create_node(make_node(n, **H100))
    rng = random.Random(11)
    backlog, live, bound, seq = [], [], 0, 0
    for rnd in range(10):
        still = []
        for rec in live:
            if rec["expires"] <= rnd:
                pair.set_phase(rec["name"], "Succeeded")
            else:
                still.append(rec)
        live = still
        pair.idle()
        if rnd == 2:
            # A gang of three 24 GiB members, reserved below quorum and
            # committed by its third member.
            for i in range(3):
                name = f"gang-{i}"
                pair.create_pod(make_pod(name, hbm=24, annotations={
                    const.ANN_POD_GROUP: "churn-gang",
                    const.ANN_POD_GROUP_MIN: "3"}))
                backlog.append((name, 5))
        for _ in range(ARRIVALS):
            kind, size = _draw_shape(rng)
            name = f"sp-{seq:04d}"
            seq += 1
            pair.create_pod(make_pod(name, chips=size) if kind == "chip"
                            else make_pod(name, hbm=size))
            backlog.append((name, rng.randint(*TTL_ROUNDS)))
        kept = []
        for name, ttl in backlog:
            ok, where = pair.schedule(name, nodes)
            if not ok:
                kept.append((name, ttl))
                continue
            bound += 1
            live.append({"name": name, "expires": rnd + ttl})
        backlog = kept
        doc = pair.same_inspect()
        for node in doc["nodes"]:
            assert all(c["usedHBM"] <= c["totalHBM"] for c in node["chips"])
    assert bound >= 60 and backlog, (bound, len(backlog))
    gang = [pair.port.api.get_pod("default", f"gang-{i}") for i in range(3)]
    assert all(p.node_name for p in gang), "the gang never committed"
    # The demand the filter found unplaceable everywhere (pods, GiB,
    # cards), pruned against each informer's view: equal.
    demand = [side.stack.predicate.demand.snapshot() for side in pair.sides]
    assert demand[1] == demand[0] and demand[0][0] > 0
    # The last 256 decisions, in order, with their outcomes.
    flight = pair.same_flight()
    assert len(flight) == jtrace.DEFAULT_CAPACITY
    assert {o for _, _, o in flight} >= {"bound", "unschedulable"}
    # Deletes: bound and pending pods alike.
    for rec in live[::2]:
        pair.delete_pod(rec["name"])
    for name, _ in backlog[::2]:
        pair.delete_pod(name)
    pair.same_inspect()
    pair.same_rebuilt_cache()


def test_seeded_churn_under_a_quota_configmap(pair):
    """bench.py's churn over three tenants: team-a limited to 400 GiB and
    24 cards with a guarantee of 200 GiB and 8 cards, team-b guaranteed
    100 GiB, everyone else limited by the default to 300 GiB and 16
    cards. Every verb's answer, every pod and the quota snapshot equal;
    the snapshot's usage is the ledger's."""
    nodes = [f"h100-{i:02d}" for i in range(8)]
    for n in nodes:
        pair.create_node(make_node(n, **H100))
    data = {"team-a": {"guaranteeHBM": 200, "limitHBM": 400,
                       "guaranteeChips": 8, "limitChips": 24},
            "team-b": {"guaranteeHBM": 100},
            "*": {"limitHBM": 300, "limitChips": 16}}
    for side in pair.sides:
        side.api.create_configmap({
            "metadata": {"name": const.QUOTA_CONFIGMAP,
                         "namespace": "kube-system"},
            "data": {k: json.dumps(v) for k, v in data.items()}})
    deadline = time.monotonic() + 10
    while not all(side.stack.controller.quota.config_for(
            "team-a").limit_hbm == 400 for side in pair.sides):
        assert time.monotonic() < deadline, "quota never applied"
        time.sleep(0.02)
    rng = random.Random(23)
    backlog, live, seq, denied = [], [], 0, 0
    for rnd in range(8):
        still = []
        for rec in live:
            if rec["expires"] <= rnd:
                pair.set_phase(rec["name"], "Succeeded", rec["ns"])
            else:
                still.append(rec)
        live = still
        pair.idle()
        for _ in range(16):
            kind, size = _draw_shape(rng)
            ns = rng.choice(["team-a", "team-b", "team-c"])
            name = f"q-{seq:04d}"
            seq += 1
            pair.create_pod(make_pod(name, chips=size, namespace=ns)
                            if kind == "chip"
                            else make_pod(name, hbm=size, namespace=ns))
            backlog.append((name, ns, rng.randint(*TTL_ROUNDS)))
        kept = []
        for name, ns, ttl in backlog:
            ok, where = pair.schedule(name, nodes, namespace=ns)
            if not ok:
                denied += any(str(r).startswith("quota:")
                              for r in dict(where).values())
                kept.append((name, ns, ttl))
                continue
            live.append({"name": name, "ns": ns, "expires": rnd + ttl})
        backlog = kept
        pair.same_inspect()
        docs = []
        for side in pair.sides:
            with urllib.request.urlopen(f"{side.base}/debug/quota",
                                        timeout=60) as resp:
                docs.append(resp.read())
        assert docs[1] == docs[0]
    assert denied, "no pod met its tenant's limit"
    usage: dict = {}
    for p in pair.port.api.list_pods():
        if p.node_name and p.phase != "Succeeded":
            cards = len(p.annotations[const.ANN_CHIP_IDX].split(","))
            if podutils.get_chips_from_pod_resource(p) > 0:
                hbm = 0
            else:
                hbm, cards = int(p.annotations[const.ANN_HBM_POD]), 0
            h, c, n = usage.get(p.namespace, (0, 0, 0))
            usage[p.namespace] = (h + hbm, c + cards, n + 1)
    snap = {t["tenant"]: (t["usedHBM"], t["usedChips"], t["pods"])
            for t in json.loads(docs[0])["tenants"] if t["pods"]}
    assert snap == usage
    pair.same_rebuilt_cache()


# -- the single-pod stories of tests/test_e2e.py --------------------------- #

def story_binpack_demo(pair):
    pair.create_node(make_node("v5e-0"))
    for name in ("binpack-1", "binpack-2", "binpack-3"):
        pair.create_pod(make_pod(name, hbm=2))
        assert pair.schedule(name)[0]
    chips = pair.same_inspect("v5e-0")["nodes"][0]["chips"]
    assert [c["usedHBM"] for c in chips] == [6, 0, 0, 0]


def story_oversized_pod_rejected(pair):
    pair.create_node(make_node("v5e-0"))
    pair.create_pod(make_pod("huge", hbm=16276))
    ok, detail = pair.schedule("huge")
    assert not ok and "v5e-0" in detail


def story_four_replicas_two_chips(pair):
    pair.create_node(make_node("v5e-0", chips=2, hbm_per_chip=16,
                               topology="2x1"))
    for i in range(4):
        pair.create_pod(make_pod(f"replica-{i}", hbm=8))
        assert pair.schedule(f"replica-{i}")[0]
    doc = pair.same_inspect("v5e-0")
    assert [c["usedHBM"] for c in doc["nodes"][0]["chips"]] == [16, 16]


def story_v5p_north_star_packing(pair):
    pair.create_node(make_node("v5p-0", chips=4, hbm_per_chip=95,
                               topology="2x2x1", tpu_type="v5p"))
    for i in range(8):
        pair.create_pod(make_pod(f"infer-{i}", hbm=44))
        assert pair.schedule(f"infer-{i}")[0]
    node = pair.same_inspect("v5p-0")["nodes"][0]
    assert all(c["usedHBM"] == 88 for c in node["chips"])


def story_multi_node_spillover(pair):
    for n in ("v5e-0", "v5e-1"):
        pair.create_node(make_node(n, chips=1, hbm_per_chip=16,
                                   topology="1"))
    where = []
    for i in range(2):
        pair.create_pod(make_pod(f"p{i}", hbm=16))
        ok, node = pair.schedule(f"p{i}")
        assert ok
        where.append(node)
    assert sorted(where) == ["v5e-0", "v5e-1"]


def story_h100_tenant(pair):
    """An H100 node as the port's daemon annotates it (no topology): a
    7 GiB tenant, then a spread one, then whole cards."""
    pair.create_node(make_node("h100-0", **H100))
    pair.create_pod(make_pod("llm", hbm=7))
    assert pair.schedule("llm") == (True, "h100-0")
    pair.create_pod(make_pod("decode", hbm=7, annotations={
        const.ANN_SCORING: "spread"}))
    assert pair.schedule("decode")[0]
    pair.create_pod(make_pod("trainer", chips=4))
    assert pair.schedule("trainer")[0]
    chips = pair.same_inspect("h100-0")["nodes"][0]["chips"]
    assert [c["usedHBM"] for c in chips][:2] == [7, 7]
    assert sum(c["usedHBM"] == 79 for c in chips) == 4


def story_nominated_pod_earmarks_a_card(pair):
    """A pending pod that a preemption round nominated to a node holds
    its demand there: a lower-priority pod that would take the last card
    is refused until the nominee binds, then the nominee binds."""
    pair.create_node(make_node("v5e-0"))
    doc = make_pod("nominee", hbm=16, priority=10)
    doc["status"]["nominatedNodeName"] = "v5e-0"
    pair.create_pod(doc)
    for i in range(3):
        pair.create_pod(make_pod(f"low-{i}", hbm=16))
        pair.idle()
        assert pair.schedule(f"low-{i}")[0]
    pair.create_pod(make_pod("late", hbm=16))
    pair.idle()
    ok, detail = pair.schedule("late")
    assert not ok and "v5e-0" in detail
    assert pair.schedule("nominee") == (True, "v5e-0")


STORIES = [story_binpack_demo, story_oversized_pod_rejected,
           story_four_replicas_two_chips, story_v5p_north_star_packing,
           story_multi_node_spillover, story_h100_tenant,
           story_nominated_pod_earmarks_a_card]


@pytest.mark.parametrize("story", STORIES, ids=[s.__name__[6:]
                                                for s in STORIES])
def test_single_pod_story(pair, story):
    story(pair)
    pair.same_inspect()
    pair.same_rebuilt_cache()


def test_restart_rebuilds_from_annotations():
    """tests/test_e2e.py's crash restart: bind, stop both stacks, start
    fresh ones over the same apiservers; the ledgers rebuild from the
    annotations alone and keep packing on the same card."""
    first = Pair()
    try:
        first.create_node(make_node("v5e-0"))
        first.create_pod(make_pod("p1", hbm=10))
        assert first.schedule("p1")[0]
        first.set_phase("p1", "Running")
        first.idle()
    finally:
        first.close()
    second = Pair.__new__(Pair)
    second.jax = Side.__new__(Side)
    second.port = Side.__new__(Side)
    for side, old, main in ((second.jax, first.jax, jmain),
                            (second.port, first.port, tmain)):
        side.api, side.main, side.trace = old.api, main, old.trace
        side.headers = {}
        side.stack, side.server = main.serve_stack(old.api)
        side.base = f"http://127.0.0.1:{side.server.server_address[1]}"
    second.sides, second.uids = (second.jax, second.port), first.uids
    try:
        assert second.same_inspect("v5e-0")["nodes"][0]["usedHBM"] == 10
        second.create_pod(make_pod("p2", hbm=6))
        assert second.schedule("p2")[0]
        doc = second.same_inspect("v5e-0")
        assert doc["nodes"][0]["chips"][0]["usedHBM"] == 16
    finally:
        second.close()


def test_verbs_unwired_in_this_slice_answer_as_the_reference(pair):
    """preempt and validate answer as the reference's on both stacks (a
    pod that asks for no card: its victims echoed, none; a review of no
    object: allowed), and 404 "not configured" on a port server built
    without them, as the reference does where they are not wired; a
    malformed body is a 400 on both; an unknown node fails the bind on
    both."""
    for path, doc in (("/preempt", {"Pod": {}}),
                      ("/validate", {"request": {"uid": "u"}})):
        outs = [side.post(path, doc) for side in pair.sides]
        assert outs[1] == outs[0] and outs[0][0] == 200, outs
    stack = pair.port.stack
    bare = tserver.ExtenderHTTPServer(("127.0.0.1", 0), stack.predicate,
                                      stack.binder, stack.inspect)
    tserver.serve_forever(bare)
    try:
        base = f"http://127.0.0.1:{bare.server_address[1]}{PREFIX}"
        for path, want in (("/preempt", "preempt not configured"),
                           ("/validate", "admission not configured")):
            req = urllib.request.Request(f"{base}{path}",
                                         data=json.dumps({"Pod": {}}).encode())
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(req, timeout=60)
            assert exc.value.code == 404
            assert json.loads(exc.value.read()) == {"Error": want}
    finally:
        bare.shutdown()
        bare.server_close()
    for side in pair.sides:
        req = urllib.request.Request(f"{side.base}{PREFIX}/filter",
                                     data=b"[1, 2]")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=60)
        assert exc.value.code == 400
    pair.create_pod(make_pod("lost", hbm=1))
    outs = [side.post("/bind", {"PodName": "lost",
                                "PodNamespace": "default",
                                "PodUID": "uid-1", "Node": "nowhere"})
            for side in pair.sides]
    assert outs[1] == outs[0] and outs[0][0] == 500


# -- wire.py ---------------------------------------------------------------- #

def _results(seed: int):
    rng = np.random.default_rng(seed)
    names = [f"node-{i}" for i in range(int(rng.integers(0, 40)))]
    passed = [n for n in names if rng.random() < 0.5]
    failed = {n: f"insufficient TPU HBM in one chip {int(rng.integers(9))}"
              for n in names if n not in passed}
    scores = [(n, int(rng.integers(0, 11))) for n in names]
    return names, passed, failed, scores


@pytest.mark.parametrize("seed", range(6))
def test_wire_encodings_are_byte_equal(seed):
    names, passed, failed, scores = _results(seed)
    for node_names in (passed, [], None):
        got = twire.encode_filter_result(TFilterResult(
            node_names=node_names, failed_nodes=failed))
        want = jwire.encode_filter_result(JFilterResult(
            node_names=node_names, failed_nodes=failed))
        assert got == want
        assert got == json.dumps(
            TFilterResult(node_names=node_names,
                          failed_nodes=failed).to_json(),
            separators=(",", ":")).encode()
    got = twire.encode_host_priorities(
        [THostPriority(h, s) for h, s in scores])
    assert got == jwire.encode_host_priorities(
        [JHostPriority(h, s) for h, s in scores])
    # The repeat-shape parse gives what the general parser gives.
    pod = make_pod(f"p{seed}", hbm=seed + 1)
    for body in ({"Pod": pod, "NodeNames": names},
                 {"pod": pod, "nodenames": names},
                 {"Pod": pod, "Nodes": {"items": [
                     make_node(n) for n in names[:3]]}}):
        raw = json.dumps(body).encode()
        for _ in range(2):  # a memo miss, then a hit
            got = twire.parse_extender_args(raw)
            want = jwire.parse_extender_args(raw)
            assert got.pod.raw == want.pod.raw
            assert got.candidate_names() == want.candidate_names()
            assert (got.node_names, got.nodes is None) == (
                want.node_names, want.nodes is None)
    assert TArgs.from_json({"Pod": pod, "NodeNames": names}
                           ).candidate_names() == JArgs.from_json(
        {"Pod": pod, "NodeNames": names}).candidate_names()


def test_concurrent_requests_coalesce_to_the_same_answers(pair):
    """Filter and prioritize requests sent at once from many threads go
    through the micro-batch gate and get the answers they get one at a
    time, on the port as on the reference, and each request's decision
    trace lands on its own pod."""
    import concurrent.futures

    nodes = [f"h100-{i:02d}" for i in range(8)]
    for n in nodes:
        pair.create_node(make_node(n, **H100))
    docs = [pair.create_pod(make_pod(f"c{i}", hbm=8 * (i % 5 + 1)))
            for i in range(24)]
    for name in ("c0", "c1", "c2"):
        assert pair.schedule(name, nodes)[0]
    pair.idle()
    bodies = [(verb, {"Pod": pair.port.api.get_pod("default",
                                                  d["metadata"]["name"]).raw,
                      "NodeNames": nodes})
              for d in docs for verb in ("/filter", "/prioritize")]
    alone = [[side.post(v, b) for v, b in bodies] for side in pair.sides]
    assert alone[1] == alone[0]
    with concurrent.futures.ThreadPoolExecutor(16) as pool:
        together = list(pool.map(lambda vb: pair.port.post(*vb),
                                 bodies * 3))
    assert together == alone[1] * 3
    # The trace phase opens per item on the thread that drains the batch:
    # each pod's open decision holds its own four filters and four
    # prioritizes (one alone, three together), each noting what the
    # reference's one of each notes for that pod. (The three bound pods'
    # newest finished decision is their bind's.)
    for d in docs[3:]:
        name = d["metadata"]["name"]
        want = pair.jax.decision("default", name)
        got = pair.port.decision("default", name)
        assert got["outcome"] == "open", name
        for verb in ("filter", "prioritize"):
            [ref] = [s["attrs"] for s in want["spans"] if s["phase"] == verb]
            attrs = [s["attrs"] for s in got["spans"] if s["phase"] == verb]
            assert attrs == [ref] * 4, (name, verb)
