"""Leader election in the port's extender (``tpushare_torch/k8s/
leader.py``, the Lease calls of the fake and the client, bind gating in
``routes/server.py``, ``LEADER_ELECT`` in ``cmd/main.py``).

* The reference's stories of ``tests/test_leader.py`` over the port's
  modules (``tests/torch_reference_stories.py``): the Lease store's
  optimistic concurrency, one candidate acquiring and renewing, exactly
  one leader of two, failover after the leader stops, a Lease with no
  renewTime taken, a wedged leader demoting itself. Its HA bind-gating
  cases build the server with the reference's metrics arguments and one
  reads ``/metrics``, which the port has not yet, and its gang hand-off
  is unsteady in the reference's own runs; all three have twins here
  over ``serve_stack(leader=...)`` that poll against deadlines and use
  sub-second leases.
* The Lease store of both fakes on the same operations: the same
  documents, resourceVersions and errors.
* The elector's Lease document against the reference's, and both
  electors over one fake apiserver: one leader.
* Two port replicas (``serve_stack(leader=...)``) over one fake: one
  leader, ``/healthz`` "ok leader" / "ok follower", the follower's 503
  with ``Retry-After``, filter on both, failover within the lease, and no
  card over its GiB across the hand-off; a gang half reserved by the old
  leader completed by the new one.
* ``LEADER_ELECT`` in ``main``: the election joined with a unique
  identity in ``LEASE_NAMESPACE``, its elector handed to the server and
  stopped at shutdown.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from tests import torch_reference_stories as R
from tpushare.k8s.builders import make_node, make_pod
from tpushare.k8s.errors import ConflictError as JConflict
from tpushare.k8s.errors import NotFoundError as JNotFound
from tpushare.k8s.fake import FakeApiServer as JFake
from tpushare.k8s.leader import LeaderElector as JElector
from tpushare_torch.cmd import main as M
from tpushare_torch.k8s.errors import ConflictError as TConflict
from tpushare_torch.k8s.errors import NotFoundError as TNotFound
from tpushare_torch.k8s.fake import FakeApiServer
from tpushare_torch.k8s.leader import LeaderElector
from tpushare_torch.utils import const
from tpushare_torch.utils import pod as podutils

globals().update(R.pick(R.load("test_leader"),
                       ["TestLeaseStore", "TestElector"]))

PREFIX = "/tpushare-scheduler"
LEASE = "tpushare-schd-extender"


@pytest.fixture
def api():
    """The reference's stories run over the port's fake apiserver."""
    return FakeApiServer()


def wait_for(pred, timeout: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


# -- the Lease store -------------------------------------------------------- #

def _lease_ops(api, conflict, not_found) -> list:
    out = []

    def attempt(fn, *args):
        try:
            out.append(("ok", fn(*args)))
        except conflict:
            out.append(("409",))
        except not_found:
            out.append(("404",))
    attempt(api.get_lease, "kube-system", "l")
    attempt(api.create_lease, "kube-system",
            {"metadata": {"name": "l"}, "spec": {"holderIdentity": "a"}})
    attempt(api.create_lease, "kube-system", {"metadata": {"name": "l"}})
    lease = api.get_lease("kube-system", "l")
    stale = lease["metadata"]["resourceVersion"]
    lease["spec"]["holderIdentity"] = "b"
    attempt(api.update_lease, "kube-system", "l", lease)
    lease["metadata"]["resourceVersion"] = stale
    attempt(api.update_lease, "kube-system", "l", lease)
    lease["metadata"].pop("resourceVersion")
    attempt(api.update_lease, "kube-system", "l", lease)
    attempt(api.update_lease, "kube-system", "ghost", {"metadata": {}})
    attempt(api.get_lease, "other-ns", "l")
    attempt(api.get_lease, "kube-system", "l")
    return out


def test_lease_stores_answer_alike():
    want = _lease_ops(JFake(), JConflict, JNotFound)
    got = _lease_ops(FakeApiServer(), TConflict, TNotFound)
    assert got == want
    assert [o[0] for o in got] == ["ok", "ok", "409", "ok", "409", "ok",
                                   "404", "ok", "ok"]


@pytest.mark.parametrize("duration", [15.0, 0.5])
def test_lease_documents_match_the_reference(duration):
    docs = []
    for cls in (JElector, LeaderElector):
        e = cls(None, "me", namespace="ns", lease_duration=duration)
        doc = e._lease_doc(3, "2026-01-01T00:00:00.000000Z")
        assert doc["spec"].pop("renewTime").endswith("Z")
        docs.append(doc)
    assert docs[1] == docs[0]
    assert type(docs[1]["spec"]["leaseDurationSeconds"]) is (
        int if duration == 15.0 else float)


def test_a_port_elector_and_a_reference_elector_elect_one():
    """The Lease is the contract: either package's replica can hold it."""
    api = FakeApiServer()
    a = JElector(api, "jax", lease_duration=2.0, renew_period=0.05)
    b = LeaderElector(api, "port", lease_duration=2.0, renew_period=0.05)
    a.start()
    try:
        assert wait_for(a.is_leader)
        b.start()
        # The follower has ticked and observed a held Lease.
        renewed = api.get_lease("kube-system", LEASE)["spec"]["renewTime"]
        assert wait_for(lambda: api.get_lease("kube-system", LEASE)[
            "spec"]["renewTime"] != renewed)
        assert a.is_leader() and not b.is_leader()
        a.stop()
        assert wait_for(b.is_leader)
        lease = api.get_lease("kube-system", LEASE)
        assert lease["spec"]["holderIdentity"] == "port"
        assert lease["spec"]["leaseTransitions"] == 1
    finally:
        a.stop()
        b.stop()


# -- two port replicas over one apiserver ------------------------------------ #

def _post(base: str, path: str, doc: dict) -> tuple[int, dict, dict]:
    req = urllib.request.Request(
        f"{base}{PREFIX}{path}", data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _healthz(base: str) -> bytes:
    with urllib.request.urlopen(f"{base}/healthz", timeout=60) as resp:
        return resp.read()


class Replicas:
    """Two port extenders, each with its own elector and stack, over one
    fake apiserver (``lease`` s, renewed every 0.05 s)."""

    def __init__(self, api, lease: float = 0.6):
        self.api = api
        self.electors = [LeaderElector(api, name, lease_duration=lease,
                                       renew_period=0.05)
                         for name in ("r0", "r1")]
        self.electors[0].start()
        assert wait_for(self.electors[0].is_leader)
        self.electors[1].start()
        self.stacks = [M.serve_stack(api, leader=e) for e in self.electors]
        self.bases = [f"http://127.0.0.1:{server.server_address[1]}"
                      for _, server in self.stacks]

    def leader(self) -> int:
        """The index of the one leader (polled: a hand-off may be under
        way)."""
        assert wait_for(lambda: sum(e.is_leader()
                                    for e in self.electors) == 1)
        return next(i for i, e in enumerate(self.electors)
                    if e.is_leader())

    def close(self) -> None:
        for stack, server in self.stacks:
            M.shutdown_stack(stack, server)
        for e in self.electors:
            e.stop()


def _over_gib(api) -> list:
    """Cards whose granted GiB exceed their capacity."""
    caps = {n.name: [int(c) for c in
                     n.annotations[const.ANN_NODE_CHIP_HBM].split(",")]
            for n in api.list_nodes()}
    used: dict = {}
    for p in api.list_pods():
        if not p.node_name or not podutils.is_assumed(p):
            continue
        whole = podutils.get_chips_from_pod_resource(p) > 0
        hbm = podutils.get_hbm_from_pod_annotation(p)
        for i in podutils.get_chip_ids_from_annotation(p):
            key = (p.node_name, i)
            used[key] = used.get(key, 0) + (caps[p.node_name][i] if whole
                                             else hbm)
    return [k for k, v in used.items() if v > caps[k[0]][k[1]]]


def test_one_replica_binds_the_other_answers_503():
    api = FakeApiServer()
    api.create_node(make_node("h100-0", chips=8, hbm_per_chip=79,
                              topology="", tpu_type="h100-80gb"))
    reps = Replicas(api)
    try:
        lead = reps.leader()
        follow = 1 - lead
        health = [_healthz(b) for b in reps.bases]
        assert health[lead] == b"ok leader"
        assert health[follow] == b"ok follower"
        for base in reps.bases:
            status, doc, _ = _post(base, "/filter", {
                "Pod": make_pod("probe", hbm=8), "NodeNames": ["h100-0"]})
            assert status == 200 and doc["NodeNames"] == ["h100-0"]
        pod = api.create_pod(make_pod("w", hbm=8))
        bind = {"PodName": "w", "PodNamespace": "default",
                "PodUID": pod.uid, "Node": "h100-0"}
        status, doc, headers = _post(reps.bases[follow], "/bind", bind)
        assert (status, doc) == (503, {"Error": "not the leader"})
        assert headers["Retry-After"] == "1"
        assert api.get_pod("default", "w").node_name == ""
        status, _, _ = _post(reps.bases[lead], "/bind", bind)
        assert status == 200
        assert api.get_pod("default", "w").node_name == "h100-0"
    finally:
        reps.close()


def test_failover_binds_within_the_lease_and_keeps_every_card():
    """The leader fills the card half way; it stops; the follower takes
    the Lease within its duration and binds the rest, against a ledger
    that saw the old leader's binds: no card goes over its GiB."""
    api = FakeApiServer()
    api.create_node(make_node("h100-0", chips=1, hbm_per_chip=79,
                              topology="", tpu_type="h100-80gb"))
    reps = Replicas(api, lease=0.6)
    try:
        lead = reps.leader()
        follow = 1 - lead
        for i in range(2):
            pod = api.create_pod(make_pod(f"a{i}", hbm=30))
            status, doc, _ = _post(reps.bases[lead], "/bind", {
                "PodName": f"a{i}", "PodNamespace": "default",
                "PodUID": pod.uid, "Node": "h100-0"})
            assert status == 200, doc
        reps.electors[lead].stop()
        stopped = time.monotonic()
        reps.stacks[lead][1].shutdown()
        assert wait_for(reps.electors[follow].is_leader, timeout=5.0)
        pod = api.create_pod(make_pod("b0", hbm=30))
        bind = {"PodName": "b0", "PodNamespace": "default",
                "PodUID": pod.uid, "Node": "h100-0"}
        status, doc, _ = _post(reps.bases[follow], "/bind", bind)
        took = time.monotonic() - stopped
        # 30 + 30 + 30 > 79: the new leader's ledger holds the old
        # leader's binds, so it refuses rather than oversubscribing.
        assert status == 500 and doc["Error"], doc
        assert _over_gib(api) == []
        pod = api.create_pod(make_pod("b1", hbm=19))
        status, doc, _ = _post(reps.bases[follow], "/bind", {
            "PodName": "b1", "PodNamespace": "default",
            "PodUID": pod.uid, "Node": "h100-0"})
        assert status == 200, doc
        assert _over_gib(api) == []
        # The Lease lapses at most 0.6 s after the last renewal, which
        # came before the stop; the rest is the follower's tick and the
        # two binds.
        assert took < 0.6 + 1.5
    finally:
        reps.close()


def test_gang_handoff_across_failover():
    """A gang half reserved by the old leader is completed by the new
    one: the old reservation is reset (its node choice lived only in the
    old leader's memory), the scheduler re-places it, and both members
    bind to distinct whole hosts. The demoted replica's planner is
    leader-gated, so it cannot race."""
    api = FakeApiServer()
    for i in range(2):
        api.create_node(make_node(f"h{i}", chips=4, hbm_per_chip=95))
    reps = Replicas(api, lease=0.6)
    ann = {const.ANN_POD_GROUP: "ring", const.ANN_POD_GROUP_MIN: "2"}
    try:
        lead = reps.leader()
        follow = 1 - lead
        w0 = api.create_pod(make_pod("w0", chips=4, annotations=ann))
        bind0 = {"PodName": "w0", "PodNamespace": "default",
                 "PodUID": w0.uid, "Node": "h0"}
        status, doc, _ = _post(reps.bases[lead], "/bind", bind0)
        assert status == 500 and "pending quorum" in doc["Error"]
        assert podutils.is_assumed(api.get_pod("default", "w0"))
        reps.electors[lead].stop()
        assert wait_for(reps.electors[follow].is_leader, timeout=5.0)
        new = reps.bases[follow]
        status, doc, _ = _post(new, "/bind", bind0)
        assert status == 500
        assert "stale reservation; reset" in doc["Error"]
        assert not podutils.is_assumed(api.get_pod("default", "w0"))
        # The new replica's informer must see the reset before filter.
        assert wait_for(lambda: reps.stacks[follow][0].controller
                        .wait_idle(timeout=1.0))
        status, doc, _ = _post(new, "/filter", {
            "Pod": api.get_pod("default", "w0").raw,
            "NodeNames": ["h0", "h1"]})
        assert status == 200 and doc["NodeNames"]
        node0 = doc["NodeNames"][0]
        bind0["Node"] = node0
        status, doc, _ = _post(new, "/bind", bind0)
        assert status == 500 and "pending quorum" in doc["Error"]
        w1 = api.create_pod(make_pod("w1", chips=4, annotations=ann))
        status, doc, _ = _post(new, "/bind", {
            "PodName": "w1", "PodNamespace": "default", "PodUID": w1.uid,
            "Node": "h1" if node0 == "h0" else "h0"})
        assert status == 200, doc
        assert wait_for(lambda: bool(
            api.get_pod("default", "w0").node_name), timeout=5.0)
        finals = [api.get_pod("default", n) for n in ("w0", "w1")]
        assert {p.node_name for p in finals} == {"h0", "h1"}
        for p in finals:
            assert len(p.annotations[const.ANN_CHIP_IDX].split(",")) == 4
        assert _over_gib(api) == []
    finally:
        reps.close()


# -- LEADER_ELECT in main ------------------------------------------------------ #

@pytest.fixture
def no_cluster(monkeypatch):
    """The fake apiserver in place of the cluster; the first wait for a
    signal returns at once."""
    api = FakeApiServer()
    monkeypatch.setattr(M.ClusterConfig, "auto",
                        classmethod(lambda cls: None))
    monkeypatch.setattr(M, "ApiClient", lambda cfg: api)
    monkeypatch.setattr(M, "setup_signals", lambda stop: stop.set())
    monkeypatch.setattr(M, "configure_logging", lambda: None)
    for key in ("PORT", "TLS_CERT_FILE", "TLS_KEY_FILE", "LEADER_ELECT",
                "LEASE_NAMESPACE", "HOSTNAME", "TPUSHARE_GC_TUNE"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("TPUSHARE_GC_TUNE", "off")
    monkeypatch.setenv("PORT", "0")
    return api


@pytest.mark.parametrize("env,elects", [
    ({"LEADER_ELECT": "1", "HOSTNAME": "extender-7",
      "LEASE_NAMESPACE": "tpushare"}, True),
    ({"LEADER_ELECT": "true"}, True),
    ({"LEADER_ELECT": "0"}, False),
    ({}, False),
])
def test_main_joins_the_election_under_leader_elect(no_cluster, monkeypatch,
                                                    env, elects):
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    seen = {}
    started = threading.Event()

    class Server(M.ExtenderHTTPServer):
        def __init__(self, *args, leader=None, **kw):
            super().__init__(*args, leader=leader, **kw)
            seen["leader"] = leader
            if leader is not None:
                assert wait_for(leader.is_leader)
                seen["lease"] = no_cluster.get_lease(leader.namespace,
                                                     leader.name)
            started.set()

    monkeypatch.setattr(M, "ExtenderHTTPServer", Server)
    M.main()
    assert started.is_set()
    leader = seen["leader"]
    if not elects:
        assert leader is None
        assert no_cluster.get_lease("kube-system", LEASE) is None
        return
    assert isinstance(leader, LeaderElector)
    assert leader.namespace == env.get("LEASE_NAMESPACE", "kube-system")
    prefix = env.get("HOSTNAME") or "pid"
    assert leader.identity.startswith(f"{prefix}-")
    assert seen["lease"]["spec"]["holderIdentity"] == leader.identity
    # Shutdown stopped the elector: it no longer leads.
    assert not leader.is_leader()


def test_two_identities_never_collide(monkeypatch):
    monkeypatch.setenv("LEADER_ELECT", "1")
    monkeypatch.setenv("HOSTNAME", "same")
    api = FakeApiServer()
    a, b = M.start_leader(api), M.start_leader(api)
    try:
        assert a.identity != b.identity
        assert wait_for(lambda: a.is_leader() != b.is_leader())
    finally:
        a.stop()
        b.stop()
