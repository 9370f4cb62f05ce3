"""The markers and Events the port's extender stamps on its fleet timeline
against the JAX package's, over both ``serve_stack``s
(``tests/test_torch_extender_e2e.py``'s ``Pair``).

* A node's Ready → NotReady edge: the same ``TPUShareNodeNotReady``
  Warning Event on both, its ``[timeline <cursor>]`` naming that side's
  ``node-notready`` marker; a node that stays NotReady, or comes back,
  fires nothing more; ``fleet_nodes_ready`` follows on the next tick.
* The same traffic on both stacks (a quota ConfigMap written twice, a
  leader hand-off through a Lease, a gang committed at quorum, a gang
  rolled back at its TTL, a NotReady flip) stamps the same marker kinds,
  details and attributes, in the same order. Timestamps, cursors'
  offsets and the decision ids (compared by presence) are left out.
* Both ``/debug/timeline`` documents carry the same series names
  (``cluster_stranded_hbm_gib``, which the defrag executor feeds,
  included), and ``/debug/blackbox`` and ``/debug/fleetday`` answer
  alike.
"""

from __future__ import annotations

import json
import time

from tests.test_quota import quota_cm_doc
from tests.test_torch_extender_e2e import H100, TIMED_RULES, Pair
from tests.torch_obs_reset import fresh_port_obs  # noqa: F401
from tpushare import obs as jobs
from tpushare.k8s import events as jevents
from tpushare.k8s.builders import make_node, make_pod
from tpushare.k8s.leader import LeaderElector as JElector
from tpushare_torch import obs as tobs
from tpushare_torch.k8s import events as tevents
from tpushare_torch.k8s.leader import LeaderElector as TElector
from tpushare_torch.utils import const

#: Marker kinds of the reference's subsystems the port has not yet (the
#: autoscaler A3, the router A5).
UNPORTED_KINDS = {"autoscale-up", "autoscale-down", "autoscale-abort",
                  "router-scaleout"}
UNPORTED_SERIES: set = set()

#: Each side's obs module, events queue and elector, in ``Pair.sides``
#: order.
PACKAGES = ((jobs, jevents, JElector), (tobs, tevents, TElector))


def _fresh_pair(nodes: int) -> Pair:
    for obs, _, _ in PACKAGES:
        obs.reset()
    pair = Pair()
    for i in range(nodes):
        pair.create_node(make_node(f"h100-{i}", **H100))
    for side in pair.sides:
        side.idle()
    return pair


def _until(pred, timeout: float = 10.0) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.01)


def _set_ready(side, name: str, ready: bool) -> None:
    node = side.api.get_node(name)
    node.raw.setdefault("status", {})["conditions"] = [
        {"type": "Ready", "status": "True" if ready else "False"}]
    side.api.update_node(node)


def _markers(obs) -> list[dict]:
    return obs.snapshot()["markers"]


def _normal(markers: list[dict]) -> list[tuple]:
    """Kind, detail and attributes; the decision id by presence; the
    markers of subsystems the port has not yet left out."""
    out = []
    for m in markers:
        if m["kind"] in UNPORTED_KINDS or \
                m["attrs"].get("rule") in TIMED_RULES:
            continue
        attrs = dict(m["attrs"])
        if "trace_id" in attrs:
            attrs["trace_id"] = "<id>"
        out.append((m["kind"], m["detail"], attrs))
    return out


def _notready_events(side, events) -> list[dict]:
    assert events.flush()
    return [e for _, e in side.api.events
            if e["reason"] == "TPUShareNodeNotReady"]


def test_notready_edge_records_the_reference_s_event():
    pair = _fresh_pair(2)
    try:
        for side in pair.sides:
            _set_ready(side, "h100-1", False)
            side.idle()
        got = []
        for side, (obs, events, _) in zip(pair.sides, PACKAGES):
            evs = _notready_events(side, events)
            assert len(evs) == 1, evs
            (marker,) = [m for m in _markers(obs)
                         if m["kind"] == "node-notready"]
            assert marker["attrs"] == {"node": "h100-1"}
            assert evs[0]["message"].endswith(
                f"[timeline {marker['cursor']}]")
            got.append([(e["reason"], e["type"], e["message"],
                         e["involvedObject"]["name"],
                         e["involvedObject"]["namespace"]) for e in evs])
        assert got[1] == got[0]
        assert got[0][0][2].startswith(
            "node h100-1 transitioned to NotReady; its chips stay in "
            "the ledger until the Node object is deleted")
        # Still NotReady on the next status write, then Ready again: only
        # the edge fires.
        for side in pair.sides:
            _set_ready(side, "h100-1", False)
            _set_ready(side, "h100-1", True)
            _set_ready(side, "h100-0", True)
            side.idle()
        for side, (obs, events, _) in zip(pair.sides, PACKAGES):
            assert len(_notready_events(side, events)) == 1
            obs.timeline().tick()
            series = obs.snapshot()["series"]
            assert series["fleet_nodes"]["last"] == 2.0
            assert series["fleet_nodes_ready"]["last"] == 2.0
    finally:
        pair.close()


def _gang(name: str, pod: str, minimum: int, gib: int) -> dict:
    return make_pod(pod, hbm=gib, annotations={
        const.ANN_POD_GROUP: name, const.ANN_POD_GROUP_MIN: str(minimum)})


#: Long enough that a loaded test host never lets A's Lease lapse while
#: A renews every 50 ms.
LEASE_S = 3.0


def _hand_off(api, elector_cls) -> None:
    """Replica A leads; an intruder takes the Lease, so A steps down;
    A stops; replica B takes the expired Lease over."""
    a = elector_cls(api, "replica-a", lease_duration=LEASE_S,
                    renew_period=0.05)
    b = elector_cls(api, "replica-b", lease_duration=LEASE_S,
                    renew_period=0.05)
    a.start()
    try:
        _until(a.is_leader)
        b.start()
        time.sleep(0.2)
        assert not b.is_leader()
        lease = api.get_lease(a.namespace, a.name)
        intruder = elector_cls(api, "intruder", lease_duration=LEASE_S)
        doc = intruder._lease_doc(1, "")
        doc["metadata"]["resourceVersion"] = \
            lease["metadata"]["resourceVersion"]
        api.update_lease(a.namespace, a.name, doc)
        _until(lambda: not a._leader)
        a.stop()
        _until(b.is_leader, timeout=3 * LEASE_S)
    finally:
        a.stop()
        b.stop()


def test_same_traffic_stamps_the_same_markers():
    pair = _fresh_pair(4)
    try:
        quota = quota_cm_doc({"default": {"limitHBM": 400}})
        for side in pair.sides:
            side.api.create_configmap(json.loads(json.dumps(quota)))
        for side in pair.sides:
            _until(lambda s=side: s.stack.controller.quota.configured(
                "default"))
        for side, (_, _, elector) in zip(pair.sides, PACKAGES):
            _hand_off(side.api, elector)
        # A gang of two commits at quorum.
        pair.create_pod(_gang("g", "g-0", 2, 16))
        pair.create_pod(_gang("g", "g-1", 2, 16))
        assert pair.schedule("g-0", ["h100-0"])[0] is False
        assert pair.schedule("g-1", ["h100-1"])[0] is True
        # A gang of two that never completes rolls back at its TTL.
        for side in pair.sides:
            side.stack.binder.gang_planner.ttl = 0.05
        pair.create_pod(_gang("t", "t-0", 2, 8))
        assert pair.schedule("t-0", ["h100-2"])[0] is False
        time.sleep(0.1)
        for side in pair.sides:
            side.stack.binder.gang_planner.expire_stale()
        # A host fails.
        for side in pair.sides:
            _set_ready(side, "h100-3", False)
            side.idle()
        # The quota ConfigMap rewritten.
        for side in pair.sides:
            cm = side.api.get_configmap("kube-system",
                                        const.QUOTA_CONFIGMAP)
            cm.raw["data"] = quota_cm_doc(
                {"default": {"limitHBM": 300}})["data"]
            side.api.update_configmap(cm)
        for side in pair.sides:
            _until(lambda s=side: s.stack.controller.quota.config_for(
                "default").limit_hbm == 300)
        markers = [_normal(_markers(obs)) for obs, _, _ in PACKAGES]
        assert markers[1] == markers[0]
        assert [m[0] for m in markers[0]] == [
            "config", "leader", "leader", "leader", "gang-commit",
            "gang-rollback", "node-notready", "config"]
        assert markers[0][1:4] == [
            ("leader", "acquired leadership", {"identity": "replica-a"}),
            ("leader", "lost leadership (observed)",
             {"identity": "replica-a"}),
            ("leader", "acquired leadership", {"identity": "replica-b"})]
        assert markers[0][4] == (
            "gang-commit", "gang g reached quorum (2 member(s) committing)",
            {"gang": "g", "members": "2", "trace_id": "<id>"})
        assert markers[0][5] == (
            "gang-rollback", "gang t expired at 1/2 members; rolling back",
            {"gang": "t", "members": "1"})
        # The routes answer alike.
        for path in ("/debug/blackbox", "/debug/fleetday"):
            outs = [side.get(path) for side in pair.sides]
            assert outs[1][0] == outs[0][0]
            assert json.loads(outs[1][1]) == json.loads(outs[0][1])
        for obs, _, _ in PACKAGES:
            obs.timeline().tick()
        docs = [json.loads(side.get("/debug/timeline?window=600")[1])
                for side in pair.sides]
        assert set(docs[1]["series"]) == \
            set(docs[0]["series"]) - UNPORTED_SERIES
        assert docs[1]["anomalies"]["rules"] == docs[0]["anomalies"]["rules"]
    finally:
        pair.close()
