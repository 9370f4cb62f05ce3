"""The port's tenant quotas (``tpushare_torch/quota/``, and where the
extender reads them) against the JAX package's.

* The ConfigMap parser on a table of documents (entries, the ``*``
  default, malformed JSON, a non-object, unknown keys, a negative value,
  a guarantee over its limit, an empty object, a deleted ConfigMap): the
  same specs and ``configured`` answers on both.
* Both ``QuotaManager``s fed the same seeded streams of pods (HBM and
  whole-card, three tenants, a tenant label, completions, re-priced
  grants) and asked every question after each step: usage, admit,
  admit_and_reserve, is_borrowed, under_guarantee, reclaim_eligible,
  reclaimable_excess, score_adjust, dominant_share, snapshot.
* The reference's stories of ``tests/test_quota.py`` over the port's
  modules (``tests/torch_reference_stories.py``): config parsing, the
  ledger, the gang charge rolled back at its TTL and a quota-doomed gang
  refused, the ConfigMap namespace pinning, the ConfigMap over the real
  client's wire, the demand tracker's per-tenant view, and the tenancy
  story end to end over the port's ``serve_stack``: borrow, reclaim by
  ``/preempt``, the denial at the limit in the Event stream, in
  ``tpushare_quota_denied_total`` and the per-tenant gauges of
  ``/metrics`` and in the flight recorder, and the usage rebuilt after a
  restart. The reference's tools are left out.
* Its end-to-end stories over both ``serve_stack``s
  (``tests/test_torch_extender_e2e.py``'s ``Pair``) byte for byte:
  a borrower fills the fleet, an under-guarantee tenant's pod is refused
  by filter, ``/preempt`` names one borrowed pod at equal priority, the
  pod binds after the eviction, a pod over its limit is refused with the
  quota reason and a Warning Event, ``/debug/quota`` agrees, and a stack
  rebuilt from the apiserver holds the same usage; the fair-share bias of
  prioritize; a rewritten ConfigMap enforced; each attempt's decision
  trace equal on both (``Pair.same_decision``).
"""

from __future__ import annotations

import json
import re
import time
import urllib.request

import numpy as np
import pytest

from tests import torch_reference_stories as R
from tests.test_torch_extender_e2e import Pair, timed_anomaly
from tests.torch_obs_reset import fresh_port_obs  # noqa: F401
from tpushare.api.objects import ConfigMap as JConfigMap, Pod as JPod
from tpushare.k8s import events as jevents
from tpushare.k8s.builders import make_node, make_pod
from tpushare.quota import QuotaManager as JManager
from tpushare.quota import parse_configmap as jparse
from tpushare_torch.api.objects import ConfigMap as TConfigMap, Pod as TPod
from tpushare_torch.cmd import main as tmain
from tpushare_torch.k8s import events as tevents
from tpushare_torch.k8s.fake import FakeApiServer
from tpushare_torch.quota import QuotaManager as TManager
from tpushare_torch.quota import parse_configmap as tparse
from tpushare_torch.routes import metrics as tmetrics
from tpushare_torch.utils import const

_STORIES = R.load("test_quota")
#: The reference's fixture: a two-node fleet under a quota ConfigMap and
#: its ``serve_stack`` (the port's, here).
tenant_cluster = _STORIES.tenant_cluster
globals().update(R.pick(
    _STORIES,
    ["TestQuotaConfig", "TestLedger", "TestTenancyEndToEnd",
     "TestGangQuotaRollback", "TestConfigMapNamespacePinning",
     "TestConfigMapWire", "TestDemandByTenant"]))


@pytest.fixture
def api():
    """The reference's stories run over the port's fake apiserver, each
    from a fresh metrics registry: a story reads its own counts (the
    reference's process holds one registry a test run, too)."""
    tmetrics.reset()
    return FakeApiServer()


def quota_cm(entries: dict, namespace: str = "kube-system") -> dict:
    return {"metadata": {"name": const.QUOTA_CONFIGMAP,
                         "namespace": namespace},
            "data": {t: s if isinstance(s, str) else json.dumps(s)
                     for t, s in entries.items()}}


# -- the parser ------------------------------------------------------------ #

CONFIGS = {
    "entries": {"team-a": {"guaranteeHBM": 64, "limitHBM": 128},
                "team-b": {"guaranteeChips": 4, "limitChips": 8,
                           "guaranteeHBM": 32}},
    "default": {"*": {"limitHBM": 256}, "team-a": {"guaranteeHBM": 8}},
    "malformed": {"bad": "{not json", "ok": {"limitHBM": 1}},
    "not_object": {"list": "[1, 2]", "num": "7"},
    "unknown_key": {"typo": {"guaranteeHbm": 4}, "ok": {"limitChips": 2}},
    "negative": {"neg": {"limitHBM": -1}},
    "not_int": {"str": {"limitHBM": "lots"}, "float": {"limitHBM": 2.5}},
    "over_limit": {"inv": {"guaranteeHBM": 9, "limitHBM": 8}},
    "empty_object": {"empty": {}, "*": {}},
    "deleted": None,
}


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_configmaps_parse_alike(case):
    entries = CONFIGS[case]
    out = []
    for parse, cm in ((jparse, JConfigMap), (tparse, TConfigMap)):
        cfg = parse(None if entries is None else cm(quota_cm(entries)))
        tenants = sorted(set(cfg.tenants) | {"nobody"})
        out.append(({t: vars(cfg.for_tenant(t)) for t in tenants},
                    {t: cfg.configured(t) for t in tenants},
                    vars(cfg.default)))
    assert out[1] == out[0]


# -- the manager on seeded streams ------------------------------------------ #

MANAGER_CM = {"team-a": {"guaranteeHBM": 48, "limitHBM": 96,
                         "guaranteeChips": 2, "limitChips": 6},
              "team-b": {"guaranteeHBM": 16},
              "*": {"limitHBM": 64}}


def _pod(rng, i: int) -> dict:
    tenant = str(rng.choice(["team-a", "team-b", "team-c"]))
    labels = ({const.LABEL_TENANT: tenant} if rng.random() < 0.3 else None)
    ns = "shared" if labels else tenant
    ann = {const.ANN_CHIP_IDX: "0"}
    if rng.random() < 0.7:
        hbm = int(rng.choice([8, 16, 24]))
        if rng.random() < 0.7:
            ann[const.ANN_HBM_POD] = str(hbm)
        doc = make_pod(f"p{i}", hbm=hbm, namespace=ns, uid=f"u{i}",
                       annotations=ann, labels=labels)
    else:
        chips = int(rng.choice([1, 2, 4]))
        ann[const.ANN_CHIP_IDX] = ",".join(str(c) for c in range(chips))
        doc = make_pod(f"p{i}", chips=chips, namespace=ns, uid=f"u{i}",
                       annotations=ann, labels=labels)
    return doc


def _answers(q, pod_cls, doc: dict, other: dict, tenants) -> tuple:
    pod, peer = pod_cls(json.loads(json.dumps(doc))), pod_cls(other)
    return (q.admit(pod), q.admit(pod, count=3), q.is_borrowed(pod),
            q.under_guarantee(pod), q.reclaim_eligible(pod, peer),
            q.score_adjust(pod),
            [(q.usage(t), q.reclaimable_excess(t), q.dominant_share(t),
              q.configured(t), vars(q.config_for(t))) for t in tenants],
            q.snapshot())


@pytest.mark.parametrize("seed", range(8))
def test_managers_answer_alike_on_a_stream(seed):
    rng = np.random.default_rng(seed)
    sides = [(JManager(), JPod, jparse, JConfigMap),
             (TManager(), TPod, tparse, TConfigMap)]
    for q, _, parse, cm in sides:
        q.set_config(parse(cm(quota_cm(MANAGER_CM))))
    tenants = ["team-a", "team-b", "team-c"]
    docs = [_pod(rng, i) for i in range(40)]
    live: list[dict] = []
    for step in range(120):
        op = rng.random()
        doc = docs[int(rng.integers(len(docs)))]
        other = docs[int(rng.integers(len(docs)))]
        if op < 0.45:
            action = "charge"
        elif op < 0.6 and live:
            action, doc = "uncharge", live[int(rng.integers(len(live)))]
        elif op < 0.7:
            action = "reserve"
        elif op < 0.8:
            action = "complete"
        else:
            action = "ask"
        out = []
        for q, pod_cls, _, _ in sides:
            pod = pod_cls(json.loads(json.dumps(doc)))
            got = None
            if action == "charge":
                q.charge(pod)
            elif action == "uncharge":
                q.uncharge(pod)
            elif action == "reserve":
                got = q.admit_and_reserve(pod)
            elif action == "complete":
                pod.raw.setdefault("status", {})["phase"] = "Succeeded"
                q.charge(pod)
            out.append((got, _answers(q, pod_cls, doc, other, tenants)))
        assert out[1] == out[0], (seed, step, action)
        if action in ("charge", "reserve") and doc not in live:
            live.append(doc)
        if action in ("uncharge", "complete") and doc in live:
            live.remove(doc)


# -- both stacks over HTTP --------------------------------------------------- #

TENANCY = {"team-a": {"guaranteeHBM": 32, "limitHBM": 48},
           "team-b": {"guaranteeHBM": 16, "limitHBM": 256}}


class TenantPair(Pair):
    """``Pair`` over two 4 x 16 GiB nodes with the reference's tenancy
    ConfigMap: team-a guaranteed 32 and limited to 48, team-b guaranteed
    16 (a born borrower)."""

    def __init__(self, entries=TENANCY):
        super().__init__()
        for i in range(2):
            self.create_node(make_node(f"v5e-{i}"))
        for side in self.sides:
            side.api.create_configmap(quota_cm(entries))
        self.wait_limit("team-a", entries["team-a"].get("limitHBM"))

    def wait_limit(self, tenant: str, limit) -> None:
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if all(side.stack.controller.quota.config_for(tenant).limit_hbm
                   == limit for side in self.sides):
                return
            time.sleep(0.02)
        raise AssertionError("quota ConfigMap never applied")

    def debug_quota(self) -> dict:
        docs = []
        for side in self.sides:
            with urllib.request.urlopen(f"{side.base}/debug/quota",
                                        timeout=60) as resp:
                docs.append(resp.read())
        assert docs[1] == docs[0]
        return json.loads(docs[0])

    def preempt(self, name: str, namespace: str) -> dict:
        pod = self.port.api.get_pod(namespace, name)
        names = [n.name for n in self.port.api.list_nodes()]
        doc = {"Pod": pod.raw,
               "NodeNameToMetaVictims": {n: {"Pods": []} for n in names}}
        outs = [side.post("/preempt", doc) for side in self.sides]
        assert outs[1] == outs[0] and outs[0][0] == 200
        return json.loads(outs[0][1])["NodeNameToMetaVictims"]

    def events(self) -> list:
        assert jevents.flush() and tevents.flush()
        out = []
        for side in self.sides:
            out.append(sorted(
                (e["involvedObject"]["name"], e["reason"],
                 re.sub(r" \[trace [^\]]*\]$", "", e["message"]), e["type"])
                for _, e in side.api.events if not timed_anomaly(e)))
        assert out[1] == out[0]
        return out[0]


@pytest.fixture
def tenants():
    pair = TenantPair()
    yield pair
    pair.close()


def _fill_with_team_b(pair: TenantPair, count: int = 8) -> None:
    for i in range(count):
        pair.create_pod(make_pod(f"b-{i}", hbm=16, namespace="team-b"))
        bound, where = pair.schedule(f"b-{i}", namespace="team-b")
        assert bound, where


def test_borrow_reclaim_deny_and_restart(tenants):
    pair = tenants
    _fill_with_team_b(pair)
    quota = pair.port.stack.controller.quota
    assert quota.usage("team-b") == (128, 0, 8)
    pair.create_pod(make_pod("a-0", hbm=16, namespace="team-a"))
    bound, detail = pair.schedule("a-0", namespace="team-a")
    assert not bound and "insufficient TPU HBM" in str(detail)
    # Reclaim at equal priority names one borrowed pod of team-b.
    victims = pair.preempt("a-0", "team-a")
    node = sorted(victims)[0]
    (uid,) = [p["UID"] for p in victims[node]["Pods"]]
    victim = next(p for p in pair.port.api.list_pods() if p.uid == uid)
    assert victim.namespace == "team-b" and quota.is_borrowed(victim)
    for side in pair.sides:
        side.api.delete_pod(victim.namespace, victim.name)
    pair.idle()
    bound, where = pair.schedule("a-0", namespace="team-a")
    assert bound, where
    assert quota.usage("team-a") == (16, 0, 1)
    assert quota.usage("team-b") == (112, 0, 7)
    # Over the limit: refused on every node with the quota reason, and a
    # Warning Event.
    pair.create_pod(make_pod("a-big", hbm=48, namespace="team-a"))
    bound, failed = pair.schedule("a-big", namespace="team-a")
    assert not bound
    (reason,) = set(failed.values())
    assert reason.startswith("quota: tenant team-a")
    assert (("a-big", tevents.REASON_QUOTA_DENIED, reason, "Warning")
            in pair.events())
    # ... and no victims for it either.
    assert pair.preempt("a-big", "team-a") == {}
    doc = pair.debug_quota()
    by_tenant = {t["tenant"]: t for t in doc["tenants"]}
    assert by_tenant["team-b"]["borrowedHBM"] == 96
    assert by_tenant["team-a"]["usedHBM"] == 16
    # A stack rebuilt from the apiserver holds the same usage and limit.
    before = {t["tenant"]: (t["usedHBM"], t["usedChips"], t["pods"])
              for t in doc["tenants"]}
    stack2 = tmain.build_stack(pair.port.api)
    stack2.controller.start(workers=1)
    try:
        after = {t["tenant"]: (t["usedHBM"], t["usedChips"], t["pods"])
                 for t in stack2.controller.quota.snapshot()}
        assert after == before
        ok, why = stack2.controller.quota.admit(
            pair.port.api.get_pod("team-a", "a-big"))
        assert not ok and why.startswith("quota:")
    finally:
        stack2.binder.gang_planner.stop()
        stack2.controller.stop()


def test_fair_share_bias_on_the_wire(tenants):
    pair = tenants
    _fill_with_team_b(pair, count=2)
    pair.create_pod(make_pod("a-score", hbm=8, namespace="team-a"))
    pair.create_pod(make_pod("b-score", hbm=8, namespace="team-b"))
    names = [n.name for n in pair.port.api.list_nodes()]
    scores = {}
    for ns, name in (("team-a", "a-score"), ("team-b", "b-score")):
        pod = pair.port.api.get_pod(ns, name)
        outs = [side.post("/prioritize", {"Pod": pod.raw,
                                          "NodeNames": names})
                for side in pair.sides]
        assert outs[1] == outs[0] and outs[0][0] == 200
        scores[ns] = {e["Host"]: e["Score"] for e in json.loads(outs[0][1])}
    assert all(scores["team-a"][n] > scores["team-b"][n] for n in names)


def test_a_rewritten_configmap_is_enforced(tenants):
    pair = tenants
    for side in pair.sides:
        cm = side.api.get_configmap("kube-system", const.QUOTA_CONFIGMAP)
        cm.raw["data"]["team-a"] = json.dumps({"limitHBM": 8})
        side.api.update_configmap(cm)
    pair.wait_limit("team-a", 8)
    pair.create_pod(make_pod("a-after", hbm=16, namespace="team-a"))
    bound, failed = pair.schedule("a-after", namespace="team-a")
    assert not bound and next(iter(failed.values())).startswith("quota:")
    # A deleted ConfigMap lifts every limit.
    for side in pair.sides:
        side.api.delete_configmap("kube-system", const.QUOTA_CONFIGMAP)
    pair.wait_limit("team-a", None)
    bound, where = pair.schedule("a-after", namespace="team-a")
    assert bound, where
    pair.debug_quota()


def test_a_configmap_outside_the_quota_namespace_is_ignored(monkeypatch):
    """``TPUSHARE_QUOTA_NAMESPACE`` moves the trusted namespace on both."""
    monkeypatch.setenv("TPUSHARE_QUOTA_NAMESPACE", "quota-ns")
    pair = Pair()
    try:
        pair.create_node(make_node("v5e-0"))
        for side in pair.sides:
            side.api.create_configmap(quota_cm({"t": {"limitHBM": 4}}))
            side.api.create_configmap(quota_cm({"t": {"limitHBM": 8}},
                                               namespace="quota-ns"))
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not all(
                side.stack.controller.quota.config_for("t").limit_hbm == 8
                for side in pair.sides):
            time.sleep(0.02)
        pair.create_pod(make_pod("p", hbm=6, namespace="t"))
        bound, where = pair.schedule("p", namespace="t")
        assert bound, where
        pair.create_pod(make_pod("q", hbm=6, namespace="t"))
        bound, failed = pair.schedule("q", namespace="t")
        assert not bound and "limit 8 GiB" in next(iter(failed.values()))
    finally:
        pair.close()
