"""The port's serving router (``tpushare_torch/router/``) against the JAX
package's.

* The reference's stories of ``tests/test_router.py`` over the port's
  router (``tests/torch_reference_stories.py``): the routing policy
  (``TestRoutingPolicy``), paged routing (``TestPagedRouting``), the
  bucket table (``TestServingIntegration``) and ``/debug/router``'s 404
  on a stack with no router. The two cases that size a replica from a
  ``jaxenv`` grant are run here over ``torchenv.ShareGrant`` and the
  port's ``serving``, and held to the reference's numbers.
* Both ``Router``s on one virtual clock, fed the same seeded open-loop
  streams (three tenants under a quota table, one flooding past its
  standing; rows and paged replicas; prompts that declare a shared
  prefix; replicas added and removed mid-stream): the same decision for
  every request, the same events at every tick, the same ``snapshot()``
  after every tick and the same scale-out callbacks.
* The surge, scale-out, bind and drain story of ``TestServingE2E`` over
  both ``serve_stack``s (``tests/test_torch_extender_e2e.py``'s ``Pair``,
  each side holding its own router): the scale-out callback schedules
  the decode pod through filter, prioritize and bind on both, the
  registered replica drains the queues, only the flooder sheds,
  ``/debug/router`` is the same document on both, and the frozen
  ``tools/kubectl_inspect_tpushare.py``'s ``serving`` view renders both
  alike.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from tests import torch_reference_stories as R
from tests.test_torch_extender_e2e import Pair
from tests.torch_obs_reset import fresh_port_obs  # noqa: F401
from tpushare.api.objects import ConfigMap as JConfigMap
from tpushare.k8s.builders import make_node, make_pod
from tpushare.quota import config as jquota_config
from tpushare.quota.manager import QuotaManager as JQuota
from tpushare.router import DecodeReplica as JReplica, Router as JRouter
from tpushare_torch.api.objects import ConfigMap as TConfigMap
from tpushare_torch.quota import config as tquota_config
from tpushare_torch.quota.manager import QuotaManager as TQuota
from tpushare_torch.router import DecodeReplica as TReplica, Router as TRouter
from tpushare_torch.runtime.torchenv import ShareGrant
from tpushare_torch.workload import model as M
from tpushare_torch.workload import paging as P
from tpushare_torch.workload import serving as S

# -- the reference's stories over the port --------------------------------- #

_STORIES = R.load("test_router")
globals().update(R.pick(
    _STORIES, ["TestRoutingPolicy", "TestPagedRouting",
               "TestServingIntegration"],
    leave_out=("TestPagedRouting.test_from_grant_paged_doubles_slots_and_"
               "prices_pages",
               "TestServingIntegration.test_from_grant_sizes_slots_like_"
               "the_tenant")))


class TestServingE2E(_STORIES.TestServingE2E):
    """The wire story without a router; the surge story runs over both
    stacks below."""

    test_surge_scaleout_bind_drain_story = None


def test_prompt_buckets_are_the_reference_s():
    from tpushare.router import router as JR
    from tpushare_torch.router import router as TR
    assert TR.PROMPT_BUCKETS == JR.PROMPT_BUCKETS == S.PROMPT_BUCKETS
    assert TR.PROMPT_BUCKETS == P.PROMPT_BUCKETS


@pytest.mark.parametrize("gib", [4, 8, 16])
def test_from_grant_sizes_slots_like_the_tenant(gib):
    """Slots are the port's ``max_batch_for_grant`` over the torchenv
    grant, and equal the reference's replica over its jaxenv grant."""
    from tpushare.runtime.jaxenv import ShareGrant as JGrant

    grant = ShareGrant(chip_ids=(0,), hbm_pod_gib=gib, hbm_chip_gib=79)
    rep = TReplica.from_grant("decode-0", grant, max_len=2048)
    assert rep.slots == S.max_batch_for_grant(M.ModelConfig(), gib,
                                              max_len=2048)
    assert rep.slots > 0 and rep.hbm_gib == float(gib)
    want = JReplica.from_grant("decode-0", JGrant(
        chip_ids=(0,), hbm_pod_gib=gib, hbm_chip_gib=79), max_len=2048)
    assert (rep.slots, rep.pages_total) == (want.slots, want.pages_total)
    tiny = ShareGrant(chip_ids=(0,), hbm_pod_gib=0, hbm_chip_gib=79)
    with pytest.raises(ValueError, match="cannot"):
        TReplica.from_grant("decode-1", tiny)


@pytest.mark.parametrize("gib", [4, 8])
def test_from_grant_paged_doubles_slots_and_prices_pages(gib):
    from tpushare.runtime.jaxenv import ShareGrant as JGrant

    grant = ShareGrant(chip_ids=(0,), hbm_pod_gib=gib, hbm_chip_gib=79)
    rows = TReplica.from_grant("r", grant, max_len=2048)
    paged = TReplica.from_grant("p", grant, max_len=2048, paged=True)
    assert paged.slots == 2 * rows.slots
    assert paged.pages_total == S.pages_for_grant(M.ModelConfig(), gib)
    assert paged.pages_total >= rows.slots * (2048 // 64)
    want = JReplica.from_grant("p", JGrant(
        chip_ids=(0,), hbm_pod_gib=gib, hbm_chip_gib=79), max_len=2048,
        paged=True)
    assert (paged.slots, paged.pages_total) == (want.slots,
                                                want.pages_total)


def test_from_grant_of_a_tiny_config():
    """A caller's config sizes the replica (the port's config, the port's
    arithmetic)."""
    cfg = M.ModelConfig().tiny()
    grant = ShareGrant(chip_ids=(0,), hbm_pod_gib=1, hbm_chip_gib=79)
    rep = TReplica.from_grant("t", grant, cfg=cfg, max_len=256)
    assert rep.slots == S.max_batch_for_grant(cfg, 1, max_len=256) > 0


# -- both routers on one seeded stream --------------------------------------- #

class Clock:
    def __init__(self) -> None:
        self.now = 0.0

    def __call__(self) -> float:
        return self.now


#: The stream's tenants: (name, arrivals a second, guarantee GiB).
TENANTS = (("chat", 40.0, 32), ("batch", 20.0, 16), ("burst", 160.0, 16))


def quota_pair() -> tuple[JQuota, TQuota]:
    """Each package's quota ledger under one ``tpushare-quotas`` table of
    the stream's tenants."""
    cm = {"metadata": {"name": "tpushare-quotas", "namespace": "kube-system"},
          "data": {name: json.dumps({"guaranteeHBM": g, "limitHBM": 2 * g})
                   for name, _, g in TENANTS}}
    out = []
    for cfg_mod, mgr, doc in ((jquota_config, JQuota, JConfigMap),
                              (tquota_config, TQuota, TConfigMap)):
        q = mgr()
        q.set_config(cfg_mod.parse_configmap(doc(cm)))
        out.append(q)
    return out[0], out[1]


def event_tuples(events) -> list:
    return [(e.kind, e.rid, round(e.at, 9)) for e in events]


def make_replicas(rng, cls) -> list:
    """Two to four replicas, rows or paged, with seeded service rates."""
    draws = np.random.default_rng(int(rng.integers(1 << 30)))
    out = []
    for i in range(int(draws.integers(2, 5))):
        paged = bool(draws.random() < 0.5)
        kw = dict(slots=int(draws.integers(2, 9)), node=f"n{i}",
                  hbm_gib=float(draws.choice([8, 16])),
                  decode_tok_s=float(draws.choice([800.0, 2000.0, 8400.0])),
                  prefill_tok_s=float(draws.choice([5e3, 2e5])),
                  admission_overhead=float(draws.choice([0.1, 0.22])))
        if paged:
            kw["pages_total"] = int(draws.integers(20, 200))
        out.append(cls(f"decode-{i}", **kw))
    return out


def replay(seed: int, side: str, steps: int = 120) -> list:
    """One router over the seeded stream; returns everything it said."""
    rng = np.random.default_rng(seed)
    clock = Clock()
    jq, tq = quota_pair()
    router_cls, rep_cls, quota = ((JRouter, JReplica, jq) if side == "jax"
                                  else (TRouter, TReplica, tq))
    fired: list = []
    router = router_cls(quota=quota if seed % 2 == 0 else None, clock=clock,
                        queue_limit=64, shed_slack=1.5,
                        scaleout_queue_factor=0.5, scaleout_cooldown_s=0.5,
                        on_scaleout=fired.append)
    for rep in make_replicas(rng, rep_cls):
        router.add_replica(rep)
    out: list = []
    extra = 0
    for step in range(steps):
        clock.now = round(clock.now + 0.05, 6)
        for name, rate, _ in TENANTS:
            rate = rate if step < steps // 2 or name != "burst" else 5.0
            for _ in range(int(rng.poisson(rate * 0.05))):
                prompt = int(rng.choice([20, 60, 100, 300, 700, 1500]))
                kw = {}
                if rng.random() < 0.3:
                    kw = {"prefix_key": "sys", "prefix_len": 256}
                out.append(router.submit(name, prompt,
                                         int(rng.integers(4, 200)), **kw))
        out.append(event_tuples(router.tick()))
        if step % 30 == 29:
            extra += 1
            router.add_replica(rep_cls(f"late-{extra}", slots=4,
                                       hbm_gib=8.0, decode_tok_s=4000.0,
                                       prefill_tok_s=2e5))
        if step == steps - 20:
            router.remove_replica("decode-0")
        out.append(router.snapshot())
    out.append(list(fired))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_both_routers_say_the_same_on_one_stream(seed):
    want = replay(seed, "jax")
    got = replay(seed, "port")
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(want, got)):
        assert b == a, (i, a, b)
    decisions = [d for d in want if isinstance(d, dict) and "outcome" in d]
    outcomes = {d["outcome"] for d in decisions}
    assert {"assigned", "queued", "shed"} <= outcomes
    SCALEOUTS[seed] = len(want[-1])


#: Scale-out callbacks each seed's stream raised (filled by the test above).
SCALEOUTS: dict[int, int] = {}


def test_the_streams_raise_the_scaleout_signal():
    for seed in range(6):
        if seed not in SCALEOUTS:
            SCALEOUTS[seed] = len(replay(seed, "port")[-1])
    assert sum(1 for n in SCALEOUTS.values() if n) >= 3, SCALEOUTS


# -- the surge story over both stacks ---------------------------------------- #

def router_pair(clock) -> Pair:
    """Both stacks, each side's router under ``tests/test_router.py``'s
    quota table."""
    from tests.test_router import quota_mgr
    jq, tq = quota_mgr(), _STORIES.quota_mgr()
    return Pair((
        JRouter(quota=jq, clock=clock, scaleout_queue_factor=0.5,
                scaleout_cooldown_s=1.0, shed_slack=2.0),
        TRouter(quota=tq, clock=clock, scaleout_queue_factor=0.5,
                scaleout_cooldown_s=1.0, shed_slack=2.0)))


def test_surge_scaleout_bind_drain_story_on_both_stacks():
    clock = Clock()
    pair = router_pair(clock)
    try:
        pair.create_node(make_node("n0", chips=4, hbm_per_chip=16))
        bound: list = []

        def register(name: str, hbm: float) -> None:
            for side, cls in ((pair.jax, JReplica), (pair.port, TReplica)):
                side.router.add_replica(cls(
                    name, slots=4, node="n0", hbm_gib=hbm,
                    decode_tok_s=1000.0, prefill_tok_s=1e9))

        def on_scaleout(spec: dict) -> None:
            # Called once a side: the port's callback does the work.
            name = f"decode-{len(bound) + 1}"
            pair.create_pod(make_pod(name, hbm=int(spec["hbmGiB"])))
            ok, node = pair.schedule(name)
            assert ok and node == "n0", node
            bound.append(name)
            register(name, float(spec["hbmGiB"]))

        specs: list = []
        pair.jax.router.on_scaleout = specs.append
        pair.port.router.on_scaleout = on_scaleout
        pair.create_pod(make_pod("decode-0", hbm=8))
        assert pair.schedule("decode-0") == (True, "n0")
        register("decode-0", 8.0)

        outs = []
        for side in pair.sides:
            r = side.router
            got = [r.submit("chat", 64, 400)["outcome"] for _ in range(4)]
            got += [r.submit("chat", 64, 50)["outcome"] for _ in range(3)]
            got += [r.submit("burst", 64, 50)["outcome"] for _ in range(8)]
            outs.append(got)
        assert outs[1] == outs[0]
        assert outs[0][:7] == ["assigned"] * 4 + ["queued"] * 3
        assert "shed" in outs[0][7:]
        clock.now = 2.0
        for side in pair.sides:
            side.router.tick()
        assert bound == ["decode-1"] and len(specs) == 1
        assert specs[0]["hbmGiB"] == 8.0
        for side in pair.sides:
            side.idle()
        clock.now = 62.0
        for side in pair.sides:
            side.router.tick()
        docs = [json.loads(side.get("/debug/router")[1])
                for side in pair.sides]
        assert docs[1] == docs[0]
        doc = docs[0]
        assert doc["queuedTotal"] == 0 and len(doc["replicas"]) == 2
        assert doc["tenants"]["chat"]["shed"] == 0
        assert doc["tenants"]["chat"]["completed"] >= 4
        assert doc["tenants"]["burst"]["shed"] >= 1
        assert doc["scaleOut"]["signals"] >= 1
        for side in pair.sides:
            text = side.get("/metrics")[1].decode()
            assert 'tpushare_router_shed_total{tenant="burst"}' in text
            assert "tpushare_router_fleet_slots 8" in text
        # The frozen inspect tool's serving view renders both alike.
        import tools.kubectl_inspect_tpushare as cli
        views = [cli.render_serving(cli.fetch_router(side.base))
                 for side in pair.sides]
        assert views[1] == views[0]
        assert "decode-1" in views[0] and "burst" in views[0]
        assert "scale-out" in views[0]
        assert pair.port.api.get_pod("default", "decode-1").node_name == "n0"
    finally:
        pair.close()
