"""Phase 2j of ``chip_smoke.py``: fleet autoscaling and the serving router
on the card.

``chip_smoke.py`` imports this module and calls :func:`autoscale_tenant`
(before phase 2i, so the tenant's imports overlap it) and
:func:`autoscale_phase`; both take the ``chip_smoke`` module itself as
``cs`` for its harness (the extender client, the daemon's grants, the
serving tenant and their checks). :func:`router_overhead_replay` runs
after phase 8: ``bench_router_torch.replay`` at the admission overhead
phase 8 measured on the card. Run the phase alone with::

    python3 tools/extender_phases.py --only 2j --out autoscale.json
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from tpushare_torch import obs as tobs
from tpushare_torch import slo as tslo
from tpushare_torch.cmd import main as extender_main
from tpushare_torch.deviceplugin import discovery, plugin
from tpushare_torch.k8s.builders import make_pod
from tpushare_torch.k8s.fake import FakeApiServer
from tpushare_torch.router import DecodeReplica, Router
from tpushare_torch.runtime import torchenv
from tpushare_torch.utils import const

#: The card's node and the fake H100 nodes beside it.
AUTOSCALE_NODE = "chip-smoke-autoscale-node"
AUTOSCALE_FLEET = 3
#: The decode pod's GiB: decode-0's grant, so the scale-out's shape.
DECODE_GIB = 16
#: Free GiB each fake card keeps once filled (no decode pod fits there,
#: the card's small pod does), and the card's once filled (no decode pod
#: fits, one does once the small pod moves).
FLEET_FREE_GIB = 9
CARD_FREE_GIB = 10
CARD_SMALL_GIB = 8
#: The executor's posture: active, its loop an hour away (the phase
#: ticks by hand), no up delay or cooldown, and a down delay that passes
#: on its injected clock only (the bench's: three rounds of 300 s).
DOWN_DELAY_S = 900.0
AUTOSCALE_ENV = {"TPUSHARE_AUTOSCALE": "active",
                 "TPUSHARE_AUTOSCALE_INTERVAL_S": "3600",
                 "TPUSHARE_AUTOSCALE_UP_DELAY_S": "0",
                 "TPUSHARE_AUTOSCALE_COOLDOWN_S": "0",
                 "TPUSHARE_AUTOSCALE_DOWN_DELAY_S": str(DOWN_DELAY_S),
                 "TPUSHARE_DEFRAG_INTERVAL_S": "3600"}
#: The router's tenants: quota guarantees (GiB) from the
#: ``tpushare-quotas`` ConfigMap the scheduler reads, and arrivals a
#: virtual second in the surge. burst floods past its standing.
TENANTS = {"chat-a": (32, 2.0), "chat-b": (32, 2.0), "burst": (32, 30.0)}
#: The decode pods' namespace, a tenant whose guarantee holds all three
#: (so no defrag move and no drain evicts a decode replica), and the
#: fillers', which no guarantee covers.
SERVING_NS = "serving"
SERVING_GUARANTEE_GIB = 3 * DECODE_GIB
FILL_NS = "batch"
#: The stream's seed, the router's tick on its virtual clock and the
#: surge's length (the scale-out fires once its cooldown, 1 s, passed).
ROUTER_SEED = 29
ROUTER_DT = 0.05
SURGE_S = 1.0
#: New tokens of each request of the second surge: burst's, sent at one
#: instant, enough of them to queue past half the fleet's slots.
SECOND_SURGE_NEW = 64
#: The analytic replica decode-0 (the reference's e2e story's).
DECODE0 = {"slots": 4, "decode_tok_s": 1000.0, "prefill_tok_s": 1e9}
MAX_LEN = 2048


def quota_configmap() -> dict:
    return {"apiVersion": "v1", "kind": "ConfigMap",
            "metadata": {"name": const.QUOTA_CONFIGMAP,
                         "namespace": "kube-system"},
            "data": {t: json.dumps({"guaranteeHBM": g, "limitHBM": 4 * g})
                     for t, (g, _) in {
                         **TENANTS,
                         SERVING_NS: (SERVING_GUARANTEE_GIB, 0)}.items()}}


def autoscale_tenant(cs, inv: discovery.HostInventory, usage_dir: str):
    """Phase 2j's tenant, started now, gated: in the allocation the
    port's daemon will give decode-1 on the first card."""
    tenant = cs.ServingTenant(plugin.build_allocation(
        inv, [inv.chips[0].index], DECODE_GIB, pod_uid="uid-decode-1",
        usage_dir=usage_dir), gated=True)
    tenant.launch()
    return tenant


def start_twins() -> list[subprocess.Popen]:
    """The host twins of ``bench_router.py`` and ``bench.py --autoscale``
    (``--smoke``), each a process of its own, left running beside the
    phase."""
    repo = os.path.dirname(os.path.abspath(__file__))
    return [subprocess.Popen([sys.executable, os.path.join(repo, script),
                              "--smoke"], cwd=repo, text=True,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.DEVNULL)
            for script in ("bench_router_torch.py",
                           "bench_autoscale_torch.py")]


def twin_documents(cs, procs: list[subprocess.Popen]) -> dict:
    docs = {}
    for name, proc in zip(("bench_router", "bench_autoscale"), procs):
        out, _ = proc.communicate(timeout=300)
        cs.check(proc.returncode == 0, f"the {name} twin exited "
                                       f"{proc.returncode}")
        docs[name] = json.loads(out.strip().splitlines()[-1])
    return docs


def fill_to(cs, api, client, stack, node: str, keep: int, prefix: str,
            start: int = 0, annotations: dict | None = None) -> int:
    """Ledger-only pods in ``FILL_NS`` on ``node`` (filter and bind, no
    grant), one a card, until each card keeps ``keep`` GiB free: the card
    with the least room above ``keep`` first, so binpack lands each
    there. Returns the pods made."""
    made = 0
    while True:
        info = stack.controller.cache.get_node_info(node)
        free = sorted(c.total_hbm - c.get_used_hbm()
                      for c in info.chips.values())
        room = [f for f in free if f > keep]
        if not room:
            return made
        name = f"{prefix}-{start + made}"
        pod = api.create_pod(make_pod(name, hbm=room[0] - keep,
                                      namespace=FILL_NS, uid=f"uid-{name}",
                                      annotations=annotations))
        got, _, _ = client.schedule(pod, [node])
        cs.check(got == node, f"{name} went to {got}")
        made += 1


class Stream:
    """The seeded open-loop stream on the router's virtual clock."""

    def __init__(self, router: Router, clock: list[float]):
        self.router = router
        self.clock = clock
        self.rng = np.random.default_rng(ROUTER_SEED)
        self.outcomes: dict[str, dict[str, int]] = {
            t: {"assigned": 0, "queued": 0, "shed": 0} for t in TENANTS}

    def submit(self, tenant: str, max_new: int) -> None:
        prompt = int(self.rng.choice([32, 64, 128, 256, 512]))
        dec = self.router.submit(tenant, prompt, max_new)
        self.outcomes[tenant][dec["outcome"]] += 1

    def run(self, seconds: float, rates: dict[str, float]) -> None:
        for _ in range(int(round(seconds / ROUTER_DT))):
            self.clock[0] = round(self.clock[0] + ROUTER_DT, 6)
            for tenant, rate in rates.items():
                for _ in range(int(self.rng.poisson(rate * ROUTER_DT))):
                    self.submit(tenant, int(self.rng.integers(100, 400)))
            self.router.tick()


def autoscale_phase(cs, inv: discovery.HostInventory, usage_dir: str,
                    fleet: int = AUTOSCALE_FLEET, tenant=None) -> dict:
    """Phase 2j: fleet autoscaling and the serving router on the card.

    (a) One port extender (``serve_stack(api, router=router)``,
    ``AUTOSCALE_ENV``) over a fake apiserver holding the card's node as
    the port's daemon advertises it and ``fleet`` fake H100 nodes, a
    ``tpushare-quotas`` ConfigMap, and the executor's clock injected; the
    ``Router`` on a virtual clock, its standing the stack's quota ledger,
    with one analytic replica, decode-0, placed on a fake node by filter
    and bind; the fake cards filled with ledger-only pods so the decode
    shape fits only the card's node. (b) A seeded stream of three
    tenants fills the fleet and queues; burst floods past its standing.
    The router raises scale-out (its counter, ``/debug/router``'s
    ``wanted``, the ``router-scaleout`` marker); the callback, the
    scheduler's side, ticks the autoscaler (a ``capacity-exists`` hold,
    no node bought), creates decode-1, places it on the card's node by
    filter and bind over HTTP, has the daemon grant it over gRPC, starts
    the gated tenant in that env (``plain_stream_checks``) and registers
    ``DecodeReplica.from_grant`` over the grant, its slots the port's
    ``max_batch_for_grant``. The queues drain; burst alone is shed.
    (c) The card filled; a second surge's scale-out: decode-2 refused
    everywhere, a ``defrag-first`` hold (moving the card's small pod
    would unblock it); every resident then carries a checkpoint in
    flight, and the next tick scales up (a node by ``elect_template``,
    the ``autoscale-up`` marker, the ``up`` count); decode-2 binds
    there, ledger-only. (d) The stream stops, decode-2 is deleted, the
    down delay passes on the injected clock, and the executor drains and
    deletes the provisioned node (``autoscale-down`` markers,
    ``tpushare_cluster_nodes`` back to the fleet); the card's node is
    never elected. The host twins run beside it in processes of their
    own. Returns the phase's fields; ``launches`` is the tenant's
    forward count."""
    t_phase = time.perf_counter()
    twins = start_twins()
    card_gib = inv.chips[0].hbm_gib
    fleet_inv = discovery.fake_inventory(chips=cs.EXTENDER_FLEET_CARDS)
    tenant = tenant or autoscale_tenant(cs, inv, usage_dir)
    predicted = tenant.alloc
    tobs.reset()
    tslo.reset()
    api = FakeApiServer()
    vclock = [0.0]
    as_clock = [0.0]
    router = Router(clock=lambda: vclock[0], scaleout_queue_factor=0.5,
                    scaleout_cooldown_s=1.0, shed_slack=3.0)
    stack = server = client = grants = pdir = None
    decisions: list[dict] = []
    served = got = stream_check = None
    timing: dict = {}
    try:
        api.create_configmap(quota_configmap())
        with cs._env(**AUTOSCALE_ENV):
            stack, server = extender_main.serve_stack(api, router=router)
        client = cs.ExtenderClient(server)
        ex = stack.controller.autoscale
        cs.check((ex.mode, ex.interval_s, ex.up_delay_s, ex.cooldown_s,
                  ex.down_delay_s) == ("active", 3600.0, 0.0, 0.0,
                                       DOWN_DELAY_S)
                 and ex.router is router
                 and ex.demand is stack.predicate.demand
                 and ex.budget is stack.controller.defrag.budget,
                 f"the executor did not read AUTOSCALE_ENV: {ex.status()}")
        ex._now = lambda: as_clock[0]
        router.quota = stack.controller.quota

        def tick(label: str) -> dict | None:
            t0 = time.perf_counter()
            doc = ex.tick()
            ms = (time.perf_counter() - t0) * 1e3
            decisions.append({"at": label, "ms": ms, "action":
                              doc and doc["action"],
                              "reason": doc and doc.get("reason"),
                              "phase": doc and doc.get("phase"),
                              "node": doc and doc.get("node")})
            return doc

        # (a) The fleet.
        api.create_node(cs.advertised_node(AUTOSCALE_NODE, inv))
        pdir = tempfile.mkdtemp(prefix="chip_smoke-as-")
        plugin.TPUSharePlugin(AUTOSCALE_NODE, api, inv, state_dir=pdir,
                              usage_dir=usage_dir).annotate_node()
        names = [AUTOSCALE_NODE]
        for i in range(fleet):
            names.append(f"h100-as-{i}")
            api.create_node(cs.advertised_node(names[-1], fleet_inv))
            plugin.TPUSharePlugin(names[-1], api, fleet_inv,
                                  usage_dir="").annotate_node()
        cs.check(stack.controller.wait_idle(timeout=60),
                 "the extender's controller did not settle")
        # Every ledger warm, as a fleet's is from the informer's first
        # sync: the autoscaler sizes the fleet from the ledgers it has.
        for name in names:
            stack.controller.cache.get_node_info(name)
        cs._until(lambda: stack.controller.quota.configured("burst"), 30,
                  "the quota ConfigMap applied")
        grants = cs.NodeGrants(AUTOSCALE_NODE, api, inv, pdir, usage_dir)
        pod0 = api.create_pod(make_pod("decode-0", hbm=DECODE_GIB,
                                       namespace=SERVING_NS,
                                       uid="uid-decode-0"))
        node0, _, _ = client.schedule(pod0, [names[1]])
        cs.check(node0 == names[1], f"decode-0 went to {node0}")
        router.add_replica(DecodeReplica("decode-0", node=node0,
                                         hbm_gib=float(DECODE_GIB),
                                         max_len=MAX_LEN, **DECODE0))
        fills = 0
        for node in names[1:]:
            fills += fill_to(cs, api, client, stack, node, FLEET_FREE_GIB,
                             "as-fleet", fills)
        cs.check(stack.controller.wait_idle(timeout=60),
                 "the extender's controller did not settle")

        # (b) The surge, the scale-out, decode-1 served on the card.
        # The counters are the process's: the phase reads their rises.
        before = client.metrics()
        stream = Stream(router, vclock)
        calls: list[dict] = []

        def scale_out(spec: dict) -> None:
            """The scheduler's side of a scale-out signal."""
            calls.append(spec)
            if len(calls) == 1:
                first_scale_out(spec)
            else:
                second_scale_out(spec)

        def first_scale_out(spec: dict) -> None:
            nonlocal served, got
            t0_unix, t0 = time.time(), time.perf_counter()
            snap = client.get("/debug/router", prefixed=False)
            metrics = client.metrics()
            cs.check(snap["scaleOut"]["wanted"]
                     and snap["scaleOut"]["signals"] == 1
                     and cs.sample(metrics,
                                   "tpushare_router_scaleout_signals_total")
                     == 1.0
                     and len(cs.markers_of(cs.timeline(client),
                                           "router-scaleout")) == 1,
                     f"the first scale-out: {snap['scaleOut']}")
            nodes = len(api.list_nodes())
            hold = tick("first scale-out")
            cs.check(hold is not None and hold["action"] == "hold"
                     and hold["reason"] == "capacity-exists"
                     and hold["demand"]["router"]["shape"] == [DECODE_GIB, 0]
                     and len(api.list_nodes()) == nodes,
                     f"the tick beside the first scale-out: {hold}")
            pod = api.create_pod(make_pod("decode-1",
                                          hbm=int(spec["hbmGiB"]),
                                          namespace=SERVING_NS,
                                          uid="uid-decode-1"))
            node, handler_ms, _ = client.schedule(pod, names)
            cs.check(node == AUTOSCALE_NODE, f"decode-1 went to {node}: "
                                             f"{client.last_bind}")
            t_bind = time.perf_counter()
            alloc, allocate_ms = grants.allocate("decode-1", DECODE_GIB)
            t_alloc = time.perf_counter()
            cs._granted(api, inv, "decode-1", SERVING_NS, DECODE_GIB,
                        usage_dir, alloc)
            cs.check(alloc == predicted, "the grant is not the env the "
                                         "tenant was started in")
            got = tenant.start()
            served = cs._serving(tenant, got, alloc, card_gib, api,
                                 AUTOSCALE_NODE, "decode-1", SERVING_NS,
                                 usage_dir)
            grant = torchenv.read_grant(alloc.envs)
            rep = DecodeReplica.from_grant("decode-1", grant,
                                           node=AUTOSCALE_NODE,
                                           max_len=MAX_LEN)
            want = cs.S.max_batch_for_grant(cs.M.ModelConfig(),
                                            grant.hbm_pod_gib,
                                            max_len=MAX_LEN)
            cs.check(rep.slots == want > 0, f"decode-1's slots {rep.slots}, "
                                            f"max_batch_for_grant {want}")
            router.add_replica(rep)
            timing["first"] = {
                "to_first_request_done_s":
                    got["first_request_done_unix"] - t0_unix,
                "control_plane_s": t_bind - t0,
                "allocate_s": t_alloc - t_bind,
                "tenant_s": got["first_request_done_unix"] - t0_unix
                - (t_alloc - t0),
                "bind_handlers_ms": handler_ms,
                "allocate_ms": allocate_ms, "slots": rep.slots}

        def second_scale_out(spec: dict) -> None:
            t0 = time.perf_counter()
            pod = api.create_pod(make_pod("decode-2",
                                          hbm=int(spec["hbmGiB"]),
                                          namespace=SERVING_NS,
                                          uid="uid-decode-2"))
            # The defrag-first check plans for the pending pods the
            # informer lists: let it see decode-2 first.
            cs.check(stack.controller.wait_idle(timeout=60),
                     "the extender's controller did not settle")
            node, _, _ = client.schedule(pod, names)
            cs.check(node is None, f"decode-2 fit on {node}")
            hold = tick("second scale-out")
            cs.check(hold is not None and hold["action"] == "hold"
                     and hold["reason"] == "defrag-first",
                     f"the tick beside the second scale-out: {hold}")
            residents = [p for p in api.list_pods() if p.node_name]
            for p in residents:
                p.metadata.setdefault("annotations", {})[
                    const.ANN_CKPT_IN_FLIGHT] = "true"
                api.update_pod(p)
            cache = stack.controller.cache

            def pinned(uid: str) -> bool:
                pod = cache.get_pod(uid)
                return (pod is not None
                        and const.ANN_CKPT_IN_FLIGHT in pod.annotations)
            cs._until(lambda: all(pinned(p.uid) for p in residents), 30,
                      "the checkpoints reached the ledger")
            up = tick("checkpoints in flight")
            cs.check(up is not None and up["action"] == "scale-up"
                     and up["election"]["kind"] == "template"
                     and up["election"]["clonedFrom"] in names[1:]
                     and not up["dryRun"]
                     and api.get_node(up["node"]) is not None,
                     f"the scale-up: {up}")
            new = up["node"]
            node = None
            deadline = time.time() + 30
            while node is None and time.time() < deadline:
                node, _, _ = client.schedule(
                    api.get_pod(SERVING_NS, "decode-2"), names + [new])
            cs.check(node == new, f"decode-2 went to {node}")
            router.add_replica(DecodeReplica(
                "decode-2", node=new, hbm_gib=float(DECODE_GIB),
                max_len=MAX_LEN, **DECODE0))
            timing["second"] = {"scale_up_s": time.perf_counter() - t0,
                                "node": new, "election": up["election"],
                                "residents_pinned": len(residents)}

        router.on_scaleout = scale_out
        rates = {t: r for t, (_, r) in TENANTS.items()}
        stream.run(SURGE_S + ROUTER_DT, rates)
        cs.check(len(calls) == 1, f"{len(calls)} scale-outs in the surge")
        stream.run(4.0, {t: 0.5 * r for t, r in rates.items()
                         if t != "burst"})
        snap = router.snapshot()
        shed = {t: o["shed"] for t, o in stream.outcomes.items()}
        cs.check(snap["queuedTotal"] == 0 and shed["burst"] > 0
                 and shed["chat-a"] == shed["chat-b"] == 0
                 and snap["tenants"]["chat-a"]["completed"] > 0,
                 f"the queues after decode-1: {snap['queuedTotal']}, "
                 f"shed {shed}")
        first_ttft = snap["ttft"]

        # (c) The card full, the second surge, the scale-up.
        # The card's filler checkpoints: the small pod is what a move
        # may take off the card.
        fill_to(cs, api, client, stack, AUTOSCALE_NODE,
                CARD_FREE_GIB + CARD_SMALL_GIB, "as-card",
                annotations={const.ANN_CKPT_IN_FLIGHT: "true"})
        small = api.create_pod(make_pod("as-card-small", hbm=CARD_SMALL_GIB,
                                        namespace=FILL_NS,
                                        uid="uid-as-card-small"))
        got_small, _, _ = client.schedule(small, [AUTOSCALE_NODE])
        cs.check(got_small == AUTOSCALE_NODE, f"the small pod: {got_small}")
        cs.check(stack.controller.wait_idle(timeout=60),
                 "the extender's controller did not settle")
        fleet_slots = router.snapshot()["fleetSlots"]
        for _ in range(fleet_slots + fleet_slots // 2 + 2):
            stream.submit("burst", SECOND_SURGE_NEW)
        as_clock[0] += 60.0
        stream.run(1.0, {})
        cs.check(len(calls) == 2, f"{len(calls)} scale-outs after the "
                                  f"second surge")

        # (d) The stream stops; the trough; the scale-down.
        new = timing["second"]["node"]
        vclock[0] += 3600.0
        router.tick()
        router.remove_replica("decode-2")
        router.tick()
        snap = router.snapshot()
        cs.check(snap["queuedTotal"] == 0 and not snap["scaleOut"]["wanted"],
                 f"the router after the stream: {snap['queuedTotal']}")
        api.delete_pod(SERVING_NS, "decode-2")
        cs._until(lambda: not ex._residents(new), 30,
                  "decode-2 left the ledger")
        as_clock[0] += DOWN_DELAY_S + 1.0
        down = tick("trough")
        cs.check(down is not None and down["action"] == "scale-down"
                 and down["node"] == new and down["phase"] == "delete",
                 f"the scale-down: {down}")
        cs._until(lambda: len(stack.controller.cache.sharing_node_infos())
                  == len(names), 30, "the provisioned node left the ledger")
        cs.check(api.get_node(new) is None and AUTOSCALE_NODE not in
                 [d["node"] for d in decisions],
                 f"the decisions: {decisions}")
        t0 = time.perf_counter()
        metrics = cs.parse_metrics(client.text("/metrics").decode())
        scrape_ms = (time.perf_counter() - t0) * 1e3
        nodes = {s: cs.sample(metrics, "tpushare_cluster_nodes", state=s)
                 for s in ("ready", "cordoned")}
        actions = {a: cs.rise(metrics, before,
                              "tpushare_autoscale_actions_total", action=a)
                   for a in ("hold", "up", "down", "deleted")}
        cs.check(nodes == {"ready": float(len(names)), "cordoned": 0.0}
                 and actions == {"hold": 2.0, "up": 1.0, "down": 1.0,
                                 "deleted": 1.0},
                 f"the gauges: nodes {nodes}, actions {actions}")
        doc = cs.timeline(client)
        markers = {k: len(cs.markers_of(doc, k)) for k in (
            "router-scaleout", "autoscale-up", "autoscale-down",
            "autoscale-abort")}
        cs.check(markers == {"router-scaleout": 2, "autoscale-up": 1,
                             "autoscale-down": 2, "autoscale-abort": 0},
                 f"markers: {markers}")
        status = client.get("/debug/autoscale", prefixed=False)
        cs.check(status["lastDecision"]["phase"] == "delete"
                 and status["fleet"]["nodes"] == len(names),
                 f"/debug/autoscale: {status}")
        code = tenant.stop()
        cs.check(code == 0, f"the tenant exited {code}")
        stream_check = cs.plain_stream_checks(got["stream"])
        router_doc = client.get("/debug/router", prefixed=False)
        docs = twin_documents(cs, twins)
    finally:
        tenant.stop()
        for proc in twins:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if grants is not None:
            grants.close()
        if client is not None:
            client.close()
        if stack is not None:
            extender_main.shutdown_stack(stack, server)
        if pdir is not None:
            shutil.rmtree(pdir, ignore_errors=True)
    return {
        "card_gib": card_gib, "fleet_nodes": fleet,
        "decisions": decisions, "scale_out": timing,
        "router": {"ttft_first_surge": first_ttft,
                   "ttft": router_doc["ttft"],
                   "shed": {t: o["shed"] for t, o in
                            stream.outcomes.items()},
                   "outcomes": stream.outcomes,
                   "fleet_slots": router_doc["fleetSlots"],
                   "signals": router_doc["scaleOut"]["signals"],
                   "replicas": [r["name"] for r in router_doc["replicas"]]},
        "cluster_nodes": nodes, "actions": actions, "markers": markers,
        "scrape_ms": scrape_ms, "tenant": served, "stream": stream_check,
        "twins": {"bench_router": {k: docs["bench_router"][k]
                                   for k in ("value", "gates")},
                  "bench_autoscale": {k: docs["bench_autoscale"][k]
                                      for k in ("value", "gates")}},
        "twin_documents": docs,
        "seconds": time.perf_counter() - t_phase,
        "launches": {"autoscale_tenant": served["launches"]}}


def router_overhead_replay(card: str, overhead_pct: float) -> dict:
    """``bench_router_torch.replay`` (its ``--smoke`` phases) with the
    admission overhead phase 8 measured on the card, beside the same
    replay at the reference's 10% figure."""
    import bench_router_torch as BR

    common = dict(replicas=6, slots=8, steady_s=8.0, surge_s=6.0,
                  recovery_s=10.0, provision_delay_s=3.0, max_extra=4,
                  seed=7)
    t0 = time.perf_counter()
    card_run = BR.replay(overhead=overhead_pct / 100.0, **common)
    reference = BR.replay(overhead=BR.OVERHEAD_CHUNKED, **common)

    def head(doc: dict) -> dict:
        return {"surge_ttft": doc["phases"]["surge"]["ttft"],
                "steady_ttft": doc["phases"]["steady"]["ttft"],
                "fleetTokensPerS": doc["fleetTokensPerS"],
                "shedTotal": doc["shedTotal"],
                "scaleOutSignals": doc["scaleOut"]["signals"],
                "fairnessJainSurge": doc["fairnessJainSurge"]}
    return {"card": card, "admission_overhead_pct": overhead_pct,
            "at_card_overhead": head(card_run),
            "at_reference_overhead": head(reference),
            "seconds": time.perf_counter() - t0}
