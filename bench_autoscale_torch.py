"""The port's twin of ``bench.py --autoscale``: the diurnal-wave scenario
over the port's extender (``tpushare_torch``: its stack, its autoscale
executor on the injected clock, its fake apiserver), on the same v5p node
documents as the reference, so that its JSON line equals the reference's.

An autoscaled fleet starting at one node must match the peak-sized static
fleet's pod-SLO compliance on <= 70% of its node-hours, with zero
tenant-guarantee evictions across every drain; the slice-completion phase
must provision at ring contiguity 1.0. The gates are those of
``BENCH_AUTOSCALE.json``; they are reported, and enforced only with
``--gate``. Prints ONE JSON line and writes no file::

    python3 bench_autoscale_torch.py --smoke
    python3 bench_autoscale_torch.py --gate
"""

from __future__ import annotations

import http.client
import json
import sys

#: The reference bench's v5p host: chips a host and GiB a chip.
CHIPS, CHIP_HBM = 4, 95

#: Ceiling the autoscaled fleet may grow to — and the FIXED size of the
#: static baseline it is judged against (a fleet sized for the peak).
AS_PEAK_NODES = 8
#: One synthetic "day": a half-sine of arrivals, then a quiet trough.
AS_ROUNDS = 24
AS_PEAK_ARRIVALS = 9
#: Wave-pod lifetime (rounds) — short, so the trough actually empties.
AS_TTL_ROUNDS = 3
#: SLO: a wave pod must bind within this many rounds of arriving.
AS_SLO_ROUNDS = 3
#: Simulated seconds per round, fed to the executor's injected clock
#: (hysteresis is wall-clock math; the bench must not sleep 2 hours).
AS_ROUND_S = 300.0
#: Gate: autoscaled node-hours / peak-static node-hours.
GATE_AS_NODE_HOURS = 0.70



class ExtenderClient:
    """Persistent keep-alive connection, like kube-scheduler's HTTP
    transport (connection reuse is the production calling pattern; a
    fresh TCP handshake per webhook call would charge the benchmark for
    connection setup the scheduler never pays)."""

    def __init__(self, host: str, port: int):
        self.host, self.port = host, port
        self.conn = None
        self._connect()

    def _connect(self):
        import socket
        self.conn = http.client.HTTPConnection(self.host, self.port)
        # Nagle off on the CLIENT side too (the server handler already
        # disables it): a request whose headers and body land in
        # separate segments must not wait on a delayed ACK.
        self.conn.connect()
        self.conn.sock.setsockopt(socket.IPPROTO_TCP,
                                  socket.TCP_NODELAY, 1)

    def idle(self):
        """Drop the keep-alive connection (next request re-dials). An
        idle in-process connection PINS one of the extender's pool
        workers for up to its socket timeout; the subprocess
        concurrency storm needs every worker, so benches release the
        harness connection before spawning it."""
        self.conn.close()

    #: Verbs safe to re-send after a dropped keep-alive connection.
    #: Mutating verbs (bind/preempt) are NOT: a drop after the server
    #: processed the request would re-execute the mutation, and the
    #: second bind's already-bound 500 would corrupt the run — those
    #: fail loudly instead (in practice they never hit the idle-close
    #: race: they always follow a filter on a fresh connection).
    RETRY_SAFE = ("/filter", "/prioritize", "/inspect")

    def _roundtrip(self, path, body):
        """One POST, with a single reconnect retry for READ verbs: the
        extender closes keep-alive connections idle past its socket
        timeout (the pool worker moves on), and a production HTTP
        transport re-dials transparently — so does this one."""
        try:
            if self.conn.sock is None:  # closed via idle(): re-dial
                self._connect()
            self.conn.request("POST", path, body,
                              {"Content-Type": "application/json"})
            return self.conn.getresponse()
        except (BrokenPipeError, ConnectionResetError,
                http.client.RemoteDisconnected):
            if not path.endswith(self.RETRY_SAFE):
                raise
            self._connect()
            self.conn.request("POST", path, body,
                              {"Content-Type": "application/json"})
            return self.conn.getresponse()

    def post(self, path, doc):
        resp = self._roundtrip(path, json.dumps(doc).encode())
        return resp.status, json.loads(resp.read())

    def close(self):
        self.conn.close()



class _Fleet:
    """A v5p fleet behind the real HTTP stack (fake apiserver +
    controller + extender server + keep-alive client) — the setup every
    bench phase shares, kept in ONE place so stack-wiring changes cannot
    silently diverge between phases."""

    def __init__(self, prefix: str, nodes: int,
                 chips: int = CHIPS, chip_hbm: int = CHIP_HBM,
                 topology: str = "2x2x1", tpu_type: str = "v5p",
                 slice_id: str = "", slice_topology: str = "",
                 quotas: dict | None = None):
        from tpushare_torch.cmd.main import build_stack
        from tpushare_torch.k8s.builders import make_node
        from tpushare_torch.k8s.fake import FakeApiServer
        from tpushare_torch.routes.server import ExtenderHTTPServer, serve_forever
        from tpushare_torch.utils import const

        self.api = FakeApiServer()
        self.names = [f"{prefix}-{i:02d}" for i in range(nodes)]
        for i, n in enumerate(self.names):
            self.api.create_node(make_node(
                n, chips=chips, hbm_per_chip=chip_hbm,
                topology=topology, tpu_type=tpu_type,
                # Multi-host slice labels (the --topology scenario):
                # every host carries its slice id, the slice's chip
                # dims, and its worker index on the host grid.
                slice_id=slice_id, slice_topology=slice_topology,
                worker_index=i if slice_topology else None))
        if quotas:
            # Present before the stack boots, exactly like a live
            # cluster: the controller's informer seeds the quota table.
            self.api.create_configmap({
                "apiVersion": "v1", "kind": "ConfigMap",
                "metadata": {"name": const.QUOTA_CONFIGMAP,
                             "namespace": "kube-system"},
                "data": {tenant: json.dumps(spec)
                         for tenant, spec in quotas.items()}})
        # build_stack reads the fleet scoring default from env ONCE at
        # construction and pins it through the cache into every ledger
        # — callers needing a non-default policy export TPUSHARE_SCORING
        # before building the fleet (bench_inference does).
        self.stack = build_stack(self.api)
        self.stack.controller.start(workers=4)
        # Materialize every node's ledger up front: a prod fleet's
        # ledgers are warm from the controller's initial informer sync,
        # so the first measured filter must not pay 16 ledger builds.
        for n in self.names:
            self.stack.controller.cache.get_node_info(n)
        # Production GC posture (cmd/main.py applies the same at
        # startup): without it, occasional full collections land
        # multi-ms pauses in the measured p99 — the spike class the
        # scale work pinned (docs/perf.md).
        from tpushare_torch.utils.runtime import tune_gc
        tune_gc(freeze=True)
        self.server = ExtenderHTTPServer(
            ("127.0.0.1", 0), self.stack.predicate, self.stack.binder,
            self.stack.inspect, prioritize=self.stack.prioritize,
            preempt=self.stack.preempt)
        serve_forever(self.server)
        host, port = self.server.server_address[:2]
        self.base = f"http://{host}:{port}"
        self.client = ExtenderClient(host, port)

    def close(self):
        self.client.close()
        self.server.shutdown()
        self.stack.binder.gang_planner.stop()
        self.stack.controller.stop()


def _as_arrivals(rounds: int, peak: int) -> list[int]:
    """Arrivals per round: positive half-sine (ramp up to ``peak``,
    back down), then zero — the trough the scale-down half must
    harvest. Deterministic by construction: the wave IS the seed."""
    import math
    return [max(0, int(round(peak * math.sin(2 * math.pi * r / rounds))))
            for r in range(rounds)]


def _as_schedule(client, pod, candidates: list[str]) -> str | None:
    """filter -> prioritize -> bind through the wire protocol; the
    node bound to, or None when the pod fits nowhere (which is the
    moment the filter verb records it as unplaceable demand — the
    autoscaler's input)."""
    if not candidates:
        return None
    status, result = client.post("/tpushare-scheduler/filter",
                                 {"Pod": pod.raw,
                                  "NodeNames": candidates})
    assert status == 200, result
    cands = result["NodeNames"]
    if not cands:
        return None
    status, ranked = client.post("/tpushare-scheduler/prioritize",
                                 {"Pod": pod.raw, "NodeNames": cands})
    assert status == 200, ranked
    best = max(ranked, key=lambda e: e["Score"])["Host"]
    status, result = client.post("/tpushare-scheduler/bind", {
        "PodName": pod.name, "PodNamespace": pod.namespace,
        "PodUID": pod.uid, "Node": best})
    assert status == 200 and not result.get("Error"), result
    return best


def _bench_autoscale_wave(autoscaled: bool, rounds: int,
                          peak_nodes: int, peak_arrivals: int,
                          ttl: int) -> dict:
    """One diurnal wave against the REAL stack. ``autoscaled`` starts
    at ONE node with the executor active (injected clock, hysteresis
    compressed to round granularity); the baseline runs the same wave
    over a fixed peak-sized fleet. Returns per-run SLO compliance,
    node-hours, tenant-guarantee eviction violations, and the action
    tally."""
    from tpushare_torch.k8s import eviction
    from tpushare_torch.k8s.builders import make_pod
    from tpushare_torch.k8s.errors import NotFoundError
    from tpushare_torch.utils import node as nodeutils

    quotas = {"team-anchor": {"guaranteeHBM": 24}}
    fleet = _Fleet("as", 1 if autoscaled else peak_nodes,
                   quotas=quotas)
    api, client = fleet.api, fleet.client
    controller = fleet.stack.controller
    clock = [0.0]
    ex = controller.autoscale
    if autoscaled:
        ex.mode = "active"
        ex.min_nodes = 1
        ex.max_nodes = peak_nodes
        # Round-granular hysteresis on the injected clock: demand acts
        # immediately, a node must be provably idle for AS_SLO_ROUNDS
        # rounds before it drains (scale-down must lag the trough, not
        # flap inside it).
        ex.up_delay_s = 0.0
        ex.cooldown_s = 0.0
        ex.down_delay_s = AS_SLO_ROUNDS * AS_ROUND_S
        ex._now = lambda: clock[0]
        # The wave's disruption ceiling is the gate on guarantee
        # violations, not the shared hourly allowance (which assumes
        # wall-clock hours this bench compresses away).
        ex.budget = eviction.EvictionBudget(now=lambda: clock[0])
        # Process-global SLO engine may be burning from earlier bench
        # phases; the wave's own aborts are not under test here.
        ex._burning_fn = lambda: []

    # The anchor: a guarantee-protected resident (inside team-anchor's
    # 24-GiB guarantee) — drains must never evict it, so its node is
    # never electable and the violations gate has a live tripwire.
    anchor = api.create_pod(make_pod("anchor", hbm=24,
                                     namespace="team-anchor"))
    assert _as_schedule(client, anchor,
                        [n.name for n in api.list_nodes()])
    controller.wait_idle(timeout=10)

    wave = _as_arrivals(rounds, peak_arrivals)
    #: name -> {ns, ttl|None, node?, expires?, row|None}. ttl None =
    #: a lingerer that lives past the end of the wave.
    live: dict[str, dict] = {}
    pending: list[str] = []       # names awaiting capacity
    rows: list[dict] = []         # {arrival, bound_round|None}
    lingerers: list[str] = []     # long-lived trough residents
    fleet_trace: list[int] = []
    violations = 0
    actions: dict[str, int] = {}
    seq = 0

    def _candidates(pod):
        return [n.name for n in api.list_nodes()
                if nodeutils.is_schedulable(n, pod)]

    def _place(name: str, rnd: int) -> bool:
        rec = live[name]
        try:
            pod = api.get_pod(rec["ns"], name)
        except NotFoundError:
            return False
        node = _as_schedule(client, pod, _candidates(pod))
        if not node:
            return False
        rec["node"] = node
        if rec["ttl"] is not None:
            rec["expires"] = rnd + rec["ttl"]
        if rec["row"] is not None and rec["row"]["bound_round"] is None:
            rec["row"]["bound_round"] = rnd
        return True

    def _retry_pending(rnd: int) -> None:
        for name in pending[:]:
            if name not in live:
                pending.remove(name)
            elif _place(name, rnd):
                pending.remove(name)

    for rnd in range(rounds):
        clock[0] += AS_ROUND_S
        # -- completions ---------------------------------------------- #
        for name, rec in list(live.items()):
            if rec.get("expires", rounds + 1) <= rnd:
                api.update_pod_status(rec["ns"], name, "Succeeded")
                del live[name]
        controller.wait_idle(timeout=10)
        # -- arrivals -------------------------------------------------- #
        for _ in range(wave[rnd]):
            name = f"w-{seq:04d}"
            seq += 1
            api.create_pod(make_pod(name, chips=1))
            row = {"arrival": rnd, "bound_round": None}
            rows.append(row)
            live[name] = {"ns": "default", "ttl": ttl, "row": row}
            if not _place(name, rnd):
                pending.append(name)
        # At the peak, park two long-lived borrowers (no guarantee):
        # they survive the trough on a wave node, so harvesting it
        # exercises the evict -> re-place path, not just empty-node
        # deletion.
        if rnd == rounds // 4:
            for i in range(2):
                name = f"linger-{i}"
                api.create_pod(make_pod(name, chips=1,
                                        namespace="team-b"))
                live[name] = {"ns": "team-b", "ttl": None, "row": None}
                if not _place(name, rnd):
                    pending.append(name)
                lingerers.append(name)
        _retry_pending(rnd)
        # -- the executor's pass(es) for this round -------------------- #
        if autoscaled:
            # The round's arrivals reach the informer before the executor
            # reads their demand (the tracker prunes what it has not seen).
            controller.wait_idle(timeout=10)
            for _ in range(peak_nodes):
                decision = ex.tick()
                if decision is None:
                    break
                act = decision["action"]
                key = (act if act != "scale-down"
                       else f"scale-down/{decision['phase']}")
                actions[key] = actions.get(key, 0) + 1
                if act == "hold":
                    break
                controller.wait_idle(timeout=10)
                for ev in decision.get("evictions") or []:
                    if ev.get("status") != "evicted":
                        continue
                    ns, _, pname = ev["pod"].partition("/")
                    if ns == "team-anchor":
                        violations += 1
                        continue
                    # Job-controller replay: the evicted resident
                    # comes back and re-places on what remains.
                    api.create_pod(make_pod(pname, chips=1,
                                            namespace=ns))
                    if pname in live and not _place(pname, rnd):
                        pending.append(pname)
                controller.wait_idle(timeout=10)
                _retry_pending(rnd)
        fleet_trace.append(len(api.list_nodes()))

    for name in lingerers:
        assert api.get_pod("team-b", name) is not None, \
            f"lingerer {name} lost across the drain"
    fleet.close()
    ok = sum(1 for r in rows
             if r["bound_round"] is not None
             and r["bound_round"] - r["arrival"] <= AS_SLO_ROUNDS)
    return {
        "slo_compliance": round(ok / len(rows), 4) if rows else 1.0,
        "node_hours": sum(fleet_trace) * AS_ROUND_S / 3600.0,
        "fleet_min": min(fleet_trace),
        "fleet_max": max(fleet_trace),
        "guarantee_violations": violations,
        "arrivals": len(rows),
        "actions": actions,
    }


def _bench_autoscale_contiguity() -> dict:
    """Topology-aware scale-up: a 4x4x2 slice (2x2x2 host grid) with
    one host GONE and the rest pinned full (checkpoint-in-flight, so
    defrag-first honestly rules itself out). The provisioner must
    elect the slice-completing template — the grid closes, the host
    ring reaches contiguity 1.0, and the starved 4-chip pod binds on
    the new node."""
    from tpushare_torch.api.objects import Node
    from tpushare_torch.k8s.builders import make_pod
    from tpushare_torch.topology import fleet as topo
    from tpushare_torch.utils import const
    from tpushare_torch.utils import node as nodeutils

    fleet = _Fleet("sc", 8, slice_id="pod-a", slice_topology="4x4x2")
    api, client = fleet.api, fleet.client
    controller = fleet.stack.controller
    gone = fleet.names[3]
    api.delete_node(gone)
    controller.wait_idle(timeout=10)
    pin = {const.ANN_CKPT_IN_FLIGHT: "true"}
    for name in fleet.names:
        if name == gone:
            continue
        filler = api.create_pod(make_pod(f"pin-{name}", chips=CHIPS,
                                         annotations=pin))
        status, result = client.post("/tpushare-scheduler/bind", {
            "PodName": filler.name, "PodNamespace": "default",
            "PodUID": filler.uid, "Node": name})
        assert status == 200 and not result.get("Error"), result
    controller.wait_idle(timeout=10)

    # The starved gang worker: needs a whole host, fits nowhere — the
    # failing filter registers its shape with the DemandTracker.
    pod = api.create_pod(make_pod("need-slice", chips=CHIPS))
    # The demand tracker prunes a pod its informer has not seen yet: let
    # the informer see it before the filter records it (the reference
    # races here, and its run then fails its assert below).
    controller.wait_idle(timeout=10)
    names = [n.name for n in api.list_nodes()]
    status, result = client.post("/tpushare-scheduler/filter",
                                 {"Pod": pod.raw, "NodeNames": names})
    assert status == 200 and not result["NodeNames"], result

    ex = controller.autoscale
    ex.mode = "active"
    ex.up_delay_s = 0.0
    ex.cooldown_s = 0.0
    decision = ex.tick()
    assert decision and decision["action"] == "scale-up", decision
    controller.wait_idle(timeout=10)

    coords = []
    grid = None
    for n in api.list_nodes():
        pos = nodeutils.host_position(Node(api.get_node(n.name).raw))
        if pos is not None:
            coords.append(pos[0])
            grid = grid or pos[1]
    contiguity = 0.0
    if grid is not None:
        snake = topo.snake_order(grid.dims)
        if set(coords) == set(snake):
            contiguity = topo.ring_stats(snake, grid)["contiguity"]

    fresh = api.get_pod("default", "need-slice")
    bound_on = _as_schedule(client, fresh,
                            [n.name for n in api.list_nodes()
                             if nodeutils.is_schedulable(n, fresh)])
    fleet.close()
    return {
        "provisioned": decision["node"],
        "election": decision["election"],
        "ring_contiguity": contiguity,
        "starved_pod_bound_on": bound_on,
    }


def bench_autoscale(smoke: bool) -> dict:
    if smoke:
        rounds, peak_nodes, peak_arrivals, ttl = 12, 4, 5, 2
    else:
        rounds, peak_nodes, peak_arrivals, ttl = (
            AS_ROUNDS, AS_PEAK_NODES, AS_PEAK_ARRIVALS, AS_TTL_ROUNDS)
    auto = _bench_autoscale_wave(True, rounds, peak_nodes,
                                 peak_arrivals, ttl)
    static = _bench_autoscale_wave(False, rounds, peak_nodes,
                                   peak_arrivals, ttl)
    contiguity = _bench_autoscale_contiguity()
    ratio = (auto["node_hours"] / static["node_hours"]
             if static["node_hours"] else 0.0)
    return {
        "autoscaled": auto,
        "static": static,
        "node_hours_ratio": round(ratio, 4),
        "contiguity": contiguity,
        "rounds": rounds,
        "peak_nodes": peak_nodes,
    }


def main_autoscale(smoke: bool) -> None:
    """The diurnal wave, the static baseline and the slice completion;
    prints ONE JSON line, the reference's document."""
    import logging

    logging.disable(logging.WARNING)
    result = bench_autoscale(smoke)
    auto, static = result["autoscaled"], result["static"]
    gates = {
        "pod_slo_compliance": {
            "value": auto["slo_compliance"],
            # The baseline IS the limit: elasticity may not cost the
            # user-visible SLO anything vs a fleet sized for the peak.
            "limit": static["slo_compliance"],
            "pass": auto["slo_compliance"] >= static["slo_compliance"]},
        "node_hours_ratio": {
            "value": result["node_hours_ratio"],
            "limit": GATE_AS_NODE_HOURS,
            "pass": result["node_hours_ratio"] <= GATE_AS_NODE_HOURS},
        "guarantee_violations": {
            "value": auto["guarantee_violations"],
            "limit": 0,
            "pass": auto["guarantee_violations"] == 0},
        "scaleup_ring_contiguity": {
            "value": result["contiguity"]["ring_contiguity"],
            "limit": 1.0,
            "pass": result["contiguity"]["ring_contiguity"] >= 1.0},
    }
    doc = {
        "metric": "autoscale_node_hours_ratio",
        "value": result["node_hours_ratio"],
        "unit": "fraction",
        "vs_baseline": (round(result["node_hours_ratio"]
                              / GATE_AS_NODE_HOURS, 4)
                        if GATE_AS_NODE_HOURS else None),
        "smoke": smoke,
        "gates": gates,
        **result,
    }
    print(json.dumps(doc))
    if "--gate" in sys.argv and not all(g["pass"]
                                        for g in gates.values()):
        sys.exit(1)


def main() -> None:
    main_autoscale(smoke="--smoke" in sys.argv)


if __name__ == "__main__":
    main()
