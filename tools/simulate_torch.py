"""Capacity planner over the PyTorch port's extender (``tpushare_torch``).

The port's twin of ``tools/simulate.py``: the same scenario schema, the
same ``EXAMPLE*`` scenarios, the same CLI and the same report documents,
replayed through the port's stack instead of the JAX package's (its fake
apiserver, controller, ledger, HTTP server and JSON wire protocol, its
router, defrag and autoscale executors, its SLO engine, profiler and
fleet-day witness). It imports nothing of ``tpushare``, of
``tools/simulate.py`` or of ``bench.py``, and never ``jax``.

    python tools/simulate_torch.py scenario.yaml          # human report
    python tools/simulate_torch.py scenario.yaml --json   # machine-readable
    python tools/simulate_torch.py --example              # a starter file
    python tools/simulate_torch.py --example-fleet-day > day.yaml
    python tools/simulate_torch.py day.yaml --seed 1234 --json

Where it departs from the reference:

* A gang's ring is priced by the ring model of its hosts' hardware. A
  ring over TPU hosts takes :mod:`tpushare_torch.topology.ici`, the
  reference's ICI/DCN model kept so the twins agree (it is no figure of
  an NVIDIA card); a ring whose every host names an NVIDIA card takes the
  port's own NVLink/NIC model
  (:func:`tpushare_torch.workload.parallel.predicted_step_time_ms`): a
  hop between two ranks of one node is an NVSwitch hop, a hop between
  nodes leaves through the NIC.
* It waits on the thing itself where the reference waits a fixed stretch
  of wall clock and goes on: for the controller to dispatch every watch
  event and drain its queue (:func:`_settle`; in the fleet day also
  before each timeline sample, so a marker its handlers owe is stamped
  and the sources read the apiserver's view, and before the evening
  scale-up's first autoscaler tick, where the reference ticks at once, so
  the demand tracker still lists the wave's pods), and for the Event
  queue to drain, each bounded only by :data:`SETTLE_TIMEOUT_S`, past
  which the replay raises instead of going on with a stale view.
  Unloaded, the day is the reference's, bit for bit. The defrag and
  autoscale executors keep the reference's SLO veto.

Scenario schema (YAML or JSON)::

    fleet:                       # node groups
      - count: 4                 # nodes in this group     (default 1)
        prefix: v5p              # names prefix-00..       (default tpu)
        chips: 4                 #                          (default 4)
        hbm_per_chip: 95         # GiB                     (default 16)
        tpu_type: v5p            #                          (default v5e)
        topology: 2x2x1          # intra-host chip mesh
        slice_id: pod-a          # multi-host ICI domain   (optional)
        unschedulable: true      # cordoned                (optional)
        taints:                  # v1.Taint list           (optional)
          - {key: pool, value: tpu, effect: NoSchedule}
    execute_preemptions: true    # evict + re-schedule instead of
                                 # reporting would-be victims (optional)
    defrag: dry-run              # after the replay, run the extender's
                                 # rebalancer over what is still
                                 # unschedulable: dry-run reports the
                                 # move plan; active executes it and
                                 # re-binds the migrants (optional)
    autoscale: dry-run           # after the replay (and any defrag
                                 # round), run the extender's fleet
                                 # autoscaler: scale-up provisions for
                                 # the surviving unplaceable demand
                                 # (defrag-first rule intact) and the
                                 # pods re-bind on the new capacity;
                                 # scale-down cordons + drains provably
                                 # idle nodes; dry-run reports the
                                 # decisions without changing the
                                 # fleet (optional, docs/autoscale.md)
    profile: on                  # arm the continuous profiler for the
                                 # replay; the report gains a hotspots
                                 # section (per-verb top frames + the
                                 # exact cost-ledger splits) (optional)
    quotas:                      # per-tenant quota table  (optional) —
      team-a:                    # becomes the tpushare-quotas ConfigMap
        guaranteeHBM: 64         # GiB owed to the tenant
        limitHBM: 128            # hard ceiling (filter denies past it)
        guaranteeChips: 2
        limitChips: 4
      "*": {limitHBM: 256}       # default for unlisted tenants
    serving:                     # after the replay, front the bound
      pods: decode               # decode pods (this name prefix) with
                                 # the REAL router (tpushare_torch/router/)
                                 # and replay open-loop traffic on a
                                 # deterministic clock (docs/serving.md)
      slots_per_replica: 4       # analytic service model per replica
      decode_tok_s: 1000         # aggregate decode rate (tokens/s)
      prefill_tok_s: 200000      # serial FIFO prefill rate
      admission_overhead: 0.1    # prefill tax on co-resident decode
                                 # (<=0.10 chunked, 0.221 the r05 gap)
      scale_out: true            # play the scheduler side of the
                                 # loop: a queue-depth signal binds one
                                 # more decode pod through the real
                                 # verbs, mid-replay
      duration: 8                # seconds of traffic
      tick: 0.05                 # service-model integration step
      traffic:                   # open-loop arrival groups
        - tenant: chat           # quota tenant (shedding standing)
          requests: 24           # arrivals spread evenly over
          start: 0               # [start, start+over) sim-seconds
          over: 8
          prompt_len: 100        # bucketed like the slot server
          max_new: 200
    fleet_day:                   # after the replay, play one seeded,
      hours: 24                  # clock-compressed day through the
      hour_s: 6                  # same stack: diurnal router traffic
      seed: 1234                 # with tenant churn plus one injected
                                 # act per chapter (quota ConfigMap
                                 # apply, request surge, NotReady
                                 # host, active defrag wave, autoscale
                                 # up/down) — each graded by the
                                 # fleet-day witness (marker + Event +
                                 # metric legs, docs/observability.md
                                 # §8); --seed overrides `seed`, and
                                 # the same seed reproduces identical
                                 # witness verdicts and scalars
    workload:                    # ordered arrival stream
      - count: 8                 # pods in this group      (default 1)
        name: trainer            # names name-0..          (required)
        namespace: team-a        # tenant (default namespace 'default')
        hbm: 24                  # GiB slice  — or —
        chips: 1                 # whole chips
        group: ring              # gang name               (optional)
        group_min: 8             # gang quorum             (optional)
        priority: 1000           # pod priority            (optional)
        tolerations:             # v1.Toleration list      (optional)
          - {key: pool, operator: Exists}
        annotations:             # extra pod annotations   (optional)
          tpushare.io/scoring: spread

Each pod is scheduled the way kube-scheduler would drive the extender:
upstream cordon/taint filtering, then ``POST filter`` →
``POST prioritize`` (bind to the top score) → ``POST bind``. Gang
members held below quorum stay "held"; pods no node can take are
"unschedulable", and for those with a priority the preempt verb is
consulted dry-run to report which victims WOULD make room (the report
shows the blast radius). With top-level ``execute_preemptions: true``
the round is EXECUTED instead: victims evicted, the scheduler's
``nominatedNodeName`` earmark recorded (so gang siblings can't steal
each other's freed chips), and the pod re-scheduled — the offline
dry-run of the gang×preemption composition.
"""

from __future__ import annotations

import argparse
import http.client
import json
import math
import random
import statistics
import sys
import time

EXAMPLE = """\
# tpushare capacity-planning scenario: an 8-host v5p pool shared by an
# inference fleet (HBM slices), one 8-host gang, and a late
# high-priority trainer that needs a preemption to fit.
fleet:
  - count: 8
    prefix: v5p
    chips: 4
    hbm_per_chip: 95
    tpu_type: v5p
    topology: 2x2x1
    slice_id: pod-a
workload:
  - {count: 16, name: serve, hbm: 24}
  - {count: 4, name: ring, chips: 4, group: ring, group_min: 4}
  - {count: 14, name: batch, hbm: 44}
  - {count: 1, name: rush, chips: 4, priority: 1000}
"""


EXAMPLE_TENANTS = """\
# Mixed-tenant contention under quota: team-serve borrows far past its
# guarantee while the fleet is idle; team-train's later arrivals are
# entitled (under guarantee) and reclaim borrowed capacity via the
# preempt round; a team-serve pod pushing past its hard limit is DENIED
# at filter (see unschedulable reasons + the tenants section).
fleet:
  - count: 4
    prefix: v5e
    chips: 4
    hbm_per_chip: 16
quotas:
  team-serve: {guaranteeHBM: 32, limitHBM: 176}
  team-train: {guaranteeHBM: 128}
execute_preemptions: true
workload:
  - {count: 12, name: decode, namespace: team-serve, hbm: 16}
  - {count: 6, name: train, namespace: team-train, hbm: 16}
  - {count: 2, name: burst, namespace: team-serve, hbm: 16}
"""


EXAMPLE_DEFRAG = """\
# Defragmentation demo: fragment -> plan -> migrate -> pending pod
# binds, in one run. Eight spread-scored 6-GiB shards scatter over all
# 16 chips' nodes (2 occupied chips per node), so a 4-chip ring pod
# fits NOWHERE despite ~100 GiB free. `defrag: active` then runs the
# extender's real rebalancer (tpushare/defrag/): it plans gang-safe
# moves, evicts the victims through pods/eviction, the replay re-binds
# them on their planned destinations (playing the Job controller), and
# the ring pod binds on the freed node. Use `defrag: dry-run` to see
# the plan without any eviction.
fleet:
  - count: 4
    prefix: v5e
    chips: 4
    hbm_per_chip: 16
defrag: active
workload:
  - count: 8
    name: shard
    hbm: 6
    annotations: {tpushare.io/scoring: spread}
  - {count: 1, name: ring, chips: 4}
"""


EXAMPLE_AUTOSCALE = """\
# Fleet-autoscaling demo (docs/autoscale.md): eight 16-GiB pods fill
# both nodes chip for chip, so the 4-chip ring pod fits NOWHERE and no
# rebalance move can help (every chip is full — defrag-first rules
# itself out honestly). `autoscale: active` then runs the extender's
# real autoscaler: the surviving demand provisions a node cloned from
# the roomiest existing template and the ring pod binds on it. Use
# `autoscale: dry-run` to see the decision without growing the fleet.
fleet:
  - count: 2
    prefix: v5e
    chips: 4
    hbm_per_chip: 16
autoscale: active
workload:
  - {count: 8, name: shard, hbm: 16}
  - {count: 1, name: ring, chips: 4}
"""


EXAMPLE_SERVING = """\
# Serving front door over the placed decode fleet: the replay binds
# two decode pods, fronts them with the router (tpushare/router/), and
# replays a traffic surge on a deterministic clock — chat stays inside
# its standing and never sheds, burst floods far past its entitlement
# and sheds, queues past the threshold raise the scale-out signal, the
# SCHEDULER binds one more decode pod through the real verbs
# mid-replay, and the queues drain. The `serving` report section (and
# the packing's `router scale-out` placement) tells the story.
fleet:
  - count: 2
    prefix: v5e
    chips: 4
    hbm_per_chip: 16
quotas:
  chat:  {guaranteeHBM: 16, limitHBM: 32}
  burst: {guaranteeHBM: 16, limitHBM: 32}
workload:
  - {count: 2, name: decode, hbm: 8}
serving:
  pods: decode
  slots_per_replica: 4
  decode_tok_s: 1000
  prefill_tok_s: 1000000000
  scale_out: true
  duration: 8
  traffic:
    - {tenant: chat, requests: 24, prompt_len: 100, max_new: 200,
       over: 8}
    - {tenant: burst, requests: 60, prompt_len: 100, max_new: 200,
       start: 2, over: 2}
"""


EXAMPLE_TOPOLOGY = """\
# Topology-aware gang placement demo (docs/topology.md): a 16-host v5p
# slice (4x4x4 chips of 2x2x1 hosts = a 2x2x4 host torus) is
# fragmented by four pinned pre-load pods, then an 8-worker pp-gang
# requesting a 4x4x2 sub-slice (a 2x2x2 host block) arrives. With the
# placer ON the gang lands on the only free contiguous block — which
# exists solely thanks to the torus WRAP (z in {3, 0}) — at ring
# contiguity 1.0. `topology_compare: true` replays the identical
# scenario with TPUSHARE_TOPOLOGY=off: the blind placement scatters
# the ring, and the report renders both placements' coordinates and
# ring-latency-model step times side by side.
fleet:
  - count: 16
    prefix: v5p
    chips: 4
    hbm_per_chip: 95
    tpu_type: v5p
    topology: 2x2x1
    slice_id: pod-a
    slice_topology: 4x4x4
topology_compare: true
workload:
  - {name: preload-1, hbm: 16, node: v5p-01}
  - {name: preload-2, hbm: 16, node: v5p-02}
  - {name: preload-5, hbm: 16, node: v5p-05}
  - {name: preload-6, hbm: 16, node: v5p-06}
  - count: 8
    name: stage
    chips: 4
    group: pp-ring
    group_min: 8
    slice_shape: 4x4x2
"""


#: Marker kinds the fleet-day schedule stakes expectations on — one
#: per injected act, in day order (the reference's tuple).
#: tests/test_torch_simulate.py cross-checks it against
#: tpushare_torch/obs/timeline.py's MARKER_KINDS by AST, so a renamed
#: kind fails the build, not the witness at replay time.
FLEET_DAY_EXPECTED_KINDS = (
    "config",           # mid-day quota ConfigMap apply
    "router-scaleout",  # request-surge queue signal
    "node-notready",    # host failure
    "defrag-plan",      # consolidation wave
    "autoscale-up",     # evening capacity wave
    "autoscale-down",   # overnight trough drain
)

#: The fleet day's router service model where ``fleet_day.serving`` does
#: not set it: the reference day's figures (aggregate decode and serial
#: prefill tokens a second, prefill tax on co-resident decode), which are
#: its TPU model's, not a figure of an NVIDIA card.
FLEET_DAY_SERVING = {"decode_tok_s": 4000.0, "prefill_tok_s": 200_000.0,
                     "admission_overhead": 0.10}

#: How long a replay waits for what its writes set off (the controller's
#: dispatch of the watch events they delivered, the Event queue) before it
#: raises. The reference waits 2-10 s of wall clock and goes on; the twin
#: waits for the thing itself, and this is only the bound past which a
#: replay is broken, not slow.
SETTLE_TIMEOUT_S = 120.0


def _settle(controller) -> None:
    """Wait until the controller has dispatched every watch event
    delivered so far and drained its queue: the informer's view is then
    the apiserver's, and a marker or Event its handlers owe is stamped.
    Raises past :data:`SETTLE_TIMEOUT_S` (the reference waits 10 s and
    goes on)."""
    if not controller.wait_idle(timeout=SETTLE_TIMEOUT_S):
        raise RuntimeError("the controller did not settle within "
                           f"{SETTLE_TIMEOUT_S} s")

EXAMPLE_FLEET_DAY = """\
# tpushare fleet-day scenario: one compressed 24-hour trace through
# the REAL stack, with the fleet-day witness grading every injected
# act (quota apply, surge, NotReady host, defrag wave, autoscale
# up/down) against the telemetry it must produce. Same seed -> same
# witness verdicts and scalars, bit for bit:
#   python tools/simulate.py fleet_day.yaml --seed 1234
fleet:
  - count: 4                 # the sharing pool the day fragments
    prefix: frag
    chips: 4
    hbm_per_chip: 16
  - count: 2                 # serve-class hosts (bigger chips) the
    prefix: serve            # decode replicas and the evening wave
    chips: 2                 # need; tainted so batch stays off them
    hbm_per_chip: 24
    taints:
      - {key: pool, value: serve, effect: NoSchedule}
quotas:
  # Guarantees make bound pods immovable to defrag and drains — the
  # day's zero-guarantee-eviction gate rides on these entries.
  team-serve: {guaranteeHBM: 32, limitHBM: 48}
  team-anchor: {guaranteeHBM: 16, limitHBM: 24}
  team-train: {limitHBM: 128, limitChips: 8}
  team-batch: {limitHBM: 96}
  team-wave: {limitHBM: 64}
  chat-a: {guaranteeHBM: 16, limitHBM: 48}
  chat-b: {guaranteeHBM: 16, limitHBM: 48}
  chat-c: {guaranteeHBM: 16, limitHBM: 48}
  flood: {guaranteeHBM: 4, limitHBM: 8}
workload:
  # Guaranteed anchors that must survive the whole day untouched.
  # Spread scoring pins one immovable pod per serve CHIP, so no
  # serve chip ever has 20 GiB free and the evening wave is forced
  # onto a provisioned host.
  - {name: anchor-a, namespace: team-anchor, hbm: 8, node: serve-00,
     annotations: {tpushare.io/scoring: spread},
     tolerations: [{key: pool, operator: Exists}]}
  - {name: anchor-b, namespace: team-anchor, hbm: 8, node: serve-01,
     annotations: {tpushare.io/scoring: spread},
     tolerations: [{key: pool, operator: Exists}]}
  # Two decode replicas the router fronts, one per serve host.
  - {name: decode-a, namespace: team-serve, hbm: 8, node: serve-00,
     annotations: {tpushare.io/scoring: spread},
     tolerations: [{key: pool, operator: Exists}]}
  - {name: decode-b, namespace: team-serve, hbm: 8, node: serve-01,
     annotations: {tpushare.io/scoring: spread},
     tolerations: [{key: pool, operator: Exists}]}
  # Spread shards fragment the sharing pool two-per-host...
  - count: 8
    name: shard
    namespace: team-batch
    hbm: 6
    annotations: {tpushare.io/scoring: spread}
  # ...so the 4-chip ring cannot bind until the defrag wave frees a
  # host mid-day.
  - {name: ring, namespace: team-train, chips: 4}
fleet_day:
  hours: 24                  # scenario hours in the day
  hour_s: 6                  # compressed seconds per scenario hour
  seed: 1234                 # the day's RNG seed (--seed overrides)
  peak_requests_per_hour: 6  # diurnal half-sine peak, per tenant
  surge_requests: 8          # per steady tenant at the surge hour
  surge_flood_requests: 12   # the flooder's burst on top
  wave:                      # evening training wave: a shape only a
    count: 2                 # new serve-class host can take (20 GiB
    hbm: 20                  # on one chip beats every 16 GiB sharing
    namespace: team-wave     # chip, and the serve chips hold
    tolerations:             # guaranteed pods defrag cannot move ->
      - {key: pool, operator: Exists}  # the scale-up is forced)
"""


def load_scenario(path: str) -> dict:
    with open(path) as f:
        text = f.read()
    try:
        import yaml
        return yaml.safe_load(text)
    except ImportError:  # pragma: no cover - yaml is baked into the image
        return json.loads(text)


def _expand_fleet(scenario: dict) -> list[dict]:
    from tpushare_torch.k8s.builders import make_node

    docs = []
    for group in scenario.get("fleet", []):
        count = int(group.get("count", 1))
        prefix = group.get("prefix", "tpu")
        slice_topology = group.get("slice_topology", "")
        for i in range(count):
            docs.append(make_node(
                f"{prefix}-{i:02d}" if count > 1 else prefix,
                chips=int(group.get("chips", 4)),
                hbm_per_chip=int(group.get("hbm_per_chip", 16)),
                chip_hbm=group.get("chip_hbm"),
                topology=group.get("topology", "2x2x1"),
                tpu_type=group.get("tpu_type", "v5e"),
                slice_id=group.get("slice_id", ""),
                # Multi-host slice geometry: the slice's chip dims plus
                # this host's worker index locate it on the host grid
                # (tpushare.io/slice-topology / worker-index) — what
                # the slice placer and the topology report read.
                slice_topology=slice_topology,
                worker_index=i if slice_topology else None,
                unschedulable=bool(group.get("unschedulable", False)),
                taints=group.get("taints"),
            ))
    return docs


def _expand_workload(scenario: dict) -> list[dict]:
    from tpushare_torch.k8s.builders import make_pod
    from tpushare_torch.utils import const

    specs = []
    for group in scenario.get("workload", []):
        count = int(group.get("count", 1))
        base = group["name"]
        # Arbitrary pod annotations pass through, e.g.
        # {tpushare.io/scoring: spread} to trial mixed scoring policies.
        ann = dict(group.get("annotations") or {})
        if group.get("group"):
            ann[const.ANN_POD_GROUP] = str(group["group"])
            ann[const.ANN_POD_GROUP_MIN] = str(
                group.get("group_min", count))
        if group.get("slice_shape"):
            # Requested ICI sub-slice (chip dims): arms the gang
            # planner's contiguous-block election (docs/topology.md).
            ann[const.ANN_SLICE_SHAPE] = str(group["slice_shape"])
        # `node: <name>` pins the group onto one node (the replay
        # plays the owner pre-loading a fleet — e.g. fragmenting
        # specific hosts before a gang arrives); scheduling still runs
        # the real wire with a one-node candidate list.
        pin = str(group.get("node", "")) or None
        for i in range(count):
            doc = make_pod(f"{base}-{i}" if count > 1 else base,
                           hbm=int(group.get("hbm", 0)),
                           chips=int(group.get("chips", 0)),
                           namespace=str(group.get("namespace",
                                                   "default")),
                           annotations=ann,
                           priority=group.get("priority"))
            if group.get("tolerations"):
                doc["spec"]["tolerations"] = list(group["tolerations"])
            specs.append((doc, pin))
    return specs


class _Client:
    """Keep-alive wire client (same as kube-scheduler's reused conn)."""

    def __init__(self, host: str, port: int):
        self.conn = http.client.HTTPConnection(host, port)

    def post(self, path: str, doc: dict):
        self.conn.request("POST", path, json.dumps(doc).encode(),
                          {"Content-Type": "application/json"})
        resp = self.conn.getresponse()
        return resp.status, json.loads(resp.read())

    def get(self, path: str):
        self.conn.request("GET", path)
        resp = self.conn.getresponse()
        return json.loads(resp.read())

    def close(self):
        self.conn.close()


def simulate(scenario: dict, seed: int | None = None) -> dict:
    """Replay ``scenario`` and return the report document. ``seed``
    overrides the scenario's ``fleet_day.seed`` (ignored otherwise)."""
    from tpushare_torch import obs as _obs
    from tpushare_torch.api.objects import Node
    from tpushare_torch.cmd.main import serve_stack, shutdown_stack
    from tpushare_torch.k8s.errors import NotFoundError
    from tpushare_torch.utils import node as nodeutils

    node_docs = _expand_fleet(scenario)
    if not node_docs:
        return {"error": "scenario has no fleet"}
    fleet_day_cfg = scenario.get("fleet_day")
    day_clock = {"now": 0.0}
    if fleet_day_cfg:
        # The whole day plays on one compressed scenario clock: reset
        # the obs singletons (a previous run's markers must not leak
        # into the witness join) and swap their clock in BEFORE the
        # stack boots, so even boot-time markers stamp scenario time.
        _obs.reset()
        _obs.set_clock(lambda: day_clock["now"])
    # Journeys/SLO windows are process singletons (like the flight
    # recorder); a replay must report ITS pods' journeys, not a
    # previous run's.
    from tpushare_torch import slo as slo_mod
    slo_mod.reset()
    # `profile: on` arms the continuous profiler for this replay; the
    # singletons are reset so the report covers THIS run's verbs only.
    profiled = str(scenario.get("profile", "")).lower() in (
        "on", "true", "1", "yes")
    from tpushare_torch import profiling
    if profiled:
        profiling.reset()
        # A replay is seconds long: sample fast enough to resolve it.
        profiling.start(hz=100)
    api = _fresh_api(node_docs)
    quota_cm = _quota_configmap(scenario)
    if quota_cm is not None:
        # Present before the stack boots, exactly like a live cluster:
        # the controller's informer seeds the quota table from it.
        api.create_configmap(quota_cm)
    stack, server = serve_stack(api)
    if fleet_day_cfg:
        # Manual sampling only: the background sampler ticks on WALL
        # cadence and would interleave nondeterministic points (and
        # anomaly evaluations) into the seeded scenario-clock replay.
        _obs.timeline().stop()
    client = _Client(*server.server_address[:2])

    placements: list[dict] = []
    held: list[dict] = []
    unschedulable: list[dict] = []
    executed_preemptions: list[dict] = []
    latencies: list[float] = []
    # Opt-in: EXECUTE the preemptions the what-if would only report —
    # evict the victims, record the scheduler's nominatedNodeName, and
    # re-schedule, exactly kube-scheduler's preemption round. This is
    # how an operator dry-runs the gang×preemption composition (a
    # priority gang arriving on a saturated fleet) offline.
    execute = bool(scenario.get("execute_preemptions"))
    all_nodes = [Node(d) for d in node_docs]
    try:
        for spec, pin in _expand_workload(scenario):
            pod = api.create_pod(spec)
            # kube-scheduler's upstream NodeUnschedulable+TaintToleration
            # pass — cordoned/untolerated nodes never reach the extender.
            candidates = [n.name for n in all_nodes
                          if nodeutils.is_schedulable(n, pod)]
            if pin is not None:
                candidates = [n for n in candidates if n == pin]
            t0 = time.perf_counter()
            verdict = _schedule_one(client, pod, candidates)
            latencies.append((time.perf_counter() - t0) * 1e3)
            def _file(v) -> bool:
                """Route one schedule verdict to its bucket; False
                when it is unschedulable (caller may escalate)."""
                v["pod"] = pod.name
                v["namespace"] = pod.namespace
                if v.pop("state") == "bound":
                    placements.append(v)
                elif v.get("pending"):
                    held.append(v)
                else:
                    return False
                return True

            if _file(verdict):
                continue
            # Priority pods preempt; priority-0 pods may still RECLAIM
            # borrowed-over-guarantee capacity at equal priority when a
            # quota table is in play — the preempt verb owns both cases
            # (it returns an empty map when no legal victims exist).
            if pod.priority or quota_cm is not None:
                plan = _whatif_preempt(client, pod, candidates)
                if plan:
                    verdict["would_preempt"] = plan
                if execute and plan:
                    outcome = _execute_preemption(
                        api, client, stack.controller, pod, plan)
                    if outcome is not None:
                        retry, record = outcome
                        executed_preemptions.append(record)
                        if not _file(retry):
                            unschedulable.append(retry)
                        continue
            unschedulable.append(verdict)
        _settle(stack.controller)
        # Reconcile against the apiserver's final truth: a member held
        # pending quorum at arrival time is bound by the gang commit
        # when the quorum-completing member lands.
        for bucket in (held, unschedulable):
            for verdict in bucket[:]:
                try:
                    final = api.get_pod(verdict.get("namespace", "default"),
                                        verdict["pod"])
                except NotFoundError:
                    continue  # reaped (e.g. below-quorum gang cleanup)
                if final.node_name:
                    bucket.remove(verdict)
                    placements.append({"pod": verdict["pod"],
                                       "namespace": verdict.get(
                                           "namespace", "default"),
                                       "node": final.node_name,
                                       "via": "gang commit"})
        # Fleet-day round (scenario `fleet_day:`): replay one seeded,
        # clock-compressed day on top of the baseline packing —
        # diurnal router traffic with tenant churn plus one injected
        # act per chapter (quota apply, surge, NotReady host, defrag
        # wave, autoscale up/down), every act graded by the fleet-day
        # witness (docs/observability.md §8).
        fleet_day_report = None
        if fleet_day_cfg:
            day_seed = int(seed if seed is not None
                           else fleet_day_cfg.get("seed", 0))
            fleet_day_report = _run_fleet_day(
                api, client, stack, scenario, day_clock, unschedulable,
                held, placements, random.Random(day_seed), day_seed)
        # Defragmentation round (scenario `defrag: dry-run|active`):
        # run the extender's REAL rebalancer over whatever is still
        # unschedulable — the offline dry-run of the fragment → plan →
        # migrate → bind story (docs/defrag.md).
        defrag_report = None
        if scenario.get("defrag") and unschedulable:
            defrag_report = _run_defrag(
                api, client, stack, scenario["defrag"],
                unschedulable, placements, all_nodes)
        # Autoscale round (scenario `autoscale: dry-run|active`): run
        # the extender's REAL fleet autoscaler after the replay (and
        # after any defrag round, which is cheaper and goes first) —
        # the offline dry-run of the demand → provision → bind and
        # trough → drain → delete stories (docs/autoscale.md). The
        # fleet CHANGES here, so the rounds re-list nodes each pass.
        autoscale_report = None
        if scenario.get("autoscale"):
            autoscale_report = _run_autoscale(
                api, client, stack, scenario["autoscale"],
                unschedulable, placements)
        # Serving round (scenario `serving:` key): front the bound
        # decode pods with the REAL router and replay the traffic
        # stream — scale-out binds land in the packing below.
        serving_report = None
        if scenario.get("serving"):
            serving_report = _run_serving(
                api, client, stack, scenario, all_nodes, placements)
        inspect_doc = client.get("/tpushare-scheduler/inspect")
        tenants = (client.get("/debug/quota").get("tenants", [])
                   if quota_cm is not None else [])
        # The user-facing latency story: SLO budget/burn plus journey
        # aggregates (e2e percentiles, attempts) — the numbers a real
        # fleet would alert on, read from the same /debug/slo surface.
        slo_doc = client.get("/debug/slo")
        hotspots_doc = None
        if profiled:
            # Read over the wire like every other surface here, so the
            # replay also proves the endpoint round-trips.
            hotspots_doc = client.get("/debug/hotspots?top=5")
        # Retrospective timeline: force one sampler pass so even a
        # sub-second replay has history, then read it over the wire so
        # the replay also proves /debug/timeline round-trips.
        from tpushare_torch import obs as _obs
        _obs.timeline().tick()
        timeline_doc = client.get("/debug/timeline?window=3600")
        if timeline_doc.get("Error"):
            timeline_doc = None  # recorder disarmed (TPUSHARE_TIMELINE=off)
    finally:
        if profiled:
            profiling.stop()
        client.close()
        shutdown_stack(stack, server)
        if fleet_day_cfg:
            # Hand the wall clock back to the obs singletons — the
            # next replay (or test) must not inherit a frozen day.
            _obs.set_clock(None)
    report = _report(inspect_doc, placements, held, unschedulable,
                     latencies, executed_preemptions, tenants, slo_doc,
                     defrag_report, serving_report, autoscale_report,
                     fleet_day_report)
    if hotspots_doc is not None:
        report["hotspots"] = hotspots_doc
    if timeline_doc is not None:
        report["timeline"] = timeline_doc
    return report


def _run_defrag(api, client: _Client, stack, mode, unschedulable,
                placements, all_nodes) -> dict:
    """One defrag round through ``stack.controller.defrag`` (the REAL
    executor): plan; in active mode evict, play the Job controller
    (recreate each victim, re-bind it on its planned destination), then
    retry the still-unschedulable pods. Mutates the ``unschedulable``
    and ``placements`` buckets in place like the preemption executor."""
    from tpushare_torch.utils import const as _c

    executor = stack.controller.defrag
    executor.mode = "active" if mode is True else str(mode)
    if executor.mode not in ("dry-run", "active"):
        return {"error": f"defrag: unknown mode {mode!r} "
                         "(want dry-run or active)"}
    # Capture victims' specs BEFORE eviction deletes them.
    originals = {f"{p.namespace}/{p.name}": p for p in api.list_pods()}
    plan_doc = executor.tick()
    out: dict = {"mode": executor.mode, "plan": plan_doc}
    if plan_doc is None or executor.mode != "active":
        return out
    _settle(stack.controller)
    migrated = []
    for move in plan_doc.get("moves", []):
        if move["status"] != "evicted":
            continue
        original = originals.get(move["pod"])
        if original is None:
            continue
        raw = original.deepcopy().raw
        meta = raw.setdefault("metadata", {})
        for key in ("uid", "resourceVersion"):
            meta.pop(key, None)
        ann = meta.get("annotations") or {}
        for key in _c.GRANT_ANNOTATIONS:
            ann.pop(key, None)
        raw.setdefault("spec", {}).pop("nodeName", None)
        raw["status"] = {"phase": "Pending"}
        pod = api.create_pod(raw)
        verdict = _schedule_one(client, pod, [move["to"]])
        migrated.append({"pod": move["pod"], "from": move["from"],
                         "to": move["to"],
                         "rebound": verdict["state"] == "bound"})
    out["migrated"] = migrated
    _settle(stack.controller)
    # The whole point: pods the fragmentation blocked now bind.
    recovered = []
    from tpushare_torch.k8s.errors import NotFoundError
    for verdict in unschedulable[:]:
        try:
            pod = api.get_pod(verdict.get("namespace", "default"),
                              verdict["pod"])
        except NotFoundError:
            continue
        from tpushare_torch.utils import node as nodeutils
        candidates = [n.name for n in all_nodes
                      if nodeutils.is_schedulable(n, pod)]
        retry = _schedule_one(client, pod, candidates)
        if retry.pop("state") == "bound":
            unschedulable.remove(verdict)
            retry["pod"] = pod.name
            retry["namespace"] = pod.namespace
            retry["via"] = "defrag"
            placements.append(retry)
            recovered.append(f"{pod.namespace}/{pod.name}")
    out["recovered"] = recovered
    return out


def _run_autoscale(api, client: _Client, stack, mode, unschedulable,
                   placements) -> dict:
    """Autoscale rounds through ``stack.controller.autoscale`` (the
    REAL executor). Scale-up provisions for the replay's surviving
    unplaceable demand — with the defrag-first rule intact, so a hold
    naming ``capacity-exists`` or ``defrag-first`` is itself the
    answer — and the pending pods re-bind on the new capacity.
    Scale-down cordons and drains provably idle nodes; evicted
    residents are re-created and re-scheduled (the replay plays the
    Job controller, same as the defrag round). A replay has no wall
    clock to age demand against, so the hysteresis delays (up/down/
    cooldown) are collapsed to zero: the report answers "what would
    the fleet settle at", not "when". Mutates ``unschedulable`` and
    ``placements`` in place like the defrag round."""
    from tpushare_torch.k8s.errors import NotFoundError
    from tpushare_torch.utils import const as _c
    from tpushare_torch.utils import node as nodeutils

    executor = stack.controller.autoscale
    executor.mode = "active" if mode is True else str(mode)
    if executor.mode not in ("dry-run", "active"):
        return {"error": f"autoscale: unknown mode {mode!r} "
                         "(want dry-run or active)"}
    executor.up_delay_s = 0.0
    executor.down_delay_s = 0.0
    executor.cooldown_s = 0.0
    # Victims' specs BEFORE a drain eviction deletes them.
    originals = {f"{p.namespace}/{p.name}": p for p in api.list_pods()}
    out: dict = {"mode": executor.mode, "decisions": [],
                 "provisioned": [], "drained": [], "recovered": []}

    def _retry_pending() -> None:
        """The whole point of a scale-up: pods the fleet size blocked
        now bind — against the RE-LISTED fleet (it just changed)."""
        for verdict in unschedulable[:]:
            try:
                pod = api.get_pod(verdict.get("namespace", "default"),
                                  verdict["pod"])
            except NotFoundError:
                continue
            candidates = [n.name for n in api.list_nodes()
                          if nodeutils.is_schedulable(n, pod)]
            retry = _schedule_one(client, pod, candidates)
            if retry.pop("state") == "bound":
                unschedulable.remove(verdict)
                retry["pod"] = pod.name
                retry["namespace"] = pod.namespace
                retry["via"] = "autoscale"
                placements.append(retry)
                out["recovered"].append(f"{pod.namespace}/{pod.name}")

    # Bounded rounds: a drain spans ticks (deferred residents), and a
    # pathological scenario must still terminate.
    for _ in range(8):
        decision = executor.tick()
        if decision is None:
            break
        out["decisions"].append(decision)
        action = decision.get("action")
        # Dry-run changes nothing, so a second tick would repeat the
        # same decision forever; one decision IS the dry-run story.
        # Holds and actuation errors likewise end the round.
        if (decision.get("dryRun") or action == "hold"
                or decision.get("error")):
            break
        _settle(stack.controller)
        if action == "scale-up":
            out["provisioned"].append(decision["node"])
            _retry_pending()
            continue
        # scale-down: play the Job controller for every eviction —
        # re-create the victim and re-schedule it on what remains.
        for ev in decision.get("evictions") or []:
            if ev.get("status") != "evicted":
                continue
            original = originals.get(ev["pod"])
            if original is None:
                continue
            raw = original.deepcopy().raw
            meta = raw.setdefault("metadata", {})
            for key in ("uid", "resourceVersion"):
                meta.pop(key, None)
            ann = meta.get("annotations") or {}
            for key in _c.GRANT_ANNOTATIONS:
                ann.pop(key, None)
            raw.setdefault("spec", {}).pop("nodeName", None)
            raw["status"] = {"phase": "Pending"}
            pod = api.create_pod(raw)
            candidates = [n.name for n in api.list_nodes()
                          if nodeutils.is_schedulable(n, pod)]
            verdict = _schedule_one(client, pod, candidates)
            verdict["pod"] = pod.name
            verdict["namespace"] = pod.namespace
            if verdict.pop("state") == "bound":
                verdict["via"] = "autoscale drain"
                placements.append(verdict)
        if decision.get("phase") == "delete":
            out["drained"].append(decision["node"])
            _settle(stack.controller)
    return out


def _run_serving(api, client: _Client, stack, scenario, all_nodes,
                 placements) -> dict:
    """Front the replay's bound decode pods with the REAL router
    (:mod:`tpushare_torch.router`) and replay the scenario's open-loop
    traffic stream on a deterministic clock. Shedding standing comes
    from the controller's live QuotaManager (the same ``quotas:``
    table the scheduler just enforced), and with ``scale_out: true``
    the router's queue-depth signal is played against the real verbs:
    the spec becomes a pod, filter → prioritize → bind places it, and
    the new replica joins the fleet MID-REPLAY — the report's packing
    includes it (``via: router scale-out``). This is the offline
    dry-run of the request-traffic → chip-placement loop
    (docs/serving.md)."""
    from tpushare_torch.k8s.builders import make_pod
    from tpushare_torch.router import DecodeReplica, Router
    from tpushare_torch.utils import const as _c
    from tpushare_torch.utils import node as nodeutils

    cfg = scenario["serving"]
    prefix = str(cfg.get("pods", "decode"))
    fronted = [p for p in placements
               if p["pod"].startswith(prefix)]
    if not fronted:
        return {"error": f"serving: no bound pod named {prefix}*"}
    slots = int(cfg.get("slots_per_replica", 4))
    model = {
        "decode_tok_s": float(cfg.get("decode_tok_s", 1000.0)),
        "prefill_tok_s": float(cfg.get("prefill_tok_s", 200_000.0)),
        "admission_overhead": float(
            cfg.get("admission_overhead", 0.10)),
    }
    now = 0.0
    router = Router(
        quota=stack.controller.quota, clock=lambda: now,
        scaleout_cooldown_s=float(cfg.get("scaleout_cooldown", 1.0)))
    namespace = fronted[0].get("namespace", "default")
    for p in fronted:
        pod = api.get_pod(p.get("namespace", "default"), p["pod"])
        ann = pod.raw["metadata"].get("annotations") or {}
        router.add_replica(DecodeReplica(
            p["pod"], slots=slots, node=p.get("node", ""),
            hbm_gib=float(ann.get(_c.ANN_HBM_POD, 0) or 0), **model))

    provisioned: list[dict] = []
    if cfg.get("scale_out"):
        def _provision(spec: dict) -> None:
            """The scheduler's side of the loop, mid-replay: one
            decode pod of the signalled shape through the real
            verbs, then the replica registers."""
            name = f"{prefix}-scale-{len(provisioned)}"
            pod = api.create_pod(make_pod(
                name, hbm=int(spec.get("hbmGiB", 8)) or 8,
                namespace=namespace))
            candidates = [n.name for n in all_nodes
                          if nodeutils.is_schedulable(n, pod)]
            verdict = _schedule_one(client, pod, candidates)
            bound = verdict.get("state") == "bound"
            provisioned.append(
                {"pod": name, "spec": spec, "bound": bound})
            if not bound:
                return
            placements.append({"pod": name, "namespace": namespace,
                               "node": verdict.get("node"),
                               "via": "router scale-out"})
            router.add_replica(DecodeReplica(
                name, slots=slots, node=verdict.get("node") or "",
                hbm_gib=float(spec.get("hbmGiB", 0) or 0), **model))
        router.on_scaleout = _provision

    arrivals: list[tuple[float, str, int, int]] = []
    duration = float(cfg.get("duration", 10.0))
    for grp in cfg.get("traffic", []):
        n = int(grp.get("requests", 1))
        start = float(grp.get("start", 0.0))
        over = float(grp.get("over", duration)) or duration
        for i in range(n):
            arrivals.append((start + over * i / max(n, 1),
                             str(grp.get("tenant", "default")),
                             int(grp.get("prompt_len", 128)),
                             int(grp.get("max_new", 64))))
    arrivals.sort(key=lambda a: a[0])

    tick = float(cfg.get("tick", 0.05))
    outcomes: dict[str, dict[str, int]] = {}
    nxt = 0
    while now < duration:
        while nxt < len(arrivals) and arrivals[nxt][0] <= now:
            _, tenant, plen, mnew = arrivals[nxt]
            nxt += 1
            dec = router.submit(tenant, plen, mnew, now=now)
            row = outcomes.setdefault(
                tenant, {"assigned": 0, "queued": 0, "shed": 0})
            row[dec["outcome"]] += 1
        router.tick(now)
        now += tick
    # Drain: keep the model running until every queued/in-flight
    # request retires (bounded — a report must terminate even if a
    # pathological scenario cannot drain).
    drained_at = None
    deadline = now + 600.0
    while now < deadline:
        router.tick(now)
        snap = router.snapshot()
        if snap["queuedTotal"] == 0 and snap["slotsInUse"] == 0:
            drained_at = round(now, 2)
            break
        now += max(tick, 0.5)
    _settle(stack.controller)
    snap = router.snapshot()
    return {
        "replicas": sorted(p["pod"] for p in fronted),
        "slotsPerReplica": slots,
        "outcomes": outcomes,
        "scaleOut": {"signals": snap["scaleOut"]["signals"],
                     "provisioned": provisioned},
        "drainedAtS": drained_at,
        "snapshot": snap,
    }


def _run_fleet_day(api, client: _Client, stack, scenario, clock,
                   unschedulable, held, placements, rng, seed) -> dict:
    """One seeded, clock-compressed day through the REAL stack, graded
    by the fleet-day witness (``tpushare_torch/obs/witness.py``).

    The baseline replay has already packed the fleet; this round plays
    the day on top of it: diurnal open-loop router traffic with seeded
    tenant churn, and one injection per chapter — a quota ConfigMap
    apply, a request surge (queue signal -> one scale-out bind through
    the real verbs), a NotReady host (and its recovery), an active
    defrag wave, and an autoscale up/down round-trip. Each injection
    STAKES a witness expectation first (marker kind, optional Event
    reason and metric delta, a conformance window), then acts; the
    end-of-day ``evaluate()`` joins schedule against observation into
    per-event verdicts plus the day's scalars (pod-SLO compliance,
    Jain fairness over the steady tenants — queued requests count as
    served because the bounded drain retires them — node-hours vs
    peak-static, guaranteed-pod evictions).

    Every timestamp rides the scenario clock (``clock["now"]``), which
    only this function advances. Before each sample and after each act
    it waits for the controller to dispatch every watch event the act's
    writes delivered (:func:`_settle`: a marker or Event its handlers owe
    is then stamped) and for the Event queue to drain (``_poll_events``),
    each bounded only by :data:`SETTLE_TIMEOUT_S`; the reference waits a
    fixed stretch of wall clock and goes on. The scenario clock is frozen
    meanwhile, so whatever fires stamps a deterministic time. Same seed
    -> same verdicts and scalars, bit for bit (the reference's
    docs/observability.md §8)."""
    from tpushare_torch import obs as _obs
    from tpushare_torch.api.objects import ConfigMap
    from tpushare_torch.k8s import events as _events
    from tpushare_torch.k8s.builders import make_pod
    from tpushare_torch.k8s.errors import NotFoundError
    from tpushare_torch.obs import sources as _sources
    from tpushare_torch.router import DecodeReplica, Router
    from tpushare_torch.utils import const as _c
    from tpushare_torch.utils import node as nodeutils

    cfg = scenario["fleet_day"]
    hours = int(cfg.get("hours", 24))
    hour_s = float(cfg.get("hour_s", 6.0))
    window_s = float(cfg.get("window_s", hour_s))
    steps = max(int(cfg.get("steps_per_hour", 10)), 1)
    tick_s = hour_s / steps
    quotas = scenario.get("quotas") or {}
    witness = _obs.witness()

    def now() -> float:
        return clock["now"]

    def sample() -> None:
        """One timeline pass once the controller has settled: sources
        read the informer's view (its pending pods give the frag index
        its shapes), which must be the apiserver's by then. The
        reference samples at once, and a bind its informer has not seen
        yet can read as 200 GiB stranded under load."""
        _settle(stack.controller)
        _obs.timeline().tick()

    def settle() -> None:
        """Advance the scenario clock one integration step, then
        sample: an injection acts with the clock frozen, so without
        the step its post-injection point would share a timestamp
        with the pre-injection baseline and the witness's metric-leg
        baseline would read the POST value."""
        clock["now"] += tick_s
        sample()

    def _await_marker(kind: str, since: float) -> bool:
        """Whether ``kind`` was stamped since ``since``, read once the
        controller has settled: the handler that stamps it has run."""
        _settle(stack.controller)
        doc = _obs.timeline().snapshot()
        return any(m["kind"] == kind and m["ts"] >= since
                   for m in doc.get("markers", []))

    def _poll_events() -> None:
        if not _events.flush(timeout=SETTLE_TIMEOUT_S):
            raise RuntimeError("fleet day: the Event queue did not drain "
                               f"within {SETTLE_TIMEOUT_S} s")
        witness.observe_events(list(api.events), now=now())

    def _guaranteed_ns(ns: str) -> bool:
        spec = quotas.get(ns) or {}
        return (float(spec.get("guaranteeHBM", 0) or 0) > 0
                or float(spec.get("guaranteeChips", 0) or 0) > 0)

    def _retry_unschedulable(via: str) -> None:
        """Re-run the pending bucket against the re-listed fleet (it
        just changed) — the defrag/autoscale rounds' recovery idiom."""
        for verdict in unschedulable[:]:
            try:
                pod = api.get_pod(verdict.get("namespace", "default"),
                                  verdict["pod"])
            except NotFoundError:
                continue
            candidates = [n.name for n in api.list_nodes()
                          if nodeutils.is_schedulable(n, pod)]
            retry = _schedule_one(client, pod, candidates)
            if retry.pop("state") == "bound":
                unschedulable.remove(verdict)
                retry["pod"] = pod.name
                retry["namespace"] = pod.namespace
                retry["via"] = via
                placements.append(retry)

    guarantee_evictions: list[str] = []
    provisioned_pods: list[str] = []
    provisioned_nodes: list[str] = []
    wave_pods: list[tuple[str, str]] = []
    failed_node: dict = {"name": None}

    # -- the router front (decode pods bound by the baseline replay) -- #
    serving = cfg.get("serving") or {}
    prefix = str(serving.get("pods", "decode"))
    slots = int(serving.get("slots_per_replica", 4))
    model = {key: float(serving.get(key, default))
             for key, default in FLEET_DAY_SERVING.items()}
    fronted = [p for p in placements if p["pod"].startswith(prefix)]
    if not fronted:
        return {"error": f"fleet_day: no bound pod named {prefix}* "
                         "to front with the router"}
    serve_ns = fronted[0].get("namespace", "default")
    # Cooldown zero: the signal is evaluated every tick, but the
    # MARKER only fires while `on_scaleout` is armed — and the surge
    # injection arms it for exactly one shot, so an incidental queue
    # blip in another hour cannot page (= go spurious in the witness).
    router = Router(quota=stack.controller.quota, clock=now,
                    scaleout_queue_factor=float(
                        serving.get("scaleout_queue_factor", 0.3)),
                    scaleout_cooldown_s=0.0)
    for p in fronted:
        pod = api.get_pod(p.get("namespace", "default"), p["pod"])
        ann = pod.raw["metadata"].get("annotations") or {}
        router.add_replica(DecodeReplica(
            p["pod"], slots=slots, node=p.get("node", ""),
            hbm_gib=float(ann.get(_c.ANN_HBM_POD, 0) or 0), **model))
    _obs.timeline().add_source("router", _sources.router_source(router))

    # Arm AFTER the baseline replay: the seeded quota ConfigMap fired
    # a boot-time "config" marker the schedule does not witness.
    witness.arm()
    sample()

    tenants = [str(t) for t in cfg.get("tenants",
                                       ("chat-a", "chat-b", "chat-c"))]
    prompt_len = int(cfg.get("prompt_len", 128))
    max_new = int(cfg.get("max_new", 64))
    peak_rph = int(cfg.get("peak_requests_per_hour", 6))
    outcomes: dict[str, dict[str, int]] = {}

    def _submit(tenant: str) -> None:
        dec = router.submit(tenant, prompt_len, max_new, now=now())
        row = outcomes.setdefault(
            tenant, {"assigned": 0, "queued": 0, "shed": 0})
        row[dec["outcome"]] += 1

    # -- the injected acts --------------------------------------------- #

    def _inject_quota() -> dict:
        t = now()
        witness.expect("quota-apply", kind="config",
                       detail_substr="quota", window_s=window_s,
                       injected_ts=t)
        tighten = str(cfg.get("quota_tighten_tenant", "flood"))
        spec = dict(quotas.get(tighten) or {})
        spec["limitHBM"] = max(int(spec.get("limitHBM", 8) or 8) // 2, 1)
        doc = _quota_configmap(scenario)
        doc["data"][tighten] = json.dumps(spec)
        api.update_configmap(ConfigMap(doc))
        observed = _await_marker("config", t)
        settle()
        return {"event": "quota-apply", "ts": t, "tenant": tighten,
                "observed": observed}

    def _inject_surge() -> dict:
        t = now()
        witness.expect("request-surge", kind="router-scaleout",
                       detail_substr="queue depth",
                       metric="router_queue_depth", metric_delta=2.0,
                       window_s=window_s, injected_ts=t)

        def _provision(spec: dict) -> None:
            # One scale-out bind through the real verbs, then disarm:
            # the day witnesses exactly one router-scaleout page.
            router.on_scaleout = None
            name = f"{prefix}-scale-{len(provisioned_pods)}"
            pod = api.create_pod(make_pod(
                name, hbm=int(spec.get("hbmGiB", 8)) or 8,
                namespace=serve_ns))
            candidates = [n.name for n in api.list_nodes()
                          if nodeutils.is_schedulable(n, pod)]
            verdict = _schedule_one(client, pod, candidates)
            if verdict.get("state") != "bound":
                unschedulable.append({"pod": name,
                                      "namespace": serve_ns,
                                      "reason": verdict.get("reason")})
                return
            provisioned_pods.append(name)
            placements.append({"pod": name, "namespace": serve_ns,
                               "node": verdict.get("node"),
                               "via": "router scale-out"})
            router.add_replica(DecodeReplica(
                name, slots=slots, node=verdict.get("node") or "",
                hbm_gib=float(spec.get("hbmGiB", 8) or 8), **model))

        router.on_scaleout = _provision
        for tenant in tenants:
            for _ in range(int(cfg.get("surge_requests", 8))):
                _submit(tenant)
        for _ in range(int(cfg.get("surge_flood_requests", 12))):
            _submit("flood")
        router.tick(now())
        settle()
        return {"event": "request-surge", "ts": t,
                "scaledOut": list(provisioned_pods)}

    def _inject_notready() -> dict:
        untainted = sorted(
            n.name for n in api.list_nodes()
            if not (n.raw.get("spec") or {}).get("taints")
            and not n.unschedulable)
        name = str(cfg.get("fail_node", "") or rng.choice(untainted))
        failed_node["name"] = name
        t = now()
        witness.expect("host-notready", kind="node-notready",
                       detail_substr=name,
                       event_reason=_events.REASON_NODE_NOTREADY,
                       metric="fleet_nodes_ready", metric_delta=-1.0,
                       window_s=window_s, injected_ts=t)
        node = api.get_node(name)
        node.raw.setdefault("status", {})["conditions"] = [
            {"type": "Ready", "status": "False",
             "reason": "KubeletStopped"}]
        api.update_node(node)
        observed = _await_marker("node-notready", t)
        _poll_events()
        settle()
        return {"event": "node-notready", "ts": t, "node": name,
                "observed": observed}

    def _inject_recover() -> dict:
        name = failed_node["name"]
        if not name:
            return {"event": "node-recovered", "skipped": True}
        node = api.get_node(name)
        node.raw.setdefault("status", {})["conditions"] = [
            {"type": "Ready", "status": "True"}]
        api.update_node(node)
        # Only the True->False edge marks; recovery just restores the
        # informer's view (and the fleet_nodes_ready series).
        _settle(stack.controller)
        settle()
        return {"event": "node-recovered", "ts": now(), "node": name}

    def _inject_defrag() -> dict:
        t = now()
        witness.expect("defrag-wave", kind="defrag-plan",
                       event_reason=_events.REASON_DEFRAG_MOVE,
                       window_s=window_s, injected_ts=t)
        report = _run_defrag(api, client, stack, "active",
                             unschedulable, placements,
                             api.list_nodes())
        moves = (report.get("plan") or {}).get("moves", [])
        for move in moves:
            if move.get("status") != "evicted":
                continue
            ns = str(move.get("pod", "")).split("/", 1)[0]
            if _guaranteed_ns(ns):
                guarantee_evictions.append(str(move["pod"]))
        _poll_events()
        settle()
        return {"event": "defrag-wave", "ts": t, "moves": len(moves),
                "recovered": report.get("recovered", [])}

    def _inject_scale_up() -> dict:
        wave = cfg.get("wave") or {}
        count = int(wave.get("count", 2))
        ns = str(wave.get("namespace", "team-wave"))
        for i in range(count):
            doc = make_pod(f"wave-{i}", hbm=int(wave.get("hbm", 20)),
                           chips=int(wave.get("chips", 0)),
                           namespace=ns)
            doc["spec"]["tolerations"] = list(
                wave.get("tolerations")
                or [{"key": "pool", "operator": "Exists"}])
            pod = api.create_pod(doc)
            wave_pods.append((ns, pod.name))
            candidates = [n.name for n in api.list_nodes()
                          if nodeutils.is_schedulable(n, pod)]
            verdict = _schedule_one(client, pod, candidates)
            verdict["pod"] = pod.name
            verdict["namespace"] = ns
            if verdict.pop("state") == "bound":
                verdict["via"] = "fleet-day wave"
                placements.append(verdict)
            else:
                unschedulable.append(verdict)
        t = now()
        witness.expect("evening-scale-up", kind="autoscale-up",
                       metric="fleet_nodes", metric_delta=1.0,
                       window_s=window_s, injected_ts=t)
        ex = stack.controller.autoscale
        ex.mode = "active"
        ex.up_delay_s = ex.down_delay_s = ex.cooldown_s = 0.0
        ex._now = now
        # The informer has seen the wave pods: the demand tracker drops a
        # pod its informer does not list, and the autoscaler then reads no
        # demand and scales down (the reference ticks at once).
        _settle(stack.controller)
        for _ in range(count + 2):
            if not any(str(v.get("pod", "")).startswith("wave-")
                       for v in unschedulable):
                break
            decision = ex.tick()
            if (decision is None
                    or decision.get("action") != "scale-up"
                    or decision.get("error")):
                break
            _settle(stack.controller)  # the informer has seen the new node
            provisioned_nodes.append(decision["node"])
            _retry_unschedulable("autoscale")
        settle()
        return {"event": "autoscale-up", "ts": t,
                "nodes": list(provisioned_nodes)}

    def _inject_scale_down() -> dict:
        t = now()
        witness.expect("overnight-scale-down", kind="autoscale-down",
                       metric="fleet_nodes", metric_delta=-1.0,
                       window_s=window_s, injected_ts=t)
        # The wave retires (its owner is done); the trough is real.
        for pns, pname in wave_pods:
            try:
                api.delete_pod(pns, pname)
            except NotFoundError:
                pass
        _settle(stack.controller)
        ex = stack.controller.autoscale
        ex._now = now
        originals = {f"{p.namespace}/{p.name}": p
                     for p in api.list_pods()}
        drained: list[str] = []
        for _ in range(8):
            decision = ex.tick()
            if decision is None:
                break
            if (decision.get("action") != "scale-down"
                    or decision.get("error")):
                break
            _settle(stack.controller)
            # Play the Job controller for every drain eviction, the
            # autoscale round's idiom — and count any guaranteed
            # victim against the day's zero-eviction gate.
            for ev in decision.get("evictions") or []:
                if ev.get("status") != "evicted":
                    continue
                pns = str(ev["pod"]).split("/", 1)[0]
                if _guaranteed_ns(pns):
                    guarantee_evictions.append(str(ev["pod"]))
                original = originals.get(ev["pod"])
                if original is None:
                    continue
                raw = original.deepcopy().raw
                meta = raw.setdefault("metadata", {})
                for key in ("uid", "resourceVersion"):
                    meta.pop(key, None)
                ann = meta.get("annotations") or {}
                for key in _c.GRANT_ANNOTATIONS:
                    ann.pop(key, None)
                raw.setdefault("spec", {}).pop("nodeName", None)
                raw["status"] = {"phase": "Pending"}
                pod = api.create_pod(raw)
                candidates = [n.name for n in api.list_nodes()
                              if nodeutils.is_schedulable(n, pod)]
                verdict = _schedule_one(client, pod, candidates)
                verdict["pod"] = pod.name
                verdict["namespace"] = pod.namespace
                if verdict.pop("state") == "bound":
                    verdict["via"] = "autoscale drain"
                    placements.append(verdict)
            if decision.get("phase") == "delete":
                drained.append(decision["node"])
                _settle(stack.controller)
                if set(provisioned_nodes) <= set(drained):
                    break  # the wave capacity is gone; stop shrinking
        settle()
        return {"event": "autoscale-down", "ts": t, "drained": drained}

    # -- the day ------------------------------------------------------- #

    schedule: dict[int, list] = {}

    def _at(key: str, default: float, fn) -> None:
        h = int(float(cfg.get(key, default)) * hours)
        schedule.setdefault(min(max(h, 0), hours - 1), []).append(fn)

    _at("quota_at", 0.25, _inject_quota)
    _at("surge_at", 0.40, _inject_surge)
    _at("notready_at", 0.50, _inject_notready)
    _at("recover_at", 0.55, _inject_recover)
    _at("defrag_at", 0.65, _inject_defrag)
    _at("scale_up_at", 0.80, _inject_scale_up)
    _at("scale_down_at", 0.90, _inject_scale_down)

    fleet_by_hour: list[int] = []
    injections: list[dict] = []
    for h in range(hours):
        clock["now"] = max(clock["now"], h * hour_s)
        for fn in schedule.get(h, []):
            record = fn()
            if record:
                injections.append({"hour": h, **record})
        # Diurnal open-loop traffic with seeded tenant churn: the
        # half-sine profile peaks mid-day; which tenants are awake
        # each hour (and when their requests land) is the rng's call.
        load = math.sin(math.pi * (h + 0.5) / hours)
        arrivals: list[tuple[float, str]] = []
        for tenant in tenants:
            if rng.random() >= 0.3 + 0.7 * load:
                continue
            for _ in range(max(1, round(peak_rph * load))):
                arrivals.append((h * hour_s + rng.random() * hour_s,
                                 tenant))
        arrivals.sort()
        nxt = 0
        for s in range(steps):
            step_end = h * hour_s + (s + 1) * tick_s
            while nxt < len(arrivals) and arrivals[nxt][0] <= step_end:
                clock["now"] = max(clock["now"], arrivals[nxt][0])
                _submit(arrivals[nxt][1])
                nxt += 1
            clock["now"] = max(clock["now"], step_end)
            router.tick(clock["now"])
        sample()
        fleet_by_hour.append(len(api.list_nodes()))

    # Bounded drain, the serving round's idiom: every queued request
    # retires (which is why Jain fairness counts queued as served).
    deadline = clock["now"] + 600.0
    while clock["now"] < deadline:
        router.tick(clock["now"])
        snap = router.snapshot()
        if snap["queuedTotal"] == 0 and snap["slotsInUse"] == 0:
            break
        clock["now"] += max(tick_s, 0.5)
    _settle(stack.controller)

    # -- the verdict join ---------------------------------------------- #
    _poll_events()
    series = _obs.timeline().snapshot(markers=False).get("series") or {}
    witness_report = witness.evaluate(series=series)
    witness.disarm()

    demanded = len(placements) + len(held) + len(unschedulable)
    compliance = (100.0 * len(placements) / demanded
                  if demanded else 100.0)
    xs = []
    for tenant in tenants:
        row = outcomes.get(tenant)
        if not row:
            continue
        total = row["assigned"] + row["queued"] + row["shed"]
        if total:
            xs.append((row["assigned"] + row["queued"]) / total)
    sq = sum(x * x for x in xs)
    fairness = round(sum(xs) ** 2 / (len(xs) * sq), 4) if sq else None
    node_hours = float(sum(fleet_by_hour))
    peak_static = (float(max(fleet_by_hour) * hours)
                   if fleet_by_hour else 0.0)
    snap = router.snapshot()
    return {
        "seed": seed,
        "hours": hours,
        "hourS": hour_s,
        "injections": injections,
        "witness": witness_report,
        "traffic": {
            "outcomes": outcomes,
            "scaleOut": {"signals": snap["scaleOut"]["signals"],
                         "bound": list(provisioned_pods)},
        },
        "fleetByHour": fleet_by_hour,
        "guaranteeEvictions": guarantee_evictions,
        "scalars": {
            "pod_slo_compliance_pct": round(compliance, 2),
            "router_fairness_jain": fairness,
            "node_hours": node_hours,
            "peak_static_node_hours": peak_static,
            "node_hours_ratio": (round(node_hours / peak_static, 4)
                                 if peak_static else None),
            "guarantee_evictions": len(guarantee_evictions),
        },
    }


def _quota_configmap(scenario: dict) -> dict | None:
    """Scenario ``quotas:`` table -> the tpushare-quotas ConfigMap doc
    (None when the scenario declares no quotas)."""
    quotas = scenario.get("quotas")
    if not quotas:
        return None
    from tpushare_torch.utils import const

    return {
        "apiVersion": "v1", "kind": "ConfigMap",
        "metadata": {"name": const.QUOTA_CONFIGMAP,
                     "namespace": "kube-system"},
        "data": {str(tenant): json.dumps(spec)
                 for tenant, spec in quotas.items()},
    }


class WireError(RuntimeError):
    """A verb returned an unexpected HTTP failure — the replay cannot
    produce a truthful report, so it aborts instead of guessing."""


def _schedule_one(client: _Client, pod, candidates: list[str]) -> dict:
    from tpushare_torch.gang.planner import QUORUM_HOLD_MARKER

    if not candidates:
        return {"state": "unschedulable",
                "reason": "no schedulable node (cordon/taints)"}
    status, result = client.post("/tpushare-scheduler/filter",
                                 {"Pod": pod.raw, "NodeNames": candidates})
    if status != 200:
        raise WireError(f"filter HTTP {status}: {result}")
    passing = result.get("NodeNames") or []
    if not passing:
        # Representative rejection reason (they are per-node).
        reasons = result.get("FailedNodes") or {}
        return {"state": "unschedulable",
                "reason": next(iter(reasons.values()), "no node fits")}
    status, ranked = client.post("/tpushare-scheduler/prioritize",
                                 {"Pod": pod.raw, "NodeNames": passing})
    if status != 200:
        raise WireError(f"prioritize HTTP {status}: {ranked}")
    best = max(ranked, key=lambda e: e["Score"])["Host"]
    status, bound = client.post("/tpushare-scheduler/bind", {
        "PodName": pod.name, "PodNamespace": pod.namespace,
        "PodUID": pod.uid, "Node": best})
    if status != 200 or bound.get("Error"):
        # The wire carries only Error (the scheduler retries on 500);
        # a gang hold is distinguished by the GangPending marker. The
        # final reconciliation pass upgrades held members that commit
        # once the rest of their gang arrives.
        err = bound.get("Error", f"bind HTTP {status}")
        if QUORUM_HOLD_MARKER in err:
            return {"state": "held", "pending": True, "node": best,
                    "reason": err}
        return {"state": "unschedulable", "reason": err}
    return {"state": "bound", "node": best}


def _whatif_preempt(client: _Client, pod, candidates: list[str]) -> dict:
    """Dry-run the preempt verb for an unplaceable priority pod: the
    victims that WOULD make room, per node (nothing is evicted)."""
    status, plan = client.post("/tpushare-scheduler/preempt", {
        "Pod": pod.raw,
        "NodeNameToMetaVictims": {n: {"Pods": []} for n in candidates}})
    if status != 200:
        return {}
    out = {}
    for node, victims in (plan.get("NodeNameToMetaVictims") or {}).items():
        pods = [p.get("UID", "") for p in (victims or {}).get("Pods") or []]
        if pods:
            out[node] = pods
    return out


def _execute_preemption(api, client: _Client, controller, pod,
                        plan: dict) -> tuple[dict, dict] | None:
    """Replay kube-scheduler's preemption round for one pod: pick the
    node with the smallest victim set, evict (delete) the victims,
    record ``status.nominatedNodeName`` (the earmark that keeps other
    pods — gang siblings included — off the freed capacity), wait for
    the controller to observe the deletions, then re-schedule on that
    node. Returns (schedule verdict, eviction record), or None when no
    victim could be resolved (plan raced a completion)."""
    node = min(plan, key=lambda n: (len(plan[n]), n))
    by_uid = {p.uid: p for p in api.list_pods()}
    evicted = []
    for uid in plan[node]:
        victim = by_uid.get(uid)
        if victim is None:
            continue
        api.delete_pod(victim.namespace, victim.name)
        evicted.append(f"{victim.namespace}/{victim.name}")
    if not evicted:
        return None
    fresh = api.get_pod(pod.namespace, pod.name)
    fresh.raw.setdefault("status", {})["nominatedNodeName"] = node
    api.update_pod(fresh)
    _settle(controller)
    # wait_idle guarantees the deletions reached the ledger; a couple
    # of short retries cover any residual lag without letting a
    # genuinely-doomed pod (plan raced a completion, earmarked chips)
    # spin for seconds.
    verdict = _schedule_one(client, api.get_pod(pod.namespace, pod.name),
                            [node])
    for _ in range(2):
        if verdict["state"] != "unschedulable":
            break
        time.sleep(0.05)
        verdict = _schedule_one(client,
                                api.get_pod(pod.namespace, pod.name),
                                [node])
    verdict.setdefault("via", "preemption")
    return verdict, {"pod": f"{pod.namespace}/{pod.name}", "node": node,
                     "evicted": evicted}


def _nvidia_ring(members: list[dict]) -> bool:
    """True when every member's node names an NVIDIA card (the port's
    discovery reads its model, e.g. ``h100-80gb``); a ring over TPU hosts,
    or over nodes of no known type, is the reference's."""
    from tpushare_torch.deviceplugin.discovery import parse_model

    return bool(members) and all(parse_model(n.get("tpuType", ""))
                                 for n in members)


def _ring_step_ms(members: list[dict], coords, grid) -> float:
    """A placed ring's predicted step time by its hardware's model: over
    TPU hosts the reference's ICI/DCN model
    (:mod:`tpushare_torch.topology.ici`) on the grid hops; over NVIDIA
    nodes the port's NVLink/NIC model, on which a hop between two ranks
    of one node is an NVSwitch hop (0) and any other leaves through the
    NIC (None)."""
    from tpushare_torch.topology import fleet as topo
    from tpushare_torch.topology import ici

    if not _nvidia_ring(members):
        return ici.predicted_step_time_ms([topo.ring_hops(coords, grid)],
                                          [])
    from tpushare_torch.workload import parallel as PL

    names = [n["name"] for n in members]
    hops = [0 if a == b else None
            for a, b in zip(names, names[1:] + names[:1])]
    return PL.predicted_step_time_ms([hops], [])


def _gang_topology(inspect_doc) -> list[dict]:
    """Ring geometry of every placed gang with located hosts: members
    in worker (pod-name) order, their host-grid coordinates, the ring
    contiguity/worst-hop over the slice grid, and the ring-latency
    model's predicted step time (:func:`_ring_step_ms`) — the report's
    proof that a placement is (or is not) contiguous."""
    from tpushare_torch.topology import fleet as topo
    from tpushare_torch.topology import topology as T

    gangs: dict[str, dict[str, dict]] = {}
    for n in inspect_doc.get("nodes", []):
        for c in n.get("chips", []):
            for p in c.get("pods", []):
                gang = p.get("gang")
                if gang:
                    gangs.setdefault(gang, {})[p["name"]] = n
    out = []
    for gang, members in sorted(gangs.items()):
        # Worker (ring) order: numeric-ordinal names, the same key the
        # gang planner's steering used.
        ordered = sorted(members, key=topo.worker_sort_key)
        grid = None
        coords: list[tuple[int, ...] | None] = []
        for name in ordered:
            n = members[name]
            hc = n.get("hostCoords")
            if hc is None:
                coords.append(None)
                continue
            if grid is None:
                grid = T.slice_host_grid(n.get("sliceTopology", ""),
                                         n.get("topology", ""),
                                         n.get("tpuType", ""))
            coords.append(tuple(hc))
        if grid is None:
            continue  # no located member: no ring geometry to report
        stats = topo.ring_stats(coords, grid)
        step_ms = _ring_step_ms([members[m] for m in ordered], coords, grid)
        out.append({
            "gang": gang,
            "members": ordered,
            "nodes": [members[m]["name"] for m in ordered],
            "coords": [list(c) if c is not None else None
                       for c in coords],
            "ringContiguity": stats["contiguity"],
            "worstHop": stats["worstHop"],
            "dcnHops": stats["dcnHops"],
            "predictedStepMs": round(step_ms, 3),
        })
    return out


def _report(inspect_doc, placements, held, unschedulable,
            latencies, executed_preemptions=(), tenants=(),
            slo_doc=None, defrag_report=None, serving_report=None,
            autoscale_report=None, fleet_day_report=None):
    nodes = []
    total_hbm = used_hbm = free_whole_chips = cordoned_hbm = 0
    for n in inspect_doc.get("nodes", []):
        free_chips = sum(1 for c in n["chips"] if c["usedHBM"] == 0)
        if n.get("unschedulable"):
            # A cordoned node's capacity is not plannable headroom: keep
            # it out of the headline (utilization, free chips) and break
            # it out so the report can't claim capacity it also proves
            # unusable.
            cordoned_hbm += n["totalHBM"] - n["usedHBM"]
        else:
            free_whole_chips += free_chips
            total_hbm += n["totalHBM"]
            used_hbm += n["usedHBM"]
        nodes.append({
            "name": n["name"],
            "usedHBM": n["usedHBM"], "totalHBM": n["totalHBM"],
            "freeWholeChips": free_chips,
            # A multi-chip pod appears on each of its chips: count names.
            "pods": len({p["name"] for c in n["chips"]
                         for p in c["pods"]}),
            **({"unschedulable": True} if n.get("unschedulable") else {}),
        })
    return {
        "utilization_pct": round(100.0 * used_hbm / total_hbm, 2)
                           if total_hbm else 0.0,
        "total_hbm": total_hbm,
        "used_hbm": used_hbm,
        "cordoned_free_hbm": cordoned_hbm,
        "free_whole_chips": free_whole_chips,
        "bound": len(placements),
        "held": len(held),
        "unschedulable": len(unschedulable),
        "p50_schedule_ms": round(statistics.median(latencies), 3)
                           if latencies else None,
        "nodes": nodes,
        "placements": placements,
        "held_pods": held,
        "unschedulable_pods": unschedulable,
        "gangs": inspect_doc.get("gangs", []),
        **({"topology": topo_section}
           if (topo_section := _gang_topology(inspect_doc)) else {}),
        "preemptions_executed": list(executed_preemptions),
        "tenants": list(tenants),
        "slo": slo_doc or {},
        **({"defrag": defrag_report} if defrag_report else {}),
        **({"serving": serving_report} if serving_report else {}),
        **({"autoscale": autoscale_report} if autoscale_report else {}),
        **({"fleet_day": fleet_day_report} if fleet_day_report else {}),
    }


def _print_gang_rings(sections: list, indent: str = "  ") -> None:
    for t in sections:
        print(f"{indent}{t['gang']}: contiguity {t['ringContiguity']}, "
              f"worst hop {t['worstHop']}, predicted step "
              f"{t['predictedStepMs']} ms")
        for member, node, coord in zip(t["members"], t["nodes"],
                                       t["coords"]):
            where = ("off-grid" if coord is None
                     else "(" + ",".join(str(c) for c in coord) + ")")
            print(f"{indent}  {member} -> {node} {where}")


def _print_human(report: dict) -> None:
    if report.get("error"):
        print(f"error: {report['error']}", file=sys.stderr)
        raise SystemExit(2)
    cordoned = (f" (+{report['cordoned_free_hbm']} GiB free but cordoned)"
                if report.get("cordoned_free_hbm") else "")
    print(f"fleet: {len(report['nodes'])} nodes, "
          f"{report['used_hbm']}/{report['total_hbm']} GiB schedulable "
          f"HBM used ({report['utilization_pct']}%), "
          f"{report['free_whole_chips']} whole chips free{cordoned}")
    print(f"pods: {report['bound']} bound, {report['held']} held (gang), "
          f"{report['unschedulable']} unschedulable; "
          f"p50 schedule {report['p50_schedule_ms']} ms")
    print()
    print(f"{'NODE':<12} {'HBM USED':>12} {'FREE CHIPS':>10} "
          f"{'PODS':>5}  FLAGS")
    for n in report["nodes"]:
        flags = "cordoned" if n.get("unschedulable") else ""
        print(f"{n['name']:<12} {n['usedHBM']:>5}/{n['totalHBM']:<6} "
              f"{n['freeWholeChips']:>10} {n['pods']:>5}  {flags}")
    if report["held_pods"]:
        print("\nheld (gang below quorum):")
        for h in report["held_pods"]:
            print(f"  {h['pod']} -> {h.get('node', '?')}: {h['reason']}")
    if report["unschedulable_pods"]:
        print("\nunschedulable:")
        for u in report["unschedulable_pods"]:
            print(f"  {u['pod']}: {u['reason']}")
            for node, victims in (u.get("would_preempt") or {}).items():
                print(f"    would fit on {node} by evicting "
                      f"{len(victims)} pod(s)")
    if report.get("topology"):
        print("\ntopology (gang rings, worker order):")
        _print_gang_rings(report["topology"], indent="  ")
        if report.get("topology_blind") is not None:
            print("  -- same scenario, placer OFF "
                  "(TPUSHARE_TOPOLOGY=off) --")
            if report["topology_blind"]:
                _print_gang_rings(report["topology_blind"], indent="  ")
            else:
                print("    (no located gang placement)")
    if report.get("preemptions_executed"):
        print("\npreemptions executed:")
        for p in report["preemptions_executed"]:
            print(f"  {p['pod']} -> {p['node']}: evicted "
                  f"{', '.join(p['evicted'])}")
    defrag_doc = report.get("defrag")
    if defrag_doc:
        plan = defrag_doc.get("plan")
        print(f"\ndefrag ({defrag_doc.get('mode')}):")
        if defrag_doc.get("error"):
            print(f"  error: {defrag_doc['error']}")
        elif plan is None:
            print("  no legal rebalance plan (nothing movable helps)")
        else:
            for m in plan.get("moves", []):
                print(f"  move {m['pod']}: {m['from']} -> {m['to']} "
                      f"[{m['status']}] trace {m['traceId']}")
            for m in defrag_doc.get("migrated", []):
                state = "re-bound" if m["rebound"] else "NOT re-bound"
                print(f"  migrated {m['pod']} -> {m['to']} ({state})")
            if defrag_doc.get("recovered"):
                print("  unblocked: "
                      + ", ".join(defrag_doc["recovered"]))
    as_doc = report.get("autoscale")
    if as_doc:
        print(f"\nautoscale ({as_doc.get('mode')}):")
        if as_doc.get("error"):
            print(f"  error: {as_doc['error']}")
        for d in as_doc.get("decisions", []):
            tag = " [dry-run]" if d.get("dryRun") else ""
            if d.get("action") == "hold":
                print(f"  hold: {d.get('reason')} — {d.get('detail')}")
            elif d.get("action") == "scale-up":
                shape = d.get("shape") or {}
                want = (f"{shape['chips']} chip(s)" if shape.get("chips")
                        else f"{shape.get('hbmGiB')} GiB")
                kind = (d.get("election") or {}).get("kind", "?")
                print(f"  scale-up {d.get('node')} for {want} "
                      f"({kind}){tag}")
            else:
                print(f"  scale-down {d.get('node')} "
                      f"[{d.get('phase')}]{tag}")
                for ev in d.get("evictions") or []:
                    print(f"    {ev['pod']}: {ev['status']}")
            if d.get("error"):
                print(f"    error: {d['error']}")
        if as_doc.get("provisioned"):
            print("  provisioned: " + ", ".join(as_doc["provisioned"]))
        if as_doc.get("drained"):
            print("  drained: " + ", ".join(as_doc["drained"]))
        if as_doc.get("recovered"):
            print("  unblocked: " + ", ".join(as_doc["recovered"]))
    slo_doc = report.get("slo") or {}
    journeys = slo_doc.get("journeys") or {}
    if journeys.get("closed"):
        closed = ", ".join(f"{n} {outcome}" for outcome, n in
                           sorted(journeys["closed"].items()))
        extra = ""
        if journeys.get("p50E2eSeconds") is not None:
            extra = (f"; bound e2e p50 "
                     f"{journeys['p50E2eSeconds'] * 1e3:.0f} ms / p99 "
                     f"{journeys['p99E2eSeconds'] * 1e3:.0f} ms, mean "
                     f"{journeys.get('meanAttempts')} attempt(s)")
        print(f"\njourneys: {closed}{extra}")
    burning = [s for s in slo_doc.get("slos", []) if s.get("burning")]
    for s in burning:
        print(f"SLO BURNING: {s['slo']} — "
              + ", ".join(f"{w}={v['burnRate']}x"
                          for w, v in s["windows"].items())
              + f" (budget {s['errorBudgetRemaining'] * 100:.0f}% left)")
    hot = report.get("hotspots")
    if hot:
        print(f"\nhotspots (continuous profiler, "
              f"{hot.get('samplingPasses', 0)} passes at "
              f"{hot.get('hz', '?')}Hz, overhead "
              f"{hot.get('overheadRatio', 0) * 100:.2f}%):")
        costs = hot.get("verbCosts", {})
        shown = {v: d for v, d in hot.get("verbs", {}).items()
                 if v != "idle"}
        for verb, vdoc in sorted(
                shown.items(),
                key=lambda kv: -float(kv[1].get("profiledSeconds")
                                      or kv[1].get("estSeconds")
                                      or 0.0)):
            cost = costs.get(verb, {})
            extra = ""
            if cost:
                extra = (f" | exact {cost['wallSeconds']:.3f}s wall, "
                         f"{cost['cpuSeconds']:.3f} cpu, "
                         f"{cost['lockWaitSeconds']:.3f} lock, "
                         f"{cost['apiSeconds']:.3f} api")
            if vdoc.get("engine") == "decision-probe":
                head = (f"{vdoc['profiledDecisions']} decision(s) "
                        "profiled exactly")
            else:
                head = f"{vdoc['samples']} samples"
            print(f"  {verb}: {head}, top frames cover "
                  f"{vdoc['coverage'] * 100:.0f}%{extra}")
            for f in vdoc.get("frames", [])[:3]:
                print(f"    {f['share'] * 100:5.1f}%  {f['frame']}")
    if report.get("tenants"):
        print("\ntenants (quota):")
        for t in report["tenants"]:
            spec = "/".join(str(t.get(k, "-")) for k in
                            ("guaranteeHBM", "limitHBM"))
            print(f"  {t['tenant']}: {t['usedHBM']} GiB used "
                  f"({t['borrowedHBM']} borrowed), "
                  f"{t['usedChips']} chip(s), guarantee/limit HBM "
                  f"{spec}, {t['pods']} pod(s)")
    if report.get("serving"):
        s = report["serving"]
        if s.get("error"):
            print(f"\nserving: {s['error']}")
        else:
            scaled = [p["pod"] for p in s["scaleOut"]["provisioned"]
                      if p["bound"]]
            print(f"\nserving (router over {len(s['replicas'])} "
                  f"fronted + {len(scaled)} scaled replica(s)):")
            snap = s["snapshot"]
            for tenant, o in sorted(s["outcomes"].items()):
                ttft = snap["tenants"].get(tenant, {}).get("ttft", {})
                print(f"  {tenant}: {o['assigned']} assigned, "
                      f"{o['queued']} queued, {o['shed']} shed; "
                      f"ttft p99 {ttft.get('p99')}s")
            drained = (f"drained at {s['drainedAtS']}s"
                       if s["drainedAtS"] is not None
                       else "DID NOT drain")
            print(f"  scale-out: {s['scaleOut']['signals']} "
                  f"signal(s), bound {scaled or 'none'}; {drained}")
    if report.get("fleet_day"):
        fd = report["fleet_day"]
        if fd.get("error"):
            print(f"\nfleet-day: {fd['error']}")
        else:
            w = fd["witness"]
            c = w["counts"]
            print(f"\nfleet-day (seed {fd['seed']}, {fd['hours']}h x "
                  f"{fd['hourS']:g}s): witness "
                  f"{'PASS' if w['pass'] else 'FAIL'} — "
                  f"{c['matched']} matched, {c['late']} late, "
                  f"{c['missing']} missing, {c['spurious']} spurious "
                  f"({w['conformancePct']}% conformance)")
            for v in w["verdicts"]:
                lag = (f"marker +{v['markerLagS']}s"
                       if v["markerLagS"] is not None else "no marker")
                bad = ",".join(k for k, ok in v["legs"].items()
                               if ok is False)
                print(f"  {v['verdict']:8s} {v['id']} ({v['kind']}) "
                      f"{lag}"
                      + (f"; failed leg(s): {bad}" if bad else ""))
            s = fd["scalars"]
            print(f"  slo compliance {s['pod_slo_compliance_pct']}%, "
                  f"fairness J {s['router_fairness_jain']}, "
                  f"node-hours {s['node_hours']:g}/"
                  f"{s['peak_static_node_hours']:g} "
                  f"(ratio {s['node_hours_ratio']}), guarantee "
                  f"evictions {s['guarantee_evictions']}")
    timeline = report.get("timeline")
    if timeline:
        series = timeline.get("series") or {}
        markers = timeline.get("markers") or []
        print(f"\ntimeline: {len(series)} series, "
              f"{len(markers)} marker(s), cursor "
              f"{timeline.get('cursorLatest', 0)}")
        for name in sorted(series):
            s = series[name]
            points = [v for _ts, v in (s.get("tier0") or [])]
            if not points:
                continue
            print(f"  {name}: last {s.get('last'):g} "
                  f"(min {min(points):g} / max {max(points):g} over "
                  f"{len(points)} point(s))")
        now = timeline.get("now") or 0.0
        for m in sorted(markers, key=lambda m: m.get("ts", 0.0)):
            age = now - m.get("ts", now)
            print(f"  [{m.get('cursor')}] -{age:.0f}s "
                  f"{m.get('kind')}: {m.get('detail')}")
    for g in report.get("gangs", []):
        print(f"\ngang {g.get('name')}: {g}")


def defrag(inspect_doc: dict, drain: str | None = None) -> dict:
    """Defragmentation advisor: what would re-packing the CURRENT fleet
    buy, and which pods would have to move?

    Live bin-packing is online — arrival order and churn fragment chips
    no matter how good the per-decision policy is. This takes the
    extender's inspect dump, re-schedules every resident pod from
    scratch (best-fit-decreasing through the REAL filter → prioritize →
    bind stack), and reports the achievable packing next to the current
    one: free whole chips reclaimed (the scarce resource multi-chip
    jobs starve for) and the move list. ADVISORY ONLY — nothing is
    evicted; the operator decides whether the gain is worth the moves
    (a kubectl delete on the listed pods re-packs them organically).

    ``drain`` flips the question to "can I drain node X?": everything
    NOT on X is pinned where it is, X's capacity is withdrawn, and only
    X's residents are re-packed onto the remaining fleet — the report's
    ``unplaced`` are the pods that will go Pending if the drain
    proceeds, and ``moves`` shows where the rest land. Gang members on
    X are still pinned (drain-evicting one member bricks its group) and
    surface in ``pinned`` so the operator sees the gang must be torn
    down whole first.
    """
    from tpushare_torch.k8s.builders import make_pod
    from tpushare_torch.utils import const

    current_nodes = inspect_doc.get("nodes", [])
    if not current_nodes:
        return {"error": "no nodes in inspect dump"}
    if drain is not None and drain not in {n["name"]
                                           for n in current_nodes}:
        return {"error": f"node {drain!r} not in the inspect dump"}

    # A node is RESTRICTED when its capacity is conditional: cordoned,
    # or tainted NoSchedule/NoExecute (which pods may land there depends
    # on tolerations the dump doesn't carry). Its residents are PINNED —
    # pre-placed exactly where they are so the repack packs around them
    # — as are committed gang members: "delete and re-create" one member
    # disrupts the whole group, so the advisor never proposes it.
    def _restricted(n: dict) -> bool:
        return bool(n.get("unschedulable")) or any(
            t.get("effect") in ("NoSchedule", "NoExecute")
            for t in n.get("taints") or [])

    residents: dict[tuple, dict] = {}
    cur_free_chips = 0
    for node in current_nodes:
        for chip in node["chips"]:
            if (chip["usedHBM"] == 0 and not _restricted(node)
                    and node["name"] != drain):
                # Drain mode asks about the REMAINING fleet, so the
                # departing node's chips never count as headroom.
                cur_free_chips += 1
            for pod in chip["pods"]:
                key = (pod["namespace"], pod["name"])
                residents.setdefault(key, {
                    "node": node["name"], "usedHBM": pod["usedHBM"],
                    "chips": len(pod["chipIds"]),
                    "chip_ids": tuple(sorted(pod["chipIds"])),
                    # First matching chip's capacity stands in for all of
                    # the pod's chips. On a heterogeneous-HBM node a
                    # multi-chip pod's other chips may differ — fine for
                    # this advisory's packing math (whole-chip pods ignore
                    # it; fractional pods are single-chip), but NOT valid
                    # as a per-chip ANN_HBM_CHIP rebuild source.
                    "chip_hbm": next(
                        (c["totalHBM"] for c in node["chips"]
                         if c["id"] in pod["chipIds"]), 0),
                    # The dump carries the REAL request type and scoring
                    # intent (inspect writes them), so no slice-vs-chip
                    # heuristic is needed; dumps predating those fields
                    # fall back to the capacity-equivalence guess.
                    "whole": pod.get(
                        "wholeChip",
                        pod["usedHBM"] >= sum(
                            c["totalHBM"] for c in node["chips"]
                            if c["id"] in pod["chipIds"])),
                    "scoring": pod.get("scoring", ""),
                    # Defrag mode: gangs + restricted-node residents
                    # stay put. Drain mode: everything stays put EXCEPT
                    # the drained node's non-gang residents.
                    "pinned": (bool(pod.get("gang")) or _restricted(node)
                               if drain is None else
                               bool(pod.get("gang"))
                               or node["name"] != drain),
                })

    scenario_fleet = [{
        "count": 1, "prefix": n["name"],
        "chips": len(n["chips"]),
        "chip_hbm": [c["totalHBM"] for c in n["chips"]],
        "tpu_type": n.get("tpuType", "v5e"),
        "topology": n.get("topology", "2x2x1"),
        "slice_id": n.get("sliceId", ""),
        # Restricted capacity is never offered to the repack; neither
        # is the node being drained.
        "unschedulable": _restricted(n) or n["name"] == drain,
    } for n in current_nodes]

    api = _fresh_api(_expand_fleet({"fleet": scenario_fleet}))
    from tpushare_torch.cmd.main import serve_stack, shutdown_stack
    from tpushare_torch.utils import const as _c
    stack, server = serve_stack(api)
    client = _Client(*server.server_address[:2])
    failed, pinned, blocking_gangs = [], [], []
    try:
        # Pinned residents first: created pre-bound at their CURRENT
        # placement (full annotation commit record + nodeName, exactly
        # what a crash-rebuild reads), so the repack packs AROUND them
        # instead of treating their chips as free.
        for (ns, name), rec in residents.items():
            if not rec["pinned"]:
                continue
            pinned.append(f"{ns}/{name}")
            if drain is not None and rec["node"] == drain:
                # A gang member on the node being drained: the drain
                # cannot proceed pod-by-pod — the group must be torn
                # down whole. This is a BLOCKER, not background pinning.
                blocking_gangs.append(f"{ns}/{name}")
            if rec["whole"]:
                doc = make_pod(name, chips=rec["chips"], namespace=ns)
            else:
                doc = make_pod(name, hbm=rec["usedHBM"], namespace=ns)
            doc["spec"]["nodeName"] = rec["node"]
            doc["status"]["phase"] = "Running"
            doc["metadata"]["annotations"].update({
                _c.ANN_CHIP_IDX: ",".join(map(str, rec["chip_ids"])),
                _c.ANN_HBM_POD: str(rec["usedHBM"]),
                _c.ANN_HBM_CHIP: str(rec["chip_hbm"]),
                _c.ANN_ASSIGNED: _c.ASSIGNED_TRUE,
                _c.ANN_ASSUME_TIME: "0",
            })
            api.create_pod(doc)
        if not stack.controller.wait_idle(timeout=30):
            # An un-ledgered pinned pod would make the repack bind onto
            # occupied chips — refuse to emit an unsound advisory.
            return {"error": "controller did not quiesce while pinning "
                             "residents; advisory aborted"}

        order = sorted(
            ((k, r) for k, r in residents.items() if not r["pinned"]),
            key=lambda kv: -kv[1]["usedHBM"])
        for (ns, name), rec in order:
            ann = ({const.ANN_SCORING: rec["scoring"]}
                   if rec["scoring"] else None)
            if rec["whole"]:
                doc = make_pod(name, chips=rec["chips"], namespace=ns,
                               annotations=ann)
            else:
                doc = make_pod(name, hbm=rec["usedHBM"], namespace=ns,
                               annotations=ann)
            pod = api.create_pod(doc)
            verdict = _schedule_one(
                client, pod, [n["name"] for n in current_nodes
                              if not _restricted(n)
                              and n["name"] != drain])
            if verdict["state"] != "bound":
                failed.append(f"{ns}/{name}")
        repack = client.get("/tpushare-scheduler/inspect")
    finally:
        client.close()
        shutdown_stack(stack, server)

    # Moves are CHIP-granular: consolidating two slices onto one chip of
    # the same node still means deleting a pod, so an intra-node shuffle
    # is a move too (a node-only diff would report gains with an empty
    # move list).
    new_map: dict[tuple, tuple] = {}
    for n in repack["nodes"]:
        for c in n["chips"]:
            for pod in c["pods"]:
                key = (pod["namespace"], pod["name"])
                new_map[key] = (n["name"],
                                tuple(sorted(pod["chipIds"])))
    moves = []
    for key, rec in residents.items():
        after = new_map.get(key)
        if after is None or rec["pinned"]:
            continue  # unplaced, or never considered movable
        if after != (rec["node"], rec["chip_ids"]):
            moves.append({"pod": f"{key[0]}/{key[1]}",
                          "from": f"{rec['node']}"
                                  f"[{','.join(map(str, rec['chip_ids']))}]",
                          "to": f"{after[0]}"
                                f"[{','.join(map(str, after[1]))}]"})

    restricted_names = {n["name"] for n in current_nodes
                        if _restricted(n) or n["name"] == drain}
    new_free = sum(1 for n in repack["nodes"]
                   for c in n["chips"]
                   if c["usedHBM"] == 0
                   and n["name"] not in restricted_names)
    return {
        "current_free_whole_chips": cur_free_chips,
        "repacked_free_whole_chips": new_free,
        "gain_whole_chips": new_free - cur_free_chips,
        "moves": moves,
        "pods": len(residents),
        # Pinned pods were never considered movable (gang members,
        # residents of cordoned/tainted nodes) — the repack packed
        # around them at their current placement.
        "pinned": pinned,
        **({"drained_node": drain,
            "blocking_gangs": sorted(blocking_gangs)} if drain else {}),
        # Non-empty means the advisory is unsound for those pods (e.g.
        # a heterogeneous detail the dump can't express) — say so
        # rather than under-report the fleet.
        "unplaced": failed,
    }


def _fresh_api(node_docs: list[dict]):
    from tpushare_torch.k8s.fake import FakeApiServer

    api = FakeApiServer()
    for doc in node_docs:
        api.create_node(doc)
    return api


def main() -> None:
    ap = argparse.ArgumentParser(
        description="Replay a fleet/workload scenario through the real "
                    "extender stack and report the packing.")
    ap.add_argument("scenario", nargs="?", help="YAML/JSON scenario file")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable report on stdout")
    ap.add_argument("--example", action="store_true",
                    help="print a starter scenario and exit")
    ap.add_argument("--example-tenants", action="store_true",
                    help="print a mixed-tenant quota-contention "
                         "scenario (borrowing, reclaim, limit denial) "
                         "and exit")
    ap.add_argument("--example-defrag", action="store_true",
                    help="print a defragmentation demo scenario "
                         "(fragment -> plan -> migrate -> pending pod "
                         "binds in one run) and exit")
    ap.add_argument("--example-autoscale", action="store_true",
                    help="print a fleet-autoscaling demo scenario "
                         "(packed fleet where defrag can't help -> "
                         "scale-up clones a node template -> the "
                         "pending ring pod binds on it) and exit")
    ap.add_argument("--example-serving", action="store_true",
                    help="print a serving front-door demo scenario "
                         "(surge -> shed the flooder -> scale-out "
                         "binds a decode pod -> queues drain) and "
                         "exit")
    ap.add_argument("--example-fleet-day", action="store_true",
                    help="print the fleet-day witness demo scenario "
                         "(one seeded, compressed 24h day: quota "
                         "apply, surge, NotReady host, defrag wave, "
                         "autoscale up/down — every act graded by "
                         "the fleet-day witness) and exit")
    ap.add_argument("--seed", type=int, default=None,
                    help="seed the fleet-day RNG (overrides the "
                         "scenario's fleet_day.seed); two runs with "
                         "the same seed produce identical witness "
                         "verdicts and scalars")
    ap.add_argument("--example-topology", action="store_true",
                    help="print a topology-aware gang placement demo "
                         "scenario (fragmented host torus; the same "
                         "pp-gang placed with the slice placer on and "
                         "off in one run, both rings priced by the "
                         "ring-latency model) and exit")
    ap.add_argument("--drain", metavar="NODE",
                    help="with --defrag: ask whether NODE can be "
                         "drained — only its residents are re-packed "
                         "(onto the remaining fleet); 'unplaced' pods "
                         "would go Pending")
    ap.add_argument("--defrag", metavar="SRC",
                    help="defrag advisory instead of a replay: SRC is an "
                         "extender base URL (its live inspect is fetched) "
                         "or a saved inspect-JSON file; reports what a "
                         "from-scratch re-pack would reclaim and which "
                         "pods would move (advisory only)")
    args = ap.parse_args()
    if args.example:
        print(EXAMPLE, end="")
        return
    if args.example_tenants:
        print(EXAMPLE_TENANTS, end="")
        return
    if args.example_defrag:
        print(EXAMPLE_DEFRAG, end="")
        return
    if args.example_autoscale:
        print(EXAMPLE_AUTOSCALE, end="")
        return
    if args.example_serving:
        print(EXAMPLE_SERVING, end="")
        return
    if args.example_fleet_day:
        print(EXAMPLE_FLEET_DAY, end="")
        return
    if args.example_topology:
        print(EXAMPLE_TOPOLOGY, end="")
        return
    if not args.scenario and not args.defrag:
        ap.error("scenario file required (or --example / --defrag)")
    if args.drain and not args.defrag:
        ap.error("--drain requires --defrag SRC")
    # Runnable from anywhere without pip-installing the package.
    import os
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if args.defrag:
        import urllib.request
        if args.defrag.startswith(("http://", "https://")):
            with urllib.request.urlopen(
                    f"{args.defrag}/tpushare-scheduler/inspect",
                    timeout=10) as resp:
                inspect_doc = json.loads(resp.read())
        else:
            with open(args.defrag) as f:
                inspect_doc = json.load(f)
        report = defrag(inspect_doc, drain=args.drain)
        if args.as_json:
            print(json.dumps(report))
        else:
            _print_defrag(report)
        return
    scenario = load_scenario(args.scenario)
    report = simulate(scenario, seed=args.seed)
    if scenario.get("topology_compare"):
        # The same scenario replayed with the slice placer DISABLED
        # (TPUSHARE_TOPOLOGY=off, exactly the production kill switch):
        # the report then carries BOTH placements' coordinates and
        # predicted step times, so the placer's win is readable from
        # one run of the tool (docs/topology.md).
        saved = os.environ.get("TPUSHARE_TOPOLOGY")
        os.environ["TPUSHARE_TOPOLOGY"] = "off"
        try:
            blind = simulate(scenario, seed=args.seed)
        finally:
            if saved is None:
                os.environ.pop("TPUSHARE_TOPOLOGY", None)
            else:
                os.environ["TPUSHARE_TOPOLOGY"] = saved
        report["topology_blind"] = blind.get("topology", [])
    if args.as_json:
        print(json.dumps(report))
    else:
        _print_human(report)


def _print_defrag(report: dict) -> None:
    if report.get("error"):
        print(f"error: {report['error']}", file=sys.stderr)
        raise SystemExit(2)
    gain = report["gain_whole_chips"]
    if report.get("drained_node"):
        print(f"drain advisory for node {report['drained_node']}:")
        blockers = report.get("blocking_gangs", [])
        if blockers:
            print(f"  BLOCKED: gang member(s) live on the node — the "
                  f"group must be torn down whole before draining: "
                  f"{', '.join(blockers)}")
        if report["unplaced"]:
            print(f"  BLOCKED: {len(report['unplaced'])} pod(s) have "
                  f"nowhere to go and will sit Pending: "
                  f"{', '.join(report['unplaced'])}")
        if not blockers and not report["unplaced"]:
            print("  safe: every movable resident fits the remaining "
                  "fleet")
        for m in report["moves"]:
            print(f"    {m['pod']}: {m['from']} -> {m['to']}")
        return
    print(f"defrag advisory over {report['pods']} resident pod(s):")
    print(f"  free whole chips: {report['current_free_whole_chips']} now "
          f"-> {report['repacked_free_whole_chips']} after re-pack "
          f"({'+' if gain >= 0 else ''}{gain})")
    if not report["moves"]:
        print("  already optimally packed — no moves would help")
    else:
        print(f"  {len(report['moves'])} move(s) would achieve it "
              "(delete these pods and let their owners re-create them):")
        for m in report["moves"]:
            print(f"    {m['pod']}: {m['from']} -> {m['to']}")
    if report["pinned"]:
        print(f"  pinned (never moved): {len(report['pinned'])} pod(s) — "
              "gang members and residents of cordoned/tainted nodes; "
              "the re-pack packed around them")
    if report["unplaced"]:
        print(f"  WARNING: {len(report['unplaced'])} pod(s) did not fit "
              f"the re-pack model: {', '.join(report['unplaced'])} — "
              "advisory is unsound for them")


if __name__ == "__main__":
    main()
