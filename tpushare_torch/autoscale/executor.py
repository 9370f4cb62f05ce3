"""Budgeted fleet autoscaler: the controller's capacity loop.

The port's copy of ``tpushare/autoscale/executor.py``.

Dry-run by default. ``TPUSHARE_AUTOSCALE`` selects the posture:

* ``off``     — no planning, no ticking;
* ``dry-run`` — (default) decide every interval, publish the decision
  to `/debug/autoscale` / metrics / the obs timeline, change NOTHING;
* ``active``  — provision and drain under hard budgets.

Scale-up consumes two first-class demand sources: the filter verb's
:class:`DemandTracker` (pods rejected on every node — shapes plus how
long their oldest pod has waited) and the serving router's
``scaleout_spec()`` (queue pressure). Provisioning is the LAST resort:
a shape that already fits a schedulable node just needs a retry, and a
shape the defrag planner can unblock by moving residents costs moves,
not node-hours — only demand that survives both checks buys a node
(the defrag-first rule, docs/autoscale.md). New nodes prefer completing
a contiguous ICI block (:mod:`tpushare_torch.autoscale.provision`).

Scale-down is defrag's dual: when demand has been quiet for the down
delay, the most strandable node (frag index score; empty nodes first)
is cordoned and drained through the SAME machinery defrag evicts with
— ``movable()`` eligibility (never a checkpoint in flight, never a pod
inside its tenant's quota guarantee), the shared
:class:`EvictionBudget`, and a per-eviction SLO-burn check that aborts
(and uncordons) the drain. The node is deleted only once its ledger is
empty.

Safety rails, in order of authority:

1. **Leader gate** — only the lease holder scales; N replicas sizing
   the fleet independently would flap it.
2. **SLO abort** — a burning objective aborts the drain and returns
   the node to service (``autoscale-abort`` marker); scale-up is never
   SLO-gated (adding capacity is how a burning SLO heals).
3. **Eviction budgets** — drain evictions flow through the shared
   :class:`tpushare_torch.k8s.eviction.EvictionBudget`. Node cooldown defers
   a victim; an exhausted global budget pauses the drain until the
   budget refills (the node STAYS cordoned — uncordon/recordon flapping
   would be worse than a slow drain).
4. **Hysteresis + cooldown** — demand must age past the up delay
   before it buys a node; the fleet must be demand-free past the down
   delay before it loses one; consecutive actions are spaced by the
   cooldown; min/max fleet bounds are hard.

Environment knobs (all optional):

* ``TPUSHARE_AUTOSCALE``              — off | dry-run | active
* ``TPUSHARE_AUTOSCALE_INTERVAL_S``   — seconds between ticks (60)
* ``TPUSHARE_AUTOSCALE_MIN_NODES``    — floor, never drained below (1)
* ``TPUSHARE_AUTOSCALE_MAX_NODES``    — ceiling, never grown past (64)
* ``TPUSHARE_AUTOSCALE_UP_DELAY_S``   — demand age before scale-up (30)
* ``TPUSHARE_AUTOSCALE_DOWN_DELAY_S`` — quiet time before scale-down (300)
* ``TPUSHARE_AUTOSCALE_COOLDOWN_S``   — spacing between actions (120)
"""

from __future__ import annotations

import copy
import logging
import os
import threading
import time
from typing import Any, Callable

from tpushare_torch import obs, trace
from tpushare_torch.api.objects import Node, Pod
from tpushare_torch.autoscale import provision
from tpushare_torch.cache.cache import SchedulerCache
from tpushare_torch.defrag import frag
from tpushare_torch.defrag.executor import _env_float, _env_int
from tpushare_torch.defrag.planner import RebalancePlanner, WhatIf
from tpushare_torch.k8s import builders, commit, eviction
from tpushare_torch.k8s.errors import ApiError
from tpushare_torch.quota.manager import QuotaManager
from tpushare_torch.utils import const, locks
from tpushare_torch.utils import node as nodeutils
from tpushare_torch.utils import pod as podutils

log = logging.getLogger(__name__)

MODES = ("off", "dry-run", "active")

#: Seconds between TPUShareAutoscaleAborted Events per reason: the
#: abort counter carries the rate, the Event is the operator page.
ABORT_EVENT_INTERVAL_S = 600.0

#: vet engine-5 state machine (docs/vet.md): a successful cordon
#: (``_set_cordon(name, True)``) takes a node out of service; until
#: the drain record is published (``self._draining = ...``, the
#: ``transfer`` — from there the tick loop owns the uncordon-or-
#: delete), every raising path must uncordon (``_set_cordon(name,
#: False)``) or the node is stranded unschedulable with no drain
#: driving it. ``_set_cordon`` reports failure as False and swallows
#: its own ApiErrors (``can_raise: false``); the True/False literal
#: pins acquire vs release.
PROTOCOLS = [
    {
        "protocol": "drain-cordon",
        "acquire": [
            {"call": "_set_cordon", "recv": ["self"],
             "args": {"1": "True"}, "truthy": "acquired",
             "can_raise": False},
        ],
        "release": [
            {"call": "_set_cordon", "recv": ["self"],
             "args": {"1": "False"}},
            {"call": "delete_node", "recv": ["self.client"]},
        ],
        "transfer": [
            {"store": "self._draining"},
        ],
        "doc": "Autoscale drain cordons: an acquired cordon is owned "
               "by the published drain record or rolled back.",
    },
]


class AutoscaleExecutor:
    """Decides on the leader every ``interval_s``; acts when active."""

    def __init__(self, cache: SchedulerCache, client: Any,
                 quota: QuotaManager | None = None,
                 pod_lister: Callable[[], list[Pod]] | None = None,
                 is_leader: Callable[[], bool] | None = None,
                 burning_fn: Callable[[], list[str]] | None = None,
                 mode: str | None = None,
                 interval_s: float | None = None,
                 budget: eviction.EvictionBudget | None = None,
                 now: Callable[[], float] = time.monotonic) -> None:
        self.cache = cache
        self.client = client
        self.quota = quota
        #: () -> list[Pod]: the informer's pod store (pending-pod scan
        #: for the defrag-first check).
        self.pod_lister = pod_lister or (lambda: [])
        self._is_leader = is_leader or (lambda: True)
        #: () -> [burning SLO names]; default reads the live SLO engine.
        self._burning_fn = burning_fn or self._engine_burning
        raw_mode = (mode if mode is not None
                    else os.environ.get("TPUSHARE_AUTOSCALE", "dry-run"))
        #: Unrecognized values degrade to the SAFE posture (dry-run
        #: observes and proposes but can never change the fleet).
        self.mode = raw_mode if raw_mode in MODES else "dry-run"
        self.interval_s = (interval_s if interval_s is not None
                           else _env_float("TPUSHARE_AUTOSCALE_INTERVAL_S",
                                           60.0))
        self.min_nodes = _env_int("TPUSHARE_AUTOSCALE_MIN_NODES", 1)
        self.max_nodes = _env_int("TPUSHARE_AUTOSCALE_MAX_NODES", 64)
        self.up_delay_s = _env_float("TPUSHARE_AUTOSCALE_UP_DELAY_S", 30.0)
        self.down_delay_s = _env_float("TPUSHARE_AUTOSCALE_DOWN_DELAY_S",
                                       300.0)
        self.cooldown_s = _env_float("TPUSHARE_AUTOSCALE_COOLDOWN_S", 120.0)
        #: Drain moves replay defrag's eligibility gates verbatim.
        self.planner = RebalancePlanner(cache, quota=quota)
        #: SHARED with defrag when the controller wires one budget for
        #: both: autoscale drains and defrag moves disrupt the same
        #: pods, so they must spend the same hourly allowance.
        self.budget = budget or eviction.EvictionBudget(
            max_concurrent=_env_int("TPUSHARE_DEFRAG_MAX_CONCURRENT", 2),
            node_cooldown_s=_env_float("TPUSHARE_DEFRAG_NODE_COOLDOWN_S",
                                       300.0),
            per_hour=_env_int("TPUSHARE_DEFRAG_MOVES_PER_HOUR", 20),
            now=now)
        #: The filter verb's DemandTracker, wired post-construction by
        #: build_stack (the predicate is built after the controller).
        self.demand: Any = None
        #: The serving router, wired by serve_stack when one exists.
        self.router: Any = None
        self._now = now
        self._lock = locks.TracingRLock("autoscale/executor")
        self._ticks = 0
        self._last_action_at = float("-inf")
        #: Monotonic stamp of the last tick that SAW pending demand —
        #: the down-delay hysteresis clock.
        self._demand_seen_at = float("-inf")
        #: Last non-empty demand shapes: what scale-down strandability
        #: is measured against once the queue itself has gone quiet.
        self._recent_shapes: list[tuple[int, int]] = []
        #: In-flight drain: {"node", "since", ...} | None. A drain can
        #: span many ticks (budgets, immovable residents).
        self._draining: dict | None = None
        self._last_decision: dict | None = None
        #: abort reason -> monotonic stamp of its last Event.
        self._abort_event_at: dict[str, float] = locks.guarded_dict(
            self._lock, "AutoscaleExecutor._abort_event_at")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def set_demand(self, demand: Any) -> None:
        self.demand = demand

    def set_router(self, router: Any) -> None:
        self.router = router

    # -- lifecycle ------------------------------------------------------- #

    def start(self) -> None:
        """Run the tick loop on a daemon thread (no-op when off)."""
        if self.mode == "off" or self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop,
                                        name="tpushare-autoscale",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        # First wait is a FULL interval: a controller that lives for
        # milliseconds (most tests) must never run an implicit tick.
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            # Control-flow failure, not telemetry loss: the stack
            # trace below IS the record.
            # vet: ignore[swallowed-telemetry-error] - control-flow failure; log.exception IS the record
            except Exception:  # noqa: BLE001 - the loop must survive
                log.exception("autoscale tick failed")

    # -- inputs ---------------------------------------------------------- #

    def pending_pods(self) -> list[Pod]:
        """TPU pods waiting for a placement (unbound, un-assumed,
        alive) — the defrag-first check's planner input."""
        out = []
        for pod in self.pod_lister():
            if not (podutils.is_tpu_sharing_pod(pod)
                    or podutils.is_tpu_chip_pod(pod)):
                continue
            if pod.node_name or podutils.is_assumed(pod):
                continue
            if podutils.is_complete_pod(pod):
                continue
            out.append(pod)
        return out

    def _engine_burning(self) -> list[str]:
        from tpushare_torch import slo
        try:
            return [row["slo"] for row in slo.engine().evaluate()
                    if row.get("burning")]
        except Exception:  # noqa: BLE001 - a broken SLO read must not
            # crash the loop, but it must VETO the drain (fail safe)
            # and count as a lost observation.
            slo.engine().drops.inc()
            return ["slo-engine-unreadable"]

    def _demand_shapes(self) -> tuple[list[tuple[int, int]], dict]:
        """(shapes aged past the up delay, detail doc). Two sources:
        the DemandTracker (aged per shape — transient filter blips
        must not buy nodes) and the router's scale-out want (already
        cooldown-gated inside the router, so taken at face value)."""
        aged: list[tuple[int, int]] = []
        detail: dict = {"tracker": {}, "router": None}
        if self.demand is not None:
            self.demand.snapshot()  # prune before reading ages
            ages = self.demand.oldest_age_by_shape()
            detail["tracker"] = {
                f"{hbm}GiBx{chips}c": round(age, 1)
                for (hbm, chips), age in sorted(ages.items())}
            aged = [shape for shape, age in ages.items()
                    if age >= self.up_delay_s]
            with self._lock:
                if ages:
                    self._demand_seen_at = self._now()
                    self._recent_shapes = sorted(ages)
        if self.router is not None:
            scale = self.router.snapshot().get("scaleOut") or {}
            if scale.get("wanted"):
                spec = scale.get("spec") or {}
                shape = (int(spec.get("hbmGiB", 0) or 0), 0)
                detail["router"] = {"spec": spec,
                                    "shape": list(shape)}
                if shape[0] > 0 and shape not in aged:
                    aged.append(shape)
                with self._lock:
                    self._demand_seen_at = self._now()
        # Largest demand first: the shape hardest to place decides the
        # node template.
        aged.sort(key=lambda s: -(s[0] + s[1] * 1000))
        return aged, detail

    def _schedulable_infos(self) -> list:
        """The sharing fleet MINUS cordoned hosts: capacity a pending
        pod could actually bind. The defrag-first fit check must not
        count a node mid-drain as available."""
        return [i for i in self.cache.sharing_node_infos()
                if nodeutils.is_schedulable(i.node)]

    @staticmethod
    def _shape_request(shape: tuple[int, int]) -> Pod:
        """A synthetic pod carrying ``shape`` — replayed through the
        REAL admission predicate by the what-if fit check."""
        hbm, chips = shape
        return Pod(builders.make_pod("autoscale-probe", hbm=hbm,
                                     chips=chips))

    def _residents(self, node_name: str) -> list[Pod]:
        """The pods resident on ``node_name`` per the live ledger,
        deterministically ordered."""
        info = self.cache.get_node_info(node_name)
        if info is None:
            return []
        by_uid: dict[str, Pod] = {}
        for chip in info.chips.values():
            for pod in chip.snapshot_pods():
                by_uid.setdefault(pod.uid, pod)
        return sorted(by_uid.values(), key=lambda p: p.key())

    # -- the tick --------------------------------------------------------- #

    def tick(self) -> dict | None:
        """One decide(+act) pass; returns the decision document or
        None. Leader-gated: follower replicas neither decide nor act."""
        if self.mode == "off" or not self._is_leader():
            return None
        with self._lock:
            self._ticks += 1
            draining = self._draining
        shapes, demand_detail = self._demand_shapes()
        if draining is not None:
            # Finish (or abort) the drain in flight before anything
            # else — a half-drained node serves nobody.
            decision = self._continue_drain(draining)
        elif shapes:
            decision = self._scale_up(shapes, demand_detail)
        else:
            decision = self._consider_scale_down()
        if decision is not None:
            decision["demand"] = demand_detail
            with self._lock:
                self._last_decision = decision
        return decision

    # -- scale-up --------------------------------------------------------- #

    def _scale_up(self, shapes: list[tuple[int, int]],
                  demand_detail: dict) -> dict:
        now = self._now()
        with self._lock:
            since_action = now - self._last_action_at
        if since_action < self.cooldown_s:
            return self._hold("cooldown",
                              f"{self.cooldown_s - since_action:.0f}s of "
                              "action cooldown remaining")
        infos = self._schedulable_infos()
        fleet = len(self.cache.sharing_node_infos())
        if fleet >= self.max_nodes:
            return self._hold("max-nodes",
                              f"fleet at ceiling ({fleet} >= "
                              f"{self.max_nodes})")
        # Defrag-first, check 1: does the shape already fit a
        # schedulable node? Then the demand just needs a retry (or the
        # pod is quota-parked) — provisioning would buy idle capacity.
        whatif = WhatIf(infos) if infos else None
        unserved = [s for s in shapes
                    if whatif is None
                    or not whatif.fits(self._shape_request(s))]
        if not unserved:
            return self._hold("capacity-exists",
                              "every demanded shape fits an existing "
                              "schedulable node")
        # Defrag-first, check 2: can moving residents create the shape?
        # Defrag moves cost evictions, not node-hours — if the planner
        # can unblock pending demand, let the defrag loop do it and
        # only provision for what remains.
        plan = self.planner.plan(self.pending_pods())
        if plan is not None and plan.unblocks:
            return self._hold(
                "defrag-first",
                f"defrag plan {plan.plan_id} unblocks "
                f"{len(plan.unblocks)} pending pod(s) with "
                f"{len(plan.moves)} move(s); not provisioning")
        shape = unserved[0]
        existing = frozenset(self.cache.node_table())
        doc, elect = provision.elect_template(
            self.cache.sharing_node_infos(), shape, existing)
        name = doc["metadata"]["name"]
        decision = {
            "action": "scale-up",
            "node": name,
            "shape": {"hbmGiB": shape[0], "chips": shape[1]},
            "election": elect,
            "dryRun": self.mode == "dry-run",
        }
        if self.mode == "active":
            try:
                self.client.create_node(doc)
            # Counted: _count(failed) feeds
            # tpushare_autoscale_actions_total{action="failed"}.
            # vet: ignore[swallowed-telemetry-error] - counted by _count(failed) below
            except ApiError as e:
                log.warning("autoscale: create_node(%s) failed (%s)",
                            name, e)
                decision["error"] = str(e)
                self._count("failed")
                return decision
            with self._lock:
                self._last_action_at = now
        self._count("up" if self.mode == "active" else "dry-run")
        obs.mark("autoscale-up",
                 f"provisioned {name} for {shape[0]} GiB x "
                 f"{shape[1]} chip(s) ({elect['kind']})"
                 + (" [dry-run]" if self.mode == "dry-run" else ""),
                 node=name, template=elect["kind"],
                 hbm=shape[0], chips=shape[1])
        log.info("autoscale scale-up%s: %s (%s) for shape %s",
                 " dry-run" if self.mode == "dry-run" else "",
                 name, elect["kind"], shape)
        return decision

    def _hold(self, reason: str, detail: str) -> dict:
        self._count("hold")
        log.debug("autoscale hold (%s): %s", reason, detail)
        return {"action": "hold", "reason": reason, "detail": detail}

    # -- scale-down ------------------------------------------------------- #

    def _consider_scale_down(self) -> dict | None:
        now = self._now()
        with self._lock:
            quiet = now - self._demand_seen_at
            since_action = now - self._last_action_at
            shapes = list(self._recent_shapes)
        if quiet < self.down_delay_s:
            return None  # demand too recent: the trough isn't proven
        if since_action < self.cooldown_s:
            return None
        fleet = self.cache.sharing_node_infos()
        if len(fleet) <= self.min_nodes:
            return None
        name, elect = self._elect_drain(fleet, shapes)
        if name is None:
            return None
        decision = {
            "action": "scale-down",
            "node": name,
            "phase": "cordon",
            "election": elect,
            "dryRun": self.mode == "dry-run",
        }
        if self.mode == "active":
            if not self._set_cordon(name, True):
                decision["error"] = "cordon failed"
                self._count("failed")
                return decision
        draining = {"node": name, "since": now, "election": elect,
                    "dryRun": self.mode == "dry-run"}
        with self._lock:
            self._draining = draining
            self._last_action_at = now
        self._count("down" if self.mode == "active" else "dry-run")
        obs.mark("autoscale-down",
                 f"cordoned {name} for drain "
                 f"({elect.get('residents', 0)} resident pod(s))"
                 + (" [dry-run]" if self.mode == "dry-run" else ""),
                 node=name, phase="cordon",
                 residents=elect.get("residents", 0))
        log.info("autoscale scale-down%s: cordoned %s (%s)",
                 " dry-run" if self.mode == "dry-run" else "",
                 name, elect)
        if self.mode == "active":
            return self._continue_drain(draining) or decision
        # Dry-run drains complete instantly: nothing was cordoned, so
        # nothing holds the hypothetical node open.
        with self._lock:
            self._draining = None
        return decision

    def _elect_drain(self, fleet: list, shapes: list[tuple[int, int]],
                     ) -> tuple[str | None, dict]:
        """The most strandable DRAINABLE node: empty nodes first (zero
        disruption), then highest frag score against the recent demand
        shapes; a node is drainable only when every resident passes
        defrag's ``movable()`` gate AND re-places elsewhere in a
        what-if — guarantee-protected pods veto the whole node."""
        candidates: list[tuple[tuple, str, dict]] = []
        for info in fleet:
            if not nodeutils.is_schedulable(info.node):
                continue  # already cordoned (by us or an operator)
            residents = self._residents(info.name)
            report = frag.node_report(info, shapes)
            ok, why = self._drainable(info.name, residents)
            if not ok:
                continue
            elect = {"residents": len(residents),
                     "fragScore": report["score"],
                     "freeHbmGiB": report["freeHBM"]}
            # Rank: fewest bodies moved, most stranded capacity freed.
            candidates.append(((len(residents), -report["score"],
                                info.name), info.name, elect))
        if not candidates:
            return None, {}
        candidates.sort(key=lambda c: c[0])
        _, name, elect = candidates[0]
        return name, elect

    def _drainable(self, name: str,
                   residents: list[Pod]) -> tuple[bool, str]:
        if not residents:
            return True, ""
        for pod in residents:
            ok, why = self.planner.movable(pod)
            if not ok:
                return False, f"{pod.key()}: {why}"
        whatif = WhatIf(self._schedulable_infos())
        for pod in residents:
            whatif.remove(pod.uid)
        for pod in residents:
            req = RebalancePlanner._as_request(pod)
            if whatif.place(req, exclude=frozenset((name,))) is None:
                return False, f"{pod.key()}: no room elsewhere"
        return True, ""

    def _continue_drain(self, draining: dict) -> dict | None:
        """Advance the drain in flight: evict what the budgets allow,
        abort on SLO burn, delete the node once its ledger is empty."""
        name = draining["node"]
        decision: dict = {"action": "scale-down", "node": name,
                          "phase": "drain", "dryRun": False,
                          "evictions": []}
        residents = self._residents(name)
        if not residents:
            return self._finish_drain(name, decision)
        for pod in residents:
            burning = self._burning_fn()
            if burning:
                return self._abort_drain(
                    name, residents, "slo-burn",
                    f"SLO(s) burning: {', '.join(burning)}")
            ok, why = self.planner.movable(pod)
            if not ok:
                # A resident became immovable mid-drain (checkpoint
                # started, borrow revoked): wait it out, don't abort —
                # the cordon keeps new work off the node meanwhile.
                decision["evictions"].append(
                    {"pod": pod.key(), "status": "deferred",
                     "detail": why})
                continue
            status = self._evict(name, pod)
            self._record_evict(name, pod, status)
            if status == eviction.EVICTED:
                decision["evictions"].append(
                    {"pod": pod.key(), "status": "evicted"})
                self._count("evicted")
            elif status == eviction.GONE:
                decision["evictions"].append(
                    {"pod": pod.key(), "status": "gone"})
            elif status == eviction.BLOCKED:
                decision["evictions"].append(
                    {"pod": pod.key(), "status": "deferred",
                     "detail": "PodDisruptionBudget blocked the "
                               "eviction"})
            elif status.startswith(eviction.DENIED_PREFIX):
                # Node cooldown or exhausted global budget: PAUSE, not
                # abort — the cordon holds, the budget refills, and the
                # next tick resumes. Uncordoning here would re-admit
                # work we would only evict again.
                decision["evictions"].append(
                    {"pod": pod.key(), "status": "paused",
                     "detail": status})
                decision["detail"] = f"drain paused ({status})"
                return decision
            else:
                decision["evictions"].append(
                    {"pod": pod.key(), "status": "failed"})
        if not self._residents(name):
            return self._finish_drain(name, decision)
        decision["detail"] = (f"{len(self._residents(name))} resident "
                              "pod(s) remaining")
        return decision

    def _finish_drain(self, name: str, decision: dict) -> dict:
        decision["phase"] = "delete"
        if self.mode == "active":
            try:
                self.client.delete_node(name)
            # Counted: _count(failed) feeds
            # tpushare_autoscale_actions_total{action="failed"}.
            # vet: ignore[swallowed-telemetry-error] - counted by _count(failed) below
            except ApiError as e:
                log.warning("autoscale: delete_node(%s) failed (%s)",
                            name, e)
                decision["error"] = str(e)
                self._count("failed")
                return decision
        with self._lock:
            self._draining = None
            self._last_action_at = self._now()
        self._count("deleted")
        obs.mark("autoscale-down", f"drained and deleted {name}",
                 node=name, phase="delete")
        log.info("autoscale scale-down: deleted %s", name)
        return decision

    def _abort_drain(self, name: str, remaining: list[Pod],
                     reason: str, detail: str) -> dict:
        """Return the node to service: uncordon, forget the drain. The
        fleet stays oversized until the objectives recover — autoscale
        must never worsen an SLO that is already hurting."""
        if self.mode == "active":
            self._set_cordon(name, False)
        with self._lock:
            self._draining = None
        self._count("aborted")
        try:
            from tpushare_torch.routes import metrics
            metrics.safe_inc(
                metrics.AUTOSCALE_ABORTED.labels(reason=reason))
        except Exception:  # noqa: BLE001 - counting must not break abort
            trace.recorder().drops.inc()
        obs.mark("autoscale-abort",
                 f"drain of {name} aborted ({reason}): {detail}",
                 node=name, reason=reason)
        log.warning("autoscale drain of %s ABORTED (%s): %s — node "
                    "uncordoned", name, reason, detail)
        self._emit_abort_event(name, remaining, reason, detail)
        return {"action": "scale-down", "node": name, "phase": "abort",
                "reason": reason, "detail": detail, "dryRun": False}

    def _set_cordon(self, name: str, cordoned: bool) -> bool:
        """Flip ``spec.unschedulable`` on the live node object."""
        try:
            node = self.client.get_node(name)
            if node is None:
                return False
            raw = copy.deepcopy(node.raw)
            if cordoned:
                raw.setdefault("spec", {})["unschedulable"] = True
            else:
                raw.setdefault("spec", {}).pop("unschedulable", None)
            commit.committed_update_node(self.client, Node(raw))
            return True
        # Counted: the caller records the failed action via _count;
        # the log line carries the API detail.
        # vet: ignore[swallowed-telemetry-error] - counted by the caller's _count(failed)
        except ApiError as e:
            log.warning("autoscale: cordon(%s, %s) failed (%s)",
                        name, cordoned, e)
            return False

    def _evict(self, node: str, pod: Pod) -> str:
        try:
            return eviction.evict_with_retry(
                self.client, pod.namespace, pod.name,
                budget=self.budget, node=node)
        # Counted: _count(failed) feeds
        # tpushare_autoscale_actions_total{action="failed"}.
        # vet: ignore[swallowed-telemetry-error] - counted by _count(outcome=failed) below
        except ApiError as e:
            log.warning("autoscale drain eviction of %s failed (%s)",
                        pod.key(), e)
            self._count("failed")
            return "failed"

    # -- telemetry -------------------------------------------------------- #

    @staticmethod
    def _record_evict(node: str, pod: Pod, status: str) -> None:
        """Drain evictions land in the flight recorder as
        ``autoscale:evict`` decisions chained (via the pod's trace-id
        annotation) to the bind that placed the pod — so
        ``/debug/trace?id=`` answers 'why did my pod disappear' with
        the placement it undid (docs/observability.md §7)."""
        try:
            with trace.phase("autoscale:evict", pod.namespace,
                             pod.name, pod.uid) as dec:
                trace.set_parent(
                    pod.annotations.get(const.ANN_TRACE_ID, ""))
                trace.note("node", node)
                trace.complete(dec, f"drain-{status}", node=node)
        except Exception:  # noqa: BLE001 - telemetry must not drain
            trace.recorder().drops.inc()

    @staticmethod
    def _count(action: str) -> None:
        try:
            from tpushare_torch.routes import metrics
            metrics.safe_inc(
                metrics.AUTOSCALE_ACTIONS.labels(action=action))
        except Exception:  # noqa: BLE001 - counting must not break scaling
            trace.recorder().drops.inc()

    def _emit_abort_event(self, node: str, remaining: list[Pod],
                          reason: str, detail: str) -> None:
        """Rate-limited Warning on the first still-resident pod —
        aborts repeat every tick while an SLO burns, and one Event per
        window keeps kubectl-describe readable."""
        if not remaining:
            return
        now = self._now()
        with self._lock:
            due = (now - self._abort_event_at.get(reason, float("-inf"))
                   >= ABORT_EVENT_INTERVAL_S)
            if due:
                self._abort_event_at[reason] = now
        if not due:
            return
        try:
            from tpushare_torch.k8s import events
            events.record(
                self.client, remaining[0], events.REASON_AUTOSCALE_ABORTED,
                f"autoscale drain of {node} aborted ({reason}): {detail} "
                "(docs/autoscale.md runbook)", event_type="Warning")
        except Exception:  # noqa: BLE001 - events must not break aborts
            from tpushare_torch.routes import metrics
            metrics.safe_inc(metrics.EVENTS_DROPPED)

    # -- surfaces --------------------------------------------------------- #

    def fleet_snapshot(self) -> dict:
        """Fleet-size facts (also the ``tpushare_cluster_*`` gauges'
        source): node counts by state and total shareable capacity."""
        infos = self.cache.sharing_node_infos()
        cordoned = sum(1 for i in infos
                       if not nodeutils.is_schedulable(i.node))
        return {
            "nodes": len(infos),
            "ready": len(infos) - cordoned,
            "cordoned": cordoned,
            "capacityHbmGiB": sum(
                nodeutils.get_total_hbm(i.node) for i in infos),
        }

    def status(self) -> dict:
        """The ``GET /debug/autoscale`` document."""
        with self._lock:
            ticks = self._ticks
            draining = dict(self._draining) if self._draining else None
            decision = self._last_decision
            shapes = list(self._recent_shapes)
        if draining is not None:
            draining["residents"] = len(self._residents(draining["node"]))
            draining["forSeconds"] = round(
                self._now() - draining.pop("since"), 1)
        return {
            "mode": self.mode,
            "intervalSeconds": self.interval_s,
            "bounds": {"minNodes": self.min_nodes,
                       "maxNodes": self.max_nodes},
            "hysteresis": {"upDelaySeconds": self.up_delay_s,
                           "downDelaySeconds": self.down_delay_s,
                           "cooldownSeconds": self.cooldown_s},
            "ticks": ticks,
            "budget": self.budget.snapshot(),
            "fleet": self.fleet_snapshot(),
            "recentShapes": [list(s) for s in shapes],
            "draining": draining,
            "lastDecision": decision,
        }
