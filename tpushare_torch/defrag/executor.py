"""Budgeted defrag executor: the controller's rebalance loop.

The port's copy of ``tpushare/defrag/executor.py``.

Dry-run by default. ``TPUSHARE_DEFRAG_MODE`` selects the posture:

* ``off``     — no planning, no ticking (the frag index still serves
  `/metrics` and `/debug/defrag` on demand);
* ``dry-run`` — (default) plan every interval, publish the plan to the
  flight recorder / `/debug/defrag` / metrics, evict NOTHING;
* ``active``  — execute plans under hard budgets.

Safety rails, in order of authority:

1. **Leader gate** — only the lease holder plans or evicts; N replicas
   rebalancing independently would fight each other.
2. **SLO abort** — before the plan and before EVERY eviction, the SLO
   engine is consulted; a burning objective aborts the whole remaining
   plan (``tpushare_defrag_plans_aborted_total{reason="slo-burn"}``).
   Defrag exists to *serve* the pod-journey SLOs; it must never worsen
   them while they are already hurting.
3. **Eviction budgets** — every eviction flows through the shared
   :class:`tpushare_torch.k8s.eviction.EvictionBudget` (max concurrent,
   per-node cooldown, global moves/hour). Exhausting the hourly budget
   aborts the remaining plan (``reason="budget"``); a node still in
   cooldown only defers its move.

Environment knobs (all optional):

* ``TPUSHARE_DEFRAG_MODE``            — off | dry-run | active
* ``TPUSHARE_DEFRAG_INTERVAL_S``      — seconds between ticks (60)
* ``TPUSHARE_DEFRAG_MAX_MOVES``       — moves per plan (8)
* ``TPUSHARE_DEFRAG_MOVES_PER_HOUR``  — global eviction budget (20)
* ``TPUSHARE_DEFRAG_NODE_COOLDOWN_S`` — per-node eviction spacing (300)
* ``TPUSHARE_DEFRAG_MAX_CONCURRENT``  — evictions in flight (2)
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Callable

from tpushare_torch import obs, trace
from tpushare_torch.api.objects import Pod
from tpushare_torch.cache.cache import SchedulerCache
from tpushare_torch.defrag import frag
from tpushare_torch.defrag.planner import Move, Plan, RebalancePlanner
from tpushare_torch.k8s import eviction
from tpushare_torch.k8s.errors import ApiError
from tpushare_torch.quota.manager import QuotaManager
from tpushare_torch.utils import locks
from tpushare_torch.utils import pod as podutils

log = logging.getLogger(__name__)

MODES = ("off", "dry-run", "active")

#: Seconds between TPUShareDefragAborted Events per reason: the abort
#: counter carries the rate, the Event is the operator page.
ABORT_EVENT_INTERVAL_S = 600.0


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    # Config parsing, not telemetry: a malformed knob falls back to
    # the documented default.
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    # Same config-parse fallback.
    except ValueError:
        return default


class DefragExecutor:
    """Plans on the leader every ``interval_s``; executes when active."""

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
        #: () -> list[Pod]: the informer's pod store (pending-pod scan).
        self.pod_lister = pod_lister or (lambda: [])
        self._is_leader = is_leader or (lambda: True)
        #: () -> [burning SLO names]; default reads the live SLO engine.
        self._burning_fn = burning_fn or self._engine_burning
        raw_mode = (mode if mode is not None
                    else os.environ.get("TPUSHARE_DEFRAG_MODE", "dry-run"))
        #: Unrecognized values degrade to the SAFE posture (dry-run
        #: observes and proposes but can never evict).
        self.mode = raw_mode if raw_mode in MODES else "dry-run"
        self.interval_s = (interval_s if interval_s is not None
                           else _env_float("TPUSHARE_DEFRAG_INTERVAL_S",
                                           60.0))
        self.planner = RebalancePlanner(
            cache, quota=quota,
            max_moves=_env_int("TPUSHARE_DEFRAG_MAX_MOVES", 8))
        self.budget = budget or eviction.EvictionBudget(
            max_concurrent=_env_int("TPUSHARE_DEFRAG_MAX_CONCURRENT", 2),
            node_cooldown_s=_env_float("TPUSHARE_DEFRAG_NODE_COOLDOWN_S",
                                       300.0),
            per_hour=_env_int("TPUSHARE_DEFRAG_MOVES_PER_HOUR", 20),
            now=now)
        #: The filter verb's DemandTracker, wired post-construction by
        #: build_stack (the predicate is built after the controller);
        #: None = fall back to the informer pending-pod scan alone.
        self.demand: Any = None
        self._now = now
        self._lock = locks.TracingRLock("defrag/executor")
        self._last_plan: Plan | None = None
        self._ticks = 0
        #: abort reason -> monotonic stamp of its last Event.
        self._abort_event_at: dict[str, float] = locks.guarded_dict(
            self._lock, "DefragExecutor._abort_event_at")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def set_demand(self, demand: Any) -> None:
        self.demand = demand

    # -- lifecycle ------------------------------------------------------- #

    def start(self) -> None:
        """Run the tick loop on a daemon thread (no-op when off)."""
        if self.mode == "off" or self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop,
                                        name="tpushare-defrag",
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
            except Exception:  # noqa: BLE001 - the loop must survive
                log.exception("defrag tick failed")

    # -- inputs ---------------------------------------------------------- #

    def pending_pods(self) -> list[Pod]:
        """TPU pods currently waiting for a placement: unbound,
        un-assumed, alive. These are the demand the planner tries to
        unblock (a defrag that moves pods nobody is waiting on is churn,
        not repair)."""
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

    def _shapes(self) -> list[frag.Shape]:
        """Demand shapes for the frag index: the DemandTracker's
        unplaceable entries when wired (pods failing the filter
        everywhere — the sharpest stranding signal), else the pending
        scan."""
        if self.demand is not None:
            shapes = self.demand.shapes()
            if shapes:
                return shapes
        return sorted({
            (podutils.get_hbm_from_pod_resource(p),
             podutils.get_chips_from_pod_resource(p))
            for p in self.pending_pods()})

    def frag_snapshot(self) -> dict:
        """The cluster fragmentation report (frag.py math over the live
        ledger) — served by `/metrics` and `/debug/defrag`."""
        return frag.cluster_report(self.cache.sharing_node_infos(),
                                   self._shapes())

    def _engine_burning(self) -> list[str]:
        from tpushare_torch import slo
        try:
            return [row["slo"] for row in slo.engine().evaluate()
                    if row.get("burning")]
        except Exception:  # noqa: BLE001 - a broken SLO read must not
            # crash the loop, but it must VETO eviction (fail safe) and
            # count as a lost observation.
            slo.engine().drops.inc()
            return ["slo-engine-unreadable"]

    # -- the tick --------------------------------------------------------- #

    def tick(self) -> dict | None:
        """One plan(+execute) pass; returns the plan document or None.
        Leader-gated: follower replicas neither plan nor evict."""
        if self.mode == "off" or not self._is_leader():
            return None
        with self._lock:
            self._ticks += 1
        plan = self.build_plan()
        if plan is None:
            return None
        if self.mode == "dry-run":
            plan.status = "dry-run"
            for move in plan.moves:
                move.status = "dry-run"
                self._count_move("dry-run")
            log.info("defrag dry-run: %d move(s) would unblock %s "
                     "(plan %s)", len(plan.moves), plan.unblocks,
                     plan.plan_id)
            return plan.to_json()
        self.execute(plan)
        return plan.to_json()

    def build_plan(self) -> Plan | None:
        """Author (and publish) a plan for the current pending set.
        Runs even with NOTHING pending: an idle fleet is exactly when a
        fragmented slice-shape gang's ring is cheapest to repair, and
        the planner's own no-work pre-check keeps the empty-pending
        tick O(pods), not O(fleet-clone)."""
        pending = self.pending_pods()
        plan = self.planner.plan(pending)
        if plan is not None:
            with self._lock:
                self._last_plan = plan
            obs.mark("defrag-plan",
                     f"plan {plan.plan_id}: {len(plan.moves)} move(s), "
                     f"unblocks {', '.join(plan.unblocks) or 'n/a'}",
                     plan=plan.plan_id, moves=len(plan.moves))
        return plan

    def execute(self, plan: Plan) -> None:
        """Evict the plan's victims under the budgets; abort the whole
        remainder the moment an SLO burns."""
        plan.status = "executing"
        for i, move in enumerate(plan.moves):
            burning = self._burning_fn()
            if burning:
                self._abort(plan, plan.moves[i:], "slo-burn",
                            f"SLO(s) burning: {', '.join(burning)}")
                return
            status = self._evict(move)
            if status == eviction.EVICTED:
                move.status = "evicted"
                self._count_move("evicted")
                self._record_move(move, plan, "defrag-moved")
                self._emit_move_event(move, plan)
            elif status == eviction.GONE:
                move.status = "gone"
                self._count_move("gone")
            elif status == eviction.BLOCKED:
                move.status = "deferred"
                move.detail = "PodDisruptionBudget blocked the eviction"
                self._count_move("deferred")
                self._record_move(move, plan, "defrag-deferred")
            elif status == eviction.DENIED_PREFIX + \
                    eviction.REASON_NODE_COOLDOWN:
                move.status = "deferred"
                move.detail = "node in post-eviction cooldown"
                self._count_move("deferred")
            elif status.startswith(eviction.DENIED_PREFIX):
                # concurrent / moves-per-hour: the GLOBAL budget is
                # spent — nothing later in the plan can proceed either.
                self._abort(plan, plan.moves[i:], "budget",
                            f"eviction budget exhausted ({status})")
                return
            else:  # "failed" — counted (and detailed) inside _evict
                move.status = "failed"
                self._record_move(move, plan, "defrag-failed",
                                  error=move.detail)
        plan.status = "executed"

    def _evict(self, move: Move) -> str:
        try:
            return eviction.evict_with_retry(
                self.client, move.namespace, move.name,
                budget=self.budget, node=move.from_node)
        # Counted: _count_move below increments
        # tpushare_defrag_moves_total{outcome="failed"} via safe_inc.
        except ApiError as e:
            log.warning("defrag eviction of %s failed (%s)",
                        move.key(), e)
            move.detail = str(e)
            self._count_move("failed")
            return "failed"

    def _abort(self, plan: Plan, remaining: list[Move], reason: str,
               detail: str) -> None:
        plan.status = "aborted"
        plan.abort_reason = reason
        for move in remaining:
            move.status = "aborted"
            move.detail = detail
            self._count_move("aborted")
            self._record_move(move, plan, "defrag-aborted", error=detail)
        try:
            from tpushare_torch.routes import metrics
            metrics.safe_inc(
                metrics.DEFRAG_PLANS_ABORTED.labels(reason=reason))
        except Exception:  # noqa: BLE001 - counting must not break abort
            trace.recorder().drops.inc()
        log.warning("defrag plan %s ABORTED (%s): %s — %d move(s) "
                    "cancelled", plan.plan_id, reason, detail,
                    len(remaining))
        obs.mark("defrag-abort",
                 f"plan {plan.plan_id} aborted ({reason}): {detail}",
                 plan=plan.plan_id, reason=reason,
                 cancelled=len(remaining))
        self._emit_abort_event(plan, remaining, reason, detail)

    # -- telemetry -------------------------------------------------------- #

    @staticmethod
    def _count_move(outcome: str) -> None:
        try:
            from tpushare_torch.routes import metrics
            metrics.safe_inc(metrics.DEFRAG_MOVES.labels(outcome=outcome))
        except Exception:  # noqa: BLE001 - counting must not break moves
            trace.recorder().drops.inc()

    @staticmethod
    def _record_move(move: Move, plan: Plan, outcome: str,
                     error: str = "") -> None:
        """Executed/aborted moves land in the flight recorder as
        ``defrag:move`` decisions, like every other placement event."""
        try:
            with trace.phase("defrag:move", move.namespace, move.name,
                             move.uid) as dec:
                # Chain to the plan decision when it recorded one, else
                # straight to the bind that placed the pod — either way
                # the ancestor walk reaches the original placement.
                trace.set_parent(move.trace_id or move.parent_id)
                trace.note("planId", plan.plan_id)
                trace.note("from", move.from_node)
                trace.note("to", move.to_node)
                trace.complete(dec, outcome, node=move.to_node,
                               error=error)
        except Exception:  # noqa: BLE001 - telemetry must not move pods
            trace.recorder().drops.inc()

    def _emit_move_event(self, move: Move, plan: Plan) -> None:
        try:
            from tpushare_torch.k8s import events
            pod = Pod({"metadata": {"name": move.name,
                                    "namespace": move.namespace,
                                    "uid": move.uid}})
            events.record(
                self.client, pod, events.REASON_DEFRAG_MOVE,
                f"defrag: evicted from {move.from_node} to consolidate "
                f"stranded HBM (planned destination {move.to_node}; "
                f"plan {plan.plan_id}; unblocks "
                f"{', '.join(plan.unblocks) or 'n/a'})",
                trace_id=move.trace_id)
        except Exception:  # noqa: BLE001 - events must not break moves
            from tpushare_torch.routes import metrics
            metrics.safe_inc(metrics.EVENTS_DROPPED)

    def _emit_abort_event(self, plan: Plan, remaining: list[Move],
                          reason: str, detail: str) -> None:
        """Rate-limited Warning on the first cancelled move's pod —
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
            move = remaining[0]
            pod = Pod({"metadata": {"name": move.name,
                                    "namespace": move.namespace,
                                    "uid": move.uid}})
            events.record(
                self.client, pod, events.REASON_DEFRAG_ABORTED,
                f"defrag plan {plan.plan_id} aborted ({reason}): "
                f"{detail}; {len(remaining)} move(s) cancelled "
                "(docs/defrag.md runbook)", event_type="Warning",
                trace_id=move.trace_id)
        except Exception:  # noqa: BLE001 - events must not break aborts
            from tpushare_torch.routes import metrics
            metrics.safe_inc(metrics.EVENTS_DROPPED)

    # -- surfaces --------------------------------------------------------- #

    def status(self) -> dict:
        """The ``GET /debug/defrag`` document."""
        with self._lock:
            plan = self._last_plan
            ticks = self._ticks
        return {
            "mode": self.mode,
            "intervalSeconds": self.interval_s,
            "maxMovesPerPlan": self.planner.max_moves,
            "ticks": ticks,
            "budget": self.budget.snapshot(),
            "frag": self.frag_snapshot(),
            "lastPlan": plan.to_json() if plan is not None else None,
        }
