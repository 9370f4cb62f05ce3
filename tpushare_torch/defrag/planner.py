"""Rebalance planner: bounded move search over a what-if ledger.

The port's copy of ``tpushare/defrag/planner.py``.

A *move* is "evict pod P from node A; its owner recreates it and the
scheduler re-places it on node B" — proven, not hoped: before a move is
proposed, the victim is re-placed in a **what-if copy** of the chip
ledger by replaying the REAL admission predicate (``NodeInfo.assume``)
and the REAL bin-pack chip picker (``NodeInfo.pick_chips``), so the
plan only contains relocations the live filter/bind path would accept.

Invariants every plan honors (docs/defrag.md):

* **gang-atomic** — a committed gang member never moves alone: either
  every cluster-wide member of its group is proven re-placeable (and
  all of them are in the plan) or none moves. Evicting one member would
  trip the controller's gang reaper and restart the job anyway — the
  planner prices that truthfully by moving the whole group or not at
  all.
* **quota-safe** — with a quota table configured, only pods sitting
  wholly in *borrowed* territory (beyond their tenant's guarantee) are
  movable: defrag must never cut a tenant below what it is owed, even
  transiently during the evict→rebind window.
* **checkpoint-aware** — a pod with ``tpushare.io/checkpoint-in-flight``
  set is never moved: killing it mid-save loses the checkpoint AND the
  progress since the previous one.
* **budgeted** — at most ``max_moves`` per plan (gang members count
  individually), and at most ``MAX_VICTIMS_PER_CHIP`` victims cleared
  from any one chip (a chip needing mass eviction is not fragmentation,
  it is load).

The search itself is greedy: pending pods (largest demand first) that
fit nowhere in the what-if get a make-room attempt per candidate node;
the cheapest working victim set wins; the what-if absorbs the result so
later pending pods plan against the post-move world.
"""

from __future__ import annotations

import logging
import time
from typing import Any

from tpushare_torch import trace
from tpushare_torch.api.objects import Pod
from tpushare_torch.cache.cache import SchedulerCache
from tpushare_torch.cache.nodeinfo import AllocationError, NodeInfo
from tpushare_torch.quota.manager import QuotaManager
from tpushare_torch.topology.topology import Topology
from tpushare_torch.utils import const
from tpushare_torch.utils import pod as podutils

log = logging.getLogger(__name__)

#: Victims the planner may clear from one chip for one pending pod.
MAX_VICTIMS_PER_CHIP = 3

#: Candidate target nodes trial-cloned per pending pod. Each trial
#: deep-clones the what-if fleet, so this bounds a planner tick at
#: O(pending × MAX_TARGETS_TRIED × fleet) instead of O(pending × nodes
#: × fleet); candidates are sorted cheapest-first, so the first trial
#: almost always succeeds and later ones exist only as fallbacks.
MAX_TARGETS_TRIED = 4


class Move:
    """One planned relocation. ``status`` advances planned → (dry-run |
    evicted | deferred | aborted | failed | gone); each transition lands
    in the flight recorder under the pod's name with a ``defrag:``
    span."""

    __slots__ = ("namespace", "name", "uid", "from_node", "to_node",
                 "gang", "hbm", "chips", "status", "trace_id", "detail",
                 "parent_id")

    def __init__(self, pod: Pod, from_node: str, to_node: str) -> None:
        self.namespace = pod.namespace
        self.name = pod.name
        self.uid = pod.uid
        self.from_node = from_node
        self.to_node = to_node
        self.gang = pod.annotations.get(const.ANN_POD_GROUP, "")
        self.hbm, self.chips = QuotaManager.granted_demand(pod)
        self.status = "planned"
        self.trace_id = ""
        self.detail = ""
        #: Causal parent: the bind decision that placed this pod (its
        #: trace-id annotation) — the move's plan/execute decisions
        #: descend from it, so /debug/trace?id= resolves an eviction
        #: back to the placement it undid, even across a restart.
        self.parent_id = pod.annotations.get(const.ANN_TRACE_ID, "")

    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def to_json(self) -> dict:
        doc = {
            "pod": self.key(),
            "uid": self.uid,
            "from": self.from_node,
            "to": self.to_node,
            "status": self.status,
            "traceId": self.trace_id,
        }
        if self.gang:
            doc["gang"] = self.gang
        if self.hbm:
            doc["hbmGiB"] = self.hbm
        if self.chips:
            doc["wholeChips"] = self.chips
        if self.detail:
            doc["detail"] = self.detail
        return doc


class Plan:
    """A bounded set of moves plus the pending pods they unblock."""

    def __init__(self, moves: list[Move], unblocks: list[str]) -> None:
        self.plan_id = trace.new_trace_id()
        self.created_at = time.time()
        self.moves = moves
        self.unblocks = unblocks
        self.status = "planned"
        self.abort_reason = ""

    def to_json(self) -> dict:
        return {
            "id": self.plan_id,
            "createdAt": self.created_at,
            "status": self.status,
            **({"abortReason": self.abort_reason}
               if self.abort_reason else {}),
            "unblocks": list(self.unblocks),
            "moves": [m.to_json() for m in self.moves],
        }


class WhatIf:
    """A detached copy of the fleet's chip ledgers the planner mutates
    freely. Placement replays the real predicate + picker, so "fits"
    here means "the live filter/bind path would take it"."""

    def __init__(self, infos: list[NodeInfo]) -> None:
        self.nodes: dict[str, NodeInfo] = {
            i.name: i.whatif_clone() for i in infos}
        #: uid -> (node name, the pod document the ledger holds)
        self.located: dict[str, tuple[str, Pod]] = {}
        for name, info in self.nodes.items():
            for chip in info.chips.values():
                for pod in chip.snapshot_pods():
                    self.located.setdefault(pod.uid, (name, pod))

    def clone(self) -> "WhatIf":
        return WhatIf(list(self.nodes.values()))

    def remove(self, uid: str) -> None:
        entry = self.located.pop(uid, None)
        if entry is not None:
            node, pod = entry
            self.nodes[node].remove_pod(pod)

    def fits(self, pod: Pod) -> bool:
        return any(info.assume(pod)[0] for info in self.nodes.values())

    def place(self, pod: Pod,
              exclude: frozenset[str] = frozenset()) -> str | None:
        """Re-place ``pod`` with the real picker, tightest node first
        (the node left with the least free HBM — the cross-node binpack
        the prioritize verb implements). Returns the node, or None."""
        best: tuple[int, str, list[int]] | None = None
        for name in sorted(self.nodes):
            if name in exclude:
                continue
            info = self.nodes[name]
            ok, _ = info.assume(pod)
            if not ok:
                continue
            try:
                chips = info.pick_chips(pod)
            # Control flow, not telemetry: "no placement on this
            # node" just tries the next one.
            except AllocationError:
                continue
            leftover = sum(info.get_available_hbm().values())
            if best is None or leftover < best[0]:
                best = (leftover, name, chips)
        if best is None:
            return None
        _, name, chips = best
        info = self.nodes[name]
        if podutils.get_chips_from_pod_resource(pod) > 0:
            hbm_pod = sum(info.chips[c].total_hbm for c in chips)
        else:
            hbm_pod = podutils.get_hbm_from_pod_resource(pod)
        placed = podutils.updated_pod_annotation_spec(
            pod, chips, hbm_pod, info.chips[chips[0]].total_hbm,
            assume_time_ns=0)
        placed.spec["nodeName"] = name
        info.add_or_update_pod(placed)
        self.located[pod.uid] = (name, placed)
        return name


class _WhatIfTable:
    """Adapter giving :class:`tpushare_torch.topology.fleet.SlicePlacer` the
    ``node_table()`` face of a cache over a what-if's detached ledgers,
    so ring-repair elections replay the REAL election code against the
    planner's hypothetical world."""

    def __init__(self, nodes: dict[str, NodeInfo]) -> None:
        self._nodes = nodes

    def node_table(self) -> dict[str, NodeInfo]:
        return dict(self._nodes)


class RebalancePlanner:
    def __init__(self, cache: SchedulerCache,
                 quota: QuotaManager | None = None,
                 max_moves: int = 8) -> None:
        self.cache = cache
        self.quota = quota
        self.max_moves = max_moves

    # -- move eligibility ------------------------------------------------ #

    def movable(self, pod: Pod) -> tuple[bool, str]:
        """May this resident be relocated at all? (Gang atomicity is
        enforced separately — this is the per-pod gate.)"""
        if podutils.is_complete_pod(pod):
            return False, "complete"
        if not pod.node_name:
            return False, "unbound (gang reservation in flight)"
        if pod.annotations.get(const.ANN_CKPT_IN_FLIGHT, "").lower() in (
                "true", "1"):
            return False, "checkpoint in flight"
        if self.quota is not None:
            tenant = self.quota.tenant_of(pod)
            if (self.quota.configured(tenant)
                    and not self.quota.is_borrowed(pod)):
                # Inside guaranteed territory: evicting would cut the
                # tenant below what it is owed until the rebind lands.
                return False, f"inside tenant {tenant}'s quota guarantee"
        return True, ""

    def _gang_members(self, pod: Pod) -> list[Pod]:
        group, _ = podutils.get_pod_group(pod)
        if not group:
            return [pod]
        members = [m for m in self.cache.gang_members(pod.namespace, group)
                   if not podutils.is_complete_pod(m)]
        return members or [pod]

    # -- the search ------------------------------------------------------ #

    def plan(self, pending: list[Pod]) -> Plan | None:
        """Author a bounded move set that unblocks as much of ``pending``
        as it can, then spends any leftover budget repairing fragmented
        rings (:meth:`_ring_repairs`); None when no legal move helps.
        Defrag never moves pods for aesthetics alone — a ring repair is
        not aesthetics: a slice-shape gang running its collectives over
        multi-hop ICI pays the fragmentation on every training step, so
        a contiguity-restoring move scores above any pure packing move
        (which this planner simply never authors)."""
        infos = self.cache.sharing_node_infos()
        if not infos:
            return None
        if not pending and not self._has_fragmented_slice_gang(infos):
            # Nothing to unblock and no ring worth repairing: keep the
            # (default-on, every-interval) idle tick O(pods + ring
            # math over live node documents), not O(fleet-clone) —
            # a healthy contiguous gang must not cost a WhatIf per
            # tick forever.
            return None
        whatif = WhatIf(infos)
        #: The REAL residents. The unblock loop below hypothetically
        #: places pending pods into the what-if (so later pending pods
        #: plan against the post-move world) — the repair pass must
        #: never mistake those placements for bound gangs and author
        #: evictions for pods that are not actually running.
        residents = frozenset(whatif.located)
        moves: list[Move] = []
        unblocks: list[str] = []
        order = sorted(
            pending,
            key=lambda p: -(podutils.get_hbm_from_pod_resource(p)
                            + podutils.get_chips_from_pod_resource(p) * 1000))
        # Bound the scan: a huge pending backlog must not turn the
        # (default-on, every-interval) planner tick into a fleet-sized
        # search per pod — the move budget caps what a plan can repair
        # anyway, so scanning far past it only burns the controller.
        order = order[:max(self.max_moves, 1) * 4]
        for pod in order:
            if len(moves) >= self.max_moves:
                break
            if whatif.fits(pod):
                # Fits already (or a previous pod's moves freed room):
                # account for it so later pending pods don't plan onto
                # the same hole.
                whatif.place(pod)
                continue
            found = self._make_room(whatif, pod,
                                    self.max_moves - len(moves))
            if found is None:
                continue
            new_moves, whatif = found
            moves.extend(new_moves)
            whatif.place(pod)
            unblocks.append(f"{pod.namespace}/{pod.name}")
        moves.extend(self._ring_repairs(whatif, residents,
                                        self.max_moves - len(moves)))
        if not moves:
            return None
        plan = Plan(moves, unblocks)
        self._record(plan)
        return plan

    # -- ring repair (docs/topology.md) ---------------------------------- #

    @staticmethod
    def _has_fragmented_slice_gang(infos: list[NodeInfo]) -> bool:
        """Any RESIDENT slice-shape gang whose worker-order ring is
        below perfect contiguity? Computed from live node documents
        only (gang_ring_stats needs positions, not ledgers) — the
        cheap gate that lets the idle (nothing-pending) tick skip the
        what-if clone entirely."""
        from tpushare_torch.topology import fleet as topo

        gangs: dict[tuple[str, str], dict[str, Any]] = {}
        for info in infos:
            for chip in info.chips.values():
                for pod in chip.snapshot_pods():
                    if (not pod.annotations.get(const.ANN_POD_GROUP)
                            or podutils.get_slice_shape(pod) is None
                            or podutils.is_complete_pod(pod)):
                        continue
                    key = (pod.namespace,
                           pod.annotations[const.ANN_POD_GROUP])
                    gangs.setdefault(key, {})[pod.name] = info.node
        for members in gangs.values():
            ordered = sorted(members, key=topo.worker_sort_key)
            stats = topo.gang_ring_stats(
                [members[name] for name in ordered])
            if stats is not None and stats["contiguity"] < 0.999:
                return True
        return False

    def _ring_repairs(self, whatif: WhatIf, residents: frozenset[str],
                      budget: int) -> list[Move]:
        """Moves that restore a fragmented slice-shape gang's ring
        contiguity: members of a committed gang whose worker-order ring
        pays multi-hop ICI (or DCN) are relocated onto a freshly
        elected contiguous block. Whole-gang eligibility applies
        (every member must be movable — the eviction restarts the
        group through the gang reaper and the owner re-gangs it
        atomically, with the placer now finding the repaired block),
        but only the off-slot members actually move. Runs on leftover
        budget after pending-pod moves: unblocking stuck demand still
        outranks speeding up running jobs."""
        if budget <= 0:
            return []
        from tpushare_torch.topology import fleet as topo

        gangs: dict[tuple[str, str], list[tuple[str, Pod]]] = {}
        for uid, (node, pod) in whatif.located.items():
            if uid not in residents:
                continue  # hypothetically-placed pending pod, not real
            group = pod.annotations.get(const.ANN_POD_GROUP, "")
            if not group or podutils.get_slice_shape(pod) is None:
                continue
            gangs.setdefault((pod.namespace, group), []).append((node,
                                                                 pod))
        out: list[Move] = []
        for key, members in sorted(gangs.items()):
            if len(out) >= budget:
                break
            # Worker (ring) order: numeric-ordinal pod-name order —
            # the SAME key the gang planner's steering used, or an
            # unpadded w-10 would sort next to w-1 and a perfectly
            # placed ring would be "repaired" into a fragmented one.
            members.sort(key=lambda m: topo.worker_sort_key(m[1].name))
            infos = [whatif.nodes.get(n) for n, _ in members]
            if any(i is None for i in infos):
                continue
            cur = topo.gang_ring_stats([i.node for i in infos
                                        if i is not None])
            if cur is None or cur["contiguity"] >= 0.999:
                continue
            if any(not self.movable(p)[0] for _, p in members):
                continue
            # Elect against a what-if with the gang REMOVED: the block
            # the gang itself fragments is a legal destination.
            trial = whatif.clone()
            for _, p in members:
                trial.remove(p.uid)
            placer = topo.SlicePlacer(_WhatIfTable(trial.nodes))
            placement = placer.elect(key, self._as_request(members[0][1]))
            if placement is None or len(placement.hosts) < len(members):
                continue
            # Assign ring slots EXACTLY like bind-time steering will
            # when the re-gang lands (worker ordinal when valid, next
            # free slot otherwise), and judge the improvement by the
            # MEMBERS' predicted post-move ring — not the full block's
            # stats: a mismatch there authors an eviction whose
            # steered outcome measures no better, and the next tick
            # would author it again, forever.
            slots = self._assign_slots(members, len(placement.hosts))
            grid = Topology(dims=placement.grid_dims,
                            torus=placement.torus)
            new_contig = topo.ring_stats(
                [placement.coords[s] for s in slots], grid)["contiguity"]
            if new_contig <= cur["contiguity"]:
                continue
            gang_moves: list[Move] = []
            for slot, (node, p) in zip(slots, members):
                target = placement.hosts[slot]
                if target == node:
                    continue
                move = Move(p, node, target)
                move.detail = (f"ring-repair: contiguity "
                               f"{cur['contiguity']} -> {new_contig}")
                gang_moves.append(move)
            if not gang_moves or len(out) + len(gang_moves) > budget:
                continue
            out.extend(gang_moves)
            # Fold the repair into the LIVE what-if: a second
            # fragmented gang in this same plan must see the block as
            # taken, or both would elect it and one re-gang lands
            # nowhere better than it started.
            by_uid = {p.uid: (node, p) for node, p in members}
            for move in gang_moves:
                node, pod = by_uid[move.uid]
                whatif.remove(move.uid)
                self._apply_repair(whatif, move.to_node, pod)
        return out

    @staticmethod
    def _assign_slots(members: list[tuple[str, Pod]],
                      n_hosts: int) -> list[int]:
        """Ring slots the gang planner's steering will hand these
        members (in the given worker order): each member takes its
        worker ordinal when it is a valid, unclaimed slot; otherwise
        the first free slot in ring order."""
        from tpushare_torch.topology import fleet as topo

        used: set[int] = set()
        slots: list[int] = []
        for _node, pod in members:
            ordinal = topo.worker_ordinal(pod.name)
            if (ordinal is not None and ordinal < n_hosts
                    and ordinal not in used):
                slot = ordinal
            else:
                slot = next(i for i in range(n_hosts) if i not in used)
            used.add(slot)
            slots.append(slot)
        return slots

    def _apply_repair(self, whatif: WhatIf, target: str,
                      victim: Pod) -> None:
        """Re-place one repaired member on its elected host inside the
        what-if (the pinned-destination variant of ``WhatIf.place``).
        Best-effort: the elected hosts were verified free by the
        election, so a pick failure (a racing hypothetical placement)
        just leaves the member out of the model — over-reserving the
        block is the safe direction."""
        info = whatif.nodes.get(target)
        if info is None:
            return
        req = self._as_request(victim)
        try:
            chips = info.pick_chips(req)
        except AllocationError:
            return
        if podutils.get_chips_from_pod_resource(req) > 0:
            hbm_pod = sum(info.chips[c].total_hbm for c in chips)
        else:
            hbm_pod = podutils.get_hbm_from_pod_resource(req)
        placed = podutils.updated_pod_annotation_spec(
            req, chips, hbm_pod, info.chips[chips[0]].total_hbm,
            assume_time_ns=0)
        placed.spec["nodeName"] = target
        info.add_or_update_pod(placed)
        whatif.located[victim.uid] = (target, placed)

    def _make_room(self, whatif: WhatIf, pod: Pod, budget: int
                   ) -> tuple[list[Move], WhatIf] | None:
        """Find a victim set on SOME node whose relocation lets ``pod``
        fit there; returns (moves, the what-if with them applied)."""
        req_chips = podutils.get_chips_from_pod_resource(pod)
        req_hbm = podutils.get_hbm_from_pod_resource(pod)
        candidates: list[tuple[int, str, list[Pod]]] = []
        for name, info in whatif.nodes.items():
            victims = (self._chip_victims(info, req_chips)
                       if req_chips > 0
                       else self._hbm_victims(info, req_hbm))
            if victims is None:
                continue
            expanded = self._expand_gangs(victims)
            if expanded is None or len(expanded) > budget:
                continue
            candidates.append((len(expanded), name, expanded))
        for _, target, victims in sorted(
                candidates, key=lambda c: (c[0], c[1]))[:MAX_TARGETS_TRIED]:
            trial = whatif.clone()
            ok = True
            placements: list[Move] = []
            for victim in sorted(
                    victims,
                    key=lambda v: -podutils.get_hbm_from_pod_annotation(v)):
                source = trial.located.get(victim.uid, ("", None))[0]
                trial.remove(victim.uid)
                dest = trial.place(self._as_request(victim),
                                   exclude=frozenset((target,)))
                if dest is None:
                    ok = False
                    break
                placements.append(Move(victim, source, dest))
            if ok and trial.nodes[target].assume(pod)[0]:
                return placements, trial
        return None

    def _hbm_victims(self, info: NodeInfo,
                     req_hbm: int) -> list[Pod] | None:
        """Cheapest movable victim set freeing one chip up to
        ``req_hbm``; None when no chip on this node can get there."""
        if req_hbm <= 0:
            return None
        avail = info.get_available_hbm()
        best: list[Pod] | None = None
        for idx, chip in info.chips.items():
            if chip.total_hbm < req_hbm:
                continue
            deficit = req_hbm - avail.get(idx, 0)
            if deficit <= 0:
                continue  # fits already; caller would not be here
            residents = [(p, c) for p, c in chip.snapshot_contributions()
                         if c > 0 and self.movable(p)[0]]
            # Largest contribution first: fewest victims to cover the
            # deficit (moving is disruption; minimize bodies, not GiB).
            residents.sort(key=lambda pc: -pc[1])
            chosen: list[Pod] = []
            freed = 0
            for p, c in residents:
                if len(chosen) >= MAX_VICTIMS_PER_CHIP:
                    break
                chosen.append(p)
                freed += c
                if freed >= deficit:
                    break
            if freed < deficit:
                continue
            if best is None or len(chosen) < len(best):
                best = chosen
        return best

    def _chip_victims(self, info: NodeInfo,
                      req_chips: int) -> list[Pod] | None:
        """Movable victims clearing enough chips for a whole-chip
        request; already-free chips are used first."""
        if req_chips <= 0:
            return None
        free = len(info.get_free_chips())
        need = req_chips - free
        if need <= 0:
            return None  # fits already
        clearable: list[tuple[int, list[Pod]]] = []
        for idx, chip in info.chips.items():
            residents = {p.uid: p for p, c in chip.snapshot_contributions()
                         if c > 0}
            if not residents:
                continue
            if any(not self.movable(p)[0] for p in residents.values()):
                continue
            if len(residents) > MAX_VICTIMS_PER_CHIP:
                continue
            cost = sum(podutils.pod_used_hbm(p)
                       for p in residents.values())
            clearable.append((cost, list(residents.values())))
        if len(clearable) < need:
            return None
        clearable.sort(key=lambda c: c[0])
        victims: dict[str, Pod] = {}
        for _, residents in clearable[:need]:
            for p in residents:
                victims[p.uid] = p
        return list(victims.values())

    def _expand_gangs(self, victims: list[Pod]) -> list[Pod] | None:
        """Close the victim set over gang membership — move all members
        or none. None when any member is immovable."""
        out: dict[str, Pod] = {}
        for victim in victims:
            for member in self._gang_members(victim):
                ok, why = self.movable(member)
                if not ok:
                    log.debug("defrag: dropping candidate %s — gang "
                              "member %s is immovable (%s)",
                              victim.key(), member.key(), why)
                    return None
                out[member.uid] = member
        return list(out.values())

    @staticmethod
    def _as_request(victim: Pod) -> Pod:
        """The victim as its owner would recreate it: the original
        request, no grant annotations (re-placement must re-run the
        real picker, not adopt the old chips)."""
        fresh = victim.deepcopy()
        ann = fresh.metadata.get("annotations") or {}
        for key in const.GRANT_ANNOTATIONS:
            ann.pop(key, None)
        fresh.raw.setdefault("spec", {}).pop("nodeName", None)
        return fresh

    # -- flight-recorder plumbing ---------------------------------------- #

    def _record(self, plan: Plan) -> None:
        """Every planned move becomes a completed ``defrag:plan``
        decision in the flight recorder — `kubectl inspect tpushare
        explain <pod>` shows WHY the pod was (or would be) moved."""
        for move in plan.moves:
            try:
                with trace.phase("defrag:plan", move.namespace, move.name,
                                 move.uid) as dec:
                    trace.set_parent(move.parent_id)
                    trace.note("planId", plan.plan_id)
                    trace.note("from", move.from_node)
                    trace.note("to", move.to_node)
                    trace.note("unblocks", list(plan.unblocks))
                    if move.gang:
                        trace.note("gang", move.gang)
                    trace.complete(dec, "defrag-planned",
                                   node=move.to_node)
                if dec is not None:
                    move.trace_id = dec.trace_id
            except Exception:  # noqa: BLE001 - telemetry must not plan
                trace.recorder().drops.inc()
