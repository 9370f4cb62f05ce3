"""Preempt handler: minimal-cost victim selection on the chip ledger.

The port's copy of ``tpushare/scheduler/preempt.py``: its answers, its
decision-trace notes (``quotaDenied``, ``victimsPerNode``) and its
``tpushare_preempt_victims_total`` count are the reference's.

The k8s scheduler-extender protocol has a fourth verb gpushare never
implemented — ``preemptVerb`` (its vendored wire types stop at bind,
``vendor/k8s.io/kubernetes/pkg/scheduler/api/types.go:258-302``). Without
it, a high-priority pod that cannot fit is stuck behind the extender's
extended resources forever: the default preemption logic only understands
resources the scheduler itself accounts, so it can evict for CPU and
memory but never to free TPU HBM or whole chips. On a saturated fleet
(exactly the adversarial-bench regime, where ~100 multi-chip pods sit
blocked) that turns priority classes into a no-op for TPU jobs.

Protocol (``schedulerapi.ExtenderPreemptionArgs/Result``): when no node
passes filtering, the scheduler computes a per-node candidate victim set
from *its* resource view and POSTs it here. This handler re-plans each
node against the chip ledger and answers with the victims *TPU* resources
require; nodes where no legal eviction set frees enough capacity are
dropped from the map. The scheduler intersects, picks a node, and evicts.

Victim-selection policy (TPU-first):

* Only pods with ``spec.priority`` strictly below the preemptor's are
  evictable — the scheduler enforces this too, but the ledger must not
  propose victims the scheduler would reject.
* HBM preemptors need one chip with enough contiguous-after-eviction
  free HBM: chips are planned independently and the cheapest plan wins.
  Cost order follows upstream k8s preemption: lowest victim priority
  dominates (two priority-0 slices die before one priority-5 trainer),
  then the tie-breaks in ``_plan_cost`` ending with least HBM destroyed
  (evict one 12-GiB slice from a chip with 4 GiB already free rather
  than a whole 16-GiB trainer).
* Whole-chip preemptors need N fully-free chips: per-chip eviction plans
  are costed the same way and the N cheapest feasible chips are taken,
  so already-free chips are used before anything is evicted.
* Victims the scheduler already nominated (for its own resources) are
  preferred at equal cost — those pods are being evicted anyway, so
  reusing them keeps the total blast radius minimal.
* Tenancy (tpushare/quota): victims *borrowing over their tenant's
  guarantee* form a preferred tier — among legal victims, borrowed pods
  die before pods running inside their tenant's guaranteed share, so
  elastic borrowing stays cheap to reclaim. And when the preemptor's
  own tenant is asking within its guarantee, borrowed pods of OTHER
  tenants are evictable even at EQUAL priority (fair-share reclaim, the
  Themis shape): a guarantee would be worthless if a borrower at the
  same priority class could squat on it. Both behaviors vanish when no
  quota config exists — a quota-free fleet preempts exactly as before.
* Gang victims are priced at their gang's FULL cluster footprint:
  evicting one member of a committed gang bricks the whole job while the
  surviving members squat on their chips, so the real cost of that
  victim is every member's HBM across every node — not the one slice on
  the chip under consideration. A lone pod of the same priority
  therefore always beats a gang member, at any size, and a small gang
  beats a large one. When a gang member IS evicted, every sibling on the
  candidate node joins the victim map (the wire form is per-node — see
  :meth:`Preempt.expand_gang_victims`), and the controller's gang reaper
  reclaims members on other nodes once the eviction drops the group
  below quorum — the whole gang's chips come back, not just one slice.
"""

from __future__ import annotations

import logging
from typing import Callable, Iterable

from tpushare_torch import trace
from tpushare_torch.api.extender import (ExtenderPreemptionArgs,
                                         ExtenderPreemptionResult)
from tpushare_torch.api.objects import Pod
from tpushare_torch.cache.cache import SchedulerCache
from tpushare_torch.cache.chipinfo import ChipInfo
from tpushare_torch.cache.nodeinfo import NodeInfo, apply_nominated_demand
from tpushare_torch.quota.manager import QuotaManager
from tpushare_torch.utils import pod as podutils

log = logging.getLogger(__name__)


class Preempt:
    name = "tpushare-preempt"

    def __init__(self, cache: SchedulerCache,
                 pdb_lister: Callable[[], list] | None = None,
                 quota: QuotaManager | None = None) -> None:
        self.cache = cache
        #: Zero-arg callable returning the current PodDisruptionBudgets
        #: (wired to the informer's pdbs store). None = no PDB view:
        #: the handler then echoes the scheduler's violation counts
        #: instead of recounting.
        self.pdb_lister = pdb_lister
        #: Optional tenant ledger: arms the borrowed-victim tier and
        #: equal-priority fair-share reclaim (module docstring).
        self.quota = quota

    def _borrowed(self, pod: Pod) -> bool:
        return self.quota is not None and self.quota.is_borrowed(pod)

    def _reclaim_ok(self, plan_pods: Iterable[Pod], preemptor: Pod,
                    memo: dict | None = None) -> bool:
        """Plan-level fair-share bound: per-victim ``is_borrowed`` is
        static against the live ledger, so a plan evicting SEVERAL
        equal-priority victims of one tenant could cut that tenant
        below its guarantee (two 16-GiB pods over a 16-GiB guarantee
        are each individually borrowed — but only 16 GiB is actually
        on loan). Cap each tenant's equal-priority reclaim total at
        its current beyond-guarantee excess; lower-priority victims
        are ordinary preemption and consume no budget.

        ``memo`` (one dict per plan_node request) caches each victim's
        tenant/demand and each tenant's excess: the chip-combination
        search evaluates thousands of candidate plans, and per-plan
        quota-lock round-trips would contend with the filter/bind hot
        path. The memo also pins ONE excess reading per request, so
        every candidate plan is judged against the same ledger view."""
        if self.quota is None:
            return True
        if memo is None:
            memo = {}
        victims: dict = memo.setdefault("victims", {})
        excess: dict = memo.setdefault("excess", {})
        taking: dict[str, list[int]] = {}
        for pod in plan_pods:
            if pod.priority != preemptor.priority:
                continue
            entry = victims.get(pod.uid)
            if entry is None:
                tenant = self.quota.tenant_of(pod)
                entry = victims[pod.uid] = (
                    tenant, self.quota.granted_demand(pod))
                if tenant not in excess:
                    excess[tenant] = self.quota.reclaimable_excess(tenant)
            tenant, (hbm, chips) = entry
            acc = taking.setdefault(tenant, [0, 0])
            acc[0] += hbm
            acc[1] += chips
        return all(hbm <= excess[tenant][0] and chips <= excess[tenant][1]
                   for tenant, (hbm, chips) in taking.items())

    # ------------------------------------------------------------------ #
    # Per-chip planning
    # ------------------------------------------------------------------ #

    def _evictable(self, pod: Pod, preemptor: Pod) -> bool:
        if podutils.is_complete_pod(pod):
            return False  # already free; never a victim
        if pod.priority < preemptor.priority:
            return True
        # Fair-share reclaim: an equal-priority victim is legal ONLY
        # when it sits wholly in borrowed territory and the preemptor's
        # tenant is asking within its guarantee (QuotaManager gates all
        # three conditions; no quota config -> never).
        return (self.quota is not None
                and pod.priority == preemptor.priority
                and self.quota.reclaim_eligible(preemptor, pod))

    def _victim_order(self, pod: Pod, contrib: int,
                      preferred: set[str]) -> tuple[int, int, int, int, int]:
        """Sort key: BORROWED pods first (quota tier — usage beyond a
        tenant's guarantee is the cheapest thing on the chip to take
        back), then lowest priority (same criteria order as
        ``_plan_cost``); among equals prefer non-gang pods, then pods the
        scheduler already nominated, then the largest contribution
        (fewest victims to reach the target)."""
        return (0 if self._borrowed(pod) else 1,
                pod.priority,
                1 if podutils.is_gang_pod(pod) else 0,
                0 if pod.uid in preferred else 1,
                -contrib)

    def _plan_chip_hbm(self, chip: ChipInfo, need: int, preemptor: Pod,
                       preferred: set[str],
                       reclaim_memo: dict | None = None,
                       ) -> list[tuple[Pod, int]] | None:
        """Cheapest victim set on one chip that frees ≥ ``need`` GiB
        beyond what is already free; None when even evicting every legal
        victim falls short. ``need <= 0`` means the chip already fits."""
        if need <= 0:
            return []
        candidates = [(p, c) for p, c in chip.snapshot_contributions()
                      if c > 0 and self._evictable(p, preemptor)]
        candidates.sort(key=lambda pc: self._victim_order(
            pc[0], pc[1], preferred))
        chosen: list[tuple[Pod, int]] = []
        freed = 0
        for pod, contrib in candidates:
            if not self._reclaim_ok([p for p, _ in chosen] + [pod],
                                    preemptor, reclaim_memo):
                continue  # would overdraw its tenant's borrowed excess
            chosen.append((pod, contrib))
            freed += contrib
            if freed >= need:
                break
        if freed < need:
            return None
        # Reprieve pass (k8s preemption does the same): walk the chosen
        # set from the most-protected victim down and spare anyone whose
        # contribution is no longer needed — the greedy can overshoot
        # when a later, bigger victim covers an earlier small one.
        for entry in sorted(chosen, key=lambda pc: self._victim_order(
                pc[0], pc[1], preferred), reverse=True):
            if freed - entry[1] >= need:
                chosen.remove(entry)
                freed -= entry[1]
        return chosen

    # ------------------------------------------------------------------ #
    # Per-node planning
    # ------------------------------------------------------------------ #

    def _nominated_view(self, info: NodeInfo, preemptor: Pod
                        ) -> tuple[dict[int, int], set[int], bool]:
        """(available HBM per chip, earmarked chip set, unmet?) after
        subtracting higher-or-equal-priority NOMINATED demand — capacity
        some other preemptor's victims freed stays spoken for until it
        binds, so a plan here must not hand it to this preemptor (the
        gang case: member B "already fits" on the chips member A's
        victims freed, and the gang livelocks). ``unmet`` means a
        nominee's victims are still dying and its shortfall is covered
        by capacity that has not materialized yet — this node cannot be
        safely planned for another same-priority preemptor this round
        (upstream runs its preemption simulation with nominated pods'
        FULL requests added; one delayed round beats double-targeting
        the same dying victims)."""
        nominated = [p for p in self.cache.nominated_on(info.name)
                     if p.uid != preemptor.uid
                     and p.priority >= preemptor.priority]
        avail = info.get_available_hbm()
        if not nominated:
            return avail, set(), False
        free = set(info.get_free_chips())
        free_before = set(free)
        avail_before = dict(avail)
        unmet = apply_nominated_demand(avail, free, nominated)
        earmarked = {i for i in free_before - free} | {
            i for i in avail if avail[i] != avail_before.get(i, 0)}
        return avail, earmarked, unmet

    def plan_node(self, info: NodeInfo, preemptor: Pod,
                  preferred: set[str],
                  gang_memo: dict | None = None) -> list[Pod] | None:
        """Victim pods whose eviction lets ``preemptor`` fit on ``info``;
        [] when it already fits, None when no legal plan exists.
        ``gang_memo`` caches per-gang (member count, footprint) across
        cost evaluations — pass one dict per request so the combination
        search never rescans the cluster pod table."""
        if gang_memo is None:
            gang_memo = {}
        reclaim_memo: dict = {}  # per-request victim/excess cache
        avail, earmarked, unmet = self._nominated_view(info, preemptor)
        if unmet:
            return None  # a nominee's grant is still materializing here
        req_chips = podutils.get_chips_from_pod_resource(preemptor)
        if req_chips > 0:
            return self._plan_node_chips(info, req_chips, preemptor,
                                         preferred, gang_memo, earmarked,
                                         reclaim_memo)
        req_hbm = podutils.get_hbm_from_pod_resource(preemptor)
        if req_hbm <= 0:
            return None  # not a TPU pod; caller handles pass-through
        best: list[tuple[Pod, int]] | None = None
        for idx, chip in info.chips.items():
            if chip.total_hbm < req_hbm:
                continue  # can never fit, even empty
            plan = self._plan_chip_hbm(chip, req_hbm - avail.get(idx, 0),
                                       preemptor, preferred, reclaim_memo)
            if plan is None:
                continue
            if best is None or (
                    self._plan_cost(plan, preferred, info, gang_memo)
                    < self._plan_cost(best, preferred, info, gang_memo)):
                best = plan
        return None if best is None else self._dedup([p for p, _ in best])

    def _plan_node_chips(self, info: NodeInfo, req_chips: int,
                         preemptor: Pod, preferred: set[str],
                         gang_memo: dict,
                         earmarked: set[int] = frozenset(),
                         reclaim_memo: dict | None = None,
                         ) -> list[Pod] | None:
        """The N-chip set whose *distinct-victim union* is cheapest.

        Chips cannot be costed independently: one multi-chip victim can
        clear several chips at once, so the cheapest pair of chips may
        share a single victim while per-chip costing would evict two
        separate pods. Chip counts per host are small (4-8), so the
        exact search over combinations is affordable; pathological chip
        counts fall back to greedy marginal-cost selection.
        ``earmarked`` chips carry nominated demand (another preemptor's
        freed capacity) and are never offered."""
        clearable: dict[int, list[tuple[Pod, int]]] = {}
        for idx, chip in info.chips.items():
            if idx in earmarked:
                continue
            residents = [(p, c) for p, c in chip.snapshot_contributions()
                         if not podutils.is_complete_pod(p)]
            if any(not self._evictable(p, preemptor) for p, _ in residents):
                continue
            clearable[idx] = residents
        if len(clearable) < req_chips:
            return None

        def union_plan(chip_set: Iterable[int]) -> list[tuple[Pod, int]]:
            merged: dict[str, list] = {}
            for i in chip_set:
                for p, c in clearable[i]:
                    if p.uid in merged:
                        merged[p.uid][1] += c
                    else:
                        merged[p.uid] = [p, c]
            return [(p, c) for p, c in merged.values()]

        import itertools
        import math

        # comb(16,8)=12870: exact search covers every real host form
        # factor (up to 16 chips); the greedy is the >16-chip fallback
        # (exercised by tests/test_preempt.py's synthetic 32-chip host).
        # Either way a candidate plan must pass the fair-share reclaim
        # bound (_reclaim_ok) — a chip set whose union over-drains one
        # tenant's borrowed excess is not a legal plan at all.
        if math.comb(len(clearable), req_chips) <= 13000:
            try:
                # Lazy: min() streams the combination space; the memoed
                # reclaim bound filters inline without materializing
                # thousands of candidate plans.
                best = min(
                    (pl for pl in
                     (union_plan(combo) for combo in
                      itertools.combinations(sorted(clearable),
                                             req_chips))
                     if self._reclaim_ok([p for p, _ in pl], preemptor,
                                         reclaim_memo)),
                    key=lambda pl: self._plan_cost(pl, preferred, info,
                                                   gang_memo))
            except ValueError:  # every combination over-reclaims
                return None
        else:
            chosen: list[int] = []
            while len(chosen) < req_chips:
                held_pods = union_plan(chosen)
                held = {p.uid for p, _ in held_pods}
                # Groups already doomed by a held member cost nothing
                # more: their siblings' chips are free in practice, and
                # the marginal cost must say so or the greedy would
                # evict a pristine victim instead of finishing off a
                # gang it has already condemned.
                doomed = frozenset(
                    (p.namespace, podutils.get_pod_group(p)[0])
                    for p, _ in held_pods
                    if podutils.get_pod_group(p)[0])
                options = [
                    i for i in sorted(clearable) if i not in chosen
                    and self._reclaim_ok(
                        [p for p, _ in union_plan(chosen + [i])],
                        preemptor, reclaim_memo)]
                if not options:
                    return None
                nxt = min(
                    options,
                    key=lambda i: self._plan_cost(
                        [(p, c) for p, c in clearable[i]
                         if p.uid not in held], preferred, info,
                        gang_memo, doomed))
                chosen.append(nxt)
            best = union_plan(chosen)
        return self._dedup([p for p, _ in best])

    def _pod_footprint(self, pod: Pod, info: NodeInfo | None) -> int:
        """A victim's FULL granted HBM footprint in GiB — what eviction
        actually destroys, cluster-truth, not its share on the chips
        under consideration. HBM pods carry the grant in their
        annotation; whole-chip pods carry no HBM annotation, so their
        footprint is every granted chip's full
        HBM, read from their node's ledger (a 2-chip trainer destroyed to
        free one chip still costs both chips)."""
        hbm = podutils.get_hbm_from_pod_annotation(pod)
        if hbm > 0:
            return hbm
        chip_ids = podutils.get_chip_ids_from_annotation(pod)
        if not chip_ids:
            return 0
        node = None
        if info is not None and pod.node_name == info.name:
            node = info
        elif pod.node_name:
            node = self.cache.peek_node_info(pod.node_name)
        if node is None:
            return 0
        return sum(node.chips[i].total_hbm for i in chip_ids
                   if i in node.chips)

    def _gang_price(self, key: tuple[str, str], fallback: Pod,
                    info: NodeInfo | None,
                    gang_memo: dict) -> tuple[int, int]:
        """(member count, summed cluster footprint GiB) for gang ``key``,
        memoized per request: the exact search evaluates up to ~13k
        candidate plans and must not rescan the cluster pod table (under
        the cache lock) for every one of them."""
        priced = gang_memo.get(key)
        if priced is None:
            members = self.cache.gang_members(*key) or [fallback]
            priced = (len(members),
                      sum(self._pod_footprint(m, info) for m in members))
            gang_memo[key] = priced
        return priced

    def _plan_cost(self, plan: list[tuple[Pod, int]], preferred: set[str],
                   info: NodeInfo | None, gang_memo: dict,
                   doomed: frozenset = frozenset(),
                   ) -> tuple[int, int, int, int, int, int]:
        """Compare eviction plans across chips. Criteria order follows
        upstream k8s preemption (``pickOneNodeForPreemption``): the
        highest victim priority is minimized FIRST — disruption lands on
        the lowest-priority workloads even when that means more victims
        (two priority-0 slices die before one priority-5 trainer). Then
        fewest NON-BORROWED victims (quota tier: at equal priority a
        plan draining beyond-guarantee borrowing beats one that cuts
        into a tenant's guaranteed share; zero everywhere when no quota
        config exists). Then fewest GANG MEMBERS STRANDED — a gang
        victim drags its whole
        group down, so it counts every cluster-wide member while a lone
        pod counts 0: a lone pod always beats a same-priority gang member
        at any size, and a 4-member gang beats a 16-member one. Then
        fewest victims beyond what the scheduler already nominated, then
        fewest in-plan victims, then least HBM destroyed — each victim at
        full granted footprint (:meth:`_pod_footprint`), gang victims at
        their group's summed cluster-wide footprint."""
        stranded = 0
        hbm = 0
        gangs_seen: set[tuple[str, str]] = set(doomed)
        for p, c in plan:
            group, _ = podutils.get_pod_group(p)
            if group:
                key = (p.namespace, group)
                if key in gangs_seen:
                    continue  # whole gang already priced (or doomed: 0)
                gangs_seen.add(key)
                count, footprint = self._gang_price(key, p, info, gang_memo)
                stranded += count
                hbm += footprint
            else:
                hbm += self._pod_footprint(p, info) or c
        return (max((p.priority for p, _ in plan), default=-1),
                sum(1 for p, _ in plan if not self._borrowed(p)),
                stranded,
                sum(1 for p, _ in plan if p.uid not in preferred),
                len(plan),
                hbm)

    def expand_gang_victims(self, plan: list[Pod],
                            node: str) -> list[Pod]:
        """Close the victim set over gang membership ON ``node``: if any
        member of a committed gang dies, the job is bricked, so every
        sibling on the same node is named too and its chips come back
        with the eviction.

        Only same-node siblings can go on the wire: the scheduler
        resolves each meta-victim UID against THAT node's pod list
        (upstream ``convertToVictims``), so a cross-node UID would abort
        the whole preemption attempt. Siblings on other nodes are
        reclaimed by the controller's gang reaper when it observes the
        eviction drop the group below quorum
        (:meth:`tpushare_torch.controller.controller.Controller`
        pod-delete path)."""
        out = list(plan)
        seen = {p.uid for p in plan}
        for p in plan:
            group, _ = podutils.get_pod_group(p)
            if not group:
                continue
            for member in self.cache.gang_members(p.namespace, group):
                if member.uid not in seen and member.node_name == node:
                    seen.add(member.uid)
                    out.append(member)
        return out

    def count_pdb_violations(self, victims: list[Pod]) -> int | None:
        """How many of ``victims`` would violate a PodDisruptionBudget —
        recomputed for the victim set THIS handler authored, not echoed
        from the scheduler's (we replace and enlarge its set: gang
        siblings, chip-ledger victims). Upstream
        ``pickOneNodeForPreemption`` minimizes this number when picking
        the node, so an undercount would steer eviction toward nodes
        where the real blast radius is larger.

        Semantics follow upstream ``filterPodsWithPDBViolation``: each
        victim consumes one allowed disruption from every budget that
        selects it; a victim that hits ANY budget with no disruptions
        left counts as one violation; a victim already listed in a
        budget's ``status.disruptedPods`` (its eviction is in flight)
        neither consumes that budget nor violates it. Returns None when
        no PDB view is wired (caller falls back to echoing)."""
        if self.pdb_lister is None:
            return None
        try:
            pdbs = list(self.pdb_lister())
        except Exception:  # pragma: no cover - lister trouble
            log.warning("PDB lister failed; echoing scheduler counts",
                        exc_info=True)
            return None
        remaining = [max(p.disruptions_allowed, 0) for p in pdbs]
        violations = 0
        for victim in victims:
            hit = False
            for i, pdb in enumerate(pdbs):
                if not pdb.matches(victim):
                    continue
                if victim.name in pdb.disrupted_pods:
                    continue  # already being disrupted: free either way
                if remaining[i] > 0:
                    remaining[i] -= 1
                else:
                    hit = True
            if hit:
                violations += 1
        return violations

    @staticmethod
    def _dedup(pods: list[Pod]) -> list[Pod]:
        """A multi-chip victim shows up once per chip it pins; the
        eviction set names it once."""
        seen: set[str] = set()
        out = []
        for p in pods:
            if p.uid not in seen:
                seen.add(p.uid)
                out.append(p)
        return out

    # ------------------------------------------------------------------ #

    def handle(self, args: ExtenderPreemptionArgs) -> ExtenderPreemptionResult:
        pod = args.pod
        result = ExtenderPreemptionResult()
        if not (podutils.is_tpu_sharing_pod(pod)
                or podutils.is_tpu_chip_pod(pod)):
            # Not ours: echo the scheduler's own victim map untouched so
            # preemption for non-TPU resources proceeds normally.
            for name, victims in args.node_victims.items():
                result.node_victims[name] = victims.victim_uids()
                result.pdb_violations[name] = victims.num_pdb_violations
            return result

        if self.quota is not None:
            # Tenant hard limit mirrors the filter: the scheduler's
            # PostFilter falls back to preemption after OUR quota
            # denial, and authoring a victim plan here would evict
            # innocents for a preemptor the filter must deny again the
            # moment they are gone (capacity exists; the tenant is over
            # policy). Empty map = no node can be helped by eviction.
            ok, reason = self.quota.admit(pod)
            if not ok:
                trace.note("quotaDenied", reason)
                log.debug("preempt pod %s refused: %s", pod.key(), reason)
                return result

        gang_memo: dict = {}  # per-request (ns, group) pricing cache
        for name, victims in args.node_victims.items():
            info = self.cache.get_node_info(name)
            if info is None:
                continue  # node vanished; drop it from the candidates
            nominated = victims.victim_uids()
            plan = self.plan_node(info, pod, set(nominated), gang_memo)
            if plan is None:
                continue  # no legal eviction set frees enough TPU capacity
            # Whole-gang closure: a gang member in the plan dooms its
            # entire group, so every same-node sibling is named too —
            # their chips come back now, not at TTL expiry (cross-node
            # siblings: controller gang reaper).
            plan = self.expand_gang_victims(plan, name)
            # UNION with the scheduler's own nominations: the scheduler
            # replaces its victim map with this response, so dropping a
            # CPU/memory victim it needs would livelock the preemptor.
            ours = [p.uid for p in plan]
            result.node_victims[name] = ours + [
                u for u in nominated if u not in set(ours)]
            # PDB violations for the set we RETURN (ours + nominated),
            # not the set the scheduler sent. Nominated-only victims are
            # resolved against this node's chip ledger; a CPU/memory
            # victim outside the TPU ledger has no Pod object here to
            # label-match, so it goes uncounted — the union rarely adds
            # such pods (they were nominated FOR this pod's resources).
            final_pods = list(plan)
            if len(ours) < len(result.node_victims[name]):
                by_uid = {p.uid: p
                          for chip in info.chips.values()
                          for p in chip.snapshot_pods()}
                final_pods += [by_uid[u] for u in nominated
                               if u not in set(ours) and u in by_uid]
            recount = self.count_pdb_violations(final_pods)
            result.pdb_violations[name] = (
                victims.num_pdb_violations if recount is None
                else recount)
        if result.node_victims:
            # The worst case over the candidates: the scheduler evicts
            # one node's set.
            from tpushare_torch.routes import metrics
            metrics.safe_inc(
                metrics.PREEMPT_VICTIMS,
                max(len(v) for v in result.node_victims.values()))
        trace.note("victimsPerNode",
                   {n: len(v) for n, v in result.node_victims.items()})
        log.debug("preempt pod %s: %s", pod.key(),
                  {n: len(v) for n, v in result.node_victims.items()})
        return result
