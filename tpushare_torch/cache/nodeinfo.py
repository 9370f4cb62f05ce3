"""Per-node card ledger and the bin-pack allocator.

The port's copy of ``tpushare/cache/nodeinfo.py`` (the counterpart of
gpushare's ``pkg/cache/nodeinfo.go``): each card has its own capacity;
single-card grants are tightest fit, ties broken toward the card with the
fewest free neighbours on the node's topology (a flat one on an NVIDIA
node) and then the lowest index; whole-card requests take a compact set
of free cards. ``allocate`` charges the cards under the node's lock,
writes the grant and the binding with the lock released (one typed retry
on a 409), and then prices the accepted document, or rolls the charge
back if a write failed.
"""

from __future__ import annotations

import logging
import time
from typing import Any, NamedTuple

from tpushare_torch import trace
from tpushare_torch.api.objects import Node, Pod, binding_doc
from tpushare_torch.cache.chipinfo import ChipInfo
from tpushare_torch.k8s.errors import ConflictError
from tpushare_torch.topology.topology import Topology
from tpushare_torch.utils import node as nodeutils
from tpushare_torch.utils import pod as podutils
from tpushare_torch.utils import locks

log = logging.getLogger(__name__)


class AllocationError(Exception):
    """No placement exists for the pod on this node."""


#: Bound on the per-node verb memos (distinct request shapes cached).
MEMO_CAP = 64


class NodeSummary(NamedTuple):
    """Immutable free-capacity digest of one node's ledger, the unit the
    filter and prioritize fast paths scan at fleet scale.

    Rebuilt lazily after any chip mutation (the ChipInfo ``on_change``
    hook clears the cache) and published as one atomic attribute write,
    so the verbs read it with no lock, instead of about ten lock round
    trips and a dict build a candidate."""

    #: Node advertises shareable TPU HBM at all.
    sharing: bool
    #: (free GiB, capacity GiB) per chip, in chip-index order.
    avail: tuple[tuple[int, int], ...]
    #: Indices of wholly-free chips (no resident active pods).
    free_chips: tuple[int, ...]
    #: Largest single-chip free HBM — the slice-admission test.
    max_free_chip: int
    chip_count: int
    #: ``spec.unschedulable`` (kubectl/autoscaler cordon). Upstream
    #: kube-scheduler filters cordoned nodes before any extender, but
    #: test harnesses (and any scheduler that skips the upstream pass)
    #: offer them — honoring the bit here keeps the filter verb's
    #: verdict identical either way, for one tuple-field read.
    unschedulable: bool = False


def apply_nominated_demand(avail: dict[int, int], free_chips: set[int],
                           nominated: list[Pod]) -> bool:
    """Subtract nominated pods' earmarked demand from an availability
    view, IN PLACE (``avail``: chip idx → free HBM GiB; ``free_chips``:
    wholly-free chip indices). Returns True when some nominee's demand
    could NOT be fully covered by current free capacity — its victims
    are still dying, and that shortfall is spoken for by capacity that
    has not materialized yet.

    Mirrors upstream preemption bookkeeping: capacity a preemptor's
    victims freed is spoken for until that preemptor binds, so admission
    for OTHER pods must not see it. Placement is simulated the way the
    real picker grants (tightest fit for HBM, arbitrary free chips for
    whole-chip) — an approximation, but an over-reservation here only
    delays a pod one scheduling round while an under-reservation steals
    a preemptor's chips and (for gangs) can livelock the whole group.
    That asymmetry also decides the partial case: a nominee whose
    victims are still terminating (only part of its demand freed so
    far) earmarks WHATEVER is currently free — an all-or-nothing
    earmark would leave each partially-freed chip stealable exactly
    during the staggered-termination window."""
    unmet = False
    for pod in sorted(nominated, key=lambda p: -p.priority):
        req_chips = podutils.get_chips_from_pod_resource(pod)
        if req_chips > 0:
            # Partial earmark: hold however many chips are free so far
            # (victims may still be terminating toward the full count).
            take = sorted(free_chips)[:req_chips]
            for idx in take:
                free_chips.discard(idx)
                avail[idx] = 0  # a whole-chip grant owns its HBM
            if len(take) < req_chips:
                unmet = True
            continue
        req_hbm = podutils.get_hbm_from_pod_resource(pod)
        if req_hbm <= 0:
            continue
        fits = [(v, i) for i, v in avail.items() if v >= req_hbm]
        if fits:
            _, idx = min(fits)  # tightest fit, like pick_chips
            avail[idx] -= req_hbm
            free_chips.discard(idx)
            continue
        # Nothing fits whole: hold what HAS been freed, emptiest chips
        # first (that is where this nominee's victims were dying).
        remaining = req_hbm
        for v, idx in sorted(((v, i) for i, v in avail.items()),
                             reverse=True):
            if remaining <= 0 or v <= 0:
                break
            take = min(v, remaining)
            avail[idx] -= take
            remaining -= take
            free_chips.discard(idx)
        if remaining > 0:
            unmet = True
    return unmet


class NodeInfo:
    """Aggregated allocation state of one TPU node."""

    def __init__(self, node: Node,
                 default_scoring: str | None = None) -> None:
        self.name = node.name
        self.node = node
        #: Fleet scoring default for the chip picker; None -> the env
        #: fallback inside podutils.effective_scoring (standalone use).
        self.default_scoring = default_scoring
        self._lock = locks.TracingRLock(f"node/{self.name}")
        #: Cached admission summary. Copy-on-write: rebuilt under the
        #: node lock, published by one atomic attribute write, cleared
        #: (set to None) by the chips' on_change hook — which only ever
        #: fires with the node lock held (every chip mutation path runs
        #: under it), so a rebuild can never publish over a fresher
        #: invalidation. Readers take no lock.
        self._summary: NodeSummary | None = None
        #: The node document's sharing bit, cached apart from the chip
        #: summary: chip churn invalidates summaries fleet-wide every
        #: round, and a rebuild must not parse the annotations again.
        #: Refreshed only when the node DOCUMENT changes
        #: (SchedulerCache.get_node_info's document swap).
        self._sharing: bool = nodeutils.is_tpu_sharing_node(node)
        #: The node document's cordon bit, cached like ``_sharing``
        #: (spec.unschedulable only changes via a document swap).
        self._unschedulable: bool = node.unschedulable
        #: Per-request-shape verdict/score memos for the verb fast
        #: paths: key → (summary-at-compute-time, cached value). An
        #: entry is valid only while its summary object IS the current
        #: one (identity check), so any ledger mutation implicitly
        #: invalidates both. GIL-atomic dict ops, no lock: a racing
        #: double-compute stores the same value twice. Bounded by the
        #: distinct request shapes in flight (callers clear past
        #: MEMO_CAP).
        self.admit_memo: dict[tuple[int, int],
                              tuple[NodeSummary, bool, str]] = {}
        self.score_memo: dict[tuple[int, int, str],
                              tuple[NodeSummary, int]] = {}
        #: k -> (summary-at-compute-time, compact selection over that
        #: summary's free chips). Same identity-validated discipline as
        #: the admit/score memos: Topology.select_compact is
        #: O(k * free^2) greedy per call, and prioritize re-runs it per
        #: candidate per request at fleet scale — in steady state each
        #: node re-selects only when its own ledger changed.
        self.compact_memo: dict[int,
                                tuple[NodeSummary,
                                      list[int] | None]] = {}
        caps = nodeutils.get_chip_capacities(node)
        self.chips: dict[int, ChipInfo] = locks.guarded_dict(
            self._lock, f"NodeInfo({self.name}).chips",
            {i: ChipInfo(i, cap, on_change=self._invalidate_summary)
             for i, cap in enumerate(caps)})
        self.chip_count = len(caps)
        self.total_hbm = sum(caps)
        topo_spec = nodeutils.get_topology(node)
        if topo_spec:
            try:
                self.topology = Topology.from_spec(topo_spec, nodeutils.get_tpu_type(node))
            except ValueError:
                self.topology = Topology.flat(self.chip_count)
        else:
            self.topology = Topology.flat(self.chip_count)
        if self.topology.chip_count != self.chip_count:
            # Mis-advertised node (chip-hbm entries vs topology volume):
            # degrade to a flat topology rather than risking IndexErrors
            # in the allocator's coordinate math.
            log.warning(
                "node %s: topology %s covers %d chips but %d advertised; "
                "falling back to flat", self.name, topo_spec,
                self.topology.chip_count, self.chip_count)
            self.topology = Topology.flat(self.chip_count)

    # ------------------------------------------------------------------ #
    # Ledger bookkeeping (reference nodeinfo.go:72-110)
    # ------------------------------------------------------------------ #

    def add_or_update_pod(self, pod: Pod) -> bool:
        """Record an annotated pod against its granted chip(s)."""
        with self._lock:
            ids = podutils.get_chip_ids_from_annotation(pod)
            added = False
            for cid in ids:
                chip = self.chips.get(cid)
                if chip is None:
                    log.warning(
                        "pod %s/%s references unknown chip %d on node %s",
                        pod.namespace, pod.name, cid, self.name,
                    )
                    continue
                chip.add_pod(pod)
                added = True
            return added

    def remove_pod(self, pod: Pod) -> None:
        with self._lock:
            for cid in podutils.get_chip_ids_from_annotation(pod):
                chip = self.chips.get(cid)
                if chip is not None:
                    chip.remove_pod(pod)

    # ------------------------------------------------------------------ #
    # Views
    # ------------------------------------------------------------------ #

    def get_available_hbm(self) -> dict[int, int]:
        """chip idx → free HBM GiB (reference getAvailableGPUs,
        nodeinfo.go:254-264)."""
        with self._lock:
            return {
                i: max(chip.total_hbm - chip.get_used_hbm(), 0)
                for i, chip in self.chips.items()
            }

    def apply_node_document(self, node: Node) -> None:
        """Fold a fresh node document (same chip set) into the ledger:
        keep the freshest doc and re-derive the cached sharing bit a
        document change may flip without touching chips. Under the node
        lock so an in-flight :meth:`summary` rebuild (which holds it)
        can't republish a digest built from the pre-flip bit AFTER this
        invalidation — on an empty node no chip mutation would ever
        re-invalidate it. Callers hold NO table lock here (the two
        locks never nest, keeping the acquisition graph a DAG)."""
        with self._lock:
            self.node = node
            self._sharing = nodeutils.is_tpu_sharing_node(node)
            self._unschedulable = node.unschedulable
            self._invalidate_summary()

    def _invalidate_summary(self) -> None:
        # One atomic write; the next summary() rebuilds. Not a guarded
        # field: the invariant is copy-on-write publish, not mutate-
        # under-lock (though every caller does hold the node lock).
        self._summary = None

    def summary(self) -> NodeSummary:
        """The node's admission digest (see :class:`NodeSummary`).

        Fast path is one attribute read of an immutable tuple; the
        rebuild (only after a ledger mutation) is O(chips) under the
        node lock. ``node`` document swaps invalidate too (see
        ``SchedulerCache.get_node_info`` / ``refresh_node``) so the
        ``sharing`` bit tracks annotation changes."""
        s = self._summary
        if s is not None:
            return s
        with self._lock:
            s = self._summary
            if s is not None:
                return s
            avail: list[tuple[int, int]] = []
            free: list[int] = []
            max_free = 0
            # Chip counters read WITHOUT the chip locks: every chip
            # mutation runs under THIS node lock (add_or_update_pod /
            # remove_pod / allocate), which we hold.
            for i, chip in self.chips.items():
                used = chip._used
                cap = chip.total_hbm
                f = cap - used if used < cap else 0
                avail.append((f, cap))
                if f > max_free:
                    max_free = f
                if used == 0 and not chip._active:
                    free.append(i)
            s = NodeSummary(
                sharing=self._sharing,
                avail=tuple(avail),
                free_chips=tuple(free),
                max_free_chip=max_free,
                chip_count=self.chip_count,
                unschedulable=self._unschedulable,
            )
            self._summary = s
            return s

    def select_compact_cached(self, s: NodeSummary,
                              k: int) -> list[int] | None:
        """``topology.select_compact`` over ``s.free_chips``, memoized
        per chip count against the summary's identity (any ledger
        mutation republishes the summary and so invalidates every
        entry). Callers must treat the result as read-only — it is the
        cached object itself, handed out to every hit."""
        ent = self.compact_memo.get(k)
        if ent is None or ent[0] is not s:
            chosen = self.topology.select_compact(list(s.free_chips), k)
            memo = self.compact_memo
            if len(memo) >= MEMO_CAP:
                memo.clear()
            ent = memo[k] = (s, chosen)
        return ent[1]

    def get_free_chips(self) -> list[int]:
        """Chips with no resident pods at all (candidates for whole-chip
        grants). O(chips): occupancy is priced at add/remove time, not
        re-derived from resident snapshots on every filter query."""
        with self._lock:
            return [
                i for i, chip in self.chips.items()
                if chip.get_used_hbm() == 0 and not chip.has_active_pods()
            ]

    def count_fits(self, pod: Pod) -> int:
        """Upper bound on how many copies of ``pod``'s request this node
        could host right now. Feeds the gang quorum-feasibility pre-check
        (an over-estimate is fine there — placement compactness is still
        enforced per member at allocate time)."""
        with self._lock:
            req_chips = podutils.get_chips_from_pod_resource(pod)
            if req_chips > 0:
                return len(self.get_free_chips()) // req_chips
            req_hbm = podutils.get_hbm_from_pod_resource(pod)
            if req_hbm <= 0:
                return 0
            return sum(v // req_hbm
                       for v in self.get_available_hbm().values())

    def count_fits_preemptable(self, pod: Pod) -> int:
        """Upper bound on the copies of ``pod``'s request this node could
        host were every resident of priority strictly below the pod's
        evicted, free capacity included: the quorum pre-check's bound for
        a priority gang, whose members can preempt their way in."""
        with self._lock:
            req_chips = podutils.get_chips_from_pod_resource(pod)
            if req_chips > 0:
                clearable = 0
                for chip in self.chips.values():
                    if all(p.priority < pod.priority
                           for p, c in chip.snapshot_contributions()
                           if c > 0 and not podutils.is_complete_pod(p)):
                        clearable += 1
                return clearable // req_chips
            req_hbm = podutils.get_hbm_from_pod_resource(pod)
            if req_hbm <= 0:
                return 0
            avail = self.get_available_hbm()
            copies = 0
            for idx, chip in self.chips.items():
                freeable = avail.get(idx, 0) + sum(
                    c for p, c in chip.snapshot_contributions()
                    if c > 0 and not podutils.is_complete_pod(p)
                    and p.priority < pod.priority)
                copies += min(freeable, chip.total_hbm) // req_hbm
            return copies

    # ------------------------------------------------------------------ #
    # Admission (reference Assume, nodeinfo.go:113-137)
    # ------------------------------------------------------------------ #

    def assume(self, pod: Pod,
               nominated: list[Pod] | None = None) -> tuple[bool, str]:
        """Can this node host the pod right now? Returns (ok, reason).

        ``nominated``: pending pods whose preemption victory earmarked
        capacity here (upstream scheduler semantics: filters run with
        higher-or-equal-priority nominated pods assumed present, so a
        preemptor's freed chips cannot be stolen in the eviction→bind
        window)."""
        relevant = [p for p in (nominated or [])
                    if p.uid != pod.uid and p.priority >= pod.priority]
        with self._lock:
            req_chips = podutils.get_chips_from_pod_resource(pod)
            if req_chips > 0:
                # Lazy views: the HBM table is only needed to apply
                # earmarks — filter is the hot path and fleets without
                # in-flight preemption must not pay for both views.
                free = set(self.get_free_chips())
                if relevant:
                    apply_nominated_demand(self.get_available_hbm(),
                                           free, relevant)
                if len(free) < req_chips:
                    return False, (
                        f"insufficient free TPU chips: want {req_chips}, "
                        f"have {len(free)}"
                    )
                return True, ""
            req_hbm = podutils.get_hbm_from_pod_resource(pod)
            if req_hbm <= 0:
                return False, "pod requests no TPU resources"
            avail = self.get_available_hbm()
            if relevant:
                apply_nominated_demand(avail,
                                       set(self.get_free_chips()),
                                       relevant)
            if any(v >= req_hbm for v in avail.values()):
                return True, ""
            return False, "insufficient TPU HBM in one chip"

    # ------------------------------------------------------------------ #
    # Placement policy (reference allocateGPUID, nodeinfo.go:209-252)
    # ------------------------------------------------------------------ #

    def pick_chips(self, pod: Pod) -> list[int]:
        """Choose chip indices for ``pod``; raises AllocationError.

        HBM pods: tightest fit — the chip with the *least* free HBM still
        ≥ the request (binpack maximizes whole-free chips, exactly the
        reference's policy); among equal fits, prefer the chip with the
        fewest free ICI neighbors so compact regions stay whole. Pods
        whose effective scoring is ``spread`` invert the fit — the
        EMPTIEST fitting chip wins (fewest co-tenants for
        latency-sensitive decode) — while keeping the same neighbor
        tie-break so pristine compact regions are still cracked last.

        Chip pods: ICI-compact set of fully-free chips.
        """
        with self._lock:
            req_chips = podutils.get_chips_from_pod_resource(pod)
            if req_chips > 0:
                free = self.get_free_chips()
                chosen = self.topology.select_compact(free, req_chips)
                if chosen is None:
                    raise AllocationError(
                        f"node {self.name}: want {req_chips} free chips, "
                        f"have {len(free)}"
                    )
                return chosen

            req_hbm = podutils.get_hbm_from_pod_resource(pod)
            if req_hbm <= 0:
                raise AllocationError("pod requests no TPU resources")
            avail = self.get_available_hbm()
            fits = {i: v for i, v in avail.items() if v >= req_hbm}
            if not fits:
                raise AllocationError(
                    f"node {self.name}: no chip has {req_hbm} GiB free"
                )
            fully_free = {i for i, v in avail.items()
                          if v >= self.chips[i].total_hbm}
            spread = podutils.effective_scoring(
                pod, default=self.default_scoring) == "spread"
            best = min(
                sorted(fits),
                key=lambda i: (
                    -fits[i] if spread else fits[i],
                    self.topology.free_neighbor_count(i, fully_free),
                    i,
                ),
            )
            return [best]

    # ------------------------------------------------------------------ #
    # Commit path (gpushare's Allocate, nodeinfo.go:139-206)
    # ------------------------------------------------------------------ #

    def allocate(self, client: Any, pod: Pod, *, bind: bool = True) -> Pod:
        """Place ``pod``, write its grant, bind it, update the ledger.

        1. pick the cards and charge them provisionally, under the lock;
        2. with the lock released, write the annotations (one retry on a
           409, against the pod as the apiserver has it) and post the
           binding;
        3. price the document the apiserver accepted, or roll the charge
           back if a write failed.

        The provisional charge keeps the two locked windows safe: a
        concurrent allocate cannot pick the held cards while the writes
        are in flight. Returns the annotated pod as accepted.

        All of it runs in the decision's ``allocate`` span, which notes
        the cards and the GiB and counts the apiserver round trips; the
        grant carries the decision's trace id and causal parent.
        """
        with trace.span("allocate", node=self.name):
            trace_id = trace.current_trace_id() or None
            trace_parent = trace.current_parent_id() or None
            with self._lock:
                chip_ids = self.pick_chips(pod)  # raises AllocationError
                if podutils.get_chips_from_pod_resource(pod) > 0:
                    hbm_pod = sum(self.chips[c].total_hbm
                                  for c in chip_ids)
                else:
                    hbm_pod = podutils.get_hbm_from_pod_resource(pod)
                hbm_chip = self.chips[chip_ids[0]].total_hbm
                provisional = podutils.updated_pod_annotation_spec(
                    pod, chip_ids, hbm_pod, hbm_chip,
                    assume_time_ns=time.time_ns(), trace_id=trace_id,
                    trace_parent=trace_parent)
                for cid in chip_ids:
                    self.chips[cid].add_pod(provisional)
            try:
                # Inside the try: the charge is live, and even a note
                # that fails must roll it back.
                trace.note("chips", list(chip_ids))
                trace.note("hbmGiB", hbm_pod)
                try:
                    new_pod = client.update_pod(provisional)
                except ConflictError:
                    fresh = client.get_pod(pod.namespace, pod.name)
                    new_pod = client.update_pod(
                        podutils.updated_pod_annotation_spec(
                            fresh, chip_ids, hbm_pod, hbm_chip,
                            assume_time_ns=time.time_ns(),
                            trace_id=trace_id, trace_parent=trace_parent))
                if bind:
                    client.bind_pod(binding_doc(new_pod, self.name))
            except BaseException:
                with self._lock:
                    for cid in chip_ids:
                        self.chips[cid].remove_pod(provisional)
                raise
            # The apiserver set spec.nodeName through the binding.
            new_pod.spec["nodeName"] = self.name
            with self._lock:
                # Same uid: re-adding replaces the provisional pricing,
                # unless a deletion seen during the unlocked writes already
                # freed it (that DELETE is consumed; nothing would free a
                # re-add).
                if any(provisional.uid in self.chips[c].pods
                       for c in chip_ids):
                    for cid in chip_ids:
                        self.chips[cid].add_pod(new_pod)
            # Rebuild the summary here, so the next filter reads it free.
            self.summary()
            log.info("allocated pod %s/%s -> node %s chips %s (%d GiB)",
                     pod.namespace, pod.name, self.name, chip_ids, hbm_pod)
            return new_pod
