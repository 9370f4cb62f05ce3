"""Prioritize (score) verb: cross-node tightest fit.

The port's copy of ``tpushare/scheduler/prioritize.py`` for pods outside
a gang. gpushare registered no prioritize verb, so after its filter the
default scheduler spread shared pods across the fleet; this verb steers
the choice between nodes with the policy that packs cards within one.
Scores are 0-10 (the scheduler multiplies them by the extender's
weight):

* HBM pods: the node whose best-fitting card leaves the least free HBM
  scores highest (``binpack``); under ``spread`` the emptiest fitting
  card wins, node emptiness breaking ties.
* Whole-card pods: the tightest card-count fit, plus a compactness bonus
  when the would-be selection is adjacent on the node's topology.
* Gang HBM members: +1 on nodes already holding a reserved member of the
  same group (fewer hosts, fewer network crossings).
* Gang whole-card members: a slice-affinity bonus on hosts of a slice
  already holding a reserved member (more when adjacent to one on the
  host grid), and, for a slice-shape gang, the top score on every host
  of the block the gang planner elected.

A lone pod takes the fast path over the admission summaries. With a
quota ledger, every feasible node's score moves by the tenant's standing:
+1 while it asks within its guarantee, -1 once it borrows beyond it
(the elected block of a slice-shape gang excepted).
"""

from __future__ import annotations

import logging
import statistics
from typing import Any

from tpushare_torch.api.extender import ExtenderArgs, HostPriority
from tpushare_torch.api.objects import Pod
from tpushare_torch.cache.cache import SchedulerCache
from tpushare_torch.cache.nodeinfo import MEMO_CAP, NodeInfo, NodeSummary
from tpushare_torch.utils import const
from tpushare_torch.utils import node as nodeutils
from tpushare_torch.utils import pod as podutils

log = logging.getLogger(__name__)

MAX_SCORE = 10


class Prioritize:
    name = "tpushare-prioritize"

    def __init__(self, cache: SchedulerCache, gang_planner: Any = None,
                 policy: str = "binpack", quota: Any = None) -> None:
        """``policy``: ``"binpack"`` (default: tightest fit, keeping whole
        cards free for multi-card pods) or ``"spread"`` (the emptiest
        placement wins: fewer co-tenants a card for latency-sensitive
        inference). The gang bonuses apply under both. ``quota``: a
        QuotaManager whose ``score_adjust`` biases the scores."""
        if policy not in const.SCORING_POLICIES:
            raise ValueError(
                f"unknown scoring policy {policy!r}; expected "
                f"one of {const.SCORING_POLICIES}")
        self.cache = cache
        self.gang_planner = gang_planner
        self.policy = policy
        self.quota = quota

    def _policy_for(self, pod: Pod) -> str:
        """The pod's ``tpushare.io/scoring`` annotation when valid, else
        the fleet default; the chip picker reads the same."""
        override = pod.annotations.get(const.ANN_SCORING, "")
        if override and override not in const.SCORING_POLICIES:
            log.debug("pod %s/%s: ignoring unknown %s=%r",
                      pod.namespace, pod.name, const.ANN_SCORING,
                      override)
        return podutils.effective_scoring(pod, default=self.policy)

    # -- per-node scoring ------------------------------------------------- #

    @staticmethod
    def _score_hbm_avail(avail: tuple[tuple[int, int], ...], req: int,
                         policy: str) -> int | None:
        """The HBM fit score from a per-card ``(free, cap)`` view, fed by
        a live ledger walk or by the admission summary alike. ``None``
        when no card fits at all."""
        fits = [(f, c) for f, c in avail if f >= req]
        if not fits:
            return None
        if policy == "binpack":
            # The card the node's picker takes: the tightest fit.
            # waste 0 -> 10; waste a whole pristine card -> 0.
            free, cap = min(fits)
            waste = free - req
            fit = 1.0 - ((waste / cap) if cap else 0.0)
            score = round(MAX_SCORE * fit)
        else:
            # Spread: the emptiest fitting card first, the node's mean
            # emptiness to break the many ties; int() keeps the second
            # term from erasing itself at the top of the scale. Cards of
            # no capacity are left out (a request of 0 on a malformed
            # node).
            nz_fits = [(f, c) for f, c in fits if c]
            nz_caps = [(f, c) for f, c in avail if c]
            if not nz_fits or not nz_caps:
                return None
            best = max((f - req) / c for f, c in nz_fits)
            emptiness = statistics.fmean(f / c for f, c in nz_caps)
            score = int(MAX_SCORE * (0.8 * best + 0.2 * emptiness))
        return score

    def _score_hbm(self, info: NodeInfo, req: int, gang_nodes: set[str],
                   policy: str) -> int:
        avail = info.get_available_hbm()
        score = self._score_hbm_avail(
            tuple((avail[i], info.chips[i].total_hbm) for i in avail),
            req, policy)
        if score is None:
            return 0
        if gang_nodes and info.name in gang_nodes and score < MAX_SCORE:
            score += 1  # consolidate a gang's slices onto fewer hosts
        return max(0, min(MAX_SCORE, score))

    def _score_chips(self, info: NodeInfo, req: int,
                     member_slices: dict | None, policy: str,
                     elected: frozenset[str] | None = None,
                     s: NodeSummary | None = None) -> int:
        # The compact selection is memoized against the summary's
        # identity (NodeInfo.select_compact_cached).
        if s is None:
            s = info._summary
            if s is None:
                s = info.summary()
        free_n = len(s.free_chips)
        if free_n < req or info.chip_count == 0:
            return 0
        leftover = free_n - req
        # binpack: an exact pack -> 8, cracking a pristine host -> low;
        # spread: the emptiest host wins.
        fit = leftover / info.chip_count
        if policy == "binpack":
            fit = 1.0 - fit
        score = round((MAX_SCORE - 2) * fit)
        chosen = info.select_compact_cached(s, req)
        if chosen and len(chosen) > 1:
            pairs = len(chosen) * (len(chosen) - 1) / 2
            mean_dist = info.topology.dispersion(chosen) / pairs
            if mean_dist <= 1.5:       # essentially adjacent
                score += 2
            elif mean_dist <= 2.5:
                score += 1
        elif chosen:
            score += 2  # a single card is trivially compact
        if elected:
            # A slice-shape gang member: every host of the elected block
            # scores the top flat (the gang takes the whole block and
            # bind steers each member to its ring slot), so no host off
            # the block can tie it; those keep the slice-affinity order
            # below it.
            if info.name in elected:
                return MAX_SCORE
            return max(0, min(MAX_SCORE - 1, self._affinity(
                score, info, member_slices)))
        if member_slices:
            score = self._affinity(score, info, member_slices)
        return max(0, min(MAX_SCORE, score))

    @staticmethod
    def _affinity(score: int, info: NodeInfo,
                  member_slices: dict | None) -> int:
        """The slice-affinity term. The fit and compactness part is capped
        two below the top first, so the bonus can still tell an exact
        whole-host pack on the member's slice from one off it."""
        if not member_slices:
            return score
        score = min(score, MAX_SCORE - 2)
        # Hosts of one slice share ICI, hosts of two slices only the
        # network; within the slice, a host next to a member beats a far
        # one.
        sid = nodeutils.get_slice_id(info.node)
        if sid and sid in member_slices:
            bonus = 2
            member_coords = member_slices[sid]
            pos = nodeutils.host_position(info.node)
            if member_coords and pos is not None:
                coords, grid = pos
                d = min(grid.distance_coords(coords, mc)
                        for mc in member_coords)
                bonus = 2 if d <= 1 else 1
            score += bonus
        return score

    def _member_slices(self, gang_nodes: set[str]) -> dict:
        """slice id -> the host coords of the nodes holding a reserved
        member of the gang there (an empty tuple when their grid position
        is unknown: flat slice affinity then)."""
        placement: dict[str, tuple] = {}
        for name in gang_nodes:
            info = self.cache.get_node_info(name)
            if info is None:
                continue
            sid = nodeutils.get_slice_id(info.node)
            if not sid:
                continue
            coords = placement.setdefault(sid, ())
            pos = nodeutils.host_position(info.node)
            if pos is not None:
                placement[sid] = coords + (pos[0],)
        return placement

    def score_node(self, pod: Pod, node_name: str,
                   gang_nodes: set[str]) -> int:
        """One node's score (tests); ``handle`` parses the request once
        for all the candidates."""
        req_chips = podutils.get_chips_from_pod_resource(pod)
        req_hbm = podutils.get_hbm_from_pod_resource(pod)
        return self._score_one(node_name, req_chips, req_hbm, gang_nodes,
                               self._member_slices(gang_nodes),
                               policy=self._policy_for(pod),
                               elected=self._elected_for(pod, req_chips))

    def _elected_for(self, pod: Pod, req_chips: int) -> frozenset[str]:
        """The elected hosts of a slice-shape whole-card gang member's
        group (empty otherwise); memoized a gang by the planner."""
        if (self.gang_planner is None or req_chips <= 0
                or not podutils.is_gang_pod(pod)
                or podutils.get_slice_shape(pod) is None):
            return frozenset()
        return self.gang_planner.elected_hosts(pod)

    def _score_one(self, node_name: str, req_chips: int, req_hbm: int,
                   gang_nodes: set[str], member_slices: dict | None,
                   policy: str,
                   elected: frozenset[str] | None = None) -> int:
        info = self.cache.get_node_info(node_name)
        if info is None:
            return 0
        if req_chips > 0:
            return self._score_chips(info, req_chips, member_slices,
                                     policy=policy, elected=elected)
        if req_hbm <= 0:
            return 0
        return self._score_hbm(info, req_hbm, gang_nodes, policy=policy)

    def snapshot(self) -> dict[str, NodeInfo]:
        """The ledger view :meth:`handle` reads, taken once by the HTTP
        micro-batch gate for all the requests it coalesces."""
        return self.cache.node_table()

    def handle(self, args: ExtenderArgs,
               table: dict[str, NodeInfo] | None = None,
               ) -> list[HostPriority]:
        pod = args.pod
        names = args.candidate_names()
        if not (podutils.is_tpu_sharing_pod(pod)
                or podutils.is_tpu_chip_pod(pod)):
            # Not ours: neutral scores leave the scheduler's ranking.
            return [HostPriority(host=n, score=0) for n in names]
        req_chips = podutils.get_chips_from_pod_resource(pod)
        req_hbm = podutils.get_hbm_from_pod_resource(pod)
        gang_nodes: set[str] = set()
        member_slices: dict = {}
        elected: frozenset[str] = frozenset()
        if self.gang_planner is not None and podutils.is_gang_pod(pod):
            gang_nodes = self.gang_planner.member_nodes(pod)
            if req_chips > 0 and gang_nodes:
                member_slices = self._member_slices(gang_nodes)
            elected = self._elected_for(pod, req_chips)
        policy = self._policy_for(pod)
        if gang_nodes or member_slices or elected:
            # A gang member's bonuses are facts of each node the summary
            # does not carry: the full path.
            out = [HostPriority(host=n, score=self._score_one(
                       n, req_chips, req_hbm, gang_nodes, member_slices,
                       policy=policy, elected=elected))
                   for n in names]
        else:
            # Lone pods: score from the admission summaries, memoized a
            # node a request shape against the summary's identity, so a
            # node's score is computed again only when its own ledger
            # changed.
            if table is None:
                table = self.cache.node_table()
            shape = (req_chips, req_hbm, policy)
            out = []
            for n in names:
                info = table.get(n)
                if info is None:
                    out.append(HostPriority(host=n, score=self._score_one(
                        n, req_chips, req_hbm, gang_nodes, member_slices,
                        policy)))
                    continue
                s = info._summary
                if s is None:
                    s = info.summary()
                ent = info.score_memo.get(shape)
                if ent is None or ent[0] is not s:
                    if req_chips > 0:
                        score = self._score_chips(info, req_chips, None,
                                                  policy, s=s)
                    elif req_hbm <= 0:
                        score = 0
                    else:
                        base = self._score_hbm_avail(s.avail, req_hbm,
                                                     policy)
                        score = (0 if base is None
                                 else max(0, min(MAX_SCORE, base)))
                    memo = info.score_memo
                    if len(memo) >= MEMO_CAP:
                        memo.clear()
                    ent = memo[shape] = (s, score)
                out.append(HostPriority(host=n, score=ent[1]))
        if self.quota is not None and not elected:
            adjust = self.quota.score_adjust(pod)
            if adjust:
                # Only feasible nodes move: a zero means "cannot host".
                out = [HostPriority(host=e.host,
                                    score=min(max(e.score + adjust, 1),
                                              MAX_SCORE))
                       if e.score > 0 else e
                       for e in out]
        if log.isEnabledFor(logging.DEBUG):
            log.debug("prioritize pod %s: %s", pod.key(),
                      {e.host: e.score for e in out})
        return out
