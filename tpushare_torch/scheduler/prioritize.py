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

The gang planner's consolidation, slice-affinity and contiguity bonuses,
and the quota's fairness nudge, come with their own slices.
"""

from __future__ import annotations

import logging
import statistics

from tpushare_torch.api.extender import ExtenderArgs, HostPriority
from tpushare_torch.api.objects import Pod
from tpushare_torch.cache.cache import SchedulerCache
from tpushare_torch.cache.nodeinfo import MEMO_CAP, NodeInfo, NodeSummary
from tpushare_torch.utils import const
from tpushare_torch.utils import pod as podutils

log = logging.getLogger(__name__)

MAX_SCORE = 10


class Prioritize:
    name = "tpushare-prioritize"

    def __init__(self, cache: SchedulerCache,
                 policy: str = "binpack") -> None:
        """``policy``: ``"binpack"`` (default: tightest fit, keeping whole
        cards free for multi-card pods) or ``"spread"`` (the emptiest
        placement wins: fewer co-tenants a card for latency-sensitive
        inference)."""
        if policy not in const.SCORING_POLICIES:
            raise ValueError(
                f"unknown scoring policy {policy!r}; expected "
                f"one of {const.SCORING_POLICIES}")
        self.cache = cache
        self.policy = policy

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

    def _score_hbm(self, info: NodeInfo, req: int, policy: str) -> int:
        avail = info.get_available_hbm()
        score = self._score_hbm_avail(
            tuple((avail[i], info.chips[i].total_hbm) for i in avail),
            req, policy)
        if score is None:
            return 0
        return max(0, min(MAX_SCORE, score))

    def _score_chips(self, info: NodeInfo, req: int, policy: str,
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
        return max(0, min(MAX_SCORE, score))

    def _score_one(self, node_name: str, req_chips: int, req_hbm: int,
                   policy: str) -> int:
        info = self.cache.get_node_info(node_name)
        if info is None:
            return 0
        if req_chips > 0:
            return self._score_chips(info, req_chips, policy)
        if req_hbm <= 0:
            return 0
        return self._score_hbm(info, req_hbm, policy)

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
        policy = self._policy_for(pod)
        # Score from the admission summaries, memoized a node a request
        # shape against the summary's identity: a node's score is
        # computed again only when its own ledger changed.
        if table is None:
            table = self.cache.node_table()
        shape = (req_chips, req_hbm, policy)
        out = []
        for n in names:
            info = table.get(n)
            if info is None:
                out.append(HostPriority(host=n, score=self._score_one(
                    n, req_chips, req_hbm, policy)))
                continue
            s = info._summary
            if s is None:
                s = info.summary()
            ent = info.score_memo.get(shape)
            if ent is None or ent[0] is not s:
                if req_chips > 0:
                    score = self._score_chips(info, req_chips, policy, s=s)
                elif req_hbm <= 0:
                    score = 0
                else:
                    base = self._score_hbm_avail(s.avail, req_hbm, policy)
                    score = (0 if base is None
                             else max(0, min(MAX_SCORE, base)))
                memo = info.score_memo
                if len(memo) >= MEMO_CAP:
                    memo.clear()
                ent = memo[shape] = (s, score)
            out.append(HostPriority(host=n, score=ent[1]))
        if log.isEnabledFor(logging.DEBUG):
            log.debug("prioritize pod %s: %s", pod.key(),
                      {e.host: e.score for e in out})
        return out
