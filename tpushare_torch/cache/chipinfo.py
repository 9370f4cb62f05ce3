"""One card's entry of the ledger.

The port's copy of ``tpushare/cache/chipinfo.py``: one card (a TPU chip
in the reference's words), its HBM GiB, and its resident pods. Capacity
is per card, and a card held whole by a multi-card pod counts its full
capacity as used whatever the pod's aggregate grant.
"""

from __future__ import annotations

from typing import Callable

from tpushare_torch.api.objects import Pod
from tpushare_torch.utils import pod as podutils
from tpushare_torch.utils import locks


class ChipInfo:
    """One card's allocation state."""

    def __init__(self, idx: int, total_hbm: int,
                 on_change: Callable[[], None] | None = None) -> None:
        self.idx = idx
        self.total_hbm = total_hbm
        #: Called after every change of the resident set, with the card's
        #: lock held; the owning NodeInfo drops its cached summary there.
        #: Every change runs under the node's lock too.
        self._on_change = on_change
        self._lock = locks.TracingRLock(f"chip/{idx}")
        self.pods: dict[str, Pod] = locks.guarded_dict(
            self._lock, f"ChipInfo({idx}).pods")  # uid -> Pod
        self._contrib: dict[str, int] = locks.guarded_dict(
            self._lock, f"ChipInfo({idx})._contrib")  # uid -> GiB counted
        self._used = 0
        #: uids priced as active (not complete) when added: a set, not a
        #: counter, so it cannot drift if a stored pod is mutated.
        self._active: set[str] = locks.guarded_set(
            self._lock, f"ChipInfo({idx})._active")

    def _contribution(self, pod: Pod) -> int:
        """What ``pod`` pins on this card: nothing once complete (a pod
        being deleted included), the card's whole capacity for a pod that
        holds several cards, else its grant."""
        if podutils.is_complete_pod(pod):
            return 0
        if len(podutils.get_chip_ids_from_annotation(pod)) > 1:
            return self.total_hbm
        return podutils.pod_used_hbm(pod)

    def add_pod(self, pod: Pod) -> None:
        """Register ``pod`` as resident; adding a newer document of the
        same pod prices it again."""
        with self._lock:
            self.pods[pod.uid] = pod
            if podutils.is_complete_pod(pod):
                self._active.discard(pod.uid)
            else:
                self._active.add(pod.uid)
            self._used -= self._contrib.get(pod.uid, 0)
            self._contrib[pod.uid] = self._contribution(pod)
            self._used += self._contrib[pod.uid]
            if self._on_change is not None:
                self._on_change()

    def remove_pod(self, pod: Pod) -> None:
        with self._lock:
            if self.pods.pop(pod.uid, None) is not None:
                self._active.discard(pod.uid)
                self._used -= self._contrib.pop(pod.uid, 0)
                if self._on_change is not None:
                    self._on_change()

    def has_active_pods(self) -> bool:
        with self._lock:
            return bool(self._active)

    def get_used_hbm(self) -> int:
        """GiB committed on this card, priced at add and remove."""
        with self._lock:
            return self._used

    def snapshot_pods(self) -> list[Pod]:
        with self._lock:
            return list(self.pods.values())

    def snapshot_contributions(self) -> list[tuple[Pod, int]]:
        """(pod, GiB it pins on this card) for every resident pod, as the
        ledger priced it: what evicting it would free."""
        with self._lock:
            return [(p, self._contrib.get(uid, 0))
                    for uid, p in self.pods.items()]

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"ChipInfo(idx={self.idx}, "
                f"hbm={self.get_used_hbm()}/{self.total_hbm})")
