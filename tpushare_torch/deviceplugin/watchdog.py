"""Grant watchdog: each tenant's reported device memory against its grant.

The port's twin of ``tpushare/deviceplugin/watchdog.py``. Tenants
heartbeat their usage into a per-pod JSON file
(:func:`tpushare_torch.runtime.torchenv.write_usage`: ``bytes_in_use`` is
the caching allocator's reserved bytes, summed over the visible cards;
the path is the ``TPUSHARE_USAGE_FILE`` that Allocate injects over a
pod-private mount). :class:`GrantWatchdog` sweeps them, compares each
tenant with the GiB the extender granted it (the pod's annotation) by the
reference's rule, used GiB above granted GiB, and publishes three ways:

- **Prometheus**: ``tpushare_hbm_used_gib{namespace,pod,node}`` and
  ``tpushare_grant_overrun{namespace,pod,node}`` (0/1), rendered in the
  text exposition format by :meth:`GrantWatchdog.render` through the
  port's one renderer, :mod:`tpushare_torch.routes.exposition` (no client
  library: the watchdog imports the standard library alone);
- **apiserver**: the ``tpushare.io/hbm-used`` and
  ``tpushare.io/grant-overrun`` pod annotations, cleared when the
  heartbeat goes stale; a Warning Event on the overrunner when it enters
  overrun, and on each innocent co-tenant of its card an Event that
  names it, so the innocent's next failed allocation is attributed;
- **policy**: opt-in eviction after ``evict_after`` consecutive overrun
  sweeps, through the PodDisruptionBudget-honoring eviction.

The heartbeat does not count the CUDA context or NCCL's buffers, which
the caching allocator does not hold: ``nvidia-smi`` charges a process
more than its heartbeat says.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time

from tpushare_torch.api.objects import Pod
from tpushare_torch.k8s import commit, events, eviction
from tpushare_torch.k8s.errors import ApiError, ConflictError
from tpushare_torch.routes.exposition import GaugeFamily
from tpushare_torch.utils import const, pod as podutils

log = logging.getLogger(__name__)

REASON_OVERRUN = "TPUShareGrantOverrun"
REASON_STARVED = "TPUShareStarvedByCoTenant"
REASON_EVICTED = "TPUShareOverrunEvicted"

GIB = 1 << 30

#: Heartbeats older than this are stale: the process restarted or died,
#: and its last bytes say nothing about the card now.
STALE_AFTER_S = 120.0

LABELS = ("namespace", "pod", "node")


class GrantWatchdog:
    """Node-local used-vs-granted comparator; runs in the device-plugin
    daemon beside the allocator whose grants it checks."""

    def __init__(self, node_name: str, client,
                 usage_dir: str = const.USAGE_DIR_DEFAULT,
                 evict_after: int = 0,
                 stale_after: float = STALE_AFTER_S,
                 now=time.time, evict_sleep=time.sleep):
        self.node_name = node_name
        self.client = client
        self.usage_dir = usage_dir
        #: 0: observe and attribute only; N > 0 evicts after N
        #: consecutive overrun sweeps (a transient spike never kills).
        self.evict_after = evict_after
        self.stale_after = stale_after
        self.now = now
        self._evict_sleep = evict_sleep
        self._evict_budget = eviction.EvictionBudget()
        self.used = GaugeFamily(
            "tpushare_hbm_used_gib",
            "Tenant-reported device memory in use (GiB), from the caching "
            "allocator's heartbeat", LABELS)
        self.overrun = GaugeFamily(
            "tpushare_grant_overrun",
            "1 while the tenant's reported usage exceeds its granted GiB",
            LABELS)
        #: uid -> consecutive overrun sweeps (the eviction counter, and
        #: the edge that fires the events).
        self._over_streak: dict[str, int] = {}
        #: (namespace, pod) label pairs exported, for the series' GC.
        self._series: set[tuple[str, str]] = set()

    # -- one sweep ------------------------------------------------------- #

    def sweep(self) -> dict:
        """Read every tenant's heartbeat, publish, and return the sweep's
        document."""
        pods = [p for p in self.client.list_pods(node_name=self.node_name)
                if p.node_name == self.node_name
                and podutils.is_assigned_non_terminated(p)]
        tenants: list[dict] = []
        overruns: list[dict] = []
        live_series: set[tuple[str, str]] = set()
        for pod in pods:
            granted = podutils.pod_used_hbm(pod)
            if granted <= 0:
                continue  # whole-card pods own their cards
            snap = self._read_heartbeat(pod.uid)
            entry = {
                "namespace": pod.namespace, "pod": pod.name,
                "uid": pod.uid, "granted_gib": granted,
                "chips": podutils.get_chip_ids_from_annotation(pod),
            }
            if snap is None:
                entry["used_gib"] = None
                self._over_streak.pop(pod.uid, None)
                # A stale heartbeat says nothing now: the gauges go below
                # and the pod's last usage annotations go too.
                self._clear_annotations(pod)
                tenants.append(entry)
                continue
            used_gib = snap["bytes_in_use"] / GIB
            peak_gib = snap["peak_bytes"] / GIB
            entry["used_gib"] = round(used_gib, 2)
            entry["peak_gib"] = round(peak_gib, 2)
            over = used_gib > granted
            entry["overrun"] = over
            labels = (pod.namespace, pod.name)
            live_series.add(labels)
            self.used.set((*labels, self.node_name), round(used_gib, 3))
            self.overrun.set((*labels, self.node_name), 1 if over else 0)
            streak = self._over_streak.get(pod.uid, 0)
            if over:
                self._over_streak[pod.uid] = streak + 1
                if streak == 0:
                    self._emit_overrun(pod, used_gib, peak_gib, granted,
                                       pods)
            else:
                self._over_streak.pop(pod.uid, None)
            self._annotate(pod, used_gib, over)
            tenants.append(entry)
            if over:
                overruns.append(entry)
        evicted = self._maybe_evict(pods)
        self._gc_series(live_series)
        live_uids = {p.uid for p in pods}
        for uid in [u for u in self._over_streak if u not in live_uids]:
            self._over_streak.pop(uid, None)
        return {"node": self.node_name, "tenants": tenants,
                "overruns": overruns, "evicted": evicted}

    def run(self, stop: threading.Event, interval: float = 10.0) -> None:
        """The daemon's sweep loop: a failed sweep is logged and the next
        one runs (the watchdog never stops the allocator)."""
        while not stop.wait(interval):
            try:
                self.sweep()
            except Exception:  # noqa: BLE001
                log.exception("grant-watchdog sweep failed")

    def render(self) -> bytes:
        """Both gauge families in the Prometheus text format."""
        return (self.used.render() + self.overrun.render()).encode()

    # -- pieces ---------------------------------------------------------- #

    def usage_path(self, uid: str) -> str:
        # Allocate mounts usage_dir/<uid> alone into the pod: no tenant
        # can write, or delete, another's heartbeat.
        return os.path.join(self.usage_dir, uid, "usage.json")

    def _read_heartbeat(self, uid: str) -> dict | None:
        try:
            with open(self.usage_path(uid), encoding="utf-8") as f:
                snap = json.load(f)
            if self.now() - float(snap.get("ts", 0)) > self.stale_after:
                return None
            return {"bytes_in_use": int(snap["bytes_in_use"]),
                    "peak_bytes": int(snap.get("peak_bytes",
                                               snap["bytes_in_use"])),
                    "ts": float(snap.get("ts", 0))}
        except (OSError, ValueError, TypeError, KeyError):
            return None

    def _emit_overrun(self, pod: Pod, used: float, peak: float,
                      granted: int, pods: list[Pod]) -> None:
        """A Warning on the overrunner, and on every co-tenant of its
        cards an Event that names it."""
        chips = set(podutils.get_chip_ids_from_annotation(pod))
        events.record(
            self.client, pod, REASON_OVERRUN,
            f"HBM grant overrun: using {used:.1f} GiB "
            f"(peak {peak:.1f}) of {granted} GiB granted on "
            f"card(s) {sorted(chips)}; co-tenant allocations on these "
            f"cards may fail because of this pod", event_type="Warning")
        log.warning("grant overrun: %s using %.1f GiB of %d granted",
                    pod.key(), used, granted)
        for other in pods:
            if other.uid == pod.uid or podutils.pod_used_hbm(other) <= 0:
                continue
            shared = chips & set(
                podutils.get_chip_ids_from_annotation(other))
            if not shared:
                continue
            events.record(
                self.client, other, REASON_STARVED,
                f"co-tenant {pod.namespace}/{pod.name} exceeds its HBM "
                f"grant ({used:.1f} of {granted} GiB) on shared card(s) "
                f"{sorted(shared)}; allocation failures on this pod are "
                f"attributable to it", event_type="Warning")

    def _annotate(self, pod: Pod, used_gib: float, over: bool) -> None:
        """Used-vs-granted on the pod, written only when it changed (a
        write every sweep from every node would storm the apiserver)."""
        want_used = f"{used_gib:.1f}"
        want_over = const.ASSIGNED_TRUE if over else None
        if (pod.annotations.get(const.ANN_HBM_USED) == want_used
                and pod.annotations.get(const.ANN_OVERRUN) == want_over):
            return

        def apply(ann: dict) -> None:
            ann[const.ANN_HBM_USED] = want_used
            if over:
                ann[const.ANN_OVERRUN] = const.ASSIGNED_TRUE
            else:
                ann.pop(const.ANN_OVERRUN, None)
        self._update_annotations(pod, apply)

    def _clear_annotations(self, pod: Pod) -> None:
        """Withdraw the usage claims of a pod with no fresh heartbeat."""
        if (const.ANN_HBM_USED not in pod.annotations
                and const.ANN_OVERRUN not in pod.annotations):
            return

        def apply(ann: dict) -> None:
            ann.pop(const.ANN_HBM_USED, None)
            ann.pop(const.ANN_OVERRUN, None)
        self._update_annotations(pod, apply)

    def _update_annotations(self, pod: Pod, apply) -> None:
        """``apply`` to a fresh read of ``pod``'s annotations and commit;
        a conflict waits for the next sweep, any other failure is logged
        (telemetry never breaks the node)."""
        try:
            fresh = self.client.get_pod(pod.namespace, pod.name)
            if fresh is None or fresh.uid != pod.uid:
                return
            apply(fresh.raw.setdefault("metadata", {}).setdefault(
                "annotations", {}))
            commit.committed_update_pod(self.client, fresh)
        except ConflictError:
            pass
        except Exception:  # noqa: BLE001
            log.debug("usage annotation update failed for %s", pod.key(),
                      exc_info=True)

    def _maybe_evict(self, pods: list[Pod]) -> list[str]:
        """After ``evict_after`` consecutive overrun sweeps, evict the
        overrunner so its card's memory goes back to the tenants that
        keep their grants."""
        if self.evict_after <= 0:
            return []
        evicted = []
        by_uid = {p.uid: p for p in pods}
        for uid, streak in list(self._over_streak.items()):
            if streak < self.evict_after:
                continue
            pod = by_uid.get(uid)
            if pod is None:
                self._over_streak.pop(uid, None)
                continue
            try:
                # The eviction subresource, not a bare DELETE: the
                # apiserver honors PodDisruptionBudgets. A pod still
                # BLOCKED keeps its streak and the next sweep retries.
                status = eviction.evict_with_retry(
                    self.client, pod.namespace, pod.name,
                    budget=self._evict_budget, node=self.node_name,
                    sleep=self._evict_sleep)
                if status == eviction.EVICTED:
                    self._evicted(pod, streak, evicted, "")
                elif status == eviction.BLOCKED:
                    log.warning("eviction of %s blocked by a "
                                "PodDisruptionBudget; will retry",
                                pod.key())
            except ApiError as e:
                if e.status not in (403, 405):
                    log.warning("eviction of %s failed (%s)", pod.key(), e)
                    continue
                # No pods/eviction rule in the RBAC, or no subresource:
                # fall back to a bare DELETE, loudly, as it bypasses
                # PodDisruptionBudgets.
                log.error("pods/eviction unavailable for %s (%s); falling "
                          "back to DELETE (PDBs BYPASSED)", pod.key(), e)
                try:
                    self.client.delete_pod(pod.namespace, pod.name)
                    self._evicted(pod, streak, evicted,
                                  " (DELETE fallback, PDBs bypassed)")
                except Exception:  # noqa: BLE001
                    log.exception("fallback deletion of %s failed",
                                  pod.key())
            except Exception:  # noqa: BLE001
                log.exception("eviction of %s failed", pod.key())
        return evicted

    def _evicted(self, pod: Pod, streak: int, evicted: list[str],
                 how: str) -> None:
        evicted.append(pod.uid)
        log.warning("evicted overrunning pod %s%s", pod.key(), how)
        events.record(
            self.client, pod, REASON_EVICTED,
            f"evicting{how}: HBM grant overrun persisted for {streak} "
            f"consecutive sweeps (policy TPUSHARE_EVICT_OVERRUN)",
            event_type="Warning")
        self._over_streak.pop(pod.uid, None)

    def _gc_series(self, live: set[tuple[str, str]]) -> None:
        """Drop the series of pods that are gone."""
        for namespace, name in self._series - live:
            self.used.remove((namespace, name, self.node_name))
            self.overrun.remove((namespace, name, self.node_name))
        self._series = live
