"""The device plugin for NVIDIA cards: what a node advertises, whose
container ``Allocate`` is serving, and what it hands that container.

Port of ``tpushare/deviceplugin/plugin.py``. The device side
(``hbm_devices``, ``chip_devices``, ``chip_health`` and
``build_allocation``) is plain functions over a
:class:`~tpushare_torch.deviceplugin.discovery.HostInventory`;
:class:`TPUSharePlugin` is the node-local half of the two-phase commit
around them, with the reference's behaviour:

* **Advertise.** One virtual device per GiB of each card
  (``tpushare.io/tpu-hbm``) and one per whole card
  (``tpushare.io/tpu-chip``); :meth:`TPUSharePlugin.annotate_node`
  publishes the per-card GiB, the model and the slice on the Node.
* **Allocate.** kubelet hands the plugin an opaque set of device ids and
  no pod. The plugin finds the pod itself: an assumed, not yet assigned
  pod on this node with an unserved container limit of the allocation's
  size, the earliest assume time first. It commits ``assigned=true`` once
  the pod's whole request is served, and returns
  :func:`build_allocation`'s response for the extender's cards.
* **Partial grants.** kubelet calls Allocate once a container. What a
  multi-container pod was served so far is checkpointed in
  ``<state_dir>/tpushare_grants.json``, the reference's file format, so
  a plugin restart between two containers serves the next span.

**The container contract.** A grant names cards by their *host* index
(``/dev/nvidia<N>``, N the minor number). The allocation emits:

* ``TPUSHARE_CHIP_IDX`` (host indices), ``TPUSHARE_HBM_POD_GIB`` and
  ``TPUSHARE_HBM_CHIP_GIB``, as the reference does: the grant watchdog
  and the annotations read host indices;
* ``NVIDIA_VISIBLE_DEVICES``: the same host indices, for the NVIDIA
  container runtime, which exposes only those cards;
* ``CUDA_VISIBLE_DEVICES`` = ``0,…,k-1``: the runtime numbers the cards
  it exposes from 0 inside the container, so a tenant granted host card 3
  sees it as CUDA ordinal 0. This takes the place of the reference's
  ``TPU_VISIBLE_CHIPS`` and process bounds (a TPU chip keeps its host
  name ``/dev/accelN`` inside the container; an NVIDIA card does not).
  Because it is set, ``torchenv.configure`` leaves it alone.

No ``XLA_PYTHON_CLIENT_MEM_FRACTION``: the tenant computes the same cap
from the grant (``torchenv.memory_fraction``). Gang members get
``TPUSHARE_POD_GROUP`` and ``TPUSHARE_POD_GROUP_SIZE``; an HBM slice gets
``TPUSHARE_USAGE_FILE`` and its pod-private heartbeat mount. Devices: the
granted cards' nodes, then whichever of ``nvidiactl``, ``nvidia-uvm``
and ``nvidia-uvm-tools`` exist under the devfs root, which every CUDA
process opens.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time

from tpushare_torch.api.objects import Pod
from tpushare_torch.deviceplugin.discovery import HostInventory
from tpushare_torch.k8s import commit
from tpushare_torch.k8s.errors import ConflictError
from tpushare_torch.utils import const, pod as podutils
from tpushare_torch.utils import locks

log = logging.getLogger(__name__)

#: How a virtual HBM-GiB device is named: card index + GiB ordinal within
#: the card (the reference's format).
HBM_DEV_FMT = "tpushare-hbm-{chip:02d}-{gib:03d}"
CHIP_DEV_FMT = "tpushare-chip-{chip:02d}"

HEALTHY = "Healthy"
UNHEALTHY = "Unhealthy"

#: The NVIDIA kernel module's control nodes a CUDA process opens besides
#: its card's.
CONTROL_NODES = ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools")


@dataclasses.dataclass(frozen=True)
class VirtualDevice:
    id: str
    health: str = HEALTHY
    numa_node: int = -1


@dataclasses.dataclass(frozen=True)
class ContainerAllocation:
    """What one container gets back from Allocate()."""

    envs: dict[str, str]
    devices: tuple[tuple[str, str], ...]  # (host_path, container_path)
    annotations: dict[str, str]
    #: (host_path, container_path, read_only): the usage-heartbeat dir.
    mounts: tuple[tuple[str, str, bool], ...] = ()


def chip_health(device_path: str) -> str:
    """Healthy while the card's device node exists (a synthetic
    inventory's ``/fake`` paths always are)."""
    if not device_path or device_path.startswith("/fake"):
        return HEALTHY
    return HEALTHY if os.path.exists(device_path) else UNHEALTHY


def hbm_devices(inv: HostInventory) -> list[VirtualDevice]:
    """One virtual device per GiB of each card's memory."""
    devs = []
    for chip in inv.chips:
        health = chip_health(chip.device_path)
        devs.extend(VirtualDevice(
            id=HBM_DEV_FMT.format(chip=chip.index, gib=gib), health=health,
            numa_node=chip.numa_node) for gib in range(chip.hbm_gib))
    return devs


def chip_devices(inv: HostInventory) -> list[VirtualDevice]:
    """One device per whole card."""
    return [VirtualDevice(id=CHIP_DEV_FMT.format(chip=c.index),
                          health=chip_health(c.device_path),
                          numa_node=c.numa_node)
            for c in inv.chips]


def _device_nodes(inv: HostInventory, chip_ids: list[int],
                  devfs_root: str) -> tuple[tuple[str, str], ...]:
    nodes = []
    for cid in chip_ids:
        chip = inv.chip(cid)
        path = (chip.device_path if chip
                else os.path.join(devfs_root, f"nvidia{cid}"))
        nodes.append((path, path))
    for name in CONTROL_NODES:
        path = os.path.join(devfs_root, name)
        if os.path.exists(path):
            nodes.append((path, path))
    return tuple(nodes)


def _chip_envs(chip_ids: list[int]) -> dict[str, str]:
    return {
        const.ENV_NVIDIA_VISIBLE_DEVICES: ",".join(map(str, chip_ids)),
        const.ENV_CUDA_VISIBLE_DEVICES: ",".join(
            str(i) for i in range(len(chip_ids))),
    }


def build_allocation(inv: HostInventory, chip_ids: list[int],
                     granted_gib: int, *, pod_uid: str,
                     group: str | None = None, group_size: int = 0,
                     whole_chips: bool = False,
                     usage_dir: str = const.USAGE_DIR_DEFAULT,
                     devfs_root: str = "/dev") -> ContainerAllocation:
    """The response to ``Allocate`` for one container granted
    ``granted_gib`` GiB on the host cards ``chip_ids`` (every GiB of them
    for ``whole_chips``). ``usage_dir`` "" turns the heartbeat contract
    off; otherwise an HBM slice's pod directory is made under it."""
    chip = inv.chip(chip_ids[0]) if chip_ids else None
    hbm_chip = chip.hbm_gib if chip else 0
    envs = {
        const.ENV_CHIP_IDX: ",".join(map(str, chip_ids)),
        const.ENV_HBM_POD: str(granted_gib),
        const.ENV_HBM_CHIP: str(hbm_chip),
        **_chip_envs(chip_ids),
    }
    if group:
        envs[const.ENV_POD_GROUP] = group
        envs[const.ENV_POD_GROUP_SIZE] = str(group_size)
    mounts: tuple[tuple[str, str, bool], ...] = ()
    if usage_dir and not whole_chips:
        # Each pod gets only its own subdirectory mounted (same path
        # inside and out): the shared directory would let a tenant forge
        # or destroy its neighbours' heartbeats and frame an innocent pod.
        pod_dir = os.path.join(usage_dir, pod_uid)
        os.makedirs(pod_dir, exist_ok=True)
        # World-writable on purpose: a tenant on a runAsNonRoot fleet
        # must write usage.json, and Allocate cannot know the pod's
        # runAsUser. The directory is mounted into this pod alone.
        os.chmod(pod_dir, 0o777)
        envs[const.ENV_USAGE_FILE] = os.path.join(pod_dir, "usage.json")
        mounts = ((pod_dir, pod_dir, False),)
    log.info("allocated cards %s (%d GiB) to pod %s", chip_ids, granted_gib,
             pod_uid)
    return ContainerAllocation(
        envs=envs, devices=_device_nodes(inv, chip_ids, devfs_root),
        annotations={const.ANN_CHIP_IDX: ",".join(map(str, chip_ids))},
        mounts=mounts)


class AllocateError(Exception):
    pass


#: Name of the partial-grant checkpoint in the plugin's state directory.
STATE_FILE = "tpushare_grants.json"


class TPUSharePlugin:
    """The node-local half of the two-phase commit protocol.

    The reference's class of the same name, with NVIDIA's allocation
    (:func:`build_allocation`, whose devices are found under
    ``devfs_root``). It has no ``headroom``: no memory-fraction env is
    emitted, the tenant computes its cap from the grant. A
    :class:`~tpushare_torch.utils.locks.TracingRLock` serializes the
    RPCs."""

    def __init__(self, node_name: str, client, inventory: HostInventory,
                 state_dir: str | None = None,
                 usage_dir: str = const.USAGE_DIR_DEFAULT,
                 devfs_root: str = "/dev"):
        self.node_name = node_name
        self.client = client
        self.inventory = inventory
        #: Heartbeat directory of HBM-slice tenants ("" turns the usage
        #: contract off).
        self.usage_dir = usage_dir
        self.devfs_root = devfs_root
        #: uid -> container grant sizes served so far (GiB, or card
        #: counts): a multi-container pod is matched container by
        #: container and committed when its whole request is served.
        self._partial: dict[str, list[int]] = {}
        self._partial_chips: dict[str, list[int]] = {}
        #: The checkpoint of those tables (kubelet keeps its own device
        #: state the same way): a restart between a pod's Allocate calls
        #: must not re-serve span 0. None disables it.
        self._state_path = (os.path.join(state_dir, STATE_FILE)
                            if state_dir else None)
        #: Serializes match -> record -> commit: the gRPC servicer runs
        #: on a thread pool, and two Allocates must not both match one
        #: pending container.
        self._alloc_lock = locks.TracingRLock("plugin/alloc")
        self._load_state()

    # -- advertisement -------------------------------------------------- #

    def hbm_devices(self) -> list[VirtualDevice]:
        return hbm_devices(self.inventory)

    def chip_devices(self) -> list[VirtualDevice]:
        return chip_devices(self.inventory)

    def annotate_node(self) -> None:
        """Publish per-card GiB, the model (and the topology, empty on
        NVIDIA cards) and ``TPUSHARE_SLICE_ID`` on this node, so the
        extender's ledger models the node's cards."""
        node = self.client.get_node(self.node_name)
        if node is None:
            raise AllocateError(f"node {self.node_name} not registered")
        ann = node.raw.setdefault("metadata", {}).setdefault(
            "annotations", {})
        ann[const.ANN_NODE_CHIP_HBM] = ",".join(
            str(c.hbm_gib) for c in self.inventory.chips)
        if self.inventory.topology:
            ann[const.ANN_NODE_TOPOLOGY] = self.inventory.topology
        if self.inventory.tpu_type:
            ann[const.ANN_NODE_TPU_TYPE] = self.inventory.tpu_type
        slice_id = os.environ.get("TPUSHARE_SLICE_ID", "")
        if slice_id:
            ann[const.ANN_NODE_SLICE] = slice_id
        commit.committed_update_node(self.client, node)

    # -- Allocate -------------------------------------------------------- #

    def allocate_hbm(self, device_ids: list[str]) -> ContainerAllocation:
        return self.allocate_hbm_batch([device_ids])[0]

    def allocate_chips(self, device_ids: list[str]) -> ContainerAllocation:
        return self.allocate_chips_batch([device_ids])[0]

    def allocate_hbm_batch(
            self, requests: list[list[str]]) -> list[ContainerAllocation]:
        """One Allocate RPC: kubelet granted each container in
        ``requests`` its GiB set; find whose they are. Every container is
        matched against a staged copy of the partial-grant state before
        anything mutates, so a failure leaves no record and no commit
        behind. The lock spans the batch's apiserver calls: it serializes
        kubelet's RPCs on one node, which kubelet issues one at a time."""
        with self._alloc_lock:
            # vet: ignore[blocking-under-lock] - node-local kubelet RPC serialization; see the docstring
            return self._allocate_batch(requests, chips=False)

    def allocate_chips_batch(
            self, requests: list[list[str]]) -> list[ContainerAllocation]:
        with self._alloc_lock:
            # vet: ignore[blocking-under-lock] - node-local kubelet RPC serialization; see allocate_hbm_batch
            return self._allocate_batch(requests, chips=True)

    def _allocate_batch(self, requests: list[list[str]],
                        chips: bool) -> list[ContainerAllocation]:
        table = self._partial_chips if chips else self._partial
        staged = {uid: list(v) for uid, v in table.items()}
        allocations: list[ContainerAllocation] = []
        to_commit: dict[str, Pod] = {}
        touched: set[str] = set()
        # kubelet sends one pod's containers a RPC: once a container
        # matches a pod the rest of the batch is pinned to it, so a batch
        # commits at most one pod and an abort is free of side effects.
        batch_pod: Pod | None = None
        pods = self._list_node_pods()

        for device_ids in requests:
            if chips:
                req_ids = sorted(
                    int(d.rsplit("-", 1)[1]) for d in device_ids
                    if d.startswith("tpushare-chip-"))
                if not req_ids:
                    raise AllocateError(
                        f"unrecognized chip device ids: {device_ids}")
                requested = len(req_ids)
            else:
                req_ids = []
                requested = len(device_ids)

            pod = self._match_pending_pod(
                requested, chips=chips, partial=staged,
                pods=[batch_pod] if batch_pod is not None else pods)
            if pod is None:
                if chips:
                    # A whole-card pod may bypass the extender: it still
                    # gets the cards kubelet picked.
                    allocations.append(ContainerAllocation(
                        envs=_chip_envs(req_ids),
                        devices=_device_nodes(self.inventory, req_ids,
                                              self.devfs_root),
                        annotations={}))
                    continue
                raise AllocateError(
                    f"no assumed pod on {self.node_name} has a container "
                    f"requesting {requested} GiB HBM")

            batch_pod = pod
            touched.add(pod.uid)
            served = staged.get(pod.uid, [])
            if chips:
                # The extender's placement over kubelet's pick; container
                # k takes the span after the cards earlier ones got.
                planned = self.host_ids(
                    podutils.get_chip_ids_from_annotation(pod))
                chip_ids = (self._planned_span(planned, served, requested)
                            or req_ids)
                total = podutils.get_chips_from_pod_resource(pod)
                alloc = self._build_allocation(pod, chip_ids,
                                               whole_chips=True)
            else:
                chip_ids = self.host_ids(
                    podutils.get_chip_ids_from_annotation(pod))
                total = podutils.get_hbm_from_pod_resource(pod)
                alloc = self._build_allocation(pod, chip_ids,
                                               granted_gib=requested)
            staged[pod.uid] = served + [requested]
            if sum(staged[pod.uid]) >= total:
                to_commit[pod.uid] = pod
            allocations.append(alloc)

        # Every container matched: commit first. A failed commit aborts
        # the RPC with the table untouched, so kubelet's retry re-matches.
        for pod in to_commit.values():
            self._commit_assigned(pod)
        # Write back this batch's entries only: the others keep what
        # _prune_partials left of them.
        for uid in touched:
            if uid in to_commit or not staged.get(uid):
                table.pop(uid, None)
            else:
                table[uid] = staged[uid]
        if touched:
            self._save_state()
        return allocations

    def host_ids(self, planned: list[int]) -> list[int]:
        """The host indices of the cards the extender planned. Its indices
        are positions in this node's ``chip-hbm`` annotation, which lists
        the inventory's cards in order, so position p is the inventory's
        p-th card. On a host that sees all its cards (numbered 0..n-1)
        the two are the same; on one that sees a subset (a container
        given host card 5 alone) position 0 is card 5. An index past the
        inventory is taken as a host index already."""
        cards = self.inventory.chips
        return [cards[p].index if 0 <= p < len(cards) else p
                for p in planned]

    @staticmethod
    def _planned_span(planned: list[int], served: list[int],
                      n: int) -> list[int]:
        """Container k's span of the extender's planned cards: the one
        rule Allocate and preferred_ids both follow."""
        if not planned:
            return []
        offset = sum(served)
        span = planned[offset:offset + n]
        return span if len(span) == n else planned

    def _list_node_pods(self) -> list[Pod]:
        return [p for p in self.client.list_pods(node_name=self.node_name)
                if p.node_name == self.node_name]

    def preferred_ids(self, resource: str, available: list[str],
                      size: int) -> list[str]:
        return self.preferred_ids_batch(resource, [(available, size)])[0]

    def preferred_ids_batch(
            self, resource: str,
            requests: list[tuple[list[str], int]]) -> list[list[str]]:
        """The device ids kubelet should prefer for each container, so
        its pick is the extender's plan: the pending pod's next planned
        span of cards, or the GiB devices on its planned cards. A
        container sees the earlier containers' spans of the same RPC
        (a local overlay of the served state); nothing persists."""
        chips = resource == const.CHIP_RESOURCE
        out: list[list[str]] = []
        with self._alloc_lock:
            base = self._partial_chips if chips else self._partial
            overlay = {uid: list(v) for uid, v in base.items()}
            # vet: ignore[blocking-under-lock] - node-local kubelet RPC serialization; see allocate_hbm_batch
            pods = self._list_node_pods()
            for available, size in requests:
                avail = set(available)
                # vet: ignore[blocking-under-lock] - node-local kubelet RPC serialization; see allocate_hbm_batch
                pod = self._match_pending_pod(size, chips=chips,
                                              partial=overlay, pods=pods)
                if pod is None:
                    out.append([])
                    continue
                planned = self.host_ids(
                    podutils.get_chip_ids_from_annotation(pod))
                if not planned:
                    out.append([])
                    continue
                if chips:
                    span = self._planned_span(
                        planned, overlay.get(pod.uid, []), size)
                    ids = [CHIP_DEV_FMT.format(chip=c) for c in span]
                else:
                    prefixes = tuple(f"tpushare-hbm-{c:02d}-"
                                     for c in planned)
                    ids = [d for d in sorted(avail)
                           if d.startswith(prefixes)][:size]
                overlay[pod.uid] = overlay.get(pod.uid, []) + [size]
                out.append([i for i in ids if i in avail])
        return out

    # -- matching -------------------------------------------------------- #

    def _match_pending_pod(self, requested: int, chips: bool = False,
                           partial: dict[str, list[int]] | None = None,
                           pods: list[Pod] | None = None) -> Pod | None:
        """The assumed, unassigned pod on this node with an unserved
        container limit of ``requested``, the earliest assume time first
        (then by namespace/name). ``partial`` overlays a batch's staged
        served state; ``pods`` reuses its LIST."""
        candidates = []
        live_uids = set()
        if pods is None:
            pods = self._list_node_pods()
        for pod in pods:
            live_uids.add(pod.uid)
            if podutils.is_complete_pod(pod):
                continue
            if not podutils.is_assumed(pod) or podutils.is_assigned(pod):
                continue
            # An HBM allocation never takes a whole-card pod, nor the
            # reverse: they came through different kubelet resources.
            if chips != podutils.is_tpu_chip_pod(pod):
                continue
            resource = const.CHIP_RESOURCE if chips else const.HBM_RESOURCE
            limits = [lim for lim in pod.iter_resource_limits(resource)
                      if lim > 0]
            if requested not in self._unserved_limits(pod, limits, chips,
                                                      partial):
                continue
            candidates.append((podutils.get_assume_time(pod), pod.key(),
                               pod))
        self._prune_partials(live_uids)
        if not candidates:
            return None
        candidates.sort(key=lambda t: (t[0], t[1]))
        return candidates[0][2]

    def _unserved_limits(self, pod: Pod, limits: list[int],
                         chips: bool = False,
                         partial: dict[str, list[int]] | None = None,
                         ) -> list[int]:
        """Container limits no earlier Allocate covered (each served grant
        takes one equal limit)."""
        if partial is None:
            partial = self._partial_chips if chips else self._partial
        remaining = list(limits)
        for grant in partial.get(pod.uid, []):
            if grant in remaining:
                remaining.remove(grant)
        return remaining

    def _prune_partials(self, live_uids: set[str]) -> None:
        """Drop the served state of pods that are gone."""
        dropped = False
        for table in (self._partial, self._partial_chips):
            for uid in list(table):
                if uid not in live_uids:
                    del table[uid]
                    dropped = True
        if dropped:
            self._save_state()

    # -- partial-grant checkpoint ---------------------------------------- #

    def _load_state(self) -> None:
        if not self._state_path:
            return
        try:
            with open(self._state_path, encoding="utf-8") as f:
                doc = json.load(f)
            if not isinstance(doc, dict):
                raise ValueError(f"checkpoint root is {type(doc).__name__},"
                                 " not an object")
            self._partial = {str(u): [int(g) for g in v]
                             for u, v in (doc.get("hbm") or {}).items()}
            self._partial_chips = {
                str(u): [int(g) for g in v]
                for u, v in (doc.get("chips") or {}).items()}
            if self._partial or self._partial_chips:
                log.info("restored partial-grant checkpoint: %d hbm / "
                         "%d card pods mid-allocation",
                         len(self._partial), len(self._partial_chips))
        except FileNotFoundError:
            pass
        except (OSError, ValueError, TypeError, AttributeError) as e:
            # A corrupt checkpoint must not stop the plugin: at worst a
            # mid-allocation pod fails its next container and kubelet
            # readmits it under a fresh uid.
            log.warning("partial-grant checkpoint unreadable (%s); "
                        "starting clean", e)

    def _save_state(self) -> None:
        """Atomic write (temporary file, then rename)."""
        if not self._state_path:
            return
        tmp = self._state_path + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({"hbm": self._partial,
                           "chips": self._partial_chips}, f)
            os.replace(tmp, self._state_path)
        except OSError as e:  # pragma: no cover - disk trouble
            log.warning("partial-grant checkpoint write failed: %s", e)

    # -- commit ---------------------------------------------------------- #

    def _commit_assigned(self, pod: Pod, retries: int = 3) -> None:
        """Flip ``assigned`` to true on a fresh read, retrying a
        conflict."""
        for attempt in range(retries):
            fresh = self.client.get_pod(pod.namespace, pod.name)
            ann = fresh.raw.setdefault("metadata", {}).setdefault(
                "annotations", {})
            ann[const.ANN_ASSIGNED] = const.ASSIGNED_TRUE
            try:
                commit.committed_update_pod(self.client, fresh)
                return
            except ConflictError:
                if attempt == retries - 1:
                    raise
                time.sleep(0.05 * (attempt + 1))

    def _build_allocation(self, pod: Pod, chip_ids: list[int],
                          whole_chips: bool = False,
                          granted_gib: int | None = None,
                          ) -> ContainerAllocation:
        """:func:`build_allocation` for one container of ``pod``: its own
        share of the grant (``granted_gib``, or the pod's grant)."""
        gib = (granted_gib if granted_gib is not None
               else podutils.get_hbm_from_pod_annotation(pod))
        group, minimum = podutils.get_pod_group(pod)
        return build_allocation(
            self.inventory, chip_ids, gib, pod_uid=pod.uid,
            group=group or None, group_size=minimum,
            whole_chips=whole_chips, usage_dir=self.usage_dir,
            devfs_root=self.devfs_root)
