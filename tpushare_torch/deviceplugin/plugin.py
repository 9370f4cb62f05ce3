"""The device plugin's accelerator half for NVIDIA cards: what a node
advertises, and what ``Allocate`` hands a container.

Port of the device side of ``tpushare/deviceplugin/plugin.py``
(``hbm_devices``, ``chip_devices``, ``_chip_health``, ``_device_nodes``,
``_chip_envs`` and ``_build_allocation``), as plain functions over a
:class:`~tpushare_torch.deviceplugin.discovery.HostInventory`. The
matching of pods to an allocation, its commit and the state file are
control plane, accelerator-neutral, and are not ported.

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
import logging
import os

from tpushare_torch.deviceplugin.discovery import HostInventory
from tpushare_torch.utils import const

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
