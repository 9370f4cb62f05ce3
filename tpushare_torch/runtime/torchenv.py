"""Tenant-side runtime contract for a PyTorch process on an NVIDIA card:
the device plugin's injected grant env -> process configuration, and
the HBM-usage heartbeat the plugin's grant watchdog reads.

Port of ``tpushare/runtime/jaxenv.py``. The grant parser is a copy.
:func:`configure` only sets environment (``CUDA_VISIBLE_DEVICES`` from
the granted chip index), so it runs before torch touches CUDA;
:func:`apply_memory_fraction` runs after, and caps the caching
allocator at the granted fraction through
``torch.cuda.set_per_process_memory_fraction``. Whether that cap holds
against a tenant that allocates past it is a property of the card's
software stack that is measured (``chip_smoke.py``), not assumed here.

The heartbeat writes the same JSON keys as the JAX tenant (``bytes_in_use``,
``peak_bytes``, ``bytes_limit``, ``source``, ``ts``, ``pid``), so the
unchanged watchdog reads a torch tenant.

A gang member joins its gang's process group through
:func:`init_distributed`, from the same env as the JAX tenant's
``jax.distributed`` bootstrap (:func:`distributed_spec`).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time

import torch
import torch.distributed as dist

from tpushare_torch.utils import const
from tpushare_torch.utils.device import resolve_device

#: Safety headroom applied to the granted fraction.
DEFAULT_HEADROOM = 0.9

ENV_CUDA_VISIBLE_DEVICES = const.ENV_CUDA_VISIBLE_DEVICES


@dataclasses.dataclass(frozen=True)
class ShareGrant:
    """What the device plugin granted this process."""

    chip_ids: tuple[int, ...]
    hbm_pod_gib: int
    hbm_chip_gib: int

    @property
    def mem_fraction(self) -> float:
        if self.hbm_chip_gib <= 0:
            return 1.0
        return min(self.hbm_pod_gib / self.hbm_chip_gib, 1.0)

    @property
    def whole_chips(self) -> bool:
        return self.hbm_pod_gib >= self.hbm_chip_gib * len(self.chip_ids)


def read_grant(environ=None) -> ShareGrant | None:
    """Parse the injected env; None when not running under tpushare."""
    env = os.environ if environ is None else environ
    raw_idx = env.get(const.ENV_CHIP_IDX)
    if raw_idx is None:
        return None
    try:
        chip_ids = tuple(int(p) for p in str(raw_idx).split(",") if p != "")
        hbm_pod = int(env.get(const.ENV_HBM_POD, "0"))
        hbm_chip = int(env.get(const.ENV_HBM_CHIP, "0"))
    except ValueError:
        return None
    return ShareGrant(chip_ids, hbm_pod, hbm_chip)


def configure(environ=None) -> ShareGrant | None:
    """Restrict the process to its granted card(s) before CUDA starts.
    Returns the grant, or None (no-op) outside a tpushare pod.

    The container contract (``deviceplugin.plugin.build_allocation``):
    ``TPUSHARE_CHIP_IDX`` names the cards by *host* index, which the
    watchdog and the annotations read; ``CUDA_VISIBLE_DEVICES`` holds
    the ordinals the container sees (``0,…,k-1``: the NVIDIA container
    runtime exposes only the cards in ``NVIDIA_VISIBLE_DEVICES`` and
    numbers them from 0). This sets ``CUDA_VISIBLE_DEVICES`` only where
    it is unset, to the host indices: right for a process outside a
    container, which sees every card of the host."""
    env = os.environ if environ is None else environ
    grant = read_grant(env)
    if grant is not None and grant.chip_ids:
        env.setdefault(ENV_CUDA_VISIBLE_DEVICES,
                       ",".join(str(c) for c in grant.chip_ids))
    return grant


@dataclasses.dataclass(frozen=True)
class DistributedSpec:
    """What a gang member needs to join its gang's process group."""

    coordinator: str
    num_processes: int
    process_id: int


def distributed_spec(environ=None) -> DistributedSpec | None:
    """Derive the gang bootstrap from injected + standard k8s env.

    The device plugin injects the gang's name/size
    (``TPUSHARE_POD_GROUP``, ``TPUSHARE_POD_GROUP_SIZE``); the worker
    index comes from ``JOB_COMPLETION_INDEX`` (k8s indexed Job) or
    ``TPU_WORKER_ID``; the coordinator address from
    ``TPUSHARE_COORDINATOR`` or the indexed-Job convention
    ``<group>-0.<group>:8476``. Returns None when not in a gang
    (single-process job). A copy of the JAX tenant's rules."""
    env = os.environ if environ is None else environ
    group = env.get(const.ENV_POD_GROUP, "")
    try:
        num = int(env.get(const.ENV_POD_GROUP_SIZE, "0"))
    except ValueError:
        return None
    if not group or num <= 1:
        return None
    raw_id = env.get("JOB_COMPLETION_INDEX", env.get("TPU_WORKER_ID"))
    if raw_id is None:
        return None
    try:
        pid = int(raw_id)
    except ValueError:
        return None
    if not 0 <= pid < num:
        # An out-of-range rank would hang the whole gang at the init
        # barrier; fail loudly instead.
        raise ValueError(
            f"worker index {pid} out of range for pod group {group!r} of "
            f"size {num}; the gang's pod-group-min must equal the Job's "
            f"completion count")
    coordinator = env.get(const.ENV_COORDINATOR,
                          f"{group}-0.{group}:8476")
    return DistributedSpec(coordinator, num, pid)


def init_distributed(environ=None, *, backend: str | None = None,
                     device: str | torch.device = "cuda",
                     init_method: str | None = None
                     ) -> DistributedSpec | None:
    """Join the gang's process group (``torch.distributed``) at
    ``tcp://<coordinator>`` with the gang's size and this worker's rank,
    and make the rank's card current; None (nothing done) outside a gang.
    ``init_method`` replaces the TCP rendezvous (e.g. ``file://...``).

    The backend is never chosen by a failure. On the CPU it is gloo. On
    the card, with no ``backend``, it is NCCL when each rank has a card of
    its own: this host runs no more ranks than it sees cards
    (``LOCAL_WORLD_SIZE``, 1 when unset) and the grant, if any, is whole
    cards. NCCL takes one rank a card, so where ranks would share one
    this raises unless the caller asks for ``backend="gloo"``, and it
    refuses ``backend="nccl"`` for more local ranks than cards. Local
    rank ``LOCAL_RANK`` takes card ``LOCAL_RANK % cards``."""
    env = os.environ if environ is None else environ
    spec = distributed_spec(env)
    if spec is None:
        return None
    dev = resolve_device(device)
    if dev.type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} does not run on the CPU; "
                             f"only gloo does")
        backend = "gloo"
    else:
        local_rank = int(env.get("LOCAL_RANK", "0"))
        local_world = int(env.get("LOCAL_WORLD_SIZE", "1"))
        cards = torch.cuda.device_count()
        grant = read_grant(env)
        shares = local_world > cards
        if backend is None:
            if shares or (grant is not None and not grant.whole_chips):
                raise ValueError(
                    f"{local_world} local rank(s) on {cards} card(s) under "
                    f"grant {grant}: ranks may share a card, which NCCL "
                    f"refuses; pass backend='gloo' to run the gang's "
                    f"collectives through the host")
            backend = "nccl"
        elif backend == "nccl" and shares:
            raise ValueError(f"NCCL takes one rank a card: {local_world} "
                             f"local ranks on {cards} card(s)")
        torch.cuda.set_device(local_rank % cards)
    dist.init_process_group(
        backend, init_method=init_method or f"tcp://{spec.coordinator}",
        world_size=spec.num_processes, rank=spec.process_id)
    return spec


def memory_fraction(grant: ShareGrant | None,
                    headroom: float = DEFAULT_HEADROOM) -> float | None:
    """The allocator cap for an HBM-slice grant (fraction x headroom,
    rounded as the JAX tenant rounds it); None for whole-card pods,
    which own the card's memory outright, and outside a tpushare pod."""
    if grant is None or grant.whole_chips:
        return None
    return round(grant.mem_fraction * headroom, 3)


def apply_memory_fraction(grant: ShareGrant | None,
                          headroom: float = DEFAULT_HEADROOM
                          ) -> float | None:
    """Cap every visible card's caching allocator at the grant's
    fraction. Call after :func:`configure`, once torch has CUDA.
    Returns the fraction set, or None when nothing was capped."""
    fraction = memory_fraction(grant, headroom)
    if fraction is None:
        return None
    for i in range(torch.cuda.device_count()):
        torch.cuda.set_per_process_memory_fraction(fraction, i)
    return fraction


# --------------------------------------------------------------------- #
# Usage reporting: the heartbeat the device plugin's watchdog reads
# --------------------------------------------------------------------- #

def usage_snapshot() -> dict | None:
    """This process's device memory summed over its visible cards, from
    the caching allocator's counters: memory reserved on the card (what
    co-tenants lose) and its peak. None without a card: host RAM is not
    HBM, and heartbeating it could get an innocent tenant flagged."""
    if not torch.cuda.is_available():
        return None
    in_use = peak = limit = 0
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        in_use += int(stats.get("reserved_bytes.all.current", 0))
        peak += int(stats.get("reserved_bytes.all.peak", 0))
        limit += int(torch.cuda.get_device_properties(i).total_memory)
    return {
        "bytes_in_use": in_use,
        "peak_bytes": peak,
        "bytes_limit": limit,
        "source": "memory_stats",
        "ts": time.time(),
        "pid": os.getpid(),
    }


def write_usage(path: str | None = None, environ=None) -> dict | None:
    """One heartbeat: snapshot -> atomic write to ``path`` (default: the
    injected ``TPUSHARE_USAGE_FILE``). No-op (None) outside a tpushare
    pod or without a card, so callers may invoke it unconditionally."""
    env = os.environ if environ is None else environ
    path = path or env.get(const.ENV_USAGE_FILE, "")
    if not path:
        return None
    snap = usage_snapshot()
    if snap is None:
        return None
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(snap, f)
        os.replace(tmp, path)  # atomic: the watchdog never reads a torn file
    except OSError:
        return None
    return snap


def start_usage_reporter(interval: float = 5.0, path: str | None = None,
                         environ=None) -> threading.Thread | None:
    """Daemon thread heartbeating :func:`write_usage` every ``interval``
    seconds. None (no thread) outside a tpushare pod. A stale heartbeat
    is the watchdog's liveness signal, so the thread dies with the
    process."""
    env = os.environ if environ is None else environ
    target = path or env.get(const.ENV_USAGE_FILE, "")
    if not target:
        return None

    def _beat() -> None:
        while True:
            write_usage(target, environ=env)
            time.sleep(interval)

    t = threading.Thread(target=_beat, name="tpushare-usage-reporter",
                         daemon=True)
    t.start()
    return t
