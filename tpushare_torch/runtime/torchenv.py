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
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time

import torch

from tpushare_torch.utils import const

#: Safety headroom applied to the granted fraction.
DEFAULT_HEADROOM = 0.9

ENV_CUDA_VISIBLE_DEVICES = "CUDA_VISIBLE_DEVICES"


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
    Sets ``CUDA_VISIBLE_DEVICES`` only where it is unset. Returns the
    grant, or None (no-op) outside a tpushare pod."""
    env = os.environ if environ is None else environ
    grant = read_grant(env)
    if grant is not None and grant.chip_ids:
        env.setdefault(ENV_CUDA_VISIBLE_DEVICES,
                       ",".join(str(c) for c in grant.chip_ids))
    return grant


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
