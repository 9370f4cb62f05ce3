"""NVIDIA card discovery: what does this host have?

Counterpart of ``tpushare/deviceplugin/discovery.py`` for NVIDIA cards,
with its own :class:`ChipSpec` and :class:`HostInventory` (the same
fields and properties). The chain runs in order, first hit wins:

1. **devfs** -- ``<devfs>/nvidia<N>``, one node per card. The control
   nodes (``nvidiactl``, ``nvidia-uvm``, ``nvidia-uvm-tools``,
   ``nvidia-modeset``, ``nvidia-caps/``) are not cards.
2. **sysfs** -- PCI functions under ``<sysfs>/bus/pci/devices`` with
   NVIDIA's vendor id and a display or 3D class (``0x03xxxx``). NVSwitches
   and the cards' audio and USB functions carry the same vendor id.
3. **procfs** -- the NVIDIA kernel module's
   ``<procfs>/driver/nvidia/gpus/*/information``.
4. **Environment** -- ``NVIDIA_VISIBLE_DEVICES`` as the NVIDIA container
   runtime sets it; the model comes from :data:`ENV_GPU_MODEL`.
5. **The GKE label** -- ``cloud.google.com/gke-accelerator``.

Where ``NVIDIA_VISIBLE_DEVICES`` lists cards by index, rungs 1-3 count
only those: a container may show device nodes of cards it was not given.
A rung that counts cards without naming them takes the model from the
first source that names one: the module's model line, the PCI device
id, ``nvidia-smi`` (NVIDIA's NVML tool, which names the card where a
container shows neither procfs nor the PCI tree), the environment, the
label. ``hbm_gib`` comes from :data:`HBM_GIB_BY_TYPE`, in the card's
usable whole GiB, so the capacity the plugin advertises never exceeds
what the card holds.
"""

from __future__ import annotations

import dataclasses
import glob
import logging
import os
import re
import subprocess

log = logging.getLogger(__name__)

#: Usable device memory per card, whole GiB, by model: ``memory.total``
#: as nvidia-smi reports it, rounded down. An "80GB" H100 reports
#: 81,559 MiB (79.6 GiB): advertising 80 would let the scheduler's sum of
#: grants overcommit the card.
HBM_GIB_BY_TYPE = {
    "h100-80gb": 79,     # 81,559 MiB
    "h200-141gb": 140,   # 143,771 MiB
    "a100-80gb": 80,     # 81,920 MiB
    "a100-40gb": 40,     # 40,960 MiB
    "l4": 22,            # 23,034 MiB
}

#: A model named without its memory size takes the family's smallest:
#: advertising less than the card holds never overcommits it.
_FAMILY_DEFAULT = {"h100": "h100-80gb", "h200": "h200-141gb",
                   "a100": "a100-40gb", "l4": "l4"}

#: PCI device id -> model (vendor 0x10de).
PCI_DEVICE_MODELS = {
    0x2330: "h100-80gb",   # H100 SXM5
    0x2331: "h100-80gb",   # H100 PCIe
    0x2335: "h200-141gb",  # H200 SXM
    0x20b0: "a100-40gb",   # A100 SXM4 40GB
    0x20f1: "a100-40gb",   # A100 PCIe 40GB
    0x20b2: "a100-80gb",   # A100 SXM4 80GB
    0x20b5: "a100-80gb",   # A100 PCIe 80GB
    0x27b8: "l4",
}

NVIDIA_VENDOR = 0x10de
#: PCI base class of display controllers (VGA 0x0300, 3D 0x0302).
_DISPLAY_CLASS = 0x03

ENV_VISIBLE_DEVICES = "NVIDIA_VISIBLE_DEVICES"
#: The model hint for the environment rung (for example ``h100-80gb`` or
#: ``NVIDIA H100 80GB HBM3``), set on the device plugin's pod.
ENV_GPU_MODEL = "TPUSHARE_GPU_MODEL"
GKE_ACCELERATOR_LABEL = "cloud.google.com/gke-accelerator"
#: GCE accelerator-optimized machine types end in the card count
#: (``a3-highgpu-8g``).
INSTANCE_TYPE_LABEL = "node.kubernetes.io/instance-type"


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """One physical card on this host."""

    index: int
    hbm_gib: int
    device_path: str = ""
    chip_type: str = ""
    numa_node: int = -1


@dataclasses.dataclass(frozen=True)
class HostInventory:
    """Everything the device plugin advertises about this host. The
    field names are the TPU inventory's; ``tpu_type`` holds the card
    model and ``topology`` is empty (no ICI mesh)."""

    tpu_type: str
    topology: str
    chips: tuple[ChipSpec, ...]
    source: str = ""  # which discovery rung produced this

    @property
    def chip_count(self) -> int:
        return len(self.chips)

    @property
    def total_hbm_gib(self) -> int:
        return sum(c.hbm_gib for c in self.chips)

    def chip(self, index: int) -> ChipSpec | None:
        for c in self.chips:
            if c.index == index:
                return c
        return None


def parse_model(value: str) -> str:
    """A model key of :data:`HBM_GIB_BY_TYPE` from a procfs model line
    (``NVIDIA H100 80GB HBM3``), a GKE label value (``nvidia-h100-80gb``)
    or a key itself; "" if opaque."""
    text = value.strip().lower()
    family = re.search(r"(?<![a-z0-9])(h100|h200|a100|l4)(?![0-9])", text)
    if not family:
        return ""
    size = re.search(r"(\d+)\s*gb", text)
    key = f"{family.group(1)}-{size.group(1)}gb" if size else ""
    return key if key in HBM_GIB_BY_TYPE else _FAMILY_DEFAULT[family.group(1)]


def _inventory(model: str, paths: dict[int, str],
               numa: dict[int, int] | None = None,
               source: str = "") -> HostInventory:
    chips = tuple(
        ChipSpec(index=i, hbm_gib=HBM_GIB_BY_TYPE.get(model, 0),
                 device_path=paths[i], chip_type=model,
                 numa_node=(numa or {}).get(i, -1))
        for i in sorted(paths))
    return HostInventory(tpu_type=model, topology="", chips=chips,
                         source=source)


def _read(path: str) -> str:
    try:
        with open(path, encoding="utf-8") as f:
            return f.read().strip()
    except OSError:
        return ""


# ---------------------------------------------------------------------------
# Rung 1: devfs
# ---------------------------------------------------------------------------

_NODE_RE = re.compile(r"nvidia(\d+)$")


def devfs_scan(devfs_root: str = "/dev",
               model_hint: str = "") -> HostInventory | None:
    """Count ``<devfs_root>/nvidia<N>``; the node names no model."""
    paths = {}
    for path in glob.glob(os.path.join(devfs_root, "nvidia*")):
        m = _NODE_RE.fullmatch(os.path.basename(path))
        if m:
            paths[int(m.group(1))] = path
    if not paths:
        return None
    return _inventory(model_hint, paths, source="devfs")


# ---------------------------------------------------------------------------
# Rung 2: sysfs
# ---------------------------------------------------------------------------

def _pci_cards(sysfs_root: str) -> list[tuple[str, int, int]]:
    """(PCI address, device id, NUMA node) of each NVIDIA display or 3D
    function, in PCI address order (the minor-number order)."""
    cards = []
    for dev in sorted(glob.glob(os.path.join(sysfs_root, "bus", "pci",
                                             "devices", "*"))):
        try:
            vendor = int(_read(os.path.join(dev, "vendor")), 16)
            klass = int(_read(os.path.join(dev, "class")), 16)
            device = int(_read(os.path.join(dev, "device")), 16)
        except ValueError:
            continue
        if vendor != NVIDIA_VENDOR or klass >> 16 != _DISPLAY_CLASS:
            continue
        try:
            numa = int(_read(os.path.join(dev, "numa_node")))
        except ValueError:
            numa = -1
        cards.append((os.path.basename(dev), device, numa))
    return cards


def sysfs_scan(sysfs_root: str = "/sys",
               model_hint: str = "") -> HostInventory | None:
    """Count the NVIDIA display/3D PCI functions; the model from the
    first one's device id, else ``model_hint``."""
    cards = _pci_cards(sysfs_root)
    if not cards:
        return None
    model = PCI_DEVICE_MODELS.get(cards[0][1], "") or model_hint
    paths = {i: f"/dev/nvidia{i}" for i in range(len(cards))}
    numa = {i: card[2] for i, card in enumerate(cards)}
    return _inventory(model, paths, numa=numa, source="sysfs")


# ---------------------------------------------------------------------------
# Rung 3: procfs
# ---------------------------------------------------------------------------

def _procfs_cards(procfs_root: str) -> dict[int, str]:
    """Device minor -> model line, from the kernel module's per-card
    files."""
    found = {}
    files = sorted(glob.glob(os.path.join(procfs_root, "driver", "nvidia",
                                          "gpus", "*", "information")))
    for order, path in enumerate(files):
        fields = {}
        for line in _read(path).splitlines():
            key, _, val = line.partition(":")
            fields[key.strip().lower()] = val.strip()
        try:
            minor = int(fields.get("device minor", order))
        except ValueError:
            minor = order
        found[minor] = fields.get("model", "")
    return found


def procfs_scan(procfs_root: str = "/proc",
                model_hint: str = "") -> HostInventory | None:
    """Count the kernel module's cards; the model from their ``Model:``
    line."""
    cards = _procfs_cards(procfs_root)
    if not cards:
        return None
    model = next((m for m in map(parse_model, cards.values()) if m),
                 model_hint)
    return _inventory(model, {i: f"/dev/nvidia{i}" for i in cards},
                      source="procfs")


def smi_models(smi_path: str = "nvidia-smi") -> dict[int, str]:
    """Index -> model key of each card ``nvidia-smi`` lists; {} where it
    does not run. Names cards, counts none: a rung counts them."""
    try:
        out = subprocess.run(
            [smi_path, "--query-gpu=index,name", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    models = {}
    for line in out.strip().splitlines():
        index, _, name = line.partition(",")
        if index.strip().isdigit():
            models[int(index)] = parse_model(name)
    return models


# ---------------------------------------------------------------------------
# Rung 4: the container runtime's environment
# ---------------------------------------------------------------------------

def _visible_ids(env) -> list[str]:
    """The cards ``NVIDIA_VISIBLE_DEVICES`` lists (indices or UUIDs); []
    for ``all``, ``none``, ``void`` and unset, which list none."""
    raw = env.get(ENV_VISIBLE_DEVICES, "").strip().lower()
    if raw in ("", "all", "none", "void"):
        return []
    return [p.strip() for p in raw.split(",") if p.strip()]


def env_discover(environ=None, model_hint: str = "") -> HostInventory | None:
    """Cards from ``NVIDIA_VISIBLE_DEVICES`` (indices or UUIDs); ``all``,
    ``none``, ``void`` and unset give no inventory. The model from
    :data:`ENV_GPU_MODEL`, else ``model_hint``."""
    env = os.environ if environ is None else environ
    ids = _visible_ids(env)
    if not ids:
        return None
    indices = ([int(p) for p in ids] if all(p.isdigit() for p in ids)
               else list(range(len(ids))))
    model = parse_model(env.get(ENV_GPU_MODEL, "")) or model_hint
    return _inventory(model, {i: f"/dev/nvidia{i}" for i in indices},
                      source="env")


# ---------------------------------------------------------------------------
# Rung 5: GKE node labels
# ---------------------------------------------------------------------------

def gke_label_discover(labels: dict[str, str]) -> HostInventory | None:
    """Cards from GKE's accelerator label: the model from its value, the
    count from the machine type's ``-<N>g`` suffix, else 1."""
    model = parse_model(labels.get(GKE_ACCELERATOR_LABEL, ""))
    if not model:
        return None
    m = re.search(r"-(\d+)g$", labels.get(INSTANCE_TYPE_LABEL, ""))
    count = int(m.group(1)) if m else 1
    return _inventory(model, {i: f"/dev/nvidia{i}" for i in range(count)},
                      source="gke-labels")


# ---------------------------------------------------------------------------
# The chain
# ---------------------------------------------------------------------------

def _only(inv: HostInventory | None,
          indices: set[int] | None) -> HostInventory | None:
    """``inv`` cut to the cards ``indices`` names (all of them for None);
    None when no card is left."""
    if inv is None or indices is None:
        return inv
    chips = tuple(c for c in inv.chips if c.index in indices)
    return dataclasses.replace(inv, chips=chips) if chips else None


def _retype(inv: HostInventory, model: str) -> HostInventory:
    """Name the cards of a rung that counted them without a model."""
    chips = tuple(dataclasses.replace(
        c, chip_type=c.chip_type or model,
        hbm_gib=c.hbm_gib or HBM_GIB_BY_TYPE.get(c.chip_type or model, 0))
        for c in inv.chips)
    return dataclasses.replace(inv, chips=chips,
                               tpu_type=inv.tpu_type or model)


def discover_host(devfs_root: str = "/dev", sysfs_root: str = "/sys",
                  procfs_root: str = "/proc", environ=None,
                  node_labels: dict[str, str] | None = None,
                  smi_path: str = "nvidia-smi") -> HostInventory | None:
    """Run the discovery chain; None only when every rung misses."""
    env = os.environ if environ is None else environ
    labels = node_labels or {}
    listed = _procfs_cards(procfs_root)
    pci = _pci_cards(sysfs_root)
    model = (next((m for m in map(parse_model, listed.values()) if m), "")
             or (PCI_DEVICE_MODELS.get(pci[0][1], "") if pci else "")
             or next((m for m in smi_models(smi_path).values() if m), "")
             or parse_model(env.get(ENV_GPU_MODEL, ""))
             or parse_model(labels.get(GKE_ACCELERATOR_LABEL, "")))
    ids = _visible_ids(env)
    visible = ({int(p) for p in ids} if ids and all(p.isdigit() for p in ids)
               else None)
    inv = (_only(devfs_scan(devfs_root, model), visible)
           or _only(sysfs_scan(sysfs_root, model), visible)
           or _only(procfs_scan(procfs_root, model), visible)
           or env_discover(env, model)
           or gke_label_discover(labels))
    if inv is not None and model:
        inv = _retype(inv, model)
    if inv is not None:
        log.info("discovered %d %s card(s) via %s (%d GiB in all)",
                 inv.chip_count, inv.tpu_type or "unknown-model", inv.source,
                 inv.total_hbm_gib)
    return inv
