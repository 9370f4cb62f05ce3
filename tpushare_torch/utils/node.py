"""Node-level readers: cards, capacities, topology and slice fields.

The port's copy of ``tpushare/utils/node.py``, GKE label fallbacks
included, so a node reads the same on both sides. An NVIDIA node carries
no topology annotation (the port's daemon writes none), so its ledger
takes a flat topology.
"""

from __future__ import annotations

from tpushare_torch.api.objects import Node, Pod
from tpushare_torch.utils import const


def is_tpu_sharing_node(node: Node) -> bool:
    """Node advertises shareable HBM (reference ``IsGPUSharingNode``,
    node.go:6-8)."""
    return get_total_hbm(node) > 0


def get_total_hbm(node: Node) -> int:
    """Total shareable HBM GiB on the node (reference ``GetTotalGPUMemory``,
    node.go:11-19)."""
    return node.capacity_of(const.HBM_RESOURCE)


def get_chip_count(node: Node) -> int:
    """Number of TPU chips on the node (reference ``GetGPUCountInNode``,
    node.go:22-30)."""
    return node.capacity_of(const.CHIP_RESOURCE)


def get_chip_capacities(node: Node) -> list[int]:
    """Per-chip HBM GiB.

    Prefers the device plugin's ``tpushare.io/chip-hbm`` annotation (which
    supports heterogeneous chips); falls back to an equal split of the node
    total, like the reference did unconditionally.
    """
    count = get_chip_count(node)
    total = get_total_hbm(node)
    ann = node.annotations.get(const.ANN_NODE_CHIP_HBM)
    if ann:
        try:
            caps = [int(part) for part in str(ann).split(",") if part != ""]
        except ValueError:
            caps = []
        if caps and all(c > 0 for c in caps):
            return caps
    if count <= 0:
        return []
    return [total // count] * count


def get_topology(node: Node) -> str:
    """Physical chip topology string, e.g. "2x2x1"; empty when unknown.

    Reads the tpushare annotation first, then the GKE well-known label
    (SURVEY.md §5 'distributed communication backend' TPU mapping).
    """
    topo = node.annotations.get(const.ANN_NODE_TOPOLOGY, "")
    if topo:
        return topo
    return node.labels.get(const.GKE_TPU_TOPOLOGY_LABEL, "")


def get_slice_id(node: Node) -> str:
    """Multi-host slice this host belongs to; empty when unknown.

    Hosts of one slice are joined by ICI, hosts of different slices by
    DCN — the locality distinction SURVEY.md §5 requires the resource
    model to encode. Reads the tpushare annotation first; the GKE
    node-pool label is used as a fallback ONLY when the GKE topology
    label proves the pool is a multi-host slice (slice topology volume
    exceeds this host's chip count). A pool of independent single-host
    nodes shares a pool name but no ICI, and must not look like a slice.
    """
    sid = node.annotations.get(const.ANN_NODE_SLICE, "")
    if sid:
        return sid
    topo = node.labels.get(const.GKE_TPU_TOPOLOGY_LABEL, "")
    if not topo:
        return ""
    try:
        volume = 1
        for part in topo.split("x"):
            volume *= int(part)
    except ValueError:
        return ""
    if volume <= get_chip_count(node):
        return ""  # single-host pool: no ICI beyond this host
    return node.labels.get(const.GKE_NODEPOOL_LABEL, "")


def get_slice_topology(node: Node) -> str:
    """Chip topology of the WHOLE multi-host slice (e.g. "8x8"); empty
    when unknown or when the node is not part of a multi-host slice.

    Reads the tpushare annotation first; the GKE topology label is the
    fallback — on multi-host node pools that label carries the SLICE
    dims (the per-host dims come from the chip inventory), which is
    exactly the case where its volume exceeds this host's chip count."""
    st = node.annotations.get(const.ANN_NODE_SLICE_TOPOLOGY, "")
    if st:
        return st
    topo = node.labels.get(const.GKE_TPU_TOPOLOGY_LABEL, "")
    if not topo:
        return ""
    try:
        volume = 1
        for part in topo.split("x"):
            volume *= int(part)
    except ValueError:
        return ""
    return topo if volume > get_chip_count(node) else ""


def get_worker_index(node: Node) -> int | None:
    """This host's worker index within its multi-host slice (row-major
    over the host grid), or None when unknown."""
    for source in (node.annotations.get(const.ANN_NODE_WORKER),
                   node.labels.get(const.GKE_TPU_WORKER_LABEL)):
        if source is None:
            continue
        try:
            idx = int(source)
        except ValueError:
            continue
        if idx >= 0:
            return idx
    return None


def host_position(node: Node) -> tuple[tuple[int, ...], "object"] | None:
    """(host coords, host grid Topology) of this node within its slice,
    or None when the slice topology / worker index are unknown. The
    grid's ``distance_coords`` is the inter-host ICI hop count — what
    gang placement minimizes WITHIN a slice (a flat slice-id match says
    nothing about adjacency on a big torus)."""
    from tpushare_torch.topology import topology as T

    grid = T.slice_host_grid(get_slice_topology(node), get_topology(node),
                             get_tpu_type(node))
    if grid is None:
        return None
    widx = get_worker_index(node)
    if widx is None or widx >= grid.chip_count:
        return None
    return grid.coords(widx), grid


def get_tpu_type(node: Node) -> str:
    """TPU generation, e.g. "v5e" / "v5p"; empty when unknown."""
    t = node.annotations.get(const.ANN_NODE_TPU_TYPE, "")
    if t:
        return t
    accel = node.labels.get(const.GKE_TPU_ACCELERATOR_LABEL, "")
    # e.g. "tpu-v5-lite-podslice" → "v5e", "tpu-v5p-slice" → "v5p"
    if "v5-lite" in accel or "v5e" in accel:
        return "v5e"
    if "v5p" in accel:
        return "v5p"
    if "v6e" in accel or "trillium" in accel:
        return "v6e"
    if "v4" in accel:
        return "v4"
    return ""


def _tolerates(toleration: dict, taint: dict) -> bool:
    """One ``v1.Toleration`` vs one ``v1.Taint``, upstream matching rules
    (``pkg/apis/core/v1/helper.TolerationsTolerateTaint``): empty effect
    tolerates every effect, empty key (with Exists) every key; Equal
    compares values, Exists ignores them."""
    effect = toleration.get("effect", "")
    if effect and effect != taint.get("effect"):
        return False
    key = toleration.get("key", "")
    operator = toleration.get("operator", "Equal")
    if not key:
        return operator == "Exists"
    if key != taint.get("key"):
        return False
    if operator == "Exists":
        return True
    return toleration.get("value", "") == taint.get("value", "")


def is_schedulable(node: Node, pod: Pod | None = None) -> bool:
    """Would kube-scheduler even consider ``node`` for ``pod``?

    Mirrors the NodeUnschedulable + TaintToleration filter plugins that
    run BEFORE any extender webhook: cordoned nodes
    (``spec.unschedulable``) and nodes with untolerated
    NoSchedule/NoExecute taints never reach our filter verb, so fleet
    scans WE initiate (the gang quorum pre-check in
    the gang planner's quorum pre-check) must apply the same exclusion.
    """
    tolerations = (pod.spec.get("tolerations") or []) if pod else []
    if node.unschedulable:
        # A cordon is modeled upstream as the synthetic
        # node.kubernetes.io/unschedulable:NoSchedule taint; only pods
        # that explicitly tolerate it (DaemonSets in practice — never
        # TPU workers) may still land on a cordoned node.
        synthetic = {"key": "node.kubernetes.io/unschedulable",
                     "effect": "NoSchedule"}
        if not any(_tolerates(t, synthetic) for t in tolerations):
            return False
    for taint in node.taints:
        if taint.get("effect") not in ("NoSchedule", "NoExecute"):
            continue  # PreferNoSchedule never excludes
        if not any(_tolerates(t, taint) for t in tolerations):
            return False
    return True
