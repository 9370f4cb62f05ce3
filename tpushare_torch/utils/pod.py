"""Pod-level readers, classifiers and the bind-time writer.

The port's copy of ``tpushare/utils/pod.py``: the helpers the device
plugin, the grant watchdog and the scheduler extender use, with the same
semantics, so the annotation schema is one on both sides.
"""

from __future__ import annotations

import os
import time

from tpushare_torch.api.objects import Pod
from tpushare_torch.utils import const


def is_complete_pod(pod: Pod) -> bool:
    """True once the pod holds nothing: a terminated phase, or marked for
    deletion."""
    if pod.deletion_timestamp:
        return True
    return pod.phase in ("Succeeded", "Failed")


def is_assigned_non_terminated(pod: Pod) -> bool:
    """Scheduled onto a node and still running."""
    if pod.deletion_timestamp or not pod.node_name:
        return False
    return pod.phase not in ("Succeeded", "Failed")


def get_hbm_from_pod_resource(pod: Pod) -> int:
    """Sum of the containers' ``tpu-hbm`` limits, GiB. Kept on the pod
    object: the filter reads one pod once per candidate node, and a pod's
    limits never change."""
    try:
        return pod._req_hbm_memo
    except AttributeError:
        val = pod._req_hbm_memo = sum(
            pod.iter_resource_limits(const.HBM_RESOURCE))
        return val


def get_chips_from_pod_resource(pod: Pod) -> int:
    """Sum of the containers' whole-card limits (kept on the pod too)."""
    try:
        return pod._req_chips_memo
    except AttributeError:
        val = pod._req_chips_memo = sum(
            pod.iter_resource_limits(const.CHIP_RESOURCE))
        return val


def is_tpu_sharing_pod(pod: Pod) -> bool:
    """The pod requests an HBM slice."""
    return get_hbm_from_pod_resource(pod) > 0


def is_tpu_chip_pod(pod: Pod) -> bool:
    """The pod requests whole cards rather than an HBM slice."""
    return get_chips_from_pod_resource(pod) > 0


def is_gang_pod(pod: Pod) -> bool:
    return const.ANN_POD_GROUP in pod.annotations


def get_tenant(pod: Pod) -> str:
    """Whom the pod's usage is charged to: its ``tpushare.io/tenant``
    label, else its namespace."""
    return pod.labels.get(const.LABEL_TENANT) or pod.namespace


def get_chip_ids_from_annotation(pod: Pod) -> list[int]:
    """Granted card indices, or [] when unassigned or invalid."""
    value = pod.annotations.get(const.ANN_CHIP_IDX)
    if value is None:
        return []
    try:
        ids = [int(part) for part in str(value).split(",") if part != ""]
    except ValueError:
        return []
    return [i for i in ids if i >= 0]


def get_chip_id_from_annotation(pod: Pod) -> int:
    """The first granted card index, or ``NO_CHIP``."""
    ids = get_chip_ids_from_annotation(pod)
    return ids[0] if ids else const.NO_CHIP


def get_hbm_from_pod_annotation(pod: Pod) -> int:
    """GiB granted at bind time, 0 when absent or invalid."""
    value = pod.annotations.get(const.ANN_HBM_POD)
    if value is None:
        return 0
    try:
        return max(int(value), 0)
    except ValueError:
        return 0


def get_assume_time(pod: Pod) -> int:
    """Nanosecond assume time, or 0 when absent."""
    value = pod.annotations.get(const.ANN_ASSUME_TIME)
    try:
        return int(value) if value is not None else 0
    except ValueError:
        return 0


def is_assumed(pod: Pod) -> bool:
    """The extender placed the pod (the annotation is there, whatever the
    flag)."""
    return const.ANN_CHIP_IDX in pod.annotations


def is_assigned(pod: Pod) -> bool:
    """The device plugin confirmed the placement."""
    return pod.annotations.get(const.ANN_ASSIGNED) == const.ASSIGNED_TRUE


def get_pod_group(pod: Pod) -> tuple[str, int]:
    """(group name, minimum members), or ("", 0) outside a gang."""
    group = pod.annotations.get(const.ANN_POD_GROUP, "")
    if not group:
        return "", 0
    try:
        minimum = int(pod.annotations.get(const.ANN_POD_GROUP_MIN, "0"))
    except ValueError:
        minimum = 0
    return group, max(minimum, 0)


def get_slice_shape(pod: Pod) -> tuple[int, ...] | None:
    """A gang's requested slice shape (``tpushare.io/slice-shape``), or
    None when absent or malformed: a typo degrades to placement without
    topology, never breaks a bind."""
    spec = pod.annotations.get(const.ANN_SLICE_SHAPE, "")
    if not spec:
        return None
    from tpushare_torch.topology.topology import parse_topology

    try:
        return parse_topology(str(spec))
    except ValueError:
        return None


def effective_scoring(pod: Pod, default: str | None = None) -> str:
    """The pod's scoring policy: its ``tpushare.io/scoring`` annotation
    when valid, else ``default`` (or ``TPUSHARE_SCORING``), else binpack.
    The prioritize verb and the chip picker both read it, so "spread"
    means fewer co-tenants across nodes and within one."""
    override = pod.annotations.get(const.ANN_SCORING, "")
    if override in const.SCORING_POLICIES:
        return override
    if default is None:
        default = os.environ.get("TPUSHARE_SCORING", "binpack")
    return default if default in const.SCORING_POLICIES else "binpack"


def pod_used_hbm(pod: Pod) -> int:
    """GiB the pod holds against its card: its grant, 0 once complete."""
    if is_complete_pod(pod):
        return 0
    return get_hbm_from_pod_annotation(pod)


def updated_pod_annotation_spec(pod: Pod, chip_ids: list[int], hbm_pod: int,
                                hbm_chip: int,
                                assume_time_ns: int | None = None,
                                trace_id: str | None = None,
                                trace_parent: str | None = None) -> Pod:
    """A deep copy of ``pod`` with the bind-time grant written: the card
    indices, the GiB granted and the card's, ``assigned`` "false" and the
    nanosecond assume time, which orders the device plugin's matching.
    The ledger is rebuilt from these annotations after a restart.
    ``trace_id`` adds the decision trace's key and ``trace_parent`` the
    causal parent of that decision (both observational only)."""
    new_pod = pod.deepcopy()
    ann = new_pod.metadata.setdefault("annotations", {})
    if ann is None:  # metadata.annotations may be an explicit null
        ann = new_pod.metadata["annotations"] = {}
    now_ns = time.time_ns() if assume_time_ns is None else assume_time_ns
    ann[const.ANN_CHIP_IDX] = ",".join(str(i) for i in chip_ids)
    ann[const.ANN_HBM_POD] = str(hbm_pod)
    ann[const.ANN_HBM_CHIP] = str(hbm_chip)
    ann[const.ANN_ASSIGNED] = const.ASSIGNED_FALSE
    ann[const.ANN_ASSUME_TIME] = str(now_ns)
    if trace_id:
        ann[const.ANN_TRACE_ID] = trace_id
    if trace_parent:
        ann[const.ANN_TRACE_PARENT] = trace_parent
    return new_pod
