"""Pod-level readers and classifiers the node daemon calls.

The port's copy of the twelve helpers of ``tpushare/utils/pod.py`` that
the device plugin and the grant watchdog use, with the same semantics:
the annotation schema stays the extender's.
"""

from __future__ import annotations

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
    """Sum of the containers' ``tpu-hbm`` limits, GiB."""
    return sum(pod.iter_resource_limits(const.HBM_RESOURCE))


def get_chips_from_pod_resource(pod: Pod) -> int:
    """Sum of the containers' whole-card limits."""
    return sum(pod.iter_resource_limits(const.CHIP_RESOURCE))


def is_tpu_chip_pod(pod: Pod) -> bool:
    """The pod requests whole cards rather than an HBM slice."""
    return get_chips_from_pod_resource(pod) > 0


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


def pod_used_hbm(pod: Pod) -> int:
    """GiB the pod holds against its card: its grant, 0 once complete."""
    if is_complete_pod(pod):
        return 0
    return get_hbm_from_pod_annotation(pod)
