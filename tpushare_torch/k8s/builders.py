"""Builders of pod and node documents (tests, harnesses, samples).

The port's copy of ``tpushare/k8s/builders.py``: a pod is one container
with the extended resource in ``resources.limits``; a node is what the
device plugin advertises (capacity, per-chip GiB and topology
annotations). An empty ``topology`` reads as none, as on an NVIDIA node.
"""

from __future__ import annotations

from tpushare_torch.utils import const


def make_pod(name: str, hbm: int = 0, chips: int = 0,
             namespace: str = "default", node_name: str = "",
             annotations: dict | None = None, phase: str = "Pending",
             uid: str | None = None, priority: int | None = None,
             container_hbm: list[int] | None = None,
             labels: dict | None = None) -> dict:
    """``container_hbm`` builds a multi-container pod (one container per
    entry); otherwise a single container carries the whole request."""
    if container_hbm is not None:
        containers = [
            {"name": f"c{i}",
             "resources": {"limits": {const.HBM_RESOURCE: str(h)}}}
            for i, h in enumerate(container_hbm)]
    else:
        limits = {}
        if hbm:
            limits[const.HBM_RESOURCE] = str(hbm)
        if chips:
            limits[const.CHIP_RESOURCE] = str(chips)
        containers = [{"name": "main", "resources": {"limits": limits}}]
    doc: dict = {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {"name": name, "namespace": namespace,
                     "annotations": dict(annotations or {}),
                     **({"labels": dict(labels)} if labels else {})},
        "spec": {"containers": containers},
        "status": {"phase": phase},
    }
    if uid:
        doc["metadata"]["uid"] = uid
    if node_name:
        doc["spec"]["nodeName"] = node_name
    if priority is not None:
        doc["spec"]["priority"] = priority
    return doc


def make_node(name: str, chips: int = 4, hbm_per_chip: int = 16,
              topology: str = "2x2x1", tpu_type: str = "v5e",
              chip_hbm: list[int] | None = None,
              slice_id: str = "", slice_topology: str = "",
              worker_index: int | None = None,
              unschedulable: bool = False,
              taints: list[dict] | None = None) -> dict:
    caps = chip_hbm if chip_hbm is not None else [hbm_per_chip] * chips
    annotations = {
        const.ANN_NODE_CHIP_HBM: ",".join(str(c) for c in caps),
        const.ANN_NODE_TOPOLOGY: topology,
        const.ANN_NODE_TPU_TYPE: tpu_type,
    }
    if slice_id:
        annotations[const.ANN_NODE_SLICE] = slice_id
    if slice_topology:
        annotations[const.ANN_NODE_SLICE_TOPOLOGY] = slice_topology
    if worker_index is not None:
        annotations[const.ANN_NODE_WORKER] = str(worker_index)
    spec: dict = {}
    if unschedulable:
        spec["unschedulable"] = True
    if taints:
        spec["taints"] = list(taints)
    return {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": {
            "name": name,
            "annotations": annotations,
        },
        **({"spec": spec} if spec else {}),
        "status": {
            "capacity": {
                const.HBM_RESOURCE: str(sum(caps)),
                const.CHIP_RESOURCE: str(len(caps)),
            },
            "allocatable": {
                const.HBM_RESOURCE: str(sum(caps)),
                const.CHIP_RESOURCE: str(len(caps)),
            },
        },
    }
