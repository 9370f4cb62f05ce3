"""Views over raw apiserver documents: ``Pod``, ``Node``,
``PodDisruptionBudget`` and ``ConfigMap``, and the ``Binding`` the
extender posts.

The port's copy of ``tpushare/api/objects.py`` (``K8sObject``, ``Pod``,
``Node``, ``PodDisruptionBudget``, ``ConfigMap``, ``binding_doc``), cut to
the fields the device plugin, the grant watchdog and the scheduler
extender read. A view holds a reference
to the underlying dict (``raw``), so a caller mutates a document and
commits it back as it came.
"""

from __future__ import annotations

import copy
import re
from typing import Iterator, TypeVar

_K = TypeVar("_K", bound="K8sObject")

_QUANTITY_RE = re.compile(r"^([+-]?[0-9.]+(?:[eE][+-]?[0-9]+)?)([A-Za-z]*)$")

_SUFFIX_MULTIPLIERS = {
    "": 1, "k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12, "P": 10**15,
    "E": 10**18, "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40,
    "Pi": 2**50, "Ei": 2**60, "m": 1e-3,
}


def parse_quantity(value) -> int:
    """A Kubernetes resource quantity ("2", "16Gi", "500m") as an integer,
    truncated toward zero as ``resource.Quantity.Value()`` does."""
    if isinstance(value, (int, float)):
        return int(value)
    m = _QUANTITY_RE.match(str(value).strip())
    if not m:
        raise ValueError(f"invalid quantity: {value!r}")
    number, suffix = m.groups()
    try:
        mult = _SUFFIX_MULTIPLIERS[suffix]
    except KeyError:
        raise ValueError(f"invalid quantity suffix: {value!r}") from None
    return int(float(number) * mult)


class K8sObject:
    """Metadata accessors over a raw apiserver JSON document."""

    __slots__ = ("raw",)

    def __init__(self, raw: dict) -> None:
        self.raw = raw

    @property
    def metadata(self) -> dict:
        return self.raw.setdefault("metadata", {})

    @property
    def name(self) -> str:
        return self.metadata.get("name", "")

    @property
    def namespace(self) -> str:
        return self.metadata.get("namespace", "default")

    @property
    def uid(self) -> str:
        return self.metadata.get("uid", "")

    @property
    def resource_version(self) -> str:
        return self.metadata.get("resourceVersion", "")

    @property
    def annotations(self) -> dict:
        return self.metadata.get("annotations") or {}

    @property
    def labels(self) -> dict:
        return self.metadata.get("labels") or {}

    @property
    def deletion_timestamp(self) -> str | None:
        return self.metadata.get("deletionTimestamp")

    def deepcopy(self: _K) -> _K:
        return type(self)(copy.deepcopy(self.raw))

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"{type(self).__name__}({self.namespace}/{self.name})"


class Pod(K8sObject):
    """A ``v1.Pod`` view."""

    @property
    def spec(self) -> dict:
        return self.raw.setdefault("spec", {})

    @property
    def status(self) -> dict:
        return self.raw.get("status") or {}

    @property
    def node_name(self) -> str:
        return self.spec.get("nodeName", "")

    @property
    def nominated_node_name(self) -> str:
        """``status.nominatedNodeName``: the node a preemption round
        earmarked for the pod until it binds."""
        return self.status.get("nominatedNodeName", "")

    @property
    def phase(self) -> str:
        return self.status.get("phase", "")

    @property
    def priority(self) -> int:
        """``spec.priority``; 0 when unset."""
        val = self.spec.get("priority")
        try:
            return int(val) if val is not None else 0
        except (TypeError, ValueError):
            return 0

    @property
    def containers(self) -> list[dict]:
        return self.spec.get("containers") or []

    def iter_resource_limits(self, resource: str) -> Iterator[int]:
        """The parsed limit of ``resource`` of each container that sets
        one."""
        for c in self.containers:
            limits = (c.get("resources") or {}).get("limits") or {}
            if resource in limits:
                yield parse_quantity(limits[resource])

    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


class Node(K8sObject):
    """A ``v1.Node`` view."""

    @property
    def spec(self) -> dict:
        return self.raw.get("spec") or {}

    @property
    def unschedulable(self) -> bool:
        """``spec.unschedulable``: the node is cordoned."""
        return bool(self.spec.get("unschedulable"))

    @property
    def taints(self) -> list[dict]:
        return self.spec.get("taints") or []

    @property
    def status(self) -> dict:
        return self.raw.get("status") or {}

    @property
    def ready(self) -> bool:
        """The ``Ready`` node condition. A node with no conditions at all
        (fixtures, fresh fakes) counts as ready: kubelet's absence shows as
        an ``Unknown`` or ``False`` condition, not as missing status."""
        for cond in self.status.get("conditions") or []:
            if cond.get("type") == "Ready":
                return cond.get("status") == "True"
        return True

    @property
    def capacity(self) -> dict:
        return self.status.get("capacity") or {}

    def capacity_of(self, resource: str) -> int:
        val = self.capacity.get(resource)
        return parse_quantity(val) if val is not None else 0


class PodDisruptionBudget(K8sObject):
    """A ``policy/v1.PodDisruptionBudget`` view: what the preempt verb
    needs to count ``NumPDBViolations`` for the victim sets it names."""

    @property
    def spec(self) -> dict:
        return self.raw.get("spec") or {}

    @property
    def status(self) -> dict:
        return self.raw.get("status") or {}

    @property
    def disruptions_allowed(self) -> int:
        """``status.disruptionsAllowed``, which the disruption controller
        keeps and upstream preemption reads."""
        try:
            return int(self.status.get("disruptionsAllowed", 0))
        except (TypeError, ValueError):
            return 0

    @property
    def disrupted_pods(self) -> set[str]:
        """Names of pods whose disruption is in flight
        (``status.disruptedPods``)."""
        return set((self.status.get("disruptedPods") or {}).keys())

    def matches(self, pod: Pod) -> bool:
        """Namespace and label selector (``matchLabels``; In, NotIn,
        Exists and DoesNotExist of ``matchExpressions``; another operator
        matches nothing). An empty selector matches nothing, as in the
        scheduler's ``filterPodsWithPDBViolation``."""
        if pod.namespace != self.namespace:
            return False
        selector = self.spec.get("selector")
        if not selector or (not selector.get("matchLabels")
                            and not selector.get("matchExpressions")):
            return False
        labels = pod.labels
        for k, v in (selector.get("matchLabels") or {}).items():
            if labels.get(k) != v:
                return False
        for expr in selector.get("matchExpressions") or []:
            key = expr.get("key", "")
            op = expr.get("operator", "")
            values = expr.get("values") or []
            if op == "In":
                if labels.get(key) not in values:
                    return False
            elif op == "NotIn":
                if key in labels and labels[key] in values:
                    return False
            elif op == "Exists":
                if key not in labels:
                    return False
            elif op == "DoesNotExist":
                if key in labels:
                    return False
            else:
                return False
        return True


class ConfigMap(K8sObject):
    """A ``v1.ConfigMap`` view: the quota table's document."""

    @property
    def data(self) -> dict:
        return self.raw.get("data") or {}


def binding_doc(pod: Pod, node_name: str) -> dict:
    """The ``v1.Binding`` posted to ``pods/{name}/binding``."""
    return {
        "apiVersion": "v1",
        "kind": "Binding",
        "metadata": {"name": pod.name, "namespace": pod.namespace,
                     "uid": pod.uid},
        "target": {"apiVersion": "v1", "kind": "Node", "name": node_name},
    }
