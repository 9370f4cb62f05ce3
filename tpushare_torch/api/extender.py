"""Scheduler-extender wire types.

The port's copy of ``tpushare/api/extender.py``'s filter, prioritize and
bind types: JSON-compatible dataclasses for the kube-scheduler ↔
extender webhook, read in either era's field casing (the legacy
capitalized names and the modern camelCase tags). Both the node-name and
the full-node forms of the filter are supported, and both victim forms of
the preempt verb (full pods, or bare uids).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from tpushare_torch.api.objects import Node, Pod


def _either(doc: dict, legacy: str, modern: str,
            default: Any = None) -> Any:
    """Read a wire field in either era's casing: the legacy v1.11
    ``pkg/scheduler/api`` structs had no json tags (Go marshals the
    exported — capitalized — field names; what the reference's vendored
    types put on the wire), the modern ``k8s.io/kube-scheduler/
    extender/v1`` tags are camelCase. One helper so every from_json
    handles both identically."""
    if legacy in doc:
        return doc[legacy]
    return doc.get(modern, default)


@dataclass
class ExtenderArgs:
    """Arguments of ``POST .../filter``."""

    pod: Pod
    node_names: list[str] | None = None
    nodes: list[Node] | None = None

    @classmethod
    def from_json(cls, doc: dict) -> "ExtenderArgs":
        pod = Pod(_either(doc, "Pod", "pod") or {})
        node_names = _either(doc, "NodeNames", "nodenames")
        nodes_doc = _either(doc, "Nodes", "nodes")
        nodes = None
        if nodes_doc and nodes_doc.get("items") is not None:
            nodes = [Node(n) for n in nodes_doc["items"]]
        return cls(pod=pod, node_names=node_names, nodes=nodes)

    def candidate_names(self) -> list[str]:
        if self.node_names is not None:
            return list(self.node_names)
        if self.nodes is not None:
            return [n.name for n in self.nodes]
        return []


@dataclass
class ExtenderFilterResult:
    """Result of ``POST .../filter``."""

    node_names: list[str] | None = None
    nodes: list[Node] | None = None
    failed_nodes: dict[str, str] = field(default_factory=dict)
    error: str = ""

    def to_json(self) -> dict:
        doc: dict = {"FailedNodes": self.failed_nodes, "Error": self.error}
        doc["NodeNames"] = self.node_names
        if self.nodes is not None:
            doc["Nodes"] = {
                "apiVersion": "v1",
                "kind": "NodeList",
                "items": [n.raw for n in self.nodes],
            }
        else:
            doc["Nodes"] = None
        return doc


@dataclass
class HostPriority:
    """One entry of the prioritize response (counterpart of the vendored
    ``schedulerapi.HostPriority``: Host + Score 0-10; the scheduler
    multiplies Score by the extender's registered weight)."""

    host: str
    score: int

    def to_json(self) -> dict:
        return {"Host": self.host, "Score": self.score}


def host_priority_list_to_json(entries: list[HostPriority]) -> list[dict]:
    """The prioritize verb's wire response is a bare JSON array
    (``schedulerapi.HostPriorityList``), not an object."""
    return [e.to_json() for e in entries]


@dataclass
class ExtenderBindingArgs:
    """Arguments of ``POST .../bind``."""

    pod_name: str
    pod_namespace: str
    pod_uid: str
    node: str

    @classmethod
    def from_json(cls, doc: dict) -> "ExtenderBindingArgs":
        return cls(
            pod_name=_either(doc, "PodName", "podName", ""),
            pod_namespace=_either(doc, "PodNamespace", "podNamespace", ""),
            pod_uid=_either(doc, "PodUID", "podUID", ""),
            node=_either(doc, "Node", "node", ""),
        )


@dataclass
class ExtenderBindingResult:
    """Result of ``POST .../bind``."""

    error: str = ""
    #: True when the error is an EXPECTED hold (gang member reserved,
    #: awaiting quorum): the scheduler must still retry (wire carries
    #: Error), but metrics/alerts must not count it as a failure.
    pending: bool = False

    def to_json(self) -> dict:
        return {"Error": self.error}


@dataclass
class Victims:
    """One node's proposed eviction set, in either wire form: full pods
    (``schedulerapi.Victims``) or bare uids (``MetaVictims``), by the
    scheduler's ``nodeCacheCapable``."""

    pods: list[Pod] = field(default_factory=list)
    uids: list[str] = field(default_factory=list)
    num_pdb_violations: int = 0

    @classmethod
    def from_json(cls, doc: dict) -> "Victims":
        pods = [Pod(p) for p in _either(doc, "Pods", "pods") or []
                if isinstance(p, dict)]
        # A MetaPod carries its uid at the top level; a full v1.Pod only
        # under metadata.
        uids = [_either(p.raw, "UID", "uid") for p in pods
                if "UID" in p.raw or "uid" in p.raw]
        pods = [p for p in pods if "UID" not in p.raw and "uid" not in p.raw]
        return cls(pods=pods, uids=uids,
                   num_pdb_violations=int(
                       _either(doc, "NumPDBViolations",
                               "numPDBViolations", 0)))

    def victim_uids(self) -> list[str]:
        return self.uids + [p.uid for p in self.pods if p.uid]


@dataclass
class ExtenderPreemptionArgs:
    """``POST .../preempt``: the preemptor and the scheduler's candidate
    victims a node, in either form."""

    pod: Pod
    node_victims: dict[str, Victims] = field(default_factory=dict)

    @classmethod
    def from_json(cls, doc: dict) -> "ExtenderPreemptionArgs":
        pod = Pod(_either(doc, "Pod", "pod") or {})
        raw = (_either(doc, "NodeNameToMetaVictims",
                       "nodeNameToMetaVictims")
               or _either(doc, "NodeNameToVictims",
                          "nodeNameToVictims") or {})
        victims = {name: Victims.from_json(v or {})
                   for name, v in raw.items()}
        return cls(pod=pod, node_victims=victims)


@dataclass
class ExtenderPreemptionResult:
    """The surviving candidate nodes, each with the victims this
    extender's resources need, always in the uid (MetaVictims) form."""

    node_victims: dict[str, list[str]] = field(default_factory=dict)
    pdb_violations: dict[str, int] = field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "NodeNameToMetaVictims": {
                name: {
                    "Pods": [{"UID": uid} for uid in uids],
                    "NumPDBViolations": self.pdb_violations.get(name, 0),
                }
                for name, uids in self.node_victims.items()
            }
        }
