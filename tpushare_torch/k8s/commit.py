"""Precondition-carrying commits, the port's copy of
``tpushare/k8s/commit.py``.

All durable scheduler state lives in pod and node annotations, so an
annotation PUT is a commit. Every commit carries the ``resourceVersion``
it read, so that a concurrent writer turns the PUT into a typed
:class:`~tpushare_torch.k8s.errors.ConflictError` the caller retries, and
a pod commit carries the ``uid``, so that a delete-and-recreate under the
same name cannot absorb a stale grant.
"""

from __future__ import annotations

from tpushare_torch.api.objects import Node, Pod


class PreconditionError(ValueError):
    """The object offered for commit carries no optimistic-concurrency
    precondition: committing it would be a blind last-write-wins PUT."""


def committed_update_pod(client, pod: Pod) -> Pod:
    """PUT ``pod`` with its resourceVersion and uid preconditions."""
    if not pod.resource_version:
        raise PreconditionError(
            f"refusing blind pod commit for {pod.key()}: no "
            "resourceVersion; mutate a freshly read copy")
    if not pod.uid:
        raise PreconditionError(
            f"refusing blind pod commit for {pod.key()}: no uid")
    return client.update_pod(pod)


def committed_update_node(client, node: Node) -> Node:
    """PUT ``node`` with its resourceVersion precondition."""
    if not node.resource_version:
        raise PreconditionError(
            f"refusing blind node commit for {node.name}: no "
            "resourceVersion; mutate a freshly read copy")
    return client.update_node(node)
