"""Node-template election for scale-up: WHAT to provision, and WHERE.

The port's copy of ``tpushare/autoscale/provision.py``. An H100 node has
no host grid (:func:`tpushare_torch.topology.fleet.build_host_grids`
skips it), so on an H100 fleet the election falls to the template clone;
on TPU node documents it is the reference's election.

Arbitrary capacity is the fallback, not the preference. A slice-shape
gang's collectives run over the ICI torus, and :class:`SlicePlacer`
can only elect a contiguous block from hosts that exist — so a new
node that *completes a hole in an existing slice grid* is worth more
than the same chips anywhere else: it turns a partial slice into one
the placer can hand out at ring contiguity 1.0. The election therefore
prefers, in order:

1. a missing coordinate on an existing :class:`HostGrid` (most
   occupied ICI neighbors first — extend the block, don't start a new
   island), cloned from a sibling host so the slice stays homogeneous;
2. a clone of the roomiest existing sharing node that fits the shape;
3. a generic node sized to the shape (empty fleet cold-start).
"""

from __future__ import annotations

from typing import Any, Sequence

from tpushare_torch.cache.nodeinfo import NodeInfo
from tpushare_torch.k8s import builders
from tpushare_torch.topology import fleet as topo
from tpushare_torch.utils import node as nodeutils

#: (hbm GiB, whole chips) — the DemandTracker's shape tuple.
Shape = tuple[int, int]


def _fits_caps(caps: Sequence[int], shape: Shape) -> bool:
    """Would a node with per-chip capacities ``caps`` admit ``shape``?
    Same arithmetic as the filter's ``_admit`` against an EMPTY node."""
    hbm, chips = shape
    if not caps:
        return False
    if chips > 0:
        return len(caps) >= chips
    if hbm <= 0:
        return False
    return max(caps) >= hbm


def _fresh_name(base: str, existing: frozenset[str]) -> str:
    for i in range(1, len(existing) + 2):
        name = f"{base}-{i}"
        if name not in existing:
            return name
    return base  # unreachable: the range covers every collision


def _slice_hole(infos: Sequence[NodeInfo], shape: Shape,
                existing: frozenset[str]) -> tuple[dict, dict] | None:
    """A node document filling the best hole in an existing slice
    grid, or None when every known grid is complete (or too small for
    the shape). Best = most occupied ICI neighbors, so each scale-up
    extends a contiguous block instead of opening a new gap."""
    grids = topo.build_host_grids(infos)
    by_name = {i.name: i for i in infos}
    best: tuple[tuple[int, int, tuple[int, ...]], dict, dict] | None = None
    for sid in sorted(grids):
        hg = grids[sid]
        member = by_name.get(next(iter(sorted(hg.hosts.values()))))
        if member is None:
            continue
        caps = nodeutils.get_chip_capacities(member.node)
        if not _fits_caps(caps, shape):
            continue
        for idx in range(hg.grid.chip_count):
            coords = hg.grid.coords(idx)
            if coords in hg.hosts:
                continue
            occupied = sum(
                1 for n in hg.grid.neighbors(idx)
                if hg.grid.coords(n) in hg.hosts)
            remaining = hg.grid.chip_count - len(hg.hosts) - 1
            # Rank: most occupied neighbors, then lowest worker index
            # (deterministic); negative for min().
            rank = (-occupied, idx, tuple(coords))
            if best is not None and rank >= best[0]:
                continue
            name = _fresh_name(f"autoscale-{sid}-w{idx}", existing)
            doc = builders.make_node(
                name, chips=len(caps), chip_hbm=list(caps),
                topology=nodeutils.get_topology(member.node),
                tpu_type=nodeutils.get_tpu_type(member.node),
                slice_id=sid,
                slice_topology=nodeutils.get_slice_topology(member.node),
                worker_index=idx)
            detail = {"kind": "slice-completion", "sliceId": sid,
                      "workerIndex": idx, "occupiedNeighbors": occupied,
                      "holesRemaining": remaining}
            best = (rank, doc, detail)
    if best is None:
        return None
    return best[1], best[2]


def elect_template(infos: Sequence[NodeInfo], shape: Shape,
                   existing: frozenset[str]) -> tuple[dict, dict[str, Any]]:
    """(node document, election detail) for ONE new node able to admit
    ``shape``. ``existing`` is the current fleet's node names (the new
    name must not collide — apiserver create is 409 on conflict)."""
    hole = _slice_hole(infos, shape, existing)
    if hole is not None:
        return hole
    template: NodeInfo | None = None
    for info in infos:
        caps = nodeutils.get_chip_capacities(info.node)
        if not _fits_caps(caps, shape):
            continue
        if (template is None
                or sum(caps) > sum(
                    nodeutils.get_chip_capacities(template.node))):
            template = info
    if template is not None:
        caps = nodeutils.get_chip_capacities(template.node)
        doc = builders.make_node(
            _fresh_name("autoscale", existing),
            chips=len(caps), chip_hbm=list(caps),
            topology=nodeutils.get_topology(template.node),
            tpu_type=nodeutils.get_tpu_type(template.node))
        return doc, {"kind": "template", "clonedFrom": template.name}
    # Cold start (or every node is too small for the shape): size a
    # generic node to the request itself.
    hbm, chips = shape
    n_chips = max(chips, 1)
    per_chip = max(hbm, 16)
    doc = builders.make_node(
        _fresh_name("autoscale", existing),
        chips=n_chips, hbm_per_chip=per_chip,
        topology=f"{n_chips}x1x1")
    return doc, {"kind": "generic", "chips": n_chips,
                 "chipHbmGiB": per_chip}
