"""Fleet-scale topology: per-slice host grids and the contiguous slice
placer for multi-host gangs.

The port's copy of ``tpushare/topology/fleet.py``. Every node that
advertises a slice id, a slice topology and a worker index is located on
its slice's host grid (:class:`HostGrid`); a gang annotated with a
requested slice shape (``tpushare.io/slice-shape``, chip dims like
``4x4x4``) gets a contiguous block of hosts elected for it
(:class:`SlicePlacer`) before any member binds, in the ring order its
collectives run. A ring whose neighbours sit ``d`` grid hops apart loads
each link with up to ``d`` streams, and a neighbour pair split across
slices crosses the datacenter network on every rotation; this module
keeps the hop counts small.

An NVIDIA node carries no host topology, so :func:`build_host_grids`
skips it and a slice-shape gang on such nodes places unconstrained, as
the reference places it on any node without a topology.

The placer runs once a gang (its first member's quorum pre-check), never
on the single-pod filter and prioritize path, and is memoized on the
exact :class:`NodeSummary` objects it read.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import permutations
from typing import Any, Sequence

from tpushare_torch.api.objects import Node, Pod
from tpushare_torch.cache.nodeinfo import MEMO_CAP, NodeInfo, NodeSummary
from tpushare_torch.topology.topology import Topology, parse_topology
from tpushare_torch.utils import node as nodeutils
from tpushare_torch.utils import pod as podutils
from tpushare_torch.utils import locks

#: Grid-hop equivalents charged to a ring hop that leaves the slice (or
#: whose end has no grid position): a crossing of the datacenter network
#: costs about an order of magnitude more than one ICI hop. Feeds only
#: the dimensionless contiguity score.
DCN_HOP_WEIGHT = 8


@dataclass(frozen=True)
class HostGrid:
    """One multi-host slice's host grid: which node sits where.
    ``grid.distance_coords`` is the inter-host hop count (wrapped where
    the slice wraps)."""

    slice_id: str
    grid: Topology
    #: Chip dims of one host (``(2, 2, 1)`` for a v5p host): a requested
    #: slice shape divided by these is the host block.
    host_dims: tuple[int, ...]
    #: host coords -> node name, for every located member of the slice.
    hosts: dict[tuple[int, ...], str]

    def distance(self, a: tuple[int, ...], b: tuple[int, ...]) -> int:
        return self.grid.distance_coords(a, b)


def build_host_grids(infos: Sequence[NodeInfo]) -> dict[str, HostGrid]:
    """Group located nodes into one :class:`HostGrid` a slice. Nodes with
    no slice id, grid position or parseable host topology are skipped,
    and so is a node whose grid disagrees with the first one seen for its
    slice: one mis-labelled host must not corrupt a slice's geometry."""
    members: dict[str, dict[tuple[int, ...], str]] = {}
    grids: dict[str, tuple[Topology, tuple[int, ...]]] = {}
    for info in infos:
        node = info.node
        sid = nodeutils.get_slice_id(node)
        if not sid:
            continue
        pos = nodeutils.host_position(node)
        if pos is None:
            continue
        try:
            host_dims = parse_topology(nodeutils.get_topology(node))
        # An unparseable host topology means no grid position.
        except ValueError:
            continue
        coords, grid = pos
        first = grids.setdefault(sid, (grid, host_dims))
        if first[0].dims != grid.dims or first[0].torus != grid.torus:
            continue
        members.setdefault(sid, {})[coords] = info.name
    return {
        sid: HostGrid(slice_id=sid, grid=grids[sid][0],
                      host_dims=grids[sid][1], hosts=hosts)
        for sid, hosts in members.items()
    }


def host_block(shape: tuple[int, ...],
               host_dims: tuple[int, ...]) -> tuple[int, ...] | None:
    """A requested slice shape (chip dims) as the block of hosts it spans
    on a slice of ``host_dims`` hosts, or None when it does not tile
    (``slice_host_grid``'s arithmetic)."""
    h = host_dims + (1,) * (len(shape) - len(host_dims))
    if len(h) > len(shape):
        return None
    if any(s % d for s, d in zip(shape, h)):
        return None
    return tuple(s // d for s, d in zip(shape, h))


def worker_ordinal(name: str) -> int | None:
    """A pod name's worker ordinal, its trailing integer (``w-3``,
    ``stage_12``: the indexed Job's numbering), or None."""
    digits = ""
    for ch in reversed(name):
        if ch.isdigit():
            digits = ch + digits
        elif digits:
            break
        elif ch in "-_.":
            continue
        else:
            break
    return int(digits) if digits else None


def worker_sort_key(name: str) -> tuple[int, int, str]:
    """Ring order of gang member names: by numeric ordinal where the name
    has one (so ``w-10`` follows ``w-9``, not ``w-1``), by name
    otherwise."""
    ordinal = worker_ordinal(name)
    if ordinal is None:
        return (1, 0, name)
    return (0, ordinal, name)


def snake_order(dims: tuple[int, ...]) -> list[tuple[int, ...]]:
    """Boustrophedon walk over a block: consecutive entries are grid
    neighbours, so the ring pays one hop a rotation everywhere but,
    perhaps, the closing hop."""
    if not dims:
        return [()]
    head = snake_order(dims[:-1])
    out: list[tuple[int, ...]] = []
    for i, prefix in enumerate(head):
        rng = (range(dims[-1]) if i % 2 == 0
               else range(dims[-1] - 1, -1, -1))
        out.extend(prefix + (z,) for z in rng)
    return out


def ring_hops(coords: Sequence[tuple[int, ...] | None],
              grid: Topology | None) -> list[int | None]:
    """Grid distance of each hop of the closed ring over ``coords`` in
    order, the closing hop included; a hop with an unknown end is None
    (a datacenter-network hop)."""
    n = len(coords)
    out: list[int | None] = []
    for i in range(n):
        a, b = coords[i], coords[(i + 1) % n]
        out.append(None if a is None or b is None or grid is None
                   else grid.distance_coords(a, b))
    return out


def ring_stats(coords: Sequence[tuple[int, ...] | None],
               grid: Topology | None) -> dict[str, Any]:
    """A placement's ring quality: ``contiguity`` (1.0 when every hop is
    one link; network hops weigh ``DCN_HOP_WEIGHT``), ``worstHop``,
    ``dcnHops`` and ``internalLinks`` (adjacent pairs within the set)."""
    hops = ring_hops(coords, grid)
    n = len(hops)
    if n == 0:
        return {"hops": [], "contiguity": 0.0, "worstHop": 0,
                "dcnHops": 0, "internalLinks": 0}
    weighted = [DCN_HOP_WEIGHT if h is None else h for h in hops]
    total = sum(weighted)
    if total == 0:
        # One located member, or co-located coords: no traffic crosses a
        # link, which is contiguous, not fragmented.
        return {"hops": hops, "contiguity": 1.0, "worstHop": 0,
                "dcnHops": 0, "internalLinks": 0}
    located = [c for c in coords if c is not None]
    internal = 0
    if grid is not None:
        internal = sum(
            1 for i in range(len(located))
            for j in range(i + 1, len(located))
            if grid.distance_coords(located[i], located[j]) == 1)
    return {
        "hops": hops,
        "contiguity": round(n / total, 4) if total else 0.0,
        "worstHop": max(weighted),
        "dcnHops": sum(1 for h in hops if h is None),
        "internalLinks": internal,
    }


def gang_ring_stats(nodes: Sequence[Node]) -> dict[str, Any] | None:
    """Ring stats of a placed gang, members in ring order. The grid is the
    first located member's; members on other slices or with no position
    count as network hops. None when no member has a grid position."""
    anchor: tuple[str, Topology] | None = None
    positioned: list[tuple[str, tuple[int, ...]] | None] = []
    for node in nodes:
        sid = nodeutils.get_slice_id(node)
        pos = nodeutils.host_position(node)
        if pos is None or not sid:
            positioned.append(None)
            continue
        if anchor is None:
            anchor = (sid, pos[1])
        positioned.append((sid, pos[0]))
    if anchor is None:
        return None
    sid0, grid = anchor
    coords = [p[1] if p is not None and p[0] == sid0 else None
              for p in positioned]
    return ring_stats(coords, grid)


@dataclass(frozen=True)
class Placement:
    """A gang's elected contiguous hosts in ring (snake) order: member i
    is steered onto ``hosts[i]``."""

    slice_id: str
    hosts: tuple[str, ...]
    coords: tuple[tuple[int, ...], ...]
    grid_dims: tuple[int, ...]
    torus: bool
    stats: dict[str, Any]

    def host_set(self) -> frozenset[str]:
        return frozenset(self.hosts)


class SlicePlacer:
    """Elects contiguous host blocks for slice-shape gangs.

    ``elect`` enumerates, on each slice's grid, every placement of the
    host block (every axis permutation; offsets wrap on a torus) whose
    hosts all fit the member's request, ranks them by total ring hops,
    worst hop and internal links, and returns the winner in ring order.
    The answer is memoized a gang against the summaries it read and the
    table's size, so a trickling gang's later members read one entry."""

    def __init__(self, cache: Any) -> None:
        self.cache = cache
        self._lock = locks.TracingRLock("topology/placer")
        #: (namespace, gang) -> (request key, summary reads, fleet size,
        #: elected placement); under ``_lock``.
        self._memo: dict[tuple[str, str], tuple[
            tuple[Any, ...],
            tuple[tuple[NodeInfo, NodeSummary], ...],
            int,
            Placement | None]] = locks.guarded_dict(
                self._lock, "SlicePlacer._memo")

    @staticmethod
    def _fits(s: NodeSummary, req_chips: int, req_hbm: int) -> bool:
        if not s.sharing:
            return False
        if req_chips > 0:
            return len(s.free_chips) >= req_chips
        if req_hbm > 0:
            return s.max_free_chip >= req_hbm
        return False

    def elect(self, gang_key: tuple[str, str],
              pod: Pod) -> Placement | None:
        """The gang's elected placement, or None when the pod has no valid
        slice shape or no contiguous candidate exists now. A change to any
        summary the election read invalidates the memo."""
        shape = podutils.get_slice_shape(pod)
        if shape is None:
            return None
        req_chips = podutils.get_chips_from_pod_resource(pod)
        req_hbm = podutils.get_hbm_from_pod_resource(pod)
        req_key = (shape, req_chips, req_hbm)
        table = self.cache.node_table()
        with self._lock:
            ent = self._memo.get(gang_key)
        if ent is not None:
            key, reads, fleet_n, placement = ent
            if (key == req_key and fleet_n == len(table)
                    and all(info._summary is s for info, s in reads)):
                return placement
        reads_out: dict[str, tuple[NodeInfo, NodeSummary]] = {}
        # The election's one fleet scan, once a gang.
        infos = list(table.values())
        placement = self._elect(pod, shape, req_chips, req_hbm,
                                infos, reads_out)
        with self._lock:
            if len(self._memo) >= MEMO_CAP:
                self._memo.clear()
            self._memo[gang_key] = (req_key, tuple(reads_out.values()),
                                    len(table), placement)
        return placement

    def forget(self, gang_key: tuple[str, str]) -> None:
        """Drop a gang's memo entry (committed or rolled back)."""
        with self._lock:
            self._memo.pop(gang_key, None)

    def _elect(self, pod: Pod, shape: tuple[int, ...], req_chips: int,
               req_hbm: int, infos: list[NodeInfo],
               reads: dict[str, tuple[NodeInfo, NodeSummary]],
               ) -> Placement | None:
        grids = build_host_grids(infos)
        if not grids:
            return None
        by_name = {i.name: i for i in infos}
        free: dict[str, bool] = {}

        def host_free(name: str) -> bool:
            cached = free.get(name)
            if cached is not None:
                return cached
            info = by_name.get(name)
            if info is None:
                return False
            s = info._summary
            if s is None:
                s = info.summary()
            reads[name] = (info, s)
            # A cordoned or untolerated-taint host never binds a member; a
            # cordon swaps the node document, which invalidates the
            # summary the memo pinned.
            ok = (self._fits(s, req_chips, req_hbm)
                  and nodeutils.is_schedulable(info.node, pod))
            free[name] = ok
            return ok

        best: tuple[tuple[Any, ...], Placement] | None = None
        for sid in sorted(grids):
            hg = grids[sid]
            block = host_block(shape, hg.host_dims)
            if block is None:
                continue
            dims = hg.grid.dims
            block = block + (1,) * (len(dims) - len(block))
            if len(block) > len(dims):
                continue
            for coords, hosts in self._candidates(hg, block, host_free):
                stats = ring_stats(coords, hg.grid)
                # Fewest total hops, then the smallest worst hop, then the
                # most internal links; slice id and origin break ties.
                rank = (sum(h for h in stats["hops"] if h is not None),
                        stats["worstHop"], -stats["internalLinks"],
                        sid, coords[0])
                if best is None or rank < best[0]:
                    best = (rank, Placement(
                        slice_id=sid, hosts=tuple(hosts),
                        coords=tuple(coords), grid_dims=dims,
                        torus=hg.grid.torus, stats=stats))
        return best[1] if best is not None else None

    @staticmethod
    def _candidates(hg: HostGrid, block: tuple[int, ...],
                    host_free: Any,
                    ) -> list[tuple[list[tuple[int, ...]], list[str]]]:
        """Every (coords, hosts) placement of ``block`` on ``hg``, both in
        ring order, whose hosts all exist and fit."""
        dims = hg.grid.dims
        out: list[tuple[list[tuple[int, ...]], list[str]]] = []
        for perm in sorted(set(permutations(block))):
            if any(p > d for p, d in zip(perm, dims)):
                continue
            walk = snake_order(perm)
            axis_origins = [
                range(d) if hg.grid.torus else range(d - p + 1)
                for p, d in zip(perm, dims)]
            origins: list[tuple[int, ...]] = [()]
            for rng in axis_origins:
                origins = [o + (v,) for o in origins for v in rng]
            for origin in origins:
                coords = [tuple((o + w) % d for o, w, d
                                in zip(origin, step, dims))
                          for step in walk]
                hosts = [hg.hosts.get(c, "") for c in coords]
                if all(h and host_free(h) for h in hosts):
                    out.append((coords, hosts))
        return out
