"""Chip topology: coordinates, ICI adjacency, compact selection.

The port's copy of ``tpushare/topology/topology.py``, whole. A node with
an ICI spec ("2x2x1") gets a mesh or torus; a node without one (every
NVIDIA node: the port's daemon writes no topology) gets
:meth:`Topology.flat`, on which every chip has up to two neighbours by
index. The bin-packer uses it to pick compact chip sets for multi-chip
pods and to break ties between equally tight single-chip fits toward the
chip with the fewest free neighbours.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from itertools import combinations

# This module is pure geometry: it consumes topology specs and never
# guesses hardware facts of its own.


def parse_topology(spec: str) -> tuple[int, ...]:
    """Parse "2x2x1" → (2, 2, 1). Raises ValueError on malformed specs."""
    parts = spec.lower().split("x")
    dims = tuple(int(p) for p in parts)
    if not dims or any(d <= 0 for d in dims):
        raise ValueError(f"invalid topology spec: {spec!r}")
    return dims


@dataclass(frozen=True)
class Topology:
    """An ICI mesh/torus of chips, indexed row-major over coordinates."""

    dims: tuple[int, ...]
    torus: bool = False  # v5p 3D tori wrap; single-host meshes do not

    @classmethod
    def from_spec(cls, spec: str, tpu_type: str = "") -> "Topology":
        dims = parse_topology(spec)
        # Wraparound links only exist on pod-scale v5p/v4 tori where every
        # dimension is a multiple of 4; host-scale blocks are plain meshes.
        torus = tpu_type in ("v4", "v5p") and all(d >= 4 for d in dims)
        return cls(dims=dims, torus=torus)

    @classmethod
    def flat(cls, count: int) -> "Topology":
        """Degenerate 1-D topology for hosts with unknown wiring."""
        return cls(dims=(max(count, 0),))

    @property
    def chip_count(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    @lru_cache(maxsize=None)
    def coords(self, idx: int) -> tuple[int, ...]:
        """Row-major index → coordinate tuple."""
        if not 0 <= idx < self.chip_count:
            raise IndexError(idx)
        out = []
        for d in reversed(self.dims):
            out.append(idx % d)
            idx //= d
        return tuple(reversed(out))

    def index(self, coords: tuple[int, ...]) -> int:
        idx = 0
        for c, d in zip(coords, self.dims):
            idx = idx * d + c
        return idx

    @lru_cache(maxsize=None)
    def distance(self, a: int, b: int) -> int:
        """ICI hop distance (Manhattan on the mesh, wrapped on a torus)."""
        return self.distance_coords(self.coords(a), self.coords(b))

    def distance_coords(self, ca: tuple[int, ...],
                        cb: tuple[int, ...]) -> int:
        """Hop distance between two coordinate tuples."""
        total = 0
        for x, y, d in zip(ca, cb, self.dims):
            delta = abs(x - y)
            if self.torus:
                delta = min(delta, d - delta)
            total += delta
        return total

    def neighbors(self, idx: int) -> list[int]:
        """Chips one ICI hop away."""
        base = self.coords(idx)
        out = []
        for axis, d in enumerate(self.dims):
            if d == 1:
                continue
            for step in (-1, 1):
                c = base[axis] + step
                if self.torus:
                    c %= d
                elif not 0 <= c < d:
                    continue
                coords = base[:axis] + (c,) + base[axis + 1:]
                nb = self.index(coords)
                if nb != idx and nb not in out:
                    out.append(nb)
        return out

    def dispersion(self, chip_ids: list[int]) -> int:
        """Sum of pairwise ICI distances — lower is more compact."""
        return sum(self.distance(a, b) for a, b in combinations(chip_ids, 2))

    def select_compact(self, free: list[int], k: int) -> list[int] | None:
        """Choose ``k`` chips from ``free`` minimizing ICI dispersion.

        Greedy with every free chip as seed (host-scale chip counts are
        small — ≤16 — so this is effectively exact and O(n^3)).
        Returns None when fewer than ``k`` chips are free.
        """
        if k <= 0 or len(free) < k:
            return None
        if k == 1:
            return [free[0]]
        if len(free) == k:
            # Taking every free chip: there is exactly one choice, and a
            # whole-host grant (the common slice-gang member shape) must
            # not pay the O(n^3) seeded search for it.
            return sorted(free)
        best: list[int] | None = None
        best_cost = None
        # Seed/pool iteration over the SORTED free set: equally-compact
        # selections tie-break toward the lowest chip indices no matter
        # what order the caller's free list arrived in — the memoized
        # fast path and a direct recompute must never disagree.
        free_sorted = sorted(free)
        for seed in free_sorted:
            chosen = [seed]
            pool = [c for c in free_sorted if c != seed]
            while len(chosen) < k:
                nxt = min(pool, key=lambda c: sum(self.distance(c, x) for x in chosen))
                chosen.append(nxt)
                pool.remove(nxt)
            cost = self.dispersion(chosen)
            if best_cost is None or cost < best_cost:
                best, best_cost = chosen, cost
        return sorted(best) if best else None

    def free_neighbor_count(self, idx: int, free: set[int]) -> int:
        """How many of ``idx``'s ICI neighbors are in ``free``."""
        return sum(1 for nb in self.neighbors(idx) if nb in free)


def slice_host_grid(slice_topo: str, host_topo: str,
                    tpu_type: str = "") -> Topology | None:
    """The HOST-level grid of a multi-host slice: slice chip dims
    divided elementwise by host chip dims (e.g. an "8x8" v5e slice of
    "2x2" hosts is a 4x4 host grid; a v5p "4x4x8" slice of "2x2x1"
    hosts is a 2x2x8 host grid). Worker index i sits at
    ``grid.coords(i)`` (row-major — the TPU runtime's numbering), and
    ``grid.distance`` is the inter-host ICI hop count, torus-wrapped
    where the slice itself wraps. None when either topology is missing,
    malformed, or not an exact tiling."""
    if not slice_topo or not host_topo:
        return None
    try:
        s = parse_topology(slice_topo)
        h = parse_topology(host_topo)
    # Malformed specs mean "no grid", which every caller handles.
    except ValueError:
        return None
    h = h + (1,) * (len(s) - len(h))
    if len(h) > len(s) or any(si % hi for si, hi in zip(s, h)):
        return None
    dims = tuple(si // hi for si, hi in zip(s, h))
    if all(d == 1 for d in dims):
        return None  # single-host "slice": no inter-host grid
    # Wraparound follows the SLICE topology (same rule as from_spec).
    torus = tpu_type in ("v4", "v5p") and all(d >= 4 for d in s)
    return Topology(dims=dims, torus=torus)
