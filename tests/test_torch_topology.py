"""The port's topology (``tpushare_torch/topology/topology.py``) against
the JAX package's, on every spec ``tests/test_topology.py`` uses and on
the flat topology an NVIDIA node gets.

Each case builds both topologies from the same spec and compares their
geometry (dims, torus, coordinates, indices, neighbours, every pairwise
distance) and, over free sets drawn from a numpy seed, ``select_compact``
for every k and ``free_neighbor_count`` for every chip. Host integers:
the outcomes must be equal.
"""

from __future__ import annotations

import numpy as np
import pytest

from tpushare.topology import topology as JT
from tpushare_torch.topology import topology as TT

#: (constructor, args): every spec of tests/test_topology.py, the flat
#: topologies of NVIDIA nodes (8 cards an H100 host, and smaller), and
#: the host grids its slice tests build directly.
SPECS = [
    ("from_spec", ("2x4",)),
    ("from_spec", ("4x4x4", "v5p")),
    ("from_spec", ("2x2x1", "v5p")),
    ("from_spec", ("2x2",)),
    ("from_spec", ("2x2x1",)),
    ("from_spec", ("1",)),
    ("flat", (4,)),
    ("flat", (8,)),
    ("flat", (2,)),
    ("flat", (1,)),
    ("flat", (0,)),
    ("dims", ((2, 2, 2),)),
    ("dims", ((2, 2),)),
]


def build(mod, kind, args):
    if kind == "from_spec":
        return mod.Topology.from_spec(*args)
    if kind == "flat":
        return mod.Topology.flat(*args)
    return mod.Topology(dims=args[0])


def geometry(t) -> dict:
    n = t.chip_count
    return {
        "dims": t.dims, "torus": t.torus, "n": n,
        "coords": [t.coords(i) for i in range(n)],
        "index": [t.index(t.coords(i)) for i in range(n)],
        "neighbors": [t.neighbors(i) for i in range(n)],
        "distance": [[t.distance(a, b) for b in range(n)]
                     for a in range(n)],
    }


def free_sets(n: int, seed: int, count: int = 12) -> list[list[int]]:
    """Seeded free sets: empty, whole, and random subsets in random
    order (the picker must not depend on the order it is given)."""
    rng = np.random.default_rng(seed)
    out = [[], list(range(n))]
    for _ in range(count):
        size = int(rng.integers(0, min(n, 16) + 1))
        out.append([int(i) for i in rng.permutation(n)[:size]])
    return out


@pytest.mark.parametrize("kind,args", SPECS,
                         ids=[f"{k}-{a}" for k, a in SPECS])
def test_geometry_matches(kind, args):
    assert geometry(build(TT, kind, args)) == geometry(
        build(JT, kind, args))


@pytest.mark.parametrize("kind,args", SPECS,
                         ids=[f"{k}-{a}" for k, a in SPECS])
def test_compact_selection_matches(kind, args):
    jt, tt = build(JT, kind, args), build(TT, kind, args)
    n = tt.chip_count
    for seed, free in enumerate(free_sets(n, seed=len(SPECS) + n)):
        for k in range(0, min(len(free), 8) + 2):
            got, want = tt.select_compact(free, k), jt.select_compact(free,
                                                                     k)
            assert got == want, (free, k)
            if got:
                assert tt.dispersion(got) == jt.dispersion(want)
        fset = set(free)
        assert [tt.free_neighbor_count(i, fset) for i in range(n)] == [
            jt.free_neighbor_count(i, fset) for i in range(n)]


@pytest.mark.parametrize("spec", ["2x2x1", "2x4", "8", "4x4x4", "1x1"])
def test_parse_matches(spec):
    assert TT.parse_topology(spec) == JT.parse_topology(spec)


@pytest.mark.parametrize("bad", ["", "0x2", "2x-1", "axb"])
def test_parse_refuses_what_the_reference_refuses(bad):
    with pytest.raises(ValueError):
        JT.parse_topology(bad)
    with pytest.raises(ValueError):
        TT.parse_topology(bad)


@pytest.mark.parametrize("slice_topo,host_topo,tpu_type", [
    ("8x8", "2x2", "v5e"), ("4x4x8", "2x2x1", "v5p"), ("", "2x2", "v5e"),
    ("2x2", "", "v5e"), ("2x2", "2x2", "v5e"), ("3x4", "2x2", "v5e"),
    ("axb", "2x2", "v5e"), ("16x16", "2x2", "v5e"), ("4x4x4", "2x2", "v5p"),
])
def test_slice_host_grid_matches(slice_topo, host_topo, tpu_type):
    got = TT.slice_host_grid(slice_topo, host_topo, tpu_type)
    want = JT.slice_host_grid(slice_topo, host_topo, tpu_type)
    assert (got is None) == (want is None)
    if got is not None:
        assert (got.dims, got.torus) == (want.dims, want.torus)
