"""The port's slice placer (``tpushare_torch/topology/fleet.py``) against
the JAX package's, on seeded fleets.

Each fleet is drawn with numpy from a seed and written as the same node
and pod documents into both packages' fake apiservers; each side builds
its own ledger. On it ``build_host_grids``, ``host_block``,
``snake_order``, ``ring_stats`` and ``gang_ring_stats`` must equal the
reference's, and ``SlicePlacer.elect`` must elect the same
``Placement`` (slice, hosts in ring order, coords, grid, stats) for
every requested shape, memo reads included. The fleets: v5p hosts of
``2x2x1`` chips in ``4x4x4`` and ``4x4x8`` slices (torus host grids),
v5e hosts of ``2x2`` chips in ``8x8`` slices, a slice with a
mis-labelled host, and H100 nodes with no topology (no grid: the placer
elects nothing there, as the reference does for any node without a
topology); some hosts missing, cordoned or occupied, and shapes that do
not tile. Tolerance: exact (ring stats are integers and a ratio rounded
to four places by both).
"""

from __future__ import annotations

import numpy as np
import pytest

from tests.torch_obs_reset import fresh_port_obs  # noqa: F401
from tpushare.cache.cache import SchedulerCache as JCache
from tpushare.k8s.builders import make_node, make_pod
from tpushare.k8s.fake import FakeApiServer as JFake
from tpushare.topology import fleet as jfleet
from tpushare.topology.topology import Topology as JTopology
from tpushare_torch.api.objects import Node as TNode
from tpushare_torch.cache.cache import SchedulerCache as TCache
from tpushare_torch.k8s.fake import FakeApiServer as TFake
from tpushare_torch.topology import fleet as tfleet
from tpushare_torch.topology.topology import Topology as TTopology
from tpushare_torch.utils import const

#: (tpu type, host topology, chips a host, slice topology, host grid size)
V5P_444 = ("v5p", "2x2x1", 4, "4x4x4", 16)
V5P_448 = ("v5p", "2x2x1", 4, "4x4x8", 32)
V5E_88 = ("v5e", "2x2", 4, "8x8", 16)
SHAPES = ("4x4x4", "4x4x2", "2x2x4", "4x2x2", "2x2x1", "4x4x1", "8x8",
          "4x4", "4x8", "2x4", "3x2x1", "6x6", "4x4x16", "2x2x8")


def _fleet(seed: int, slices, h100: int = 0, mislabel: bool = False):
    """(node docs, pod docs) of a seeded fleet: each slice drops some
    hosts, cordons some and fills some (a pod on all its cards or on
    one); ``mislabel`` gives one host of the first slice another slice
    topology."""
    rng = np.random.default_rng(seed)
    nodes, pods = [], []
    for s, (tpu, host_topo, chips, slice_topo, n) in enumerate(slices):
        sid = f"slice-{s}"
        for w in range(n):
            if rng.random() < 0.1:
                continue  # a host missing from the fleet
            name = f"{sid}-w{w:02d}"
            topo = slice_topo
            if mislabel and s == 0 and w == 3:
                topo = "4x4x16" if tpu == "v5p" else "16x16"
            nodes.append(make_node(
                name, chips=chips, hbm_per_chip=95 if tpu == "v5p" else 16,
                topology=host_topo, tpu_type=tpu, slice_id=sid,
                slice_topology=topo, worker_index=w,
                unschedulable=bool(rng.random() < 0.08)))
            roll = rng.random()
            if roll < 0.15:
                pods.append(_resident(f"busy-{name}", name, list(
                    range(chips)), chips, 95 if tpu == "v5p" else 16))
            elif roll < 0.25:
                pods.append(_resident(f"part-{name}", name, [0], 0,
                                      95 if tpu == "v5p" else 16))
    for i in range(h100):
        nodes.append(make_node(f"h100-{i:02d}", chips=8, hbm_per_chip=79,
                               topology="", tpu_type="h100-80gb"))
    return nodes, pods


def _resident(name, node, chip_ids, chips, cap):
    doc = make_pod(name, chips=chips, hbm=0 if chips else 7,
                   node_name=node, phase="Running", uid=f"uid-{name}")
    doc["metadata"]["annotations"].update({
        const.ANN_CHIP_IDX: ",".join(map(str, chip_ids)),
        const.ANN_HBM_POD: str(cap * len(chip_ids) if chips else 7),
        const.ANN_HBM_CHIP: str(cap),
        const.ANN_ASSIGNED: const.ASSIGNED_TRUE,
        const.ANN_ASSUME_TIME: "1"})
    return doc


def _caches(nodes, pods):
    out = []
    for fake, cache_cls in ((JFake, JCache), (TFake, TCache)):
        api = fake()
        for doc in nodes:
            api.create_node(doc)
        for doc in pods:
            api.create_pod(doc)
        cache = cache_cls(api.get_node, api.list_pods)
        cache.build()
        for doc in nodes:
            cache.get_node_info(doc["metadata"]["name"])
        out.append(cache)
    return out


def _grids(grids):
    return {sid: (g.slice_id, g.grid.dims, g.grid.torus, g.host_dims,
                  dict(g.hosts)) for sid, g in grids.items()}


def _placement(p):
    if p is None:
        return None
    return (p.slice_id, p.hosts, p.coords, p.grid_dims, p.torus, p.stats,
            p.host_set())


FLEETS = {
    "v5p_4x4x4_and_4x4x8": dict(slices=(V5P_444, V5P_448)),
    "v5e_8x8": dict(slices=(V5E_88, V5E_88)),
    "mislabelled_host": dict(slices=(V5P_444, V5E_88), mislabel=True),
    "h100_no_topology": dict(slices=(), h100=12),
    "h100_beside_a_slice": dict(slices=(V5P_444,), h100=6),
}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("fleet_name", sorted(FLEETS))
def test_host_grids_and_elections_match(fleet_name, seed):
    nodes, pods = _fleet(seed, **FLEETS[fleet_name])
    jcache, tcache = _caches(nodes, pods)
    jinfos = sorted(jcache.get_node_infos(), key=lambda i: i.name)
    tinfos = sorted(tcache.get_node_infos(), key=lambda i: i.name)
    assert [i.name for i in tinfos] == [i.name for i in jinfos]
    grids = _grids(tfleet.build_host_grids(tinfos))
    assert grids == _grids(jfleet.build_host_grids(jinfos))
    if fleet_name.startswith("h100_no"):
        assert grids == {}
    jplacer, tplacer = jfleet.SlicePlacer(jcache), tfleet.SlicePlacer(tcache)
    rng = np.random.default_rng(100 + seed)
    elected = 0
    for k, shape in enumerate(SHAPES):
        for chips in (4, 2):
            doc = make_pod(f"g{k}-{chips}", chips=chips, annotations={
                const.ANN_POD_GROUP: f"g{k}-{chips}",
                const.ANN_POD_GROUP_MIN: "4",
                const.ANN_SLICE_SHAPE: shape})
            if rng.random() < 0.3:
                doc["spec"]["tolerations"] = [{"operator": "Exists"}]
            from tpushare.api.objects import Pod as JPod
            from tpushare_torch.api.objects import Pod as TPod
            key = ("default", f"g{k}-{chips}")
            want = jplacer.elect(key, JPod(doc))
            got = tplacer.elect(key, TPod(doc))
            assert _placement(got) == _placement(want), (shape, chips)
            # A second election reads the memo and gives the same.
            assert _placement(tplacer.elect(key, TPod(doc))) == \
                _placement(got)
            elected += got is not None
            if got is not None:
                assert all(tcache.get_node_info(h).node.unschedulable
                           is False for h in got.hosts)
    if fleet_name.startswith("h100_no"):
        assert elected == 0
    elif fleet_name.startswith("v5p"):
        assert elected > 0


@pytest.mark.parametrize("seed", range(4))
def test_ring_helpers_match(seed):
    rng = np.random.default_rng(seed)
    dims = tuple(int(d) for d in rng.integers(1, 5, size=int(
        rng.integers(1, 4))))
    assert tfleet.snake_order(dims) == jfleet.snake_order(dims)
    walk = tfleet.snake_order(dims)
    assert all(sum(abs(a - b) for a, b in zip(walk[i], walk[i + 1])) == 1
               for i in range(len(walk) - 1))
    for torus in (False, True):
        tgrid, jgrid = TTopology(dims, torus), JTopology(dims, torus)
        n = int(rng.integers(0, 9))
        coords = [None if rng.random() < 0.2 else
                  tuple(int(rng.integers(0, d)) for d in dims)
                  for _ in range(n)]
        assert tfleet.ring_hops(coords, tgrid) == \
            jfleet.ring_hops(coords, jgrid)
        assert tfleet.ring_stats(coords, tgrid) == \
            jfleet.ring_stats(coords, jgrid)
    assert tfleet.ring_stats([(0,), (0,)], TTopology((4,), False)) == \
        jfleet.ring_stats([(0,), (0,)], JTopology((4,), False))
    for shape, host in (((4, 4, 4), (2, 2, 1)), ((8, 8), (2, 2)),
                        ((3, 2, 1), (2, 2, 1)), ((4, 4), (2, 2, 1)),
                        ((16,), (2, 2))):
        assert tfleet.host_block(shape, host) == jfleet.host_block(shape,
                                                                   host)
    for name in ("w-3", "w-10", "stage_12", "worker", "a1b", "x-2.",
                 "7", ""):
        assert tfleet.worker_ordinal(name) == jfleet.worker_ordinal(name)
        assert tfleet.worker_sort_key(name) == jfleet.worker_sort_key(name)


@pytest.mark.parametrize("fleet_name", ["v5p_4x4x4_and_4x4x8",
                                        "mislabelled_host",
                                        "h100_beside_a_slice"])
def test_gang_ring_stats_match(fleet_name):
    nodes, _ = _fleet(5, **FLEETS[fleet_name])
    from tpushare.api.objects import Node as JNode
    rng = np.random.default_rng(7)
    for _ in range(12):
        pick = rng.choice(len(nodes), size=int(rng.integers(1, 9)),
                          replace=False)
        docs = [nodes[i] for i in pick]
        assert tfleet.gang_ring_stats([TNode(d) for d in docs]) == \
            jfleet.gang_ring_stats([JNode(d) for d in docs])
