"""The port's ring-latency model (``tpushare_torch/workload/parallel.py``)
against the JAX package's: the same composition (rotation, collective,
step) over the port's per-hop physics, and those physics (NVLink through
a non-blocking NVSwitch inside a node, the NIC across nodes), and the
tool that fits its NVLink constants (``tools/ring_model_fit.py``) where
it runs without cards."""

import importlib.util
import os
import sys
from unittest import mock

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tpushare.workload import parallel as JP
from tpushare_torch.workload import model as M
from tpushare_torch.workload import parallel as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HOPS = st.one_of(st.none(), st.integers(min_value=0, max_value=16))
HOP_LISTS = st.lists(HOPS, max_size=8)
PAYLOAD = st.floats(min_value=0, max_value=4e9, allow_nan=False)


@settings(max_examples=200, deadline=None)
@given(hop_list=HOP_LISTS, payload=PAYLOAD,
       rotations=st.one_of(st.none(), st.integers(0, 16)))
def test_ring_composition_matches_the_reference(hop_list, payload,
                                                rotations):
    with mock.patch.object(JP, "hop_time_us", P.hop_time_us):
        assert JP.ring_rotation_time_us(hop_list, payload) == (
            P.ring_rotation_time_us(hop_list, payload))
        assert JP.ring_collective_time_us(hop_list, payload, rotations) == (
            P.ring_collective_time_us(hop_list, payload, rotations))


@settings(max_examples=200, deadline=None)
@given(sp_rings=st.lists(HOP_LISTS, max_size=4),
       pp_links=st.lists(HOPS, max_size=4),
       layers=st.integers(1, 64), microbatches=st.integers(1, 16),
       kv=PAYLOAD, act=PAYLOAD,
       compute=st.floats(min_value=0, max_value=1e4, allow_nan=False))
def test_predicted_step_matches_the_reference(sp_rings, pp_links, layers,
                                              microbatches, kv, act,
                                              compute):
    kw = dict(layers=layers, microbatches=microbatches, kv_block_bytes=kv,
              act_bytes=act, compute_ms=compute)
    with mock.patch.object(JP, "hop_time_us", P.hop_time_us):
        assert JP.predicted_step_time_ms(sp_rings, pp_links, **kw) == (
            P.predicted_step_time_ms(sp_rings, pp_links, **kw))
        # The defaults too (the reference's step shape).
        assert JP.predicted_step_time_ms(sp_rings, pp_links) == (
            P.predicted_step_time_ms(sp_rings, pp_links))


@pytest.mark.parametrize("payload", [0, 1 << 20, 64 << 20, 1e10])
def test_in_node_hops_cost_the_same_at_any_distance(payload):
    one = P.hop_time_us(1, payload)
    assert all(P.hop_time_us(d, payload) == one for d in (0, 2, 3, 7, 100))
    assert P.ring_rotation_time_us([1, 1, 1, 1], payload) == (
        P.ring_rotation_time_us([3, 2, 4, 3], payload))
    assert P.predicted_step_time_ms([[1, 1, 1, 1]] * 4, [1, 1, 1]) == (
        P.predicted_step_time_ms([[3, 2, 4, 3]] * 4, [2, 3, 1]))


def test_a_nic_hop_costs_the_bandwidth_ratio_at_large_payloads():
    big = 1e13
    ratio = P.hop_time_us(None, big) / P.hop_time_us(1, big)
    assert ratio == pytest.approx(
        P.NVLINK_BYTES_PER_S / P.NIC_BYTES_PER_S, rel=1e-3)
    assert P.hop_time_us(None, 0) == P.NIC_LATENCY_US
    assert P.hop_time_us(1, 0) == P.NVLINK_LATENCY_US
    # A ring that leaves the node is gated by its NIC hop.
    assert P.ring_rotation_time_us([1, None, 1], 64 << 20) == (
        P.hop_time_us(None, 64 << 20))


def test_empty_placement_costs_only_compute():
    assert P.predicted_step_time_ms([], [], compute_ms=7.5) == 7.5
    assert P.predicted_step_time_ms([], []) == 20.0
    assert P.ring_collective_time_us([], 1 << 20) == 0.0
    assert P.ring_rotation_time_us([], 1 << 20) == 0.0


def test_no_tpu_figure_remains():
    names = set(vars(P))
    assert not {n for n in names if n.startswith(("ICI_", "DCN_"))}


def _fit_tool():
    path = os.path.join(REPO, "tools", "ring_model_fit.py")
    spec = importlib.util.spec_from_file_location("ring_model_fit", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def test_the_fit_recovers_a_line():
    tool = _fit_tool()
    payloads = [64 << 20, 128 << 20, 256 << 20]
    ms = [(273.0 + p / 427e9 * 1e6) / 1e3 for p in payloads]
    latency_us, bytes_per_s = tool.fit(payloads, ms)
    assert latency_us == pytest.approx(273.0)
    assert bytes_per_s == pytest.approx(427e9)
    # The (1,2,2) gang's block: a rank's K and V, 1024 tokens x 4 heads.
    assert tool.gang_ring_bytes(M.ModelConfig(), 8, 2048, tp=2, sp=2) == (
        8 << 20)


@pytest.mark.parametrize("cards,argv,says", [
    (0, [], "at least two cards"),
    (1, [], "at least two cards"),
    (4, ["--payloads-mib", "1", "16", "256"], "two payloads from 16 to 128"),
])
def test_the_fit_refuses_what_it_cannot_fit(monkeypatch, capsys, cards,
                                            argv, says):
    tool = _fit_tool()
    monkeypatch.setattr(sys, "argv", ["ring_model_fit.py", *argv])
    monkeypatch.setattr(tool.torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(tool.torch.cuda, "device_count", lambda: cards)
    assert tool.main() == 2
    assert says in capsys.readouterr().err
