"""Phase 2e of ``chip_smoke.py`` (the node daemon) on the CPU: the pods it
creates, its annotate, advertise and Allocate steps in process and over
gRPC to the fake kubelet (the card's name and the health of its device
node stood in for), the env it hands the tenant, and its verdicts on
synthetic sweeps. The tenant itself needs the card."""

from __future__ import annotations

import os

import pytest
import torch

import chip_smoke
from tpushare.api.objects import Pod as JPod
from tpushare.utils import pod as jpod
from tpushare_torch.deviceplugin import discovery, plugin
from tpushare_torch.utils import const

TOTAL_MIB = 81559  # an H100 80GB's memory.total


def _host(cards=2, first=3):
    """A host of H100s as the native shim names them."""
    return discovery.HostInventory(
        "h100-80gb", "", source="native", chips=tuple(
            discovery.ChipSpec(i, 79, f"/dev/nvidia{i}", "h100-80gb")
            for i in range(first, first + cards)))


def test_daemon_pods_are_what_the_extender_s_bind_leaves():
    inv = _host()
    docs = chip_smoke.daemon_pods(inv)
    assert [d["metadata"]["name"] for d in docs] == [
        n for n, _ in chip_smoke.DAEMON_PODS]
    pods = [JPod(d) for d in docs]
    for (name, gib), pod in zip(chip_smoke.DAEMON_PODS, pods):
        assert pod.uid == f"uid-{name}"
        assert pod.node_name == chip_smoke.DAEMON_NODE
        assert jpod.is_assumed(pod) and not jpod.is_assigned(pod)
        assert jpod.get_chip_ids_from_annotation(pod) == [3]
        assert jpod.get_hbm_from_pod_resource(pod) == gib
        assert jpod.get_hbm_from_pod_annotation(pod) == gib
        assert pod.annotations[const.ANN_HBM_CHIP] == "79"
        assert not jpod.is_tpu_chip_pod(pod)
    times = [jpod.get_assume_time(p) for p in pods]
    assert times == sorted(set(times))


@pytest.fixture
def on_a_host(monkeypatch):
    """The card's name as torch gives it, every card's device node
    present, and the held tenant recorded instead of started."""
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(plugin, "chip_health", lambda path: plugin.HEALTHY)
    calls = []

    def held(alloc, card_gib, api, pod, usage_dir):
        calls.append(dict(alloc=alloc, card_gib=card_gib, api=api, pod=pod,
                          usage_dir=usage_dir))
        return {"launches": 8}
    monkeypatch.setattr(chip_smoke, "held_tenant_phase", held)
    return calls


def test_node_daemon_phase_matches_and_commits(on_a_host, tmp_path):
    inv = _host()
    usage = str(tmp_path / "usage")
    got = chip_smoke.node_daemon_phase(inv, TOTAL_MIB, usage)
    assert got["node_annotations"] == {
        const.ANN_NODE_CHIP_HBM: "79,79",
        const.ANN_NODE_TPU_TYPE: "h100-80gb"}
    assert got["advertised_gib"] == 158
    assert got["registered"] == sorted((const.HBM_RESOURCE,
                                        const.CHIP_RESOURCE))
    assert got["launches"] == 8
    [call] = on_a_host
    api = call["api"]
    assigned = {n: api.get_pod("default", n).annotations[const.ANN_ASSIGNED]
                for n, _ in chip_smoke.DAEMON_PODS}
    assert assigned == {"early": "true", "small": "false",
                        "wire-early": "true", "wire-late": "false"}
    assert call["pod"] == "wire-early" and call["card_gib"] == 79
    # The tenant's env: exactly the wire response's, which is
    # build_allocation's for the matched pod on the first card.
    want = plugin.build_allocation(inv, [3], 7, pod_uid="uid-wire-early",
                                   usage_dir=usage)
    assert call["alloc"] == want
    assert got["envs"] == want.envs
    assert got["devices"] == ["/dev/nvidia3"]
    env = chip_smoke.tenant_env(call["alloc"], {"PATH": "/bin",
                                                const.ENV_HBM_POD: "79"})
    assert {k: v for k, v in env.items() if k.startswith("TPUSHARE_")} == {
        const.ENV_CHIP_IDX: "3", const.ENV_HBM_POD: "7",
        const.ENV_HBM_CHIP: "79",
        const.ENV_USAGE_FILE: os.path.join(usage, "uid-wire-early",
                                           "usage.json")}
    assert env[const.ENV_CUDA_VISIBLE_DEVICES] == "0"
    assert env[const.ENV_NVIDIA_VISIBLE_DEVICES] == "3"
    for key in ("preferred_ms", "allocate_ms", "wire_preferred_ms",
                "wire_allocate_ms"):
        assert got[key] > 0


@pytest.mark.parametrize("name,inv,total", [
    ("an unknown model", discovery.HostInventory("", "", chips=(
        discovery.ChipSpec(0, 79, "/dev/nvidia0", ""),)), TOTAL_MIB),
    ("a card sized past nvidia-smi", _host(cards=1, first=0),
     (79 << 10) - 1),
    ("a card at another node", discovery.HostInventory(
        "h100-80gb", "", chips=(discovery.ChipSpec(
            0, 79, "/dev/nvidia7", "h100-80gb"),)), TOTAL_MIB),
])
def test_node_daemon_phase_refuses_a_wrong_inventory(on_a_host, tmp_path,
                                                     name, inv, total):
    with pytest.raises((RuntimeError, KeyError)):
        chip_smoke.node_daemon_phase(inv, total, str(tmp_path))
    assert on_a_host == []


UID = "uid-wire-early"


def _sweep(used=0.2, overrun=False, others=()):
    entry = {"uid": UID, "pod": "wire-early", "granted_gib": 7,
             "used_gib": used}
    if used is not None:
        entry["overrun"] = overrun
    tenants = [entry, *others]
    return {"tenants": tenants,
            "overruns": [t for t in tenants if t.get("overrun")]}


ANN = {const.ANN_HBM_USED: "0.2"}


@pytest.mark.parametrize("sweep,ann,failing", [
    (_sweep(), ANN, set()),
    (_sweep(used=None), ANN, {"fresh", "within_grant"}),
    (_sweep(used=0.0), ANN, {"within_grant"}),
    (_sweep(used=9.5, overrun=True),
     {**ANN, const.ANN_OVERRUN: "true"},
     {"within_grant", "no_overrun", "annotated"}),
    (_sweep(others=[{"uid": "uid-x", "used_gib": 9.0, "overrun": True}]),
     ANN, {"no_overrun"}),
    (_sweep(), {}, {"annotated"}),
    ({"tenants": [], "overruns": []}, ANN, {"fresh", "within_grant"}),
])
def test_daemon_sweep_gates_on_a_synthetic_sweep(sweep, ann, failing):
    got = chip_smoke.daemon_sweep_gates(sweep, ann, UID, 7)
    assert {k for k, v in got.items() if not v} == failing

