"""Phase 2h of ``chip_smoke.py`` (``tenancy_phase``) and phase 2f's GC
turn (``gc_posture_churn``) on the CPU, at small fleets.

The card's node comes from an inventory as the native shim reports a
host whose visible card is host index 3. The tenants on the card are
stood in for by a process-free ``ServingTenant`` that prints what the
held tenant prints and writes its heartbeat where the grant says; the
card's free bytes are a counter. Everything else runs as on the card:
two port extenders over one fake apiserver under leader election, the
follower's 503, the failover, the port's daemon granting over gRPC, the
preempt verb naming the serving tenant alone, the PDB refusing the other
pod's eviction, the preemptor bound and granted in the victim's place,
the quota cap and its Warning Event, the admission webhook, and
``bench.py``'s preempt twins. A replay on the card needs an NVIDIA card
and is marked so; here it skips.
"""

from __future__ import annotations

import gc
import json
import os
import time

import pytest
import torch

import chip_smoke
from tpushare_torch.deviceplugin import discovery, plugin
from tpushare_torch.utils import const


def _host(cards=1, first=3):
    return discovery.HostInventory(
        "h100-80gb", "", source="native", chips=tuple(
            discovery.ChipSpec(i, 79, f"/dev/nvidia{i}", "h100-80gb")
            for i in range(first, first + cards)))


class StubTenant:
    """``ServingTenant`` without a process: the held tenant's result line
    for 2 prefills of 4 layers, and a fresh heartbeat of 1 GiB in the
    grant's usage file."""

    started: list = []

    def __init__(self, alloc):
        self.alloc = alloc
        self.ready_s = None
        self.stopped = False

    def start(self) -> dict:
        t0 = time.perf_counter()
        grant = int(self.alloc.envs[const.ENV_HBM_POD])
        path = self.alloc.envs[const.ENV_USAGE_FILE]
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"bytes_in_use": 1 << 30, "peak_bytes": 1 << 30,
                       "bytes_limit": grant << 30, "source": "stub",
                       "ts": time.time(), "pid": os.getpid()}, f)
        self.started.append(self.alloc)
        self.ready_s = time.perf_counter() - t0
        return {"device_count": 1, "cuda_visible_devices": "0",
                "cap": round(grant / 79 * 0.9, 3), "launches": 8,
                "prefills": 2, "n_layers": 4, "tok_per_s": 1.0,
                "first_request_s": 0.1, "first_request_done_unix":
                time.time(), "pid": os.getpid()}

    def stop(self) -> int:
        self.stopped = True
        return 0


@pytest.fixture
def stubbed(monkeypatch):
    monkeypatch.setattr(plugin, "chip_health", lambda path: plugin.HEALTHY)
    StubTenant.started = []
    monkeypatch.setattr(chip_smoke, "ServingTenant", StubTenant)
    free = iter(range(0, 1 << 40, 16 << 30))
    monkeypatch.setattr(chip_smoke, "card_free_bytes", lambda: next(free))
    monkeypatch.setattr(chip_smoke, "TENANCY_LEASE_S", 0.6)
    monkeypatch.setattr(chip_smoke, "TENANCY_RENEW_S", 0.05)
    return StubTenant.started


def test_tenancy_phase_on_the_host(stubbed, tmp_path):
    usage = str(tmp_path / "usage")
    got = chip_smoke.tenancy_phase(_host(), usage, fleet=16, bench_nodes=2,
                                   gang_hosts=2)
    json.dumps(got)
    # (a)
    assert got["ha"]["healthz"] == ["ok leader", "ok follower"]
    assert got["ha"]["follower_bind_status"] == 503
    # (b) The victim was granted on host card 3 and served; the card full.
    victim_alloc, pre_alloc = stubbed
    assert victim_alloc.envs[const.ENV_NVIDIA_VISIBLE_DEVICES] == "3"
    assert victim_alloc.envs[const.ENV_HBM_POD] == "16"
    assert got["fillers_gib"] == [16, 20, 27]
    # (c)
    assert 0 < got["failover"]["failover_s"] < 5 * 0.6
    assert got["failover"]["ledger"]["used_gib"] == \
        got["failover"]["ledger"]["granted_gib"]
    # (d) The serving tenant alone was named; the PDB held; the preemptor
    # took its place.
    pre = got["preempt"]
    assert pre["plan"] == {"NodeNameToMetaVictims": {
        chip_smoke.TENANCY_NODE: {"Pods": [{"UID": "uid-victim"}],
                                  "NumPDBViolations": 0}}}
    assert pre["pdb_eviction_refused"] == 429
    assert pre["card_freed_bytes"] == 16 << 30
    assert 0 < pre["handler_ms"] <= pre["wire_ms"]
    assert set(pre["split_s"]) == {"preempt", "eviction", "process_exit",
                                   "bind", "allocate",
                                   "to_first_request_done"}
    assert pre_alloc.envs[const.ENV_NVIDIA_VISIBLE_DEVICES] == "3"
    assert got["preemptor"]["launches"] == 8
    assert got["launches"] == {"tenancy_victim": 8, "tenancy_preemptor": 8}
    # (e) The cap at the usage, its reason, then the raised cap.
    quota = got["quota"]
    assert quota["capped_at_gib"] == 16 and quota["raised_to_gib"] == 32
    assert quota["reason"].startswith(
        f"quota: tenant {chip_smoke.TENANCY_BURST} over HBM limit")
    assert quota["bound_to"] != chip_smoke.TENANCY_NODE
    # (f)
    denied = got["admission"]["oversize"]["response"]
    assert denied["allowed"] is False and "79 GiB" in \
        denied["status"]["message"]
    assert got["admission"]["fits"]["response"]["allowed"] is True
    # (g)
    assert got["bench_preempt"]["victims"] == 1
    assert got["bench_gang_preempt"]["victims"] == 2 * 8
    assert len(set(got["bench_gang_preempt"]["nominated"].values())) == 2
    scale = got["preempt_at_scale"]
    assert (scale["nodes"], scale["fillers"]) == (16, 16 * 8)
    assert len(scale["preempt_handler_ms"]) == chip_smoke.PREEMPT_REPEATS
    assert all(0 < h <= w for h, w in zip(scale["preempt_handler_ms"],
                                          scale["preempt_wire_ms"]))


def test_gc_posture_churn_restores_the_interpreter():
    before = gc.get_threshold()
    got = chip_smoke.gc_posture_churn(fleet=16, target=120)
    assert got["bound"] >= 120
    assert got["used_gib"] == got["granted_gib"] > 0
    assert got["thresholds"] == [1000, 50, 50]
    assert got["frozen_objects"] > 0
    assert gc.get_threshold() == before
    assert gc.get_freeze_count() == 0


def test_a_victim_plan_naming_the_pdb_pod_fails_the_run(stubbed, tmp_path,
                                                        monkeypatch):
    """A preempt verb that names another pod than the serving tenant fails
    the phase."""
    from tpushare_torch.scheduler import preempt as P

    real = P.Preempt.handle

    def wrong(self, args):
        result = real(self, args)
        for node, uids in result.node_victims.items():
            result.node_victims[node] = ["uid-guarded"]
        return result
    monkeypatch.setattr(P.Preempt, "handle", wrong)
    with pytest.raises(RuntimeError, match="serving tenant alone"):
        chip_smoke.tenancy_phase(_host(), str(tmp_path), fleet=4,
                                 bench_nodes=1, gang_hosts=1)


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="the tenants serve on an NVIDIA card")
def test_tenancy_phase_on_the_card(tmp_path):
    chip_smoke.FA.build_seconds()
    got = chip_smoke.tenancy_phase(discovery.discover_host(), str(tmp_path),
                                   fleet=16, bench_nodes=2, gang_hosts=2)
    assert got["preempt"]["card_freed_bytes"] > 0
