"""Phase 2g of ``chip_smoke.py`` (``gang_phase``) on the CPU, at a fleet of
16 H100 nodes and 4 churned gangs.

The card's node comes from an inventory as the native shim reports a
host whose visible card is host index 3. Everything but the gang's
training runs as on the card: the port's extender over HTTP holds three
members below quorum and commits the fourth's, the port's daemon grants
all four over gRPC to a ``FakeKubelet`` with the gang's env, the
controller reaps the survivors of an evicted member and spares an
opted-out gang, the TTL rollback empties the ledger, and the churned
gangs are bound all or none. The training on the card (``gang_train``)
needs an NVIDIA card and is marked so; here it skips. The phase's gates
on ``tpushare_gangs_pending``, ``tpushare_gangs_reaped_total`` and each
member's trace id pass on the port's stack and fail on one broken for
each.
"""

from __future__ import annotations

import json
import sys

import pytest
import torch

import chip_smoke
from tests.torch_obs_reset import fresh_port_obs  # noqa: F401
from tpushare_torch.deviceplugin import discovery, plugin
from tpushare_torch.routes import metrics as tmetrics
from tpushare_torch.runtime import launch
from tpushare_torch.utils import const


def _host(cards=1, first=3):
    return discovery.HostInventory(
        "h100-80gb", "", source="native", chips=tuple(
            discovery.ChipSpec(i, 79, f"/dev/nvidia{i}", "h100-80gb")
            for i in range(first, first + cards)))


@pytest.fixture
def healthy(monkeypatch):
    monkeypatch.setattr(plugin, "chip_health", lambda path: plugin.HEALTHY)


def test_gang_phase_host_parts(healthy, tmp_path):
    usage = str(tmp_path / "usage")
    got = chip_smoke.gang_phase(_host(), usage, None, fleet=16, gangs=4)
    assert (got["card_gib"], got["member_gib"]) == (79, 19)
    assert len(got["bind_handler_ms"]) == len(got["bind_wire_ms"]) == 4
    assert all(0 < h <= w for h, w in zip(got["bind_handler_ms"],
                                          got["bind_wire_ms"]))
    assert len(got["grant_ms"]) == 4
    for env in got["envs"]:
        assert env[const.ENV_POD_GROUP] == chip_smoke.GANG_GROUP
        assert env[const.ENV_POD_GROUP_SIZE] == "4"
        assert env[const.ENV_HBM_POD] == "19"
        assert env[const.ENV_NVIDIA_VISIBLE_DEVICES] == "3"
        assert env[const.ENV_USAGE_FILE].startswith(usage)
    assert len({env[const.ENV_USAGE_FILE] for env in got["envs"]}) == 4
    assert got["train"] is None and got["launches"] == {}
    assert got["reaper"]["reaped"] == ["w-0", "w-1", "w-3"]
    assert got["reaper"]["used_gib_after"] == 0
    assert got["reaper"]["reaped_counted"] == 1
    assert got["gangs_pending"] == [1.0, 1.0, 1.0, 0.0]
    ids = got["trace_ids"]
    assert sorted(ids) == [f"w-{i}" for i in range(4)]
    assert len(set(ids.values())) == 4 and all(len(t) == 12
                                               for t in ids.values())
    assert got["ttl"] == {**got["ttl"], "reserved_gib": 57,
                          "used_gib_after": 0}
    churn = got["churn"]
    assert (churn["nodes"], churn["gangs"], churn["committed"]) == (16, 4, 4)
    assert 0 < churn["commit_p50_ms"] <= churn["commit_p99_ms"]
    # smoke, keep and the churn's four; the TTL leg's rollback.
    assert got["markers"]["gang_commit"] == 6
    assert got["markers"]["gang_rollback"] == [("ttl", "3")]
    smoke = got["markers"]["smoke"]
    assert smoke["attrs"]["members"] == "4"
    assert smoke["attrs"]["trace_id"] in ids.values()


def test_a_lost_gang_commit_marker_fails(small_gang, monkeypatch):
    from tpushare_torch import obs as tobs

    real, dropped = tobs.mark, []

    def mark(kind, *args, **kw):
        if kind == "gang-commit" and not dropped:
            dropped.append(kind)
            return None
        return real(kind, *args, **kw)
    monkeypatch.setattr(tobs, "mark", mark)
    with pytest.raises(RuntimeError, match="gang-commit markers"):
        small_gang()


@pytest.fixture
def small_gang(healthy, tmp_path):
    return lambda: chip_smoke.gang_phase(_host(), str(tmp_path), None,
                                         fleet=4, gangs=1)


def test_a_pending_gauge_that_stays_at_zero_fails(small_gang, monkeypatch):
    monkeypatch.setattr(tmetrics.GANGS_PENDING, "set",
                        lambda value: None)
    with pytest.raises(RuntimeError, match="tpushare_gangs_pending"):
        small_gang()


def test_commit_events_with_the_completer_s_id_fail(small_gang,
                                                    monkeypatch):
    """A commit's Events must carry each member's own id: emitted with
    the thread's (the completing member's), three of four disagree."""
    from tpushare_torch.k8s import events

    real = events.record

    def thread_id(*args, trace_id=None, **kwargs):
        return real(*args, **kwargs)
    monkeypatch.setattr(events, "record", thread_id)
    with pytest.raises(RuntimeError, match="w-0: trace-id"):
        small_gang()


def test_a_reap_the_metrics_miss_fails(small_gang, monkeypatch):
    monkeypatch.setattr(tmetrics.GANGS_REAPED, "inc", lambda n=1: None)
    with pytest.raises(RuntimeError, match="reaped_total rose by 0"):
        small_gang()


def test_a_half_bound_gang_fails_the_check():
    api = chip_smoke.FakeApiServer()
    for i in range(2):
        doc = chip_smoke.gang_pod(f"g-{i}", 8, "g", 2)
        if i == 0:
            doc["spec"]["nodeName"] = "n"
        api.create_pod(doc)
    with pytest.raises(RuntimeError, match="in part"):
        chip_smoke._all_or_none(api, {"g": ["g-0", "g-1"]})


def test_launch_runs_each_rank_in_its_own_env():
    """``envs``: rank i sees envs[i] and, of the launcher's, only the
    coordinator, its index and the checkout on PYTHONPATH."""
    envs = [{"PATH": "/usr/bin:/bin", "MEMBER": f"m{i}",
             const.ENV_POD_GROUP: "g", const.ENV_POD_GROUP_SIZE: "3"}
            for i in range(3)]
    records = launch.launch(
        ["-c", "import json, os; print(json.dumps(dict(os.environ)))"], 3,
        deadline_s=60, envs=envs)
    coords = {r[const.ENV_COORDINATOR] for r in records}
    assert len(coords) == 1
    for i, rec in enumerate(records):
        extra = set(rec) - set(envs[i])
        assert extra <= {const.ENV_COORDINATOR, "JOB_COMPLETION_INDEX",
                         "PYTHONPATH", "LC_CTYPE"}, extra
        assert rec["JOB_COMPLETION_INDEX"] == str(i)
        assert {k: rec[k] for k in envs[i]} == envs[i]
        assert "LOCAL_RANK" not in rec
    with pytest.raises(ValueError):
        launch.launch(["-c", "pass"], 2, deadline_s=10, envs=envs)
    with pytest.raises(ValueError):
        launch.launch(["-c", "pass"], 3, deadline_s=10, envs=envs,
                      grant_gib=4)


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="the gang trains on an NVIDIA card")
def test_gang_trains_on_the_card(tmp_path):
    """Phase 2g whole on one card: the kernels built, the single-process
    step, then the gang from its Allocate envs."""
    chip_smoke.FA.build_seconds()
    inv = discovery.discover_host()
    ref = chip_smoke.single_process_step(chip_smoke.M.ModelConfig())
    got = chip_smoke.gang_phase(inv, str(tmp_path), ref, fleet=16, gangs=4)
    n = chip_smoke.M.ModelConfig().n_layers
    assert got["train"]["launches_per_step"] == {
        "flash_fwd": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
    json.dumps(got)
    print(json.dumps(got["train"]), file=sys.stderr)
