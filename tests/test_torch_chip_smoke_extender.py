"""Phase 2f of ``chip_smoke.py`` (``extender_phase``) on the CPU, at a
fleet of 16 H100 nodes.

The card's node comes from an inventory as the native shim reports a
host whose visible cards are host indices 3 and 4, so the extender's
position 0 is host card 3. The held tenant is recorded instead of
started; everything else runs as on the card: the port's extender over
HTTP places the tenant, the port's daemon commits that pod over gRPC to
a ``FakeKubelet``, and the seeded churn binds its pods with the ledger
checks. The churn's traffic is ``bench.py``'s, draw for draw. The
phase's decision-trace and ``/metrics`` gates pass on the port's stack
and fail on one broken for each: a grant whose ``trace-id`` is not its
decision's, a bind or a filter the metrics count short by one. The
restart replays the tenant's decision from the journal, and fails on a
controller that never replays it.
"""

from __future__ import annotations

import random
import signal
import time

import pytest
import torch

import bench
import chip_smoke
from tests.torch_obs_reset import fresh_port_obs  # noqa: F401
from tpushare_torch import profiling as tprofiling
from tpushare_torch import trace as ttrace
from tpushare_torch.deviceplugin import discovery, plugin
from tpushare_torch.routes import metrics as tmetrics
from tpushare_torch.utils import const


def _host(cards=2, first=3):
    """A host of H100s as the native shim names them."""
    return discovery.HostInventory(
        "h100-80gb", "", source="native", chips=tuple(
            discovery.ChipSpec(i, 79, f"/dev/nvidia{i}", "h100-80gb")
            for i in range(first, first + cards)))


def test_the_churn_s_traffic_is_bench_s():
    assert list(chip_smoke.EXTENDER_SIZE_MIX) == [
        tuple(m) for m in bench.SIZE_MIX]
    assert chip_smoke.EXTENDER_TTL_ROUNDS == bench.SCALE_TTL_ROUNDS
    assert chip_smoke.EXTENDER_FLEET == bench.SCALE_NODES
    for seed in range(3):
        a, b = random.Random(seed), random.Random(seed)
        assert [chip_smoke.draw_shape(a) for _ in range(500)] == [
            bench._draw_shape(b) for _ in range(500)]
    names = [f"n{i}" for i in range(1024)]
    for n in (16, 100, 300, 1024):
        a, b = random.Random(n), random.Random(n)
        assert chip_smoke.scale_candidates(a, names[:n]) == \
            bench._scale_candidates(b, names[:n])


def test_client_sends_again_on_a_connection_the_server_closed_idle(
        monkeypatch):
    """The port's server closes a keep-alive connection idle past
    ``TPUSHARE_HTTP_TIMEOUT_S`` (a gang's training leaves 2g's idle that
    long); the client's next request goes again on a new connection."""
    monkeypatch.setenv("TPUSHARE_HTTP_TIMEOUT_S", "0.2")
    stack, server = chip_smoke.extender_main.serve_stack(
        chip_smoke.FakeApiServer())
    client = chip_smoke.ExtenderClient(server)
    try:
        assert client.healthz()
        first = client.conn.sock
        time.sleep(1.5)            # past the timeout and the 1 s idle tick
        assert client.healthz()
        assert client.conn.sock is not first
        assert client.text("/metrics")
    finally:
        client.close()
        chip_smoke.extender_main.shutdown_stack(stack, server)


def test_advertised_node_counts_the_daemon_s_devices():
    inv = discovery.fake_inventory(chips=8)
    doc = chip_smoke.advertised_node("n", inv)
    assert doc["status"]["capacity"] == {const.HBM_RESOURCE: "632",
                                         const.CHIP_RESOURCE: "8"}


def test_percentiles_are_nearest_rank():
    assert chip_smoke._percentiles([]) == (0.0, 0.0)
    assert chip_smoke._percentiles([float(i) for i in range(1, 101)]) == (
        50.0, 99.0)
    assert chip_smoke._percentiles([3.0]) == (3.0, 3.0)


@pytest.fixture
def held(monkeypatch):
    """The held tenant recorded instead of started; every card healthy."""
    monkeypatch.setattr(plugin, "chip_health", lambda path: plugin.HEALTHY)
    calls = []

    def record(alloc, card_gib, api, pod, usage_dir, node=None):
        calls.append(dict(alloc=alloc, card_gib=card_gib, api=api, pod=pod,
                          usage_dir=usage_dir, node=node))
        return {"launches": 8}
    monkeypatch.setattr(chip_smoke, "held_tenant_phase", record)
    return calls


def test_extender_phase_places_commits_and_churns(held, tmp_path):
    inv = _host()
    usage = str(tmp_path / "usage")
    got = chip_smoke.extender_phase(inv, usage, fleet=16, target=200)
    assert got["tenant_node"] == chip_smoke.EXTENDER_NODE
    assert (got["tenant_position"], got["tenant_card"]) == (0, 3)
    assert got["launches"] == 8
    [call] = held
    assert call["pod"] == "extender-tenant"
    assert call["node"] == chip_smoke.EXTENDER_NODE
    assert call["card_gib"] == 79
    api = call["api"]
    pod = api.get_pod("default", "extender-tenant")
    assert pod.node_name == chip_smoke.EXTENDER_NODE
    assert pod.annotations[const.ANN_ASSIGNED] == const.ASSIGNED_TRUE
    assert pod.annotations[const.ANN_CHIP_IDX] == "0"
    want = plugin.build_allocation(inv, [3], 7, pod_uid=pod.uid,
                                   usage_dir=usage)
    assert call["alloc"] == want and got["envs"] == want.envs
    assert want.envs[const.ENV_NVIDIA_VISIBLE_DEVICES] == "3"
    churn = got["churn"]
    assert churn["nodes"] == 16 and churn["bound"] >= 200
    assert churn["used_gib"] == churn["granted_gib"] > 0
    assert churn["total_gib"] == 16 * 8 * 79
    assert 0 < churn["handler_p50_ms"] <= churn["handler_p99_ms"]
    assert 0 < churn["wire_p50_ms"] <= churn["wire_p99_ms"]
    assert churn["handler_p50_ms"] <= churn["wire_p50_ms"]
    assert 0 < churn["gib_utilisation_pct"] <= 100
    # The tenant's decision, and the churn's scrapes and counts.
    traced = got["tenant_trace"]
    assert traced["trace_id"] == pod.annotations[const.ANN_TRACE_ID]
    assert traced["outcome"] == "bound"
    assert traced["spans"][-2:] == [("bind", 0), ("allocate", 1)]
    assert traced["allocate_attrs"] == {
        "node": chip_smoke.EXTENDER_NODE, "chips": [0], "hbmGiB": 7}
    assert traced["allocate_api_calls"] >= 2
    assert traced["traceparent"] == ttrace.format_traceparent(
        traced["trace_id"])
    assert (traced["hbm_used_gib"], traced["binds_counted"]) == (7, 1)
    assert churn["sent"]["/bind"] == churn["bound"]
    assert churn["sent"]["/filter"] >= churn["sent"]["/prioritize"] >= \
        churn["sent"]["/bind"]
    assert churn["metrics_gib_used"] == churn["used_gib"]
    assert churn["flight_decisions"] == 256
    assert churn["scrapes"] >= 1
    assert 0 < churn["scrape_p50_ms"] <= churn["scrape_max_ms"]
    assert churn["scrape_bytes"] > 0 and churn["scrape_series"] > 16 * 2
    # The exemplar, the restart, the timeline and the NotReady leg.
    assert got["tenant_bind_exemplar"][1] == traced["trace_id"]
    restart = got["restart"]
    assert restart["restored_trace"] == traced["trace_id"]
    assert restart["restored_spans"] == traced["spans"]
    assert restart["replayed"] > 0 and restart["restart_s"] > 0
    assert restart["markers_before"] == ["restart"]
    assert restart["segments"] >= 1
    assert restart["ledger_used_gib"] == 7
    watched = got["timeline"]
    assert watched["series_last"]["fleet_nodes"] == 17
    assert watched["bind_exemplars"] >= 1
    notready = got["notready"]
    assert notready["node"] == "h100-0000"
    assert notready["event"].endswith(f"[timeline {notready['cursor']}]")
    assert notready["ready_drop_s"] <= chip_smoke.NOTREADY_TICKS * 2.0
    # The profiler armed over both churns (the signal driver: the churn
    # runs on the main thread), its legs, and disarmed after.
    prof = got["profiler"]
    assert prof["driver"] == "signal" and prof["sampling_passes"] > 0
    assert 0 <= prof["overhead_ratio"] < 1
    for verb in ("filter", "prioritize", "bind"):
        assert prof["verb_costs"][verb]["decisions"] > 0
        assert prof["engines"][verb] == "decision-probe"
        assert 0 < len(prof["top_frames"][verb]) <= 5
        assert (prof["verb_costs_both_churns"][verb]["decisions"]
                > prof["verb_costs"][verb]["decisions"])
    assert prof["verb_costs"]["bind"]["decisions"] == churn["bound"]
    assert 0 < prof["attribution"] <= 1
    assert prof["attribution_pass"] == (prof["attribution"] >= 0.90)
    assert prof["continuous_lines"] > 1 and prof["continuous_bytes"] > 0
    assert prof["overlap_status"] == 409
    assert prof["profile_stacks"] > 0 and prof["trace_events"] > 0
    assert prof["threads_named"] > 0
    assert prof["heap_stop"].startswith("# tracemalloc stopped")
    assert (prof["itimer_prof"], prof["sigprof_restored"]) == ([0.0, 0.0],
                                                               True)
    assert prof["after_gc_posture"]["running"] is True
    assert not tprofiling.running()
    assert signal.getitimer(signal.ITIMER_PROF) == (0.0, 0.0)
    assert [s["phase"] for s in got["tenant_lock_wait"]] == [
        "filter", "quota", "prioritize", "bind", "allocate"]


def test_a_restart_that_replays_nothing_fails(held, tmp_path,
                                              monkeypatch):
    from tpushare_torch import obs as tobs

    monkeypatch.setattr(tobs, "replay_startup", lambda: 0)
    with pytest.raises(RuntimeError, match=r"/debug/trace\?id=\w+: 404"):
        chip_smoke.extender_phase(_host(), str(tmp_path), fleet=16,
                                  target=200)


def test_ledger_checks_catch_a_ledger_that_lies(held, tmp_path,
                                               monkeypatch):
    """A live ledger that drops a bound pod disagrees with the grants in
    the apiserver, and the phase fails."""
    from tpushare_torch.cache import cache as C

    real = C.SchedulerCache.add_or_update_pod

    def lossy(self, pod):
        if pod.name == "churn-00003":
            return False
        return real(self, pod)
    monkeypatch.setattr(C.SchedulerCache, "add_or_update_pod", lossy)
    with pytest.raises(RuntimeError):
        chip_smoke.extender_phase(_host(), str(tmp_path), fleet=16,
                                  target=60)


def test_a_grant_with_another_decision_s_id_fails_the_run(
        held, tmp_path, monkeypatch):
    """The tenant's ``trace-id`` annotation must be its decision's."""
    from tpushare_torch.cache import nodeinfo

    real = nodeinfo.podutils.updated_pod_annotation_spec

    def other_id(*args, **kwargs):
        kwargs["trace_id"] = "0123456789ab"
        return real(*args, **kwargs)
    monkeypatch.setattr(nodeinfo.podutils, "updated_pod_annotation_spec",
                        other_id)
    with pytest.raises(RuntimeError, match="trace-id 0123456789ab"):
        chip_smoke.extender_phase(_host(), str(tmp_path), fleet=16,
                                  target=60)


def _short_by_one(monkeypatch, family, method: str, skip: int) -> None:
    """``family``'s ``method`` drops its ``skip``-th call."""
    real = getattr(family, method)
    calls = [0]

    def dropping(*args, **kwargs):
        calls[0] += 1
        if calls[0] != skip:
            return real(*args, **kwargs)
    monkeypatch.setattr(family, method, dropping)


def test_a_bind_the_metrics_miss_fails_the_run(held, tmp_path,
                                              monkeypatch):
    _short_by_one(monkeypatch, tmetrics.BIND_LATENCY, "observe", 1)
    with pytest.raises(RuntimeError, match="0.0 binds of 1 sent"):
        chip_smoke.extender_phase(_host(), str(tmp_path), fleet=16,
                                  target=60)


def test_a_filter_the_metrics_miss_fails_the_churn(held, tmp_path,
                                                  monkeypatch):
    _short_by_one(monkeypatch, tmetrics.FILTER_REQUESTS, "inc", 7)
    with pytest.raises(RuntimeError, match="/metrics counted"):
        chip_smoke.extender_phase(_host(), str(tmp_path), fleet=16,
                                  target=60)


def test_parse_metrics_reads_the_exposition():
    text = tmetrics.REGISTRY.render().decode()
    got = chip_smoke.parse_metrics(
        text + 'x_total{node="a\\"b",le="+Inf"} 2.0\nx 1e+07\n')
    assert got[("x_total", (("le", "+Inf"), ("node", 'a\\"b')))] == 2.0
    assert chip_smoke.sample(got, "x") == 1e7
    assert chip_smoke.sample(got, "tpushare_leader") in (0.0, 1.0)
    assert chip_smoke.sample(got, "tpushare_quota_denied_total",
                             tenant="nobody") == 0.0


def test_wire_timed_api_counts_requests_on_the_open_span():
    api = chip_smoke.WireTimedApi()
    api.create_node({"metadata": {"name": "n"}})
    with ttrace.phase("bind", "default", "p", "u") as dec:
        with ttrace.span("allocate"):
            api.get_node("n")
            api.list_pods()
        api.list_nodes()
    ttrace.complete(dec, "bound")
    spans = ttrace.get_trace("default", "p")["spans"]
    assert [s["apiCalls"] for s in spans] == [1, 2]
    api.get_node("n")  # outside a decision: nothing to note
    ttrace.reset()


def test_no_card_means_no_result(monkeypatch, capsys):
    """Without a card the script exits nonzero before any phase."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(chip_smoke, "nvidia_smi",
                        lambda q: (_ for _ in ()).throw(OSError("none")))
    assert chip_smoke.main(str("/nonexistent")) == 2
    assert "ok" not in capsys.readouterr().out


def test_overhead_gates_run_on_the_host(monkeypatch):
    """The timeline's, the journal's and the profiler's overhead gates
    (run on the card by ``tools/extender_phases.py --overhead``) at a
    small size: each arm timed in every batch, the verdict's arithmetic,
    and the environment put back, the profiler disarmed."""
    import os

    for key in ("TPUSHARE_TIMELINE", "TPUSHARE_BLACKBOX_DIR",
                "TPUSHARE_EXPORT_URL"):
        monkeypatch.delenv(key, raising=False)
    got = chip_smoke.overhead_phase(fleet=8, batches=2, per_batch=10)
    assert got["nodes"] == 8
    assert got["profiler"]["driver"] == "signal"
    assert got["profiler"]["sampling_passes"] >= 0
    for gate in (got["timeline"], got["blackbox"], got["profiler"]):
        assert len(gate["batch_p99s_off_ms"]) == \
            len(gate["batch_p99s_on_ms"]) == 2
        assert gate["p99_off_ms"] == min(gate["batch_p99s_off_ms"])
        assert gate["delta_ms"] == max(gate["p99_on_ms"]
                                       - gate["p99_off_ms"], 0.0)
        assert gate["limit_ms"] >= chip_smoke.OVERHEAD_FLOOR_MS
        assert gate["pass"] == (gate["delta_ms"] <= gate["limit_ms"])
    for key in ("TPUSHARE_TIMELINE", "TPUSHARE_BLACKBOX_DIR",
                "TPUSHARE_EXPORT_URL"):
        assert key not in os.environ
    assert not tprofiling.running()
    assert signal.getitimer(signal.ITIMER_PROF) == (0.0, 0.0)
