"""Phase 2i of ``chip_smoke.py`` (``defrag_phase``) on the CPU, and phase
2f's journey and fragmentation numbers (``pod_e2e_p99_s``,
``churn_gates``).

The card's node comes from an inventory as the native shim reports a
host whose visible card is host index 3. The tenant on the card is stood
in for by a process-free ``ServingTenant`` that prints what the gated
tenant prints (its stream included) and writes its heartbeat where the
grant says; the card's free bytes are a counter, and the stream's check
against the plain model is recorded (it runs here on its own, at a tiny
width). Everything else runs as on the card: the port's extender over a
fake apiserver with the executor active through ``DEFRAG_ENV``, the SLO
ConfigMap trusted from its namespace, the port's daemon granting over
gRPC, the fill to a splinter, the pending pod filter refuses, the abort
on the burning objective and its lift through the ConfigMap, the move
through the fake's eviction API, the successor and the pending pod
placed, the journey and the gauges. The phase fails on an executor that
ignores the burn and on a planner that would move the pod with a
checkpoint in flight. A run on the card needs an NVIDIA card and is
marked so; here it skips.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

import chip_smoke
from tests.torch_obs_reset import fresh_port_obs  # noqa: F401
from tpushare_torch.api.objects import ConfigMap
from tpushare_torch.defrag import planner as tplanner
from tpushare_torch.deviceplugin import discovery, plugin
from tpushare_torch.routes import exposition as X
from tpushare_torch.routes import metrics as tmetrics
from tpushare_torch.slo import config as tconfig
from tpushare_torch.utils import const
from tpushare_torch.workload import model as M
from tpushare_torch.workload import serving as S


def _host(cards=1, first=3):
    return discovery.HostInventory(
        "h100-80gb", "", source="native", chips=tuple(
            discovery.ChipSpec(i, 79, f"/dev/nvidia{i}", "h100-80gb")
            for i in range(first, first + cards)))


# -- the sizing and the ConfigMaps ------------------------------------------- #

@pytest.mark.parametrize("card_gib,fleet_gib", [(79, 79), (94, 79),
                                                (79, 94)])
def test_the_fill_leaves_a_splinter_and_room_for_the_move(card_gib,
                                                          fleet_gib):
    got = chip_smoke.defrag_fill(card_gib, fleet_gib)
    card = dict(got["card"])
    assert sum(card.values()) + got["card_free_gib"] == card_gib
    # The card's splinter takes no pending pod; freeing the movable pod
    # makes room for one.
    assert got["card_free_gib"] < chip_smoke.TENANCY_GIB <= (
        got["card_free_gib"] + card["defrag-movable"])
    # The movable pod is the largest the planner may move there.
    movable = {n: g for n, g in card.items() if n != "defrag-ckpt"}
    assert max(movable, key=movable.get) == "defrag-movable"
    assert list(movable.values()).count(card["defrag-movable"]) == 1
    # Each fleet card takes the movable pod and no pending one.
    assert card["defrag-movable"] <= got["fleet_free_gib"] < \
        chip_smoke.TENANCY_GIB
    assert got["fleet_pod_gib"] + got["fleet_free_gib"] == fleet_gib


def test_a_card_too_small_for_the_fill_fails():
    with pytest.raises(RuntimeError, match="no checkpointing pod"):
        chip_smoke.defrag_fill(50, 79)


def test_the_slo_configmaps_parse_to_their_objectives():
    for entries in (chip_smoke.DEFRAG_BURNING_SLO,
                    chip_smoke.DEFRAG_LIFTED_SLO):
        doc = chip_smoke.slo_configmap(chip_smoke.DEFRAG_SLO_NAMESPACE,
                                       entries)
        assert doc["metadata"] == {
            "name": const.SLO_CONFIGMAP,
            "namespace": chip_smoke.DEFRAG_SLO_NAMESPACE}
        cfg = tconfig.parse_configmap(ConfigMap(doc))
        assert cfg is not tconfig.DEFAULTS and set(cfg.slos) == set(entries)
    [spec] = tconfig.parse_configmap(ConfigMap(chip_smoke.slo_configmap(
        "x", chip_smoke.DEFRAG_BURNING_SLO))).slos.values()
    # Any bind later than 1 ms after its pod's creation is bad, and half
    # bad burns at the fast-burn multiple.
    assert (spec.signal, spec.threshold_seconds, spec.objective,
            spec.fast_burn) == ("pod_e2e", 0.001, 0.5, 1.0)
    assert chip_smoke.DEFRAG_ENV["TPUSHARE_SLO_NAMESPACE"] == \
        chip_smoke.DEFRAG_SLO_NAMESPACE


# -- 2f's journey and fragmentation numbers ------------------------------------ #

def _bench_p99(values, monkeypatch):
    """``bench._pod_e2e_p99_s`` over a registry holding ``values``."""
    import prometheus_client as prom

    import bench
    from tpushare.routes import metrics as jmetrics
    reg = prom.CollectorRegistry()
    hist = prom.Histogram("tpushare_pod_e2e_scheduling_seconds", "e2e",
                          ["tenant", "outcome"], registry=reg,
                          buckets=jmetrics._E2E_BUCKETS)
    for i, v in enumerate(values):
        hist.labels(tenant=f"t{i % 3}",
                    outcome=("bound", "deleted")[i % 2]).observe(v)
    monkeypatch.setattr(jmetrics, "REGISTRY", reg)
    return bench._pod_e2e_p99_s()


@pytest.mark.parametrize("seed", range(4))
def test_pod_e2e_p99_is_bench_s(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    old = [float(v) for v in rng.exponential(50.0, 20)]
    new = [float(v) for v in rng.exponential(3.0, int(rng.integers(1, 300)))]
    if seed % 2:
        new.append(2000.0)   # past the last bound: +Inf
    reg = X.Registry()
    hist = X.Histogram("tpushare_pod_e2e_scheduling_seconds", "e2e",
                       ["tenant", "outcome"], registry=reg,
                       buckets=tmetrics._E2E_BUCKETS)

    def observe(values):
        for i, v in enumerate(values):
            hist.labels(tenant=f"t{i % 3}",
                        outcome=("bound", "deleted")[i % 2]).observe(v)
    observe(old)
    before = chip_smoke.parse_metrics(reg.render().decode())
    observe(new)
    after = chip_smoke.parse_metrics(reg.render().decode())
    assert chip_smoke.pod_e2e_p99_s(after, before) == _bench_p99(
        new, monkeypatch)
    assert chip_smoke.pod_e2e_p99_s(after, after) is None
    import bench
    assert chip_smoke.GATE_POD_E2E_P99_S == bench.GATE_POD_E2E_P99_S
    assert chip_smoke.GATE_STRANDED_RATIO == bench.GATE_STRANDED_RATIO


# -- the stream against the plain model ----------------------------------------- #

def _tiny():
    return dataclasses.replace(M.ModelConfig().tiny(), max_seq_len=256)


def _tenant_stream(cfg) -> list:
    """The gated tenant's first request at a tiny width on the CPU."""
    params = M.init_params(torch.Generator(device="cpu").manual_seed(0),
                           cfg, device="cpu")
    prompt = torch.randint(
        0, cfg.vocab_size, (chip_smoke.TENANT_BATCH,
                            chip_smoke.TENANT_PROMPT),
        generator=torch.Generator(device="cpu").manual_seed(1))
    with torch.inference_mode():
        out = S.generate(params, prompt, cfg, n_new=chip_smoke.TENANT_NEW,
                         max_len=chip_smoke.TENANT_PROMPT
                         + chip_smoke.TENANT_NEW)
    return out.tolist()


def test_the_stream_check_holds_a_stream_to_the_plain_model():
    cfg = _tiny()
    stream = _tenant_stream(cfg)
    got = chip_smoke.plain_stream_checks(stream, device="cpu", cfg=cfg)
    assert got["tokens_equal"] and got["plain_argmax_agree"] == 1.0
    assert got["plain_max_gap"] == 0.0
    # A token the model did not choose, far from its choice, fails.
    bad = json.loads(json.dumps(stream))
    bad[2][-5] = (bad[2][-5] + 7) % cfg.vocab_size
    with pytest.raises(RuntimeError, match="not the one this process"):
        chip_smoke.plain_stream_checks(bad, device="cpu", cfg=cfg)
    with pytest.raises(RuntimeError, match="is not its prompt's"):
        chip_smoke.plain_stream_checks(stream[:4], device="cpu", cfg=cfg)


# -- the phase on the host --------------------------------------------------------- #

class StubTenant:
    """``ServingTenant`` without a process: the gated tenant's result line
    for 2 prefills of 4 layers with a stream, and a fresh heartbeat of
    1 GiB in the grant's usage file."""

    made: list = []

    def __init__(self, alloc, gated=False):
        self.alloc = alloc
        self.gated = gated
        self.ready_s = None
        self.started_unix = None
        self.launched = self.stopped = False
        self.made.append(self)

    def launch(self) -> None:
        self.launched = True
        self.started_unix = time.time()

    def start(self) -> dict:
        assert self.launched and self.gated
        go = time.time()
        grant = int(self.alloc.envs[const.ENV_HBM_POD])
        path = self.alloc.envs[const.ENV_USAGE_FILE]
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"bytes_in_use": 1 << 30, "peak_bytes": 1 << 30,
                       "bytes_limit": grant << 30, "source": "stub",
                       "ts": time.time(), "pid": os.getpid()}, f)
        self.ready_s = time.time() - go
        return {"device_count": 1, "cuda_visible_devices": "0",
                "cap": round(grant / 79 * 0.9, 3), "launches": 8,
                "prefills": 2, "n_layers": 4, "tok_per_s": 1.0,
                "first_request_s": 0.1,
                "first_request_done_unix": time.time() + 0.1,
                "gated_unix": self.started_unix + 0.01, "go_unix": go,
                "stream": [[1, 2, 3]], "pid": os.getpid()}

    def stop(self) -> int:
        self.stopped = True
        return 0


@pytest.fixture
def stubbed(monkeypatch):
    monkeypatch.setattr(plugin, "chip_health", lambda path: plugin.HEALTHY)
    StubTenant.made = []
    monkeypatch.setattr(chip_smoke, "ServingTenant", StubTenant)
    free = iter(range(0, 1 << 40, 16 << 30))
    monkeypatch.setattr(chip_smoke, "card_free_bytes", lambda: next(free))
    streams = []

    def record(stream):
        streams.append(stream)
        return {"tokens_equal": True, "plain_argmax_agree": 1.0,
                "plain_max_gap": 0.0, "new_tokens": 512}
    monkeypatch.setattr(chip_smoke, "plain_stream_checks", record)
    return streams


def test_defrag_phase_on_the_host(stubbed, tmp_path):
    usage = str(tmp_path / "usage")
    got = chip_smoke.defrag_phase(_host(), usage)
    json.dumps(got)
    # The tenant started ahead, gated, in the grant the pending pod got.
    [tenant] = StubTenant.made
    assert tenant.gated and tenant.launched and tenant.stopped
    want = plugin.build_allocation(_host(), [3], chip_smoke.TENANCY_GIB,
                                   pod_uid="uid-defrag-pending",
                                   usage_dir=usage)
    assert tenant.alloc == want
    assert stubbed == [[[1, 2, 3]]]
    # (a) The fill, the splinter and the stranded GiB.
    assert got["movable"] == {"defrag-ckpt": [False, "checkpoint in flight"],
                              "defrag-movable": [True, ""]}
    card = got["card_node_frag"]
    assert (card["freeHBM"], card["strandedHBM"], card["score"]) == (
        10, 10, 1.0)
    fleet_free = got["sizing"]["fleet_free_gib"]
    assert got["stranded_gib_before"] == 10 + 3 * 8 * fleet_free
    assert got["frag_nodes"] == 4
    # (b) The abort, counted; the lift.
    abort = got["abort"]
    assert (abort["plan_status"], abort["reason"]) == ("aborted",
                                                       "slo-burn")
    assert (abort["slo_burn"], abort["evicted"]) == (1.0, 0.0)
    assert abort["cancelled"] >= 1 and abort["lift_s"] >= 0
    # (c) The move off the card, the budget, the pending pod served.
    plan = got["plan"]
    assert plan["moves"] == [{
        "pod": "default/defrag-movable", "from": chip_smoke.DEFRAG_NODE,
        "to": "h100-defrag-0", "status": "evicted"}]
    assert plan["unblocks"] == ["default/defrag-pending"]
    assert plan["evicted"] == 1 and plan["budget"]["usedLastHour"] == 1
    journey = got["journey"]
    assert journey["outcome"] == "bound" and journey["attemptsTotal"] == 2
    assert journey["refused"] == ["unschedulable"]
    assert got["stranded_gib_after"] < got["stranded_gib_before"]
    assert got["tenant"]["launches"] == 8
    assert got["launches"] == {"defrag_tenant": 8}
    assert got["card_freed_bytes"] == 16 << 30
    assert set(got["split_s"]) == {"plan", "eviction", "recreate_and_rebind",
                                   "pending_bind", "grant", "import_left",
                                   "process_start", "first_request"}
    assert all(v >= 0 for k, v in got["split_s"].items()
               if k != "import_left")
    assert got["ledger"]["used_gib"] == got["ledger"]["granted_gib"]


def test_the_phase_serves_with_a_tenant_started_before_it(stubbed,
                                                          tmp_path):
    usage = str(tmp_path / "usage")
    early = chip_smoke.defrag_tenant(_host(), usage)
    assert early.launched and early.gated and not early.stopped
    got = chip_smoke.defrag_phase(_host(), usage, tenant=early)
    assert StubTenant.made == [early] and early.stopped
    assert got["tenant"]["launches"] == 8


def test_an_executor_that_ignores_the_burn_fails(stubbed, tmp_path,
                                                 monkeypatch):
    from tpushare_torch.defrag.executor import DefragExecutor
    monkeypatch.setattr(DefragExecutor, "_engine_burning", lambda self: [])
    with pytest.raises(RuntimeError, match="the burning tick"):
        chip_smoke.defrag_phase(_host(), str(tmp_path / "usage"))
    assert all(t.stopped for t in StubTenant.made)


def test_a_planner_that_would_move_the_checkpoint_fails(stubbed, tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(tplanner.RebalancePlanner, "movable",
                        lambda self, pod: (True, ""))
    with pytest.raises(RuntimeError, match="movable"):
        chip_smoke.defrag_phase(_host(), str(tmp_path / "usage"))


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="the tenant serves on an NVIDIA card")
def test_defrag_phase_on_the_card(tmp_path):
    chip_smoke.FA.build_seconds()
    got = chip_smoke.defrag_phase(discovery.discover_host(), str(tmp_path))
    assert got["stream"]["tokens_equal"]
    assert got["card_freed_bytes"] > 0
