"""Phase 2j of ``chip_smoke.py`` (``chip_smoke_autoscale.py``) on the CPU.

The card's node comes from an inventory as the native shim reports a
host whose visible card is host index 3, and the tenant on the card is
``tests/test_torch_chip_smoke_defrag.py``'s process-free ``StubTenant``
(its stream's check against the plain model is recorded, not run).
Everything else runs as on the card: the port's extender with the
autoscale executor active through ``AUTOSCALE_ENV`` and a router on a
virtual clock, the fleet filled so the decode shape fits only the card's
node, the surge and its scale-out (a capacity-exists hold, decode-1
placed on the card's node, granted over gRPC, served, registered from its
grant), burst alone shed, the card filled, the second scale-out's
defrag-first hold, the scale-up once every resident checkpoints, decode-2
bound on the new node, the trough's drain and delete, the gauges and the
markers, and the host twins beside it. The phase fails on an executor
that buys a node where capacity exists, and on one that never scales up.
A run on the card needs an NVIDIA card and is marked so; here it skips.
"""

from __future__ import annotations

import json

import pytest
import torch

import chip_smoke
import chip_smoke_autoscale as CA
from tests.test_torch_chip_smoke_defrag import StubTenant, _host, stubbed  # noqa: F401
from tests.torch_obs_reset import fresh_port_obs  # noqa: F401
from tpushare_torch.api.objects import ConfigMap
from tpushare_torch.deviceplugin import discovery, plugin
from tpushare_torch.quota import config as tquota_config
from tpushare_torch.workload import model as M
from tpushare_torch.workload import serving as S


def test_the_env_and_the_quota_configmap():
    assert CA.AUTOSCALE_ENV["TPUSHARE_AUTOSCALE"] == "active"
    assert float(CA.AUTOSCALE_ENV["TPUSHARE_AUTOSCALE_DOWN_DELAY_S"]) == \
        CA.DOWN_DELAY_S
    cfg = tquota_config.parse_configmap(ConfigMap(CA.quota_configmap()))
    assert set(cfg.tenants) == {*CA.TENANTS, CA.SERVING_NS}
    # The serving tenant's guarantee holds every decode pod of the phase.
    assert cfg.tenants[CA.SERVING_NS].guarantee_hbm == 3 * CA.DECODE_GIB
    # The fill: no decode pod fits a filled card, the small pod moves to
    # one, and moving it off the card makes room for one.
    assert CA.FLEET_FREE_GIB < CA.DECODE_GIB
    assert CA.CARD_SMALL_GIB <= CA.FLEET_FREE_GIB
    assert CA.CARD_FREE_GIB < CA.DECODE_GIB <= \
        CA.CARD_FREE_GIB + CA.CARD_SMALL_GIB


def test_autoscale_phase_on_the_host(stubbed, tmp_path):
    usage = str(tmp_path / "usage")
    got = chip_smoke.autoscale_phase(_host(), usage)
    json.dumps(got)
    [tenant] = StubTenant.made
    assert tenant.gated and tenant.launched and tenant.stopped
    assert tenant.alloc == plugin.build_allocation(
        _host(), [3], CA.DECODE_GIB, pod_uid="uid-decode-1",
        usage_dir=usage)
    assert stubbed == [[[1, 2, 3]]]
    steps = [(d["action"], d["reason"] or d["phase"]) for d in
             got["decisions"]]
    assert steps == [("hold", "capacity-exists"), ("hold", "defrag-first"),
                     ("scale-up", None), ("scale-down", "delete")]
    assert all(d["ms"] > 0 for d in got["decisions"])
    assert CA.AUTOSCALE_NODE not in [d["node"] for d in got["decisions"]]
    first = got["scale_out"]["first"]
    assert first["slots"] == S.max_batch_for_grant(
        M.ModelConfig(), CA.DECODE_GIB, max_len=CA.MAX_LEN)
    assert set(first) >= {"control_plane_s", "allocate_s", "tenant_s",
                          "to_first_request_done_s"}
    shed = got["router"]["shed"]
    assert shed["burst"] > 0 and shed["chat-a"] == shed["chat-b"] == 0
    assert got["router"]["signals"] == 2
    assert got["router"]["ttft"]["p99"] >= got["router"]["ttft"]["p50"] > 0
    assert got["cluster_nodes"] == {"ready": 4.0, "cordoned": 0.0}
    assert got["actions"] == {"hold": 2.0, "up": 1.0, "down": 1.0,
                              "deleted": 1.0}
    assert got["markers"] == {"router-scaleout": 2, "autoscale-up": 1,
                              "autoscale-down": 2, "autoscale-abort": 0}
    assert got["launches"] == {"autoscale_tenant": 8}
    twins = got["twin_documents"]
    assert all(twins["bench_router"]["gates"].values())
    assert all(g["pass"] for g in twins["bench_autoscale"]["gates"].values())
    assert got["scrape_ms"] > 0


def test_the_phase_serves_with_a_tenant_started_before_it(stubbed,
                                                          tmp_path):
    usage = str(tmp_path / "usage")
    early = chip_smoke.autoscale_tenant(_host(), usage)
    assert early.launched and early.gated and not early.stopped
    got = chip_smoke.autoscale_phase(_host(), usage, tenant=early)
    assert StubTenant.made == [early] and early.stopped
    assert got["tenant"]["launches"] == 8


def test_an_executor_that_buys_a_node_where_capacity_exists_fails(
        stubbed, tmp_path, monkeypatch):
    from tpushare_torch.autoscale.executor import AutoscaleExecutor
    monkeypatch.setattr(AutoscaleExecutor, "_schedulable_infos",
                        lambda self: [])
    with pytest.raises(RuntimeError, match="first scale-out"):
        chip_smoke.autoscale_phase(_host(), str(tmp_path / "usage"))
    assert all(t.stopped for t in StubTenant.made)


def test_an_executor_that_never_scales_up_fails(stubbed, tmp_path,
                                                monkeypatch):
    from tpushare_torch.autoscale.executor import AutoscaleExecutor
    real = AutoscaleExecutor._scale_up

    def never(self, shapes, detail):
        doc = real(self, shapes, detail)
        if doc["action"] == "scale-up":
            return self._hold("max-nodes", "refused")
        return doc
    monkeypatch.setattr(AutoscaleExecutor, "_scale_up", never)
    with pytest.raises(RuntimeError, match="the scale-up"):
        chip_smoke.autoscale_phase(_host(), str(tmp_path / "usage"))


def test_extender_phases_runs_2j_alone():
    import tools.extender_phases as XP
    import inspect
    assert "2j" in inspect.getsource(XP)
    assert chip_smoke.autoscale_phase.__module__ == "chip_smoke"


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="the tenant serves on an NVIDIA card")
def test_autoscale_phase_on_the_card(tmp_path):
    chip_smoke.FA.build_seconds()
    got = chip_smoke.autoscale_phase(discovery.discover_host(),
                                     str(tmp_path))
    assert got["stream"]["tokens_equal"]
