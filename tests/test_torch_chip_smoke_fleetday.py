"""Phase 2k of ``chip_smoke.py`` (``chip_smoke_fleetday.py``) on the CPU.

The card's service rates are stubbed (a host has no card to time); the
rest runs as on the card: the reference's fleet day at 24 hours and seed
1234 through ``tools/simulate_torch.py``, held to ``BENCH_FLEETDAY.json``;
the same day at the stubbed rates, its five gates reported; and
``bench_fleetday_torch.py``'s smoke in process. The phase fails when a
marker is dropped (the witness no longer reads 6 of 6), when its day is
not the committed one, and when no forward launch was counted; the
measurement itself raises without a card. ``tools/extender_phases.py
--only 2k`` runs it alone. A run on the card needs an NVIDIA card and is
marked so; here it skips. The executors leave the objectives that judge
the test host's own filter latency out of their SLO veto
(``host_latency_vetoes_nothing`` of ``tests/test_torch_simulate.py``);
on the card they keep it whole.
"""

from __future__ import annotations

import gc
import json
import sys

import pytest
import torch

import chip_smoke
import chip_smoke_fleetday as CF
from tests.test_torch_simulate import host_latency_vetoes_nothing  # noqa: F401
from tests.torch_obs_reset import fresh_port_obs  # noqa: F401
from tpushare_torch import obs as tobs

#: Rates of the order PERF.md predicts for the card (not a measurement).
STUB = {"decode_tok_s": 9000.0, "prefill_tok_s": 60000.0, "admit_ms": 2.1,
        "admit_ms_min": 2.0, "chunk_ms": 28.4, "chunk_ms_min": 28.0,
        "shape": {}, "launches": 48}


@pytest.fixture
def stubbed(monkeypatch):
    """The rates as ``STUB`` gives them (a host has no card to time)."""
    monkeypatch.setattr(CF, "service_rates", lambda cs: dict(STUB))


def test_fleetday_phase_on_the_host(stubbed):
    thresholds = gc.get_threshold()
    got = CF.fleetday_phase(chip_smoke)
    json.dumps(got)
    assert gc.get_threshold() == thresholds and gc.get_freeze_count() == 0
    assert got["witness"] == {"reference_rate": CF.MATCHED,
                              "card_rate": CF.MATCHED}
    committed = CF.committed_day()
    assert got["reference_rate_day"]["scalars"] == committed["scalars"]
    assert got["reference_rate_day"]["outcomes"] == \
        committed["traffic"]["outcomes"]
    assert got["reference_rates"] == {"decode_tok_s": 4000.0,
                                      "prefill_tok_s": 200000.0,
                                      "admission_overhead": 0.10}
    assert got["rates"]["decode_tok_s"] == STUB["decode_tok_s"]
    assert set(got["card_rate_gates"]) == {
        "witness_conformance", "pod_slo_compliance",
        "router_fairness_jain", "node_hours_ratio", "guarantee_evictions"}
    assert got["card_rate_gates"]["witness_conformance"]["pass"]
    assert got["card_rate_day"]["scalars"]["guarantee_evictions"] == 0
    assert got["launches"] == {"fleetday_rates": 48}
    bench = got["bench_twin"]
    assert bench["smoke"] and bench["day"]["hours"] == 12
    assert bench["day"]["witness"]["counts"] == CF.MATCHED
    assert got["phase_s"] > 0


def test_a_dropped_marker_fails_the_phase(stubbed, monkeypatch):
    real = tobs.mark

    def dropping(kind, detail, **attrs):
        if kind == "node-notready":
            return -1
        return real(kind, detail, **attrs)

    monkeypatch.setattr(tobs, "mark", dropping)
    with pytest.raises(RuntimeError, match="witness"):
        CF.fleetday_phase(chip_smoke)


def test_a_day_unequal_to_the_committed_one_fails(stubbed, monkeypatch):
    committed = CF.committed_day()
    committed["fleetByHour"][-1] += 1
    monkeypatch.setattr(CF, "committed_day", lambda: committed)
    with pytest.raises(RuntimeError, match="fleetByHour"):
        CF.fleetday_phase(chip_smoke)


def test_no_counted_launch_fails(monkeypatch):
    monkeypatch.setattr(CF, "service_rates",
                        lambda cs: dict(STUB, launches=0))
    with pytest.raises(RuntimeError, match="no forward launch"):
        CF.fleetday_phase(chip_smoke)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_the_rates_need_a_card():
    with pytest.raises(RuntimeError, match="CUDA device"):
        CF.service_rates(chip_smoke)


def test_extender_phases_runs_2k_alone(stubbed, monkeypatch, tmp_path,
                                      capsys):
    import tools.extender_phases as XP

    monkeypatch.setattr(XP.CS, "nvidia_smi", lambda q: "stub card, 0 W")
    monkeypatch.setattr(XP.CS.FA, "build_seconds", lambda: {})
    monkeypatch.setattr(XP.discovery, "discover_host", lambda: None)
    out = tmp_path / "fleetday.json"
    monkeypatch.setattr(sys, "argv", ["extender_phases.py", "--only", "2k",
                                      "--out", str(out)])
    assert XP.main() == 0
    doc = json.loads(out.read_text())
    assert [k for k in doc if k.startswith("2")] == ["2k fleet day"]
    assert doc["2k fleet day"]["witness"]["card_rate"] == CF.MATCHED
    assert "[2k fleet day]" in capsys.readouterr().out


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="the rates are timed on an NVIDIA card")
def test_service_rates_on_the_card():
    chip_smoke.FA.build_seconds()
    got = CF.service_rates(chip_smoke)
    assert got["launches"] == got["shape"]["n_layers"] * CF.RATE_REPS
    assert got["decode_tok_s"] > 0 and got["prefill_tok_s"] > 0
