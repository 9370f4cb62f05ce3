"""The extender's GC posture and timestamps (``tpushare_torch/utils/
runtime.py``, ``utils/k8stime.py``) against the JAX package's, and the
environment the port's ``main`` reads beyond what it did before: the GC
posture applied by ``main`` and not by ``serve_stack``, and one warning
for each of the reference main's variables the port does not read yet.

Every test restores the interpreter's thresholds and unfreezes what it
froze.
"""

from __future__ import annotations

import gc
import logging

import pytest

from tpushare.utils import k8stime as jtime
from tpushare.utils import runtime as jrt
from tpushare_torch.cmd import main as M
from tpushare_torch.k8s.fake import FakeApiServer
from tpushare_torch.utils import k8stime as ttime
from tpushare_torch.utils import runtime as trt


@pytest.fixture(autouse=True)
def restore_gc():
    before = gc.get_threshold()
    yield
    gc.set_threshold(*before)
    gc.unfreeze()


@pytest.mark.parametrize("env", [
    {}, {"TPUSHARE_GC_TUNE": "on"}, {"TPUSHARE_GC_TUNE": "OFF"},
    {"TPUSHARE_GC_TUNE": "0"}, {"TPUSHARE_GC_TUNE": "false"},
    {"TPUSHARE_GC_TUNE": "no"}, {"TPUSHARE_GC_GEN0": "5000"},
    {"TPUSHARE_GC_GEN0": "0"}, {"TPUSHARE_GC_GEN0": "-3"},
    {"TPUSHARE_GC_GEN0": "lots"},
    {"TPUSHARE_GC_TUNE": "off", "TPUSHARE_GC_GEN0": "9"},
])
def test_tune_gc_from_env_matches_the_reference(monkeypatch, env):
    for key in ("TPUSHARE_GC_TUNE", "TPUSHARE_GC_GEN0"):
        monkeypatch.delenv(key, raising=False)
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    out = []
    for mod in (jrt, trt):
        gc.set_threshold(700, 10, 10)
        applied = mod.tune_gc_from_env()
        out.append((applied, gc.get_threshold()))
    assert out[1] == out[0]


@pytest.mark.parametrize("args", [
    {}, {"gen0": 0, "gen1": -1, "gen2": 3}, {"gen0": 12, "gen1": 7}])
def test_tune_gc_matches_the_reference(args):
    out = []
    for mod in (jrt, trt):
        gc.set_threshold(700, 10, 10)
        mod.tune_gc(**args)
        out.append(gc.get_threshold())
    assert out[1] == out[0]
    assert (trt.DEFAULT_GEN0, trt.DEFAULT_GEN1, trt.DEFAULT_GEN2) == (
        jrt.DEFAULT_GEN0, jrt.DEFAULT_GEN1, jrt.DEFAULT_GEN2)


def test_freeze_moves_the_live_heap_to_the_permanent_generation():
    gc.unfreeze()
    keep = [[i] for i in range(1000)]
    trt.tune_gc(freeze=True)
    assert gc.get_freeze_count() >= len(keep)


STAMPS = ["2026-10-18T09:21:13Z", "2026-10-18T09:21:13.123456Z",
          "2026-10-18T09:21:13.5Z", "1970-01-01T00:00:00Z",
          "2026-10-18T09:21:13+00:00", "2026-10-18 09:21:13Z",
          "2026-13-01T00:00:00Z", "", "garbage", None, 17]


@pytest.mark.parametrize("raw", STAMPS, ids=[repr(s) for s in STAMPS])
def test_parse_rfc3339_matches_the_reference(raw):
    assert ttime.parse_rfc3339(raw) == jtime.parse_rfc3339(raw)
    assert (ttime.parse_rfc3339_epoch(raw)
            == jtime.parse_rfc3339_epoch(raw))
    assert ttime.RFC3339_FRACTIONAL == jtime.RFC3339_FRACTIONAL


# -- main's environment --------------------------------------------------- #

@pytest.fixture
def no_cluster(monkeypatch):
    """The fake apiserver in place of the cluster; the first wait for a
    signal returns at once."""
    api = FakeApiServer()
    monkeypatch.setattr(M.ClusterConfig, "auto",
                        classmethod(lambda cls: None))
    monkeypatch.setattr(M, "ApiClient", lambda cfg: api)
    monkeypatch.setattr(M, "setup_signals", lambda stop: stop.set())
    monkeypatch.setattr(M, "configure_logging", lambda: None)
    for key in ("TLS_CERT_FILE", "TLS_KEY_FILE", "LEADER_ELECT",
                "TPUSHARE_GC_TUNE", "TPUSHARE_GC_GEN0", *M.NOT_PORTED):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("PORT", "0")
    return api


@pytest.mark.parametrize("name", sorted(M.NOT_PORTED))
def test_main_warns_of_each_variable_it_does_not_read(no_cluster,
                                                      monkeypatch, caplog,
                                                      name):
    monkeypatch.setenv(name, "1")
    monkeypatch.setenv("TPUSHARE_GC_TUNE", "off")
    with caplog.at_level(logging.WARNING, logger=M.log.name):
        M.main()
    lines = [r.getMessage() for r in caplog.records
             if r.name == M.log.name and r.levelno == logging.WARNING]
    assert lines == [f"{name} is set but not read: {M.NOT_PORTED[name]} "
                     "is not yet ported"]


def test_main_warns_of_nothing_when_none_is_set(no_cluster, monkeypatch,
                                                caplog):
    monkeypatch.setenv("TPUSHARE_GC_TUNE", "off")
    with caplog.at_level(logging.WARNING, logger=M.log.name):
        M.main()
    assert not [r for r in caplog.records if r.name == M.log.name
                and r.levelno >= logging.WARNING]


def test_not_ported_names_the_reference_main_s_variables():
    """Each variable the port warns of is one the reference's main
    documents, and none is one the port reads."""
    import inspect

    from tpushare.cmd import main as jmain
    jdoc = inspect.getsource(jmain)
    for name in M.NOT_PORTED:
        assert name in jdoc, name
    tdoc = M.__doc__.split("Variables of the reference")[0]
    for name in M.NOT_PORTED:
        assert name not in tdoc, name
    for name in ("LEADER_ELECT", "LEASE_NAMESPACE", "TPUSHARE_GC_TUNE",
                 "TPUSHARE_QUOTA_NAMESPACE", "TPUSHARE_LOG_JSON",
                 "DEBUG_ROUTES"):
        assert name in tdoc and name not in M.NOT_PORTED


@pytest.mark.parametrize("env,applied", [
    ({}, True), ({"TPUSHARE_GC_TUNE": "off"}, False),
    ({"TPUSHARE_GC_GEN0": "2500"}, True)])
def test_main_applies_the_gc_posture(no_cluster, monkeypatch, env, applied):
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    gc.set_threshold(700, 10, 10)
    M.main()
    gen0 = int(env.get("TPUSHARE_GC_GEN0", trt.DEFAULT_GEN0))
    want = ((gen0, trt.DEFAULT_GEN1, trt.DEFAULT_GEN2) if applied
            else (700, 10, 10))
    assert gc.get_threshold() == want


def test_serve_stack_keeps_the_interpreter_s_thresholds():
    gc.set_threshold(700, 10, 10)
    stack, server = M.serve_stack(FakeApiServer())
    try:
        assert gc.get_threshold() == (700, 10, 10)
    finally:
        M.shutdown_stack(stack, server)
