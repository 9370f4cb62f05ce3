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

from tests.torch_obs_reset import fresh_port_obs  # noqa: F401
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
    monkeypatch.setattr(M, "setup_signals",
                        lambda stop, flush=None: stop.set())
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
                 "DEBUG_ROUTES", "TPUSHARE_PROFILE", "TPUSHARE_PROFILE_HZ",
                 *TIMELINE_VARIABLES, *SLO_DEFRAG_VARIABLES):
        assert name in tdoc and name not in M.NOT_PORTED


#: The pod-journey SLOs' and the defrag executor's variables, which the
#: port's main reads (``tests/test_torch_defrag.py`` holds their effect to
#: the reference's).
SLO_DEFRAG_VARIABLES = ("TPUSHARE_SLO_NAMESPACE", "TPUSHARE_DEFRAG_MODE",
                        "TPUSHARE_DEFRAG_MAX_MOVES",
                        "TPUSHARE_DEFRAG_MOVES_PER_HOUR",
                        "TPUSHARE_DEFRAG_NODE_COOLDOWN_S",
                        "TPUSHARE_DEFRAG_MAX_CONCURRENT",
                        "TPUSHARE_DEFRAG_INTERVAL_S")

#: The retrospective layer's variables, which the port's main reads.
TIMELINE_VARIABLES = ("TPUSHARE_TIMELINE", "TPUSHARE_BLACKBOX_DIR",
                      "TPUSHARE_BLACKBOX_SEGMENT_BYTES",
                      "TPUSHARE_BLACKBOX_SEGMENTS", "TPUSHARE_EXPORT_URL")


class _Sink:
    """A localhost HTTP sink for the push exporter: keeps each body."""

    def __init__(self):
        import http.server
        import threading

        bodies = self.bodies = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 (stdlib casing)
                n = int(self.headers.get("Content-Length", 0))
                bodies.append(self.rfile.read(n))
                self.send_response(200)
                self.end_headers()

            def log_message(self, *args):
                pass

        self.server = http.server.HTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}/"

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.mark.parametrize("name", TIMELINE_VARIABLES)
def test_main_reads_the_timeline_variables(no_cluster, monkeypatch, caplog,
                                           tmp_path, name):
    """Each variable is read, not warned of: the journal is armed in its
    directory (a segment holding the ``restart`` marker that the
    controller's start stamps, bounded by the two size variables), the
    exporter posts the same marker to its URL beside the journal, and
    ``TPUSHARE_TIMELINE=off`` stamps no marker at all."""
    import json
    import os

    from tpushare_torch import obs

    monkeypatch.setenv("TPUSHARE_GC_TUNE", "off")
    journal = str(tmp_path / "journal")
    sink = None
    env = {"TPUSHARE_TIMELINE": {"TPUSHARE_TIMELINE": "off",
                                 "TPUSHARE_BLACKBOX_DIR": journal},
           "TPUSHARE_BLACKBOX_DIR": {"TPUSHARE_BLACKBOX_DIR": journal},
           "TPUSHARE_BLACKBOX_SEGMENT_BYTES": {
               "TPUSHARE_BLACKBOX_DIR": journal,
               "TPUSHARE_BLACKBOX_SEGMENT_BYTES": "4096"},
           "TPUSHARE_BLACKBOX_SEGMENTS": {
               "TPUSHARE_BLACKBOX_DIR": journal,
               "TPUSHARE_BLACKBOX_SEGMENTS": "2"}}.get(name, {})
    if name == "TPUSHARE_EXPORT_URL":
        sink = _Sink()
        env = {name: sink.url, "TPUSHARE_BLACKBOX_DIR": journal}
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    seen = {}
    real = obs._arm_blackbox

    def arm():
        real()
        if obs.blackbox() is not None:
            seen["bounds"] = (obs.blackbox().segment_bytes,
                              obs.blackbox().max_segments)
    monkeypatch.setattr(obs, "_arm_blackbox", arm)
    try:
        with caplog.at_level(logging.WARNING, logger=M.log.name):
            M.main()
    finally:
        if sink is not None:
            sink.close()
        obs.reset()
    assert not [r for r in caplog.records if r.name == M.log.name
                and r.levelno >= logging.WARNING]
    if name == "TPUSHARE_EXPORT_URL":
        posted = [json.loads(line) for body in sink.bodies
                  for line in body.splitlines()]
        assert [d["kind"] for d in posted if d["t"] == "marker"] == \
            ["restart"]
        return
    kinds = [d["kind"] for d in obs.replay(journal)
             if d["t"] == "marker"]
    assert kinds == ([] if name == "TPUSHARE_TIMELINE" else ["restart"])
    assert os.listdir(journal)
    assert seen["bounds"] == {
        "TPUSHARE_BLACKBOX_SEGMENT_BYTES": (4096, 8),
        "TPUSHARE_BLACKBOX_SEGMENTS": (1 << 20, 2)}.get(name, (1 << 20, 8))


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
