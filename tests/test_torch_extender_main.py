"""The scheduler extender's process (``tpushare_torch/cmd/main.py``):
its environment, the TLS misconfiguration it refuses, the per-level log
files, and ``python -m tpushare_torch.cmd.main``."""

from __future__ import annotations

import logging
import os
import subprocess
import sys
import threading

import pytest

from tests.torch_obs_reset import fresh_port_obs  # noqa: F401
from tpushare_torch.cmd import main as M
from tpushare_torch.k8s.fake import FakeApiServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    for key in ("PORT", "WORKERS", "TLS_CERT_FILE", "TLS_KEY_FILE",
                "TPUSHARE_SCORING", "DEBUG_ROUTES", "TPUSHARE_LOG_JSON"):
        monkeypatch.delenv(key, raising=False)
    return api


@pytest.mark.parametrize("env,port,workers,policy", [
    ({}, 39999, 4, "binpack"),
    ({"PORT": "0", "WORKERS": "2", "TPUSHARE_SCORING": "spread"}, 0, 2,
     "spread"),
])
def test_main_reads_its_environment(no_cluster, monkeypatch, env, port,
                                    workers, policy):
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    seen = {}
    real_start = M.Controller.start

    def start(self, workers=4):
        seen["workers"] = workers
        return real_start(self, workers=workers)
    monkeypatch.setattr(M.Controller, "start", start)

    class Server:
        def __init__(self, addr, predicate, binder, inspect, prioritize,
                     preempt, admission, leader, quota, gang_planner,
                     workqueue, defrag, autoscale, router, debug_routes):
            seen.update(addr=addr, policy=prioritize.policy,
                        scoring=predicate.cache._default_scoring)
            # Every verb is wired, over the controller's one quota ledger;
            # no election without LEADER_ELECT; /metrics reads the gang
            # planner, the workqueue and the defrag executor, whose frag
            # index reads the filter's demand, and the autoscale executor,
            # which reads it too and spends the defrag budget; main holds
            # no router; the debug routes are on.
            assert preempt.quota is quota is predicate.quota
            assert admission is not None and leader is None
            assert gang_planner is binder.gang_planner
            assert workqueue is not None and debug_routes is True
            assert defrag.demand is predicate.demand
            assert autoscale.demand is predicate.demand
            assert autoscale.budget is defrag.budget and router is None
            self.closed = threading.Event()

        def serve_forever(self):
            self.closed.wait()

        def shutdown(self):
            self.closed.set()
    monkeypatch.setattr(M, "ExtenderHTTPServer", Server)
    M.main()
    assert seen == dict(workers=workers, addr=("0.0.0.0", port),
                        policy=policy, scoring=policy)


@pytest.mark.parametrize("which", ["TLS_CERT_FILE", "TLS_KEY_FILE"])
def test_main_refuses_half_a_tls_pair(no_cluster, monkeypatch, which):
    monkeypatch.setenv(which, "/nonexistent")
    with pytest.raises(SystemExit) as exc:
        M.main()
    assert exc.value.code == 2


def test_module_runs_and_refuses_half_a_tls_pair():
    env = {**os.environ, "PYTHONPATH": REPO, "TLS_CERT_FILE": "/x"}
    env.pop("TLS_KEY_FILE", None)
    proc = subprocess.run([sys.executable, "-m", "tpushare_torch.cmd.main"],
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 2, proc.stderr[-2000:]
    assert "TLS misconfigured" in proc.stderr


def test_log_dir_holds_one_file_a_level(tmp_path):
    root = logging.getLogger()
    before = list(root.handlers)
    level = root.level
    try:
        for _ in range(2):  # a second call replaces, never duplicates
            M.configure_logging("warning", str(tmp_path))
        files = [h for h in root.handlers
                 if getattr(h, "_tpushare_level_file", False)]
        assert len(files) == 5
        log = logging.getLogger("tpushare_torch.test")
        log.debug("d")
        log.info("i")
        log.error("e")
        for h in files:
            h.flush()
        read = {name: (tmp_path / f"{name}.log").read_text()
                for name in ("debug", "info", "warning", "error",
                             "critical")}
        assert read["debug"].strip().endswith("d")
        assert read["info"].strip().endswith("i")
        assert read["error"].strip().endswith("e")
        assert read["warning"] == read["critical"] == ""
        assert "e" not in read["debug"].split(":")[-1]
    finally:
        for h in list(root.handlers):
            if h not in before:
                root.removeHandler(h)
                h.close()
        root.setLevel(level)
