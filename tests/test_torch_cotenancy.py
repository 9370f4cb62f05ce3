"""``cogpucheck.py`` (the port's co-tenancy check) against
``cochipcheck.py``, on the CPU: the injected grant env, the tenant
bodies' result keys, the ``ok`` gates, the refusal without a card, and
the unchanged grant watchdog reading heartbeats written by
``torchenv.write_usage``."""

import ast
import copy
import os
import queue
import subprocess
import sys
import tempfile
import threading
import time
import types

import pytest
import torch

import cochipcheck
import cogpucheck
from tpushare.deviceplugin.watchdog import (GIB, GrantWatchdog,
                                            REASON_OVERRUN, REASON_STARVED)
from tpushare.k8s import events as k8s_events
from tpushare.k8s.builders import make_node, make_pod
from tpushare.k8s.fake import FakeApiServer
from tpushare.utils import const as jconst
from tpushare_torch.deviceplugin import discovery
from tpushare_torch.runtime import torchenv
from tpushare_torch.utils import const
from tpushare_torch.workload import model as M

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD_GIB = 79
GRANT_KEYS = (const.ENV_CHIP_IDX, const.ENV_HBM_POD, const.ENV_HBM_CHIP)


@pytest.mark.parametrize("grant,card", [(7, 16), (4, 79), (34, 79),
                                        (79, 79), (6.5, 80)])
def test_tenant_env_matches_cochipcheck(grant, card):
    want = cochipcheck._tenant_env(grant, card)
    got = cogpucheck._tenant_env(grant, card)
    assert {k: got[k] for k in GRANT_KEYS} == {k: want[k]
                                                for k in GRANT_KEYS}
    assert got["PYTHONPATH"].split(os.pathsep)[0] == REPO
    # The parsed grant is the one the JAX tenant would read.
    grant_t = torchenv.read_grant(got)
    assert (grant_t.chip_ids, grant_t.hbm_pod_gib, grant_t.hbm_chip_gib) == (
        (0,), int(grant), card)


def _return_keys(fn_name):
    """The string keys of every dict literal ``fn_name`` returns in
    cochipcheck.py (each tenant body returns one JSON-able dict)."""
    with open(os.path.join(REPO, "cochipcheck.py"), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
            keys |= {k.value for k in node.value.keys
                     if isinstance(k, ast.Constant)}
    assert keys, fn_name
    return keys


@pytest.fixture
def granted(monkeypatch):
    """The env a 7/16 grant of a 79 GiB card injects, restored after."""
    env = cogpucheck._tenant_env(CARD_GIB * 7 // 16, CARD_GIB)
    for key in GRANT_KEYS:
        monkeypatch.setenv(key, env[key])
    # Set, then removed, so that configure()'s setdefault is undone after.
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    monkeypatch.delenv(const.ENV_USAGE_FILE, raising=False)
    released = threading.Event()
    released.set()
    return released


def test_train_tenant_body_in_process(granted):
    r = cogpucheck.tenant_train(0.0, granted, cfg=M.ModelConfig().tiny(),
                                device="cpu")
    assert _return_keys("tenant_train") <= set(r)
    assert r["tenant"] == "train" and r["grant_gib"] == CARD_GIB * 7 // 16
    assert r["steps"] >= 1 and r["loss_finite"] is True
    assert r["mem_fraction_env"] == torchenv.memory_fraction(
        torchenv.read_grant())
    # On the CPU the wrappers take their plain versions: no launch.
    assert r["launches"] == {"flash_fwd": 0, "flash_bwd_dq": 0,
                             "flash_bwd_dkv": 0}
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "0"   # configure() ran


def test_decode_tenant_body_in_process(granted):
    cfg = M.ModelConfig().tiny()
    r = cogpucheck.tenant_decode(0.0, granted, cfg=cfg, device="cpu")
    assert _return_keys("tenant_decode") <= set(r)
    assert r["tenant"] == "decode" and r["tokens_in_vocab"] is True
    assert r["batch"] == min(r["max_batch_for_grant"], 64) == 64
    assert r["generates"] >= 1 and r["n_layers"] == cfg.n_layers
    assert r["launches"]["flash_fwd"] == 0


def test_tenant_without_a_grant_refuses(monkeypatch):
    for key in GRANT_KEYS:
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="injected grant env"):
        cogpucheck.tenant_train(0.0, threading.Event(), device="cpu")


@pytest.mark.parametrize("visible,want", [(None, 79), ("0", 79),
                                          ("1", 22), ("1,0", 22)])
def test_card_gib_counts_cuda_ordinals_in_discovery_order(monkeypatch,
                                                          visible, want):
    """CUDA card 0 of a container that shows /dev/nvidia5 and
    /dev/nvidia7 is nvidia5, whatever the nodes' numbers."""
    inv = discovery.HostInventory("", "", source="devfs", chips=(
        discovery.ChipSpec(5, 79, "/dev/nvidia5", "h100-80gb"),
        discovery.ChipSpec(7, 22, "/dev/nvidia7", "l4")))
    monkeypatch.setattr(discovery, "discover_host", lambda environ: inv)
    env = {} if visible is None else {"CUDA_VISIBLE_DEVICES": visible}
    assert cogpucheck.card_gib(env)[1] == want


def test_card_gib_refuses_what_discovery_cannot_size(monkeypatch):
    monkeypatch.setattr(discovery, "discover_host", lambda environ: None)
    with pytest.raises(RuntimeError, match="no NVIDIA card"):
        cogpucheck.card_gib({})
    inv = discovery.HostInventory("", "", chips=(
        discovery.ChipSpec(0, 0, "/dev/nvidia0"),))
    monkeypatch.setattr(discovery, "discover_host", lambda environ: inv)
    for env in ({}, {"CUDA_VISIBLE_DEVICES": "3"}):
        with pytest.raises(RuntimeError, match="cannot size card"):
            cogpucheck.card_gib(env)


def _passing_report():
    return {
        "concurrent": {"both_tenants_ok": True,
                       "running_when_overcommit_died": True,
                       "overcommit_clean": True},
        "estimator": {"prediction_fits": True, "overshoot_refused": True},
        "isolation": {"exactly_one_refused": True},
        "heartbeats": {"hog_over_grant": True,
                       "innocent_within_grant": True},
    }


GATE_FIELDS = [("concurrent", "both_tenants_ok"),
               ("concurrent", "running_when_overcommit_died"),
               ("concurrent", "overcommit_clean"),
               ("estimator", "prediction_fits"),
               ("estimator", "overshoot_refused"),
               ("isolation", "exactly_one_refused"),
               ("heartbeats", "hog_over_grant"),
               ("heartbeats", "innocent_within_grant")]


def test_gates_pass_on_a_passing_report():
    g = cogpucheck.gates(_passing_report())
    assert set(g) == {field for _, field in GATE_FIELDS}
    assert all(g.values())


@pytest.mark.parametrize("section,field", GATE_FIELDS)
def test_each_gate_fails_the_report(section, field):
    report = copy.deepcopy(_passing_report())
    report[section][field] = False
    g = cogpucheck.gates(report)
    assert not all(g.values()) and g[field] is False


OOM = "OutOfMemoryError: CUDA out of memory. Tried to allocate 95.00 GiB."


@pytest.mark.parametrize("result,refused", [
    ({"outcome": "refused", "error": OOM}, True),
    ({"outcome": "refused", "error": "RuntimeError: CUDA error"}, False),
    ({"outcome": "ALLOCATED"}, False),
    ({"outcome": "NO_OUTPUT", "exit_code": 1}, False),
    ({"outcome": "TIMEOUT"}, False),
])
def test_only_out_of_memory_counts_as_refused(result, refused):
    assert cogpucheck._refused_oom(result) is refused


def test_wait_ready_and_collect(tmp_path):
    """The READY hand-off and the JSON line of a tenant process, through
    _wait_ready and _collect (a stand-in tenant script)."""
    script = tmp_path / "tenant.py"
    script.write_text(
        "import json, sys\n"
        "print('READY', flush=True)\n"
        "sys.stdin.read()\n"
        "print(json.dumps({'tenant': 'x', 'outcome': 'held'}))\n")
    err = tempfile.TemporaryFile(mode="w+", encoding="utf-8")
    proc = subprocess.Popen([sys.executable, str(script)],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=err, text=True)
    t = cogpucheck._Tenant("x", proc, queue.Queue(), err)
    threading.Thread(target=cogpucheck._pump, args=(proc.stdout, t.lines),
                     daemon=True).start()
    assert cogpucheck._wait_ready(t, 60)
    assert proc.poll() is None         # holds until released
    assert cogpucheck._collect(t, 60) == {"tenant": "x", "outcome": "held",
                                          "exit_code": 0}


def test_smoke_without_a_card_exits_nonzero_with_no_report(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = tmp_path / "COTENANCY_gpu.json"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "cogpucheck.py"), "--smoke",
         "--out", str(out)],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert proc.returncode == 2
    assert "no CUDA device" in proc.stderr
    assert proc.stdout == "" and not out.exists()


def _torch_heartbeat(monkeypatch, path, gib):
    """One heartbeat from torchenv.write_usage, the allocator's counters
    faked at ``gib`` reserved on one 79 GiB card."""
    stats = {"reserved_bytes.all.current": int(gib * GIB),
             "reserved_bytes.all.peak": int(gib * GIB)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: stats)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: types.SimpleNamespace(
                            total_memory=81559 << 20))
    snap = torchenv.write_usage(environ={const.ENV_USAGE_FILE: path})
    assert snap["bytes_in_use"] == int(gib * GIB)


def test_unchanged_watchdog_names_the_torch_hog(monkeypatch, tmp_path):
    """The heartbeats of cogpucheck's last phase (hog: 10 GiB under a 4
    GiB grant; innocent: 6 under 7), written by torchenv, read by the
    JAX package's GrantWatchdog as cochipcheck's phase 6 reads its
    tenants'."""
    usage = str(tmp_path)
    wd_paths = GrantWatchdog("host-a", None, usage_dir=usage)
    _torch_heartbeat(monkeypatch, wd_paths.usage_path("uid-hog"), 10)
    _torch_heartbeat(monkeypatch, wd_paths.usage_path("uid-innocent"), 6)
    api = FakeApiServer()
    api.create_node(make_node("host-a", chips=1, hbm_per_chip=CARD_GIB))
    for name, uid, hbm in (("hog", "uid-hog", 4),
                           ("innocent", "uid-innocent", 7)):
        api.create_pod(make_pod(
            name, hbm=hbm, node_name="host-a", uid=uid, phase="Running",
            annotations={jconst.ANN_CHIP_IDX: "0",
                         jconst.ANN_HBM_POD: str(hbm),
                         jconst.ANN_HBM_CHIP: str(CARD_GIB),
                         jconst.ANN_ASSIGNED: jconst.ASSIGNED_TRUE,
                         jconst.ANN_ASSUME_TIME: str(time.time_ns())}))
    wd = GrantWatchdog("host-a", api, usage_dir=usage)
    doc = wd.sweep()
    k8s_events.flush(timeout=10)
    ev = [(e["involvedObject"]["name"], e["reason"], e["message"])
          for _, e in api.events]
    assert [o["pod"] for o in doc["overruns"]] == ["hog"]
    used = {t["pod"]: t["used_gib"] for t in doc["tenants"]}
    assert used == {"hog": 10.0, "innocent": 6.0}
    assert any(name == "innocent" and reason == REASON_STARVED
               and "hog" in msg for name, reason, msg in ev)
    assert any(name == "hog" and reason == REASON_OVERRUN
               for name, reason, _ in ev)
