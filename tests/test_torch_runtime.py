"""The port's tenant runtime against ``tpushare.runtime.jaxenv``, and the
package-wide rule that the port imports neither JAX nor the JAX
package."""

import ast
import json
import os
import types

import pytest
import torch

from tpushare.deviceplugin.watchdog import GrantWatchdog
from tpushare.runtime import jaxenv
from tpushare.utils import const as jconst
from tpushare_torch.runtime import torchenv
from tpushare_torch.utils import const

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GRANT_ENVS = [
    {},
    {"TPUSHARE_CHIP_IDX": "0", "TPUSHARE_HBM_POD_GIB": "16",
     "TPUSHARE_HBM_CHIP_GIB": "80"},
    {"TPUSHARE_CHIP_IDX": "1,3", "TPUSHARE_HBM_POD_GIB": "160",
     "TPUSHARE_HBM_CHIP_GIB": "80"},
    {"TPUSHARE_CHIP_IDX": "2", "TPUSHARE_HBM_POD_GIB": "80",
     "TPUSHARE_HBM_CHIP_GIB": "80"},
    {"TPUSHARE_CHIP_IDX": "0", "TPUSHARE_HBM_POD_GIB": "8"},
    {"TPUSHARE_CHIP_IDX": "x", "TPUSHARE_HBM_POD_GIB": "8"},
    {"TPUSHARE_CHIP_IDX": "", "TPUSHARE_HBM_POD_GIB": "4",
     "TPUSHARE_HBM_CHIP_GIB": "16"},
]


def test_env_names_are_the_contract():
    for name in ("ENV_CHIP_IDX", "ENV_HBM_POD", "ENV_HBM_CHIP",
                 "ENV_USAGE_FILE"):
        assert getattr(const, name) == getattr(jconst, name)


@pytest.mark.parametrize("env", GRANT_ENVS)
def test_read_grant_matches_jaxenv(env):
    want = jaxenv.read_grant(dict(env))
    got = torchenv.read_grant(dict(env))
    if want is None:
        assert got is None
        return
    assert (got.chip_ids, got.hbm_pod_gib, got.hbm_chip_gib) == (
        want.chip_ids, want.hbm_pod_gib, want.hbm_chip_gib)
    assert got.mem_fraction == want.mem_fraction
    assert got.whole_chips == want.whole_chips


@pytest.mark.parametrize("env", GRANT_ENVS)
def test_configure_matches_jaxenv(env):
    jenv, tenv = dict(env), dict(env)
    jaxenv.configure(jenv)
    torchenv.configure(tenv)
    assert (tenv.get("CUDA_VISIBLE_DEVICES")
            == jenv.get(jconst.ENV_TPU_VISIBLE_CHIPS))
    # The allocator cap is the fraction the JAX tenant puts in its env.
    frac = torchenv.memory_fraction(torchenv.read_grant(tenv))
    want = jenv.get(jconst.ENV_XLA_MEM_FRACTION)
    assert frac == (None if want is None else float(want))
    # configure only sets env: no other key appears.
    assert set(tenv) - set(env) <= {"CUDA_VISIBLE_DEVICES"}


def test_configure_keeps_a_preset_visible_devices():
    env = {"TPUSHARE_CHIP_IDX": "3", "CUDA_VISIBLE_DEVICES": "0"}
    torchenv.configure(env)
    assert env["CUDA_VISIBLE_DEVICES"] == "0"


def test_no_card_no_heartbeat(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert torchenv.usage_snapshot() is None
    path = tmp_path / "usage.json"
    assert torchenv.write_usage(str(path)) is None
    assert not path.exists()
    assert torchenv.apply_memory_fraction(None) is None
    assert torchenv.start_usage_reporter(environ={}) is None


def test_heartbeat_is_read_by_the_watchdog(tmp_path, monkeypatch):
    """On a (simulated) two-card host the heartbeat sums both cards'
    allocator counters into the keys the unchanged watchdog reads."""
    stats = [{"reserved_bytes.all.current": 3 << 30,
              "reserved_bytes.all.peak": 5 << 30},
             {"reserved_bytes.all.current": 1 << 30,
              "reserved_bytes.all.peak": 1 << 30}]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: stats[i])
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: types.SimpleNamespace(
                            total_memory=80 << 30))
    wd = GrantWatchdog("node-a", client=None, usage_dir=str(tmp_path))
    path = wd.usage_path("pod-uid")
    env = {const.ENV_USAGE_FILE: path}
    snap = torchenv.write_usage(environ=env)
    with open(path, encoding="utf-8") as f:
        on_disk = json.load(f)
    assert set(on_disk) == {"bytes_in_use", "peak_bytes", "bytes_limit",
                            "source", "ts", "pid"}
    assert on_disk == snap
    assert on_disk["bytes_in_use"] == 4 << 30
    assert on_disk["peak_bytes"] == 6 << 30
    assert on_disk["bytes_limit"] == 160 << 30
    assert on_disk["source"] == "memory_stats"
    read = wd._read_heartbeat("pod-uid")
    assert read["bytes_in_use"] == 4 << 30
    assert read["peak_bytes"] == 6 << 30


def _port_files():
    root = os.path.join(REPO, "tpushare_torch")
    for dirpath, _, names in os.walk(root):
        for name in names:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(REPO, "chip_smoke.py")


def _imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = list(_port_files())
    assert len(files) > 10
    assert os.path.join(REPO, "tpushare_torch", "workload", "train.py") in files
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "tpushare"), (path, mod)
