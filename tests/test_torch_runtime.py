"""The port's tenant runtime against ``tpushare.runtime.jaxenv``, and the
package-wide rule that the port imports neither JAX nor the JAX
package."""

import ast
import json
import os
import types

import pytest
import torch

from tpushare.deviceplugin.watchdog import GrantWatchdog as JaxWatchdog
from tpushare.runtime import jaxenv
from tpushare.utils import const as jconst
from tpushare_torch.deviceplugin.watchdog import GrantWatchdog
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
                 "ENV_USAGE_FILE", "ENV_POD_GROUP", "ENV_POD_GROUP_SIZE",
                 "ENV_COORDINATOR"):
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
    allocator counters into the keys the port's watchdog reads, as the
    JAX package's watchdog reads them too."""
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
    ref = JaxWatchdog("node-a", client=None, usage_dir=str(tmp_path))
    assert ref.usage_path("pod-uid") == path
    assert ref._read_heartbeat("pod-uid") == read


def _port_files():
    root = os.path.join(REPO, "tpushare_torch")
    for dirpath, _, names in os.walk(root):
        for name in names:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "cogpucheck.py")
    yield os.path.join(REPO, "bench_workload_torch.py")
    yield os.path.join(REPO, "tools", "estimator_peak.py")
    yield os.path.join(REPO, "tools", "gloo_cuda_probe.py")
    yield os.path.join(REPO, "tools", "nccl_gang.py")
    yield os.path.join(REPO, "tools", "ring_model_fit.py")
    yield os.path.join(REPO, "tools", "extender_phases.py")
    yield os.path.join(REPO, "tests", "torch_parallel_rank.py")
    yield os.path.join(REPO, "tests", "torch_pipeline_rank.py")
    yield os.path.join(REPO, "tests", "torch_checkpoint_rank.py")
    yield os.path.join(REPO, "tests", "torch_serving_tp_rank.py")
    yield os.path.join(REPO, "tests", "torch_extender_daemon_side.py")


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
    for name in (("tpushare_torch", "workload", "train.py"),
                 ("tpushare_torch", "workload", "pipeline.py"),
                 ("tpushare_torch", "workload", "moe.py"),
                 ("tpushare_torch", "workload", "checkpoint.py"),
                 ("tpushare_torch", "deviceplugin", "discovery.py"),
                 ("tpushare_torch", "deviceplugin", "plugin.py"),
                 ("tpushare_torch", "deviceplugin", "kubelet.py"),
                 ("tpushare_torch", "deviceplugin", "watchdog.py"),
                 ("tpushare_torch", "k8s", "client.py"),
                 ("tpushare_torch", "k8s", "fake.py"),
                 ("tpushare_torch", "api", "objects.py"),
                 ("tpushare_torch", "cmd", "deviceplugin_main.py"),
                 ("tpushare_torch", "workload", "parallel.py"),
                 ("tpushare_torch", "api", "extender.py"),
                 ("tpushare_torch", "topology", "topology.py"),
                 ("tpushare_torch", "cache", "chipinfo.py"),
                 ("tpushare_torch", "cache", "nodeinfo.py"),
                 ("tpushare_torch", "cache", "cache.py"),
                 ("tpushare_torch", "k8s", "informer.py"),
                 ("tpushare_torch", "k8s", "workqueue.py"),
                 ("tpushare_torch", "k8s", "builders.py"),
                 ("tpushare_torch", "controller", "controller.py"),
                 ("tpushare_torch", "scheduler", "predicate.py"),
                 ("tpushare_torch", "scheduler", "prioritize.py"),
                 ("tpushare_torch", "scheduler", "bind.py"),
                 ("tpushare_torch", "scheduler", "inspect.py"),
                 ("tpushare_torch", "routes", "wire.py"),
                 ("tpushare_torch", "routes", "batch.py"),
                 ("tpushare_torch", "routes", "server.py"),
                 ("tpushare_torch", "cmd", "main.py"),
                 ("tpushare_torch", "utils", "node.py"),
                 ("tpushare_torch", "topology", "fleet.py"),
                 ("tpushare_torch", "gang", "planner.py"),
                 ("tpushare_torch", "trace", "__init__.py"),
                 ("tpushare_torch", "trace", "recorder.py"),
                 ("tpushare_torch", "trace", "jsonlog.py"),
                 ("tpushare_torch", "routes", "metrics.py"),
                 ("tpushare_torch", "routes", "exposition.py"),
                 *(("tpushare_torch", "obs", f"{name}.py") for name in (
                     "__init__", "timeline", "sources", "anomaly",
                     "exemplars", "blackbox", "export", "witness")),
                 ("tpushare_torch", "utils", "locks.py"),
                 ("tpushare_torch", "routes", "pprof.py"),
                 *(("tpushare_torch", "profiling", f"{name}.py") for name in (
                     "__init__", "ledger", "decisions", "sampler")),
                 *(("tpushare_torch", "slo", f"{name}.py") for name in (
                     "__init__", "config", "journey", "engine")),
                 *(("tpushare_torch", "defrag", f"{name}.py") for name in (
                     "__init__", "frag", "planner", "executor")),
                 ("tools", "extender_phases.py"),
                 ("chip_smoke.py",),
                 ("tools", "ring_model_fit.py"),
                 ("cogpucheck.py",), ("bench_workload_torch.py",)):
        assert os.path.join(REPO, *name) in files
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "orbax", "tpushare",
                               "bench_workload"), (path, mod)


#: The port's raw ``threading`` locks, each its own with no twin in the
#: reference: the exposition's stand-in for ``prometheus_client``'s locks,
#: the native discovery shim's load and the kernel library's load. Every
#: other lock of the port is a ``TracingRLock`` (``utils/locks.py`` keeps
#: its own two internals, as the reference's does).
RAW_LOCKS = {
    ("tpushare_torch/routes/exposition.py", "_lock"): 2,
    ("tpushare_torch/deviceplugin/discovery.py", "_native_lock"): 1,
    ("tpushare_torch/workload/flash_attention.py", "_lib_lock"): 1,
}


def _package_files(root: str):
    for dirpath, _, names in os.walk(os.path.join(REPO, root)):
        for name in sorted(names):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def _raw_locks(path: str) -> list[str]:
    """The targets of ``threading.Lock()`` / ``threading.RLock()`` calls
    in ``path``."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        value = node.value
        if (isinstance(value, ast.Call)
                and isinstance(value.func, ast.Attribute)
                and value.func.attr in ("Lock", "RLock")
                and isinstance(value.func.value, ast.Name)
                and value.func.value.id == "threading"):
            target = node.targets[0] if isinstance(node, ast.Assign) \
                else node.target
            out.append(ast.unparse(target).split(".")[-1])
    return out


def test_no_raw_lock_but_the_port_s_own():
    found: dict = {}
    for path in _package_files("tpushare_torch"):
        rel = os.path.relpath(path, REPO)
        if rel == os.path.join("tpushare_torch", "utils", "locks.py"):
            # its two internals, declared as the reference declares them,
            # and the RLock inside TracingRLock
            assert sorted(_raw_locks(path)) == [
                "_lock", "_race_lock", "_registry_lock"]
            continue
        for name in _raw_locks(path):
            found[(rel, name)] = found.get((rel, name), 0) + 1
    assert found == RAW_LOCKS


def _lock_sites(path: str) -> list[tuple[str, str]]:
    """Each ``TracingRLock(...)``, ``guarded_dict(...)`` and
    ``guarded_set(...)`` call in ``path``: (callee, its site or name
    argument as written)."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    out = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("TracingRLock", "guarded_dict",
                                       "guarded_set")):
            arg = node.args[0 if node.func.attr == "TracingRLock" else 1]
            out.append((node.func.attr, ast.unparse(arg)))
    return sorted(out)


def test_every_traced_lock_takes_the_reference_s_site():
    """Module by module, the port's ``TracingRLock`` sites and guarded
    containers' names are its reference twin's, as written (an f-string
    site such as ``node/{self.name}`` included): the router's
    ``router/state`` and the autoscaler's ``autoscale/executor`` among
    them. A module of the port with no twin takes no lock site."""
    compared = 0
    for path in _package_files("tpushare_torch"):
        rel = os.path.relpath(path, os.path.join(REPO, "tpushare_torch"))
        twin = os.path.join(REPO, "tpushare", rel)
        sites = _lock_sites(path)
        if not os.path.exists(twin):
            assert not sites, rel
            continue
        assert sites == _lock_sites(twin), rel
        compared += len(sites)
    assert compared >= 50


GANG = {const.ENV_POD_GROUP: "train", const.ENV_POD_GROUP_SIZE: "4"}
SPEC_ENVS = [
    {},
    {"JOB_COMPLETION_INDEX": "0"},
    {**GANG, "JOB_COMPLETION_INDEX": "2"},
    {**GANG, "TPU_WORKER_ID": "3"},
    {**GANG, "JOB_COMPLETION_INDEX": "1", "TPU_WORKER_ID": "3"},
    {**GANG, "JOB_COMPLETION_INDEX": "2",
     const.ENV_COORDINATOR: "coord:9999"},
    {**GANG},
    {**GANG, "JOB_COMPLETION_INDEX": "x"},
    {**GANG, const.ENV_POD_GROUP_SIZE: "1", "JOB_COMPLETION_INDEX": "0"},
    {**GANG, const.ENV_POD_GROUP_SIZE: "y", "JOB_COMPLETION_INDEX": "0"},
    {const.ENV_POD_GROUP_SIZE: "4", "JOB_COMPLETION_INDEX": "0"},
]


@pytest.mark.parametrize("env", SPEC_ENVS)
def test_distributed_spec_matches_jaxenv(env):
    want = jaxenv.distributed_spec(dict(env))
    got = torchenv.distributed_spec(dict(env))
    if want is None:
        assert got is None
        return
    assert (got.coordinator, got.num_processes, got.process_id) == (
        want.coordinator, want.num_processes, want.process_id)


def test_distributed_spec_cases_of_the_device_plugin_tests():
    """tests/test_deviceplugin.py's gang cases through the port's copy."""
    env = {**GANG, "JOB_COMPLETION_INDEX": "2"}
    spec = torchenv.distributed_spec(env)
    assert spec.num_processes == 4 and spec.process_id == 2
    assert spec.coordinator == "train-0.train:8476"
    env[const.ENV_COORDINATOR] = "coord:9999"
    assert torchenv.distributed_spec(env).coordinator == "coord:9999"
    assert torchenv.distributed_spec({"JOB_COMPLETION_INDEX": "0"}) is None
    bad = {const.ENV_POD_GROUP: "g", const.ENV_POD_GROUP_SIZE: "4",
           "JOB_COMPLETION_INDEX": "5"}
    with pytest.raises(ValueError, match="out of range"):
        torchenv.distributed_spec(bad)
    with pytest.raises(ValueError, match="out of range"):
        jaxenv.distributed_spec(bad)


def test_init_distributed_outside_a_gang_does_nothing():
    assert torchenv.init_distributed({}, device="cpu") is None
    assert not torch.distributed.is_initialized()


@pytest.fixture
def one_card(monkeypatch):
    """A host that shows one card; joining a process group is refused
    here, so a test that got that far fails."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: None)

    def refuse(*args, **kw):
        raise AssertionError(f"init_process_group{args}{kw}")
    monkeypatch.setattr(torch.distributed, "init_process_group", refuse)


@pytest.mark.parametrize("backend", [None, "nccl"])
def test_init_distributed_refuses_nccl_ranks_on_one_card(one_card, backend):
    env = {**GANG, "JOB_COMPLETION_INDEX": "1", "LOCAL_RANK": "1",
           "LOCAL_WORLD_SIZE": "4"}
    with pytest.raises(ValueError, match="NCCL"):
        torchenv.init_distributed(env, backend=backend)


def test_init_distributed_wants_gloo_under_an_hbm_slice(one_card):
    """One rank a host, but an HBM-slice grant: the card may hold other
    ranks of the gang, so no backend is picked for the caller."""
    env = {**GANG, "JOB_COMPLETION_INDEX": "1", "TPUSHARE_CHIP_IDX": "0",
           "TPUSHARE_HBM_POD_GIB": "19", "TPUSHARE_HBM_CHIP_GIB": "79"}
    with pytest.raises(ValueError, match="backend='gloo'"):
        torchenv.init_distributed(env)


def test_init_distributed_takes_nccl_for_a_card_of_its_own(one_card):
    env = {**GANG, "JOB_COMPLETION_INDEX": "1", "TPUSHARE_CHIP_IDX": "0",
           "TPUSHARE_HBM_POD_GIB": "79", "TPUSHARE_HBM_CHIP_GIB": "79"}
    with pytest.raises(AssertionError, match="'nccl'.*tcp://train-0"):
        torchenv.init_distributed(env)


def test_init_distributed_runs_only_gloo_on_the_cpu():
    env = {**GANG, "JOB_COMPLETION_INDEX": "1"}
    with pytest.raises(ValueError, match="only gloo"):
        torchenv.init_distributed(env, backend="nccl", device="cpu")
