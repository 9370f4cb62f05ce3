"""The port's grant watchdog (``tpushare_torch/deviceplugin/watchdog.py``)
against the JAX package's, scenario by scenario.

Every scenario of ``tests/test_watchdog.py`` is one case: it runs once on
the JAX ``GrantWatchdog`` over the JAX ``FakeApiServer`` and once on the
port's over the port's fake, with the same pods (``tpushare.k8s.builders``)
and the same heartbeats, makes that test's checks on each side and
records the sweep documents, the events (reason, involved pod, type),
every pod's annotations, the overrun streaks and the exposition's sample
lines: the JAX side's ``prometheus_client.generate_latest``, the port's
own rendering. The two records must be equal.
"""

from __future__ import annotations

import json
import time

import pytest
import torch
from prometheus_client import generate_latest

from tests.torch_daemon_sides import (
    JAX, NODE, SIDES, TORCH, event_view, pods_state)
from tpushare.k8s.builders import make_node, make_pod
from tpushare_torch.runtime import torchenv
from tpushare_torch.utils import const

GIB = 1 << 30


def tenant(name, hbm, chip_ids, uid=None, phase="Running", labels=None):
    """An assigned HBM-slice tenant resident on the node."""
    return make_pod(
        name, hbm=hbm, node_name=NODE, phase=phase, uid=uid or f"uid-{name}",
        labels=labels, annotations={
            const.ANN_CHIP_IDX: ",".join(str(c) for c in chip_ids),
            const.ANN_HBM_POD: str(hbm), const.ANN_HBM_CHIP: "16",
            const.ANN_ASSIGNED: const.ASSIGNED_TRUE,
            const.ANN_ASSUME_TIME: "1790000000000000000"})


PDB = {"metadata": {"name": "hog-pdb", "namespace": "default"},
       "spec": {"selector": {"matchLabels": {"app": "protected"}}},
       "status": {"disruptionsAllowed": 0}}


class Run:
    """One side's run: its apiserver, heartbeat directory, clock and the
    record of what it observed."""

    def __init__(self, side, root):
        self.s = side
        self.api = side.Fake()
        self.usage = root
        self.clock = [time.time()]
        self.obs: list = []

    def note(self, key, value) -> None:
        self.obs.append((key, value))

    def beat(self, uid, gib, peak_gib=None, age=0.0) -> None:
        doc = {"bytes_in_use": int(gib * GIB),
               "peak_bytes": int((gib if peak_gib is None else peak_gib)
                                 * GIB),
               "ts": self.clock[0] - age}
        (self.usage / uid).mkdir(exist_ok=True)
        (self.usage / uid / "usage.json").write_text(json.dumps(doc))

    def watchdog(self, client=None, **kw):
        kw.setdefault("now", lambda: self.clock[0])
        return self.s.watchdog(client or self.api, str(self.usage), **kw)

    def sweep(self, wd) -> dict:
        doc = wd.sweep()
        self.note("sweep", doc)
        self.note("samples", samples(self.s, wd))
        self.note("streak", dict(wd._over_streak))
        return doc

    def events(self) -> list:
        assert self.s.events.flush()
        return event_view(self.api)

    def reasons(self, name) -> list[str]:
        return [reason for reason, pod, _ in self.events() if pod == name]

    def gauge(self, wd, name, pod):
        return self.s.gauge(wd, name, pod)

    def ann(self, name) -> dict:
        return self.api.get_pod("default", name).annotations

    def finish(self) -> list:
        self.note("events", self.events())
        self.note("pods", pods_state(self.api))
        return self.obs


def exposition(side, wd) -> str:
    return (generate_latest(wd.registry) if side is JAX
            else wd.render()).decode()


def samples(side, wd) -> list[str]:
    """The exposition's sample lines."""
    return [ln for ln in exposition(side, wd).splitlines()
            if ln and not ln.startswith("#")]


# --------------------------------------------------------------------------
# Scenarios: tests/test_watchdog.py, one function each
# --------------------------------------------------------------------------

def within_grant_publishes_gauges_and_annotation(r):
    r.api.create_pod(tenant("good", 8, [0]))
    r.beat("uid-good", 5.0)
    wd = r.watchdog()
    doc = r.sweep(wd)
    assert doc["overruns"] == []
    [t] = doc["tenants"]
    assert t["used_gib"] == 5.0 and t["granted_gib"] == 8
    assert not t["overrun"]
    assert r.gauge(wd, "tpushare_hbm_used_gib", "good") == 5.0
    assert r.gauge(wd, "tpushare_grant_overrun", "good") == 0
    assert r.ann("good")[const.ANN_HBM_USED] == "5.0"
    assert const.ANN_OVERRUN not in r.ann("good")
    assert r.reasons("good") == []


def overrunner_named_and_innocent_attributed(r):
    r.api.create_pod(tenant("hog", 4, [0]))
    r.api.create_pod(tenant("innocent", 7, [0]))
    r.api.create_pod(tenant("elsewhere", 7, [1]))
    r.beat("uid-hog", 10.0, peak_gib=11.0)
    r.beat("uid-innocent", 6.0)
    r.beat("uid-elsewhere", 6.0)
    wd = r.watchdog()
    doc = r.sweep(wd)
    [over] = doc["overruns"]
    assert over["pod"] == "hog" and over["used_gib"] == 10.0
    assert r.gauge(wd, "tpushare_grant_overrun", "hog") == 1
    assert r.reasons("hog") == [r.s.wd.REASON_OVERRUN]
    events = [e for _, e in r.api.events]
    hog_ev = [e for e in events if e["reason"] == r.s.wd.REASON_OVERRUN][0]
    assert "10.0" in hog_ev["message"] and "4 GiB" in hog_ev["message"]
    assert hog_ev["type"] == "Warning"
    assert r.reasons("innocent") == [r.s.wd.REASON_STARVED]
    starved = [e for e in events if e["reason"] == r.s.wd.REASON_STARVED][0]
    assert "default/hog" in starved["message"]
    assert r.reasons("elsewhere") == []
    assert r.ann("hog")[const.ANN_OVERRUN] == const.ASSIGNED_TRUE


def overrun_event_fires_on_edge_only(r):
    r.api.create_pod(tenant("hog", 4, [0]))
    r.beat("uid-hog", 10.0)
    wd = r.watchdog()
    r.sweep(wd)
    r.sweep(wd)
    assert r.reasons("hog") == [r.s.wd.REASON_OVERRUN]
    r.beat("uid-hog", 3.0)
    r.sweep(wd)
    assert const.ANN_OVERRUN not in r.ann("hog")
    r.beat("uid-hog", 9.0)
    r.sweep(wd)
    assert r.reasons("hog") == [r.s.wd.REASON_OVERRUN] * 2


def stale_heartbeat_is_no_data(r):
    r.api.create_pod(tenant("gone", 4, [0]))
    r.beat("uid-gone", 10.0, age=600)
    wd = r.watchdog()
    doc = r.sweep(wd)
    assert doc["overruns"] == []
    [t] = doc["tenants"]
    assert t["used_gib"] is None
    assert r.gauge(wd, "tpushare_hbm_used_gib", "gone") is None


def stale_heartbeat_clears_stale_annotations(r):
    r.api.create_pod(tenant("hog", 4, [0]))
    r.beat("uid-hog", 10.0)
    wd = r.watchdog(stale_after=0.5)
    r.sweep(wd)
    assert r.ann("hog")[const.ANN_OVERRUN] == const.ASSIGNED_TRUE
    r.clock[0] += 0.6  # the heartbeat goes stale
    r.sweep(wd)
    assert const.ANN_OVERRUN not in r.ann("hog")
    assert const.ANN_HBM_USED not in r.ann("hog")


def opt_in_eviction_after_consecutive_sweeps(r):
    r.api.create_pod(tenant("hog", 4, [0]))
    r.beat("uid-hog", 10.0)
    wd = r.watchdog(evict_after=3)
    r.sweep(wd)
    r.sweep(wd)
    assert r.api.get_pod("default", "hog") is not None
    r.beat("uid-hog", 3.0)
    r.sweep(wd)
    r.beat("uid-hog", 10.0)
    for _ in range(3):
        doc = r.sweep(wd)
    assert doc["evicted"] == ["uid-hog"]
    assert r.s.wd.REASON_EVICTED in r.reasons("hog")
    with pytest.raises(r.s.errors.NotFoundError):
        r.api.get_pod("default", "hog")


def over_streak_pruned_for_vanished_pods(r):
    wd = r.watchdog(evict_after=5)
    for name in ("churn-a", "churn-b"):
        r.api.create_pod(tenant(name, 4, [0]))
        r.beat(f"uid-{name}", 10.0)
    r.sweep(wd)
    assert set(wd._over_streak) == {"uid-churn-a", "uid-churn-b"}
    r.api.delete_pod("default", "churn-a")
    r.sweep(wd)
    assert set(wd._over_streak) == {"uid-churn-b"}
    wd0 = r.watchdog()
    r.sweep(wd0)
    assert set(wd0._over_streak) == {"uid-churn-b"}
    r.api.delete_pod("default", "churn-b")
    r.sweep(wd0)
    assert wd0._over_streak == {}


def _relax(r, pdb) -> None:
    """Give the budget one disruption."""
    raw = pdb.raw if r.s is JAX else pdb
    raw["status"]["disruptionsAllowed"] = 1
    r.api.update_pdb(pdb)


def eviction_honors_pdb(r):
    r.api.create_pod(tenant("hog", 4, [0], labels={"app": "protected"}))
    r.beat("uid-hog", 10.0)
    pdb = r.api.create_pdb(PDB)
    wd = r.watchdog(evict_after=2, evict_sleep=lambda s: None)
    r.sweep(wd)
    doc = r.sweep(wd)
    assert doc["evicted"] == []
    assert r.api.get_pod("default", "hog") is not None
    assert wd._over_streak["uid-hog"] >= 2
    _relax(r, pdb)
    doc = r.sweep(wd)
    assert doc["evicted"] == ["uid-hog"]
    assert r.s.wd.REASON_EVICTED in r.reasons("hog")


def retry_429_with_backoff_actually_reattempts(r):
    r.api.create_pod(tenant("hog", 4, [0], labels={"app": "protected"}))
    r.beat("uid-hog", 10.0)
    pdb = r.api.create_pdb(PDB)
    sleeps = []

    def relax_pdb_on_first_backoff(seconds):
        sleeps.append(seconds)
        if len(sleeps) == 1:
            _relax(r, pdb)

    wd = r.watchdog(evict_after=1, evict_sleep=relax_pdb_on_first_backoff)
    doc = r.sweep(wd)
    assert sleeps and sleeps[0] > 0
    assert doc["evicted"] == ["uid-hog"]
    with pytest.raises(r.s.errors.NotFoundError):
        r.api.get_pod("default", "hog")
    r.note("sleeps", sleeps)


def blocked_429_through_every_attempt_keeps_streak(r):
    r.api.create_pod(tenant("hog", 4, [0], labels={"app": "protected"}))
    r.beat("uid-hog", 10.0)
    r.api.create_pdb(PDB)
    sleeps = []
    wd = r.watchdog(evict_after=1, evict_sleep=sleeps.append)
    doc = r.sweep(wd)
    assert doc["evicted"] == []
    assert len(sleeps) == 2
    assert r.api.get_pod("default", "hog") is not None
    assert wd._over_streak["uid-hog"] >= 1
    r.note("sleeps", sleeps)


def eviction_falls_back_to_delete_without_rbac(r):
    api_error = r.s.errors.ApiError

    class NoEvictRbac:
        def __init__(self, inner):
            self._inner = inner

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def evict_pod(self, namespace, name):
            raise api_error(403, reason="Forbidden",
                            body="pods/eviction is forbidden")

    r.api.create_pod(tenant("hog", 4, [0]))
    r.beat("uid-hog", 10.0)
    wd = r.watchdog(client=NoEvictRbac(r.api), evict_after=2)
    r.sweep(wd)
    doc = r.sweep(wd)
    assert doc["evicted"] == ["uid-hog"]
    assert r.s.wd.REASON_EVICTED in r.reasons("hog")
    with pytest.raises(r.s.errors.NotFoundError):
        r.api.get_pod("default", "hog")


def default_policy_never_evicts(r):
    r.api.create_pod(tenant("hog", 4, [0]))
    r.beat("uid-hog", 10.0)
    wd = r.watchdog()
    for _ in range(10):
        doc = r.sweep(wd)
    assert doc["evicted"] == []
    assert r.api.get_pod("default", "hog") is not None


def series_gc_on_pod_removal(r):
    r.api.create_pod(tenant("brief", 8, [0]))
    r.beat("uid-brief", 5.0)
    wd = r.watchdog()
    r.sweep(wd)
    assert r.gauge(wd, "tpushare_hbm_used_gib", "brief") == 5.0
    r.api.delete_pod("default", "brief")
    r.sweep(wd)
    assert r.gauge(wd, "tpushare_hbm_used_gib", "brief") is None


def render_exposition_format(r):
    r.api.create_pod(tenant("good", 8, [0]))
    r.beat("uid-good", 5.0)
    wd = r.watchdog()
    r.sweep(wd)
    text = exposition(r.s, wd)
    assert "tpushare_hbm_used_gib" in text and 'pod="good"' in text


def inspect_surfaces_used_vs_granted(r):
    """The JAX extender's inspect reads what either watchdog wrote."""
    from tpushare.api.objects import Pod as JPod
    from tpushare.cache.cache import SchedulerCache
    from tpushare.k8s.fake import FakeApiServer
    from tpushare.scheduler.inspect import Inspect

    r.api.create_pod(tenant("hog", 4, [0]))
    r.beat("uid-hog", 10.0)
    r.sweep(r.watchdog())
    shared = FakeApiServer()
    shared.create_node(make_node(NODE))
    cache = SchedulerCache(shared.get_node, shared.list_pods)
    cache.add_or_update_pod(JPod(r.api.get_pod("default", "hog").raw))
    doc = Inspect(cache).handle(NODE)
    [entry] = [p for c in doc["nodes"][0]["chips"] for p in c["pods"]]
    assert entry["usedHBM"] == 4
    assert entry["reportedUsedHBM"] == "10.0"
    assert entry["overrun"] is True
    r.note("inspect", entry)


def allocate_injects_usage_contract(r):
    """Allocate hands the tenant its heartbeat path and the mount of its
    own directory, and the gRPC framing carries the mount."""
    if r.s is JAX:
        from tpushare.deviceplugin import kubelet
    else:
        from tpushare_torch.deviceplugin import kubelet
    r.api.create_node(make_node(NODE))
    devfs = r.usage / "devfs"
    devfs.mkdir()
    usage = r.usage / "alloc"
    plugin = r.s.plugin(r.api, r.s.inventory(), str(devfs),
                        usage_dir=str(usage))
    r.api.create_pod(make_pod(
        "slice", hbm=8, node_name=NODE, uid="uid-slice", annotations={
            const.ANN_CHIP_IDX: "0", const.ANN_HBM_POD: "8",
            const.ANN_HBM_CHIP: "16",
            const.ANN_ASSIGNED: const.ASSIGNED_FALSE,
            const.ANN_ASSUME_TIME: "1"}))
    alloc = plugin.allocate_hbm(["x"] * 8)
    pod_dir = usage / "uid-slice"
    assert alloc.envs[const.ENV_USAGE_FILE] == str(pod_dir / "usage.json")
    assert alloc.mounts == ((str(pod_dir), str(pod_dir), False),)
    assert pod_dir.is_dir()
    [m] = list(kubelet._to_pb_allocation(alloc).mounts)
    assert m.host_path == str(pod_dir) and not m.read_only
    r.note("mount", [m.host_path[len(str(r.usage)):], m.container_path[
        len(str(r.usage)):], m.read_only])


def usage_snapshot_refuses_without_a_card(r, monkeypatch):
    """A tenant with no accelerator reports nothing: host memory is not
    device memory, and heartbeating it could frame an innocent pod."""
    if r.s is JAX:
        from tpushare.runtime import jaxenv
        assert jaxenv.usage_snapshot() is None
    else:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert torchenv.usage_snapshot() is None


def runtime_write_usage(r, monkeypatch):
    """Tenant side: snapshot, then an atomic file the watchdog reads."""
    if r.s is JAX:
        from tpushare.runtime import jaxenv as runtime
    else:
        runtime = torchenv
    target = r.usage / "u" / "uid-x.json"
    monkeypatch.setattr(
        runtime, "usage_snapshot",
        lambda: {"bytes_in_use": 3 * GIB, "peak_bytes": 4 * GIB,
                 "ts": 1.0, "pid": 1})
    env = {const.ENV_USAGE_FILE: str(target)}
    assert runtime.write_usage(environ=env)["bytes_in_use"] == 3 * GIB
    on_disk = json.loads(target.read_text())
    assert on_disk["peak_bytes"] == 4 * GIB
    assert runtime.write_usage(environ={}) is None
    assert runtime.start_usage_reporter(environ={}) is None
    r.note("on_disk", on_disk)


SCENARIOS = [
    within_grant_publishes_gauges_and_annotation,
    overrunner_named_and_innocent_attributed,
    overrun_event_fires_on_edge_only,
    stale_heartbeat_is_no_data,
    stale_heartbeat_clears_stale_annotations,
    opt_in_eviction_after_consecutive_sweeps,
    over_streak_pruned_for_vanished_pods,
    eviction_honors_pdb,
    retry_429_with_backoff_actually_reattempts,
    blocked_429_through_every_attempt_keeps_streak,
    eviction_falls_back_to_delete_without_rbac,
    default_policy_never_evicts,
    series_gc_on_pod_removal,
    render_exposition_format,
    inspect_surfaces_used_vs_granted,
    allocate_injects_usage_contract,
    usage_snapshot_refuses_without_a_card,
    runtime_write_usage,
]
NEEDS_MONKEYPATCH = {usage_snapshot_refuses_without_a_card,
                     runtime_write_usage}


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_watchdog_matches_the_reference(scenario, tmp_path, monkeypatch):
    records = []
    for side in SIDES:
        root = tmp_path / side.name
        root.mkdir()
        r = Run(side, root)
        if scenario in NEEDS_MONKEYPATCH:
            scenario(r, monkeypatch)
        else:
            scenario(r)
        records.append(r.finish())
    want, got = records
    assert got == want


# --------------------------------------------------------------------------
# The exposition, sample line by sample line
# --------------------------------------------------------------------------

@pytest.mark.parametrize("used", [0.0, 0.001, 5.0, 7.25, 10.0, 1234.5678,
                                  2.5e7])
def test_exposition_matches_generate_latest(tmp_path, used):
    """Both gauge families after sweeps that set, flip and collect series
    (a namespace and pod name that need escaping among them): the port's
    rendering against ``generate_latest``, line by line, HELP and TYPE
    aside."""
    texts = []
    for side in SIDES:
        root = tmp_path / side.name
        root.mkdir()
        r = Run(side, root)
        r.api.create_pod(tenant("a", 8, [0]))
        r.api.create_pod(tenant("b", 4, [1]))
        odd = tenant('we"ird\\pod', 4, [1], uid="uid-odd")
        r.api.create_pod(odd)
        for uid, gib in (("uid-a", used), ("uid-b", 3.0),
                         ("uid-odd", 4.5)):
            r.beat(uid, gib)
        wd = r.watchdog()
        wd.sweep()
        r.api.delete_pod("default", "b")
        r.beat("uid-a", used + 9)
        wd.sweep()
        texts.append(exposition(side, wd))
    want, got = (
        [ln for ln in t.splitlines() if not ln.startswith("# HELP")]
        for t in texts)
    assert got == want
    assert sum(1 for ln in got if not ln.startswith("#")) == 4


def test_render_is_the_metrics_endpoint_body(tmp_path):
    """The gauge families as the daemon serves them: HELP, TYPE, then the
    samples of each family."""
    r = Run(TORCH, tmp_path)
    r.api.create_pod(tenant("good", 8, [0]))
    r.beat("uid-good", 5.0)
    wd = r.watchdog()
    wd.sweep()
    lines = wd.render().decode().splitlines()
    assert lines[0].startswith("# HELP tpushare_hbm_used_gib ")
    assert lines[1:3] == [
        "# TYPE tpushare_hbm_used_gib gauge",
        'tpushare_hbm_used_gib{namespace="default",node="host-a",'
        'pod="good"} 5.0']
    assert lines[4:] == [
        "# TYPE tpushare_grant_overrun gauge",
        'tpushare_grant_overrun{namespace="default",node="host-a",'
        'pod="good"} 0.0']


def test_watchdog_imports_no_metrics_library():
    """The watchdog, the plugin and the fake apiserver import the
    standard library and the port alone."""
    import ast
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    allowed_top = {"tpushare_torch", "__future__"}
    for rel in ("deviceplugin/watchdog.py", "deviceplugin/plugin.py",
                "deviceplugin/discovery.py", "k8s/fake.py", "k8s/events.py",
                "k8s/eviction.py", "k8s/commit.py", "k8s/errors.py",
                "api/objects.py", "utils/pod.py", "utils/const.py"):
        path = os.path.join(repo, "tpushare_torch", rel)
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                top = name.split(".")[0]
                assert top in allowed_top or top in _stdlib(), (rel, name)


def _stdlib() -> frozenset:
    import sys
    return frozenset(sys.stdlib_module_names)

