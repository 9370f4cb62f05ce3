"""The port's kubelet gRPC plumbing and daemon
(``tpushare_torch/deviceplugin/kubelet.py``,
``tpushare_torch/cmd/deviceplugin_main.py``) against the JAX package's,
over real gRPC on unix sockets.

Each scenario of ``tests/test_kubelet_grpc.py`` is one case: it drives
the JAX daemon (``run_node_daemon`` and its ``FakeKubelet``, over the JAX
fake apiserver) and the port's, with the same documents, makes that
test's checks on each side and records what came over the wire: the
registrations, the advertised devices, the Allocate response (as
``torch_daemon_sides.alloc_view`` puts it), the RPC error, the preferred
ids and the node's annotations. The two records must be equal. Then the
daemon's main: its exit codes, its environment, the gauges it serves and
the re-registration after kubelet's socket is recreated.
"""

from __future__ import annotations

import json
import os
import threading
import types
import urllib.request

import grpc
import pytest

from tests.torch_daemon_sides import (
    CHIPS, GIB, JAX, NODE, SIDES, TORCH, alloc_view, pods_state)
from tpushare.k8s.builders import make_node, make_pod
from tpushare_torch.cmd import deviceplugin_main as main_mod
from tpushare_torch.deviceplugin import kubelet as TK
from tpushare_torch.utils import const


def kubelet_module(side):
    if side is JAX:
        from tpushare.deviceplugin import kubelet
        return kubelet
    return TK


def wire_alloc(resp) -> types.SimpleNamespace:
    """A ContainerAllocateResponse as an allocation."""
    return types.SimpleNamespace(
        envs=dict(resp.envs),
        devices=tuple((d.host_path, d.container_path) for d in resp.devices),
        mounts=tuple((m.host_path, m.container_path, m.read_only)
                     for m in resp.mounts),
        annotations=dict(resp.annotations))


class Stack:
    """One side's daemon over real gRPC: a fake kubelet, the side's
    apiserver and ``run_node_daemon``."""

    def __init__(self, side, root, devfs, usage):
        self.s = side
        self.k = kubelet_module(side)
        self.dir = str(root)
        self.kubelet = self.k.FakeKubelet(self.dir)
        self.kubelet.start()
        self.api = side.Fake()
        self.api.create_node(make_node(NODE, chips=CHIPS, hbm_per_chip=GIB))
        kw = {"devfs_root": devfs} if side is TORCH else {}
        self.servers = self.k.run_node_daemon(
            NODE, self.api, side.inventory(), plugin_dir=self.dir,
            poll_interval=0.05, usage_dir=usage, **kw)
        self.obs: list = []

    def note(self, key, value) -> None:
        self.obs.append((key, value))

    def endpoint(self, resource) -> str:
        return self.k.socket_name(resource)

    def close(self) -> list:
        for s in self.servers:
            s.stop()
        self.kubelet.stop()
        self.note("pods", pods_state(self.api))
        return self.obs


def servicer(side, api, resource, devfs):
    """A servicer over a plugin of node "n" with no node object."""
    k = kubelet_module(side)
    plugin = side.plugin(api, side.inventory(), devfs, node="n",
                         usage_dir="")
    return k.DevicePluginServicer(plugin, resource)


# --------------------------------------------------------------------------
# Scenarios: tests/test_kubelet_grpc.py, one function each
# --------------------------------------------------------------------------

def registration_both_resources(st, devfs):
    regs = sorted((r.resource_name, r.version, r.endpoint,
                   r.options.get_preferred_allocation_available)
                  for r in st.kubelet.registrations)
    assert {r[0] for r in regs} == {const.HBM_RESOURCE,
                                    const.CHIP_RESOURCE}
    assert all(r[1] == st.k.API_VERSION == "v1beta1" for r in regs)
    assert all(r[2] == st.endpoint(r[0]) for r in regs)
    st.note("registrations", regs)


def list_and_watch_advertises_capacity(st, devfs):
    hbm = st.kubelet.snapshot_devices(st.endpoint(const.HBM_RESOURCE))
    chips = st.kubelet.snapshot_devices(st.endpoint(const.CHIP_RESOURCE))
    assert len(hbm) == 64 and len(chips) == 4
    assert all(d.health == "Healthy" for d in hbm)
    st.note("devices", [[(d.ID, d.health) for d in devs]
                        for devs in (hbm, chips)])


def allocate_over_the_wire(st, devfs):
    st.api.create_pod(make_pod(
        "w", hbm=8, node_name=NODE, annotations={
            const.ANN_CHIP_IDX: "2", const.ANN_HBM_POD: "8",
            const.ANN_HBM_CHIP: "16",
            const.ANN_ASSIGNED: const.ASSIGNED_FALSE,
            const.ANN_ASSUME_TIME: "1790000000000000000"}))
    ids = [f"tpushare-hbm-00-{i:03d}" for i in range(8)]  # kubelet's pick
    resp = st.kubelet.allocate(st.endpoint(const.HBM_RESOURCE), ids)
    assert len(resp.container_responses) == 1
    creq = resp.container_responses[0]
    view = alloc_view(st.s, wire_alloc(creq))
    # The env follows the extender's card (2), not kubelet's ids.
    assert creq.envs[const.ENV_CHIP_IDX] == "2"
    assert view["visible"] == "2" and view["ordinals"] == "0"
    assert view["fraction"] == 0.45
    assert view["devices"][0][0] == "/fake/nvidia2"
    assert {d.permissions for d in creq.devices} == {"rw"}
    assert st.api.get_pod("default", "w").annotations[
        const.ANN_ASSIGNED] == const.ASSIGNED_TRUE
    view["tpushare"].pop(const.ENV_USAGE_FILE)
    view.pop("mounts")
    st.note("allocation", view)


def allocate_no_matching_pod_is_an_rpc_error(st, devfs):
    with pytest.raises(grpc.RpcError) as err:
        st.kubelet.allocate(st.endpoint(const.HBM_RESOURCE), ["x"] * 3)
    assert err.value.code() == grpc.StatusCode.INTERNAL
    st.note("code", err.value.code().name)


def get_preferred_allocation_packs_sorted(st, devfs):
    svc = servicer(st.s, st.s.Fake(), const.HBM_RESOURCE, devfs)
    pb = st.k.pb
    req = pb.PreferredAllocationRequest(container_requests=[
        pb.ContainerPreferredAllocationRequest(
            available_deviceIDs=["tpushare-hbm-01-000",
                                 "tpushare-hbm-00-001",
                                 "tpushare-hbm-00-000"],
            allocation_size=2)])
    got = list(svc.GetPreferredAllocation(req, None)
               .container_responses[0].deviceIDs)
    assert got == ["tpushare-hbm-00-000", "tpushare-hbm-00-001"]
    st.note("preferred", got)


def node_annotated_at_daemon_start(st, devfs):
    ann = st.api.get_node(NODE).raw["metadata"]["annotations"]
    assert ann[const.ANN_NODE_CHIP_HBM] == "16,16,16,16"
    assert ann[const.ANN_NODE_TPU_TYPE] == st.s.model
    st.note("chip_hbm", ann[const.ANN_NODE_CHIP_HBM])


def get_preferred_allocation_follows_extender_plan(st, devfs):
    api = st.s.Fake()
    svc = servicer(st.s, api, const.CHIP_RESOURCE, devfs)
    api.create_pod(make_pod("w", chips=2, node_name="n", annotations={
        const.ANN_CHIP_IDX: "2,3", const.ANN_HBM_POD: "32",
        const.ANN_HBM_CHIP: "16", const.ANN_ASSIGNED: const.ASSIGNED_FALSE,
        const.ANN_ASSUME_TIME: "1"}))
    pb = st.k.pb
    req = pb.PreferredAllocationRequest(container_requests=[
        pb.ContainerPreferredAllocationRequest(
            available_deviceIDs=[f"tpushare-chip-{i:02d}" for i in range(4)],
            allocation_size=2)])
    got = list(svc.GetPreferredAllocation(req, None)
               .container_responses[0].deviceIDs)
    assert got == ["tpushare-chip-02", "tpushare-chip-03"]
    st.note("preferred", got)
    # Over the wire too, through the daemon's own servicer.
    st.api.create_pod(make_pod("v", chips=2, node_name=NODE, annotations={
        const.ANN_CHIP_IDX: "1,3", const.ANN_HBM_POD: "32",
        const.ANN_HBM_CHIP: "16", const.ANN_ASSIGNED: const.ASSIGNED_FALSE,
        const.ANN_ASSUME_TIME: "1"}))
    with st.kubelet._channel(st.endpoint(const.CHIP_RESOURCE)) as ch:
        wire = st.k.DevicePluginStub(ch).GetPreferredAllocation(
            req, timeout=5.0)
    got = list(wire.container_responses[0].deviceIDs)
    assert got == ["tpushare-chip-01", "tpushare-chip-03"]
    st.note("wire", got)


SCENARIOS = [
    registration_both_resources, list_and_watch_advertises_capacity,
    allocate_over_the_wire, allocate_no_matching_pod_is_an_rpc_error,
    get_preferred_allocation_packs_sorted, node_annotated_at_daemon_start,
    get_preferred_allocation_follows_extender_plan,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_wire_matches_the_reference(scenario, tmp_path):
    devfs = tmp_path / "devfs"
    devfs.mkdir()
    usage = str(tmp_path / "usage")
    records = []
    for side in SIDES:
        root = tmp_path / side.name
        root.mkdir()
        st = Stack(side, root, str(devfs), usage)
        try:
            scenario(st, str(devfs))
        finally:
            records.append(st.close())
    want, got = records
    assert got == want


def test_fake_kubelet_asks_the_preferred_allocation(tmp_path):
    """``FakeKubelet.preferred``: GetPreferredAllocation for one
    container, over the wire, as kubelet asks it before Allocate."""
    st = Stack(TORCH, tmp_path, str(tmp_path), str(tmp_path / "u"))
    try:
        st.api.create_pod(make_pod("w", hbm=4, node_name=NODE, annotations={
            const.ANN_CHIP_IDX: "3", const.ANN_HBM_POD: "4",
            const.ANN_HBM_CHIP: "16",
            const.ANN_ASSIGNED: const.ASSIGNED_FALSE,
            const.ANN_ASSUME_TIME: "1"}))
        avail = [f"tpushare-hbm-{c:02d}-{g:03d}" for c in range(4)
                 for g in range(16)]
        got = st.kubelet.preferred(st.endpoint(const.HBM_RESOURCE), avail, 4)
        assert got == [f"tpushare-hbm-03-{g:03d}" for g in range(4)]
    finally:
        st.close()


# --------------------------------------------------------------------------
# The daemon's main
# --------------------------------------------------------------------------

def test_daemon_serves_gauges_and_reregisters(tmp_path, monkeypatch):
    """``run``: both resources registered, the watchdog's gauges on the
    metrics port, and a recreated kubelet socket answered by fresh
    plugin sockets and a second registration. The daemon binds the
    metrics port itself and reports it (a port picked here and freed
    before the daemon binds it can be taken by another process), and
    every wait is on the condition it stands for."""
    from tpushare_torch.k8s.fake import FakeApiServer

    monkeypatch.setattr(main_mod, "KUBELET_POLL_S", 0.05)
    monkeypatch.setattr(main_mod, "KUBELET_SETTLE_S", 0.0)
    plugin_dir, usage = str(tmp_path / "plugins"), str(tmp_path / "usage")
    os.makedirs(plugin_dir)
    kubelet = TK.FakeKubelet(plugin_dir)
    kubelet.start()
    api = FakeApiServer()
    api.create_node(make_node(NODE))
    api.create_pod(make_pod("t", hbm=4, node_name=NODE, uid="uid-t",
                            phase="Running", annotations={
                                const.ANN_CHIP_IDX: "0",
                                const.ANN_HBM_POD: "4",
                                const.ANN_ASSIGNED: const.ASSIGNED_TRUE}))
    os.makedirs(os.path.join(usage, "uid-t"))
    with open(os.path.join(usage, "uid-t", "usage.json"), "w",
              encoding="utf-8") as f:
        json.dump({"bytes_in_use": 6 << 30, "ts": 4e9}, f)
    stop = threading.Event()
    swept, ports, gone = threading.Event(), [], threading.Event()

    def sweep_once(self, stop, interval=10.0):
        self.sweep()
        swept.set()
    monkeypatch.setattr(main_mod.GrantWatchdog, "run", sweep_once)
    real_inode = main_mod._inode

    def inode(path):
        # The daemon's poll of kubelet's socket: note when it saw the
        # socket gone.
        ino = real_inode(path)
        if ino is None and path == kubelet.socket_path:
            gone.set()
        return ino
    monkeypatch.setattr(main_mod, "_inode", inode)
    t = threading.Thread(target=main_mod.run, args=(
        NODE, api, TORCH.inventory(), stop), kwargs=dict(
        plugin_dir=plugin_dir, usage_dir=usage, metrics_port=0,
        metrics_bound=ports.append), daemon=True)
    t.start()
    second = None
    try:
        assert TK.wait_for(lambda: len(kubelet.registrations) == 2,
                           timeout=60)
        assert TK.wait_for(lambda: bool(ports) and swept.is_set(),
                           timeout=60)
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{ports[0]}/metrics",
            timeout=30).read().decode()
        assert ('tpushare_hbm_used_gib{namespace="default",node="host-a",'
                'pod="t"} 6.0') in body
        assert ('tpushare_grant_overrun{namespace="default",node="host-a",'
                'pod="t"} 1.0') in body
        # kubelet restarts: its socket goes, and comes back under a new
        # inode once the daemon's poll has seen it gone.
        kubelet.stop()
        assert TK.wait_for(lambda: not os.path.exists(kubelet.socket_path))
        assert gone.wait(60)
        second = TK.FakeKubelet(plugin_dir)
        second.start()
        assert TK.wait_for(lambda: len(second.registrations) == 2,
                           timeout=60)
        assert {r.resource_name for r in second.registrations} == {
            const.HBM_RESOURCE, const.CHIP_RESOURCE}
        assert len(second.snapshot_devices(
            TK.socket_name(const.CHIP_RESOURCE))) == CHIPS
    finally:
        stop.set()
        t.join(timeout=30)
        assert not t.is_alive()
        for k in (kubelet, second):
            if k is not None:
                k.stop()
    assert not os.path.exists(os.path.join(
        plugin_dir, TK.socket_name(const.HBM_RESOURCE)))


def test_main_exits_2_without_a_node_name(monkeypatch):
    monkeypatch.delenv("NODE_NAME", raising=False)
    with pytest.raises(SystemExit) as exc:
        main_mod.main()
    assert exc.value.code == 2


def _no_cluster(monkeypatch, api):
    monkeypatch.setenv("NODE_NAME", NODE)
    monkeypatch.setattr(main_mod.ClusterConfig, "auto",
                        classmethod(lambda cls: None))
    monkeypatch.setattr(main_mod, "ApiClient", lambda cfg: api)


def test_main_exits_1_without_a_card(monkeypatch):
    from tpushare_torch.k8s.fake import FakeApiServer

    api = FakeApiServer()
    api.create_node({"metadata": {"name": NODE, "labels": {"a": "b"}}})
    _no_cluster(monkeypatch, api)
    seen = {}

    def discover(node_labels=None):
        seen["labels"] = node_labels
    monkeypatch.setattr(main_mod.discovery, "discover_host", discover)
    with pytest.raises(SystemExit) as exc:
        main_mod.main()
    assert exc.value.code == 1
    assert seen["labels"] == {"a": "b"}


@pytest.mark.parametrize("env,want", [
    ({}, dict(plugin_dir="/var/lib/kubelet/device-plugins",
              usage_dir="/var/run/tpushare/usage", evict_after=0,
              metrics_port=0)),
    ({"DEVICE_PLUGIN_PATH": "/p", "TPUSHARE_USAGE_DIR": "",
      "TPUSHARE_EVICT_OVERRUN": "TRUE", "METRICS_PORT": "9400"},
     dict(plugin_dir="/p", usage_dir="", evict_after=3, metrics_port=9400)),
    ({"TPUSHARE_EVICT_OVERRUN": "true", "TPUSHARE_EVICT_AFTER_SWEEPS": "5"},
     dict(plugin_dir="/var/lib/kubelet/device-plugins",
          usage_dir="/var/run/tpushare/usage", evict_after=5,
          metrics_port=0)),
])
def test_main_reads_the_reference_s_environment(monkeypatch, env, want):
    """The JAX daemon's variables, read the same way, and the discovered
    inventory handed to the daemon."""
    from tpushare_torch.k8s.fake import FakeApiServer

    for key in ("DEVICE_PLUGIN_PATH", "TPUSHARE_USAGE_DIR",
                "TPUSHARE_EVICT_OVERRUN", "TPUSHARE_EVICT_AFTER_SWEEPS",
                "METRICS_PORT"):
        monkeypatch.delenv(key, raising=False)
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    api = FakeApiServer()
    _no_cluster(monkeypatch, api)
    inv = TORCH.inventory()
    monkeypatch.setattr(main_mod.discovery, "discover_host",
                        lambda node_labels=None: inv)
    monkeypatch.setattr(main_mod, "setup_signals",
                        lambda stop, flush=None: None)
    got = {}

    def run(node, client, inventory, stop, **kw):
        got.update(node=node, client=client, inventory=inventory, **kw)
    monkeypatch.setattr(main_mod, "run", run)
    main_mod.main()
    assert got == dict(node=NODE, client=api, inventory=inv, **want)
