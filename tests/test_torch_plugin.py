"""The device plugin's accelerator half for NVIDIA cards
(``tpushare_torch/deviceplugin/plugin.py``) against the JAX package's
``TPUSharePlugin``: the advertisement's ids and health, and the
``Allocate`` response on every shared key, over equal inventories; the
container remap of host cards to CUDA ordinals; and phase 2d's tenant env
in ``chip_smoke.py``."""

import os
import stat

import pytest

import chip_smoke
from tpushare.api.objects import Pod
from tpushare.deviceplugin import discovery as JD
from tpushare.deviceplugin import plugin as JP
from tpushare.k8s.builders import make_node, make_pod
from tpushare.k8s.fake import FakeApiServer
from tpushare.utils import const as jconst
from tpushare_torch.deviceplugin import discovery as D
from tpushare_torch.deviceplugin import plugin as P
from tpushare_torch.runtime import torchenv
from tpushare_torch.utils import const

CHIPS, GIB = 4, 16


def _reference(usage_dir, chips=CHIPS, gib=GIB):
    api = FakeApiServer()
    api.create_node(make_node("host-a", chips=chips, hbm_per_chip=gib,
                              tpu_type="v5e"))
    inv = JD.fake_inventory(chips=chips, hbm_gib=gib, tpu_type="v5e")
    return JP.TPUSharePlugin("host-a", api, inv, usage_dir=usage_dir)


@pytest.fixture
def devfs(tmp_path):
    """A devfs root with two of the three control nodes."""
    dev = tmp_path / "dev"
    dev.mkdir()
    for name in ("nvidiactl", "nvidia-uvm"):
        (dev / name).write_text("")
    return str(dev)


GRANTS = {
    # name: (chip ids, granted GiB, whole chips, gang (group, size))
    "slice": ([1], 6, False, None),
    "slice_of_all": ([0], 16, False, None),
    "whole_1": ([2], 16, True, None),
    "whole_2": ([0, 1], 32, True, None),
    "gang_slice": ([3], 8, False, ("infer", 2)),
    "gang_whole_2": ([2, 3], 32, True, ("train", 4)),
}


@pytest.mark.parametrize("usage", [True, False], ids=["usage", "no_usage"])
@pytest.mark.parametrize("name", list(GRANTS))
def test_allocation_matches_the_reference(tmp_path, devfs, name, usage):
    chip_ids, gib, whole, gang = GRANTS[name]
    usage_dir = str(tmp_path / "usage") if usage else ""
    annotations = ({jconst.ANN_POD_GROUP: gang[0],
                    jconst.ANN_POD_GROUP_MIN: str(gang[1])} if gang else {})
    pod = Pod(make_pod("w", hbm=gib, node_name="host-a", uid=f"uid-{name}",
                       annotations=annotations))
    want = _reference(usage_dir)._build_allocation(
        pod, chip_ids, whole_chips=whole, granted_gib=gib)
    got = P.build_allocation(
        D.fake_inventory(chips=CHIPS, hbm_gib=GIB), chip_ids, gib,
        pod_uid=pod.uid, group=gang and gang[0],
        group_size=gang[1] if gang else 0, whole_chips=whole,
        usage_dir=usage_dir, devfs_root=devfs)

    def tpushare(envs):
        return {k: v for k, v in envs.items() if k.startswith("TPUSHARE_")}

    assert tpushare(got.envs) == tpushare(want.envs)
    assert got.mounts == want.mounts
    assert got.annotations == want.annotations
    assert (const.ENV_USAGE_FILE in got.envs) == (usage and not whole)
    for host, _, _ in got.mounts:
        assert stat.S_IMODE(os.stat(host).st_mode) == 0o777
    # The tenant's cap from the grant is the reference's env fraction.
    fraction = want.envs.get(jconst.ENV_XLA_MEM_FRACTION)
    assert torchenv.memory_fraction(torchenv.read_grant(got.envs)) == (
        float(fraction) if fraction is not None else None)
    # /dev/accelN becomes /dev/nvidiaN, then the control nodes that exist.
    control = [os.path.join(devfs, n) for n in ("nvidiactl", "nvidia-uvm")]
    assert got.devices == tuple(
        (p.replace("accel", "nvidia"), c.replace("accel", "nvidia"))
        for p, c in want.devices) + tuple((p, p) for p in control)
    # The container contract replaces the TPU's chip envs.
    assert got.envs[const.ENV_NVIDIA_VISIBLE_DEVICES] == ",".join(
        map(str, chip_ids))
    assert got.envs[const.ENV_CUDA_VISIBLE_DEVICES] == ",".join(
        str(i) for i in range(len(chip_ids)))
    for key in (jconst.ENV_TPU_VISIBLE_CHIPS, jconst.ENV_XLA_MEM_FRACTION):
        assert key not in got.envs


def test_advertisement_ids_match_the_reference(tmp_path):
    ref = _reference("", chips=2, gib=16)
    inv = D.fake_inventory(chips=2, hbm_gib=16)
    for ours, theirs in ((P.hbm_devices(inv), ref.hbm_devices()),
                         (P.chip_devices(inv), ref.chip_devices())):
        assert [(d.id, d.health, d.numa_node) for d in ours] == [
            (d.id, d.health, d.numa_node) for d in theirs]
    assert len(P.hbm_devices(inv)) == 32
    assert P.hbm_devices(inv)[17].id == "tpushare-hbm-01-001"
    assert P.chip_devices(inv)[1].id == "tpushare-chip-01"
    h100 = D.fake_inventory(chips=1)
    assert len(P.hbm_devices(h100)) == D.HBM_GIB_BY_TYPE["h100-80gb"]


def test_health_turns_unhealthy_when_a_node_goes(tmp_path):
    dev = tmp_path / "dev"
    dev.mkdir()
    for i in range(2):
        (dev / f"nvidia{i}").write_text("")
    inv = D.discover_host(str(dev), str(tmp_path / "none"),
                          str(tmp_path / "none"), environ={},
                          smi_path="/nonexistent/nvidia-smi")
    assert inv.source == "native"
    assert {d.health for d in P.chip_devices(inv)} == {P.HEALTHY}
    (dev / "nvidia1").unlink()
    assert [d.health for d in P.chip_devices(inv)] == [P.HEALTHY,
                                                       P.UNHEALTHY]
    for c in inv.chips:
        assert P.chip_health(c.device_path) == (
            JP.TPUSharePlugin._chip_health(c.device_path))
    assert P.chip_health("/fake/nvidia9") == P.HEALTHY
    assert P.chip_health("") == P.HEALTHY


@pytest.mark.parametrize("chip_ids,ordinals", [([3], "0"), ([2, 3], "0,1"),
                                               ([0], "0")])
def test_container_remap_of_host_cards(tmp_path, chip_ids, ordinals):
    """A tenant granted host card 3 sees it as CUDA ordinal 0 in its
    container: configure leaves the allocation's CUDA_VISIBLE_DEVICES
    alone, while the grant keeps the host indices."""
    inv = D.fake_inventory(chips=4)
    alloc = P.build_allocation(inv, chip_ids, 79 * len(chip_ids),
                               pod_uid="u", whole_chips=True, usage_dir="")
    env = dict(alloc.envs)
    grant = torchenv.configure(env)
    host = ",".join(map(str, chip_ids))
    assert env[const.ENV_CUDA_VISIBLE_DEVICES] == ordinals
    assert env[const.ENV_NVIDIA_VISIBLE_DEVICES] == host
    assert env[const.ENV_CHIP_IDX] == host
    assert grant.chip_ids == tuple(chip_ids)
    assert alloc.annotations == {const.ANN_CHIP_IDX: host}
    # Outside a container (no CUDA_VISIBLE_DEVICES), configure names the
    # host's own indices, which a process there sees.
    bare = {k: v for k, v in alloc.envs.items()
            if k != const.ENV_CUDA_VISIBLE_DEVICES}
    torchenv.configure(bare)
    assert bare[const.ENV_CUDA_VISIBLE_DEVICES] == host


def test_an_unknown_card_gets_its_devfs_node(tmp_path, devfs):
    alloc = P.build_allocation(D.fake_inventory(chips=1), [5], 4,
                               pod_uid="u", usage_dir="", devfs_root=devfs)
    assert alloc.devices[0] == (os.path.join(devfs, "nvidia5"),) * 2
    assert alloc.envs[const.ENV_HBM_CHIP] == "0"


def test_phase_2d_tenant_env_is_the_allocation(tmp_path):
    """The allocated tenant's env: the kept paths, this checkout on
    PYTHONPATH, the allocation's envs, and nothing of the parent's grant
    or card choice."""
    alloc = P.build_allocation(D.fake_inventory(chips=4), [3], 16,
                               pod_uid="smoke", usage_dir=str(tmp_path))
    parent = {"PATH": "/usr/bin", "HOME": "/home/u", "PYTHONPATH": "/x",
              "LD_LIBRARY_PATH": "/usr/local/cuda/lib64",
              const.ENV_CHIP_IDX: "0", const.ENV_HBM_POD: "79",
              const.ENV_POD_GROUP: "old", "TPUSHARE_ANYTHING": "1",
              const.ENV_CUDA_VISIBLE_DEVICES: "5", "UNRELATED": "1"}
    env = chip_smoke.tenant_env(alloc, parent)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert env["PYTHONPATH"].split(os.pathsep) == [repo, "/x"]
    assert {k: env[k] for k in ("PATH", "HOME", "LD_LIBRARY_PATH")} == {
        k: parent[k] for k in ("PATH", "HOME", "LD_LIBRARY_PATH")}
    assert {k: v for k, v in env.items()
            if k.startswith("TPUSHARE_")} == {
        k: v for k, v in alloc.envs.items() if k.startswith("TPUSHARE_")}
    assert env[const.ENV_CUDA_VISIBLE_DEVICES] == "0"
    assert "UNRELATED" not in env
    assert set(env) == set(chip_smoke.TENANT_KEEP_ENV) & set(parent) | set(
        alloc.envs) | {"PYTHONPATH"}
