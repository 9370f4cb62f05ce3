"""The port's NVIDIA discovery (``tpushare_torch/deviceplugin/discovery.py``)
on fake devfs, sysfs and procfs roots, and its inventory types against
the JAX package's."""

import dataclasses

import pytest

from tpushare.deviceplugin import discovery as JD
from tpushare_torch.deviceplugin import discovery as D

NO_SMI = "/nonexistent/nvidia-smi"
H100_MINORS = {"0000:18:00.0": 0, "0000:2a:00.0": 1, "0000:9a:00.0": 2,
               "0000:ab:00.0": 3}
NUMA = {"0000:18:00.0": 0, "0000:2a:00.0": 0, "0000:9a:00.0": 1,
        "0000:ab:00.0": 1}


def _write(path, text):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


@pytest.fixture
def host(tmp_path):
    """An HGX-like host: four H100s as /dev/nvidia0-3 beside the control
    nodes; in sysfs the four cards plus an NVSwitch, an audio function
    (both NVIDIA's vendor id) and another vendor's VGA; the kernel
    module's per-card files in procfs."""
    dev, sys_, proc = tmp_path / "dev", tmp_path / "sys", tmp_path / "proc"
    for name in ("nvidia0", "nvidia1", "nvidia2", "nvidia3", "nvidiactl",
                 "nvidia-uvm", "nvidia-uvm-tools", "nvidia-modeset"):
        _write(dev / name, "")
    _write(dev / "nvidia-caps" / "nvidia-cap1", "")
    pci = sys_ / "bus" / "pci" / "devices"
    functions = {addr: ("0x10de", "0x2330", "0x030200", str(NUMA[addr]))
                 for addr in H100_MINORS}
    functions.update({
        "0000:05:00.0": ("0x10de", "0x22a3", "0x068000", "0"),   # NVSwitch
        "0000:18:00.1": ("0x10de", "0x22ba", "0x040300", "0"),   # audio
        "0000:00:02.0": ("0x8086", "0x0bd5", "0x030000", "-1"),  # other VGA
    })
    for addr, (vendor, device, klass, numa) in functions.items():
        for name, value in (("vendor", vendor), ("device", device),
                            ("class", klass), ("numa_node", numa)):
            _write(pci / addr / name, value + "\n")
    for addr, minor in H100_MINORS.items():
        _write(proc / "driver" / "nvidia" / "gpus" / addr / "information",
               f"Model: \t\t NVIDIA H100 80GB HBM3\nIRQ:   \t\t 42\n"
               f"Bus Location: \t {addr}\nDevice Minor: \t {minor}\n")
    return {"devfs_root": str(dev), "sysfs_root": str(sys_),
            "procfs_root": str(proc)}


def _discover(host, **kw):
    args = {**host, "environ": {}, "smi_path": NO_SMI, **kw}
    return D.discover_host(**args)


def test_devfs_counts_cards_not_control_nodes(host):
    inv = _discover(host)
    assert inv.source == "devfs" and inv.chip_count == 4
    assert [c.index for c in inv.chips] == [0, 1, 2, 3]
    assert inv.chips[2].device_path.endswith("/dev/nvidia2")
    # Named by the procfs model line: 79 usable GiB each.
    assert inv.tpu_type == "h100-80gb" and inv.topology == ""
    assert {c.hbm_gib for c in inv.chips} == {79}
    assert inv.total_hbm_gib == 4 * 79


def test_sysfs_counts_only_display_functions(host, tmp_path):
    inv = _discover(host, devfs_root=str(tmp_path / "none"))
    assert inv.source == "sysfs" and inv.chip_count == 4
    assert [c.numa_node for c in inv.chips] == [0, 0, 1, 1]
    assert inv.tpu_type == "h100-80gb"


def test_sysfs_names_the_model_by_pci_id(host, tmp_path):
    inv = D.sysfs_scan(host["sysfs_root"])
    assert inv.tpu_type == "h100-80gb" and inv.chips[0].hbm_gib == 79


def test_procfs_counts_the_drivers_cards(host, tmp_path):
    none = str(tmp_path / "none")
    inv = _discover(host, devfs_root=none, sysfs_root=none)
    assert inv.source == "procfs" and inv.chip_count == 4
    assert sorted(c.index for c in inv.chips) == [0, 1, 2, 3]
    assert inv.tpu_type == "h100-80gb"


@pytest.mark.parametrize("value,indices", [
    ("0,1", [0, 1]),
    ("2", [2]),
    ("GPU-4f2f1c9e-0000-0000-0000-000000000001,"
     "GPU-4f2f1c9e-0000-0000-0000-000000000002", [0, 1]),
])
def test_env_counts_visible_devices(tmp_path, value, indices):
    none = str(tmp_path / "none")
    inv = D.discover_host(none, none, none, environ={
        D.ENV_VISIBLE_DEVICES: value, D.ENV_GPU_MODEL: "nvidia-h100-80gb"},
        smi_path=NO_SMI)
    assert inv.source == "env"
    assert [c.index for c in inv.chips] == indices
    assert inv.total_hbm_gib == 79 * len(indices)


@pytest.mark.parametrize("value", ["all", "none", "void", "", "ALL"])
def test_env_without_a_list_gives_nothing(value):
    env = {D.ENV_VISIBLE_DEVICES: value, D.ENV_GPU_MODEL: "h100-80gb"}
    assert D.env_discover(env) is None


@pytest.mark.parametrize("labels,model,count", [
    ({D.GKE_ACCELERATOR_LABEL: "nvidia-h100-80gb",
      D.INSTANCE_TYPE_LABEL: "a3-highgpu-8g"}, "h100-80gb", 8),
    ({D.GKE_ACCELERATOR_LABEL: "nvidia-h100-mega-80gb"}, "h100-80gb", 1),
    ({D.GKE_ACCELERATOR_LABEL: "nvidia-tesla-a100",
      D.INSTANCE_TYPE_LABEL: "a2-highgpu-2g"}, "a100-40gb", 2),
    ({D.GKE_ACCELERATOR_LABEL: "nvidia-a100-80gb"}, "a100-80gb", 1),
    ({D.GKE_ACCELERATOR_LABEL: "nvidia-l4",
      D.INSTANCE_TYPE_LABEL: "g2-standard-8"}, "l4", 1),
])
def test_gke_label(tmp_path, labels, model, count):
    none = str(tmp_path / "none")
    inv = D.discover_host(none, none, none, environ={}, node_labels=labels,
                          smi_path=NO_SMI)
    assert inv.source == "gke-labels" and inv.tpu_type == model
    assert inv.chip_count == count
    assert inv.total_hbm_gib == count * D.HBM_GIB_BY_TYPE[model]


@pytest.mark.parametrize("visible,source,indices", [
    ("0", "devfs", [0]),
    ("0,2", "devfs", [0, 2]),
    ("all", "devfs", [0, 2]),
    ("GPU-4f2f1c9e-0000-0000-0000-000000000001", "devfs", [0, 2]),
    ("5", "env", [5]),
])
def test_visible_devices_restrict_the_file_rungs(tmp_path, visible, source,
                                                  indices):
    """A container that shows /dev/nvidia0 and /dev/nvidia2 but was given
    card 0 (NVIDIA_VISIBLE_DEVICES=0) counts one card; a list of UUIDs or
    ``all`` names no index and restricts nothing; an index no node has
    leaves the count to the env rung."""
    dev = tmp_path / "dev"
    for name in ("nvidia0", "nvidia2", "nvidiactl", "nvidia-uvm"):
        _write(dev / name, "")
    none = str(tmp_path / "none")
    inv = D.discover_host(str(dev), none, none, smi_path=NO_SMI, environ={
        D.ENV_VISIBLE_DEVICES: visible, D.ENV_GPU_MODEL: "h100-80gb"})
    assert inv.source == source
    assert [c.index for c in inv.chips] == indices
    assert inv.total_hbm_gib == 79 * len(indices)


def test_chain_order_and_none_when_every_rung_misses(host, tmp_path):
    none = str(tmp_path / "none")
    env = {D.ENV_VISIBLE_DEVICES: "0", D.ENV_GPU_MODEL: "l4"}
    labels = {D.GKE_ACCELERATOR_LABEL: "nvidia-l4"}
    rungs = [("devfs_root", "devfs"), ("sysfs_root", "sysfs"),
             ("procfs_root", "procfs")]
    kw = {**host, "environ": env, "node_labels": labels, "smi_path": NO_SMI}
    for i, (_, source) in enumerate(rungs):
        missing = {root: none for root, _ in rungs[:i]}
        assert D.discover_host(**{**kw, **missing}).source == source
    missing = {root: none for root, _ in rungs}
    assert D.discover_host(**{**kw, **missing}).source == "env"
    assert D.discover_host(**{**kw, **missing,
                              "environ": {}}).source == "gke-labels"
    assert D.discover_host(**{**kw, **missing, "environ": {},
                              "node_labels": {}}) is None


def test_the_card_names_the_model_before_any_hint(host):
    """The card's own model line wins over the env and label hints."""
    inv = _discover(host, environ={D.ENV_GPU_MODEL: "l4"},
                    node_labels={D.GKE_ACCELERATOR_LABEL: "nvidia-l4"})
    assert inv.tpu_type == "h100-80gb"


def test_an_unnamed_card_takes_the_hint(tmp_path):
    dev = tmp_path / "dev"
    _write(dev / "nvidia0", "")
    none = str(tmp_path / "none")
    inv = D.discover_host(str(dev), none, none,
                          environ={D.ENV_GPU_MODEL: "NVIDIA L4"},
                          smi_path=NO_SMI)
    assert (inv.source, inv.tpu_type, inv.chips[0].hbm_gib) == (
        "devfs", "l4", 22)
    inv = D.discover_host(str(dev), none, none, environ={}, smi_path=NO_SMI)
    assert (inv.tpu_type, inv.total_hbm_gib) == ("", 0)


def _fake_smi(tmp_path, names):
    smi = tmp_path / "nvidia-smi"
    lines = "".join(f"echo '{i}, {name}'\n" for i, name in enumerate(names))
    smi.write_text("#!/bin/sh\n" + lines)
    smi.chmod(0o755)
    return str(smi)


def test_nvidia_smi_names_a_card_no_file_names(tmp_path):
    """A container that shows /dev/nvidia0 and NVIDIA_VISIBLE_DEVICES but
    neither the module's procfs nor the PCI tree: nvidia-smi names the
    card, ahead of the env and label hints."""
    dev = tmp_path / "dev"
    for name in ("nvidia0", "nvidiactl", "nvidia-uvm", "nvidia-uvm-tools"):
        _write(dev / name, "")
    none = str(tmp_path / "none")
    smi = _fake_smi(tmp_path, ["NVIDIA H100 80GB HBM3"])
    assert D.smi_models(smi) == {0: "h100-80gb"}
    inv = D.discover_host(str(dev), none, none,
                          environ={D.ENV_VISIBLE_DEVICES: "0",
                                   D.ENV_GPU_MODEL: "l4"},
                          smi_path=smi)
    assert (inv.source, inv.chip_count, inv.tpu_type) == ("devfs", 1,
                                                          "h100-80gb")
    assert inv.chips[0].hbm_gib == 79
    assert D.smi_models(NO_SMI) == {}


@pytest.mark.parametrize("text,model", [
    ("NVIDIA H100 80GB HBM3", "h100-80gb"),
    ("nvidia-h100-80gb", "h100-80gb"),
    ("h100-80gb", "h100-80gb"),
    ("NVIDIA H100 PCIe", "h100-80gb"),
    ("NVIDIA H100 NVL", "h100-80gb"),      # unknown size: the smallest
    ("NVIDIA H200", "h200-141gb"),
    ("NVIDIA A100-SXM4-80GB", "a100-80gb"),
    ("NVIDIA A100-SXM4-40GB", "a100-40gb"),
    ("nvidia-tesla-a100", "a100-40gb"),
    ("NVIDIA L4", "l4"),
    ("NVIDIA L40S", ""),
    ("Tesla T4", ""),
    ("", ""),
])
def test_parse_model(text, model):
    assert D.parse_model(text) == model


def test_hbm_table_never_exceeds_the_card():
    """Every entry is whole GiB at or under the card's size, and the
    H100's is under the 81,559 MiB nvidia-smi reports for it."""
    assert D.HBM_GIB_BY_TYPE["h100-80gb"] * 1024 <= 81559
    for model, gib in D.HBM_GIB_BY_TYPE.items():
        nominal = int(model.split("-")[1][:-2]) if "-" in model else 24
        assert 0 < gib <= nominal
    assert set(D.PCI_DEVICE_MODELS.values()) <= set(D.HBM_GIB_BY_TYPE)


def test_inventory_types_match_the_reference():
    for ours, ref in ((D.ChipSpec, JD.ChipSpec),
                      (D.HostInventory, JD.HostInventory)):
        assert ([(f.name, f.default) for f in dataclasses.fields(ours)]
                == [(f.name, f.default) for f in dataclasses.fields(ref)])
    ref = JD.fake_inventory(chips=4, hbm_gib=79, tpu_type="h100-80gb")
    ours = D.HostInventory(
        tpu_type="h100-80gb", topology=ref.topology, source="fake",
        chips=tuple(D.ChipSpec(**dataclasses.asdict(c)) for c in ref.chips))
    assert (ours.chip_count, ours.total_hbm_gib) == (ref.chip_count,
                                                      ref.total_hbm_gib)
    for i in (0, 3, 7):
        got, want = ours.chip(i), ref.chip(i)
        assert (got is None) == (want is None)
        if want is not None:
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
