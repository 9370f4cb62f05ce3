"""The native discovery shim (``tpushare_torch/native/nvdisc.cc``), built
with ``g++`` and run on fake devfs, sysfs and procfs trees: its rung of
``discover_host`` against the Python rungs on the same trees, what it
counts and in which order, the ``NVIDIA_VISIBLE_DEVICES`` restriction,
its C ABI, and a failed build that raises instead of falling through."""

import ctypes
import shutil

import pytest

from tpushare_torch.deviceplugin import discovery as D

NO_SMI = "/nonexistent/nvidia-smi"
MINORS = {"0000:18:00.0": 0, "0000:2a:00.0": 1, "0000:9a:00.0": 2,
          "0000:ab:00.0": 3}
NUMA = {"0000:18:00.0": 0, "0000:2a:00.0": 0, "0000:9a:00.0": 1,
        "0000:ab:00.0": 1}


def _write(path, text=""):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


def _tree(tmp_path, procfs=True, sysfs=True, nodes=("nvidia0", "nvidia1",
                                                    "nvidia2", "nvidia3")):
    """Four H100s as device nodes beside the control nodes; their PCI
    functions (plus an NVSwitch and another vendor's VGA) in sysfs and the
    kernel module's per-card files in procfs where asked."""
    dev, sys_, proc = tmp_path / "dev", tmp_path / "sys", tmp_path / "proc"
    dev.mkdir(parents=True)
    for name in (*nodes, "nvidiactl", "nvidia-uvm", "nvidia-uvm-tools",
                 "nvidia-modeset"):
        _write(dev / name)
    _write(dev / "nvidia-caps" / "nvidia-cap1")
    if sysfs:
        pci = sys_ / "bus" / "pci" / "devices"
        functions = {addr: ("0x10de", "0x2330", "0x030200", str(NUMA[addr]))
                     for addr in MINORS}
        functions["0000:05:00.0"] = ("0x10de", "0x22a3", "0x068000", "0")
        functions["0000:00:02.0"] = ("0x8086", "0x0bd5", "0x030000", "-1")
        for addr, (vendor, device, klass, numa) in functions.items():
            for name, value in (("vendor", vendor), ("device", device),
                                ("class", klass), ("numa_node", numa)):
                _write(pci / addr / name, value + "\n")
    if procfs:
        for addr, minor in MINORS.items():
            _write(proc / "driver" / "nvidia" / "gpus" / addr / "information",
                   f"Model: \t\t NVIDIA H100 80GB HBM3\nIRQ:   \t\t 42\n"
                   f"Bus Location: \t {addr}\nDevice Minor: \t {minor}\n")
    return {"devfs_root": str(dev), "sysfs_root": str(sys_),
            "procfs_root": str(proc)}


def _discover(roots, **kw):
    return D.discover_host(**{**roots, "environ": {}, "smi_path": NO_SMI,
                              **kw})


def _without_the_shim(monkeypatch, roots, **kw):
    """The chain with :func:`D.devfs_scan`, the shim's rule in Python, in
    the native rung's place, on the same trees."""
    with monkeypatch.context() as m:
        m.setattr(D.NativeDiscovery, "discover",
                  lambda self, model_hint="": D.devfs_scan(self.devfs_root,
                                                           model_hint))
        return _discover(roots, **kw)


def _facts(inv):
    return (inv.chip_count, [c.index for c in inv.chips], inv.tpu_type,
            [c.chip_type for c in inv.chips], [c.hbm_gib for c in inv.chips],
            inv.total_hbm_gib)


@pytest.mark.parametrize("procfs,sysfs,environ", [
    (True, True, {}),
    (True, False, {}),
    (False, True, {}),
    (False, False, {D.ENV_GPU_MODEL: "NVIDIA H100 80GB HBM3"}),
    (False, False, {}),
])
def test_native_rung_equals_the_python_rungs(tmp_path, monkeypatch, procfs,
                                             sysfs, environ):
    roots = _tree(tmp_path, procfs=procfs, sysfs=sysfs)
    native = _discover(roots, environ=environ)
    python = _without_the_shim(monkeypatch, roots, environ=environ)
    assert (native.source, python.source) == ("native", "devfs")
    assert _facts(native) == _facts(python)
    assert native.chip_count == 4
    named = procfs or sysfs or environ
    assert native.tpu_type == ("h100-80gb" if named else "")
    assert native.total_hbm_gib == (4 * 79 if named else 0)
    assert [c.device_path for c in native.chips] == [
        c.device_path for c in python.chips]


def test_native_reads_numa_through_procfs_bus_ids(tmp_path):
    roots = _tree(tmp_path)
    inv = D.NativeDiscovery(**roots).discover()
    assert [c.numa_node for c in inv.chips] == [0, 0, 1, 1]
    assert [c.numa_node for c in inv.chips] == [
        c.numa_node for c in D.sysfs_scan(roots["sysfs_root"]).chips]
    raw = D.NativeDiscovery(**roots).enumerate()
    assert [r.bus_id.decode() for r in raw] == list(MINORS)
    assert {(r.pci_vendor, r.pci_device) for r in raw} == {(0x10de, 0x2330)}
    assert {r.model.decode() for r in raw} == {"NVIDIA H100 80GB HBM3"}


def test_native_without_procfs_counts_but_does_not_name(tmp_path):
    roots = _tree(tmp_path, procfs=False)
    inv = D.NativeDiscovery(**roots).discover()
    assert inv.chip_count == 4 and inv.tpu_type == ""
    assert {c.hbm_gib for c in inv.chips} == {0}
    assert {c.numa_node for c in inv.chips} == {-1}
    assert D.NativeDiscovery(**roots).discover("l4").total_hbm_gib == 4 * 22


def test_control_nodes_and_odd_names_are_not_cards(tmp_path):
    dev = tmp_path / "dev"
    for name in ("nvidia0", "nvidia2", "nvidiactl", "nvidia-uvm",
                 "nvidia-uvm-tools", "nvidia-modeset", "nvidia0foo",
                 "nvidia", "nvidia-1", "nvidia2x", "accel0", "nvidia_3"):
        _write(dev / name)
    _write(dev / "nvidia-caps" / "nvidia-cap1")
    none = str(tmp_path / "none")
    native = D.NativeDiscovery(str(dev), none, none).discover()
    python = D.devfs_scan(str(dev))
    assert [c.index for c in native.chips] == [0, 2]
    assert [c.index for c in native.chips] == [c.index for c in python.chips]


def test_index_order_and_the_nvidia_subdirectory(tmp_path):
    dev = tmp_path / "dev"
    for name in ("nvidia10", "nvidia2", "nvidia0"):
        _write(dev / name)
    _write(dev / "nvidia" / "nvidia7")
    _write(dev / "nvidia" / "nvidia2")           # counted once
    none = str(tmp_path / "none")
    inv = D.NativeDiscovery(str(dev), none, none).discover()
    assert [c.index for c in inv.chips] == [0, 2, 7, 10]
    assert inv.chips[1].device_path == str(dev / "nvidia2")
    assert inv.chips[2].device_path == str(dev / "nvidia" / "nvidia7")


def test_no_card_falls_through_to_the_next_rung(tmp_path):
    roots = _tree(tmp_path, nodes=())
    assert D.NativeDiscovery(**roots).discover() is None
    inv = _discover(roots)
    assert inv.source == "sysfs" and inv.chip_count == 4


@pytest.mark.parametrize("visible,source,indices", [
    ("0", "native", [0]),
    ("1,3", "native", [1, 3]),
    ("all", "native", [0, 1, 2, 3]),
    ("GPU-4f2f1c9e-0000-0000-0000-000000000001", "native", [0, 1, 2, 3]),
    ("7", "env", [7]),
])
def test_visible_devices_restrict_the_native_rung(tmp_path, visible, source,
                                                  indices):
    roots = _tree(tmp_path)
    inv = _discover(roots, environ={D.ENV_VISIBLE_DEVICES: visible})
    assert inv.source == source
    assert [c.index for c in inv.chips] == indices
    assert inv.total_hbm_gib == 79 * len(indices)


def test_struct_size_matches_ctypes():
    lib = D.NativeDiscovery().lib
    assert lib.nvdisc_struct_size() == ctypes.sizeof(D._NvdiscCard)
    assert lib.nvdisc_version() == b"nvdisc/1.0"


def test_bad_arguments_return_minus_one(tmp_path):
    lib = D.NativeDiscovery().lib
    buf = (D._NvdiscCard * 4)()
    roots = (str(tmp_path).encode(),) * 3
    assert lib.nvdisc_enumerate(None, 4, *roots) == -1
    assert lib.nvdisc_enumerate(buf, 0, *roots) == -1
    assert lib.nvdisc_enumerate(buf, -2, *roots) == -1
    long_root = "/" + "d" * 300
    assert lib.nvdisc_enumerate(buf, 4, long_root.encode(), *roots[1:]) == -1
    with pytest.raises(RuntimeError, match="refused"):
        D.NativeDiscovery(long_root, str(tmp_path), str(tmp_path)).discover()
    # An empty root names no directory, and joined to a node's name it
    # would name one under /: it is refused, whichever root it is.
    for i in range(3):
        empty = tuple(b"" if j == i else r for j, r in enumerate(roots))
        assert lib.nvdisc_enumerate(buf, 4, *empty) == -1
    # NULL roots are the defaults, /dev, /sys and /proc.
    assert lib.nvdisc_enumerate(buf, 4, None, None, None) >= 0


def test_max_cards_bounds_the_count(tmp_path):
    dev = tmp_path / "dev"
    for i in range(6):
        _write(dev / f"nvidia{i}")
    none = str(tmp_path / "none").encode()
    lib = D.NativeDiscovery().lib
    buf = (D._NvdiscCard * 3)()
    assert lib.nvdisc_enumerate(buf, 3, str(dev).encode(), none, none) == 3


def test_a_failed_build_raises_and_does_not_fall_through(tmp_path,
                                                         monkeypatch):
    roots = _tree(tmp_path / "host")
    monkeypatch.setattr(D, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.delenv(D.ENV_NATIVE_LIB, raising=False)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="building nvdisc.cc failed"):
        _discover(roots)
    # A compiler that runs and fails: its output is in the error.
    broken = tmp_path / "nvdisc.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(D, "_NATIVE_SRC", broken)
    monkeypatch.setenv("CXX", shutil.which("g++"))
    with pytest.raises(RuntimeError, match="error"):
        _discover(roots)
    assert not list((tmp_path / "build").glob("*.so"))


def test_a_library_that_does_not_load_raises(tmp_path, monkeypatch):
    monkeypatch.setenv(D.ENV_NATIVE_LIB, str(tmp_path / "libmissing.so"))
    with pytest.raises(RuntimeError, match="cannot load"):
        _discover(_tree(tmp_path))


def test_nvdisc_lib_names_a_prebuilt_shim(tmp_path, monkeypatch):
    monkeypatch.setattr(D, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.delenv(D.ENV_NATIVE_LIB, raising=False)
    built = D.build_native()
    assert built.parent == tmp_path / "build"
    assert built.name == D.native_lib_path().name
    assert built.name.startswith("libnvdisc-")
    prebuilt = tmp_path / "libprebuilt.so"
    shutil.copy(built, prebuilt)
    monkeypatch.setenv(D.ENV_NATIVE_LIB, str(prebuilt))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    inv = _discover(_tree(tmp_path / "host"))
    assert inv.source == "native" and inv.chip_count == 4


def test_the_library_is_named_by_its_source(tmp_path, monkeypatch):
    copy = tmp_path / "nvdisc.cc"
    copy.write_bytes(D._NATIVE_SRC.read_bytes())
    before = D.native_lib_path()
    monkeypatch.setattr(D, "_NATIVE_SRC", copy)
    assert D.native_lib_path() == before
    copy.write_bytes(copy.read_bytes() + b"// changed\n")
    assert D.native_lib_path() != before
