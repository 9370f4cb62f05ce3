"""The JAX package's node daemon and the port's, side by side, for the
parity tests of ``tests/test_torch_deviceplugin_daemon.py``,
``tests/test_torch_kubelet_grpc.py`` and ``tests/test_torch_watchdog.py``.

A scenario runs once a side on the same raw documents (built with
``tpushare.k8s.builders``) and records what it observed; the test holds
the two records equal. An allocation is recorded as :func:`alloc_view`
sees it: the ``TPUSHARE_*`` envs, annotations and mounts as they are;
the visible cards (``TPU_VISIBLE_CHIPS`` against
``NVIDIA_VISIBLE_DEVICES``), the ordinals a process sees them by (the
TPU keeps host names, so ``0..k-1`` from the count, against
``CUDA_VISIBLE_DEVICES``), the allocator cap (the reference's
``XLA_PYTHON_CLIENT_MEM_FRACTION`` against what ``torchenv`` computes
from the grant) and the device nodes (``/dev/accelN`` becomes
``/dev/nvidiaN``; the test's devfs root holds no control node).
"""

from __future__ import annotations

import dataclasses
import types

from tpushare.deviceplugin import discovery as JD
from tpushare.deviceplugin import plugin as JP
from tpushare.deviceplugin import watchdog as JW
from tpushare.k8s import errors as JE
from tpushare.k8s import events as JEV
from tpushare.k8s.fake import FakeApiServer as JFake
from tpushare.utils import const as jconst
from tpushare_torch.deviceplugin import discovery as TD
from tpushare_torch.deviceplugin import plugin as TP
from tpushare_torch.deviceplugin import watchdog as TW
from tpushare_torch.k8s import errors as TE
from tpushare_torch.k8s import events as TEV
from tpushare_torch.k8s.fake import FakeApiServer as TFake
from tpushare_torch.runtime import torchenv
from tpushare_torch.utils import const

NODE = "host-a"
CHIPS, GIB = 4, 16


@dataclasses.dataclass(frozen=True)
class Side:
    name: str
    disc: types.ModuleType
    plug: types.ModuleType
    wd: types.ModuleType
    errors: types.ModuleType
    events: types.ModuleType
    Fake: type
    model: str
    node_prefix: str  # a card's device node under devfs

    def inventory(self, chips: int = CHIPS, hbm: int = GIB):
        return self.disc.fake_inventory(chips=chips, hbm_gib=hbm,
                                        tpu_type=self.model)

    def chip_inventory(self, paths: dict[int, str], hbm: int = GIB):
        """An inventory of cards of ``hbm`` GiB at ``paths``."""
        return self.disc.HostInventory(
            tpu_type=self.model, topology="",
            chips=tuple(self.disc.ChipSpec(i, hbm, device_path=p,
                                           chip_type=self.model)
                        for i, p in sorted(paths.items())))

    def plugin(self, api, inv, devfs: str, node: str = NODE, **kw):
        if self is TORCH:
            kw["devfs_root"] = devfs
        return self.plug.TPUSharePlugin(node, api, inv, **kw)

    def watchdog(self, client, usage_dir: str, **kw):
        return self.wd.GrantWatchdog(NODE, client, usage_dir=usage_dir, **kw)

    def gauge(self, wd, name: str, pod: str, namespace: str = "default"):
        if self is JAX:
            return wd.registry.get_sample_value(
                name, {"namespace": namespace, "pod": pod, "node": NODE})
        family = {"tpushare_hbm_used_gib": wd.used,
                  "tpushare_grant_overrun": wd.overrun}[name]
        return family.get((namespace, pod, NODE))


JAX = Side("jax", JD, JP, JW, JE, JEV, JFake, "v5e", "accel")
TORCH = Side("torch", TD, TP, TW, TE, TEV, TFake, "h100-80gb", "nvidia")
SIDES = (JAX, TORCH)


def alloc_view(side: Side, alloc) -> dict:
    """What an allocation grants, in terms both sides share."""
    envs = alloc.envs
    view = {"tpushare": {k: v for k, v in envs.items()
                         if k.startswith("TPUSHARE_")},
            "annotations": dict(alloc.annotations),
            "mounts": [list(m) for m in alloc.mounts]}
    if side is JAX:
        visible = envs[jconst.ENV_TPU_VISIBLE_CHIPS]
        frac = envs.get(jconst.ENV_XLA_MEM_FRACTION)
        view.update(
            visible=visible,
            ordinals=",".join(str(i) for i in
                              range(len(visible.split(",")))),
            fraction=float(frac) if frac is not None else None,
            devices=[[p.replace("accel", "nvidia") for p in d]
                     for d in alloc.devices])
        assert not set(envs) & {const.ENV_NVIDIA_VISIBLE_DEVICES,
                                const.ENV_CUDA_VISIBLE_DEVICES}
    else:
        view.update(
            visible=envs[const.ENV_NVIDIA_VISIBLE_DEVICES],
            ordinals=envs[const.ENV_CUDA_VISIBLE_DEVICES],
            fraction=torchenv.memory_fraction(torchenv.read_grant(envs)),
            devices=[list(d) for d in alloc.devices])
        assert not set(envs) & {jconst.ENV_TPU_VISIBLE_CHIPS,
                                jconst.ENV_XLA_MEM_FRACTION}
    return view


def pods_state(api) -> dict:
    """Every pod's annotations, by namespace/name."""
    return {p.key(): dict(p.annotations) for p in api.list_pods()}


def event_view(api) -> list[tuple[str, str, str]]:
    """The events posted, as (reason, involved pod, type)."""
    return [(e["reason"], e["involvedObject"]["name"], e["type"])
            for _, e in api.events]
