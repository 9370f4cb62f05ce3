"""The port's scheduler extender places a tenant and the port's node
daemon commits it, for ``tests/test_torch_extender_daemon.py``.

Run as a script (``python tests/torch_extender_daemon_side.py WORKDIR``),
it refuses any import of ``tpushare`` or ``jax`` before it imports the
port, runs :func:`scenario` over the port's fake apiserver and stack,
and prints its outcome as one JSON line with the modules of either name
that were loaded (none). The test also runs :func:`scenario` with the
JAX package's stack over its fake apiserver, and compares.
"""

from __future__ import annotations

import importlib.abc
import json
import os
import sys
import urllib.request

NODE = "h100-node"


class _Refuse(importlib.abc.MetaPathFinder):
    """Fails the import of the JAX package and of JAX."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("tpushare", "jax", "jaxlib"):
            raise ImportError(f"{name} may not be imported here")
        return None


def _post(base: str, path: str, doc: dict) -> dict:
    req = urllib.request.Request(base + path, data=json.dumps(doc).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        assert resp.status == 200
        return json.loads(resp.read())


def scenario(api, stack_mod, cache_cls, plugin_client, workdir: str) -> dict:
    """The port's daemon annotates an H100 node of two cards; the stack of
    ``stack_mod`` places a 7 GiB pod on it through filter, prioritize and
    bind over HTTP; the daemon's plugin matches and commits that pod in
    Allocate; the live ledger, inspect and a rebuilt cache read it."""
    from tpushare_torch.deviceplugin import discovery, plugin
    from tpushare_torch.k8s.builders import make_pod
    from tpushare_torch.utils import const

    api.create_node({"apiVersion": "v1", "kind": "Node",
                     "metadata": {"name": NODE},
                     "status": {"capacity": {const.HBM_RESOURCE: "158",
                                             const.CHIP_RESOURCE: "2"},
                                "allocatable": {const.HBM_RESOURCE: "158",
                                                const.CHIP_RESOURCE: "2"}}})
    devfs = os.path.join(workdir, "devfs")
    os.makedirs(devfs, exist_ok=True)
    plug = plugin.TPUSharePlugin(
        NODE, plugin_client, discovery.fake_inventory(chips=2),
        state_dir=workdir, usage_dir=os.path.join(workdir, "usage"),
        devfs_root=devfs)
    plug.annotate_node()
    out = {"node_annotations": dict(api.get_node(NODE).annotations)}
    stack, server = stack_mod.serve_stack(api)
    base = (f"http://127.0.0.1:{server.server_address[1]}"
            "/tpushare-scheduler")
    try:
        created = api.create_pod(make_pod("llm", hbm=7, uid="uid-llm"))
        pod = api.get_pod("default", "llm")
        passed = _post(base, "/filter", {"Pod": pod.raw,
                                         "NodeNames": [NODE]})
        scores = _post(base, "/prioritize", {
            "Pod": pod.raw, "NodeNames": passed["NodeNames"]})
        best = max(scores, key=lambda e: e["Score"])["Host"]
        out["filter"], out["scores"] = passed, scores
        out["bind"] = _post(base, "/bind", {
            "PodName": "llm", "PodNamespace": "default",
            "PodUID": created.uid, "Node": best})
        bound = api.get_pod("default", "llm")
        chip = int(bound.annotations[const.ANN_CHIP_IDX])
        out.update(node=bound.node_name, chip=chip, bound_annotations={
            k: bound.annotations[k] for k in (
                const.ANN_CHIP_IDX, const.ANN_HBM_POD, const.ANN_HBM_CHIP,
                const.ANN_ASSIGNED)})
        avail = [f"tpushare-hbm-{c:02d}-{g:03d}" for c in range(2)
                 for g in range(79)]
        ids = plug.preferred_ids(const.HBM_RESOURCE, avail, 7)
        alloc = plug.allocate_hbm(ids)
        out["preferred"] = ids
        out["envs"] = {k: alloc.envs[k] for k in (
            const.ENV_CHIP_IDX, const.ENV_NVIDIA_VISIBLE_DEVICES,
            const.ENV_CUDA_VISIBLE_DEVICES, const.ENV_HBM_POD)}
        out["assigned"] = api.get_pod("default", "llm").annotations[
            const.ANN_ASSIGNED]
        assert stack.controller.wait_idle(timeout=60)
        held = stack.controller.cache.get_node_info(NODE).chips[chip].pods
        out["ledger_holds"] = held[created.uid].name
        with urllib.request.urlopen(f"{base}/inspect/{NODE}",
                                    timeout=60) as resp:
            doc = json.loads(resp.read())
        out["inspect_used"] = [c["usedHBM"] for c in doc["nodes"][0]["chips"]]
        # An extender that rebuilds its cache from the apiserver, as on a
        # restart, reads the committed flag too.
        rebuilt = cache_cls(api.get_node, api.list_pods)
        rebuilt.build()
        info = rebuilt.get_node_info(NODE)
        out["rebuilt_assigned"] = info.chips[chip].pods[
            created.uid].annotations[const.ANN_ASSIGNED]
        out["rebuilt_avail"] = {str(k): v for k, v in
                                info.get_available_hbm().items()}
    finally:
        stack_mod.shutdown_stack(stack, server)
    return out


def main(workdir: str) -> int:
    sys.meta_path.insert(0, _Refuse())
    from tpushare_torch.cache.cache import SchedulerCache
    from tpushare_torch.cmd import main as stack_mod
    from tpushare_torch.k8s.fake import FakeApiServer

    api = FakeApiServer()
    out = scenario(api, stack_mod, SchedulerCache, api, workdir)
    out["loaded"] = sorted(m for m in sys.modules
                           if m.split(".")[0] in ("tpushare", "jax"))
    print(json.dumps(out, sort_keys=True), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
