"""The port's device plugin (``tpushare_torch/deviceplugin/plugin.py``,
``TPUSharePlugin``) against the JAX package's, scenario by scenario.

Every scenario of ``tests/test_deviceplugin.py`` from the advertisement
on (discovery has its own port tests) is one case: it runs once on the
JAX plugin over the JAX ``FakeApiServer`` and once on the port's plugin
over the port's fake, on the same raw pods and nodes, makes that test's
checks on each side, and records what it saw: the allocations (as
``torch_daemon_sides.alloc_view`` puts them), the errors raised, every
pod's annotations, the served-grant tables and the checkpoint file. The
two records must be equal. Then the checkpoint is read across, both
ways, and the JAX extender schedules a pod onto a node the port's daemon
annotated.
"""

from __future__ import annotations

import json
import os
import threading

import pytest

from tests.torch_daemon_sides import (
    CHIPS, GIB, JAX, NODE, SIDES, TORCH, alloc_view, pods_state)
from tpushare.k8s.builders import make_node, make_pod
from tpushare_torch.api.objects import Node, Pod
from tpushare_torch.k8s import commit
from tpushare_torch.k8s import eviction as TEvict
from tpushare_torch.runtime import torchenv
from tpushare_torch.utils import const
from tpushare_torch.utils import pod as podutils


#: An assume time: the scenarios' documents are the same on both sides.
T0 = 1_790_000_000_000_000_000


class Run:
    """One side's run of a scenario: its apiserver, directories and the
    record of what it observed."""

    def __init__(self, side, root, shared):
        self.s = side
        self.api = side.Fake()
        self.state = str(root / "state")
        os.makedirs(self.state)
        self.devfs = str(shared / "devfs")
        self.usage = str(shared / "usage")
        self.root = root
        self.obs: list = []

    def note(self, key, value) -> None:
        self.obs.append((key, value))

    def plugin(self, chips=CHIPS, hbm=GIB, node=NODE, create_node=True,
               client=None, inv=None, **kw):
        if create_node:
            self.api.create_node(make_node(node, chips=chips,
                                           hbm_per_chip=hbm))
        kw.setdefault("usage_dir", self.usage)
        return self.s.plugin(client or self.api,
                             inv or self.s.inventory(chips, hbm),
                             self.devfs, node=node, **kw)

    def call(self, fn, *args):
        """``fn(*args)``, recording the allocations or the error's type."""
        try:
            out = fn(*args)
        except Exception as e:  # noqa: BLE001 - recorded and compared
            self.note("raise", type(e).__name__)
            return e
        if isinstance(out, list):
            self.note("allocs", [alloc_view(self.s, a) for a in out])
        else:
            self.note("alloc", alloc_view(self.s, out))
        return out

    def ann(self, name, namespace="default") -> dict:
        return self.api.get_pod(namespace, name).annotations

    def assigned(self, name) -> bool:
        return self.ann(name).get(const.ANN_ASSIGNED) == const.ASSIGNED_TRUE

    def finish(self, plugin=None) -> list:
        self.note("pods", pods_state(self.api))
        if plugin is not None:
            self.note("partial", (plugin._partial, plugin._partial_chips))
        path = os.path.join(self.state, "tpushare_grants.json")
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                self.note("checkpoint", json.load(f))
        return self.obs


def assumed(name, hbm, chip_ids, assume_ns, hbm_chip=GIB, node=NODE,
            **kw):
    """An HBM-slice pod as the extender's bind leaves it."""
    return make_pod(
        name, hbm=hbm, node_name=node,
        annotations={
            const.ANN_CHIP_IDX: ",".join(str(c) for c in chip_ids),
            const.ANN_HBM_POD: str(hbm), const.ANN_HBM_CHIP: str(hbm_chip),
            const.ANN_ASSIGNED: const.ASSIGNED_FALSE,
            const.ANN_ASSUME_TIME: str(assume_ns)}, **kw)


def chip_pod(name, chip_ids, containers=None, assume="1", extra=None):
    """A whole-card pod assumed on ``chip_ids``: one container of all of
    them, or one a size of ``containers``."""
    doc = make_pod(name, chips=len(chip_ids), node_name=NODE, annotations={
        const.ANN_CHIP_IDX: ",".join(map(str, chip_ids)),
        const.ANN_HBM_POD: str(GIB * len(chip_ids)),
        const.ANN_HBM_CHIP: str(GIB),
        const.ANN_ASSIGNED: const.ASSIGNED_FALSE,
        const.ANN_ASSUME_TIME: assume, **(extra or {})})
    if containers:
        doc["spec"]["containers"] = [
            {"name": f"c{i}",
             "resources": {"limits": {const.CHIP_RESOURCE: str(n)}}}
            for i, n in enumerate(containers)]
    return doc


def two_container_pod(r):
    pod = assumed("mc", 12, [0], 1)
    pod["spec"]["containers"] = [
        {"name": "a", "resources": {"limits": {const.HBM_RESOURCE: "8"}}},
        {"name": "b", "resources": {"limits": {const.HBM_RESOURCE: "4"}}}]
    return r.api.create_pod(pod)


class FailingCommit:
    """The side's apiserver, whose pod updates fail with a conflict
    ``failures`` times."""

    def __init__(self, r, failures=99):
        self._api, self._conflict = r.api, r.s.errors.ConflictError
        self.failures = failures

    def __getattr__(self, name):
        return getattr(self._api, name)

    def update_pod(self, pod):
        if self.failures > 0:
            self.failures -= 1
            raise self._conflict(reason="synthetic conflict")
        return self._api.update_pod(pod)


# --------------------------------------------------------------------------
# Scenarios: tests/test_deviceplugin.py from :152 on, one function each
# --------------------------------------------------------------------------

def hbm_device_advertisement(r):
    plugin = r.plugin(chips=2)
    devs = plugin.hbm_devices()
    assert len(devs) == 32
    assert devs[0].id == "tpushare-hbm-00-000"
    assert {d.health for d in devs} == {"Healthy"}
    r.note("hbm", [(d.id, d.health, d.numa_node) for d in devs])
    r.note("chips", [(d.id, d.health) for d in plugin.chip_devices()])


def health_tracks_device_nodes(r):
    inv = r.s.chip_inventory({0: "/dev/definitely-missing-0"})
    plugin = r.plugin(create_node=False, inv=inv, node="n")
    assert plugin.chip_devices()[0].health == "Unhealthy"
    r.note("chips", [(d.id, d.health) for d in plugin.chip_devices()])


def annotate_node_publishes_capacities(r):
    r.api.create_node({"apiVersion": "v1", "kind": "Node",
                       "metadata": {"name": "bare"}, "status": {}})
    inv = r.s.inventory(chips=4, hbm=95)
    r.plugin(create_node=False, inv=inv, node="bare").annotate_node()
    ann = dict(r.api.get_node("bare").raw["metadata"]["annotations"])
    assert ann.pop(const.ANN_NODE_CHIP_HBM) == "95,95,95,95"
    assert ann.pop(const.ANN_NODE_TPU_TYPE) == r.s.model
    # The TPU host publishes its ICI topology; an NVIDIA host has none.
    assert ann.pop(const.ANN_NODE_TOPOLOGY, "") == inv.topology
    assert (inv.topology == "") == (r.s is TORCH)
    r.note("node", ann)


def allocate_hbm_matches_earliest_assume_time(r):
    plugin = r.plugin()
    t0 = T0
    r.api.create_pod(assumed("late", 8, [1], t0 + 1000))
    r.api.create_pod(assumed("early", 8, [0], t0))
    alloc = r.call(plugin.allocate_hbm, ["x"] * 8)
    assert alloc.envs[const.ENV_CHIP_IDX] == "0"
    assert alloc.envs[const.ENV_HBM_POD] == "8"
    assert alloc.envs[const.ENV_HBM_CHIP] == "16"
    assert alloc_view(r.s, alloc)["fraction"] == 0.45
    assert r.assigned("early") and not r.assigned("late")
    r.note("times", [r.ann(n)[const.ANN_ASSUME_TIME] == str(t)
                     for n, t in (("early", t0), ("late", t0 + 1000))])
    return plugin


def allocate_hbm_ignores_other_nodes_and_sizes(r):
    plugin = r.plugin()
    r.api.create_pod(assumed("other-node", 8, [0], 1, node="host-b"))
    r.api.create_pod(assumed("other-size", 4, [0], 1))
    assert isinstance(r.call(plugin.allocate_hbm, ["x"] * 8),
                      r.s.plug.AllocateError)
    return plugin


def allocate_hbm_skips_already_assigned(r):
    plugin = r.plugin()
    pod = assumed("done", 8, [0], 1)
    pod["metadata"]["annotations"][const.ANN_ASSIGNED] = const.ASSIGNED_TRUE
    r.api.create_pod(pod)
    assert isinstance(r.call(plugin.allocate_hbm, ["x"] * 8),
                      r.s.plug.AllocateError)
    return plugin


def allocate_hbm_never_consumes_whole_chip_pod(r):
    plugin = r.plugin()
    r.api.create_pod(chip_pod("chip-pod", [0, 1]))
    assert isinstance(r.call(plugin.allocate_hbm, ["x"] * 32),
                      r.s.plug.AllocateError)
    assert not r.assigned("chip-pod")
    return plugin


def whole_chip_allocation_no_mem_fraction(r):
    plugin = r.plugin()
    r.api.create_pod(chip_pod("chips", [2, 3], assume="5"))
    alloc = r.call(plugin.allocate_chips,
                   ["tpushare-chip-00", "tpushare-chip-01"])
    view = alloc_view(r.s, alloc)
    assert view["visible"] == "2,3" and view["fraction"] is None
    assert r.assigned("chips")
    return plugin


def chip_allocation_without_extender_pod(r):
    plugin = r.plugin()
    alloc = r.call(plugin.allocate_chips, ["tpushare-chip-01"])
    assert alloc_view(r.s, alloc)["visible"] == "1"
    assert alloc.annotations == {}
    return plugin


def _mc_pod(r, sizes, chip=0, name="mc"):
    return r.api.create_pod(make_pod(
        name, container_hbm=sizes, node_name=NODE, annotations={
            const.ANN_CHIP_IDX: str(chip),
            const.ANN_HBM_POD: str(sum(sizes)),
            const.ANN_HBM_CHIP: "16",
            const.ANN_ASSIGNED: const.ASSIGNED_FALSE,
            const.ANN_ASSUME_TIME: "1"}))


def multi_container_commit_on_last(r):
    plugin = r.plugin()
    _mc_pod(r, [4, 4])
    a1 = r.call(plugin.allocate_hbm, ["x"] * 4)
    assert a1.envs[const.ENV_HBM_POD] == "4"
    assert alloc_view(r.s, a1)["fraction"] == 0.225
    assert not r.assigned("mc")
    r.note("mid", pods_state(r.api))
    a2 = r.call(plugin.allocate_hbm, ["x"] * 4)
    assert a2.envs[const.ENV_CHIP_IDX] == a1.envs[const.ENV_CHIP_IDX]
    assert r.assigned("mc")
    return plugin


def multi_container_pod_total_does_not_match(r):
    plugin = r.plugin()
    _mc_pod(r, [4, 4])
    assert isinstance(r.call(plugin.allocate_hbm, ["x"] * 8),
                      r.s.plug.AllocateError)
    return plugin


def multi_container_partial_pruned_when_pod_deleted(r):
    plugin = r.plugin()
    pod = _mc_pod(r, [4, 4])
    r.call(plugin.allocate_hbm, ["x"] * 4)
    assert plugin._partial.get(pod.uid) == [4]
    r.api.delete_pod("default", "mc")
    assert isinstance(r.call(plugin.allocate_hbm, ["x"] * 4),
                      r.s.plug.AllocateError)
    assert pod.uid not in plugin._partial
    return plugin


def multi_container_unequal_matched_by_size(r):
    plugin = r.plugin()
    _mc_pod(r, [2, 6])
    assert r.call(plugin.allocate_hbm, ["x"] * 6).envs[
        const.ENV_HBM_POD] == "6"
    assert r.call(plugin.allocate_hbm, ["x"] * 2).envs[
        const.ENV_HBM_POD] == "2"
    assert r.assigned("mc")
    return plugin


def health_flips_unhealthy_when_device_vanishes(r):
    dev = r.root / "dev"
    dev.mkdir()
    for i in range(2):
        (dev / f"{r.s.node_prefix}{i}").write_text("")
    paths = {i: str(dev / f"{r.s.node_prefix}{i}") for i in range(2)}
    plugin = r.plugin(chips=2, inv=r.s.chip_inventory(paths))
    assert {d.health for d in plugin.chip_devices()} == {"Healthy"}
    (dev / f"{r.s.node_prefix}1").unlink()
    healths = [(d.id, d.health) for d in plugin.chip_devices()]
    assert healths == [("tpushare-chip-00", "Healthy"),
                       ("tpushare-chip-01", "Unhealthy")]
    hbm = plugin.hbm_devices()
    assert sum(1 for d in hbm if d.health == "Unhealthy") == 16
    r.note("healths", healths)
    r.note("hbm", [(d.id, d.health) for d in hbm])


def multi_container_chip_pod_spans_planned_chips(r):
    plugin = r.plugin()
    r.api.create_pod(chip_pod("mcchip", [0, 1, 2, 3], containers=[2, 2]))
    a1 = r.call(plugin.allocate_chips,
                ["tpushare-chip-00", "tpushare-chip-01"])
    assert alloc_view(r.s, a1)["visible"] == "0,1"
    assert not r.assigned("mcchip")
    a2 = r.call(plugin.allocate_chips,
                ["tpushare-chip-02", "tpushare-chip-03"])
    assert alloc_view(r.s, a2)["visible"] == "2,3"
    assert r.assigned("mcchip")
    return plugin


def concurrent_allocates_serialize(r):
    plugin = r.plugin()
    _mc_pod(r, [4, 4])
    results, errors = [], []

    def alloc():
        try:
            results.append(plugin.allocate_hbm(["x"] * 4))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=alloc) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert not errors and len(results) == 2
    assert r.assigned("mc") and plugin._partial == {}
    r.note("allocs", sorted(json.dumps(alloc_view(r.s, a), sort_keys=True)
                            for a in results))
    return plugin


def distributed_spec_rejects_out_of_range_rank(r):
    env = {const.ENV_POD_GROUP: "g", const.ENV_POD_GROUP_SIZE: "4",
           "JOB_COMPLETION_INDEX": "5"}
    if r.s is JAX:
        from tpushare.runtime import jaxenv as runtime
    else:
        runtime = torchenv
    with pytest.raises(ValueError, match="out of range"):
        runtime.distributed_spec(env)


def _runtime(r):
    if r.s is JAX:
        from tpushare.runtime import jaxenv
        return jaxenv
    return torchenv


def gang_pod_gets_distributed_env(r):
    plugin = r.plugin()
    r.api.create_pod(chip_pod("w-2", [0, 1, 2, 3], extra={
        const.ANN_POD_GROUP: "train", const.ANN_POD_GROUP_MIN: "4"}))
    alloc = r.call(plugin.allocate_chips,
                   [f"tpushare-chip-{i:02d}" for i in range(4)])
    assert alloc.envs[const.ENV_POD_GROUP] == "train"
    assert alloc.envs[const.ENV_POD_GROUP_SIZE] == "4"
    runtime = _runtime(r)
    env = dict(alloc.envs)
    env["JOB_COMPLETION_INDEX"] = "2"
    spec = runtime.distributed_spec(env)
    assert (spec.num_processes, spec.process_id) == (4, 2)
    assert spec.coordinator == "train-0.train:8476"
    env[const.ENV_COORDINATOR] = "coord:9999"
    assert runtime.distributed_spec(env).coordinator == "coord:9999"
    assert runtime.distributed_spec({"JOB_COMPLETION_INDEX": "0"}) is None
    return plugin


def allocation_grant_round_trips_through_the_runtime(r):
    plugin = r.plugin()
    r.api.create_pod(assumed("w", 12, [3], 1))
    alloc = r.call(plugin.allocate_hbm, ["x"] * 12)
    grant = _runtime(r).read_grant(dict(alloc.envs))
    assert grant.chip_ids == (3,)
    assert (grant.hbm_pod_gib, grant.hbm_chip_gib) == (12, 16)
    assert 0.0 < grant.mem_fraction < 1.0
    r.note("grant", [grant.chip_ids, grant.hbm_pod_gib, grant.hbm_chip_gib,
                     grant.mem_fraction, grant.whole_chips])
    return plugin


def batch_failed_commit_leaves_no_partial_state(r):
    failing = FailingCommit(r)
    plugin = r.plugin(client=failing)
    two_container_pod(r)
    assert isinstance(r.call(plugin.allocate_hbm_batch,
                             [["x"] * 8, ["x"] * 4]),
                      r.s.errors.ConflictError)
    assert plugin._partial == {}
    failing.failures = 0
    assert len(r.call(plugin.allocate_hbm_batch,
                      [["x"] * 8, ["x"] * 4])) == 2
    assert r.assigned("mc")
    return plugin


def batch_unmatchable_second_container_applies_nothing(r):
    plugin = r.plugin()
    two_container_pod(r)
    assert isinstance(r.call(plugin.allocate_hbm_batch,
                             [["x"] * 8, ["x"] * 5]),
                      r.s.plug.AllocateError)
    assert plugin._partial == {} and not r.assigned("mc")
    return plugin


def preferred_chip_follows_planned_annotation(r):
    plugin = r.plugin()
    r.api.create_pod(chip_pod("w", [2, 3]))
    ids = plugin.preferred_ids(const.CHIP_RESOURCE,
                               [f"tpushare-chip-{i:02d}" for i in range(4)],
                               2)
    assert ids == ["tpushare-chip-02", "tpushare-chip-03"]
    r.note("preferred", ids)
    return plugin


def preferred_hbm_lands_on_planned_chip(r):
    plugin = r.plugin()
    r.api.create_pod(assumed("w", 8, [3], 1))
    ids = plugin.preferred_ids(
        const.HBM_RESOURCE,
        [f"tpushare-hbm-{c:02d}-{g:03d}" for c in range(4)
         for g in range(16)], 8)
    assert len(ids) == 8
    assert all(i.startswith("tpushare-hbm-03-") for i in ids)
    r.note("preferred", ids)
    return plugin


def preferred_no_pending_pod_returns_empty(r):
    plugin = r.plugin()
    ids = plugin.preferred_ids(const.CHIP_RESOURCE, ["tpushare-chip-00"], 1)
    assert ids == []
    r.note("preferred", ids)
    return plugin


def per_container_retry_completes_commit(r):
    failing = FailingCommit(r, failures=0)
    plugin = r.plugin(client=failing)
    two_container_pod(r)
    r.call(plugin.allocate_hbm_batch, [["x"] * 8])
    assert list(plugin._partial.values()) == [[8]]
    failing.failures = 99
    assert isinstance(r.call(plugin.allocate_hbm_batch, [["x"] * 4]),
                      r.s.errors.ConflictError)
    assert list(plugin._partial.values()) == [[8]]
    failing.failures = 0
    r.call(plugin.allocate_hbm_batch, [["x"] * 4])
    assert plugin._partial == {} and r.assigned("mc")
    return plugin


def batch_never_commits_two_pods(r):
    plugin = r.plugin()
    r.api.create_pod(assumed("pa", 8, [0], 1))
    r.api.create_pod(assumed("pb", 8, [1], 2))
    assert isinstance(r.call(plugin.allocate_hbm_batch,
                             [["x"] * 8, ["x"] * 8]),
                      r.s.plug.AllocateError)
    assert not r.assigned("pa") and not r.assigned("pb")
    assert plugin._partial == {}
    r.call(plugin.allocate_hbm_batch, [["x"] * 8])
    r.call(plugin.allocate_hbm_batch, [["x"] * 8])
    assert r.assigned("pa") and r.assigned("pb")
    return plugin


def allocate_does_not_resurrect_pruned_partials(r):
    plugin = r.plugin()
    pod = two_container_pod(r)
    r.call(plugin.allocate_hbm_batch, [["x"] * 8])
    assert plugin._partial == {pod.uid: [8]}
    r.api.delete_pod("default", "mc")
    r.api.create_pod(assumed("other", 4, [1], 5))
    r.call(plugin.allocate_hbm_batch, [["x"] * 4])
    assert plugin._partial == {}
    return plugin


def preferred_ids_batch_advances_span_per_container(r):
    plugin = r.plugin()
    r.api.create_pod(chip_pod("w", [0, 1, 2, 3], containers=[2, 2]))
    all_ids = [f"tpushare-chip-{i:02d}" for i in range(4)]
    first, second = plugin.preferred_ids_batch(
        const.CHIP_RESOURCE,
        [(all_ids, 2), (["tpushare-chip-02", "tpushare-chip-03"], 2)])
    assert first == ["tpushare-chip-00", "tpushare-chip-01"]
    assert second == ["tpushare-chip-02", "tpushare-chip-03"]
    assert plugin._partial_chips == {}
    r.note("preferred", [first, second])
    return plugin


def checkpoint_restart_between_containers_serves_next_span(r):
    r.api.create_pod(chip_pod("mcchip", [0, 1, 2, 3], containers=[2, 2]))
    p1 = r.plugin(state_dir=r.state)
    a1 = r.call(p1.allocate_chips, ["tpushare-chip-00", "tpushare-chip-01"])
    assert alloc_view(r.s, a1)["visible"] == "0,1"
    p2 = r.plugin(create_node=False, state_dir=r.state)
    a2 = r.call(p2.allocate_chips, ["tpushare-chip-02", "tpushare-chip-03"])
    assert alloc_view(r.s, a2)["visible"] == "2,3"
    assert r.assigned("mcchip")
    return p2


def checkpoint_completed_pod_clears_it(r):
    r.api.create_pod(chip_pod("mcchip", [0, 1, 2, 3], containers=[2, 2]))
    p = r.plugin(state_dir=r.state)
    r.call(p.allocate_chips, ["tpushare-chip-00", "tpushare-chip-01"])
    r.call(p.allocate_chips, ["tpushare-chip-02", "tpushare-chip-03"])
    with open(os.path.join(r.state, "tpushare_grants.json"),
              encoding="utf-8") as f:
        assert json.load(f) == {"hbm": {}, "chips": {}}
    return p


def checkpoint_corrupt_starts_clean(r):
    with open(os.path.join(r.state, "tpushare_grants.json"), "w",
              encoding="utf-8") as f:
        f.write("{not json")
    p = r.plugin(state_dir=r.state)
    assert p._partial == {} and p._partial_chips == {}
    os.remove(os.path.join(r.state, "tpushare_grants.json"))
    return p


def checkpoint_pruned_pod_leaves_it(r):
    r.api.create_pod(chip_pod("mcchip", [0, 1, 2, 3], containers=[2, 2]))
    p = r.plugin(state_dir=r.state)
    r.call(p.allocate_chips, ["tpushare-chip-00", "tpushare-chip-01"])
    r.note("mid", json.loads(open(os.path.join(
        r.state, "tpushare_grants.json"), encoding="utf-8").read()))
    r.api.delete_pod("default", "mcchip")
    r.api.create_pod(chip_pod("fresh", [2], assume="2"))
    r.call(p.allocate_chips, ["tpushare-chip-02"])
    with open(os.path.join(r.state, "tpushare_grants.json"),
              encoding="utf-8") as f:
        assert json.load(f)["chips"] == {}
    return p


SCENARIOS = [
    hbm_device_advertisement, health_tracks_device_nodes,
    annotate_node_publishes_capacities,
    allocate_hbm_matches_earliest_assume_time,
    allocate_hbm_ignores_other_nodes_and_sizes,
    allocate_hbm_skips_already_assigned,
    allocate_hbm_never_consumes_whole_chip_pod,
    whole_chip_allocation_no_mem_fraction,
    chip_allocation_without_extender_pod,
    multi_container_commit_on_last,
    multi_container_pod_total_does_not_match,
    multi_container_partial_pruned_when_pod_deleted,
    multi_container_unequal_matched_by_size,
    health_flips_unhealthy_when_device_vanishes,
    multi_container_chip_pod_spans_planned_chips,
    concurrent_allocates_serialize,
    distributed_spec_rejects_out_of_range_rank,
    gang_pod_gets_distributed_env,
    allocation_grant_round_trips_through_the_runtime,
    batch_failed_commit_leaves_no_partial_state,
    batch_unmatchable_second_container_applies_nothing,
    preferred_chip_follows_planned_annotation,
    preferred_hbm_lands_on_planned_chip,
    preferred_no_pending_pod_returns_empty,
    per_container_retry_completes_commit,
    batch_never_commits_two_pods,
    allocate_does_not_resurrect_pruned_partials,
    preferred_ids_batch_advances_span_per_container,
    checkpoint_restart_between_containers_serves_next_span,
    checkpoint_completed_pod_clears_it,
    checkpoint_corrupt_starts_clean,
    checkpoint_pruned_pod_leaves_it,
]


def run_both(scenario, tmp_path) -> tuple[list, list]:
    shared = tmp_path / "shared"
    (shared / "devfs").mkdir(parents=True)
    records = []
    for side in SIDES:
        root = tmp_path / side.name
        root.mkdir()
        r = Run(side, root, shared)
        plugin = scenario(r)
        records.append(r.finish(plugin))
    return tuple(records)


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_daemon_matches_the_reference(scenario, tmp_path):
    want, got = run_both(scenario, tmp_path)
    assert got == want


# --------------------------------------------------------------------------
# The partial-grant checkpoint read across, both ways
# --------------------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [(JAX, TORCH), (TORCH, JAX)],
                         ids=["jax_to_torch", "torch_to_jax"])
@pytest.mark.parametrize("resource", ["chips", "hbm"])
def test_checkpoint_restarts_the_other_plugin(tmp_path, writer, reader,
                                              resource):
    """A checkpoint one plugin wrote between a pod's two containers
    restarts the other, which serves the next container and commits."""
    state = tmp_path / "state"
    state.mkdir()
    devfs = tmp_path / "devfs"
    devfs.mkdir()
    usage = str(tmp_path / "usage")
    served = []
    for side in (writer, reader):
        api = side.Fake()
        api.create_node(make_node(NODE, chips=CHIPS, hbm_per_chip=GIB))
        if resource == "chips":
            api.create_pod(chip_pod("mc", [0, 1, 2, 3], containers=[2, 2]))
        else:
            api.create_pod(make_pod(
                "mc", container_hbm=[4, 6], node_name=NODE, uid="uid-mc",
                annotations={const.ANN_CHIP_IDX: "1",
                             const.ANN_HBM_POD: "10",
                             const.ANN_HBM_CHIP: str(GIB),
                             const.ANN_ASSIGNED: const.ASSIGNED_FALSE,
                             const.ANN_ASSUME_TIME: "1"}))
        plugin = side.plugin(api, side.inventory(), str(devfs),
                             state_dir=str(state), usage_dir=usage)
        if side is writer:
            if resource == "chips":
                alloc = plugin.allocate_chips(["tpushare-chip-00",
                                               "tpushare-chip-01"])
            else:
                alloc = plugin.allocate_hbm(["x"] * 4)
            with open(state / "tpushare_grants.json", encoding="utf-8") as f:
                doc = json.load(f)
            uid = api.get_pod("default", "mc").uid
            assert doc == ({"hbm": {}, "chips": {uid: [2]}}
                           if resource == "chips"
                           else {"hbm": {uid: [4]}, "chips": {}})
        else:
            assert (plugin._partial_chips if resource == "chips"
                    else plugin._partial) == doc[resource]
            if resource == "chips":
                alloc = plugin.allocate_chips(["tpushare-chip-00",
                                               "tpushare-chip-01"])
            else:
                assert plugin.preferred_ids(
                    const.HBM_RESOURCE,
                    [f"tpushare-hbm-{c:02d}-{g:03d}" for c in range(4)
                     for g in range(GIB)], 6)[0] == "tpushare-hbm-01-000"
                alloc = plugin.allocate_hbm(["x"] * 6)
            assert api.get_pod("default", "mc").annotations[
                const.ANN_ASSIGNED] == const.ASSIGNED_TRUE
            with open(state / "tpushare_grants.json", encoding="utf-8") as f:
                assert json.load(f) == {"hbm": {}, "chips": {}}
        served.append(alloc_view(side, alloc))
    if resource == "chips":
        # The reader serves the span after the writer's, not span 0 again.
        assert [v["visible"] for v in served] == ["0,1", "2,3"]
    else:
        assert [v["tpushare"][const.ENV_HBM_POD] for v in served] == [
            "4", "6"]


# --------------------------------------------------------------------------
# The port's own pieces against the reference's
# --------------------------------------------------------------------------

POD_DOCS = [
    make_pod("a", hbm=8, node_name=NODE, phase="Running", annotations={
        const.ANN_CHIP_IDX: "1,3", const.ANN_HBM_POD: "8",
        const.ANN_ASSIGNED: const.ASSIGNED_TRUE,
        const.ANN_ASSUME_TIME: "17", const.ANN_POD_GROUP: "g",
        const.ANN_POD_GROUP_MIN: "3"}),
    make_pod("b", chips=2, annotations={const.ANN_CHIP_IDX: "x",
                                        const.ANN_HBM_POD: "-4",
                                        const.ANN_ASSUME_TIME: "soon",
                                        const.ANN_POD_GROUP: "g",
                                        const.ANN_POD_GROUP_MIN: "y"}),
    make_pod("c", container_hbm=[2, 6], phase="Succeeded", node_name=NODE,
             annotations={const.ANN_HBM_POD: "8"}),
    make_pod("d", hbm=4, node_name=NODE, phase="Running",
             annotations={const.ANN_CHIP_IDX: "", const.ANN_HBM_POD: "4",
                          const.ANN_ASSIGNED: const.ASSIGNED_FALSE}),
    {**make_pod("e", hbm=4, node_name=NODE, phase="Running",
                annotations={const.ANN_HBM_POD: "4"}),
     "metadata": {"name": "e", "namespace": "ns",
                  "deletionTimestamp": "2026-01-01T00:00:00Z",
                  "annotations": {const.ANN_HBM_POD: "4"}}},
    {"metadata": {"name": "f"}, "spec": {"containers": [
        {"name": "m", "resources": {"limits": {
            const.HBM_RESOURCE: "16Gi", const.CHIP_RESOURCE: "500m"}}}]}},
]

HELPERS = ("get_assume_time", "get_chip_ids_from_annotation",
           "get_chips_from_pod_resource", "get_hbm_from_pod_annotation",
           "get_hbm_from_pod_resource", "get_pod_group", "is_assigned",
           "is_assigned_non_terminated", "is_assumed", "is_complete_pod",
           "is_tpu_chip_pod", "pod_used_hbm")


@pytest.mark.parametrize("helper", HELPERS)
def test_pod_helpers_match_the_reference(helper):
    from tpushare.api.objects import Pod as JPod
    from tpushare.utils import pod as jpod

    for doc in POD_DOCS:
        assert getattr(podutils, helper)(Pod(json.loads(json.dumps(doc)))) \
            == getattr(jpod, helper)(JPod(json.loads(json.dumps(doc)))), (
                helper, doc["metadata"]["name"])


def test_const_names_are_the_reference_s():
    from tpushare.utils import const as jconst

    names = [n for n in dir(const) if n.isupper()
             and not n.startswith("ENV_NVIDIA")
             and not n.startswith("ENV_CUDA")]
    assert {"HBM_RESOURCE", "CHIP_RESOURCE", "ANN_ASSIGNED", "ASSIGNED_TRUE",
            "ANN_HBM_POD", "ANN_HBM_CHIP", "ANN_ASSUME_TIME", "ANN_HBM_USED",
            "ANN_OVERRUN", "ANN_NODE_CHIP_HBM", "ANN_NODE_TOPOLOGY",
            "ANN_NODE_TPU_TYPE", "ANN_NODE_SLICE", "ANN_POD_GROUP",
            "ANN_POD_GROUP_MIN"} <= set(names)
    for name in names:
        assert getattr(const, name) == getattr(jconst, name), name


def test_commit_refuses_a_blind_write():
    api = TORCH.Fake()
    with pytest.raises(commit.PreconditionError):
        commit.committed_update_pod(api, Pod({"metadata": {"name": "p"}}))
    with pytest.raises(commit.PreconditionError):
        commit.committed_update_pod(api, Pod({"metadata": {
            "name": "p", "resourceVersion": "3"}}))
    with pytest.raises(commit.PreconditionError):
        commit.committed_update_node(api, Node({"metadata": {"name": "n"}}))
    stale = api.create_pod(make_pod("p"))
    commit.committed_update_pod(api, api.get_pod("default", "p"))
    with pytest.raises(TORCH.errors.ConflictError):
        commit.committed_update_pod(api, stale)


@pytest.mark.parametrize("caps", [
    {}, {"max_concurrent": 1}, {"per_hour": 2}, {"node_cooldown_s": 10.0}])
def test_eviction_budget_matches_the_reference(caps):
    from tpushare.k8s import eviction as JEvict

    clock = [0.0]
    budgets = [m.EvictionBudget(now=lambda: clock[0], **caps)
               for m in (JEvict, TEvict)]
    steps = [("acquire", "a"), ("acquire", "a"), ("release", "a", True),
             ("acquire", "a"), ("release", "a", False), ("tick", 5.0),
             ("acquire", "b"), ("release", "b", True), ("acquire", "a"),
             ("tick", 4000.0), ("acquire", "a"), ("acquire", "b")]
    seen = []
    for step in steps:
        if step[0] == "tick":
            clock[0] += step[1]
            continue
        out = [getattr(b, step[0])(*step[1:]) for b in budgets]
        seen.append(out[0])
        assert out[0] == out[1], (step, out)
    assert set(seen) - {None} <= {"", "concurrent", "moves-per-hour",
                                  "node-cooldown"}


# --------------------------------------------------------------------------
# The shared extender schedules onto a node the port's daemon annotated
# --------------------------------------------------------------------------

class Bridge:
    """The port's client over the JAX fake apiserver: raw documents pass
    through, each side sees only its own object types."""

    def __init__(self, api):
        self.api = api

    def get_node(self, name):
        node = self.api.get_node(name)
        return Node(node.raw) if node is not None else None

    def update_node(self, node):
        from tpushare.api.objects import Node as JNode
        return Node(self.api.update_node(JNode(node.raw)).raw)

    def list_pods(self, node_name=None):
        return [Pod(p.raw) for p in self.api.list_pods(node_name=node_name)]

    def get_pod(self, namespace, name):
        return Pod(self.api.get_pod(namespace, name).raw)

    def update_pod(self, pod):
        from tpushare.api.objects import Pod as JPod
        return Pod(self.api.update_pod(JPod(pod.raw)).raw)


def test_shared_extender_schedules_an_nvidia_node(tmp_path):
    """The port's daemon annotates an H100 node; the JAX extender's filter
    and bind verbs place a 7 GiB pod on it; the port's plugin matches and
    commits that pod in Allocate; the JAX cache counts it assigned on the
    card it was bound to."""
    from tests.test_e2e import Cluster
    from tpushare.k8s.fake import FakeApiServer

    api = FakeApiServer()
    api.create_node({"apiVersion": "v1", "kind": "Node",
                     "metadata": {"name": "h100-node"},
                     "status": {"capacity": {const.HBM_RESOURCE: "158",
                                             const.CHIP_RESOURCE: "2"},
                                "allocatable": {const.HBM_RESOURCE: "158",
                                                const.CHIP_RESOURCE: "2"}}})
    devfs = tmp_path / "devfs"
    devfs.mkdir()
    plugin = TORCH.plug.TPUSharePlugin(
        "h100-node", Bridge(api), TORCH.disc.fake_inventory(chips=2),
        state_dir=str(tmp_path), usage_dir=str(tmp_path / "usage"),
        devfs_root=str(devfs))
    plugin.annotate_node()
    ann = api.get_node("h100-node").annotations
    assert ann[const.ANN_NODE_CHIP_HBM] == "79,79"
    assert ann[const.ANN_NODE_TPU_TYPE] == "h100-80gb"
    assert const.ANN_NODE_TOPOLOGY not in ann

    cluster = Cluster(api)
    try:
        doc = make_pod("llm", hbm=7)
        created = api.create_pod(doc)
        bound, where = cluster.schedule(doc)
        assert bound and where == "h100-node", where
        pod = api.get_pod("default", "llm")
        assert pod.node_name == "h100-node"
        chip = int(pod.annotations[const.ANN_CHIP_IDX])
        assert pod.annotations[const.ANN_ASSIGNED] == const.ASSIGNED_FALSE
        assert pod.annotations[const.ANN_HBM_CHIP] == "79"

        avail = [f"tpushare-hbm-{c:02d}-{g:03d}" for c in range(2)
                 for g in range(79)]
        ids = plugin.preferred_ids(const.HBM_RESOURCE, avail, 7)
        assert len(ids) == 7
        assert all(i.startswith(f"tpushare-hbm-{chip:02d}-") for i in ids)
        alloc = plugin.allocate_hbm(ids)
        assert alloc.envs[const.ENV_CHIP_IDX] == str(chip)
        assert alloc.envs[const.ENV_NVIDIA_VISIBLE_DEVICES] == str(chip)
        assert alloc.envs[const.ENV_CUDA_VISIBLE_DEVICES] == "0"
        assert api.get_pod("default", "llm").annotations[
            const.ANN_ASSIGNED] == const.ASSIGNED_TRUE

        # The running extender's ledger holds the pod on that card; an
        # extender that rebuilds its cache from the apiserver (as on a
        # restart) reads the committed flag too.
        assert cluster.controller.cache.get_node_info("h100-node").chips[
            chip].pods[created.uid].name == "llm"
        assert cluster.inspect("h100-node")["nodes"][0]["chips"][chip][
            "usedHBM"] == 7
        from tpushare.cache.cache import SchedulerCache

        rebuilt = SchedulerCache(api.get_node, api.list_pods)
        rebuilt.build()
        held = rebuilt.get_node_info("h100-node").chips[chip].pods
        assert held[created.uid].annotations[const.ANN_ASSIGNED] == \
            const.ASSIGNED_TRUE
        assert rebuilt.get_node_info("h100-node").get_available_hbm() == {
            chip: 72, 1 - chip: 79}
    finally:
        cluster.close()
