"""The port's gang reaper against the JAX package's, on the CPU.

The reaper cases of ``tests/test_controller.py`` (``TestGangReaper``,
``:302``-``:409``), each run on both packages' controllers over their
own fake apiservers with the same documents: three members of a
committed gang (whole v5p hosts, ``pod-group-min`` 3) run on three
hosts, one dies, and the record (which pods are left, each host's free
cards, the ``TPUShareGangReaped`` Events, and how far each package's
``tpushare_gangs_reaped_total`` rose) must be equal on both sides,
besides each case's own assertions. Tolerance: exact. The Events are
compared whole: the reaper runs on the controller's thread, which holds
no decision, so neither side's carries a ``[trace ...]`` suffix.
"""

from __future__ import annotations

import time

import pytest

from tests.torch_obs_reset import fresh_port_obs  # noqa: F401
from tpushare.controller.controller import Controller as JController
from tpushare.k8s import events as jevents
from tpushare.k8s.builders import make_node, make_pod
from tpushare.k8s.errors import NotFoundError as JNotFound
from tpushare.k8s.fake import FakeApiServer as JFake
from tpushare.routes import metrics as jmetrics
from tpushare_torch.api.objects import Pod
from tpushare_torch.controller.controller import Controller as TController
from tpushare_torch.k8s import events as tevents
from tpushare_torch.k8s.errors import NotFoundError as TNotFound
from tpushare_torch.k8s.fake import FakeApiServer as TFake
from tpushare_torch.routes import metrics as tmetrics
from tpushare_torch.utils import const
from tpushare_torch.utils import pod as podutils

HOSTS = ("host-0", "host-1", "host-2")


def _jax_reaped() -> float:
    return jmetrics.REGISTRY.get_sample_value("tpushare_gangs_reaped_total")


class Side:
    def __init__(self, fake, controller, events, not_found, reaped):
        self.api = fake()
        self.controller_cls = controller
        self.events = events
        self.NotFound = not_found
        #: The package's reap count, and its value before the case.
        self.reaped = reaped
        self.reaped0 = reaped()
        for n in HOSTS:
            self.api.create_node(make_node(n, chips=4, hbm_per_chip=95,
                                           topology="2x2x1", tpu_type="v5p"))

    def gang_pod(self, name, node, minimum="3", extra=None,
                 group="trainjob"):
        """A member the planner committed: granted all four cards of
        ``node`` and bound there, running."""
        ann = {const.ANN_POD_GROUP: group,
               const.ANN_POD_GROUP_MIN: minimum, **(extra or {})}
        pod = Pod(make_pod(name, chips=4, phase="Running", annotations=ann,
                           uid=f"uid-{name}"))
        pod = podutils.updated_pod_annotation_spec(pod, [0, 1, 2, 3], 380,
                                                   95, assume_time_ns=1)
        pod.raw["spec"]["nodeName"] = node
        return self.api.create_pod(pod.raw)

    def start(self, **kw):
        self.c = self.controller_cls(self.api, **kw)
        self.c.start(workers=2)

    def alive(self, name):
        try:
            self.api.get_pod("default", name)
            return True
        except self.NotFound:
            return False

    def wait_gone(self, names, timeout=5.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if not any(self.alive(n) for n in names):
                return True
            time.sleep(0.02)
        return False

    def record(self, names):
        assert self.c.wait_idle()
        time.sleep(0.1)  # let every queued delete drain
        assert self.c.wait_idle()
        assert self.events.flush()
        return ({n: self.alive(n) for n in names},
                {h: len(self.c.cache.get_node_info(h).get_free_chips())
                 for h in HOSTS},
                sorted((e["involvedObject"]["name"], e["reason"],
                        e["message"], e["type"])
                       for _, e in self.api.events),
                self.reaped() - self.reaped0)


def case_evicted_member_reaps_survivors(side):
    for i in range(3):
        side.gang_pod(f"m{i}", HOSTS[i])
    side.start()
    side.api.delete_pod("default", "m0")  # eviction mid-run
    assert side.wait_gone(["m1", "m2"]), "survivors below quorum stay"
    rec = side.record(["m0", "m1", "m2"])
    assert rec[1] == {h: 4 for h in HOSTS}  # their cards are free again
    assert [e[1] for e in rec[2]] == [const_reaped()] * 2
    assert rec[3] == 1  # one gang reaped
    return rec


def case_completed_member_never_reaps(side):
    for i in range(3):
        side.gang_pod(f"m{i}", HOSTS[i])
    side.start()
    side.api.update_pod_status("default", "m0", "Succeeded")
    assert side.c.wait_idle()
    side.api.delete_pod("default", "m0")  # GC of a finished pod
    rec = side.record(["m1", "m2"])
    assert rec[0] == {"m1": True, "m2": True} and rec[2] == []
    return rec


def case_above_quorum_survivors_spared(side):
    for i in range(3):
        side.gang_pod(f"m{i}", HOSTS[i], minimum="2")
    side.start()
    side.api.delete_pod("default", "m0")
    rec = side.record(["m1", "m2"])
    assert rec[0] == {"m1": True, "m2": True}
    return rec


def case_reap_opt_out(side):
    for i in range(3):
        side.gang_pod(f"m{i}", HOSTS[i],
                      extra={const.ANN_POD_GROUP_REAP: "false"})
    side.start()
    side.api.delete_pod("default", "m0")
    rec = side.record(["m1", "m2"])
    assert rec[0] == {"m1": True, "m2": True} and rec[2] == []
    return rec


def case_reap_does_not_cascade_to_replacements(side):
    for i in range(3):
        side.gang_pod(f"m{i}", HOSTS[i])
    side.start()
    side.api.delete_pod("default", "m0")
    assert side.wait_gone(["m1", "m2"])
    # The owner recreates all three: fresh, not yet scheduled.
    for i in range(3):
        side.api.create_pod(make_pod(
            f"m{i}-new", chips=4, uid=f"uid-m{i}-new",
            annotations={const.ANN_POD_GROUP: "trainjob",
                         const.ANN_POD_GROUP_MIN: "3"}))
    rec = side.record([f"m{i}-new" for i in range(3)])
    assert all(rec[0].values())
    return rec


def case_follower_replica_never_reaps(side):
    for i in range(3):
        side.gang_pod(f"m{i}", HOSTS[i])
    side.start(is_leader=lambda: False)
    side.api.delete_pod("default", "m0")
    rec = side.record(["m1", "m2"])
    assert rec[0] == {"m1": True, "m2": True} and rec[2] == []
    return rec


def const_reaped():
    return tevents.REASON_GANG_REAPED


CASES = [case_evicted_member_reaps_survivors,
         case_completed_member_never_reaps,
         case_above_quorum_survivors_spared, case_reap_opt_out,
         case_reap_does_not_cascade_to_replacements,
         case_follower_replica_never_reaps]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_reaper_case_matches_the_reference(case):
    records = []
    for side in (Side(JFake, JController, jevents, JNotFound, _jax_reaped),
                 Side(TFake, TController, tevents, TNotFound,
                      tmetrics.GANGS_REAPED.get)):
        try:
            records.append(case(side))
        finally:
            if hasattr(side, "c"):
                side.c.stop()
    assert records[1] == records[0]
