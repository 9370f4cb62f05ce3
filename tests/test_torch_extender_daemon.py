"""The system's own path on the port alone: the port's scheduler
extender places a pod on a node the port's daemon annotated, and the
port's daemon commits that pod in Allocate.

``tests/torch_extender_daemon_side.py`` runs in a process that refuses
any import of ``tpushare`` or ``jax``; its outcome must carry the facts
``test_shared_extender_schedules_an_nvidia_node`` asserts of the JAX
extender, and equal the outcome of the same scenario with the JAX
package's stack in this process.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

from tests.test_torch_deviceplugin_daemon import Bridge
from tests.torch_extender_daemon_side import scenario
from tests.torch_obs_reset import fresh_port_obs  # noqa: F401
from tpushare_torch.utils import const

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_alone(workdir) -> dict:
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests",
                                      "torch_extender_daemon_side.py"),
         str(workdir)], env=env, cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def check_outcome(out: dict) -> None:
    """What ``test_shared_extender_schedules_an_nvidia_node`` asserts."""
    assert out["node_annotations"][const.ANN_NODE_CHIP_HBM] == "79,79"
    assert out["node_annotations"][const.ANN_NODE_TPU_TYPE] == "h100-80gb"
    assert const.ANN_NODE_TOPOLOGY not in out["node_annotations"]
    assert out["filter"]["NodeNames"] == ["h100-node"]
    assert out["bind"] == {"Error": ""}
    assert out["node"] == "h100-node"
    chip = out["chip"]
    assert out["bound_annotations"][const.ANN_ASSIGNED] == \
        const.ASSIGNED_FALSE
    assert out["bound_annotations"][const.ANN_HBM_CHIP] == "79"
    assert out["bound_annotations"][const.ANN_HBM_POD] == "7"
    assert len(out["preferred"]) == 7
    assert all(i.startswith(f"tpushare-hbm-{chip:02d}-")
               for i in out["preferred"])
    assert out["envs"][const.ENV_CHIP_IDX] == str(chip)
    assert out["envs"][const.ENV_NVIDIA_VISIBLE_DEVICES] == str(chip)
    assert out["envs"][const.ENV_CUDA_VISIBLE_DEVICES] == "0"
    assert out["assigned"] == const.ASSIGNED_TRUE
    assert out["ledger_holds"] == "llm"
    assert out["inspect_used"][chip] == 7
    assert out["rebuilt_assigned"] == const.ASSIGNED_TRUE
    assert out["rebuilt_avail"] == {str(chip): 72, str(1 - chip): 79}


def test_port_extender_places_what_the_port_daemon_commits(tmp_path):
    out = port_alone(tmp_path / "port")
    assert out.pop("loaded") == []
    check_outcome(out)


def test_same_outcome_as_the_jax_extender(tmp_path):
    from tpushare.cache.cache import SchedulerCache
    from tpushare.cmd import main as jmain
    from tpushare.k8s.fake import FakeApiServer

    os.makedirs(tmp_path / "jax")
    api = FakeApiServer()
    want = scenario(api, jmain, SchedulerCache, Bridge(api),
                    str(tmp_path / "jax"))
    check_outcome(want)
    got = port_alone(tmp_path / "port")
    got.pop("loaded")
    assert got == want
