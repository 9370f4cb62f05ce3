"""The port's black-box flight journal and push exporter
(``tpushare_torch/obs/blackbox.py``, ``obs/export.py``, and where the
port's extender arms, feeds, flushes and replays them) against the JAX
package's.

* The reference's stories of ``tests/test_blackbox.py``, every one, over
  the port's modules (``tests/torch_reference_stories.py``): frames and
  rotation, a restart opening a new segment, a torn tail, the
  fire-and-forget intake, a flush that cannot wedge, the defaults and
  snapshot, the exporter's backoff, stall, batches, bounded queue and
  shutdown, the ``traceparent`` boundary and the port main's signal
  contract (``setup_signals(stop, flush=)``).
* A journal either package writes is the other's, frame for frame: the
  same seeded records written by both give the same segment files byte
  for byte, and each package replays the other's.
* ``replay_startup`` over a journal written by either package's
  ``obs`` (markers, samples, a completed decision): both packages put
  back the same markers, the same ``restart`` boundary, the same
  restored decision and the same count.
* The reference's crash story (``tests/test_crash_forensics.py``) over
  ``python -m tpushare_torch.cmd.main`` and ``tests/miniapiserver.py``: a
  real bind, a real SIGKILL, and a second process that serves the first
  one's markers behind a ``restart`` marker and resolves its bind
  decision, tagged ``restored``. Its second case: a journaled bind
  decision, restored after a simulated crash, is the causal parent of the
  port's defrag planner's move of that pod.
"""

from __future__ import annotations

import importlib
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from tests import torch_reference_stories as R
from tests.torch_obs_reset import fresh_port_obs  # noqa: F401
from tpushare import obs as jobs
from tpushare import trace as jtrace
from tpushare_torch import obs as tobs
from tpushare_torch import trace as ttrace

jblackbox = importlib.import_module("tpushare.obs.blackbox")
tblackbox = importlib.import_module("tpushare_torch.obs.blackbox")

# -- the reference's stories over the port ------------------------------------ #

_STORIES = R.load("test_blackbox")
globals().update({name: getattr(_STORIES, name) for name in dir(_STORIES)
                  if name.startswith("test_") or name == "_fresh_trace"})


def test_journal_constants_are_the_reference_s():
    for name in ("DEFAULT_SEGMENT_BYTES", "DEFAULT_MAX_SEGMENTS",
                 "QUEUE_DEPTH", "MAX_FRAME_BYTES", "_SEGMENT_PREFIX",
                 "_SEGMENT_SUFFIX"):
        assert getattr(tblackbox, name) == getattr(jblackbox, name), name
    assert tblackbox._FRAME.format == jblackbox._FRAME.format


# -- the same journal, frame for frame ----------------------------------------- #

def _records(seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    kinds = ("marker", "sample", "decision")
    out = []
    for i in range(int(rng.integers(40, 160))):
        kind = str(rng.choice(kinds))
        doc = {"t": kind, "ts": 1.7e9 + float(rng.random()) * 1e3}
        if kind == "marker":
            doc.update(cursor=i, kind="config", detail=f"m{i} é",
                       attrs={"k": str(int(rng.integers(9)))})
        elif kind == "sample":
            doc["series"] = {f"s{j}": float(rng.normal())
                             for j in range(int(rng.integers(1, 6)))}
        else:
            doc["doc"] = {"traceId": f"{i:012x}", "outcome": "bound",
                          "pad": "x" * int(rng.integers(0, 400))}
        out.append(doc)
    return out


def _write(mod, directory: str, docs: list[dict]) -> None:
    journal = mod.BlackboxJournal(directory, segment_bytes=2048,
                                  max_segments=4)
    journal.start()
    for doc in docs:
        journal.append(doc)
    assert journal.flush(timeout=5.0)
    journal.stop()


def _files(directory: str) -> dict[str, bytes]:
    out = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("seed", range(3))
def test_journals_are_byte_identical_and_cross_replay(tmp_path, seed):
    docs = _records(seed)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    _write(jblackbox, jdir, docs)
    _write(tblackbox, tdir, docs)
    assert _files(tdir) == _files(jdir)
    assert len(_files(tdir)) > 1  # the journal rotated
    tail = jblackbox.replay(jdir)
    assert tail and tail == docs[-len(tail):]
    assert tblackbox.replay(jdir) == tail
    assert jblackbox.replay(tdir) == tblackbox.replay(tdir) == tail
    # A torn tail ends the story at the same frame in both readers.
    last = [p for p in jblackbox.list_segments(jdir)
            if os.path.getsize(p) > 16][-1]
    with open(last, "r+b") as f:
        f.truncate(os.path.getsize(last) - 3)
    assert tblackbox.replay(jdir) == jblackbox.replay(jdir)


# -- replay_startup over either package's journal ------------------------------ #

_PACKAGES = {"jax": (jobs, jtrace), "port": (tobs, ttrace)}


def _journal_story(obs, trace, directory: str, monkeypatch) -> str:
    """What one package's extender leaves in its journal: markers, a
    tick's samples and a completed bind decision. Returns its id."""
    monkeypatch.setenv("TPUSHARE_BLACKBOX_DIR", directory)
    obs.reset()
    trace.reset()
    obs.set_clock(lambda: 1.7e9)
    try:
        obs._arm_blackbox()
        obs.mark("leader", "acquired leadership", identity="replica-a")
        obs.mark("config", "quota ConfigMap kube-system/tpushare-quotas "
                 "applied", configmap="quota")
        obs.timeline().record("fleet_nodes", 3.0, ts=1.7e9)
        obs.timeline().record("fleet_nodes_ready", 2.0, ts=1.7e9)
        obs._journal_tick(1.7e9)
        with trace.phase("bind", "default", "p-0", "uid-0") as dec:
            trace.note("hbmGiB", 7)
        trace.complete(dec, "bound", node="n1")
        obs.mark("node-notready", "node n2 NotReady", node="n2")
        assert obs.flush_blackbox()
    finally:
        obs.reset()
        trace.reset()
    return dec.trace_id


def _replayed(obs, trace, directory: str, trace_id: str,
              monkeypatch) -> tuple:
    monkeypatch.setenv("TPUSHARE_BLACKBOX_DIR", directory)
    obs.reset()
    trace.reset()
    try:
        count = obs.replay_startup()
        assert obs.replay_startup() == 0  # once a process
        markers = [(m["kind"], m["detail"], m["attrs"])
                   for m in obs.snapshot()["markers"]]
        series = {name: doc["tier0"]
                  for name, doc in obs.snapshot()["series"].items()}
        chain = trace.causal_chain(trace_id)
        target = {k: v for k, v in chain["target"].items()
                  if not k.lower().endswith("seconds")}
        return count, markers, series, target, \
            obs.blackbox_snapshot()["replayed"]
    finally:
        obs.reset()
        trace.reset()


@pytest.mark.parametrize("writer", sorted(_PACKAGES))
def test_replay_startup_restores_alike(tmp_path, monkeypatch, writer):
    written = str(tmp_path / "written")
    trace_id = _journal_story(*_PACKAGES[writer], written, monkeypatch)
    got = {}
    for name, (obs, trace) in _PACKAGES.items():
        copy = str(tmp_path / name)
        shutil.copytree(written, copy)
        got[name] = _replayed(obs, trace, copy, trace_id, monkeypatch)
    assert got["port"] == got["jax"]
    count, markers, _series, target, replayed = got["port"]
    assert count == 5 and replayed is True
    assert markers[-1] == ("restart", "replayed 5 journal records",
                           {"replayed": "5"})
    assert target["restored"] is True and target["outcome"] == "bound"


# -- the crash story over the port's process ----------------------------------- #

_CRASH = R.load("test_crash_forensics")
_fresh = _CRASH._fresh


def _spawn(port: int, kubeconfig: str, journal_dir: str):
    """The story's ``_spawn``, starting the port's extender."""
    env = dict(os.environ)
    env.update({"KUBECONFIG": kubeconfig, "PORT": str(port),
                "WORKERS": "2", "LOG_LEVEL": "error",
                "TPUSHARE_BLACKBOX_DIR": journal_dir})
    env.pop("TPUSHARE_EXPORT_URL", None)
    return subprocess.Popen(
        [sys.executable, "-m", "tpushare_torch.cmd.main"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)


_CRASH._spawn = _spawn
test_sigkill_restart_replays_precrash_story = \
    _CRASH.test_sigkill_restart_replays_precrash_story
test_defrag_move_resolves_restored_bind_across_restart = \
    _CRASH.test_defrag_move_resolves_restored_bind_across_restart
