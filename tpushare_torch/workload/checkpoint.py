"""Workload checkpoint / resume (``torch.distributed.checkpoint``-backed).

The scheduler side of the framework is checkpoint-free by design (the
kube-apiserver is its store — reference cache.go:49-74); the workload
side needs real checkpoints: an HBM-sharing inference pod or a
gang-scheduled training job must survive preemption and resume on a
possibly different chip/slice. ``torch.distributed.checkpoint`` (DCP)
handles the sharded-tensor plumbing: saving from a dp×tp×sp mesh and
restoring onto a DIFFERENT mesh shape works because restore reads the
target mesh's slices of each global tensor.

Layout: ``<dir>/<step>/`` per step, DCP-managed, with retention.

Defrag interaction (docs/defrag.md): while a save is in flight, set the
``tpushare.io/checkpoint-in-flight: "true"`` annotation on your own pod
(and clear it after ``wait``) — the scheduler's rebalance planner never
proposes moving a pod mid-checkpoint, so a defrag eviction cannot land
between ``save`` and durability and cost both the checkpoint and the
progress since the previous one.

Port of ``tpushare/workload/checkpoint.py`` (orbax). What orbax does
for the JAX package, done here explicitly:

* **Shards are written as global tensors.** Each rank's tp shard of a
  weight and of its two AdamW moments is a DTensor view
  (``parallel.global_view``) of the global tensor, so each rank writes
  only its slice, dp and sp replicas are written once, and a restore on
  any mesh (or in one process) reads the slices it holds. A plain tensor
  saved by many ranks would be taken for a replica, and a tp shard lost.
* **The snapshot is taken before ``save`` returns.** The train step
  updates its parameters and optimizer in place, so ``save`` copies them
  to host memory first; the write then drains in a background thread
  while training goes on.
* **A step is committed by a rename.** Every rank writes into
  ``<dir>/<step>.partial``; once every rank's part is written (DCP's
  last collective), rank 0 renames it to ``<dir>/<step>``, prunes past
  ``max_to_keep``, and the ranks meet at a barrier. A save killed midway
  leaves no ``<dir>/<step>``, so ``latest_step`` stays at the previous
  step.
* **The optimizer's state is materialized on restore.** AdamW creates
  ``step`` and its moments at its first step; ``restore`` fills a fresh
  optimizer's (``get_optimizer_state_dict`` creates them) so the next
  update bias-corrects from the restored ``step``. The optimizer's
  hyperparameters are the target's own, as optax's live in its code.

A checkpoint's collectives run on a gloo group of their own, on host
tensors: gloo cannot send CUDA tensors, and a group apart keeps the
background write's collectives from interleaving with training's.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import shutil
import threading
import time

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint.state_dict import (
    get_optimizer_state_dict, set_optimizer_state_dict)
from torch.distributed.tensor import DTensor

from tpushare_torch.workload import parallel as par

log = logging.getLogger(__name__)

#: Suffix of the directory a step is written into before its commit.
PARTIAL = ".partial"


@dataclasses.dataclass
class CheckpointConfig:
    directory: str
    max_to_keep: int = 3
    save_interval_steps: int = 1


class Checkpointer:
    """Save/restore (params, opt_state, step) with retention.

    ``params`` is a ``model.Transformer`` (this rank's tp shard of it
    under ``mesh``) and ``opt_state`` the optimizer over its parameters,
    as ``train.make_train_step``'s ``init_fn`` returns them. Every rank of
    the gang builds the Checkpointer with its :class:`parallel.Mesh`
    (building it is a collective) and calls each method; ``mesh=None``
    saves and restores this process alone, whole tensors.

    Restore targets the CURRENT mesh's shards (pass your freshly
    initialized state), so a job saved on a (2, 2, 1) gang restores onto
    a (1, 1, 4) one, or into one process, with nothing but a different
    mesh in hand — the elasticity the gang scheduler's rollback story
    assumes.

    ``last_save_stats`` holds the last save's host seconds blocked, its
    seconds from start until durable, and its bytes on disk (the last
    two once ``wait`` has returned); ``last_restore_stats`` the last
    restore's seconds, and those spent agreeing on the step (waiting for
    every rank), building the targets (the optimizer's state created),
    in ``dcp.load``, and copying the result in."""

    def __init__(self, cfg: CheckpointConfig, mesh: par.Mesh | None = None):
        self.cfg = cfg
        self._group = self._device_mesh = None
        if mesh is not None:
            self._device_mesh = par.host_device_mesh(mesh)
            self._group = dist.new_group(backend="gloo")
        os.makedirs(cfg.directory, exist_ok=True)
        self._writer: threading.Thread | None = None
        self._error: BaseException | None = None
        self._last_started: int | None = None
        self.last_save_stats: dict = {}
        self.last_restore_stats: dict = {}

    # ------------------------------------------------------------------
    # Steps on disk

    def _path(self, step: int, partial: bool = False) -> str:
        return os.path.join(self.cfg.directory,
                            f"{step}{PARTIAL if partial else ''}")

    def _steps(self) -> list[int]:
        """Committed steps on disk, ascending."""
        return sorted(int(name) for name in os.listdir(self.cfg.directory)
                      if name.isdigit()
                      and os.path.isdir(os.path.join(self.cfg.directory,
                                                     name)))

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def _should_save(self, step: int) -> bool:
        """The reference's rule (orbax's default policy): never at or
        before the last step saved; else at multiples of
        ``save_interval_steps``, or when no checkpoint exists yet."""
        last = max((s for s in (self.latest_step(), self._last_started)
                    if s is not None), default=None)
        if last is not None and last >= step:
            return False
        return step % self.cfg.save_interval_steps == 0 or last is None

    # ------------------------------------------------------------------
    # Save

    def _is_coordinator(self) -> bool:
        return self._group is None or dist.get_rank(self._group) == 0

    def _barrier(self) -> None:
        if self._group is not None:
            dist.barrier(group=self._group)

    def _host(self, name: str, t: torch.Tensor):
        """A host copy of ``t`` (parameter ``name``'s shard, or a tensor of
        its shape), as its global tensor under a mesh."""
        local = t.detach().to("cpu", copy=True)
        if self._device_mesh is None:
            return local
        return par.global_view(name, local, self._device_mesh)

    def _state(self, params, opt_state, make) -> dict:
        """The checkpoint's tree: ``make(name, tensor)`` of every
        parameter and of every optimizer state tensor of its parameter's
        shape; other state (AdamW's scalar ``step``) as a host copy."""
        shapes = {name: p.shape for name, p in params.named_parameters()}

        def leaf(name, v):
            if not isinstance(v, torch.Tensor):
                return v
            if v.shape == shapes[name]:
                return make(name, v)
            return v.detach().to("cpu", copy=True)

        return {
            "params": {name: make(name, p)
                       for name, p in params.named_parameters()},
            "opt_state": {name: {key: leaf(name, v)
                                 for key, v in per.items()}
                          for name, per in _optimizer_state(
                              params, opt_state).items()},
        }

    def save(self, step: int, params, opt_state, *, force: bool = False,
             wait: bool = False) -> bool:
        """Async by default (training continues while the write drains);
        ``wait=True`` blocks until durable. The state is copied to host
        memory before this returns, so the caller may step at once."""
        if not force and not self._should_save(step):
            return False
        if os.path.isdir(self._path(step)):
            raise ValueError(f"checkpoint for step {step} already exists")
        t0 = time.perf_counter()
        self.wait()
        state = self._state(params, opt_state, self._host)
        partial = self._path(step, partial=True)
        if self._is_coordinator():
            shutil.rmtree(partial, ignore_errors=True)
        self._barrier()
        self._last_started = step
        self.last_save_stats = {"step": step}
        self._writer = threading.Thread(
            target=self._write, args=(step, state, partial, t0),
            name=f"checkpoint-{step}", daemon=True)
        self._writer.start()
        self.last_save_stats["blocked_s"] = time.perf_counter() - t0
        if wait:
            self.wait()
        log.info("checkpoint saved at step %d -> %s", step,
                 self.cfg.directory)
        return True

    def _write(self, step: int, state: dict, partial: str,
               t0: float) -> None:
        try:
            dcp.save(state, storage_writer=dcp.FileSystemWriter(partial),
                     process_group=self._group,
                     no_dist=self._group is None)
            if self._is_coordinator():
                final = self._path(step)
                os.rename(partial, final)
                _fsync_dir(self.cfg.directory)
                self.last_save_stats["bytes"] = sum(
                    os.path.getsize(os.path.join(final, f))
                    for f in os.listdir(final))
                self._prune()
            self._barrier()
            self.last_save_stats["durable_s"] = time.perf_counter() - t0
        except BaseException as exc:      # re-raised by wait()
            self._error = exc

    def _prune(self) -> None:
        keep = self.cfg.max_to_keep
        if keep is None:
            return
        for old in self._steps()[:-keep] if keep > 0 else self._steps():
            shutil.rmtree(self._path(old), ignore_errors=True)

    # ------------------------------------------------------------------
    # Restore

    def _agreed(self, step: int | None) -> int | None:
        """Rank 0's step, on every rank."""
        if self._group is None:
            return step
        box = [step]
        dist.broadcast_object_list(box, src=dist.get_global_rank(
            self._group, 0), group=self._group)
        return box[0]

    def restore(self, params_target, opt_state_target,
                step: int | None = None):
        """Restore onto the shards/structure of the given targets (use a
        freshly-initialized state as the template), in place. Returns
        (params, opt_state, step) or None when no checkpoint exists."""
        marks = [time.perf_counter()]
        self.wait()
        step = self._agreed(self.latest_step() if step is None else step)
        if step is None:
            return None
        marks.append(time.perf_counter())

        def target(name, t):
            local = torch.empty(t.shape, dtype=t.dtype, device="cpu")
            if self._device_mesh is None:
                return local
            return par.global_view(name, local, self._device_mesh)

        state = self._state(params_target, opt_state_target, target)
        marks.append(time.perf_counter())
        dcp.load(state, storage_reader=dcp.FileSystemReader(
            self._path(step)), process_group=self._group,
            no_dist=self._group is None)
        marks.append(time.perf_counter())
        with torch.no_grad():
            for name, p in params_target.named_parameters():
                p.copy_(_local(state["params"][name]))
        osd = {"state": {name: {key: _local(v) for key, v in per.items()}
                         for name, per in state["opt_state"].items()},
               "param_groups": get_optimizer_state_dict(
                   params_target, opt_state_target)["param_groups"]}
        set_optimizer_state_dict(params_target, opt_state_target, osd)
        marks.append(time.perf_counter())
        self.last_restore_stats = {
            "step": step, "seconds": marks[-1] - marks[0],
            **{f"{phase}_s": b - a for phase, a, b in zip(
                ("agree", "targets", "load", "apply"), marks, marks[1:])}}
        log.info("restored checkpoint step %d from %s", step,
                 self.cfg.directory)
        return params_target, opt_state_target, step

    # ------------------------------------------------------------------

    def wait(self) -> None:
        """Block until the save in flight (if any) is durable on every
        rank; re-raises its failure."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            exc, self._error = self._error, None
            raise exc

    def close(self) -> None:
        self.wait()


def _optimizer_state(params, opt_state) -> dict:
    """The optimizer's state by parameter name, created if the optimizer
    has taken no step: ``get_optimizer_state_dict`` creates it by one step
    at learning rate 0 on zero gradients, which leaves the weights and
    AdamW's moments as they were and counts one step, so the count is set
    back to 0, what a fresh optimizer counts."""
    fresh = not opt_state.state
    osd = get_optimizer_state_dict(params, opt_state)["state"]
    if fresh:
        for per in osd.values():
            if isinstance(per.get("step"), torch.Tensor):
                per["step"].zero_()
    return osd


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
