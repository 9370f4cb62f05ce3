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
  State the optimizer already holds is copied into, not replaced
  (``convert.set_optimizer_state``): a compiled step reads it in place,
  so the step after a restore replays its graph.
* **A pipe is saved in the reference's stacked layout.** A 1F1B pipe's
  state (``pipeline.make_flagship_pipeline``: each rank's stage of
  blocks, the edge every rank holds, AdamW over both) is the tree the
  reference's orbax ``Checkpointer`` writes for its ``(stacked, edge)``
  and optax's ``adamw`` state: ``params.0.<w>`` is block weight ``w`` of
  every stage, ``[n_stages, per_stage, *shape]``, sharded over the pipe
  axis on dim 0 (and over tp on its tp dim + 2), ``params.1.<name>`` the
  edge whole; ``opt_state.0.mu`` and ``opt_state.0.nu`` the moments in
  the same two layouts, ``opt_state.0.count`` the step. It restores onto
  any dp / tp (and sp) placement with the same stage count, or whole
  into one process at the stage count it was saved with, as orbax
  restores the saved shape: a gang of another stage count is refused
  before anything is read but the metadata.

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
from torch import nn
from torch.distributed.checkpoint.state_dict import get_optimizer_state_dict
from torch.distributed.tensor import DTensor

from tpushare_torch.workload import convert
from tpushare_torch.workload import model as M
from tpushare_torch.workload import parallel as par
from tpushare_torch.workload import pipeline as P

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

    A pipe's Checkpointer is built with ``pipe_axis`` (the mesh axis the
    stages lie along, ``"pp"``, or ``"sp"`` on a mesh without one) and
    the ``tp_axis`` its stages are split over, if any; ``params`` is then
    the pair ``(stage, edge)`` that ``pipeline.make_flagship_pipeline``'s
    ``init_fn`` returns (the reference's ``(stacked, edge)``), and
    ``opt_state`` the AdamW over ``[*stage.parameters(),
    *edge.parameters()]``. In one process (``mesh=None``, ``pipe_axis``
    naming the axis of the gang that saved) it restores a pipe's
    checkpoint whole: ``stage`` holds every block in order, and the
    stage count is the checkpoint's (``pipeline.stage_tree``), as orbax
    restores the stacked tree into one host. A pipe is saved by its gang
    only: one process holds no stage count of its own.

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

    def __init__(self, cfg: CheckpointConfig, mesh: par.Mesh | None = None,
                 *, pipe_axis: str | None = None,
                 tp_axis: str | None = None):
        self.cfg = cfg
        self._group = self._device_mesh = None
        if tp_axis is not None and pipe_axis is None:
            raise ValueError("tp_axis names the axis a pipe's stages are "
                             "split over: it takes pipe_axis")
        #: A pipe's (pipe axis, tp axis, its size under the mesh, or None
        #: in one process); None for a Transformer.
        self._pipe = None if pipe_axis is None else (
            pipe_axis, tp_axis, None if mesh is None else mesh.size(pipe_axis))
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

    def _view(self, name: str, local: torch.Tensor):
        """``local``, a host tensor laid out as parameter ``name`` (a pipe's
        stacked weight ``"0.<w>"`` or edge tensor ``"1.<name>"``), as its
        global tensor under a mesh; itself in one process."""
        dm = self._device_mesh
        if dm is None:
            return local
        if self._pipe is None:
            return par.global_view(name, local, dm)
        pipe_axis, tp_axis = self._pipe[:2]
        part, _, leaf = name.partition(".")
        if part == "0":
            return par.stacked_global_view(leaf, local, dm, pipe_axis,
                                           tp_axis)
        return par.replicated_view(local, dm)

    def _state(self, params, opt_state, local, n_local: int = 1) -> dict:
        """The checkpoint's tree, from ``local(tensor)``, a host tensor of
        each tensor's shape (a copy, or an empty target); a pipe's with
        ``n_local`` of its stages in this process."""
        if self._pipe is not None:
            return self._pipe_state(params, opt_state, local, n_local)
        if not isinstance(params, M.Transformer):
            raise TypeError(f"params must be a model.Transformer, got "
                            f"{type(params).__name__}; a pipe's (stage, "
                            f"edge) takes Checkpointer(..., pipe_axis=...)")
        return self._model_state(params, opt_state, local)

    def _model_state(self, params, opt_state, local) -> dict:
        """A Transformer's tree: the global view of ``local`` of every
        parameter and of every optimizer state tensor of its parameter's
        shape; other state (AdamW's scalar ``step``) as a host copy."""
        shapes = {name: p.shape for name, p in params.named_parameters()}

        def make(name, t):
            return self._view(name, local(t))

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

    def _pipe_state(self, params, opt_state, local, n_local: int) -> dict:
        """A pipe's tree, the reference's ``(stacked, edge)`` and optax's
        ``(ScaleByAdamState(count, mu, nu), ...)``: ``params.0.<w>`` the
        stacked view of ``local`` of this process's ``n_local`` stages of
        block weight ``w``, ``params.1.<name>`` of the edge;
        ``opt_state.0.mu`` and ``.nu`` the moments laid out alike;
        ``opt_state.0.count`` a host copy of AdamW's step, which every
        parameter shares."""
        stage, edge, module = _pipe_modules(params)
        per = _optimizer_state(module, opt_state)

        def pair(get):
            stacked = P.stage_tree(stage, n_local,
                                   lambda name, p: local(get(f"stage.{name}",
                                                             p)))
            return {"0": {w: self._view(f"0.{w}", t)
                          for w, t in stacked.items()},
                    "1": {k: self._view(f"1.{k}", local(get(f"edge.{k}", p)))
                          for k, p in edge.named_parameters()}}

        def moment(key):
            return pair(lambda fqn, p: per[fqn][key])

        steps = [st["step"] for st in per.values()]
        if len({float(t) for t in steps}) != 1:
            raise ValueError("the pipe's parameters have taken different "
                             "step counts; optax keeps one")
        return {"params": pair(lambda fqn, p: p),
                "opt_state": {"0": {"count": _host_copy(steps[0]),
                                    "mu": moment("exp_avg"),
                                    "nu": moment("exp_avg_sq")}}}

    def _check_stages(self, saved: dict) -> int:
        """The stages of the checkpoint's pipe this process holds, from its
        metadata (``saved``, by key) alone: in one process all of them;
        under a mesh one, and a ``ValueError`` naming both counts unless
        the pipe axis has as many ranks as the checkpoint has stages."""
        sizes = [md.size for key, md in saved.items()
                 if key.startswith("params.0.")]
        if not sizes:
            raise ValueError("the checkpoint holds no params.0.*: not a "
                             "pipe's")
        n_saved, n_target = sizes[0][0], self._pipe[2]
        if n_target is None:
            return n_saved
        if n_target != n_saved:
            raise ValueError(
                f"the checkpoint holds a pipe of {n_saved} stages, the "
                f"target has {n_target}: a pipe restores onto the stage "
                f"count it was saved with")
        return 1

    @staticmethod
    def _check_shapes(state: dict, saved: dict) -> None:
        """Raise ``ValueError`` unless the checkpoint holds each of the
        target's stacked weights at its global shape."""
        for w, t in state["params"]["0"].items():
            key = f"params.0.{w}"
            got = tuple(saved[key].size) if key in saved else None
            if got != tuple(t.shape):
                raise ValueError(f"{key}: saved {got}, target "
                                 f"{tuple(t.shape)}")

    def _apply_pipe(self, state: dict, params, opt_state) -> None:
        """Copy a loaded pipe tree into ``params`` and ``opt_state``."""
        stage, edge, module = _pipe_modules(params)

        def blocks(tree):
            return P.stage_blocks({w: _local(t)
                                   for w, t in tree["0"].items()})

        def by_fqn(tree):
            out = {f"stage.{i}.{w}": t for i, blk in enumerate(blocks(tree))
                   for w, t in blk.items()}
            out.update({f"edge.{k}": _local(t) for k, t in tree["1"].items()})
            return out

        weights = by_fqn(state["params"])
        with torch.no_grad():
            for fqn, p in module.named_parameters():
                p.copy_(weights[fqn])
        adam = state["opt_state"]["0"]
        mu, nu = by_fqn(adam["mu"]), by_fqn(adam["nu"])
        convert.set_optimizer_state(module, opt_state, {
            fqn: {"step": adam["count"].clone(), "exp_avg": mu[fqn],
                  "exp_avg_sq": nu[fqn]}
            for fqn, _ in module.named_parameters()})

    def save(self, step: int, params, opt_state, *, force: bool = False,
             wait: bool = False) -> bool:
        """Async by default (training continues while the write drains);
        ``wait=True`` blocks until durable. The state is copied to host
        memory before this returns, so the caller may step at once."""
        if not force and not self._should_save(step):
            return False
        if self._pipe is not None and self._pipe[2] is None:
            raise ValueError("a pipe is saved by its gang: one process "
                             "restores its checkpoint, and holds no stage "
                             "count to save one")
        if os.path.isdir(self._path(step)):
            raise ValueError(f"checkpoint for step {step} already exists")
        t0 = time.perf_counter()
        self.wait()
        state = self._state(params, opt_state, _host_copy)
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

        reader = dcp.FileSystemReader(self._path(step))
        if self._pipe is None:
            state = self._state(params_target, opt_state_target, _host_empty)
        else:
            saved = reader.read_metadata().state_dict_metadata
            state = self._state(params_target, opt_state_target, _host_empty,
                                self._check_stages(saved))
            self._check_shapes(state, saved)
        marks.append(time.perf_counter())
        dcp.load(state, storage_reader=reader, process_group=self._group,
                 no_dist=self._group is None)
        marks.append(time.perf_counter())
        if self._pipe is not None:
            self._apply_pipe(state, params_target, opt_state_target)
        else:
            with torch.no_grad():
                for name, p in params_target.named_parameters():
                    p.copy_(_local(state["params"][name]))
            convert.set_optimizer_state(params_target, opt_state_target, {
                name: {key: _local(v) for key, v in per.items()}
                for name, per in state["opt_state"].items()})
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


def _pipe_modules(params) -> tuple[nn.ModuleList, nn.Module, nn.ModuleDict]:
    """(stage, edge, one module over both, stage first: the order the
    pipe's optimizer holds them in) of a pipe's ``params``."""
    if not (isinstance(params, tuple) and len(params) == 2
            and isinstance(params[0], nn.ModuleList)
            and isinstance(params[1], nn.Module)):
        raise TypeError(f"a pipe's params are the pair (stage: "
                        f"nn.ModuleList, edge), got {type(params).__name__}")
    stage, edge = params
    return stage, edge, nn.ModuleDict({"stage": stage, "edge": edge})


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def _host_empty(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="cpu")


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
