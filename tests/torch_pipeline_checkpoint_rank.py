"""One rank of the CPU gang that ``test_torch_pipeline_checkpoint.py``
starts through ``tpushare_torch.runtime.launch``.

Run as a script (``python tests/torch_pipeline_checkpoint_rank.py INPUTS
OUT INIT_METHOD``), so it imports neither JAX nor the test conftest:
numpy, torch and the port only. It reads the test's batch and the JAX
package's initial (stacked, edge) pipe tree (``INPUTS``, an ``.npz``),
joins a gang of 4 over gloo on the CPU and, at the tiny width in fp32
with 4 layers, trains the flagship 1F1B pipe (M = 4) with AdamW:

* (a) a (2, 1, 1, 2) dp x pp gang from the JAX weights: two steps, an
  async save of step 2 under ``OUT/a``, the state at the save gathered,
  then step 3 uninterrupted;
* (b) a (1, 2, 1, 2) tp x pp gang from weights of another seed: restore
  of ``OUT/a`` (the same two stages, tp 1 -> 2), the restored state
  gathered, then step 3;
* (c) the pipe over the ``sp`` axis of a (2, 1, 2) mesh with no pipe axis
  (pp = 1; the dp rows are replicas, as the entry's ``pipe`` part runs
  it): one step, a save under ``OUT/c``, then a restore into weights of
  another seed; both states gathered;
* (d) a (1, 1, 1, 4) pipe of four stages restoring ``OUT/a``, with
  ``dcp.load`` barred: the refusal and the loads attempted recorded;
* the entry point's checkpointed ``dp_pp`` part on (2, 1, 2): three calls
  with a save after call 2 (``--ckpt-every 2``), then a fresh gang that
  resumes from it (``--resume``), each over its own rendezvous.

Rank 0 saves every gathered array into ``OUT/out.npz`` (``weight/<w>``,
``exp_avg/<w>`` and ``exp_avg_sq/<w>`` in the reference's stacked layout,
and the AdamW ``step``); each rank prints one JSON line.
"""

import contextlib
import dataclasses
import io
import json
import os
import sys

import numpy as np
import torch
import torch.distributed.checkpoint as dcp

from tpushare_torch import entry as E
from tpushare_torch.runtime import torchenv
from tpushare_torch.workload import convert
from tpushare_torch.workload import model as M
from tpushare_torch.workload import parallel as par
from tpushare_torch.workload import pipeline as P
from tpushare_torch.workload import train as T
from tpushare_torch.workload.checkpoint import CheckpointConfig, Checkpointer

CFG = dataclasses.replace(M.ModelConfig().tiny(), dtype=torch.float32,
                          n_layers=4, remat=False)
MICROBATCHES = 4


class Pipe:
    """A flagship pipe on ``mesh``: its stage, edge, AdamW and train_fn."""

    def __init__(self, mesh, axis, tp_axis=None, dp_axis=None, seed=0,
                 jax_tree=None):
        self.mesh, self.axis, self.tp_axis = mesh, axis, tp_axis
        init_fn, self.train_fn = P.make_flagship_pipeline(
            CFG, mesh, axis, n_microbatches=MICROBATCHES, dp_axis=dp_axis,
            tp_axis=tp_axis, device="cpu")
        if jax_tree is None:
            self.stage, self.edge = init_fn(
                torch.Generator().manual_seed(seed))
        else:
            self.stage, self.edge = convert.pipeline_params_from_jax(
                *jax_tree, mesh, axis, tp_axis, device="cpu")
        self.opt = T.make_optimizer()([*self.stage.parameters(),
                                       *self.edge.parameters()])

    @property
    def params(self):
        return self.stage, self.edge

    def step(self, tokens, targets) -> float:
        loss = self.train_fn(self.stage, self.edge, tokens, targets)
        self.opt.step()
        return loss.item()

    def checkpointer(self, directory):
        return Checkpointer(CheckpointConfig(directory), self.mesh,
                            pipe_axis=self.axis, tp_axis=self.tp_axis)

    def state(self) -> dict:
        """Weights and moments gathered into the stacked layout, numpy."""
        return {k: t.numpy() for k, t in convert.pipeline_state(
            self.opt, self.stage, self.edge, self.mesh, self.axis,
            self.tp_axis).items()}


def host_mesh(mesh) -> list:
    """The names and shape of ``host_device_mesh(mesh)`` (a collective)."""
    dm = par.host_device_mesh(mesh)
    return [list(dm.mesh_dim_names), list(dm.shape)]


def cases(inputs, out_dir, out, record):
    tokens, targets = (torch.from_numpy(inputs[k]).long()
                       for k in ("tokens", "targets"))
    jax_tree = ({k[8:]: inputs[k] for k in inputs if k.startswith("stacked/")},
                {k[5:]: inputs[k] for k in inputs if k.startswith("edge/")})

    # (a) dp x pp from the JAX weights: save step 2, step 3 uninterrupted.
    pipe = Pipe(par.make_mesh(2, 1, 1, 2), "pp", dp_axis="dp",
                jax_tree=jax_tree)
    record["host_meshes"] = {"a": host_mesh(pipe.mesh)}
    out["a/losses"] = np.array([pipe.step(tokens, targets)
                                for _ in range(2)])
    ckpt = pipe.checkpointer(os.path.join(out_dir, "a"))
    assert ckpt.save(2, pipe.params, pipe.opt)
    out.update({f"a/saved/{k}": v for k, v in pipe.state().items()})
    out["a/loss3"] = np.float64(pipe.step(tokens, targets))
    ckpt.close()
    record["a_latest"] = ckpt.latest_step()
    record["a_stats"] = ckpt.last_save_stats
    out.update({f"a/after/{k}": v for k, v in pipe.state().items()})

    # (b) tp x pp, the same two stages, from weights of another seed.
    pipe = Pipe(par.make_mesh(1, 2, 1, 2), "pp", tp_axis="tp", seed=7)
    ckpt = pipe.checkpointer(os.path.join(out_dir, "a"))
    _, _, record["b_restored_step"] = ckpt.restore(pipe.params, pipe.opt)
    ckpt.close()
    out.update({f"b/restored/{k}": v for k, v in pipe.state().items()})
    out["b/loss3"] = np.float64(pipe.step(tokens, targets))
    out.update({f"b/after/{k}": v for k, v in pipe.state().items()})

    # (c) The pipe over sp on a mesh without a pipe axis.
    pipe = Pipe(par.make_mesh(2, 1, 2), "sp", seed=3)
    record["host_meshes"]["c"] = host_mesh(pipe.mesh)
    pipe.step(tokens, targets)
    ckpt = pipe.checkpointer(os.path.join(out_dir, "c"))
    assert ckpt.save(1, pipe.params, pipe.opt, wait=True)
    ckpt.close()
    out.update({f"c/saved/{k}": v for k, v in pipe.state().items()})
    pipe = Pipe(par.make_mesh(2, 1, 2), "sp", seed=5)
    ckpt = pipe.checkpointer(os.path.join(out_dir, "c"))
    _, _, record["c_restored_step"] = ckpt.restore(pipe.params, pipe.opt)
    ckpt.close()
    out.update({f"c/restored/{k}": v for k, v in pipe.state().items()})

    # (d) A four-stage target of (a)'s two-stage checkpoint.
    pipe = Pipe(par.make_mesh(1, 1, 1, 4), "pp", seed=11)
    ckpt = pipe.checkpointer(os.path.join(out_dir, "a"))
    loads, real_load = [], dcp.load
    dcp.load = lambda *a, **kw: loads.append(a)
    try:
        ckpt.restore(pipe.params, pipe.opt)
        record["d_refused"] = None
    except ValueError as exc:
        record["d_refused"] = str(exc)
    finally:
        dcp.load = real_load
    record["d_loads"] = len(loads)
    ckpt.close()


def dryrun(init_method, ckpt_dir, *args):
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        E.main(["--mesh", "2,1,2", "--parts", "dp_pp", "--steps", "3",
                "--device", "cpu", "--init-method", init_method,
                "--ckpt-dir", ckpt_dir, *args])
    return json.loads(printed.getvalue().splitlines()[-1])["parts"]["dp_pp"]


def main(inputs_path, out_dir, init_method):
    os.nice(19)
    torch.set_num_threads(1)
    spec = torchenv.init_distributed(device="cpu", init_method=init_method)
    inputs = dict(np.load(inputs_path))
    out, record = {}, {"rank": spec.process_id}
    try:
        cases(inputs, out_dir, out, record)
    finally:
        torch.distributed.destroy_process_group()
    if spec.process_id == 0:
        np.savez(os.path.join(out_dir, "out.npz"), **out)
    entry_dir = os.path.join(out_dir, "entry")
    record["entry_save"] = dryrun(f"{init_method}-save", entry_dir,
                                  "--ckpt-every", "2")
    record["entry_resume"] = dryrun(f"{init_method}-resume", entry_dir,
                                    "--resume")
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:4])
