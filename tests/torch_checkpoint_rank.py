"""One rank of the CPU gang that ``test_torch_checkpoint.py`` starts
through ``tpushare_torch.runtime.launch``.

Run as a script (``python tests/torch_checkpoint_rank.py INPUTS OUT
INIT_METHOD``), so it imports neither JAX nor the test conftest: numpy,
torch and the port only. It reads the test's batch (``INPUTS``, an
``.npz``), joins a gang of 4 over gloo on the CPU and, at the tiny width
in fp32, runs:

* (a) a (2, 1, 2) ring gang: two steps, an async save of step 2 under
  ``OUT/a``, the state at the save gathered, then step 3 uninterrupted;
* (b) a (1, 1, 4) ring gang from weights of another seed: restore of
  ``OUT/a``, the restored state gathered, then step 3;
* (c) a (2, 2, 1) gang: three steps, then a save of step 3 under
  ``OUT/c`` (the test restores it in one process);
* the entry point's checkpointed dry run on (2, 2, 1): three steps with
  a save after step 2 (``--ckpt-every 2``), then a fresh gang that
  resumes from it (``--resume``), each over its own rendezvous.

Rank 0 saves every gathered array into ``OUT/out.npz`` (weights,
``exp_avg`` and ``exp_avg_sq`` by parameter name, gathered over tp, and
the AdamW ``step``); each rank prints one JSON line.
"""

import contextlib
import dataclasses
import io
import json
import os
import sys

import numpy as np
import torch

from tpushare_torch import entry as E
from tpushare_torch.runtime import torchenv
from tpushare_torch.workload import model as M
from tpushare_torch.workload import parallel as par
from tpushare_torch.workload import train as T
from tpushare_torch.workload.checkpoint import CheckpointConfig, Checkpointer

CFG = dataclasses.replace(M.ModelConfig().tiny(), dtype=torch.float32)


def state(params, opt, mesh) -> dict:
    """Weights and AdamW state gathered over tp, as numpy, by key."""
    by_param = dict(params.named_parameters())
    out = {f"weight/{n}": p for n, p in par.gather_shards(
        {n: p.detach() for n, p in by_param.items()}, mesh).items()}
    for key in ("exp_avg", "exp_avg_sq"):
        out.update({f"{key}/{n}": t for n, t in par.gather_shards(
            {n: opt.state[p][key] for n, p in by_param.items()},
            mesh).items()})
    steps = {float(opt.state[p]["step"]) for p in by_param.values()}
    assert len(steps) == 1, steps
    return {k: v.numpy() for k, v in out.items()} | {
        "step": np.float64(steps.pop())}


def run(mesh, seed, batch):
    init_fn, step, place = T.make_train_step(CFG, mesh, device="cpu")
    params, opt = init_fn(torch.Generator().manual_seed(seed), batch[0])
    return params, opt, step, place(*batch)


def cases(batch, out_dir, out, record):
    # (a) Save on (2, 1, 2), step 3 uninterrupted.
    mesh = par.make_mesh(2, 1, 2)
    params, opt, step, shard = run(mesh, 0, batch)
    for _ in range(2):
        step(params, opt, *shard)
    ckpt = Checkpointer(CheckpointConfig(os.path.join(out_dir, "a")), mesh)
    assert ckpt.save(2, params, opt)
    out.update({f"a/saved/{k}": v for k, v in
                state(params, opt, mesh).items()})
    _, _, loss = step(params, opt, *shard)
    ckpt.close()
    record["a_latest"] = ckpt.latest_step()
    out["a/loss3"] = np.float64(loss.item())
    out.update({f"a/after/{k}": v for k, v in
                state(params, opt, mesh).items()})

    # (b) Restore on (1, 1, 4) into weights of another seed, then step 3.
    mesh = par.make_mesh(1, 1, 4)
    params, opt, step, shard = run(mesh, 7, batch)
    ckpt = Checkpointer(CheckpointConfig(os.path.join(out_dir, "a")), mesh)
    _, _, record["b_restored_step"] = ckpt.restore(params, opt)
    ckpt.close()
    out.update({f"b/restored/{k}": v for k, v in
                state(params, opt, mesh).items()})
    _, _, loss = step(params, opt, *shard)
    out["b/loss3"] = np.float64(loss.item())
    out.update({f"b/after/{k}": v for k, v in
                state(params, opt, mesh).items()})

    # (c) Train on (2, 2, 1) and save step 3.
    mesh = par.make_mesh(2, 2, 1)
    params, opt, step, shard = run(mesh, 0, batch)
    for _ in range(3):
        step(params, opt, *shard)
    ckpt = Checkpointer(CheckpointConfig(os.path.join(out_dir, "c")), mesh)
    assert ckpt.save(3, params, opt, wait=True)
    record["c_latest"] = ckpt.latest_step()
    record["c_stats"] = ckpt.last_save_stats
    ckpt.close()
    out.update({f"c/saved/{k}": v for k, v in
                state(params, opt, mesh).items()})


def dryrun(init_method, ckpt_dir, *args):
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        E.main(["--mesh", "2,2,1", "--parts", "train", "--steps", "3",
                "--device", "cpu", "--init-method", init_method,
                "--ckpt-dir", ckpt_dir, *args])
    return json.loads(printed.getvalue().splitlines()[-1])["paths"]["ring"]


def main(inputs_path, out_dir, init_method):
    os.nice(19)
    torch.set_num_threads(1)
    spec = torchenv.init_distributed(device="cpu", init_method=init_method)
    inputs = np.load(inputs_path)
    batch = tuple(torch.from_numpy(inputs[k]).long()
                  for k in ("tokens", "targets"))
    out, record = {}, {"rank": spec.process_id}
    try:
        cases(batch, out_dir, out, record)
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
