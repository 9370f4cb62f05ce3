"""One rank of the CPU gang that ``test_torch_parallel.py`` starts through
``tpushare_torch.runtime.launch``.

Run as a script (``python tests/torch_parallel_rank.py INPUTS OUT
INIT_METHOD``), so it imports neither JAX nor the test conftest: numpy,
torch and the port only. It reads the test's numpy inputs (``INPUTS``,
an ``.npz``), joins the gang over gloo on the CPU, and runs:

* attention at sp = 2 and 4 (meshes (4, 1, 2) and (2, 1, 4)): the plain
  ring, the ring through the flash path (its plain versions on the CPU)
  and Ulysses (plain and flash), outputs and q/k/v gradients of
  ``sum(out * dout)`` gathered over sp; Ulysses' refusal of 3 heads;
* the train step at (2, 2, 2), ring and Ulysses, fp32 and bf16, each
  both as ``make_train_step`` picks its attention on the CPU (the plain
  ring, Ulysses over plain attention) and through the kernels' code
  path (``use_flash=True``: ``ring_flash_attention`` with the merge's
  lse cotangent, Ulysses over ``flash_attention``; the kernels' plain
  versions on the CPU), and with sequence parallelism off (fp32), from
  the test's weights: the global loss, the gathered gradients and the
  weights after one step; and ``shard_params`` then ``gather_params``;
* the entry point's dry run (``python -m tpushare_torch.entry --attention
  ring ulysses --steps 2 --device cpu``, every part: training in the
  reference's bf16, the ring-MoE and the four pipes) over its own
  rendezvous, then its train part again at the same config in fp32.

Rank 0 saves every gathered array into ``OUT`` (``.npz``) and each dry
run's first losses and gathered grads beside it (:func:`dryrun_path`);
each rank prints one JSON line, which holds both dry runs' records.
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
from tpushare_torch.workload import collectives as C
from tpushare_torch.workload import convert
from tpushare_torch.workload import model as M
from tpushare_torch.workload import parallel as par
from tpushare_torch.workload import train as T

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tree(inputs, prefix):
    """The JAX-layout numpy tree saved flat under ``prefix``."""
    n = len({k.split("/")[2] for k in inputs if k.startswith(f"{prefix}/b")})
    return {"embed": inputs[f"{prefix}/embed"],
            "final_norm": inputs[f"{prefix}/final_norm"],
            "blocks": [{key: inputs[f"{prefix}/blocks/{i}/{key}"]
                        for key in convert._BLOCK_KEYS} for i in range(n)]}


def _np(t):
    return t.detach().float().numpy()


def attention_cases(inputs, out):
    q, k, v, dout = (torch.from_numpy(inputs[x]) for x in
                     ("q", "k", "v", "dout"))
    refused = {}
    for sp in (2, 4):
        mesh = par.make_mesh(8 // sp, 1, sp)
        shard = [x.chunk(sp, dim=1)[mesh.sp_rank].contiguous()
                 for x in (q, k, v, dout)]
        fns = {
            "ring": par.make_ring_attn_fn(mesh, use_flash=False),
            "ring_flash": par.make_ring_attn_fn(mesh, use_flash=True),
            "ulysses": par.make_ulysses_attn_fn(mesh, use_flash=False),
            "ulysses_flash": par.make_ulysses_attn_fn(mesh, use_flash=True),
        }
        for name, fn in fns.items():
            qs, ks, vs = (x.clone().requires_grad_() for x in shard[:3])
            o = fn(qs, ks, vs)
            (o * shard[3]).sum().backward()
            for key, t in (("out", o), ("dq", qs.grad), ("dk", ks.grad),
                           ("dv", vs.grad)):
                out[f"sp{sp}/{name}/{key}"] = _np(
                    C.all_gather(t.detach(), mesh.sp_group, 1))
        try:
            par.ulysses_attention(*(x[:, :, :3] for x in shard[:3]),
                                  mesh.sp_group)
        except ValueError as exc:
            refused[f"sp{sp}"] = str(exc)
    return refused


def train_cases(inputs, out):
    mesh = par.make_mesh(2, 2, 2)
    tokens = torch.from_numpy(inputs["tokens"]).long()
    targets = torch.from_numpy(inputs["targets"]).long()
    exact = {}
    for dtype, tdt in DTYPES.items():
        cfg = dataclasses.replace(M.ModelConfig().tiny(), dtype=tdt)
        full = convert.params_from_jax(_tree(inputs, dtype), cfg, "cpu")
        back = par.gather_params(par.shard_params(full, mesh), mesh)
        exact[dtype] = all(
            torch.equal(a, b) for a, b in zip(full.parameters(),
                                              back.parameters()))
        # "*_flash": the kernels' code path; "none": use_ring_attention=
        # False, sp ranks as replicas (fp32).
        flash = {"ring_flash": par.make_ring_attn_fn(mesh, use_flash=True),
                 "ulysses_flash": par.make_ulysses_attn_fn(mesh,
                                                           use_flash=True)}
        strategies = ("ring", "ulysses", *flash) + (
            ("none",) if tdt == torch.float32 else ())
        for attention in strategies:
            kw = ({"use_ring_attention": False} if attention == "none"
                  else {"attn_fn": flash[attention]} if attention in flash
                  else {"attention": attention})
            _, step, place = T.make_train_step(cfg, mesh, device="cpu", **kw)
            params = par.shard_params(full, mesh)
            opt = T.make_optimizer()(params.parameters())
            params, opt, loss = step(params, opt, *place(tokens, targets))
            key = f"{dtype}/{attention}"
            out[f"{key}/loss"] = np.float64(loss.item())
            grads = par.gather_shards(
                {n: p.grad for n, p in params.named_parameters()}, mesh)
            after = par.gather_params(params, mesh)
            for n, p in after.named_parameters():
                out[f"{key}/grad/{n}"] = _np(grads[n])
                out[f"{key}/weight/{n}"] = _np(p)
    return exact


def dryrun_path(out_path, dtype="bfloat16"):
    """Where rank 0's dry run in ``dtype`` saves its first losses and
    gathered grads (the entry's ``--save-grads``), beside ``OUT``."""
    return os.path.splitext(out_path)[0] + f"_dryrun_{dtype}.pt"


def dryrun(argv, dtype=None):
    """The entry's rank body on ``argv``; with ``dtype``, its tiny config
    in that dtype. Returns the record it prints."""
    entry_config = E.dryrun_config
    if dtype is not None:
        def config_in(width, mesh):
            cfg, batch = entry_config(width, mesh)
            return dataclasses.replace(cfg, dtype=dtype), batch
        E.dryrun_config = config_in
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            E.main(argv)
    finally:
        E.dryrun_config = entry_config
    return json.loads(printed.getvalue().splitlines()[-1])


def main(inputs_path, out_path, init_method):
    # Eight ranks share the host with the rest of the suite: run only on
    # CPU its timing-sensitive tests leave idle.
    os.nice(19)
    torch.set_num_threads(1)
    spec = torchenv.init_distributed(device="cpu", init_method=init_method)
    inputs = dict(np.load(inputs_path))
    out = {}
    try:
        refused = attention_cases(inputs, out)
        exact = train_cases(inputs, out)
    finally:
        torch.distributed.destroy_process_group()
    if spec.process_id == 0:
        np.savez(out_path, **out)
    common = ["--attention", "ring", "ulysses", "--steps", "2", "--device",
              "cpu"]
    record = dryrun([*common, "--init-method", f"{init_method}-dryrun",
                     "--save-grads", dryrun_path(out_path)])
    record32 = dryrun([*common, "--parts", "train", "--init-method",
                       f"{init_method}-dryrun32", "--save-grads",
                       dryrun_path(out_path, "float32")], torch.float32)
    print(json.dumps({"rank": spec.process_id, "refused": refused,
                      "round_trip_exact": exact, "dryrun": record,
                      "dryrun_float32": record32}), flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:4])
