"""One rank of the CPU gang that ``test_torch_pipeline.py`` and
``test_torch_moe.py`` each start through ``tpushare_torch.runtime.launch``.

Run as a script (``python tests/torch_pipeline_rank.py SUITE INPUTS OUT
INIT_METHOD``), so it imports neither JAX nor the test conftest: numpy,
torch and the port only. It reads the test's numpy inputs (``INPUTS``, an
``.npz``: weights of the JAX package's init trees, tokens and
activations), joins the gang of 8 over gloo on the CPU, and runs SUITE:

* ``pipeline``: the GPipe forward with the reference's toy stage at
  (n_stages, M) in :data:`GPIPE_CASES`, its [n, M, mb, D] staged result
  gathered over the pipe; the flagship 1F1B pipe at every case of
  :data:`FLAGSHIP_CASES` (the loss and the stacked and edge gradients,
  gathered as the reference lays them out); a few Adam steps through it;
  its stash peak at M = 4 and 16; and the refusals that need a mesh;
* ``moe``: the ring-MoE over sp = 8 at E in :data:`MOE_EXPERTS`, output
  gathered over sp, and its gradients of sum(y²) at E = 8.

Every mesh takes all 8 ranks, dp filling what the case leaves. Rank 0
saves every gathered array into ``OUT`` (``.npz``); each rank prints one
JSON line. :func:`run_module` starts the gang for a test module, beside
that module's JAX references.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

from tpushare_torch.runtime import launch, torchenv
from tpushare_torch.workload import collectives as C
from tpushare_torch.workload import convert
from tpushare_torch.workload import flash_attention as FA
from tpushare_torch.workload import model as M
from tpushare_torch.workload import moe
from tpushare_torch.workload import parallel as par
from tpushare_torch.workload import pipeline as P

#: The reference's toy stage width and GPipe cases (n_stages, M).
D = 16
GPIPE_CASES = ((4, 4), (4, 8), (2, 4))
#: The reference's flagship pipe config (tests/test_pipeline.py).
CFG = {"vocab_size": 64, "d_model": 32, "n_heads": 4, "n_layers": 4,
       "d_ff": 64, "max_seq_len": 16}
#: name -> the case of tests/test_pipeline.py it counters: the port's mesh
#: (dp, tp, sp, pp), the pipe axis, M, the batch, the config's changes,
#: the factory's kwargs, and "flash" for the kernels' code path as
#: ``attn_fn`` (their plain versions on the CPU); "bf16" cases run two of
#: them in the flagship's own dtype.
FLAGSHIP_CASES = {
    "1f1b_2x4": {"mesh": (4, 1, 2, 1), "axis": "sp", "m": 4, "batch": 4},
    "1f1b_4x8": {"mesh": (2, 1, 4, 1), "axis": "sp", "m": 8, "batch": 8},
    "1f1b_2x8": {"mesh": (4, 1, 2, 1), "axis": "sp", "m": 8, "batch": 8},
    "dp2_pp4": {"mesh": (2, 1, 1, 4), "axis": "pp", "m": 4, "batch": 8,
                "kw": {"dp_axis": "dp"}},
    "dp2_tp2_pp2": {"mesh": (2, 2, 1, 2), "axis": "pp", "m": 4, "batch": 8,
                    "kw": {"dp_axis": "dp", "tp_axis": "tp"}},
    "flash_in_stages": {"mesh": (4, 1, 1, 2), "axis": "pp", "m": 2,
                        "batch": 2, "cfg": {"n_layers": 2,
                                            "max_seq_len": 128},
                        "flash": True},
    "sp_ring": {"mesh": (1, 1, 4, 2), "axis": "pp", "m": 4, "batch": 4,
                "kw": {"sp_axis": "sp"}},
    "sp_flash_ring": {"mesh": (2, 1, 2, 2), "axis": "pp", "m": 2,
                      "batch": 2, "cfg": {"n_layers": 2, "max_seq_len": 256},
                      "kw": {"sp_axis": "sp", "sp_flash": True}},
    "4d": {"mesh": (1, 2, 2, 2), "axis": "pp", "m": 2, "batch": 4,
           "cfg": {"n_layers": 2},
           "kw": {"dp_axis": "dp", "tp_axis": "tp", "sp_axis": "sp"}},
    "bf16_4d": {"mesh": (1, 2, 2, 2), "axis": "pp", "m": 2, "batch": 4,
                "cfg": {"n_layers": 2}, "bf16": True,
                "kw": {"dp_axis": "dp", "tp_axis": "tp", "sp_axis": "sp"}},
    "bf16_2x4": {"mesh": (4, 1, 2, 1), "axis": "sp", "m": 4, "batch": 4,
                 "bf16": True},
}
#: The Adam steps through the (2, 4) pipe, and the stash's M values.
TRAIN_STEPS, TRAIN_LR = 8, 1e-2
STASH_MS = (4, 16)
#: The MoE's width and expert counts (tests/test_moe.py), over sp = 8.
MOE_D, MOE_F, MOE_EXPERTS = 16, 32, (8, 16)
#: A module's gang is done in well under a minute alone, at the lowest
#: priority beside the rest of the suite in a few; the deadline only
#: turns a hang into a failure.
GANG_DEADLINE_S = 600
HERE = os.path.dirname(os.path.abspath(__file__))
#: Runs ``save_references(argv[1])`` of a test module at nice 19, so that
#: JAX's compile and its thread pool run at the lowest priority too.
NICE_REFERENCES = (
    "import os, sys; os.nice(19); sys.path.insert(0, {here!r}); "
    "import {module} as t; t.save_references(sys.argv[1])")


def run_module(suite: str, module: str, tmp, inputs: dict):
    """A test module's runs, side by side and at the lowest priority, so
    the rest of the suite keeps its CPU: the gang of ``suite`` on
    ``inputs``, and the JAX package's references, made by a subprocess of
    the test ``module``'s ``save_references`` (on the 8-device CPU mesh
    the conftest's env gives it). Returns (rank records, rank 0's arrays,
    references)."""
    np.savez(tmp / "inputs.npz", **inputs)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (os.path.dirname(HERE), os.environ.get("PYTHONPATH"))
        if p)}
    refs = subprocess.Popen(
        [sys.executable, "-c", NICE_REFERENCES.format(here=HERE,
                                                      module=module),
         str(tmp / "refs.pkl")], env=env)
    try:
        records = launch.launch(
            [os.path.join(HERE, "torch_pipeline_rank.py"), suite,
             str(tmp / "inputs.npz"), str(tmp / "out.npz"),
             f"file://{tmp / 'rendezvous'}"], 8,
            deadline_s=GANG_DEADLINE_S, env={"OMP_NUM_THREADS": "1"})
        if refs.wait(timeout=GANG_DEADLINE_S) != 0:
            raise RuntimeError(f"{module}.save_references failed")
    finally:
        if refs.poll() is None:
            refs.kill()
            refs.wait()
    with open(tmp / "refs.pkl", "rb") as f:
        references = pickle.load(f)
    return records, dict(np.load(tmp / "out.npz")), references


def case_config(case: dict) -> M.ModelConfig:
    return M.ModelConfig(**{**CFG, **case.get("cfg", {})},
                         dtype=torch.bfloat16 if case.get("bf16")
                         else torch.float32, remat=False)


def _toy_stage(params, x):
    return F.gelu(x @ params["w"] + params["b"], approximate="tanh")


def _flagship(name, case, inputs, mesh):
    cfg = case_config(case)
    kw = dict(case.get("kw", {}))
    if case.get("flash"):
        kw["attn_fn"] = FA.flash_attention
    init_fn, train_fn = P.make_flagship_pipeline(
        cfg, mesh, case["axis"], n_microbatches=case["m"], device="cpu",
        **kw)
    stacked = {k[len(name) + 9:]: v for k, v in inputs.items()
               if k.startswith(f"{name}/stacked/")}
    edge = {k: inputs[f"{name}/edge/{k}"] for k in ("embed", "final_norm")}
    stage, edge = convert.pipeline_params_from_jax(
        stacked, edge, mesh, case["axis"], kw.get("tp_axis"), device="cpu")
    stage, edge = stage.to(cfg.dtype), edge.to(cfg.dtype)
    tokens = torch.from_numpy(inputs[f"{name}/tokens"]).long()
    return train_fn, stage, edge, tokens, torch.roll(tokens, -1, dims=1)


def pipeline_suite(inputs, out):
    record = {"stash_peak": {}, "refused": {}, "wqkv_shard": None}
    for n, m in GPIPE_CASES:
        mesh = par.make_mesh(8 // n, 1, n)
        stage = P.place_pipeline_params(
            {k: torch.from_numpy(inputs[f"gpipe/{n}/{k}"]) for k in "wb"},
            mesh, "sp")
        fn = P.make_pipeline_fn(_toy_stage, mesh, "sp", n_microbatches=m)
        staged = fn(stage, torch.from_numpy(inputs["gpipe/x"]))
        out[f"gpipe/{n}x{m}"] = C.all_gather(staged[None], mesh.sp_group,
                                             0).numpy()
    for name, case in FLAGSHIP_CASES.items():
        mesh = par.make_mesh(*case["mesh"])
        train_fn, stage, edge, tokens, targets = _flagship(name, case,
                                                           inputs, mesh)
        loss = train_fn(stage, edge, tokens, targets)
        out[f"{name}/loss"] = np.float64(loss.item())
        g_stacked, g_edge = convert.pipeline_grads_to_numpy(
            stage, edge, mesh, case["axis"], case.get("kw", {}).get("tp_axis"))
        for key, g in {**g_stacked, **g_edge}.items():
            out[f"{name}/grad/{key}"] = g
        if name == "dp2_tp2_pp2":
            record["wqkv_shard"] = list(stage[0].wqkv.shape)
        if name == "1f1b_2x4":
            # A few Adam steps from the same weights.
            opt = torch.optim.Adam([*stage.parameters(), *edge.parameters()],
                                   lr=TRAIN_LR)
            losses = []
            for _ in range(TRAIN_STEPS):
                losses.append(train_fn(stage, edge, tokens, targets).item())
                opt.step()
            out["train/losses"] = np.array(losses)
            for m in STASH_MS:
                fn = P.make_flagship_pipeline(
                    case_config(case), mesh, "sp", n_microbatches=m,
                    device="cpu")[1]
                tok = tokens.repeat(m // 4 + 1, 1)[:m]
                fn(stage, edge, tok, tok)
                record["stash_peak"][m] = fn.pipe.stash_peak
    refusals = {
        "dp_indivisible": ((2, 1, 1, 4), "pp", 3, (3, 16),
                           {"dp_axis": "dp"}),
        "sp_indivisible": ((2, 1, 2, 2), "pp", 2, (2, 15),
                           {"sp_axis": "sp"}),
    }
    for name, (shape, axis, m, tshape, kw) in refusals.items():
        mesh = par.make_mesh(*shape)
        cfg = M.ModelConfig(**{**CFG, "n_layers": 2 * shape[3]},
                            dtype=torch.float32, remat=False)
        init_fn, train_fn = P.make_flagship_pipeline(
            cfg, mesh, axis, n_microbatches=m, device="cpu", **kw)
        stage, edge = init_fn(torch.Generator().manual_seed(0))
        tokens = torch.zeros(tshape, dtype=torch.long)
        try:
            train_fn(stage, edge, tokens, tokens)
        except ValueError as exc:
            record["refused"][name] = str(exc)
    return record


def moe_suite(inputs, out):
    mesh = par.make_mesh(1, 1, 8)
    x = torch.from_numpy(inputs["x"])
    xs = x.chunk(8, dim=1)[mesh.sp_rank]
    fn = moe.make_ring_moe_fn(mesh, "sp")
    shards = {}
    for e in MOE_EXPERTS:
        params = moe.place_moe_params(
            {k: torch.from_numpy(inputs[f"e{e}/{k}"])
             for k in ("router", "w1", "w2")}, mesh, "sp")
        shards[e] = {k: list(v.shape) for k, v in params.items()}
        for v in params.values():
            v.requires_grad_()
        y = fn(params, xs)
        out[f"e{e}/y"] = C.all_gather(y.detach(), mesh.sp_group, 1).numpy()
        if e == 8:
            y.square().sum().backward()
            out["e8/grad/router"] = params["router"].grad.numpy()
            for k in ("w1", "w2"):
                out[f"e8/grad/{k}"] = C.all_gather(params[k].grad,
                                                   mesh.sp_group, 0).numpy()
    return {"shards": shards}


def main(suite, inputs_path, out_path, init_method):
    # Eight ranks share the host with the rest of the suite: run only on
    # CPU its timing-sensitive tests leave idle.
    os.nice(19)
    torch.set_num_threads(1)
    spec = torchenv.init_distributed(device="cpu", init_method=init_method)
    inputs = dict(np.load(inputs_path))
    out = {}
    try:
        record = {"pipeline": pipeline_suite, "moe": moe_suite}[suite](
            inputs, out)
    finally:
        torch.distributed.destroy_process_group()
    if spec.process_id == 0:
        np.savez(out_path, **out)
    print(json.dumps({"rank": spec.process_id, **record}), flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:5])
