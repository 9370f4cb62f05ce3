"""One rank of the CPU gang that ``test_torch_serving_tp.py`` starts
through ``tpushare_torch.runtime.launch``.

Run as a script (``python tests/torch_serving_tp_rank.py INPUTS OUT
INIT_METHOD``), so it imports neither JAX nor the test conftest: numpy,
torch and the port only. It reads the test's weights (the JAX package's
tiny fp32 tree), prompts and JAX's greedy stream (``INPUTS``, an
``.npz``), joins a (2, 2, 1) gang of 4 over gloo on the CPU and runs the
tensor-parallel decode:

* teacher-forced: ``prefill`` of its dp shard of the prompts, then
  ``decode_step`` fed JAX's stream, each step's logits gathered over dp;
* ``generate`` greedy, and at temperature 0.8 with a generator of the
  same seed on every rank, the streams of its tp pair gathered;
* the prefill's ``attn_fn`` calls, the cache's shape, and a cache of
  heads that do not split over tp, refused.

Rank 0 saves every array into ``OUT`` (``.npz``); each rank prints one
JSON line.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import torch

from tpushare_torch.runtime import torchenv
from tpushare_torch.workload import collectives as C
from tpushare_torch.workload import convert
from tpushare_torch.workload import model as M
from tpushare_torch.workload import parallel as par
from tpushare_torch.workload import serving as S

CFG = M.ModelConfig(vocab_size=256, d_model=64, n_heads=4, n_layers=2,
                    d_ff=128, max_seq_len=128, dtype=torch.float32,
                    remat=False)
MAX_LEN = 16


def _tree(inputs):
    return {"embed": inputs["p/embed"], "final_norm": inputs["p/final_norm"],
            "blocks": [{key: inputs[f"p/blocks/{i}/{key}"]
                        for key in convert._BLOCK_KEYS}
                       for i in range(CFG.n_layers)]}


def main(inputs_path, out_path, init_method):
    os.nice(19)
    torch.set_num_threads(1)
    spec = torchenv.init_distributed(device="cpu", init_method=init_method)
    inputs = np.load(inputs_path)
    prompts = torch.from_numpy(inputs["prompts"]).long()
    stream = torch.from_numpy(inputs["stream"]).long()
    out, record = {}, {"rank": spec.process_id}
    try:
        mesh = par.make_mesh(2, 2, 1)
        tp = mesh.tp_group
        params = par.shard_params(
            convert.params_from_jax(_tree(inputs), CFG, "cpu"), mesh)
        calls = []

        def attn(q, k, v):
            calls.append(tuple(q.shape))
            return M.causal_attention(q, k, v)

        local = par.place_batch(mesh, prompts, sequence=False)
        fed = par.place_batch(mesh, stream, sequence=False)
        cache = S.init_cache(CFG, local.shape[0], MAX_LEN, "cpu", tp=tp)
        record["cache_shape"] = list(cache[0]["k"].shape)
        try:
            S.init_cache(dataclasses.replace(CFG, n_heads=3), 1, MAX_LEN,
                         "cpu", tp=tp)
        except ValueError as exc:
            record["refused"] = str(exc)
        logits, cache = S.prefill(params, local, cache, attn_fn=attn, tp=tp)
        record["prefill_attn_calls"] = calls
        steps = [logits]
        length = prompts.shape[1]
        for pos in range(length, stream.shape[1] - 1):
            logits, cache = S.decode_step(params, cache, fed[:, pos], pos,
                                          tp=tp)
            steps.append(logits)
        out["teacher_forced"] = C.all_gather(torch.stack(steps, 1),
                                             mesh.dp_group, 0).numpy()
        n_new = stream.shape[1] - length
        out["greedy"] = S.generate(params, prompts, CFG, n_new, MAX_LEN,
                                   mesh=mesh).numpy()
        sampled = S.generate(params, prompts, CFG, n_new, MAX_LEN,
                             temperature=0.8, mesh=mesh,
                             generator=torch.Generator().manual_seed(3))
        out["sampled_by_tp_rank"] = C.all_gather(sampled[None], tp,
                                                 0).numpy()
    finally:
        torch.distributed.destroy_process_group()
    if spec.process_id == 0:
        np.savez(out_path, **out)
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:4])
