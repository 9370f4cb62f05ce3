"""One rank of the CPU gangs that ``test_torch_graphs_mesh.py`` starts
through ``tpushare_torch.runtime.launch``.

Run as a script (``python tests/torch_graphs_mesh_rank.py OUT
INIT_METHOD``), so it imports neither JAX nor the test conftest: numpy,
torch and the port only. It joins a gang over gloo on the CPU, sets
``graphs.STAND_IN`` to a stand-in for capture (as
``tests/test_torch_graphs.py`` does in one process), and runs the compiled
sharded steps of :data:`CASES` for the gang's size, at the dry run's tiny
width in fp32 (``entry.dryrun_config``; weights from
``entry.dryrun_generator(0)``): each compiled (3 calls: the key's eager
first call, a capture, two replays) and eagerly under ``graphs.disabled()``
(3 calls) from the same init, bit for bit. The flash wrappers' plain
versions stand for the kernels on the CPU: each call of them counts one
launch, as the kernel's wrapper does on the card, so a capture's recorded
growth and its replays' launches are checked against the design.

Rank 0 saves each case's first-step arrays (loss, gathered weights or
gradients, streams, hidden states, the MoE's output) into ``OUT``
(``.npz``) for the test to hold against the JAX package's sharded step;
each rank prints one JSON line: per case, the bit-identity verdicts, the
registry's stats and the counted launches.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import torch

from tpushare_torch import entry as E
from tpushare_torch.runtime import torchenv
from tpushare_torch.workload import collectives as C
from tpushare_torch.workload import convert
from tpushare_torch.workload import flash_attention as FA
from tpushare_torch.workload import graphs
from tpushare_torch.workload import model as M
from tpushare_torch.workload import moe
from tpushare_torch.workload import parallel as par
from tpushare_torch.workload import pipeline as P
from tpushare_torch.workload import serving as S
from tpushare_torch.workload import train as T

#: Case -> mesh (dp, tp, sp[, pp]), by the gang's size.
CASES = {
    2: {"train_ring": (1, 1, 2), "train_ulysses": (1, 1, 2),
        "train_tp": (1, 2, 1), "train_dp": (2, 1, 1),
        "generate": (1, 2, 1), "pipe": (1, 1, 1, 2), "moe": (1, 1, 2)},
    4: {"train_ring": (1, 2, 2), "generate": (2, 2, 1)},
}
CALLS = 3
#: The pipe: layers, microbatches, global batch (mb = 1).
PIPE_LAYERS, PIPE_M, PIPE_ROWS = 2, 4, 4
#: The decode: new tokens, prompt length, cache length, temperature.
N_NEW, PROMPT, MAX_LEN, TEMPERATURE = 4, 8, 16, 0.8
SAMPLE_SEEDS = (21, 22)


class StandIn:
    """What stands in for a CUDA graph on the CPU (as in
    ``tests/test_torch_graphs.py``): the capture runs the body (its
    collectives too, on every rank alike) and puts the bound tensors and
    the generator back; a replay runs the body again into the static
    outputs, with the launch counters left to the registry."""

    @staticmethod
    def warm_up(body, inputs, dev):
        return body(*inputs)

    def capture(self, body, static_in, bound, group, dev, prepare,
                generator):
        saved = [t.clone() for t in bound]
        drawn = None if generator is None else generator.get_state()
        out = graphs._eager(body, static_in, prepare)
        with torch.no_grad():
            for t, s in zip(bound, saved):
                t.copy_(s)
        if generator is not None:
            generator.set_state(drawn)
        return (body, static_in, graphs._as_tuple(out), prepare), out

    @staticmethod
    def replay(graph):
        body, static_in, static_out, prepare = graph
        counts = graphs._counts()
        new = graphs._as_tuple(graphs._eager(body, static_in, prepare))
        graphs._set_counts(counts)
        with torch.no_grad():
            for o, n in zip(static_out, new):
                o.copy_(n)


def count_plain_launches() -> None:
    """Each call of a flash wrapper's plain version counts what the
    kernel's wrapper counts on the card: one forward, or one dq and one
    dk/dv."""
    fwd, bwd = FA.flash_block_with_lse_plain, FA.flash_bwd_plain

    def counted_fwd(*args, **kw):
        FA.FLASH_FWD_LAUNCHES += 1
        return fwd(*args, **kw)

    def counted_bwd(*args, **kw):
        FA.FLASH_BWD_DQ_LAUNCHES += 1
        FA.FLASH_BWD_DKV_LAUNCHES += 1
        return bwd(*args, **kw)

    FA.flash_block_with_lse_plain = counted_fwd
    FA.flash_bwd_plain = counted_bwd


def _launches() -> list[int]:
    return [getattr(FA, name) for name in graphs.COUNTERS]


def _zero() -> None:
    for name in graphs.COUNTERS:
        setattr(FA, name, 0)


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b, strict=True))


def config(mesh) -> M.ModelConfig:
    return dataclasses.replace(E.dryrun_config("tiny", mesh)[0],
                               dtype=torch.float32)


def batch(mesh, cfg):
    _, (rows, seq) = E.dryrun_config("tiny", mesh)
    tokens = torch.randint(0, cfg.vocab_size, (rows, seq),
                           generator=E.dryrun_generator(1))
    return tokens, torch.roll(tokens, -1, dims=1)


def _opt_tensors(opt) -> list[torch.Tensor]:
    return [t for st in opt.state.values() for t in st.values()
            if isinstance(t, torch.Tensor)]


def train_case(mesh, attention, out, key):
    """3 steps compiled, then 3 eager from the same init: losses,
    weights and AdamW moments bit for bit; rank 0 keeps the first
    step's loss and gradients (gathered)."""
    cfg = config(mesh)
    make = (par.make_ulysses_attn_fn if attention == "ulysses"
            else par.make_ring_attn_fn)
    init_fn, step, place = T.make_train_step(
        cfg, mesh, attn_fn=make(mesh, use_flash=True), device="cpu")
    tokens, targets = batch(mesh, cfg)
    shard = place(tokens, targets)
    runs = {}
    for mode in ("compiled", "eager"):
        params, opt = init_fn(E.dryrun_generator(0), tokens)
        losses, per_step = [], []
        for i in range(CALLS):
            before = _launches()
            if mode == "eager":
                with graphs.disabled():
                    _, _, loss = step(params, opt, *shard)
            else:
                _, _, loss = step(params, opt, *shard)
            per_step.append([a - b for a, b in zip(_launches(), before)])
            losses.append(loss)
            if i == 0 and mode == "compiled":
                grads = par.gather_shards(
                    {n: p.grad for n, p in params.named_parameters()}, mesh)
                out[f"{key}/loss"] = np.float64(loss.item())
                for n, g in grads.items():
                    out[f"{key}/grad/{n}"] = g.numpy()
        runs[mode] = (losses, list(params.parameters()),
                      _opt_tensors(opt), per_step)
        del params, opt
    (lc, wc, oc, steps), (le, we, oe, _) = runs["compiled"], runs["eager"]
    return {"losses": [x.item() for x in lc],
            "bit_identical": _same(lc, le) and _same(wc, we)
            and _same(oc, oe) and len(oc) > 0,
            "launches_per_step": steps}


def generate_case(mesh, out, key):
    """Greedy and sampled ``generate(mesh=)``, compiled (the sampled
    graph captured from one generator and replayed with it and another)
    against eager calls from generators seeded alike."""
    cfg = dataclasses.replace(config(mesh), n_layers=2, remat=False)
    params = par.shard_params(M.init_params(E.dryrun_generator(4), cfg,
                                            "cpu"), mesh)
    prompts = torch.randint(0, cfg.vocab_size, (2 * mesh.dp, PROMPT),
                            generator=E.dryrun_generator(5))

    def call(g=None):
        return S.generate(params, prompts, cfg, N_NEW, MAX_LEN,
                          attn_fn=FA.flash_attention,
                          temperature=TEMPERATURE if g else 0.0,
                          generator=g, mesh=mesh)

    def gens():
        return [torch.Generator().manual_seed(s) for s in SAMPLE_SEEDS]

    greedy = [call() for _ in range(CALLS)]
    ga, gb = gens()
    sampled = [call(g) for g in (ga, ga, gb)]
    with graphs.disabled():
        greedy_e = [call() for _ in range(CALLS)]
        ra, rb = gens()
        sampled_e = [call(g) for g in (ra, ra, rb)]
    if mesh.rank == 0:
        out[f"{key}/stream"] = greedy[0].numpy()
    draws = all(torch.equal(a.get_state(), b.get_state())
                for a, b in ((ga, ra), (gb, rb)))
    # Every rank of the gang holds the same streams (the tp ranks drew
    # alike); the gather reads them from every rank.
    every = C.all_gather(torch.stack(sampled)[None], mesh.group(
        *mesh.axes), 0)
    return {"bit_identical": _same(greedy, greedy_e)
            and _same(sampled, sampled_e) and draws,
            "sampled_differs": not torch.equal(sampled[0], sampled[1]),
            "ranks_agree": bool((every == every[0]).all()),
            "stream_shape": list(greedy[0].shape)}


def pipe_case(mesh, out, key):
    """The GPipe forward over the stages of the flagship pipe (the
    kernels' code path in them) on 3 batches, then the 1F1B pipe over pp
    with an eager AdamW step after each call, compiled against eager
    from the same init: hidden states, losses, gradients and weights bit
    for bit. Rank 0 keeps the first GPipe output and the first 1F1B
    call's loss and gradients."""
    cfg = dataclasses.replace(config(mesh), n_layers=PIPE_LAYERS,
                              remat=False)
    init_fn, train_fn = P.make_flagship_pipeline(
        cfg, mesh, "pp", n_microbatches=PIPE_M, attn_fn=FA.flash_attention,
        device="cpu")
    rows = torch.randint(0, cfg.vocab_size, (CALLS, PIPE_ROWS,
                                             cfg.max_seq_len),
                         generator=E.dryrun_generator(1))
    runs = {}
    for mode in ("compiled", "eager"):
        stage, edge = init_fn(E.dryrun_generator(0))
        fwd = P.make_pipeline_fn(train_fn.stage_fn, mesh, "pp",
                                 n_microbatches=PIPE_M)
        hidden, gpipe_calls = [], []
        for i in range(CALLS):
            with torch.no_grad():
                x = edge["embed"][rows[i]]
            before = _launches()
            if mode == "eager":
                with graphs.disabled():
                    hidden.append(fwd(stage, x))
            else:
                hidden.append(fwd(stage, x))
            gpipe_calls.append([a - b for a, b in zip(_launches(), before)])
        params = [*stage.parameters(), *edge.parameters()]
        opt = T.make_optimizer()(params)
        losses, grads, per_call = [], [], []
        for i in range(CALLS):
            tokens = rows[0]
            before = _launches()
            if mode == "eager":
                with graphs.disabled():
                    loss = train_fn(stage, edge, tokens,
                                    torch.roll(tokens, -1, dims=1))
            else:
                loss = train_fn(stage, edge, tokens,
                                torch.roll(tokens, -1, dims=1))
            per_call.append([a - b for a, b in zip(_launches(), before)])
            losses.append(loss)
            grads += [p.grad.clone() for p in params]
            if i == 0 and mode == "compiled":
                g_stacked, g_edge = convert.pipeline_grads_to_numpy(
                    stage, edge, mesh, "pp")
                out[f"{key}/loss"] = np.float64(loss.item())
                for k, g in {**g_stacked, **g_edge}.items():
                    out[f"{key}/grad/{k}"] = g
            opt.step()
        runs[mode] = (losses, grads, params, hidden, per_call, gpipe_calls,
                      train_fn.pipe.stash_peak)
        del stage, edge, opt
    comp, eag = runs["compiled"], runs["eager"]
    staged = C.all_gather(comp[3][0][None], mesh.group("pp"), 0)
    if mesh.rank == 0:
        out[f"{key}/gpipe"] = P.last_stage_output(staged[-1]).numpy()
    return {"losses": [x.item() for x in comp[0]],
            "bit_identical": all(_same(c, e) for c, e in zip(comp[:4],
                                                               eag[:4])),
            "launches_per_call": comp[4], "gpipe_launches": comp[5],
            "stash_peak": comp[6]}


def moe_case(mesh, out, key):
    """The ring-MoE's value and gradient over sp (E = 2·sp) on 3 token
    batches, compiled against eager: losses, outputs and gradients bit
    for bit. Rank 0 keeps the first call's loss, output and gradients
    (the experts' gathered over sp)."""
    cfg = config(mesh)
    _, (rows, seq) = E.dryrun_config("tiny", mesh)
    params = moe.init_moe_params(E.dryrun_generator(2), cfg.d_model,
                                 cfg.d_ff, 2 * mesh.sp, "cpu")
    xs = torch.randn((CALLS, rows, seq, cfg.d_model),
                     generator=E.dryrun_generator(3))
    vg = moe.make_ring_moe_value_and_grad(mesh, "sp")
    runs = {}
    for mode in ("compiled", "eager"):
        placed = {k: v.requires_grad_() for k, v in
                  moe.place_moe_params(params, mesh, "sp").items()}
        got = []
        for i in range(CALLS):
            x = xs[i].chunk(mesh.sp, dim=1)[mesh.sp_rank]
            if mode == "eager":
                with graphs.disabled():
                    loss, y = vg(placed, x, xs[i].numel())
            else:
                loss, y = vg(placed, x, xs[i].numel())
            got += [loss, y, *(placed[k].grad.clone() for k in sorted(placed))]
            if i == 0 and mode == "compiled":
                y_all = C.all_gather(y, mesh.sp_group, 1)
                w = {k: C.all_gather(placed[k].grad, mesh.sp_group, 0)
                     for k in ("w1", "w2")}
                if mesh.rank == 0:
                    out[f"{key}/loss"] = np.float64(loss.item())
                    out[f"{key}/y"] = y_all.numpy()
                    out[f"{key}/grad/router"] = placed["router"].grad.numpy()
                    for k, g in w.items():
                        out[f"{key}/grad/{k}"] = g.numpy()
        runs[mode] = got
    return {"bit_identical": _same(runs["compiled"], runs["eager"])}


def _trace(fn):
    """``fn``'s collectives, as ``collectives.recorded`` lists them."""
    with C.recorded() as seen:
        fn()
    return seen


def run_case(name, shape, out):
    mesh = par.make_mesh(*shape)
    graphs.clear()
    _zero()
    if name.startswith("train"):
        attention = "ulysses" if name == "train_ulysses" else "ring"
        rec = train_case(mesh, attention, out, name)
    elif name == "generate":
        rec = generate_case(mesh, out, name)
    elif name == "pipe":
        rec = pipe_case(mesh, out, name)
    else:
        rec = moe_case(mesh, out, name)
    rec.update(mesh=list(shape), backend=mesh.backend,
               captures_here=graphs.captures(torch.device("cpu"), mesh),
               stats=graphs.stats(),
               captured=[(c["name"], list(c["growth"]))
                         for c in graphs.CAPTURES])
    return rec


def main(out_path, init_method):
    os.nice(19)
    torch.set_num_threads(1)
    spec = torchenv.init_distributed(device="cpu", init_method=init_method)
    graphs.STAND_IN = StandIn()
    count_plain_launches()
    out, record = {}, {"rank": spec.process_id, "cases": {}}
    try:
        for name, shape in CASES[spec.num_processes].items():
            record["cases"][name] = run_case(name, shape, out)
        # A capture that issues a collective its warm-up did not raises:
        # a body that reduces only once it has been called before.
        mesh = par.make_mesh(1, 1, spec.num_processes)
        calls = []

        def uneven(x):
            calls.append(1)
            return C.all_reduce(x, mesh.sp_group) if len(calls) > 1 else x

        try:
            graphs.run("uneven", uneven, (torch.ones(2),), mesh=mesh)
            record["uneven"] = "not refused"
        except RuntimeError as exc:
            record["uneven"] = str(exc)
        record["gloo_collective_trace"] = [
            list(map(str, e)) for e in _trace(
                lambda: C.all_reduce(torch.ones(3), mesh.sp_group))]
    finally:
        torch.distributed.destroy_process_group()
    if spec.process_id == 0:
        np.savez(out_path, **out)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
