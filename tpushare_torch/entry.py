"""Entry points: the flagship forward on one card, and the sharded dry run
of a gang's rank.

:func:`entry` is the counterpart of the JAX package's graft entry: the
flagship LM at vocab 8192 over tokens ``[2, 256]``, built by
``train.make_forward_fn`` (attention from ``best_attn_fn``: the CUDA
flash kernel on the card).

:func:`dryrun_multichip` is the rank body of the JAX package's multi-chip
dry run: dp × tp × sp training (checkpointed and resumed on request),
the ring-MoE, the flagship pipes and the tp-sharded decode
(:data:`PARTS`). Each rank of a gang started by ``runtime.launch`` runs
it (``python -m tpushare_torch.entry ...``) and prints one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch
import torch.distributed as dist

from tpushare_torch.runtime import torchenv
from tpushare_torch.utils.device import resolve_device
from tpushare_torch.workload import checkpoint as CK
from tpushare_torch.workload import collectives as C
from tpushare_torch.workload import convert
from tpushare_torch.workload import flash_attention as FA
from tpushare_torch.workload import model as M
from tpushare_torch.workload import moe
from tpushare_torch.workload import parallel as par
from tpushare_torch.workload import pipeline
from tpushare_torch.workload import serving as S
from tpushare_torch.workload import train as T

ENTRY_CONFIG = M.ModelConfig(vocab_size=8192, d_model=512, n_heads=8,
                             n_layers=4, d_ff=1536, max_seq_len=512)
#: The dry run's weights come from a host generator of this seed, its
#: global batch from one of seed + 1 (:func:`dryrun_generator`).
DRYRUN_SEED = 0


def entry(device: str | torch.device = "cuda"):
    """(forward fn, example args) for the flagship model on ``device``.
    The forward runs under ``torch.inference_mode()`` and returns fp32
    logits [2, 256, 8192]."""
    dev = resolve_device(device)
    cfg = ENTRY_CONFIG
    params = M.init_params(torch.Generator().manual_seed(0), cfg, dev)
    tokens = torch.zeros((2, 256), dtype=torch.long, device=dev)
    return T.make_forward_fn(cfg, device=dev), (params, tokens)


def dryrun_config(width: str, mesh: par.Mesh) -> tuple[M.ModelConfig,
                                                        tuple[int, int]]:
    """(config, global batch) of the dry run: ``"tiny"`` is the JAX
    package's exactly (``__graft_entry__.dryrun_multichip``: vocab 256,
    d_model 64, max(4, tp) heads, 2 layers, d_ff 128, 16·sp tokens a
    sequence, batch 2·dp, the default dtype bf16, so head_dim 16 through
    the bf16 kernels on a card); its other tiny parts set fp32 themselves,
    as the reference's do. ``"flagship"`` is the default config (bf16) at
    the 8 × 2048 batch one card trains."""
    if width == "flagship":
        return M.ModelConfig(), (8, 2048)
    cfg = M.ModelConfig(vocab_size=256, d_model=64, n_heads=max(4, mesh.tp),
                        n_layers=2, d_ff=128, max_seq_len=16 * mesh.sp)
    return cfg, (2 * mesh.dp, cfg.max_seq_len)


#: The dry run's parts, in the reference's order (``__graft_entry__.py``):
#: dp × tp × sp training, the ring-MoE over sp, the flagship 1F1B pipe
#: over the sp axis, dp × pp, dp × tp × pp and dp × tp × sp × pp, and the
#: tensor-parallel decode on the training mesh's dp × tp.
PARTS = ("train", "moe", "pipe", "dp_pp", "dp_tp_pp", "4d", "serve")


def _launches() -> dict[str, int]:
    return {"flash_fwd": FA.FLASH_FWD_LAUNCHES,
            "flash_bwd_dq": FA.FLASH_BWD_DQ_LAUNCHES,
            "flash_bwd_dkv": FA.FLASH_BWD_DKV_LAUNCHES}


def _reset_launches() -> None:
    FA.FLASH_FWD_LAUNCHES = FA.FLASH_BWD_DQ_LAUNCHES = 0
    FA.FLASH_BWD_DKV_LAUNCHES = 0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def dryrun_generator(offset: int) -> torch.Generator:
    """The generator of seed ``DRYRUN_SEED + offset`` the dry run draws
    from. It is the host's on every device (draws are moved to the rank's
    device after), so a gang on the card and the same gang on the host
    start from the same weights and batch."""
    return torch.Generator().manual_seed(DRYRUN_SEED + offset)


def _memory(dev: torch.device) -> dict:
    """Peak bytes this rank allocated, and the card's bytes in use while
    every rank holds its memory (a collective)."""
    if dev.type != "cuda":
        return {}
    out = {"peak_bytes": torch.cuda.max_memory_allocated(dev)}
    dist.barrier()
    free, total = torch.cuda.mem_get_info(dev)
    out["card_used_bytes"] = total - free
    dist.barrier()
    return out


def _timed(dev: torch.device, fn):
    """(fn's result, host ms, kernel launches) of one call, the launch
    counters set to 0 just before."""
    _reset_launches()
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, 1e3 * (time.perf_counter() - t0), _launches()


def pipe_setup(part: str, width: str, mesh: par.Mesh, world: int):
    """(mesh shape, pipe axis, config, microbatches, global batch, factory
    kwargs) of a pipeline part, or None where the gang is too small for
    it; the shape is None for the part that pipes over the training
    ``mesh`` itself. Tiny width is the reference's dry run: fp32, no
    remat, the pipe over the training mesh's sp axis with one layer a
    stage and M = 2·sp; dp × pp on a (ranks / sp, sp) mesh; dp × tp × pp
    and the 4D pipe at (2, 2, 2) and (1, 2, 2, 2), dp taking the ranks
    past 8. Flagship width is the default config at the 8 × 2048 batch,
    bf16."""
    n = mesh.sp
    base, (_, seq) = dryrun_config("tiny", mesh)
    axis = "pp"
    if part == "pipe":
        shape, axis, kw = None, "sp", {}
        cfg = dataclasses.replace(base, n_layers=n)
        m, rows = 2 * n, 2 * n
    elif part == "dp_pp":
        if n < 2 or world // n < 2:
            return None
        shape, kw = (world // n, 1, 1, n), {"dp_axis": "dp"}
        cfg = dataclasses.replace(base, n_layers=n)
        m, rows = 2 * n, 2 * n * (world // n)
    else:
        if world % 8:
            return None
        tiny = dataclasses.replace(base, n_heads=max(base.n_heads
                                                     - base.n_heads % 2, 2),
                                   n_layers=2)
        if part == "dp_tp_pp":
            shape, kw = (world // 4, 2, 1, 2), {"dp_axis": "dp",
                                                 "tp_axis": "tp"}
            cfg, m, rows = tiny, 4, 4 * (world // 4)
        else:
            shape = (world // 8, 2, 2, 2)
            kw = {"dp_axis": "dp", "tp_axis": "tp", "sp_axis": "sp"}
            cfg = dataclasses.replace(tiny, max_seq_len=32)
            m, rows, seq = 2, 2 * (world // 8), 32
    if width == "flagship":
        cfg, (rows, seq) = M.ModelConfig(), (8, 2048)
        m = {"pipe": 2 * n, "dp_pp": 4, "dp_tp_pp": 4, "4d": 8}[part]
    else:
        cfg = dataclasses.replace(cfg, dtype=torch.float32, remat=False)
    return shape, axis, cfg, m, (rows, seq), kw


def moe_inputs(width: str, mesh: par.Mesh, dev: torch.device):
    """(full params, global x [B, S, D]) of the ring-MoE part: E = 2·sp
    experts, fp32; the tiny width's d_model, d_ff and [batch, seq] are
    the training config's, the flagship's 512, 1536 and 8 × 2048."""
    cfg, (batch, seq) = dryrun_config(width, mesh)
    params = moe.init_moe_params(dryrun_generator(2), cfg.d_model, cfg.d_ff,
                                 2 * mesh.sp, dev)
    x = torch.randn((batch, seq, cfg.d_model),
                    generator=dryrun_generator(3)).to(dev)
    return params, x


def _weights(params, mesh) -> dict:
    """The full weights on the host, gathered over tp (a collective)."""
    return {n: p.detach().cpu()
            for n, p in par.gather_params(params, mesh).named_parameters()}


def _train_part(cfg, mesh, tokens, targets, attentions, steps, dev, save,
                record, saved, ckpt: dict) -> None:
    """dp × tp × sp training, one path an attention strategy; with
    ``ckpt["directory"]``, checkpoints (``workload.checkpoint``): resume
    from the latest step there (``ckpt["resume"]``), then an async save
    after every ``ckpt["every"]``-th step."""
    if ckpt["directory"] and len(attentions) > 1:
        raise ValueError("a checkpointed run trains one attention strategy")
    for attention in attentions:
        init_fn, step, place = T.make_train_step(
            cfg, mesh, attention=attention, device=dev)
        params, opt = init_fn(dryrun_generator(0), tokens)
        shard = place(tokens, targets)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        losses, step_ms, launches, done = [], [], [], 0
        ckpt_rec, weights = {}, {}
        ckptr = (CK.Checkpointer(CK.CheckpointConfig(ckpt["directory"]), mesh)
                 if ckpt["directory"] else None)
        if ckptr is not None and ckpt["resume"]:
            restored, ms, _ = _timed(dev, lambda: ckptr.restore(params, opt))
            if restored is None:
                raise RuntimeError(f"nothing to resume from in "
                                   f"{ckpt['directory']}")
            done = restored[2]
            ckpt_rec.update(restored_step=done, restore_ms=ms,
                            restore_stats=ckptr.last_restore_stats)
            if save:
                weights["restored"] = _weights(params, mesh)
        for i in range(done, steps):
            (params, opt, loss), ms, counts = _timed(
                dev, lambda: step(params, opt, *shard))
            step_ms.append(ms)
            launches.append(counts)
            losses.append(loss.item())
            if i == done and save:
                grads = par.gather_shards(
                    {n: p.grad for n, p in params.named_parameters()}, mesh)
                saved[attention] = {
                    "loss": losses[0],
                    "grads": {n: g.cpu() for n, g in grads.items()}}
            every = ckpt["every"]
            if ckptr is not None and every and (i + 1) % every == 0:
                ckptr.save(i + 1, params, opt)
                ckpt_rec.setdefault("saved_steps", []).append(i + 1)
                ckpt_rec.setdefault("save_blocked_ms", []).append(
                    1e3 * ckptr.last_save_stats["blocked_s"])
                if save:
                    weights[i + 1] = _weights(params, mesh)
        if ckptr is not None:
            ckptr.close()
            stats = ckptr.last_save_stats
            if "durable_s" in stats:
                ckpt_rec.update(durable_ms=1e3 * stats["durable_s"],
                                bytes=stats.get("bytes"))
        if save and ckptr is not None:
            weights["final"] = _weights(params, mesh)
            saved["checkpoint"] = {"losses": losses, "weights": weights}
        record["paths"][attention] = {"dtype": str(cfg.dtype),
                                      "losses": losses, "step_ms": step_ms,
                                      "steps": list(range(done + 1,
                                                          steps + 1)),
                                      "launches_per_step": launches,
                                      **({"checkpoint": ckpt_rec}
                                         if ckptr is not None else {}),
                                      **_memory(dev)}
        del params, opt


def _moe_part(width, mesh, steps, dev, save, saved) -> dict:
    """The ring-MoE over the mesh's sp group: forward and backward of
    mean(y²) over the global tokens."""
    params, x = moe_inputs(width, mesh, dev)
    placed = {k: v.requires_grad_() for k, v in
              moe.place_moe_params(params, mesh, "sp").items()}
    xs = x.chunk(mesh.sp, dim=1)[mesh.sp_rank]
    fn = moe.make_ring_moe_fn(mesh, "sp")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, call_ms, launches = [], [], []

    def call():
        for v in placed.values():
            v.grad = None
        y = fn(placed, xs)
        local = y.square().sum() / x.numel()
        local.backward()
        return y, C.all_reduce(local.detach(), mesh.sp_group)

    for _ in range(steps):
        (y, loss), ms, counts = _timed(dev, call)
        losses.append(loss.item())
        call_ms.append(ms)
        launches.append(counts)
    if save:
        group = mesh.sp_group
        out = {"loss": losses[0],
               "y": C.all_gather(y.detach(), group, 1).cpu(),
               "grads": {"router": placed["router"].grad.cpu(),
                         **{k: C.all_gather(placed[k].grad, group, 0).cpu()
                            for k in ("w1", "w2")}}}
        if mesh.rank == 0:
            saved["moe"] = out
    return {"experts": params["w1"].shape[0],
            "experts_per_rank": placed["w1"].shape[0],
            "tokens_per_rank": list(xs.shape), "losses": losses,
            "call_ms": call_ms, "launches_per_call": launches,
            **_memory(dev)}


def _pipe_part(part, width, train_mesh, world, steps, dev, save,
               saved) -> dict:
    """A flagship pipe part (:func:`pipe_setup`) through the 1F1B train_fn,
    ``steps`` calls at the same weights; dp × pp also runs the GPipe
    forward over the same stages."""
    setup = pipe_setup(part, width, train_mesh, world)
    if setup is None:
        return {"skipped": f"a gang of {world} ranks has no room for it"}
    shape, axis, cfg, m, (rows, seq), kw = setup
    mesh = par.make_mesh(*shape) if shape else train_mesh
    init_fn, train_fn = pipeline.make_flagship_pipeline(
        cfg, mesh, axis, n_microbatches=m, device=dev, **kw)
    stage, edge = init_fn(dryrun_generator(0))
    tokens = torch.randint(0, cfg.vocab_size, (rows, seq),
                           generator=dryrun_generator(1)).to(dev)
    targets = torch.roll(tokens, -1, dims=1)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, call_ms, launches = [], [], []
    for _ in range(steps):
        loss, ms, counts = _timed(
            dev, lambda: train_fn(stage, edge, tokens, targets))
        losses.append(loss.item())
        call_ms.append(ms)
        launches.append(counts)
    rec = {"mesh_shape": mesh.shape, "pipe_axis": axis, "microbatches": m,
           "layers_per_stage": len(stage), "batch": [rows, seq],
           "dtype": str(cfg.dtype), "losses": losses, "call_ms": call_ms,
           "launches_per_call": launches,
           "stash_peak": train_fn.pipe.stash_peak, **_memory(dev)}
    out = {}
    if save:
        g_stacked, g_edge = convert.pipeline_grads_to_numpy(
            stage, edge, mesh, axis, kw.get("tp_axis"))
        out = {"loss": losses[0], "grads": {
            **{k: torch.from_numpy(g) for k, g in g_edge.items()},
            **{f"blocks.{i}.{k}": torch.from_numpy(layer)
               for k, g in g_stacked.items()
               for i, layer in enumerate(g.reshape((-1,) + g.shape[2:]))}}}
    if part == "dp_pp":
        fwd = pipeline.make_pipeline_fn(train_fn.stage_fn, mesh, axis,
                                        n_microbatches=m)
        with torch.no_grad():
            x = edge["embed"][tokens.chunk(mesh.dp)[mesh.dp_rank]]
        outs, ms, counts = _timed(dev, lambda: fwd(stage, x))
        rec["gpipe"] = {"call_ms": ms, "launches": counts}
        if save:
            every = C.all_gather(outs[None], mesh.group("dp", "pp"), 0)
            out["gpipe"] = torch.cat([pipeline.last_stage_output(o)
                                      for o in every[mesh.pp - 1::mesh.pp]]
                                     ).cpu()
    if out and mesh.rank == 0:
        saved[f"pipe_{part}"] = out
    return rec


def serve_setup(width: str, mesh: par.Mesh):
    """(config, [batch, prompt length], new tokens, cache length) of the
    serve part: at ``"tiny"`` width the reference's dry-run decode (the
    training config at 2 layers, fp32, prompts [2·dp, 8], 4 new tokens,
    a 16-token cache); at ``"flagship"`` the default config, bf16, 8 ×
    (128 + 64) as phase 5 of ``chip_smoke.py`` serves it."""
    if width == "flagship":
        return M.ModelConfig(), (8, 128), 64, 192
    base, _ = dryrun_config("tiny", mesh)
    cfg = dataclasses.replace(base, n_layers=2, dtype=torch.float32,
                              remat=False)
    return cfg, (2 * mesh.dp, 8), 4, 16


def serve_prompts(cfg: M.ModelConfig, shape, dev: torch.device):
    """The serve part's global prompts, which every rank draws alike."""
    return torch.randint(0, cfg.vocab_size, shape,
                         generator=dryrun_generator(5)).to(dev)


def _serve_part(width, mesh, dev, save, saved, ckpt: dict) -> dict:
    """The tensor-parallel decode: ``generate`` on the training mesh's dp
    × tp (sp ranks are replicas) from weights of seed ``DRYRUN_SEED +
    4``, or restored from the latest checkpoint (``ckpt["resume"]``),
    with the prefill attention ``best_attn_fn`` picks."""
    cfg, shape, n_new, max_len = serve_setup(width, mesh)
    params = par.shard_params(M.init_params(dryrun_generator(4), cfg, dev),
                              mesh)
    rec = {"heads_per_rank": cfg.n_heads // mesh.tp,
           "dtype": str(cfg.dtype)}
    if ckpt["resume"]:
        ckptr = CK.Checkpointer(CK.CheckpointConfig(ckpt["directory"]), mesh)
        # The restore's optimizer target, built before the clock starts as
        # the train part's is (the first optimizer a process builds imports
        # torch._dynamo, seconds on a shared host).
        opt = T.make_optimizer()(params.parameters())
        restored, rec["restore_ms"], _ = _timed(
            dev, lambda: ckptr.restore(params, opt))
        ckptr.close()
        del opt
        if restored is None:
            raise RuntimeError(f"nothing to resume from in "
                               f"{ckpt['directory']}")
        rec.update(restored_step=restored[2],
                   restore_stats=ckptr.last_restore_stats)
    prompts = serve_prompts(cfg, shape, dev)
    attn_fn = FA.best_attn_fn(dev)
    out, ms, counts = _timed(dev, lambda: S.generate(
        params, prompts, cfg, n_new, max_len, attn_fn=attn_fn, mesh=mesh))
    rows = shape[0] // mesh.dp
    rec.update(batch=list(shape), n_new=n_new, tokens_shape=list(out.shape),
               prompt_kept=bool(torch.equal(out[:, :shape[1]], prompts)),
               in_vocab=bool(((out >= 0) & (out < cfg.vocab_size)).all()),
               generate_ms=ms, new_tok_per_s=rows * n_new / (ms / 1e3),
               launches=counts, **_memory(dev))
    if save:
        tp = mesh.tp_group if mesh.tp > 1 else None
        local = par.place_batch(mesh, prompts, sequence=False)
        logits, _ = S.prefill(params, local, S.init_cache(
            cfg, rows, max_len, dev, tp=tp), attn_fn=attn_fn, tp=tp)
        if mesh.dp > 1:
            logits = C.all_gather(logits, mesh.dp_group, 0)
        if mesh.rank == 0:
            saved["serve"] = {"tokens": out.cpu(),
                              "prefill_logits": logits.cpu()}
    return rec


def dryrun_multichip(mesh_shape: tuple[int, int, int] | None = None, *,
                     attentions: tuple[str, ...] = ("ring",),
                     width: str = "tiny", steps: int = 1,
                     parts: tuple[str, ...] = PARTS,
                     device: str | torch.device = "cuda",
                     backend: str | None = None,
                     init_method: str | None = None,
                     save_grads: str | None = None,
                     ckpt_dir: str | None = None,
                     ckpt_every: int | None = None,
                     resume: bool = False) -> dict:
    """One rank of the sharded dry run. Joins the gang from its env
    (``torchenv.init_distributed``; a grant in the env caps the card's
    allocator), builds the training mesh (``auto_mesh_shape`` of the
    gang's size unless ``mesh_shape``) and runs ``parts`` (:data:`PARTS`),
    ``steps`` steps or calls each, every rank drawing the weights from
    generator seed ``DRYRUN_SEED`` and the global batch from seed
    ``DRYRUN_SEED + 1`` alike:

    * ``"train"``: ``make_train_step(cfg, mesh, attention=...)`` for each
      attention strategy;
    * ``"moe"``: the ring-MoE over sp (:func:`moe_inputs`);
    * ``"pipe"``, ``"dp_pp"``, ``"dp_tp_pp"``, ``"4d"``: the flagship
      1F1B pipe (:func:`pipe_setup`); ``"dp_pp"`` also runs the GPipe
      forward over the same stages;
    * ``"serve"``: ``generate`` tensor-parallel on the mesh's dp × tp
      (:func:`serve_setup`).

    With ``ckpt_dir``, training checkpoints there: ``resume`` restores
    the latest step first (training then runs the steps after it, up to
    ``steps``), and an async save follows every ``ckpt_every``-th step;
    the serve part, with ``resume``, serves the latest step's weights.

    With ``save_grads``, rank 0 saves each path's first loss and gathered
    gradients there (``torch.save``; the MoE's output too, the GPipe's
    last-stage hidden states, the gathered weights at each save, after a
    restore and after the last step, the served stream and its prefill
    logits). Returns this rank's record: per path the losses, host ms and
    kernel launches of each step or call, peak allocated bytes, and the
    card's memory in use with every rank's held; the checkpoint's save
    and restore ms and bytes on disk."""
    unknown = set(parts) - set(PARTS)
    if unknown:
        raise ValueError(f"unknown dry-run parts {sorted(unknown)}; the "
                         f"parts are {PARTS}")
    grant = torchenv.configure()
    dev = resolve_device(device)
    spec = torchenv.init_distributed(backend=backend, device=dev,
                                     init_method=init_method)
    if spec is None:
        raise RuntimeError("not a gang member: the gang env "
                           "(TPUSHARE_POD_GROUP, TPUSHARE_POD_GROUP_SIZE, "
                           "JOB_COMPLETION_INDEX) is not set")
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        fraction = torchenv.apply_memory_fraction(grant)
    else:
        fraction = None
        torch.set_num_threads(1)
    try:
        world = spec.num_processes
        mesh = par.make_mesh(*(mesh_shape or par.auto_mesh_shape(world)))
        cfg, (batch, seq) = dryrun_config(width, mesh)
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                               generator=dryrun_generator(1)).to(dev)
        targets = torch.roll(tokens, -1, dims=1)
        record = {"rank": spec.process_id, "mesh": list(mesh.coords),
                  "mesh_shape": mesh.shape, "device": str(dev),
                  "backend": dist.get_backend(), "memory_fraction": fraction,
                  "batch": [batch, seq], "paths": {}, "parts": {}}
        saved = {}
        save = save_grads is not None
        ckpt = {"directory": ckpt_dir, "every": ckpt_every,
                "resume": resume}
        for part in (p for p in PARTS if p in parts):
            if part == "train":
                _train_part(cfg, mesh, tokens, targets, attentions, steps,
                            dev, save, record, saved, ckpt)
            elif part == "serve":
                record["parts"][part] = _serve_part(width, mesh, dev, save,
                                                    saved, ckpt)
            elif part == "moe":
                record["parts"][part] = _moe_part(width, mesh, steps, dev,
                                                  save, saved)
            else:
                record["parts"][part] = _pipe_part(part, width, mesh, world,
                                                   steps, dev, save, saved)
        if save and spec.process_id == 0:
            torch.save(saved, save_grads)
        return record
    finally:
        dist.destroy_process_group()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="One rank of the sharded dry run; start the gang with "
                    "tpushare_torch.runtime.launch.")
    ap.add_argument("--mesh", help="dp,tp,sp (default: auto_mesh_shape)")
    ap.add_argument("--attention", nargs="+", default=["ring"],
                    choices=["ring", "ulysses"])
    ap.add_argument("--width", default="tiny", choices=["tiny", "flagship"])
    ap.add_argument("--steps", type=int, default=1,
                    help="steps (or calls) of each path")
    ap.add_argument("--parts", nargs="+", default=list(PARTS),
                    choices=PARTS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend")
    ap.add_argument("--init-method")
    ap.add_argument("--save-grads")
    ap.add_argument("--ckpt-dir", help="checkpoint directory of the train "
                    "and serve parts")
    ap.add_argument("--ckpt-every", type=int,
                    help="save after every N-th training step")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint first")
    args = ap.parse_args(argv)
    if (args.ckpt_every or args.resume) and not args.ckpt_dir:
        ap.error("--ckpt-every and --resume need --ckpt-dir")
    record = dryrun_multichip(
        tuple(int(x) for x in args.mesh.split(",")) if args.mesh else None,
        attentions=tuple(args.attention), width=args.width,
        steps=args.steps, parts=tuple(args.parts), device=args.device,
        backend=args.backend,
        init_method=args.init_method, save_grads=args.save_grads,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        resume=args.resume)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
