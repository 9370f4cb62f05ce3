"""Entry points: the flagship forward on one card, and the sharded dry run
of a gang's rank.

:func:`entry` is the counterpart of the JAX package's graft entry: the
flagship LM at vocab 8192 over tokens ``[2, 256]``, built by
``train.make_forward_fn`` (attention from ``best_attn_fn``: the CUDA
flash kernel on the card).

:func:`dryrun_multichip` is the rank body of the dp × tp × sp part of the
JAX package's multi-chip dry run: each rank of a gang started by
``runtime.launch`` runs it (``python -m tpushare_torch.entry ...``) and
prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
import torch.distributed as dist

from tpushare_torch.runtime import torchenv
from tpushare_torch.utils.device import resolve_device
from tpushare_torch.workload import flash_attention as FA
from tpushare_torch.workload import model as M
from tpushare_torch.workload import parallel as par
from tpushare_torch.workload import train as T

ENTRY_CONFIG = M.ModelConfig(vocab_size=8192, d_model=512, n_heads=8,
                             n_layers=4, d_ff=1536, max_seq_len=512)
#: The dry run's weights come from a generator of this seed on the rank's
#: device, its global batch from one of seed + 1.
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
    package's (vocab 256, d_model 64, max(4, tp) heads, 2 layers, d_ff
    128, 16·sp tokens a sequence, batch 2·dp); ``"flagship"`` the default
    config at the 8 × 2048 batch one card trains."""
    if width == "flagship":
        return M.ModelConfig(), (8, 2048)
    cfg = M.ModelConfig(vocab_size=256, d_model=64, n_heads=max(4, mesh.tp),
                        n_layers=2, d_ff=128, max_seq_len=16 * mesh.sp)
    return cfg, (2 * mesh.dp, cfg.max_seq_len)


def _launches() -> dict[str, int]:
    return {"flash_fwd": FA.FLASH_FWD_LAUNCHES,
            "flash_bwd_dq": FA.FLASH_BWD_DQ_LAUNCHES,
            "flash_bwd_dkv": FA.FLASH_BWD_DKV_LAUNCHES}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def dryrun_multichip(mesh_shape: tuple[int, int, int] | None = None, *,
                     attentions: tuple[str, ...] = ("ring",),
                     width: str = "tiny", steps: int = 1,
                     device: str | torch.device = "cuda",
                     backend: str | None = None,
                     init_method: str | None = None,
                     save_grads: str | None = None) -> dict:
    """One rank of the sharded dry run. Joins the gang from its env
    (``torchenv.init_distributed``; a grant in the env caps the card's
    allocator), builds the mesh (``auto_mesh_shape`` of the gang's size
    unless ``mesh_shape``), and for each attention strategy trains
    ``steps`` steps of ``make_train_step(cfg, mesh, attention=...)`` from
    the weights of generator seed ``DRYRUN_SEED`` on the global batch of
    seed ``DRYRUN_SEED + 1``, every rank making both alike. With
    ``save_grads``, rank 0 saves each strategy's first-step loss and
    gathered gradients there (``torch.save``). Returns this rank's
    record: per strategy the losses, host ms and kernel launches of each
    step, peak allocated bytes, and the card's memory in use with every
    rank's held."""
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
        mesh = par.make_mesh(*(mesh_shape
                               or par.auto_mesh_shape(spec.num_processes)))
        cfg, (batch, seq) = dryrun_config(width, mesh)
        gen = torch.Generator(device=dev).manual_seed(DRYRUN_SEED + 1)
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                               generator=gen, device=dev)
        targets = torch.roll(tokens, -1, dims=1)
        record = {"rank": spec.process_id, "mesh": list(mesh.coords),
                  "mesh_shape": mesh.shape, "device": str(dev),
                  "backend": dist.get_backend(), "memory_fraction": fraction,
                  "batch": [batch, seq], "paths": {}}
        saved = {}
        for attention in attentions:
            init_fn, step, place = T.make_train_step(
                cfg, mesh, attention=attention, device=dev)
            params, opt = init_fn(torch.Generator(device=dev)
                                  .manual_seed(DRYRUN_SEED), tokens)
            shard = place(tokens, targets)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            losses, step_ms, launches = [], [], []
            for i in range(steps):
                FA.FLASH_FWD_LAUNCHES = FA.FLASH_BWD_DQ_LAUNCHES = 0
                FA.FLASH_BWD_DKV_LAUNCHES = 0
                _sync(dev)
                t0 = time.perf_counter()
                params, opt, loss = step(params, opt, *shard)
                _sync(dev)
                step_ms.append(1e3 * (time.perf_counter() - t0))
                launches.append(_launches())
                losses.append(loss.item())
                if i == 0 and save_grads:
                    grads = par.gather_shards(
                        {n: p.grad for n, p in params.named_parameters()},
                        mesh)
                    saved[attention] = {
                        "loss": losses[0],
                        "grads": {n: g.cpu() for n, g in grads.items()}}
            path = {"losses": losses, "step_ms": step_ms,
                    "launches_per_step": launches}
            if dev.type == "cuda":
                path["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
                dist.barrier()      # every rank holds its step's memory
                free, total = torch.cuda.mem_get_info(dev)
                path["card_used_bytes"] = total - free
                dist.barrier()
            record["paths"][attention] = path
            del params, opt
        if save_grads and spec.process_id == 0:
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
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend")
    ap.add_argument("--init-method")
    ap.add_argument("--save-grads")
    args = ap.parse_args(argv)
    record = dryrun_multichip(
        tuple(int(x) for x in args.mesh.split(",")) if args.mesh else None,
        attentions=tuple(args.attention), width=args.width,
        steps=args.steps, device=args.device, backend=args.backend,
        init_method=args.init_method, save_grads=args.save_grads)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
