"""Eager against compiled steps, in turns on one card: the bench twin's
serving and train sections, and the card's busy share of each path.

    python tools/graphs_ab.py [--iters 5] [--out build/graphs_ab.json]

Each section of ``bench_workload_torch.py`` (whole requests, the slot
server and its admissions, the paged server, the flagship and the large
train step, flash side) runs once under ``graphs.disabled()`` (the eager
bodies: the port before its steps were compiled) and once as it runs by
default (CUDA graphs, ``workload.graphs``), in turns: eager, compiled,
compiled, eager. The serving sections time ``--iters`` calls a run (the
twin's own count is 40 / 20; phase 8 of ``chip_smoke.py`` takes 3).
Then one call of each path is profiled in each mode, after two untimed
calls: its host ms, the card's busy ms and their ratio (``generate`` 8 x
(128 + 64), a 64-step chunk of the 8-slot server at the twin's prompt
mix, the paged chunk at 16 streams, the flagship train step at 16 x
2048). Then the three admissions of a 1024-token prompt in 64-token
pieces on the 8-slot server, eager against compiled in turns
(``chip_smoke.admission_turns``, what phase 9 records): chunked (and the
pause a piece), interleaved beside seven decoding slots (and the pause a
co-tenant sees a piece) and paged, and one compiled piece of each kind
profiled, with the gather of the slot's row timed alone. Prints one
JSON object and the card's name and power limit as ``nvidia-smi`` gives
them; writes the JSON to ``--out``. Needs one card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import bench_workload_torch as BW  # noqa: E402
import chip_smoke as CS  # noqa: E402
from tpushare_torch.workload import flash_attention as FA  # noqa: E402
from tpushare_torch.workload import graphs  # noqa: E402
from tpushare_torch.workload import model as M  # noqa: E402
from tpushare_torch.workload import paging  # noqa: E402
from tpushare_torch.workload import serving as S  # noqa: E402
from tpushare_torch.workload import train as T  # noqa: E402

MODES = ("eager", "compiled", "compiled", "eager")


def _mode(mode: str):
    return graphs.disabled() if mode == "eager" else contextlib.nullcontext()


def _fresh() -> None:
    graphs.clear()
    torch.cuda.empty_cache()


def sections(kind: str, iters: int) -> dict:
    """Each twin section's headline numbers in each mode, in turns."""
    runs = {
        "decode": (lambda: BW.bench_decode(False, iters=iters, reps=1),
                   ("request_ms", "per_token_ms")),
        "continuous": (lambda: BW.bench_decode_continuous(
            False, iters=iters, reps=1),
            ("chunk_ms", "per_token_ms", "static_same_maxlen_tokens_per_s",
             "admission_overhead_pct")),
        "paged": (lambda: BW.bench_decode_paged(False, iters=iters, reps=1),
                  ("rows_chunk_ms", "paged_chunk_ms", "per_stream_ratio")),
        "train": (lambda: BW.bench_train(kind, False, sides=("flash",))
                  ["flash"], ("step_ms", "tokens_per_s", "mfu")),
        "train_large": (lambda: BW.bench_train(
            kind, False, cfg=BW.large_config(), batch=8, iters=8,
            sides=("flash",))["flash"], ("step_ms", "tokens_per_s", "mfu")),
    }
    result = {}
    for name, (run, keys) in runs.items():
        rows = {"eager": [], "compiled": []}
        for mode in MODES:
            _fresh()
            with _mode(mode):
                got = run()
            row = {key: got[key] for key in keys}
            if name == "continuous":
                row["admit_steady_ms"] = {
                    b: e["steady_ms"] for b, e in got["admissions"].items()}
            rows[mode].append(row)
        result[name] = rows
        print(f"  {name}: {rows}", file=sys.stderr, flush=True)
    _fresh()
    return result


def _busy(fn) -> dict:
    for _ in range(2):
        fn()
    secs, on_card, _ = CS.profiled(fn)
    busy_us = CS._busy_us(on_card)
    return {"host_ms": 1e3 * secs, "device_ms": busy_us / 1e3,
            "busy_share": busy_us / (secs * 1e6)}


def busy_shares() -> dict:
    """One profiled call of each path in each mode, in turns."""
    cfg = dataclasses.replace(M.ModelConfig(), remat=False)
    gen = CS._dev_gen(0)
    params = M.init_params(gen, cfg)
    prompt = torch.randint(0, cfg.vocab_size, (8, 128), generator=gen,
                           device="cuda")
    state = S.init_server_state(cfg, len(BW.PROMPT_MIX), 2048)
    for slot, n in enumerate(BW.PROMPT_MIX):
        S.admit_bucketed(params, state, BW._prompt(slot, n, cfg,
                                                   torch.device("cuda")),
                         slot)
    pslots = 2 * len(BW.PROMPT_MIX)
    page = paging.PAGE_TOKENS
    pages = sum(paging.pages_for(min(BW.PROMPT_MIX[i % 8] + 128, 2048), page)
                for i in range(pslots)) + 2
    pool = paging.PagePool(pages, page_tokens=page)
    pstate = S.init_paged_state(cfg, pslots, 2048, pages, page)
    for slot in range(pslots):
        n = BW.PROMPT_MIX[slot % 8]
        S.admit_paged(params, pstate, pool,
                      BW._prompt(slot % 8, n, cfg, torch.device("cuda")),
                      slot)
    S.ensure_chunk_pages(pstate, pool, 128)
    init_fn, step, _ = T.make_train_step(cfg, attn_fn=FA.flash_attention)
    tokens = torch.randint(0, cfg.vocab_size, (16, 2048), generator=gen,
                           device="cuda")
    targets = torch.roll(tokens, -1, dims=1)
    tparams, opt = init_fn(CS._dev_gen(2), tokens)
    paths = {
        "generate_8x128_64": lambda: S.generate(params, prompt, cfg, 64, 256),
        "serve_chunk_8x64": lambda: S.serve_chunk(params, dict(state), 64),
        "serve_chunk_paged_16x64": lambda: BW._serve_chunk_paged(
            params, dict(pstate), 64),
        "train_step_16x2048": lambda: step(tparams, opt, tokens, targets),
    }
    result = {}
    for name, fn in paths.items():
        rows = {"eager": [], "compiled": []}
        for mode in MODES:
            with _mode(mode):
                rows[mode].append(_busy(fn))
        result[name] = rows
        print(f"  busy {name}: {rows}", file=sys.stderr, flush=True)
    _fresh()
    return result


def admissions() -> dict:
    """The chunked, interleaved and paged admissions, eager against
    compiled in turns, at flagship width (``chip_smoke.admission_turns``)."""
    cfg = M.ModelConfig()
    gen = CS._dev_gen(3)
    params = M.init_params(gen, cfg)

    def ids(*shape):
        return torch.randint(0, cfg.vocab_size, shape, generator=gen,
                             device="cuda")

    result = CS.admission_turns(cfg, params, ids)
    print(f"  admissions: {result}", file=sys.stderr, flush=True)
    _fresh()
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=5,
                    help="timed calls a serving run")
    ap.add_argument("--out", default="build/graphs_ab.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("graphs_ab: torch sees no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    FA.build_seconds()
    kind = torch.cuda.get_device_name(0)
    result = {"card": CS.nvidia_smi("name,power.limit"), "order": MODES,
              "iters": args.iters,
              "sections": sections(kind, args.iters),
              "busy": busy_shares(),
              "admissions": admissions()}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    print(result["card"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
