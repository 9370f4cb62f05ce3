"""Time this checkout's fp32 flash backward pair (dq, dk/dv) against other
builds of the same C entries, in turns on one card.

    python tools/fp32_bwd_ab.py [--against DIR ...]
                                [--out build/fp32_bwd_ab.json]

Each ``--against`` DIR is a ``csrc`` directory holding a ``flash_bwd.cu``
and the headers it includes, e.g. ``tpushare_torch/csrc`` of an earlier
commit unpacked with ``git archive`` into an ignored directory. Each
build's ``tpushare_flash_bwd_dq`` / ``_dkv`` is built with the ``nvcc``
command ``flash_attention.build`` uses for this checkout's, and loaded
with ``ctypes``.

For each fp32 shape (phase 3's train shape (f), the long prompt (b) and
the large width (c), and the tiny dry run's blocks), every build's dq and
dk/dv are held to ``flash_bwd_plain`` (normalized error) and timed as
device ms (CUDA graphs, ``chip_smoke.device_ms``) in turns: the other
builds, this one, this one, the other builds in reverse. Then the fp32
flagship train step (``ModelConfig(dtype=float32)``, 8 x 2048, remat) is
profiled once with each build's pair swapped into the wrappers, in the
same turns: its device ms and the pair's share. Prints one JSON object
and the card's name and power limit as ``nvidia-smi`` gives them; writes
the JSON to ``--out``. Needs one Hopper card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as CS  # noqa: E402
from tpushare_torch.workload import flash_attention as FA  # noqa: E402
from tpushare_torch.workload import model as M  # noqa: E402
from tpushare_torch.workload import train as T  # noqa: E402

SHAPES = {"f_flagship_train": CS.SHAPES["f_flagship_train"],
          "b_long_prompt": CS.SHAPES["b_long_prompt"],
          "c_large_width": CS.SHAPES["c_large_width"],
          **CS.D16_SHAPES, **CS.F32_SHAPES}


def build(csrc: str, out_dir: str, name: str = "flash_bwd") -> dict:
    """Build ``csrc``/``name``.cu into ``out_dir`` with the command
    ``flash_attention.build`` uses, and bind its entries."""
    lib = os.path.join(out_dir, f"lib{name}.so")
    subprocess.run(FA.nvcc_command(os.path.join(csrc, f"{name}.cu"), lib),
                   check=True, capture_output=True, text=True)
    return FA.bind_library(lib, name)


def swapped(fns: dict | None, name: str = "flash_bwd"):
    """Point the wrappers of library ``name`` at ``fns`` (None: this
    checkout's library)."""
    for sym in FA._ENTRIES[name]:
        FA._fns.pop(sym, None)
        if fns is not None:
            FA._fns[sym] = fns[sym]


def turns(names: list[str]) -> list[str]:
    """The others, this checkout, this checkout, the others reversed."""
    others = [n for n in names if n != "this"]
    return others + ["this", "this"] + others[::-1]


def time_shapes(builds: dict) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {}
    for name, (b, lq, lk, h, d, qo, ko) in SHAPES.items():
        q, k, v, do = (torch.randn((b, n, h, d), generator=gen, device="cuda")
                       for n in (lq, lk, lk, lq))
        with torch.inference_mode():
            swapped(None)
            out, lse = FA.flash_fwd_kernel(q, k, v, qo, ko)
            delta = FA.flash_bwd_delta(do, out, None)
            ref = FA.flash_bwd_plain(q, k, v, out, lse, do, None, qo, ko)
            rows = {"shape": [b, lq, lk, h, d, qo, ko]}
            for build_name in turns(list(builds)):
                swapped(builds[build_name])
                fns = {"dq": lambda: FA.flash_bwd_dq_kernel(
                           q, k, v, do, lse, delta, qo, ko),
                       "dkv": lambda: FA.flash_bwd_dkv_kernel(
                           q, k, v, do, lse, delta, qo, ko)}
                row = rows.setdefault(build_name, {"dq_ms": [], "dkv_ms": []})
                if "refused" in row:
                    continue
                if "err" not in row:
                    try:    # an earlier build may not take this head dim
                        got = (fns["dq"](), *fns["dkv"]())
                    except RuntimeError as exc:
                        row["refused"] = str(exc)
                        continue
                    row["err"] = {g: CS._norm_err(x, r) for g, x, r in
                                  zip(("dq", "dk", "dv"), got, ref)}
                for kname, fn in fns.items():
                    row[f"{kname}_ms"].append(CS.device_ms(fn))
            for row in rows.values():
                if isinstance(row, dict) and row.get("dq_ms"):
                    row["pair_ms"] = min(row["dq_ms"]) + min(row["dkv_ms"])
            swapped(None)
        result[name] = rows
        del q, k, v, do, out, lse, delta, ref
    return result


def step_device_ms(builds: dict) -> dict:
    """The fp32 flagship train step's device ms with each build's pair."""
    cfg = M.ModelConfig(dtype=torch.float32)
    init_fn, step, place_batch = T.make_train_step(cfg)
    tokens = torch.randint(0, cfg.vocab_size, CS.TRAIN_BATCH,
                           generator=CS._dev_gen(1), device="cuda")
    targets = torch.roll(tokens, -1, dims=1)
    params, opt = init_fn(CS._dev_gen(2), tokens)
    tokens, targets = place_batch(tokens, targets)
    rows = {}
    for build_name in turns(list(builds)):
        swapped(builds[build_name])
        step(params, opt, tokens, targets)            # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(params, opt, tokens, targets)
            torch.cuda.synchronize()
        on_card = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in on_card)
        pair = sum(e.time_range.elapsed_us() for e in on_card
                   if "flash_bwd_" in e.name)
        row = rows.setdefault(build_name, {"device_ms": [], "pair_ms": []})
        row["device_ms"].append(busy / 1e3)
        row["pair_ms"].append(pair / 1e3)
    swapped(None)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", action="append", default=[],
                    help="a csrc directory to build and time against")
    ap.add_argument("--out", default="build/fp32_bwd_ab.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fp32_bwd_ab: torch sees no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    FA.build_seconds()
    with tempfile.TemporaryDirectory(prefix="fp32_bwd_ab-") as tmp:
        dirs = {os.path.abspath(d): d for d in args.against}
        builds = {"this": None}
        for i, (csrc, label) in enumerate(dirs.items()):
            out_dir = os.path.join(tmp, f"build{i}")
            os.makedirs(out_dir)
            builds[label] = build(csrc, out_dir)
        result = {"card": CS.nvidia_smi("name,power.limit"),
                  "order": turns(list(builds)),
                  "shapes": time_shapes(builds),
                  "fp32_train_step": step_device_ms(builds)}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    print(result["card"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
