"""Time this checkout's fp32 flash forward against other builds of the
same C entry, in turns on one card.

    python tools/fp32_fwd_ab.py [--against DIR ...]
                                [--out build/fp32_fwd_ab.json]

Each ``--against`` DIR is a ``csrc`` directory holding a ``flash_fwd.cu``
and the headers it includes, e.g. ``tpushare_torch/csrc`` of an earlier
commit unpacked with ``git archive`` into an ignored directory. Each
build's ``tpushare_flash_fwd`` is built with the ``nvcc`` command
``flash_attention.build`` uses for this checkout's, and loaded with
``ctypes`` (``tools/fp32_bwd_ab.py``'s ``build``) with this checkout's
argument types: an earlier build must take the offsets pair's pointer
before the stream, as this one does (``flash_attention.entry_argtypes``).

For each fp32 shape (phase 3's long prompt (b), the large width (c), the
train shape (f), the head-dim-16 blocks and 8192 tokens at D = 64 and
128), every build's forward is held to ``flash_block_with_lse_plain``
(normalized out error, absolute lse error) and timed as device ms (CUDA
graphs, ``chip_smoke.device_ms``) in turns: the other builds, this one,
this one, the other builds in reverse. Then the fp32 flagship train step
(``ModelConfig(dtype=float32)``, 8 x 2048, remat) is profiled once with
each build's forward swapped into the wrapper, in the same turns: its
device ms and the forward's share. Prints one JSON object and the card's
name and power limit as ``nvidia-smi`` gives them; writes the JSON to
``--out``. Needs one Hopper card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as CS  # noqa: E402
from tools.fp32_bwd_ab import build, swapped, turns  # noqa: E402
from tpushare_torch.workload import flash_attention as FA  # noqa: E402
from tpushare_torch.workload import model as M  # noqa: E402
from tpushare_torch.workload import train as T  # noqa: E402

SHAPES = {name: CS.SHAPES[name] for name in ("b_long_prompt", "c_large_width",
                                             "f_flagship_train")}
SHAPES.update(CS.D16_SHAPES)
SHAPES.update(CS.F32_SHAPES)
LIB = "flash_fwd"


def time_shapes(builds: dict) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {}
    for name, (b, lq, lk, h, d, qo, ko) in SHAPES.items():
        q, k, v = (torch.randn((b, n, h, d), generator=gen, device="cuda")
                   for n in (lq, lk, lk))
        seen = qo + torch.arange(lq, device="cuda") >= ko
        with torch.inference_mode():
            ref_out, ref_lse = FA.flash_block_with_lse_plain(q, k, v, qo, ko)
            rows = {"shape": [b, lq, lk, h, d, qo, ko]}
            for build_name in turns(list(builds)):
                swapped(builds[build_name], LIB)

                def fwd():
                    return FA.flash_fwd_kernel(q, k, v, qo, ko)

                row = rows.setdefault(build_name, {"ms": []})
                if "out_err" not in row:
                    out, lse = fwd()
                    row["out_err"] = (
                        (out - ref_out)[:, seen].abs().max()
                        / ref_out[:, seen].abs().max()).item()
                    row["lse_err"] = (lse - ref_lse)[:, seen].abs().max().item()
                row["ms"].append(CS.device_ms(fwd))
            for row in rows.values():
                if isinstance(row, dict) and row.get("ms"):
                    row["min_ms"] = min(row["ms"])
            swapped(None, LIB)
        result[name] = rows
        del q, k, v, ref_out, ref_lse
    return result


def step_device_ms(builds: dict) -> dict:
    """The fp32 flagship train step's device ms with each build's
    forward."""
    cfg = M.ModelConfig(dtype=torch.float32)
    init_fn, step, place_batch = T.make_train_step(cfg)
    tokens = torch.randint(0, cfg.vocab_size, CS.TRAIN_BATCH,
                           generator=CS._dev_gen(1), device="cuda")
    targets = torch.roll(tokens, -1, dims=1)
    params, opt = init_fn(CS._dev_gen(2), tokens)
    tokens, targets = place_batch(tokens, targets)
    rows = {}
    for build_name in turns(list(builds)):
        swapped(builds[build_name], LIB)
        step(params, opt, tokens, targets)            # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(params, opt, tokens, targets)
            torch.cuda.synchronize()
        on_card = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in on_card)
        fwd = sum(e.time_range.elapsed_us() for e in on_card
                  if "flash_fwd_" in e.name)
        row = rows.setdefault(build_name, {"device_ms": [], "fwd_ms": []})
        row["device_ms"].append(busy / 1e3)
        row["fwd_ms"].append(fwd / 1e3)
    swapped(None, LIB)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", action="append", default=[],
                    help="a csrc directory to build and time against")
    ap.add_argument("--out", default="build/fp32_fwd_ab.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fp32_fwd_ab: torch sees no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    FA.build_seconds()
    with tempfile.TemporaryDirectory(prefix="fp32_fwd_ab-") as tmp:
        builds = {"this": None}
        for i, csrc in enumerate(dict.fromkeys(args.against)):
            out_dir = os.path.join(tmp, f"build{i}")
            os.makedirs(out_dir)
            builds[csrc] = build(csrc, out_dir, LIB)
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
