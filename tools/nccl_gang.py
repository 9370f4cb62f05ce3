"""Sharded training over NCCL, one rank a card: phase 5d of
``chip_smoke.py`` on a host with several cards.

    python tools/nccl_gang.py [--mesh 1,2,2] [--attention ring ulysses]

Builds the kernels, then runs ``chip_smoke.sharded_phase`` with one gang
of dp·tp·sp ranks over NCCL, rank i on card i: the flagship at phase
5b's 8 x 2048 global batch, each strategy's first step held to the
single-process kernel step (on card 0) at phase 5d's bounds, every
rank's kernel launches a step to the design. Prints the phase's JSON
line and, as the last line, every card's name and power limit as
``nvidia-smi`` gives them. Fails (nonzero) on any check, and without as
many cards as ranks.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from tpushare_torch.deviceplugin import discovery  # noqa: E402
from tpushare_torch.workload import flash_attention as FA  # noqa: E402
from tpushare_torch.workload import model as M  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="1,2,2", help="dp,tp,sp")
    ap.add_argument("--attention", nargs="+", default=["ring", "ulysses"],
                    choices=["ring", "ulysses"])
    args = ap.parse_args()
    world = math.prod(int(x) for x in args.mesh.split(","))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < world:
        print(f"nccl_gang: mesh {args.mesh} needs {world} cards, this host "
              f"has {cards}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build = FA.build_seconds()
    inv = discovery.discover_host()
    fields = chip_smoke.sharded_phase(
        M.ModelConfig(), inv.chips[0].hbm_gib,
        gangs=((world, args.mesh, tuple(args.attention)),), backend="nccl")
    print(json.dumps({"build_seconds": build, "cards": cards, **fields},
                     sort_keys=True), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().replace("\n", "; "))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
