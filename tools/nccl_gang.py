"""Sharded training over NCCL, one rank a card: phase 5d of
``chip_smoke.py`` on a host with several cards, and (``--compiled``) the
compiled sharded steps of its phase 9b.

    python tools/nccl_gang.py [--mesh 1,2,2] [--attention ring ulysses]
    python tools/nccl_gang.py --compiled

Builds the kernels, then, by default, runs ``chip_smoke.sharded_phase``
with one gang of dp·tp·sp ranks over NCCL, rank i on card i: the flagship
at phase 5b's 8 x 2048 global batch, each strategy's first step held to
the single-process kernel step (on card 0) at phase 5d's bounds, every
rank's kernel launches a step to the design.

With ``--compiled`` it runs ``chip_smoke.four_card_gangs`` instead: a
gang of four ranks for each kind of case, one rank a card over NCCL,
through the flagship's
compiled sharded steps (the (1,2,2) ring and Ulysses and the (2,2,1)
train steps, ``generate(mesh=)`` on (2,2,1) greedy and sampled, the
(2,1,1,2) 1F1B pipe and its GPipe forward, the (1,1,2,2) 1F1B pipe with
the ring over sp, the ring-MoE over the (1,2,2) mesh's sp), each compiled
against eager from the same init bit for bit, a replay of every graph
traced, eager against compiled host ms in turns, first steps held to the
single-process kernel step. Then it probes the capture modes: a gang of
four captures a shift and an all-reduce over NCCL in each of
``torch.cuda.graph``'s ``capture_error_mode``s "global" and
"thread_local" (a gang a mode, a failure recorded, not raised), and
replays it against the eager result.

Prints the phase's JSON line (and writes it to ``--out``, when given)
and, as the last line, every card's name and power limit as
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
from tpushare_torch.runtime import launch, torchenv  # noqa: E402
from tpushare_torch.workload import collectives as C  # noqa: E402
from tpushare_torch.workload import flash_attention as FA  # noqa: E402
from tpushare_torch.workload import model as M  # noqa: E402
from tpushare_torch.workload import parallel as par  # noqa: E402

PROBE_FLAG = "--probe-rank"
PROBE_MODES = ("global", "thread_local")
#: Elements of the probe's fp32 payload (4 MiB), and its replays.
PROBE_NUMEL, PROBE_REPLAYS = 1 << 20, 3
PROBE_DEADLINE_S = 120


def probe_rank(mode: str) -> int:
    """One rank of a capture-mode probe: over the gang's (1, 1, 4) sp
    ring, shift a payload and all-reduce it, eagerly (which makes the
    communicators), then captured in ``mode`` and replayed; prints
    whether the capture held and the replays gave the eager result."""
    torchenv.init_distributed(backend="nccl", device="cuda")
    mesh = par.make_mesh(1, 1, torch.distributed.get_world_size())
    gen = torch.Generator(device="cuda").manual_seed(mesh.rank)
    x = torch.randn(PROBE_NUMEL, generator=gen, device="cuda")

    def body():
        return C.all_reduce(C.shift(x, mesh.sp_group), mesh.sp_group)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        want = body()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    record = {"rank": mesh.rank, "mode": mode}
    try:
        with torch.cuda.graph(graph, stream=side, capture_error_mode=mode):
            got = body()
        for _ in range(PROBE_REPLAYS):
            graph.replay()
        torch.cuda.synchronize()
        record.update(captured=True, replays_equal=bool(torch.equal(got,
                                                                    want)))
    except RuntimeError as exc:
        record.update(captured=False, error=str(exc)[:400])
    print(json.dumps(record), flush=True)
    # A graph that holds NCCL work keeps its communicator: the groups are
    # destroyed only after it is freed.
    del graph
    torch.distributed.destroy_process_group()
    return 0


def probe_capture_modes() -> dict:
    """A gang of four a mode (:func:`probe_rank`); a gang that fails or
    hangs past its deadline is recorded as such."""
    out = {}
    for mode in PROBE_MODES:
        try:
            out[mode] = launch.launch(
                [os.path.abspath(__file__), PROBE_FLAG, mode], 4,
                deadline_s=PROBE_DEADLINE_S)
        except launch.GangError as exc:
            out[mode] = {"gang_failed": str(exc)[-800:]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="1,2,2", help="dp,tp,sp")
    ap.add_argument("--attention", nargs="+", default=["ring", "ulysses"],
                    choices=["ring", "ulysses"])
    ap.add_argument("--compiled", action="store_true",
                    help="the compiled sharded steps on four cards")
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args()
    world = 4 if args.compiled else math.prod(
        int(x) for x in args.mesh.split(","))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < world:
        print(f"nccl_gang: {world} ranks need {world} cards, this host "
              f"has {cards}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build = FA.build_seconds()
    inv = discovery.discover_host()
    if args.compiled:
        fields = {"compiled": chip_smoke.four_card_gangs(
            M.ModelConfig(), cards, strict=False),
                  "capture_modes": probe_capture_modes()}
    else:
        fields = chip_smoke.sharded_phase(
            M.ModelConfig(), inv.chips[0].hbm_gib,
            gangs=((world, args.mesh, tuple(args.attention)),),
            backend="nccl")
    line = json.dumps({"build_seconds": build, "cards": cards, **fields},
                      sort_keys=True)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(line + "\n")
    print(line, flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().replace("\n", "; "))
    return 1 if args.compiled and fields["compiled"]["failed"] else 0


if __name__ == "__main__":
    if sys.argv[1:2] == [PROBE_FLAG]:
        raise SystemExit(probe_rank(sys.argv[2]))
    raise SystemExit(main())
