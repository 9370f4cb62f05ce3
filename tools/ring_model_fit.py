"""Fit the ring-latency model's NVLink constants to NCCL rotations on
this host's cards.

    python tools/ring_model_fit.py [--payloads-mib 1 16 64 128 256]

One rank a card (every card torch sees; at least two), over NCCL with a
``tcp://localhost`` rendezvous. A rotation is ring attention's shift:
each rank sends its block to rank + 1 and receives rank - 1's, one
``batch_isend_irecv`` a rotation. Each rank times :data:`ITERS`
rotations with CUDA events after a warm-up, :data:`REPS` times; a
window's rotation time is the slowest rank's, as
``parallel.ring_rotation_time_us`` says, and a payload's is its least
window's (the one the host's other work disturbed least). The host's own
ms a rotation (enqueue, from ``time.perf_counter`` over the same window)
is reported beside it: where it matches the device's, the host sets the
pace.

Rotations lie on one line only over a window of payloads: below it they
sit on a floor (about the host's time to post them), above it NCCL
moves the payload faster (on four H100s a 256 MiB rotation took 0.90
ms, a 128 MiB one 0.83). The model's constants are the least squares of
``t = latency + payload / bandwidth`` over the payloads inside
:data:`FIT_MIB` (64 MiB is the model's ``kv_block_bytes``); the fit over
every payload is reported beside it, and each payload's time as the
window's fit and the model as it stands (``parallel.NVLINK_LATENCY_US``,
``NVLINK_BYTES_PER_S``) price it, so the error outside the window
shows. Both constant sets then price the
four-card (1,2,2) gang of ``tools/nccl_gang.py`` (the flagship at 8 x
2048: a two-rank sp ring whose block is a rank's K and V, bf16).

Prints one JSON line, then every card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them. Exits 2 with fewer than two cards, 1 if a rank fails or the run
outlasts :data:`DEADLINE_S`.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from tpushare_torch.workload import model as M  # noqa: E402
from tpushare_torch.workload import parallel as par  # noqa: E402

MIB = 1 << 20
WARMUP = 5
#: Rotations a timed window, windows a payload.
ITERS, REPS = 40, 5
#: The payloads the constants are fitted on, MiB: from the floor's end
#: to where NCCL speeds up.
FIT_MIB = (16, 128)
#: Seconds the ranks may take in all.
DEADLINE_S = 300.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(rank: int, world: int, port: int, payloads: list[int],
          results) -> None:
    """One rank: the rotation's device and host ms at each payload, the
    slowest rank's in the least window (rank 0 puts them on
    ``results``)."""
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        ms = []
        for nbytes in payloads:
            send = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
            recv = torch.empty_like(send)

            def rotate():
                ops = [dist.P2POp(dist.isend, send, (rank + 1) % world),
                       dist.P2POp(dist.irecv, recv, (rank - 1) % world)]
                for req in dist.batch_isend_irecv(ops):
                    req.wait()

            for _ in range(WARMUP):
                rotate()
            windows = []
            for _ in range(REPS):
                torch.cuda.synchronize()
                dist.barrier(device_ids=[rank])
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                for _ in range(ITERS):
                    rotate()
                end.record()
                host_ms = (time.perf_counter() - t0) * 1e3 / ITERS
                torch.cuda.synchronize()
                t = torch.tensor([start.elapsed_time(end) / ITERS, host_ms],
                                 device="cuda")
                dist.all_reduce(t, op=dist.ReduceOp.MAX)
                windows.append(t.tolist())
            ms.append(min(windows))
            del send, recv
        if rank == 0:
            results.put(ms)
    finally:
        dist.destroy_process_group()


def fit(payloads: list[int], ms: list[float]) -> tuple[float, float]:
    """Least squares of ``ms * 1e3 = latency_us + payload / bytes_per_s *
    1e6``: (latency µs, bytes/s)."""
    n = len(payloads)
    us = [t * 1e3 for t in ms]
    mx, my = sum(payloads) / n, sum(us) / n
    sxx = sum((x - mx) ** 2 for x in payloads)
    slope = sum((x - mx) * (y - my) for x, y in zip(payloads, us)) / sxx
    return my - slope * mx, 1e6 / slope


def gang_ring_bytes(cfg: M.ModelConfig, batch: int, seq: int, tp: int,
                    sp: int) -> int:
    """A rank's K and V block in the sp ring (bf16)."""
    return 2 * batch * (seq // sp) * (cfg.n_heads // tp) * cfg.head_dim * 2


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--payloads-mib", type=float, nargs="+",
                    default=[1, 16, 64, 128, 256])
    args = ap.parse_args()
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < 2:
        print(f"ring_model_fit: a ring needs at least two cards, this host "
              f"has {cards}", file=sys.stderr)
        return 2
    payloads = [int(p * MIB) for p in args.payloads_mib]
    lo, hi = FIT_MIB
    window = [i for i, p in enumerate(payloads) if lo * MIB <= p <= hi * MIB]
    if len(window) < 2:
        print(f"ring_model_fit: the fit needs two payloads from {lo} to "
              f"{hi} MiB", file=sys.stderr)
        return 2
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    t0 = time.perf_counter()
    procs = mp.start_processes(
        _rank, args=(cards, _free_port(), payloads, results),
        nprocs=cards, join=False, start_method="spawn")
    try:
        while not procs.join(timeout=5):
            if time.perf_counter() - t0 > DEADLINE_S:
                raise TimeoutError(f"ranks still running after "
                                   f"{DEADLINE_S} s")
    except Exception as exc:  # noqa: BLE001 - report and stop every rank
        print(f"ring_model_fit: {exc}", file=sys.stderr)
        for p in procs.processes:
            if p.is_alive():
                p.kill()
        return 1
    windows = results.get()
    ms = [device for device, _ in windows]
    latency_us, bytes_per_s = fit([payloads[i] for i in window],
                                  [ms[i] for i in window])
    cfg = M.ModelConfig()
    block = gang_ring_bytes(cfg, 8, 2048, tp=2, sp=2)
    datasheet = {"latency_us": par.NVLINK_LATENCY_US,
                 "bytes_per_s": par.NVLINK_BYTES_PER_S}

    def gang_ring_ms(latency: float, rate: float) -> float:
        saved = par.NVLINK_LATENCY_US, par.NVLINK_BYTES_PER_S
        par.NVLINK_LATENCY_US, par.NVLINK_BYTES_PER_S = latency, rate
        try:
            return par.predicted_step_time_ms(
                [[1, 1]], [], layers=cfg.n_layers, kv_block_bytes=block,
                compute_ms=0.0)
        finally:
            par.NVLINK_LATENCY_US, par.NVLINK_BYTES_PER_S = saved

    every_us, every_rate = fit(payloads, ms)
    print(json.dumps({
        "cards": cards,
        "rotation_ms": {f"{p / MIB:g}MiB": t for p, t in zip(payloads, ms)},
        "host_ms": {f"{p / MIB:g}MiB": host
                    for p, (_, host) in zip(payloads, windows)},
        "model_us": {f"{p / MIB:g}MiB": par.ring_rotation_time_us(
            [1] * cards, p) for p in payloads},
        "fit_us": {f"{p / MIB:g}MiB": latency_us + p / bytes_per_s * 1e6
                   for p in payloads},
        "fit": {"latency_us": latency_us, "bytes_per_s": bytes_per_s,
                "payloads_mib": list(FIT_MIB)},
        "fit_every_payload": {"latency_us": every_us,
                              "bytes_per_s": every_rate},
        "model": datasheet,
        "gang_1_2_2": {"kv_block_bytes": block, "layers": cfg.n_layers,
                       "ring_ms_fit": gang_ring_ms(latency_us, bytes_per_s),
                       "ring_ms_model": gang_ring_ms(
                           datasheet["latency_us"],
                           datasheet["bytes_per_s"])},
        "seconds": time.perf_counter() - t0,
    }, sort_keys=True), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().replace("\n", "; "))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
