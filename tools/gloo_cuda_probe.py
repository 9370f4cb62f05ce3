"""Which gloo collectives take CUDA tensors on this host.

    python tools/gloo_cuda_probe.py

Runs each operation in a gang of its own (``runtime.launch``): two ranks
on card 0 over gloo, the operation called on CUDA tensors directly,
without the host buffers that ``workload/collectives.py`` stages every
gloo collective through. Prints one JSON line: per operation, each
rank's outcome (``ok`` with the result checked, or the error), or the
gang's failure when a rank died or the gang hung past its deadline.
Needs a CUDA device. The operations are those the sharded train step
uses: the ring's paired send and receive, the bf16 all-reduce and the
all-to-all.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from tpushare_torch.runtime import launch, torchenv  # noqa: E402

OPS = ("send_recv", "all_reduce_bf16", "all_to_all")
DEADLINE_S = 60


def _run(op: str, rank: int) -> bool:
    """Call ``op`` on CUDA tensors of rank ``rank`` of two; whether the
    result is right."""
    dev = torch.device("cuda", torch.cuda.current_device())
    if op == "send_recv":
        send = torch.full((1024,), float(rank), device=dev)
        recv = torch.empty_like(send)
        peer = 1 - rank
        for work in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send, peer),
                dist.P2POp(dist.irecv, recv, peer)]):
            work.wait()
        return bool((recv == peer).all())
    if op == "all_reduce_bf16":
        x = torch.full((1024,), rank + 1.0, dtype=torch.bfloat16, device=dev)
        dist.all_reduce(x)
        return bool((x == 3).all())
    x = torch.arange(2, dtype=torch.float32, device=dev) + 10 * rank
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x)
    return out.tolist() == [rank, 10.0 + rank]


def rank_main(op: str) -> int:
    spec = torchenv.init_distributed(backend="gloo", device="cuda")
    try:
        record = {"rank": spec.process_id, "ok": _run(op, spec.process_id)}
    except Exception as exc:  # the outcome being probed, reported
        record = {"rank": spec.process_id,
                  "error": f"{type(exc).__name__}: {exc}"[:400]}
    print(json.dumps(record), flush=True)
    os._exit(0)     # a failed transport can leave the group unable to close


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--op", choices=OPS, help="run as one rank of a gang")
    args = ap.parse_args()
    if args.op:
        return rank_main(args.op)
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    outcomes = {}
    for op in OPS:
        try:
            outcomes[op] = launch.launch([os.path.abspath(__file__),
                                          "--op", op], 2,
                                         deadline_s=DEADLINE_S)
        except launch.GangError as exc:
            outcomes[op] = {"gang_failed": str(exc)[:600]}
    print(json.dumps({"torch": torch.__version__,
                      "device": torch.cuda.get_device_name(0),
                      "outcomes": outcomes}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
