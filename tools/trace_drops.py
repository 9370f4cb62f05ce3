"""How often the profiler's trace loses the card's records, with and
without an idle margin around the traced call.

    python tools/trace_drops.py [--trials 150] [--rounds 2]

Traces one call of the flagship forward (``make_forward_fn``, 2 x 256
tokens) ``--trials`` times in each of four ways, ``--rounds`` times over:
eager (``graphs.disabled()``) and replayed, each with no margin and with
``chip_smoke.TRACE_PAD_S`` of host sleep inside the profiler's window on
each side. Prints, for each way, how many traces held each number of
device records, and for the first traces that held fewer than the most,
which positions (in start order of the fullest trace) were lost. Needs
one card.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as CS  # noqa: E402
from tpushare_torch.workload import flash_attention as FA  # noqa: E402
from tpushare_torch.workload import graphs  # noqa: E402
from tpushare_torch.workload import model as M  # noqa: E402
from tpushare_torch.workload import train as T  # noqa: E402


def trace(fn, pad: float) -> list:
    """The card's records of one ``fn()`` under the profiler, in start
    order, with ``pad`` seconds of host sleep on each side."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if pad:
            time.sleep(pad)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        if pad:
            time.sleep(pad)
    return sorted((e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: e.time_range.start)


def tally(label: str, fn, pad: float, trials: int) -> dict:
    full, counts, shown = None, collections.Counter(), 0
    for _ in range(trials):
        ev = trace(fn, pad)
        counts[len(ev)] += 1
        if full is None or len(ev) > len(full):
            full = ev
        elif len(ev) < len(full) and shown < 3:
            shown += 1
            got = collections.Counter(e.name[:40] for e in ev)
            seen, lost = collections.Counter(), []
            for i, e in enumerate(full):
                seen[e.name[:40]] += 1
                if seen[e.name[:40]] > got[e.name[:40]]:
                    lost.append(i)
            print(f"  {label}: lost {len(full) - len(ev)}; positions "
                  f"{lost[:10]}..{lost[-5:]}", flush=True)
    print(label, "pad", pad, dict(counts), flush=True)
    return dict(counts)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=150)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(FA.build_seconds(), flush=True)
    cfg = M.ModelConfig()
    gen = CS._dev_gen(9)
    params = M.init_params(gen, cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen,
                         device="cuda")
    fwd = T.make_forward_fn(cfg)
    fwd(params, toks)
    for _ in range(args.rounds):
        for label, mode in (("eager", graphs.disabled),
                            ("graph", contextlib.nullcontext)):
            for pad in (0.0, CS.TRACE_PAD_S):
                with mode():
                    tally(label, lambda: fwd(params, toks), pad,
                          args.trials)
    print(CS.nvidia_smi("name,power.limit"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
