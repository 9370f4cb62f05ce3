"""Peak device memory of ``cogpucheck.py``'s estimator tenant, with
decode attention's row slices at a chosen bound.

    python tools/estimator_peak.py [--overshoot 1.0] [--slice-bytes N]

Runs the tenant in this process under a whole-card grant on card 0 (the
card's GiB from the port's NVIDIA discovery) and prints its JSON line:
outcome, batch, cache bytes and ``peak_bytes``. ``--slice-bytes`` sets
``serving.DECODE_ATTN_SLICE_BYTES``; a bound past the batch's whole fp32
K (``--slice-bytes 0`` means no bound) attends every row at once, as the
serving path did before the bound existed. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import cogpucheck  # noqa: E402
from tpushare_torch.utils import const  # noqa: E402
from tpushare_torch.workload import serving as S  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--overshoot", type=float, default=1.0)
    ap.add_argument("--slice-bytes", type=int,
                    default=S.DECODE_ATTN_SLICE_BYTES)
    args = ap.parse_args()
    _, card = cogpucheck.card_gib()
    os.environ.update({const.ENV_CHIP_IDX: "0", const.ENV_HBM_POD: str(card),
                       const.ENV_HBM_CHIP: str(card)})
    S.DECODE_ATTN_SLICE_BYTES = args.slice_bytes or 1 << 62
    result = cogpucheck.tenant_estimator(args.overshoot)
    print(json.dumps({**result, "slice_bytes": args.slice_bytes}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
