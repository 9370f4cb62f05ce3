"""Phases 2f and 2h of ``chip_smoke.py`` alone, on one NVIDIA card.

Builds the kernels from the checkout, then runs ``chip_smoke.
extender_phase`` (the tenant placed through the extender and served, the
1,024-node churn with the interpreter's GC thresholds and again under
the reference extender's GC posture) and ``chip_smoke.tenancy_phase``
(two replicas under leader election, failover, a serving tenant
preempted and replaced, quota, admission, the preempt benchmarks).
Prints each phase as ``chip_smoke.py`` does and writes every field as
JSON to ``--out``::

    python3 tools/extender_phases.py --out extender_phases.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as CS  # noqa: E402
from tpushare_torch.deviceplugin import discovery  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="", help="the JSON record's path")
    args = ap.parse_args()
    t0 = time.perf_counter()
    card = CS.nvidia_smi("name,power.limit")
    CS.phase("2 build", **{f"{name}_seconds": sec
                           for name, sec in CS.FA.build_seconds().items()})
    inv = discovery.discover_host()
    out = {"card": card}
    with tempfile.TemporaryDirectory(prefix="extender_phases-") as tmp:
        for name, fn in (("2f extender", CS.extender_phase),
                         ("2h tenancy", CS.tenancy_phase)):
            t = time.perf_counter()
            out[name] = fn(inv, tmp)
            out[name]["phase_s"] = time.perf_counter() - t
            CS.phase(name, card=card, **out[name])
    out["seconds"] = time.perf_counter() - t0
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({"card": card, "seconds": out["seconds"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
