"""Phases 2f, 2g, 2h, 2i and 2j of ``chip_smoke.py`` alone, on one
NVIDIA card.

Builds the kernels from the checkout, then runs ``chip_smoke.
extender_phase`` (the tenant placed through the extender and served, its
decision trace and metrics, the 1,024-node churn with ``/metrics``
scraped every second, with the interpreter's GC thresholds and again
under the reference extender's GC posture), ``chip_smoke.gang_phase``
without the gang's training (the binds, grants, reaper, TTL rollback and
the 256-gang churn, with the gauges and each member's trace id) and
``chip_smoke.tenancy_phase`` (two replicas under leader election,
failover, a serving tenant preempted and replaced, quota, admission, the
preempt benchmarks) and ``chip_smoke.defrag_phase`` (a pending pod
placed on the card's node by the defrag executor's move once a burning
SLO lifts, and served there) and ``chip_smoke.autoscale_phase`` (a
router's scale-out places a decode pod on the card's node, served there,
then the autoscaler holds defrag-first, scales up a node and drains and
deletes it in the trough, with the host twins of ``bench_router.py`` and
``bench.py --autoscale`` beside it), each with the fleet timeline's
checks (2f also restarts the extender over its fleet and replays the
tenant's decision from the black-box journal, and flips a node NotReady;
its churns run with the continuous profiler armed). ``--overhead`` then runs
``chip_smoke.overhead_phase``: the timeline's, the journal's and the
profiler's overhead gates, ``bench.py``'s twins, on 2f's 1,024-node fleet;
``--no-phases`` runs it alone, and ``--only 2j`` (a comma-separated list
of phase numbers) runs those phases alone. Prints each phase as
``chip_smoke.py`` does and writes every field as JSON to ``--out``::

    python3 tools/extender_phases.py --out extender_phases.json
    python3 tools/extender_phases.py --overhead --no-phases --out o.json
    python3 tools/extender_phases.py --only 2i --out defrag.json
    python3 tools/extender_phases.py --only 2j --out autoscale.json
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
    ap.add_argument("--overhead", action="store_true",
                    help="run the timeline, journal and profiler "
                         "overhead gates")
    ap.add_argument("--no-phases", action="store_true",
                    help="skip phases 2f, 2g, 2h, 2i and 2j")
    ap.add_argument("--only", default="",
                    help="run only these phases (e.g. 2i or 2f,2i)")
    args = ap.parse_args()
    t0 = time.perf_counter()
    card = CS.nvidia_smi("name,power.limit")
    CS.phase("2 build", **{f"{name}_seconds": sec
                           for name, sec in CS.FA.build_seconds().items()})
    inv = discovery.discover_host()
    out = {"card": card}
    with tempfile.TemporaryDirectory(prefix="extender_phases-") as tmp:
        phases = [] if args.no_phases else [
            ("2f extender", CS.extender_phase),
            ("2g gang", lambda i, u: CS.gang_phase(i, u, None)),
            ("2h tenancy", CS.tenancy_phase),
            ("2i defrag and SLO", CS.defrag_phase),
            ("2j autoscale and router", CS.autoscale_phase)]
        if args.only:
            keep = args.only.split(",")
            phases = [(n, fn) for n, fn in phases if n.split()[0] in keep]
        if args.overhead:
            phases.append(("2f overhead", lambda i, u: CS.overhead_phase()))
        for name, fn in phases:
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
