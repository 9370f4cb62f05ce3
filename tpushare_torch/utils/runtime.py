"""The extender process's GC posture for a fleet-scale ledger.

The port's copy of ``tpushare/utils/runtime.py``. At 1,024 nodes the
ledger holds about a million long-lived objects, and CPython's default
thresholds (700, 10, 10) run full gen-2 collections often enough that
their stop-the-world pauses of 10-20 ms make the webhook's p99. Two
stdlib levers:

* stretch the gen-1 and gen-2 multipliers, so full collections run about
  35 times less often (the verbs allocate a lot but acyclically, and
  reference counting frees that). Gen-0 stays near the default: a gen-0
  pass costs in proportion to the young objects, so a large threshold
  trades frequent 0.1 ms pauses for rare multi-ms ones;
* ``gc.freeze()`` the warm heap (ledgers, informer stores, modules) into
  the permanent generation, so the collections that do run skip it.

``cmd/main.py``'s ``main`` calls :func:`tune_gc_from_env`
(``TPUSHARE_GC_TUNE``); ``chip_smoke.py``'s churn applies both levers as
``bench.py --scale`` does. ``serve_stack`` does not: tests keep the
interpreter's defaults.
"""

from __future__ import annotations

import gc
import os

#: Near the interpreter's default: gen-0 passes stay cheap. The levers
#: that matter are the multipliers (a full collection every ~2.5M
#: allocations instead of ~70k) and the freeze.
DEFAULT_GEN0 = 1_000
DEFAULT_GEN1 = 50
DEFAULT_GEN2 = 50


def tune_gc(gen0: int = DEFAULT_GEN0, gen1: int = DEFAULT_GEN1,
            gen2: int = DEFAULT_GEN2, freeze: bool = False) -> None:
    """Set the fleet-scale thresholds. ``freeze=True`` also collects once
    and moves every object alive now into the permanent generation: call
    it after the warm start (cache built, informer synced)."""
    gc.set_threshold(max(gen0, 1), max(gen1, 1), max(gen2, 1))
    if freeze:
        gc.collect()
        gc.freeze()


def tune_gc_from_env() -> bool:
    """``TPUSHARE_GC_TUNE`` (on by default; ``off``, ``0``, ``false`` or
    ``no`` keeps the interpreter's defaults) and ``TPUSHARE_GC_GEN0`` (the
    gen-0 threshold). Returns whether the posture was applied."""
    mode = os.environ.get("TPUSHARE_GC_TUNE", "on").lower()
    if mode in ("off", "0", "false", "no"):
        return False
    gen0_raw = os.environ.get("TPUSHARE_GC_GEN0", "")
    gen0 = int(gen0_raw) if gen0_raw.isdigit() else DEFAULT_GEN0
    tune_gc(gen0=gen0)
    return True
