"""The port's twins of the reference's host benches, each against the
reference's own run, in ``--smoke`` form, each in a process of its own
(as a user runs them).

* ``bench_router_torch.py`` against ``bench_router.py``: the same seeded
  three-phase replay (the chunked, whole-prefill and paged fleets) over
  the port's ``Router``, ``QuotaManager`` and ``stats``; the JSON lines
  are equal byte for byte, and the gates pass.
* ``bench_autoscale_torch.py`` against ``bench.py --autoscale``: the
  diurnal wave over the port's stack, on the reference's v5p node
  documents, the static baseline and the slice completion. The documents
  are equal but for one count: how many of the wave's drain ticks ended
  before their node's evictions reached the ledger. When the informer
  syncs an eviction before the tick re-reads the ledger, that tick
  deletes the node itself; otherwise the next tick does (the reference's
  ``tests/test_autoscale.py`` holds both as correct drains). So the
  ``scale-down/drain`` tally is a race, held here within its
  bounds on both sides (the twin's races alike under load); every other
  number, the node-hours and the gates among them, is equal. The
  reference also races its informer before two of its ticks (the demand
  tracker prunes a pod the informer has not listed yet), and then fails
  its own assert: its run is taken again, up to three times. The twin
  waits for its informer there.
* ``bench_fleetday_torch.py`` against ``bench.py --fleet-day``, both
  ``--smoke --gate``: the same ``day`` (the committed day at 12 hours
  through the port's stack), every gate passing on both; the witness's
  overhead probe is a wall-clock reading, compared by its ``pass`` only,
  and under load it can fail on either side (``--gate`` then exits 1), so
  each side's run is taken again up to three times, as the reference's
  autoscale run is above.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _line(*argv: str, tries: int = 1) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    for _ in range(tries):
        out = subprocess.run([sys.executable, *argv], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=300)
        if out.returncode == 0:
            break
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1, out.stdout[-2000:]
    return json.loads(lines[0])


def test_bench_router_twin_prints_the_reference_s_line():
    want = _line("bench_router.py", "--smoke", "--gate")
    got = _line("bench_router_torch.py", "--smoke", "--gate")
    assert got == want
    assert all(got["gates"].values())
    assert got["chunked"]["tenants"]["burst"]["shed"] > 0


def _drains(doc: dict) -> int:
    return doc["autoscaled"]["actions"].pop("scale-down/drain", 0)


def test_bench_autoscale_twin_prints_the_reference_s_document():
    want = _line("bench.py", "--autoscale", "--smoke", tries=3)
    got = _line("bench_autoscale_torch.py", "--smoke")
    deletes = want["autoscaled"]["actions"]["scale-down/delete"]
    drains = [_drains(doc) for doc in (want, got)]
    # A drain of residents ends in its own tick or in the next.
    for n in drains:
        assert 0 <= n <= 2 * deletes, drains
    assert got == want
    assert all(g["pass"] for g in got["gates"].values()), got["gates"]
    assert got["contiguity"]["election"]["kind"] == "slice-completion"


def test_bench_fleetday_twin_replays_the_reference_s_day():
    want = _line("bench.py", "--fleet-day", "--smoke", "--gate", tries=3)
    got = _line("bench_fleetday_torch.py", "--smoke", "--gate", tries=3)
    for doc in (want, got):
        assert doc.pop("witness_overhead")["pass"]
        assert doc["gates"].pop("witness_overhead")["pass"]
        assert all(g["pass"] for g in doc["gates"].values()), doc["gates"]
    assert got == want
    assert got["day"]["witness"]["counts"]["matched"] == 6
