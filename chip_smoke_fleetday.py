"""Phase 2k of ``chip_smoke.py``: the fleet day on the card.

``chip_smoke.py`` imports this module and calls :func:`fleetday_phase`
with the ``chip_smoke`` module itself as ``cs`` (its checks and the
kernels' launch counters). The phase runs in this process and starts no
child:

1. The card's service rates, measured with CUDA events after a warm-up
   through the port's serving entry points (``init_server_state``,
   ``admit_bucketed``, ``serve_chunk``, compiled as phase 8 runs them) on
   the flagship ``ModelConfig()`` in bf16, prefill through the flash
   kernel (``attn_fn=flash_attention``, as the served paths admit), at the
   fleet day's replica shape: 4 slots of 2,048 tokens, prompts of 128, 64
   new tokens.
   ``decode_tok_s`` is 4 x 64 over a 64-step ``serve_chunk`` with every
   slot busy (``DecodeReplica``'s aggregate decode rate);
   ``prefill_tok_s`` is 128 over one 128-token admission. Each timed
   admission launches the bf16 forward kernel ``n_layers`` times, counted
   from zero (``fleetday_rates`` in the kernels line).
2. The reference's day, ``EXAMPLE_FLEET_DAY`` at 24 hours and seed 1234,
   through ``tools/simulate_torch.py``: the witness at 6 of 6 matched, no
   guarantee evicted, and its injections, verdicts, fleet by hour, traffic
   and scalars equal to ``BENCH_FLEETDAY.json``'s ``day``.
3. The same day with the router's service model at the card's rates
   (``fleet_day.serving``; the admission overhead stays the day's 0.10,
   phase 8b replays the card's): the witness again at 6 of 6 and no
   guarantee evicted; ``bench.py --fleet-day``'s five gates reported,
   not enforced, and each tenant's outcomes and the scalars beside the
   reference-rate day's.
4. ``bench_fleetday_torch.py``'s smoke document, in this process.

Run the phase alone with::

    python3 tools/extender_phases.py --only 2k --out fleetday.json
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import statistics
import time

import torch
import yaml

import bench_fleetday_torch as BF
from tools import simulate_torch as TSIM
from tpushare_torch.workload import flash_attention as FA
from tpushare_torch.workload import model as M
from tpushare_torch.workload import serving as S

REPO = os.path.dirname(os.path.abspath(__file__))

#: The fleet day's replica: slots, cache length, prompt and new tokens
#: (``DecodeReplica``'s slots and ``max_len``, the day's ``prompt_len``
#: and ``max_new``).
RATE_SLOTS = 4
RATE_MAX_LEN = 2048
RATE_PROMPT = 128
RATE_STEPS = 64
#: Calls before the clock (a key's first call runs eagerly, its second
#: captures the graph) and timed calls, whose median is taken.
RATE_WARMUP = 3
RATE_REPS = 12
#: The fields of a day held to ``BENCH_FLEETDAY.json``'s.
DAY_FIELDS = ("injections", "witness", "fleetByHour", "traffic", "scalars")
MATCHED = {"matched": 6, "late": 0, "missing": 0, "spurious": 0}


def _event_ms(fn) -> float:
    """Card milliseconds between CUDA events recorded around ``fn()``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def service_rates(cs) -> dict:
    """Step 1: the card's decode and prefill rates at the day's replica
    shape, and the forward kernel's launches in the timed admissions."""
    if not torch.cuda.is_available():
        raise RuntimeError("the service rates need a CUDA device")
    cfg = dataclasses.replace(M.ModelConfig(), remat=False)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    with torch.inference_mode():
        params = M.init_params(gen, cfg, "cuda")
        state = S.init_server_state(cfg, RATE_SLOTS, RATE_MAX_LEN,
                                    device="cuda")
        prompts = [torch.randint(0, cfg.vocab_size, (RATE_PROMPT,),
                                 generator=gen, device="cuda")
                   for _ in range(RATE_SLOTS)]

        def admit(i: int) -> float:
            S.release(state, i)
            return _event_ms(lambda: S.admit_bucketed(
                params, state, prompts[i], i, attn_fn=FA.flash_attention))

        for _ in range(RATE_WARMUP):
            for i in range(RATE_SLOTS):
                admit(i)
        torch.cuda.synchronize()
        cs._zero_counts()
        admit_ms = [admit(r % RATE_SLOTS) for r in range(RATE_REPS)]
        launches = cs._counts()["flash_fwd"]
        cs.check(launches == cfg.n_layers * RATE_REPS,
                 f"2k: {launches} forward launches in {RATE_REPS} "
                 f"admissions of {cfg.n_layers} layers")
        cs.check(bool(state["active"].all()), "2k: a slot is idle")

        def chunk():
            _, emitted = S.serve_chunk(params, dict(state), RATE_STEPS)
            return emitted

        for _ in range(RATE_WARMUP):
            chunk()
        torch.cuda.synchronize()
        emitted = None

        def timed():
            nonlocal emitted
            emitted = chunk()

        chunk_ms = [_event_ms(timed) for _ in range(RATE_REPS)]
        cs.check(tuple(emitted.shape) == (RATE_STEPS, RATE_SLOTS)
                 and bool((emitted >= 0).all()),
                 "2k: a slot emitted no token in the timed chunk")
    admit_med = statistics.median(admit_ms)
    chunk_med = statistics.median(chunk_ms)
    return {
        "decode_tok_s": RATE_SLOTS * RATE_STEPS / (chunk_med / 1e3),
        "prefill_tok_s": RATE_PROMPT / (admit_med / 1e3),
        "admit_ms": admit_med, "admit_ms_min": min(admit_ms),
        "chunk_ms": chunk_med, "chunk_ms_min": min(chunk_ms),
        "shape": {"slots": RATE_SLOTS, "max_len": RATE_MAX_LEN,
                  "prompt": RATE_PROMPT, "steps": RATE_STEPS,
                  "reps": RATE_REPS, "n_layers": cfg.n_layers},
        "launches": launches,
    }


def committed_day() -> dict:
    with open(os.path.join(REPO, "BENCH_FLEETDAY.json"),
              encoding="utf-8") as f:
        return json.load(f)["day"]


def replay_day(serving: dict | None = None) -> dict:
    """``EXAMPLE_FLEET_DAY`` at its 24 hours and seed 1234 through the
    twin, the router's service model from ``serving`` when given."""
    scenario = yaml.safe_load(TSIM.EXAMPLE_FLEET_DAY)
    if serving:
        scenario["fleet_day"]["serving"] = dict(serving)
    t0 = time.perf_counter()
    day = TSIM.simulate(scenario, seed=BF.FLEETDAY_SEED)["fleet_day"]
    day["replay_s"] = time.perf_counter() - t0
    return day


def _check_day(cs, day: dict, name: str) -> None:
    cs.check(not day.get("error"), f"2k {name}: {day.get('error')}")
    witness = day["witness"]
    verdicts = [(v["id"], v["verdict"], v["legs"])
                for v in witness["verdicts"]]
    cs.check(witness["counts"] == MATCHED,
             f"2k {name}: witness {witness['counts']}, verdicts {verdicts}, "
             f"spurious {witness['spurious']}")
    cs.check(day["scalars"]["guarantee_evictions"] == 0,
             f"2k {name}: guarantee evictions {day['guaranteeEvictions']}")


def fleetday_phase(cs) -> dict:
    """Phase 2k (the module docstring)."""
    t0 = time.perf_counter()
    measured = service_rates(cs)
    cs.check(measured["launches"] > 0,
             "2k: no forward launch counted in the timed admissions")

    reference = replay_day()
    _check_day(cs, reference, "reference-rate day")
    committed = committed_day()
    unequal = [f for f in DAY_FIELDS if reference[f] != committed[f]]
    cs.check(not unequal, f"2k: the day's {unequal} differ from "
                          "BENCH_FLEETDAY.json's")

    serving = {"decode_tok_s": measured["decode_tok_s"],
               "prefill_tok_s": measured["prefill_tok_s"]}
    at_card = replay_day(serving)
    _check_day(cs, at_card, "card-rate day")
    gates = BF.day_gates(at_card)

    # bench_fleetday_torch's _Fleet applies the GC posture with a freeze:
    # hand this process's thresholds back after it.
    thresholds = gc.get_threshold()
    try:
        bench = BF.document(smoke=True)
    finally:
        gc.unfreeze()
        gc.set_threshold(*thresholds)
    cs.check(bench["day"]["witness"]["counts"] == MATCHED,
             f"2k bench twin: witness {bench['day']['witness']['counts']}")

    def side(day: dict) -> dict:
        return {"outcomes": day["traffic"]["outcomes"],
                "scaleOut": day["traffic"]["scaleOut"],
                "scalars": day["scalars"],
                "replay_s": day["replay_s"]}

    return {
        "rates": {k: v for k, v in measured.items() if k != "launches"},
        "reference_rates": dict(TSIM.FLEET_DAY_SERVING),
        "witness": {"reference_rate": reference["witness"]["counts"],
                    "card_rate": at_card["witness"]["counts"]},
        "reference_rate_day": side(reference),
        "card_rate_day": side(at_card),
        "card_rate_gates": gates,
        "bench_twin": bench,
        "launches": {"fleetday_rates": measured["launches"]},
        "phase_s": time.perf_counter() - t0,
    }
