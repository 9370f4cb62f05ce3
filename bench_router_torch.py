"""Traffic-replay benchmark for the port's serving front door
(``tpushare_torch/router/``): the twin of ``bench_router.py``, the same
replay over the port's ``Router``, ``QuotaManager`` and ``stats``, whose
JSON line equals the reference's for the same seed and flags.

    python3 bench_router_torch.py --smoke --gate

An open-loop, seeded request stream from three tenants rides through
the real Router policy against a fleet of decode replicas running the
analytic service model (slot counts, aggregate decode tokens/s and the
admission-overhead figure all taken from what ``bench_workload.py``
measured on a TPU, kept so the twins agree; ``chip_smoke.py`` replays
once more with the admission overhead its phase 8 measures on the card).
Three phases:

1. **steady**  — two interactive tenants at ~60% fleet occupancy;
2. **surge**   — a launch spike: the chat tenants rise 1.15x (in-quota
   demand — they QUEUE, never shed) while a burst tenant floods at 12x
   (past its quota-derived share — the router sheds it and caps its
   slots at its standing, via a real :class:`QuotaManager` carrying
   the same guarantees the scheduler enforces). Queues from the
   in-quota demand raise the scale-out signal; the bench plays the
   scheduler's side — new replicas join after a provisioning delay;
3. **recovery** — arrivals return to steady; the queues must drain.

Reports fleet tokens/s, per-phase TTFT p50/p99, per-tenant
served/shed counts, and per-tenant FAIRNESS under the surge (Jain
index over the non-surging tenants' served tokens — the surge must not
starve the tenants inside their shares). A second replay with the
pre-chunked-prefill admission overhead (22.1%, BENCH_WORKLOAD_r05)
quantifies what closing the serving gap buys at fleet level.

A third replay runs the SAME traffic against a paged-KV fleet: each
replica holds the same HBM but bills streams by pages, so it carries
2x the slots at the page budget one row fleet had, with 2x aggregate
decode tok/s (per-stream tok/s is flat — bench_workload's
``paged_per_stream_tok_s`` gate). The chat tenants declare a shared
128-token system preamble (``prefix_key``), so paged replicas charge
its pages once per live prefix. Gated: the paged fleet must shed the
flooder LATER (and less), raise FEWER scale-out signals, and hold the
same fairness floor — density showing up as deferred capacity
escalation, not as collateral on in-quota tenants.

Deterministic: virtual clock, seeded arrivals, no wall-time
dependence — CI runs it gated (``--gate``; ``--smoke`` shortens the
phases). Output: ONE JSON line (the bench.py contract).
"""

from __future__ import annotations

import argparse
import json
import random
import sys

from tpushare_torch.quota.config import QuotaConfig, TenantQuota
from tpushare_torch.quota.manager import QuotaManager
from tpushare_torch.router import DecodeReplica, Router
from tpushare_torch.utils import stats

#: Gates (enforced with --gate).
FAIRNESS_MIN = 0.90          #: Jain index over non-surge tenants
TTFT_P99_STEADY_MAX_S = 0.5  #: steady-phase p99 TTFT ceiling

#: Service-model constants, the reference's, from its workload bench on a
#: TPU (BENCH_WORKLOAD), not measured on the card: continuous decode
#: ~8.4k tok/s per replica, the chunked-prefill admission overhead gated
#: at <= 10%, the r05 pre-fused figure 22.1% for the comparison replay.
DECODE_TOK_S = 8400.0
PREFILL_TOK_S = 150_000.0
OVERHEAD_CHUNKED = 0.10
OVERHEAD_WHOLE = 0.221

#: Paged-fleet service model (bench_workload ``paged_decode``): same
#: HBM, 2x slots against the page budget, per-stream tok/s flat (the
#: ``paged_per_stream_tok_s`` gate) so aggregate decode doubles.
PAGE_TOKENS = 64
MAX_LEN = 2048
#: Chat requests share a tenant-scoped system preamble this long; the
#: paged fleet charges its pages once per live prefix.
SYSTEM_PREFIX_TOKENS = 128


def jain(xs: list[float]) -> float:
    """Jain's fairness index: 1.0 = perfectly equal shares."""
    if not xs or all(x == 0 for x in xs):
        return 1.0
    return (sum(xs) ** 2) / (len(xs) * sum(x * x for x in xs))


def build_quota() -> QuotaManager:
    """The same guarantees the scheduler would read from the
    tpushare-quotas ConfigMap: the chat tenants are owed equal shares,
    the burst tenant a half share — its surge is borrowing."""
    return QuotaManager(QuotaConfig(tenants={
        "chat-a": TenantQuota(guarantee_hbm=32, limit_hbm=64),
        "chat-b": TenantQuota(guarantee_hbm=32, limit_hbm=64),
        "burst": TenantQuota(guarantee_hbm=16, limit_hbm=64),
    }))


def replay(*, overhead: float, replicas: int, slots: int,
           steady_s: float, surge_s: float, recovery_s: float,
           provision_delay_s: float, max_extra: int, seed: int,
           dt: float = 0.02, paged: bool = False) -> dict:
    """One full open-loop replay; returns the result document.

    ``paged=True`` swaps every replica for its paged twin — same HBM,
    ``pages_total`` = the row fleet's page budget, 2x slots to let a
    mixed trace spend it, 2x aggregate decode (per-stream flat) — and
    leaves the TRAFFIC identical, so the two replays isolate what the
    memory model buys at fleet level."""
    rng = random.Random(seed)
    now = 0.0
    router = Router(quota=build_quota(), clock=lambda: now,
                    scaleout_queue_factor=0.25,
                    scaleout_cooldown_s=2.0,
                    # In-quota queues random-walk while the scale-out
                    # provisions (~3s): give them 3x-entitlement slack
                    # so the shed gate tests POLICY (the 12x flooder),
                    # not transient queueing noise.
                    shed_slack=3.0)

    def make_replica(name: str, node: str) -> DecodeReplica:
        if paged:
            return DecodeReplica(
                name, slots=slots * 2, node=node, hbm_gib=8.0,
                max_len=MAX_LEN, decode_tok_s=DECODE_TOK_S * 2,
                prefill_tok_s=PREFILL_TOK_S,
                admission_overhead=overhead,
                page_tokens=PAGE_TOKENS,
                pages_total=slots * (MAX_LEN // PAGE_TOKENS))
        return DecodeReplica(
            name, slots=slots, node=node, hbm_gib=8.0,
            max_len=MAX_LEN, decode_tok_s=DECODE_TOK_S,
            prefill_tok_s=PREFILL_TOK_S, admission_overhead=overhead)

    for i in range(replicas):
        router.add_replica(make_replica(f"decode-{i}",
                                        f"node-{i % 4}"))

    #: Scheduler side of the scale-out loop: each signal provisions one
    #: replica of the requested shape after the bind+boot delay.
    pending_joins: list[float] = []
    signals_at: list[float] = []
    extra = 0

    def on_scaleout(spec: dict) -> None:
        nonlocal extra
        signals_at.append(round(now, 2))
        if extra < max_extra:
            extra += 1
            pending_joins.append(now + provision_delay_s)

    router.on_scaleout = on_scaleout

    # Steady arrival rates: the chat pair at ~60% of fleet decode
    # capacity, burst a trickle until its surge.
    per_slot = DECODE_TOK_S / slots
    mean_new = 96.0
    service_s = mean_new / per_slot          # mean slot-holding time
    fleet = replicas * slots
    chat_rate = 0.30 * fleet / service_s     # req/s per chat tenant
    rates = {"chat-a": chat_rate, "chat-b": chat_rate,
             "burst": 0.05 * fleet / service_s}
    next_arrival = {t: rng.expovariate(r) for t, r in rates.items()}

    t_surge = steady_s
    t_recover = steady_s + surge_s
    t_end = t_recover + recovery_s

    phase_of = (lambda t: "steady" if t < t_surge
                else "surge" if t < t_recover else "recovery")
    book: dict[str, tuple[str, float, str]] = {}   # rid -> meta
    ttft: dict[str, list[float]] = {p: [] for p in
                                    ("steady", "surge", "recovery")}
    served: dict[str, dict[str, int]] = {
        p: {t: 0 for t in rates} for p in ttft}
    outcomes: dict[str, dict[str, int]] = {
        t: {"assigned": 0, "queued": 0, "shed": 0} for t in rates}
    # Chat rises but stays inside its guarantee-derived slot share
    # (~0.35 of the fleet each vs 0.4 entitled — they queue, never
    # shed; past ~0.4 the pair would sit critically loaded and its
    # backlog would random-walk into the shed threshold); burst goes
    # 12x past its share (it sheds).
    surge_mult = {"chat-a": 1.15, "chat-b": 1.15, "burst": 12.0}
    max_queue = 0
    first_shed_at: float | None = None

    while now < t_end:
        phase = phase_of(now)
        for tenant, rate in rates.items():
            eff = rate * (surge_mult[tenant] if phase == "surge"
                          else 1.0)
            while next_arrival[tenant] <= now:
                prompt = rng.choice((32, 64, 128, 128, 256, 512, 768,
                                     1024))
                n_new = max(16, min(256, int(rng.gauss(mean_new, 48))))
                # Chat requests carry the tenant's system preamble —
                # shareable prefix pages on a paged fleet, inert on a
                # rows fleet (pages are whole rows there).
                prefix = (dict(prefix_key="system-preamble",
                               prefix_len=SYSTEM_PREFIX_TOKENS)
                          if tenant.startswith("chat") else {})
                dec = router.submit(tenant, prompt, n_new, now=now,
                                    **prefix)
                outcomes[tenant][dec["outcome"]] += 1
                if dec["outcome"] != "shed":
                    book[dec["rid"]] = (tenant, now, phase)
                elif first_shed_at is None:
                    first_shed_at = round(now, 2)
                next_arrival[tenant] += rng.expovariate(eff)
        while pending_joins and pending_joins[0] <= now:
            pending_joins.pop(0)
            router.add_replica(make_replica(
                f"decode-x{extra}-{len(pending_joins)}", "node-new"))
        for ev in router.tick(now=now):
            meta = book.get(ev.rid)
            if meta is None:
                continue
            tenant, arrival, arr_phase = meta
            if ev.kind == "first-token":
                ttft[phase_of(ev.at)].append(ev.at - arrival)
            elif ev.kind == "complete":
                served[phase_of(ev.at)][tenant] += 1
                book.pop(ev.rid, None)
        max_queue = max(max_queue,
                        router.snapshot()["queuedTotal"])
        now += dt

    final = router.snapshot()

    def pctl(samples: list[float]) -> dict:
        if not samples:
            return {"p50": None, "p99": None, "n": 0}
        s = sorted(samples)
        return {"p50": round(stats.quantile_sorted(s, 0.5), 4),
                "p99": round(stats.quantile_sorted(s, 0.99), 4),
                "n": len(s)}

    surge_chat = [served["surge"]["chat-a"], served["surge"]["chat-b"]]
    doc = {
        "fleet": {"replicas": replicas, "extraProvisioned": extra,
                  "slotsPerReplica": slots * 2 if paged else slots,
                  "paged": paged,
                  "pagesPerReplica": (slots * (MAX_LEN // PAGE_TOKENS)
                                      if paged else None),
                  "admissionOverhead": overhead},
        "phases": {p: {"ttft": pctl(ttft[p]),
                       "served": {t: served[p][t] for t in rates}}
                   for p in ttft},
        "tenants": {t: dict(outcomes[t],
                            ttftP99=final["tenants"].get(
                                t, {}).get("ttft", {}).get("p99"))
                    for t in rates},
        "fleetTokensPerS": final["fleetTokensPerS"],
        "maxQueueDepth": max_queue,
        "queuedAtEnd": final["queuedTotal"],
        "scaleOut": {"signals": final["scaleOut"]["signals"],
                     "signalTimes": signals_at[:8]},
        "fairnessJainSurge": round(jain(surge_chat), 4),
        "firstShedAt": first_shed_at,
        "shedTotal": sum(o["shed"] for o in outcomes.values()),
        "prefix": final.get("prefix"),
    }
    return doc


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gate", action="store_true",
                    help="enforce the fairness/shed/drain gates")
    ap.add_argument("--smoke", action="store_true",
                    help="short phases (CI)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--replicas", type=int, default=6)
    ap.add_argument("--slots", type=int, default=8)
    args = ap.parse_args()

    steady, surge, recovery = ((8.0, 6.0, 10.0) if args.smoke
                               else (20.0, 15.0, 25.0))
    common = dict(replicas=args.replicas, slots=args.slots,
                  steady_s=steady, surge_s=surge, recovery_s=recovery,
                  provision_delay_s=3.0, max_extra=4, seed=args.seed)
    print("replay (chunked-prefill fleet, overhead "
          f"{OVERHEAD_CHUNKED:.0%}):", file=sys.stderr)
    chunked = replay(overhead=OVERHEAD_CHUNKED, **common)
    print(f"  {json.dumps(chunked['phases']['surge'])}", file=sys.stderr)
    print("replay (whole-prefill fleet, overhead "
          f"{OVERHEAD_WHOLE:.1%}):", file=sys.stderr)
    whole = replay(overhead=OVERHEAD_WHOLE, **common)
    print("replay (paged-KV fleet, same traffic):", file=sys.stderr)
    paged = replay(overhead=OVERHEAD_CHUNKED, paged=True, **common)
    print(f"  {json.dumps(paged['phases']['surge'])}", file=sys.stderr)

    shed = {t: chunked["tenants"][t]["shed"]
            for t in ("chat-a", "chat-b", "burst")}
    steady_p99 = chunked["phases"]["steady"]["ttft"]["p99"]
    paged_shed = {t: paged["tenants"][t]["shed"]
                  for t in ("chat-a", "chat-b", "burst")}
    gates = {
        # The surge must not starve the tenants inside their shares.
        "fairness_min": bool(
            chunked["fairnessJainSurge"] >= FAIRNESS_MIN),
        # Only the over-quota tenant sheds — policy, not collateral.
        "shed_isolated_to_surge_tenant": bool(
            shed["chat-a"] == 0 and shed["chat-b"] == 0
            and shed["burst"] > 0),
        # Queues building must raise the scheduler signal...
        "scaleout_signaled": bool(
            chunked["scaleOut"]["signals"] >= 1),
        # ...and the provisioned capacity must drain them.
        "queues_drain": bool(chunked["queuedAtEnd"] == 0),
        "ttft_p99_steady": bool(
            steady_p99 is not None
            and steady_p99 <= TTFT_P99_STEADY_MAX_S),
        # Paged fleet, same traffic: the density must show up as
        # DEFERRED capacity escalation — later first shed, less total
        # shed, fewer scale-out signals — at the same fairness floor
        # and with shedding still isolated to the flooder.
        "paged_fairness_min": bool(
            paged["fairnessJainSurge"] >= FAIRNESS_MIN),
        "paged_shed_isolated": bool(
            paged_shed["chat-a"] == 0 and paged_shed["chat-b"] == 0),
        "paged_sheds_later": bool(
            paged["firstShedAt"] is None
            or (chunked["firstShedAt"] is not None
                and paged["firstShedAt"] >= chunked["firstShedAt"])),
        "paged_sheds_less": bool(
            paged["shedTotal"] < chunked["shedTotal"]),
        "paged_fewer_scaleout_signals": bool(
            paged["scaleOut"]["signals"]
            < chunked["scaleOut"]["signals"]),
        "paged_queues_drain": bool(paged["queuedAtEnd"] == 0),
    }
    doc = {
        "metric": "router_traffic_replay",
        # Headline: surge-phase p99 TTFT on the chunked-prefill fleet.
        "value": chunked["phases"]["surge"]["ttft"]["p99"],
        "unit": "s",
        "chunked": chunked,
        # The serving tentpole's fleet-level payoff: same traffic, the
        # r05 22.1% admission overhead instead of the gated 10%.
        "whole_prefill_baseline": {
            "fleetTokensPerS": whole["fleetTokensPerS"],
            "surgeTtft": whole["phases"]["surge"]["ttft"],
            "recoveryTtft": whole["phases"]["recovery"]["ttft"],
        },
        # Same traffic on the paged fleet (the tentpole's fleet-level
        # payoff): pages_free routing + per-page admission defer the
        # shed and the scale-out signal the row fleet had to raise.
        "paged": paged,
        "gates": gates,
    }
    print(json.dumps(doc))
    if args.gate and not all(gates.values()):
        failed = [k for k, v in gates.items() if not v]
        print(f"bench_router: GATE FAILURE: {failed}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
