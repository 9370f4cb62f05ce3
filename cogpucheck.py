"""Co-tenancy check on one NVIDIA card: the PyTorch port's twin of
``cochipcheck.py``.

Tenant processes share one card's memory under grants, each started with
the env the device plugin's allocation emits (``_tenant_env``, through
``deviceplugin.plugin.build_allocation``) and configured by the
port's runtime contract (``torchenv.configure`` before CUDA starts, then
``torchenv.apply_memory_fraction``, which caps the caching allocator at
the grant's fraction). The card's GiB comes from the port's NVIDIA
discovery, for the card ``CUDA_VISIBLE_DEVICES`` names. Each tenant is a
subprocess that prints one JSON line; a tenant that holds memory prints
``READY`` once it holds it and keeps it until the parent closes its
stdin, so every hand-off waits on a signal, not on a sleep. A tenant
touches the card only once the parent writes ``GO`` to its stdin, so the
parent starts it early and it imports while the phases before its own run.

Phases (all of them in ``--smoke``, which only shortens the tenants'
budgets):

1. **Concurrent.** Train (the flagship, 8 x 512, flash attention through
   the kernels) and decode (``max_batch_for_grant``-sized generate) each
   under a grant of 7/16 of the card. Once both are ready an overcommitter
   (grant 4 GiB) asks for the card's GiB + 16 and must raise
   ``torch.cuda.OutOfMemoryError``; both tenants must still be running
   when it dies, and both must finish OK.
2. **Fraction cap.** A tenant under a 4 GiB grant allocates 10 GiB: does
   the allocator cap refuse it (``runtime_enforced``)?
3. **Isolation.** Two whole-card-grant ballasts each hold 0.6 of the
   card at once: on one card exactly one is refused.
4. **Estimator.** Decode at ``max_batch_for_grant``'s whole-card
   prediction must run; at 2.5x it must raise ``OutOfMemoryError``.
5. **Full grant.** Two ballasts under 7/16 grants each hold 85% of the
   grant (the allocator cap is 90% of it), then, released together,
   multiply together.
6. **Watchdog.** An uncooperative hog (grant 4, 10 GiB, no cap) and an
   innocent ballast (grant 7, holding 6) start in the envs of the port's
   device plugin's ``Allocate`` for two pods the extender assumed on the
   card, and heartbeat into ``<dir>/<uid>/usage.json``: the hog's
   ``bytes_in_use`` is above its grant, the innocent's within it. The
   port's ``GrantWatchdog`` sweeps them and must name the hog alone, put a
   Warning event on it, and attribute the innocent's failures to it by
   name in an event on the innocent. Each heartbeat is set beside
   ``nvidia-smi``'s per-process memory.

Usage: ``python cogpucheck.py [--smoke] [--out COTENANCY_gpu.json]``
(a tenant runs as ``python cogpucheck.py --tenant NAME`` and starts at a
``GO`` line on its stdin). Exits 2 with
no report on a host without a CUDA device, 1 when a gate fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import queue
import subprocess
import sys
import tempfile
import threading
import time

import torch

from tpushare_torch.deviceplugin import discovery, plugin, watchdog
from tpushare_torch.k8s import events
from tpushare_torch.k8s.fake import FakeApiServer
from tpushare_torch.runtime import torchenv
from tpushare_torch.utils import const
from tpushare_torch.workload import flash_attention as FA
from tpushare_torch.workload import model as M
from tpushare_torch.workload import serving as S
from tpushare_torch.workload import train as T

REPO = os.path.dirname(os.path.abspath(__file__))
GIB = 1 << 30
READY = "READY"
#: What a tenant waits for on its stdin before it touches the card.
GO = "GO"
#: cochipcheck's grants were 7 GiB of a 16 GiB chip: 7/16 of the card.
SHARE = (7, 16)
TRAIN_BATCH = (8, 512)
#: Decode: cache rows, prompt and new tokens, as cochipcheck's tenant.
DECODE_MAX_LEN, DECODE_PROMPT, DECODE_NEW = 512, 32, 128
#: The estimator's config: its KV cache dominates its memory.
ESTIMATOR_CFG = M.ModelConfig(d_model=1024, n_layers=8, d_ff=4096,
                              max_seq_len=4096, remat=False)
ESTIMATOR_MAX_LEN = 4096
#: A ballast's work: 16 products of 4096 x 4096 bf16 an iteration.
MATMUL_N, MATMUL_CHAIN = 4096, 16
#: Phase 6: the node of the fake apiserver, and the two pods the
#: extender assumed on the card as (name, grant GiB), in assume order.
NODE = "cogpucheck-node"
WATCHDOG_PODS = (("hog", 4), ("innocent", 7))
#: Sweeps a second until both tenants' heartbeats are fresh.
SWEEP_DEADLINE_S = 60


@dataclasses.dataclass(frozen=True)
class Card:
    """The card the co-tenants share: the host's inventory, the card's
    record in it (host index, model, usable GiB) and the CUDA id this
    process reaches it by."""

    inv: discovery.HostInventory
    chip: discovery.ChipSpec
    cuda_id: str


# ---------------------------------------------------------------------------
# Tenant bodies (run in subprocesses with the injected env already set)
# ---------------------------------------------------------------------------

def _tenant_env(grant_gib: float, card: Card,
                alloc: plugin.ContainerAllocation | None = None) -> dict:
    """This process's env, without its heartbeat file, with the envs the
    device plugin's ``Allocate`` emitted (``alloc``), or emits for this
    grant (``build_allocation`` on the shared card's host index in the
    discovered inventory, with no heartbeat file). No container runtime
    renumbers these processes' cards, so a tenant reaches the card by the
    CUDA id this process reaches it by, not by the allocation's
    in-container ordinal 0."""
    if alloc is None:
        alloc = plugin.build_allocation(card.inv, [card.chip.index],
                                        int(grant_gib),
                                        pod_uid="cogpucheck", usage_dir="")
    env = {k: v for k, v in os.environ.items() if k != const.ENV_USAGE_FILE}
    env.update(alloc.envs)
    env[const.ENV_CUDA_VISIBLE_DEVICES] = card.cuda_id
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _configure(cap: bool = True):
    """The workload side of the contract: read the grant and restrict
    the process to its card before CUDA starts, then cap the allocator
    at the grant's fraction (an uncooperative tenant skips the cap).
    Returns (grant, the fraction set or None)."""
    grant = torchenv.configure()
    if grant is None:
        raise RuntimeError("tenant started without the injected grant env")
    return grant, torchenv.apply_memory_fraction(grant) if cap else None


def _heartbeat() -> tuple[float | None, str | None]:
    """Write one heartbeat and start the periodic reporter (no-ops
    without ``TPUSHARE_USAGE_FILE``); this tenant's (reserved GiB,
    source), None without a card."""
    snap = torchenv.write_usage() or torchenv.usage_snapshot()
    torchenv.start_usage_reporter(interval=5.0)
    if snap is None:
        return None, None
    return round(snap["bytes_in_use"] / GIB, 2), snap["source"]


def _ready() -> None:
    print(READY, flush=True)


def _oom(exc: torch.cuda.OutOfMemoryError) -> str:
    return f"OutOfMemoryError: {str(exc)[:300]}"


def _launches() -> dict:
    return {"flash_fwd": FA.FLASH_FWD_LAUNCHES,
            "flash_bwd_dq": FA.FLASH_BWD_DQ_LAUNCHES,
            "flash_bwd_dkv": FA.FLASH_BWD_DKV_LAUNCHES}


def _reset_launches() -> None:
    FA.FLASH_FWD_LAUNCHES = 0
    FA.FLASH_BWD_DQ_LAUNCHES = 0
    FA.FLASH_BWD_DKV_LAUNCHES = 0


def tenant_train(seconds: float, release: threading.Event,
                 cfg: M.ModelConfig | None = None,
                 device: str = "cuda") -> dict:
    """Train the flagship on one fixed batch through ``make_train_step``
    (flash attention through the kernels on the card): a warm-up step,
    READY, then steps until ``seconds`` have passed and the parent has
    released it. ``mem_fraction_env`` is the allocator fraction set, the
    counterpart of the JAX tenant's env value."""
    grant, fraction = _configure()
    cfg = cfg or M.ModelConfig()
    batch, length = TRAIN_BATCH
    init_fn, step, place = T.make_train_step(cfg, mesh=None, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (batch, length), generator=gen,
                           device=device)
    targets = torch.roll(tokens, -1, dims=1)
    params, opt = init_fn(gen, tokens)
    tokens, targets = place(tokens, targets)
    params, opt, loss = step(params, opt, tokens, targets)
    loss.item()
    _ready()
    _reset_launches()
    steps, t0 = 0, time.time()
    while not steps or time.time() - t0 < seconds or not release.is_set():
        params, opt, loss = step(params, opt, tokens, targets)
        steps += 1
    lv = loss.item()
    dt = time.time() - t0
    return {"tenant": "train", "grant_gib": grant.hbm_pod_gib,
            "mem_fraction_env": fraction,
            "device_count": torch.cuda.device_count(),
            "steps": steps, "wall_s": round(dt, 2),
            "tok_per_s": round(steps * batch * length / dt),
            "loss_finite": math.isfinite(lv),
            "n_layers": cfg.n_layers, "remat": cfg.remat,
            "launches": _launches()}


def tenant_decode(seconds: float, release: threading.Event,
                  cfg: M.ModelConfig | None = None,
                  device: str = "cuda") -> dict:
    """Greedy ``generate`` at ``min(max_batch_for_grant, 64)`` rows,
    prefill through the flash kernel: a warm-up call, READY, then calls
    until ``seconds`` have passed and the parent has released it."""
    grant, fraction = _configure()
    cfg = cfg or M.ModelConfig()
    fit = S.max_batch_for_grant(cfg, grant.hbm_pod_gib, DECODE_MAX_LEN)
    if fit <= 0:
        raise RuntimeError(f"a {grant.hbm_pod_gib} GiB grant cannot hold "
                           f"the weights")
    batch = min(fit, 64)
    gen = torch.Generator(device=device).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (batch, DECODE_PROMPT),
                            generator=gen, device=device)
    params = M.init_params(gen, cfg, device)

    def generate():
        return S.generate(params, prompts, cfg, n_new=DECODE_NEW,
                          max_len=DECODE_MAX_LEN, attn_fn=FA.flash_attention)

    generate()[0, -1].item()
    _ready()
    _reset_launches()
    calls, t0 = 0, time.time()
    while not calls or time.time() - t0 < seconds or not release.is_set():
        out = generate()
        calls += 1
    ok = bool(((out >= 0) & (out < cfg.vocab_size)).all())
    dt = time.time() - t0
    return {"tenant": "decode", "grant_gib": grant.hbm_pod_gib,
            "mem_fraction_env": fraction,
            "device_count": torch.cuda.device_count(),
            "max_batch_for_grant": fit, "batch": batch,
            "decode_tok_per_s": round(calls * batch * DECODE_NEW / dt),
            "wall_s": round(dt, 2), "tokens_in_vocab": ok,
            "generates": calls, "n_layers": cfg.n_layers,
            "launches": _launches()}


def tenant_overcommit(ask_gib: float) -> dict:
    """Ask for more than the card holds: must raise OutOfMemoryError
    (any other exception fails the tenant). Records whether the message
    names the allocator cap ("allowed") or only the card."""
    grant, fraction = _configure()
    try:
        x = torch.empty(int(ask_gib * GIB), dtype=torch.uint8, device="cuda")
    except torch.cuda.OutOfMemoryError as exc:
        return {"tenant": "overcommit", "ask_gib": ask_gib,
                "grant_gib": grant.hbm_pod_gib, "memory_fraction": fraction,
                "outcome": "refused", "error": _oom(exc),
                "names_cap": "allowed" in str(exc)}
    return {"tenant": "overcommit", "ask_gib": ask_gib,
            "outcome": "ALLOCATED", "bytes": x.numel()}  # parent: FAIL


def tenant_overrun(alloc_gib: float, cap: bool,
                   release: threading.Event) -> dict:
    """Allocate past the grant but within the card, with the allocator
    cap (does it refuse?) or without it (an uncooperative tenant, which
    heartbeats what it really holds), then hold until released."""
    grant, fraction = _configure(cap)
    base = {"tenant": "overrun", "grant_gib": grant.hbm_pod_gib,
            "alloc_gib": alloc_gib, "memory_fraction": fraction,
            "pid": os.getpid()}
    try:
        x = torch.ones(int(alloc_gib * GIB), dtype=torch.uint8, device="cuda")
    except torch.cuda.OutOfMemoryError as exc:
        return {**base, "outcome": "refused", "error": _oom(exc)}
    resident = int(x[:3].sum()) == 3
    reported, source = _heartbeat()
    _ready()
    release.wait()
    return {**base, "outcome": "allocated", "resident": resident,
            "reported_gib": reported, "usage_source": source}


def tenant_ballast(gib: float, work_iters: int,
                   release: threading.Event) -> dict:
    """Hold ``gib`` (refused with OutOfMemoryError if it does not fit),
    READY, hold until released, then run ``work_iters`` iterations of bf16
    products (ballasts released together multiply together). Heartbeats
    when the usage contract is injected."""
    grant, fraction = _configure()
    base = {"tenant": "ballast", "gib": gib, "grant_gib": grant.hbm_pod_gib,
            "memory_fraction": fraction, "pid": os.getpid()}
    try:
        x = torch.ones(int(gib * GIB), dtype=torch.uint8, device="cuda")
    except torch.cuda.OutOfMemoryError as exc:
        return {**base, "outcome": "refused", "error": _oom(exc)}
    m = torch.ones((MATMUL_N, MATMUL_N), dtype=torch.bfloat16, device="cuda")

    def work():
        p = m
        for _ in range(MATMUL_CHAIN):
            p = (p @ p) * 1e-3
        return p.float().sum()

    work().item()
    reported, source = _heartbeat()
    _ready()
    release.wait()
    t0 = time.time()
    for _ in range(work_iters):
        s = work()
    val = s.item()
    dt = time.time() - t0
    return {**base, "outcome": "held", "work_iters": work_iters,
            "work_s": round(dt, 3), "finite": val == val,
            "matmul_iters_per_s": round(work_iters / dt, 2),
            "resident_after_hold": int(x[:3].sum()) == 3,
            "reported_gib": reported, "usage_source": source}


def tenant_estimator(overshoot: float) -> dict:
    """Decode at ``max_batch_for_grant``'s prediction for this grant
    (must run) or ``overshoot`` times it (past the card: must raise
    OutOfMemoryError), with the peak the allocator saw."""
    grant, _ = _configure()
    cfg = ESTIMATOR_CFG
    fit = S.max_batch_for_grant(cfg, grant.hbm_pod_gib, ESTIMATOR_MAX_LEN)
    batch = max(int(fit * overshoot), 1)
    gen = torch.Generator(device="cuda").manual_seed(2)
    params = M.init_params(gen, cfg)
    prompts = torch.randint(0, cfg.vocab_size, (batch, 16), generator=gen,
                            device="cuda")
    base = {"tenant": "estimator", "grant_gib": grant.hbm_pod_gib,
            "predicted_batch": fit, "batch": batch, "overshoot": overshoot,
            "cache_bytes": S.cache_hbm_bytes(cfg, batch, ESTIMATOR_MAX_LEN)}
    try:
        out = S.generate(params, prompts, cfg, n_new=4,
                         max_len=ESTIMATOR_MAX_LEN,
                         attn_fn=FA.flash_attention)
        ok = bool(((out >= 0) & (out < cfg.vocab_size)).all())
    except torch.cuda.OutOfMemoryError as exc:
        return {**base, "outcome": "refused", "error": _oom(exc),
                "peak_bytes": torch.cuda.max_memory_allocated()}
    return {**base, "outcome": "ran", "tokens_in_vocab": ok,
            "peak_bytes": torch.cuda.max_memory_allocated()}


# ---------------------------------------------------------------------------
# Orchestrator
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Tenant:
    """A tenant process: a thread moves its stdout lines onto ``lines``
    (None at EOF), its stderr goes to a file, closing its stdin releases
    it."""

    name: str
    proc: subprocess.Popen
    lines: queue.Queue
    stderr: object
    out: list = dataclasses.field(default_factory=list)
    eof: bool = False


def _pump(stream, lines: queue.Queue) -> None:
    for line in stream:
        lines.put(line)
    lines.put(None)


def _spawn(tenant: str, grant_gib: float, *args, card: Card,
           spawned: list,
           alloc: plugin.ContainerAllocation | None = None) -> _Tenant:
    """Start a tenant: it imports, then waits for :func:`_go` before it
    configures CUDA, so started early its imports overlap the phases
    before its own."""
    cmd = [sys.executable, os.path.abspath(__file__), "--tenant", tenant,
           "--tenant-args", ",".join(str(a) for a in args)]
    env = _tenant_env(grant_gib, card, alloc)
    err = tempfile.TemporaryFile(mode="w+", encoding="utf-8")
    proc = subprocess.Popen(cmd, env=env, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=err, text=True)
    t = _Tenant(tenant, proc, queue.Queue(), err)
    threading.Thread(target=_pump, args=(proc.stdout, t.lines),
                     daemon=True).start()
    spawned.append(t)
    return t


def _go(t: _Tenant) -> _Tenant:
    """Let a tenant start its work."""
    t.proc.stdin.write(GO + "\n")
    t.proc.stdin.flush()
    return t


def _next_line(t: _Tenant, timeout: float) -> str | None:
    if t.eof:
        return None
    line = t.lines.get(timeout=timeout)
    if line is None:
        t.eof = True
    return line


def _wait_ready(t: _Tenant, timeout: float) -> bool:
    """True once the tenant printed READY; False if it exited first (its
    result is then in its output) or ``timeout`` passed."""
    deadline = time.time() + timeout
    while True:
        try:
            line = _next_line(t, max(0.0, deadline - time.time()))
        except queue.Empty:
            return False
        if line is None:
            return False
        if line.strip() == READY:
            return True
        t.out.append(line)


def _release(*tenants: _Tenant) -> None:
    """Close each tenant's stdin: a tenant that holds lets go."""
    for t in tenants:
        try:
            t.proc.stdin.close()
        except OSError:
            pass


def _collect(t: _Tenant, timeout: float) -> dict:
    """Release the tenant, wait for it, and return its JSON line with its
    exit code (or why there is none)."""
    _release(t)
    timed_out = False
    try:
        t.proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        t.proc.kill()
        t.proc.wait()
        timed_out = True
    while True:
        try:
            line = _next_line(t, 30.0)
        except queue.Empty:
            break
        if line is None:
            break
        t.out.append(line)
    t.stderr.seek(0)
    err_tail = t.stderr.read()[-400:]
    t.stderr.close()
    if timed_out:
        return {"outcome": "TIMEOUT", "stderr_tail": err_tail}
    for line in reversed(t.out):
        if line.startswith("{"):
            d = json.loads(line)
            d["exit_code"] = t.proc.returncode
            return d
    return {"outcome": "NO_OUTPUT", "exit_code": t.proc.returncode,
            "stderr_tail": err_tail}


def _refused_oom(r: dict) -> bool:
    return (r.get("outcome") == "refused"
            and r.get("error", "").startswith("OutOfMemoryError"))


def _compute_apps() -> dict[int, int] | None:
    """pid -> MiB NVIDIA charges each process on the card, from
    ``nvidia-smi --query-compute-apps``; None if nvidia-smi fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    apps = {}
    for line in out.strip().splitlines():
        pid, _, mib = line.partition(",")
        if pid.strip().isdigit() and mib.strip().isdigit():
            apps[int(pid)] = int(mib)
    return apps


def find_card(environ=None) -> Card:
    """The card ``CUDA_VISIBLE_DEVICES`` names (its first entry; card 0
    when unset), from discovery. CUDA numbers the cards a process sees
    from 0 in discovery's order, whatever their device nodes' numbers (a
    container given ``/dev/nvidia5`` alone calls it card 0)."""
    env = os.environ if environ is None else environ
    inv = discovery.discover_host(environ=env)
    if inv is None:
        raise RuntimeError("discovery found no NVIDIA card on this host")
    first = env.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0].strip()
    pos = int(first) if first.isdigit() else 0
    if pos >= inv.chip_count or inv.chips[pos].hbm_gib <= 0:
        raise RuntimeError(f"discovery cannot size card {first!r}: {inv}")
    return Card(inv, inv.chips[pos], first or "0")


def card_gib(environ=None) -> tuple[str, int]:
    """(model, usable GiB) of :func:`find_card`'s card."""
    chip = find_card(environ).chip
    return chip.chip_type, chip.hbm_gib


def assumed_pod(name: str, gib: int, chip: int, card_gib: int,
                assume_ns: int, node: str = NODE) -> dict:
    """A one-container pod asking ``gib`` GiB, as the extender's bind
    leaves it on ``node``: bound, assumed on host card ``chip`` of
    ``card_gib`` GiB, not yet assigned, its uid ``uid-<name>``."""
    return {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": name, "namespace": "default",
                     "uid": f"uid-{name}", "annotations": {
                         const.ANN_CHIP_IDX: str(chip),
                         const.ANN_HBM_POD: str(gib),
                         const.ANN_HBM_CHIP: str(card_gib),
                         const.ANN_ASSIGNED: const.ASSIGNED_FALSE,
                         const.ANN_ASSUME_TIME: str(assume_ns)}},
        "spec": {"nodeName": node, "containers": [{
            "name": "main",
            "resources": {"limits": {const.HBM_RESOURCE: str(gib)}}}]},
        "status": {"phase": "Pending"},
    }


def watchdog_allocations(card: Card, usage_dir: str
                         ) -> tuple[FakeApiServer, dict]:
    """The node side of phase 6: the pods of ``WATCHDOG_PODS`` assumed on
    the card, and the port's plugin's ``Allocate`` of each one's grant,
    which commits it and names its heartbeat file under ``usage_dir``.
    Returns the apiserver and the allocations by pod name."""
    api = FakeApiServer()
    api.create_node({"apiVersion": "v1", "kind": "Node",
                     "metadata": {"name": NODE}})
    for i, (name, gib) in enumerate(WATCHDOG_PODS):
        api.create_pod(assumed_pod(name, gib, card.chip.index,
                                   card.chip.hbm_gib, i + 1))
    plug = plugin.TPUSharePlugin(NODE, api, card.inv, usage_dir=usage_dir)
    plug.annotate_node()
    allocs = {name: plug.allocate_hbm([f"gib-{i}" for i in range(gib)])
              for name, gib in WATCHDOG_PODS}
    for name, _ in WATCHDOG_PODS:
        pod = api.get_pod("default", name)
        if pod.annotations.get(const.ANN_ASSIGNED) != const.ASSIGNED_TRUE:
            raise RuntimeError(f"Allocate did not commit {name}")
    return api, allocs


def watchdog_verdicts(sweep: dict, events_seen: list) -> dict[str, bool]:
    """Phase 6's watchdog gates over a sweep document and the events
    posted as (pod, reason, message): the overruns are exactly the hog,
    a Warning of overrun is on the hog, and the innocent's event names
    the hog."""
    return {
        "overrunner_named": [o["pod"] for o in sweep.get("overruns", [])]
        == ["hog"],
        "overrun_event_on_hog": any(
            name == "hog" and reason == watchdog.REASON_OVERRUN
            for name, reason, _ in events_seen),
        "innocent_attributed": any(
            name == "innocent" and reason == watchdog.REASON_STARVED
            and "hog" in msg for name, reason, msg in events_seen),
    }


def run_suite(smoke: bool) -> dict:
    """Build the kernels, run the six phases and return the report, its
    ``gates`` and ``ok``. Every tenant started is stopped on the way
    out."""
    found = find_card()
    model, card = found.chip.chip_type, found.chip.hbm_gib
    FA.build()
    spawned: list[_Tenant] = []

    def spawn(tenant, grant_gib, *args, **kw):
        return _spawn(tenant, grant_gib, *args, card=found,
                      spawned=spawned, **kw)

    share = card * SHARE[0] // SHARE[1]
    report: dict = {"card": model, "card_gib": card, "share_gib": share,
                    "device_count": torch.cuda.device_count(),
                    "contract": "torchenv.configure -> CUDA_VISIBLE_DEVICES; "
                                "apply_memory_fraction -> "
                                "set_per_process_memory_fraction"}
    try:
        with tempfile.TemporaryDirectory(prefix="cogpucheck-usage-") as usage:
            _phases(report, spawn, found, share, smoke, usage)
    finally:
        for t in spawned:
            if t.proc.poll() is None:
                t.proc.kill()
                t.proc.wait()
    report["gates"] = gates(report)
    report["ok"] = all(report["gates"].values())
    return report


def _phases(report: dict, spawn, found: Card, share: int, smoke: bool,
            usage: str) -> None:
    card = found.chip.hbm_gib
    busy_s = 15 if smoke else 45
    iters = 100 if smoke else 400
    # Every tenant starts ahead of its phase and touches the card only at
    # _go: phase 1's at once, the later phases' once phase 1's two hold the
    # card.
    waiting = {key: spawn(tenant, grant, *args)
             for key, tenant, grant, args in (
                 ("train", "train", share, (busy_s,)),
                 ("decode", "decode", share, (busy_s,)),
                 ("overcommit", "overcommit", 4, (card + 16,)))}

    # 1. Train and decode under 7/16 grants; the overcommitter joins once
    # both are ready and must die while both keep running.
    t0 = time.time()
    p_train = _go(waiting["train"])
    p_decode = _go(waiting["decode"])
    ready = {t.name: _wait_ready(t, 600) for t in (p_train, p_decode)}
    waiting.update({key: spawn(tenant, grant, *args)
                  for key, tenant, grant, args in (
                      ("overrun", "overrun", 4, (10, 1)),
                      ("isolation_a", "ballast", card,
                       (round(0.6 * card, 2), 2)),
                      ("isolation_b", "ballast", card,
                       (round(0.6 * card, 2), 2)),
                      ("fit", "estimator", card, (1.0,)),
                      ("burst", "estimator", card, (2.5,)),
                      ("full_a", "ballast", share,
                       (round(0.85 * share, 2), iters)),
                      ("full_b", "ballast", share,
                       (round(0.85 * share, 2), iters)))})
    watch = watchdog_start(spawn, found, usage)
    r_over = _collect(_go(waiting["overcommit"]), 300)
    running = p_train.proc.poll() is None and p_decode.proc.poll() is None
    _release(p_train, p_decode)
    r_train, r_decode = _collect(p_train, 600), _collect(p_decode, 600)
    report["concurrent"] = {
        "train": r_train, "decode": r_decode, "overcommit": r_over,
        "ready": ready, "wall_s": round(time.time() - t0, 1),
        "both_tenants_ok": (r_train.get("loss_finite") is True
                            and r_decode.get("tokens_in_vocab") is True
                            and r_train.get("exit_code") == 0
                            and r_decode.get("exit_code") == 0),
        "running_when_overcommit_died": running,
        "overcommit_clean": _refused_oom(r_over),
    }

    # 2. Does the allocator cap stop 10 GiB under a 4 GiB grant?
    t0 = time.time()
    r_run = _collect(_go(waiting["overrun"]), 300)
    report["fraction_cap"] = {"probe": r_run,
                              "runtime_enforced": _refused_oom(r_run),
                              "wall_s": round(time.time() - t0, 1)}

    # 3. Two whole-card tenants each hold 0.6 of the card at once.
    t0 = time.time()
    gib = round(0.6 * card, 2)
    pair = [_go(waiting["isolation_a"]), _go(waiting["isolation_b"])]
    held = [_wait_ready(t, 600) for t in pair]
    _release(*pair)
    r1, r2 = (_collect(t, 300) for t in pair)
    refused = [_refused_oom(r) for r in (r1, r2)]
    resident = [r.get("resident_after_hold") is True for r in (r1, r2)]
    report["isolation"] = {
        "a": r1, "b": r2, "gib_each": gib, "ready": held,
        "exactly_one_refused": sum(refused) == 1 and sum(resident) == 1,
        "wall_s": round(time.time() - t0, 1),
    }

    # 4. The estimator's whole-card prediction, and 2.5x of it.
    t0 = time.time()
    r_fit = _collect(_go(waiting["fit"]), 600)
    r_burst = _collect(_go(waiting["burst"]), 600)
    report["estimator"] = {
        "at_prediction": r_fit, "at_2p5x": r_burst,
        "prediction_fits": (r_fit.get("outcome") == "ran"
                            and r_fit.get("tokens_in_vocab") is True),
        "overshoot_refused": _refused_oom(r_burst),
        "wall_s": round(time.time() - t0, 1),
    }

    # 5. Two 7/16 tenants each hold 85% of the grant and multiply at once.
    t0 = time.time()
    gib = round(0.85 * share, 2)
    pair = [_go(waiting["full_a"]), _go(waiting["full_b"])]
    for t in pair:
        _wait_ready(t, 600)
    _release(*pair)
    r1, r2 = (_collect(t, 600) for t in pair)
    report["full_grant"] = {
        "a": r1, "b": r2, "grant_gib": share, "materialized_gib": gib,
        "both_materialized_85pct": (r1.get("resident_after_hold") is True
                                    and r2.get("resident_after_hold")
                                    is True),
        "wall_s": round(time.time() - t0, 1),
    }

    # 6. The grant watchdog over an uncooperative hog and an innocent
    # ballast, each started in its pod's Allocate env.
    report["heartbeats"] = watchdog_phase(found, usage, watch)


def watchdog_start(spawn, found: Card, usage: str) -> dict:
    """Phase 6's tenants, started ahead of it: the hog and the innocent of
    ``WATCHDOG_PODS`` in the envs of the port's plugin's Allocate
    (``watchdog_allocations``), heartbeating under ``usage``."""
    api, allocs = watchdog_allocations(found, usage)
    return {"api": api, "allocs": allocs,
            "hog": spawn("overrun", 4, 10, 0, alloc=allocs["hog"]),
            "innocent": spawn("ballast", 7, 6, 2, alloc=allocs["innocent"])}


def watchdog_phase(found: Card, usage: str, watch: dict) -> dict:
    """Phase 6: the tenants of :func:`watchdog_start`, let go, swept by
    the port's ``GrantWatchdog`` until both heartbeats are fresh;
    returns the report's ``heartbeats`` section."""
    t0 = time.time()
    api, allocs = watch["api"], watch["allocs"]
    hog, inn = _go(watch["hog"]), _go(watch["innocent"])
    ready = [_wait_ready(t, 600) for t in (hog, inn)]
    wd = watchdog.GrantWatchdog(NODE, api, usage_dir=usage)
    deadline = time.time() + SWEEP_DEADLINE_S
    sweep = wd.sweep()
    while (any(t["used_gib"] is None for t in sweep["tenants"])
           and time.time() < deadline):
        time.sleep(1.0)
        sweep = wd.sweep()
    events.flush(timeout=10)
    seen = [(e["involvedObject"]["name"], e["reason"], e["message"])
            for _, e in api.events]
    beats = {}
    for name, _ in WATCHDOG_PODS:
        try:
            with open(wd.usage_path(f"uid-{name}"),
                      encoding="utf-8") as f:
                beats[f"uid-{name}"] = json.load(f)
        except (OSError, ValueError):
            beats[f"uid-{name}"] = None
    apps = _compute_apps()
    annotations = {name: api.get_pod("default", name).annotations
                   for name, _ in WATCHDOG_PODS}
    _release(hog, inn)
    r_hog, r_inn = _collect(hog, 300), _collect(inn, 300)
    gaps = {}
    for uid, beat in beats.items():
        used = (apps or {}).get(beat["pid"]) if beat else None
        gaps[uid] = ("not visible" if used is None
                     else (used << 20) - beat["bytes_in_use"])
    return {
        "hog": r_hog, "innocent": r_inn, "ready": ready, "beats": beats,
        "grants_gib": {f"uid-{n}": g for n, g in WATCHDOG_PODS},
        "allocation_envs": {n: a.envs for n, a in allocs.items()},
        "nvidia_smi_apps_mib": apps,
        "smi_minus_heartbeat_bytes": gaps,
        "hog_over_grant": bool(beats["uid-hog"])
        and beats["uid-hog"]["bytes_in_use"] > 4 * GIB,
        "innocent_within_grant": bool(beats["uid-innocent"])
        and 0 < beats["uid-innocent"]["bytes_in_use"] <= 7 * GIB,
        "sweep": sweep, "events": [(n, r, m[:160]) for n, r, m in seen],
        "annotations": annotations,
        **watchdog_verdicts(sweep, seen),
        "wall_s": round(time.time() - t0, 1),
    }


def gates(report: dict) -> dict[str, bool]:
    """cochipcheck's gates, the port's watchdog's verdicts on the hog and
    the innocent among them, plus the isolation gate and the 2.5x
    refusal."""
    c, e, h = (report["concurrent"], report["estimator"],
               report["heartbeats"])
    return {
        "both_tenants_ok": c["both_tenants_ok"],
        "running_when_overcommit_died": c["running_when_overcommit_died"],
        "overcommit_clean": c["overcommit_clean"],
        "prediction_fits": e["prediction_fits"],
        "overshoot_refused": e["overshoot_refused"],
        "exactly_one_refused": report["isolation"]["exactly_one_refused"],
        "hog_over_grant": h["hog_over_grant"],
        "innocent_within_grant": h["innocent_within_grant"],
        "overrunner_named": h["overrunner_named"],
        "overrun_event_on_hog": h["overrun_event_on_hog"],
        "innocent_attributed": h["innocent_attributed"],
    }


def _run_tenant(name: str, targs: list[str]) -> int:
    """Run tenant ``name`` once a ``GO`` line comes on its stdin; exit 0
    with no result at end of input instead."""
    if sys.stdin.readline().strip() != GO:
        return 0
    release = threading.Event()

    def watch_stdin():
        sys.stdin.read()          # EOF: the parent released this tenant
        release.set()

    threading.Thread(target=watch_stdin, daemon=True).start()
    fn = {"train": lambda: tenant_train(float(targs[0]), release),
          "decode": lambda: tenant_decode(float(targs[0]), release),
          "overcommit": lambda: tenant_overcommit(float(targs[0])),
          "overrun": lambda: tenant_overrun(float(targs[0]),
                                            bool(int(targs[1])), release),
          "ballast": lambda: tenant_ballast(float(targs[0]), int(targs[1]),
                                            release),
          "estimator": lambda: tenant_estimator(float(targs[0])),
          }[name]
    result = fn()
    print(json.dumps(result), flush=True)
    return 1 if result.get("outcome") == "ALLOCATED" else 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tenant")
    ap.add_argument("--tenant-args", default="")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=os.path.join(REPO, "COTENANCY_gpu.json"))
    args = ap.parse_args()
    if args.tenant:
        return _run_tenant(args.tenant,
                           [a for a in args.tenant_args.split(",") if a])
    if not torch.cuda.is_available():
        print("cogpucheck: torch sees no CUDA device; the co-tenancy check "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    report = run_suite(args.smoke)
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=1)
    c = report["concurrent"]
    print(json.dumps({"cotenancy_ok": report["ok"], "gates": report["gates"],
                      "train_tok_per_s": c["train"].get("tok_per_s"),
                      "decode_tok_per_s": c["decode"].get("decode_tok_per_s"),
                      "fraction_cap_enforced":
                          report["fraction_cap"]["runtime_enforced"],
                      "artifact": args.out}))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
