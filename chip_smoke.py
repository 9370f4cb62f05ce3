"""On-card smoke run of the PyTorch / CUDA port (``tpushare_torch``).

    python3 chip_smoke.py

Needs one NVIDIA Hopper card (compute capability 9.0) and the CUDA
toolkit. It builds the flash-attention kernels (forward, and the dq and
dk/dv backward) from the sources in this checkout, holds each against its
plain PyTorch version, runs ``cogpucheck.py``'s co-tenancy suite (train
and decode tenants as processes under grants carved from the card that
NVIDIA discovery sizes), then drives the flagship LM's forward, serving
(whole, chunked, interleaved and paged admission, the slot and paged
servers) and training paths through the entry points a user calls, at
full flagship width, under an injected HBM grant. One line per phase;
then a ``kernels`` JSON line, the card's name and power limit as
nvidia-smi gives them, and as the last line ``{"ok": true, "device":
{...}}``. Any failure raises and exits nonzero; so does a host without a
CUDA device.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

import cogpucheck
from tpushare_torch import entry as E
from tpushare_torch.deviceplugin import discovery
from tpushare_torch.runtime import torchenv
from tpushare_torch.workload import flash_attention as FA
from tpushare_torch.workload import model as M
from tpushare_torch.workload import paging as P
from tpushare_torch.workload import serving as S
from tpushare_torch.workload import train as T

#: Kernel vs plain version on the card, rows that see a key:
#: normalized out error (max |diff| / max |plain|) and absolute lse error.
#: fp32 differs only by summation order; bf16 adds the output's rounding.
OUT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LSE_TOL = {"float32": 1e-3, "bfloat16": 2e-2}
#: Backward kernels vs their plain version, dq on rows and dk/dv on keys
#: that see something: normalized (max |diff| / max |plain|). fp32 runs
#: the plain version's formulas in fp32 and differs only by summation
#: order; bf16 rounds P and dS to bf16 as operands of the second products
#: on the tensor cores (as the forward rounds P) and the gradients to
#: bf16, each a relative 2**-9 per element.
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: Prefill / decode logits against the full forward, normalized (bf16).
LOGIT_TOL = 2e-2
#: One bf16 train step through the kernels against the same step through
#: plain attention with PyTorch's autograd: relative loss, and normalized
#: error of each parameter's gradient. The two attentions round to bf16
#: at other places (the plain one rounds its probabilities, its backward
#: every intermediate), and the difference propagates through four
#: layers; on the CPU, at tiny width, the JAX package's own bf16
#: gradients differ from its fp32 ones by up to 5.5e-2 normalized
#: (tests/test_torch_train.py), so the bound is that test's 4e-2. On an
#: H100 at flagship width the two steps differ by up to 2.6e-2.
TRAIN_LOSS_TOL = 2e-2
TRAIN_GRAD_TOL = 4e-2

#: Published H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor
#: cores, fp32 outside them, and HBM3 bandwidth.
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

#: Phase-3 shapes: name -> (B, Lq, Lk, H, D, q_offset, kv_offset).
SHAPES = {
    "a_flagship_prefill": (8, 128, 128, 8, 64, 0, 0),
    "b_long_prompt": (1, 2048, 2048, 8, 64, 0, 0),
    "c_large_width": (1, 2048, 2048, 16, 128, 0, 0),
    "d_chunk_offsets": (1, 512, 1024, 8, 64, 512, 0),
    "e_ragged": (1, 200, 200, 8, 64, 0, 0),
    "f_flagship_train": (8, 2048, 2048, 8, 64, 0, 0),
    # Phase 5c's last chunked-prefill piece of a 1024-token prompt.
    "g_chunk_piece": (1, 64, 1024, 8, 64, 960, 0),
}
#: More shapes for phase 3b's backward check: a last Q block of two rows
#: (Lq = 130, both head dims), a short Q block at an offset past a longer
#: KV (a chunked prefill's tail), and rows that see no key at D = 128.
BWD_EDGE_SHAPES = {
    "lq130_d64": (2, 130, 130, 4, 64, 0, 0),
    "lq130_d128": (2, 130, 130, 4, 128, 0, 0),
    "tail_offset": (1, 77, 300, 4, 64, 223, 0),
    "no_key_d128": (1, 320, 256, 4, 128, 0, 100),
}
TIMED_SHAPE = "b_long_prompt"       # the forward's line: a long prefill
TRAIN_SHAPE = "f_flagship_train"    # the backward's line: one train step
PIECE_SHAPE = "g_chunk_piece"       # the chunked and paged pieces' launch
#: Shapes whose backward check adds a nonzero lse cotangent.
DLSE_SHAPES = ("b_long_prompt", "d_chunk_offsets")
TRAIN_BATCH = (8, 2048)             # cochipcheck's batch, bench_train's L
TRAIN_STEPS = 5
GRANT_GIB = 16
#: Phase 5c: bench_workload.py's serving traffic (bench_decode_continuous,
#: bench_decode_paged): the cache length, the chunk and page size, the
#: prompt mix and the decode steps between interleaved pieces.
SERVE_MAX_LEN = 2048
PIECE = 64
PROMPT_MIX = (32, 64, 128, 128, 256, 512, 768, 1024)
INTERLEAVE_STEPS = 8
#: The paged pool is pages_for_grant(cfg, GRANT_GIB, headroom=0.5): the
#: grant's allocator cap is 0.9 of the slice (14.4 GiB) and the phase
#: holds about 1.2 GiB beside the pool (the gathered views and the decode
#: step's fp32 copies of them), so the default 0.8 (a 12.7 GiB pool)
#: would leave the cap almost no room.
PAGED_HEADROOM = 0.5
#: The density arithmetic of bench_decode_paged: its grant and decode
#: budget a stream.
DENSITY_GRANT_GIB, DENSITY_NEW_TOKENS = 8.0, 256


def phase(name: str, **fields) -> None:
    print(f"[{name}] " + json.dumps(fields, sort_keys=True), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(usage_dir: str) -> int:
    # 0. Grant: inject the device plugin's env before anything touches CUDA.
    try:
        total_mib = int(nvidia_smi("memory.total").split()[0])
    except (OSError, subprocess.SubprocessError) as exc:
        print(f"chip_smoke: no NVIDIA card ({exc})", file=sys.stderr)
        return 2
    usage_file = os.path.join(usage_dir, "usage.json")
    os.environ.update({
        "TPUSHARE_CHIP_IDX": "0",
        "TPUSHARE_HBM_POD_GIB": str(GRANT_GIB),
        "TPUSHARE_HBM_CHIP_GIB": str(total_mib // 1024),
        "TPUSHARE_USAGE_FILE": usage_file,
    })
    grant = torchenv.configure()
    phase("0 grant", chip_ids=list(grant.chip_ids),
          hbm_pod_gib=grant.hbm_pod_gib, hbm_chip_gib=grant.hbm_chip_gib,
          cuda_visible_devices=os.environ.get("CUDA_VISIBLE_DEVICES"))

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2

    # 1. Device.
    card = nvidia_smi("name,power.limit")
    cap = torch.cuda.get_device_capability(0)
    check(cap == (9, 0), f"needs compute capability (9, 0), got {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # What the device plugin would advertise for this host: as many cards
    # as torch sees, none sized past what nvidia-smi says it holds.
    inv = discovery.discover_host()
    check(inv is not None, "discovery found no NVIDIA card")
    rungs = {name: scan() for name, scan in (
        ("devfs", discovery.devfs_scan), ("sysfs", discovery.sysfs_scan),
        ("procfs", discovery.procfs_scan), ("env", discovery.env_discover))}
    phase("1 device", card=card, torch=torch.__version__,
          cuda=torch.version.cuda, capability=list(cap),
          count=torch.cuda.device_count(), memory_total_mib=total_mib,
          inventory=dataclasses.asdict(inv),
          rungs={name: r and [r.chip_count, r.tpu_type]
                 for name, r in rungs.items()})
    check(inv.chip_count == torch.cuda.device_count(),
          f"discovery counts {inv.chip_count} cards, torch "
          f"{torch.cuda.device_count()}")
    check(all(0 < c.hbm_gib and c.hbm_gib << 10 <= total_mib
              for c in inv.chips),
          f"discovery sizes {[c.hbm_gib for c in inv.chips]} GiB against "
          f"memory.total {total_mib} MiB")

    # 2. Build the kernels from this checkout's sources, all together.
    phase("2 build", **{f"{name}_seconds": sec
                        for name, sec in FA.build_seconds().items()})

    # 2b. What was built: the Hopper kernels' machine code must hold
    # warpgroup products (HGMMA) and TMA loads (UTMALDG).
    designs = sass_phase()
    phase("2b design", **designs)

    # 2c. Co-tenancy: cogpucheck's suite, once the kernels are built and
    # before phase 3 allocates, so this process holds only its context.
    cotenancy = cotenancy_phase()

    # 3. Kernel against its plain version, on the card.
    errs = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = random_inputs(gen, SHAPES)
    for (name, dn), (q, k, v, qo, ko) in inputs.items():
        lq = q.shape[1]
        with torch.inference_mode():
            out, lse = FA.flash_fwd_kernel(q, k, v, qo, ko)
            torch.cuda.synchronize()
            p_out, p_lse = FA.flash_block_with_lse_plain(q, k, v, qo, ko)
        vis = qo + torch.arange(lq, device="cuda") >= ko
        diff = (out.float() - p_out.float())[:, vis].abs().max().item()
        norm = diff / p_out.float()[:, vis].abs().max().item()
        lse_err = (lse - p_lse)[:, vis].abs().max().item()
        check(bool(torch.isfinite(out.float()).all()),
              f"{name}/{dn}: non-finite output")
        check(norm <= OUT_TOL[dn], f"{name}/{dn}: out error {norm}")
        check(lse_err <= LSE_TOL[dn], f"{name}/{dn}: lse error {lse_err}")
        errs[name, dn] = {"max_abs_err": diff, "norm_err": norm,
                          "lse_err": lse_err}
    no_key = no_key_rows(gen)
    refusals = tma_refusals(inputs["a_flagship_prefill", "bfloat16"][0])
    phase("3 kernel vs plain", tma_refusal=refusals, no_key_rows=no_key,
          **{f"{n}/{d}": e for (n, d), e in errs.items()})

    # 3b. Backward kernels against their plain version, from the forward
    # kernel's out and lse, at the same shapes and inputs and at the edge
    # shapes: within the tolerance on rows and keys that see something, dq
    # exactly 0 on rows that see nothing, the same dq from a second launch.
    bwd_errs = {}
    edge_inputs = random_inputs(gen, BWD_EDGE_SHAPES)
    for (name, dn), (q, k, v, qo, ko) in {**inputs, **edge_inputs}.items():
        b, lq, h, _ = q.shape
        lk = k.shape[1]
        do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
        dlse = (torch.randn((b, lq, h), generator=gen, device="cuda")
                if name in DLSE_SHAPES else None)
        with torch.inference_mode():
            out, lse = FA.flash_fwd_kernel(q, k, v, qo, ko)
            delta = FA.flash_bwd_delta(do, out, dlse)
            got = (FA.flash_bwd_dq_kernel(q, k, v, do, lse, delta, qo, ko),
                   *FA.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, qo, ko))
            dq_again = FA.flash_bwd_dq_kernel(q, k, v, do, lse, delta, qo, ko)
            torch.cuda.synchronize()
            ref = FA.flash_bwd_plain(q, k, v, out, lse, do, dlse, qo, ko)
        rows = qo + torch.arange(lq, device="cuda") >= ko
        keys = ko + torch.arange(lk, device="cuda") <= qo + lq - 1
        check(bool((got[0][:, ~rows] == 0).all()),
              f"{name}/{dn}: dq is not 0 on rows that see no key")
        check(torch.equal(got[0], dq_again), f"{name}/{dn}: two dq launches "
              f"differ")
        e = {"dlse": dlse is not None}
        for gname, g, r, sel in zip(("dq", "dk", "dv"), got, ref,
                                    (rows, keys, keys)):
            g, r = g.float()[:, sel], r.float()[:, sel]
            check(bool(torch.isfinite(g).all()), f"{name}/{dn}: {gname} "
                  f"not finite")
            diff = (g - r).abs().max().item()
            e[f"{gname}_abs_err"] = diff
            e[f"{gname}_norm_err"] = diff / r.abs().max().item()
            check(e[f"{gname}_norm_err"] <= GRAD_TOL[dn],
                  f"{name}/{dn}: {gname} error {e[f'{gname}_norm_err']}")
        bwd_errs[name, dn] = e
    # No atomics: a second launch on the same inputs gives the same bits.
    q, k, v, qo, ko = inputs[TRAIN_SHAPE, "bfloat16"]
    do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    with torch.inference_mode():
        out, lse = FA.flash_fwd_kernel(q, k, v, qo, ko)
        delta = FA.flash_bwd_delta(do, out, None)
        runs = [(FA.flash_bwd_dq_kernel(q, k, v, do, lse, delta),
                 *FA.flash_bwd_dkv_kernel(q, k, v, do, lse, delta))
                for _ in range(2)]
    bitwise = all(torch.equal(a, b) for a, b in zip(*runs))
    check(bitwise, "two backward launches gave different gradients")
    # The autograd Function on the card, through both outputs, with the
    # stride-0 cotangents that sum() hands back.
    q, k, v, qo, ko = inputs["a_flagship_prefill", "float32"]
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    out, lse = FA.flash_block_with_lse(*qkv)
    (out.sum() + lse.sum()).backward()
    ref = FA.flash_bwd_plain(q, k, v, out.detach(), lse.detach(),
                             torch.ones_like(q), torch.ones_like(lse))
    fn_err = max(((t.grad - r).abs().max() / r.abs().max()).item()
                 for t, r in zip(qkv, ref))
    check(fn_err <= GRAD_TOL["float32"], f"autograd Function error {fn_err}")
    phase("3b backward kernels vs plain", bitwise_repeat=bitwise,
          function_grad_err=fn_err,
          **{f"{n}/{d}": e for (n, d), e in bwd_errs.items()})
    del runs, out, lse, delta, do, qkv, ref, edge_inputs, got, dq_again, g, r

    # 4. Forward through the entry point; from here the launches count.
    FA.FLASH_FWD_LAUNCHES = 0
    fwd, args = E.entry()
    logits = fwd(*args)
    torch.cuda.synchronize()
    n_layers = E.ENTRY_CONFIG.n_layers
    check(tuple(logits.shape) == (2, 256, 8192), f"logits {logits.shape}")
    check(bool(torch.isfinite(logits).all()), "entry logits not finite")
    check(FA.FLASH_FWD_LAUNCHES == n_layers,
          f"entry launched the kernel {FA.FLASH_FWD_LAUNCHES} times")
    phase("4 forward", logits_shape=list(logits.shape),
          launches=FA.FLASH_FWD_LAUNCHES)
    del fwd, args, logits

    # 5. Serving at flagship width under the grant.
    fraction = torchenv.apply_memory_fraction(grant)
    cfg = M.ModelConfig()
    max_batch = S.max_batch_for_grant(cfg, GRANT_GIB, 2048)
    check(max_batch >= 8, f"max_batch_for_grant {max_batch} < 8")
    params = M.init_params(torch.Generator(device="cuda").manual_seed(0),
                           cfg)
    tgen = torch.Generator(device="cuda").manual_seed(1)

    def tokens(*shape):
        return torch.randint(0, cfg.vocab_size, shape, generator=tgen,
                             device="cuda")

    prefills = 0
    prompt = tokens(8, 128)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = S.generate(params, prompt, cfg, n_new=64, max_len=256,
                     attn_fn=FA.flash_attention)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    prefills += 1
    check(tuple(out.shape) == (8, 192), f"generate shape {out.shape}")
    check(torch.equal(out[:, :128], prompt), "generate lost its prompt")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()), "ids off vocab")

    # The same request again under the profiler: the card's busy share
    # of the wall time (the profiler's own host cost lowers it a little).
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        S.generate(params, prompt, cfg, n_new=64, max_len=256,
                   attn_fn=FA.flash_attention)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    prefills += 1
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    check(busy_us > 0, "the profiler saw no kernel on the card")
    busy_share = busy_us / (prof_s * 1e6)

    ctx = tokens(2, 256)
    cache = S.init_cache(cfg, 2, 384)
    p_logits, cache = S.prefill(params, ctx, cache,
                                attn_fn=FA.flash_attention)
    prefills += 1
    with torch.inference_mode():
        ref = M.forward(params, ctx, cfg)[:, -1]
    p_err = ((p_logits - ref).abs().max() / ref.abs().max()).item()
    nxt = p_logits.argmax(dim=-1)
    d_logits, _ = S.decode_step(params, cache, nxt, 256)
    with torch.inference_mode():
        ref2 = M.forward(params, torch.cat([ctx, nxt[:, None]], 1), cfg)[:, -1]
    d_err = ((d_logits - ref2).abs().max() / ref2.abs().max()).item()
    check(p_err <= LOGIT_TOL, f"prefill logits off forward by {p_err}")
    check(d_err <= LOGIT_TOL, f"decode logits off forward by {d_err}")

    long_prompt = tokens(1, 2048)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    long_out = S.generate(params, long_prompt, cfg, n_new=4, max_len=4096,
                          attn_fn=FA.flash_attention)
    torch.cuda.synchronize()
    long_s = time.perf_counter() - t0
    prefills += 1
    check(tuple(long_out.shape) == (1, 2052), f"long shape {long_out.shape}")

    lengths = (32, 64, 128, 128, 256, 512, 768, 1024)
    state = S.init_server_state(cfg, len(lengths), 2048)
    S.reset_admission_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for slot, n in enumerate(lengths):
        state = S.admit_bucketed(params, state, tokens(n), slot,
                                 attn_fn=FA.flash_attention)
        prefills += 1
    torch.cuda.synchronize()
    admit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    emitted = []
    for _ in range(2):
        state, em = S.serve_chunk(params, state, 64)
        emitted.append(em)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    emitted = torch.cat(emitted)
    check(bool(((emitted == -1) | ((emitted >= 0)
                                   & (emitted < cfg.vocab_size))).all()),
          "slot server emitted ids off vocab")
    check(bool((emitted >= 0).any(dim=0).all()), "an admitted slot is silent")
    launches = FA.FLASH_FWD_LAUNCHES
    check(launches == cfg.n_layers * prefills + n_layers,
          f"{launches} kernel launches for {prefills} prefills")
    phase("5 serving", memory_fraction=fraction, max_batch_16gib=max_batch,
          generate_8x128_64_s=gen_s,
          generate_new_tok_per_s=8 * 64 / gen_s,
          generate_device_busy_share=busy_share,
          prefill_logit_err=p_err, decode_logit_err=d_err,
          generate_2048_4_s=long_s, slot_admits_s=admit_s,
          slot_serve_2x64_s=serve_s,
          slot_tokens=int((emitted >= 0).sum().item()),
          admissions=S.admission_stats(), prefills=prefills,
          launches=launches)
    del state, cache

    # 5c. Chunked, interleaved and paged admission and the paged server,
    # with bench_workload.py's traffic; each path's pieces are the forward
    # kernel at their offsets, counted from 0 per path.
    served = chunked_paged_phase(cfg, params, tokens)
    phase("5c chunked and paged serving", **served)
    del params

    # 5b. Training at flagship width under the grant: the train step a
    # user builds, with its defaults (kernel-backed flash attention, remat).
    train = train_phase(cfg, tokens)
    phase("5b training", **train)

    # 6. Heartbeat, and whether the grant's allocator cap holds.
    snap = torchenv.write_usage()
    with open(usage_file, encoding="utf-8") as f:
        beat = json.load(f)
    check(set(beat) == {"bytes_in_use", "peak_bytes", "bytes_limit",
                        "source", "ts", "pid"}, f"heartbeat keys {set(beat)}")
    check(beat["bytes_in_use"] > 0 and beat == snap, "empty heartbeat")
    cap_bytes = fraction * torch.cuda.get_device_properties(0).total_memory
    try:
        over = torch.empty(int(cap_bytes) + (1 << 30), dtype=torch.uint8,
                           device="cuda")
        enforced = False
        del over
    except torch.cuda.OutOfMemoryError:
        enforced = True
    torch.cuda.empty_cache()
    phase("6 heartbeat", bytes_in_use=beat["bytes_in_use"],
          peak_bytes=beat["peak_bytes"], fraction_enforced=enforced)

    # 7. Times at every phase-3 shape; the kernels line reads shape 3(b)
    # for the forward and 3(f), the train step's, for the backward.
    # The grant's cap has been measured; lift it for the timing harness.
    torch.cuda.set_per_process_memory_fraction(1.0)
    phase("7a training without the cap", **train_steps_uncapped(cfg, tokens))
    timings, bwd_timings = {}, {}
    for (name, dn), (q, k, v, qo, ko) in inputs.items():
        timings[name, dn] = time_shape(q, k, v, qo, ko, dn)
        bwd_timings[name, dn] = time_bwd_shape(q, k, v, qo, ko, dn)
    phase("7 timings", card=card,
          **{f"{n}/{d}": t for (n, d), t in timings.items()})
    phase("7b backward timings", card=card,
          dq_warpgroups=train["dq_launch"]["warpgroups"],
          **{f"{n}/{d}": t for (n, d), t in bwd_timings.items()})
    main_t = timings[TIMED_SHAPE, "bfloat16"]
    piece_t = timings[PIECE_SHAPE, "bfloat16"]
    by_path = {"serving": launches,
               "training": train["launches"]["flash_fwd"],
               **served["launches"],
               **{path: counts["flash_fwd"]
                  for path, counts in cotenancy.items()}}
    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "design": "tma+wgmma",
        "source": "tpushare_torch/csrc/flash_fwd.cu",
        "replaces": "tpushare/workload/flash_attention.py:61 (_flash_kernel)",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
        "max_norm_err": max(e["norm_err"] for e in errs.values()),
        "max_lse_err": max(e["lse_err"] for e in errs.values()),
        "shape": f"{TIMED_SHAPE} bfloat16",
        "ms": main_t["kernel_ms"],
        "kernel_ms": main_t["kernel_ms"],
        "call_ms": main_t["kernel_call_ms"],
        "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"],
        "library_ms": main_t["library_ms"],
        "vs_library": main_t["kernel_ms"] / main_t["library_ms"],
        "train_shape_ms": timings[TRAIN_SHAPE, "bfloat16"]["kernel_ms"],
        "train_shape_library_ms":
            timings[TRAIN_SHAPE, "bfloat16"]["library_ms"],
        "piece_shape": f"{PIECE_SHAPE} bfloat16",
        **{f"piece_{key}": piece_t[key]
           for key in ("kernel_ms", "kernel_call_ms", "plain_ms",
                       "library_ms", "bound_ms", "bound_by")},
    }]
    train_t = bwd_timings[TRAIN_SHAPE, "bfloat16"]
    for kname, line, grads in (("flash_bwd_dq", 217, ("dq",)),
                               ("flash_bwd_dkv", 271, ("dk", "dv"))):
        t = train_t[kname]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "design": "tma+wgmma",
            "source": "tpushare_torch/csrc/flash_bwd.cu",
            "replaces": f"tpushare/workload/flash_attention.py:{line} "
                        f"(_{kname[6:]}_kernel)",
            "launches": train["launches"][kname] + sum(
                counts[kname] for counts in cotenancy.values()),
            "launches_by_path": {"training": train["launches"][kname],
                                 **{path: counts[kname] for path, counts
                                    in cotenancy.items()}},
            "max_abs_err": max(e[f"{g}_abs_err"] for e in bwd_errs.values()
                               for g in grads),
            "max_norm_err": max(e[f"{g}_norm_err"] for e in bwd_errs.values()
                                for g in grads),
            "shape": f"{TRAIN_SHAPE} bfloat16",
            "ms": t["kernel_ms"],
            "kernel_ms": t["kernel_ms"],
            "call_ms": t["call_ms"],
            # One plain call and one library call compute dq, dk and dv.
            "plain_ms": train_t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": train_t["library_ms"],
            "vs_library": t["kernel_ms"] / train_t["library_ms"],
            "pair_ms": train_t["pair_ms"],
            "plain_and_library_compute": "dq, dk and dv in one call",
            **({"launch": train["dq_launch"]} if kname == "flash_bwd_dq"
               else {}),
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def tma_refusals(q: torch.Tensor) -> dict:
    """TMA reads the bf16 tiles: a base off the 16-byte grid (a view one
    element into an allocation shaped like ``q``) is refused by each bf16
    wrapper with ``ValueError``, before any launch. Returns each message."""
    odd = torch.empty(q.numel() + 1, dtype=q.dtype,
                      device="cuda")[1:].view(q.shape)
    stats = torch.zeros(q.shape[:3], device="cuda")     # lse and delta
    calls = {
        "flash_fwd": lambda: FA.flash_fwd_kernel(odd, odd, odd),
        "flash_bwd_dq": lambda: FA.flash_bwd_dq_kernel(odd, odd, odd, odd,
                                                       stats, stats),
        "flash_bwd_dkv": lambda: FA.flash_bwd_dkv_kernel(odd, odd, odd, odd,
                                                         stats, stats),
    }
    refused = {}
    for name, call in calls.items():
        before = _counts()
        try:
            call()
            refused[name] = ""
        except ValueError as exc:
            refused[name] = str(exc)
        check("16-byte aligned" in refused[name] and _counts() == before,
              f"misaligned bf16 input to {name}: {refused[name]!r}")
    return refused


def random_inputs(gen: torch.Generator, shapes: dict) -> dict:
    """q, k, v and the offsets at each shape (B, Lq, Lk, H, D, q_offset,
    kv_offset), in bf16 and in fp32, keyed by (shape name, dtype name)."""
    inputs = {}
    for name, (b, lq, lk, h, d, qo, ko) in shapes.items():
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn((b, n, h, d), generator=gen,
                                   device="cuda").to(dt)
                       for n in (lq, lk, lk))
            inputs[name, str(dt).split(".")[1]] = (q, k, v, qo, ko)
    return inputs


def no_key_rows(gen: torch.Generator) -> dict:
    """A KV block that starts past the first 128 query rows (the shape of
    a ring step): those rows see no key and must give out 0 and lse
    NEG_INF in both dtypes, forward, as the plain version does; out, lse,
    dq, dk and dv hold the phase-3/3b tolerances against the plain
    version on every row and every key."""
    b, lq, lk, h, d, qo, ko = 1, 256, 256, 8, 64, 0, 128
    fields = {}
    for dt in (torch.bfloat16, torch.float32):
        dn = str(dt).split(".")[1]
        q, k, v, do = (torch.randn((b, n, h, d), generator=gen,
                                   device="cuda").to(dt)
                       for n in (lq, lk, lk, lq))
        with torch.inference_mode():
            out, lse = FA.flash_fwd_kernel(q, k, v, qo, ko)
            delta = FA.flash_bwd_delta(do, out, None)
            got = (out, FA.flash_bwd_dq_kernel(q, k, v, do, lse, delta, qo,
                                               ko),
                   *FA.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, qo, ko))
            torch.cuda.synchronize()
            p_out, p_lse = FA.flash_block_with_lse_plain(q, k, v, qo, ko)
            ref = (p_out, *FA.flash_bwd_plain(q, k, v, out, lse, do, None,
                                              qo, ko))
        seen = qo + torch.arange(lq, device="cuda") >= ko
        check(bool((out[:, ~seen] == 0).all())
              and bool((lse[:, ~seen] == FA.NEG_INF).all()),
              f"no-key rows/{dn}: out is not 0 or lse is not NEG_INF")
        lse_err = (lse - p_lse).abs().max().item()
        check(lse_err <= LSE_TOL[dn], f"no-key rows/{dn}: lse error "
                                      f"{lse_err}")
        fields[f"{dn}_lse_err"] = lse_err
        tol = {"out": OUT_TOL[dn], "dq": GRAD_TOL[dn], "dk": GRAD_TOL[dn],
               "dv": GRAD_TOL[dn]}
        for name, g, r in zip(tol, got, ref):
            g, r = g.float(), r.float()
            err = ((g - r).abs().max() / r.abs().max()).item()
            check(err <= tol[name], f"no-key rows/{dn}: {name} error {err}")
            fields[f"{dn}_{name}_norm_err"] = err
    return fields


def cotenancy_phase() -> dict:
    """``cogpucheck.run_suite(smoke=True)`` on this card: prints the card's
    used memory first, then every tenant's line and the phase's seconds;
    fails unless the suite's gates hold and the train and decode tenants
    launched the kernels as their work says (train: every bf16 kernel,
    ``(1 + remat) * n_layers`` forwards and ``n_layers`` of each backward a
    step; decode: ``n_layers`` forwards a ``generate``). Returns each
    tenant's launches, keyed by path."""
    used = nvidia_smi("memory.used")
    t0 = time.perf_counter()
    report = cogpucheck.run_suite(smoke=True)
    seconds = time.perf_counter() - t0
    for section, body in report.items():
        if not isinstance(body, dict):
            continue
        for key, val in body.items():
            if isinstance(val, dict) and "exit_code" in val:
                phase(f"2c co-tenancy {section}/{key}", **val)
    tr, de = report["concurrent"]["train"], report["concurrent"]["decode"]
    phase("2c co-tenancy", seconds=seconds, memory_used_before=used,
          card=report["card"], card_gib=report["card_gib"],
          share_gib=report["share_gib"], gates=report["gates"],
          fraction_cap_enforced=report["fraction_cap"]["runtime_enforced"],
          heartbeat_gaps=report["heartbeats"]["smi_minus_heartbeat_bytes"],
          phase_seconds={k: v["wall_s"] for k, v in report.items()
                         if isinstance(v, dict) and "wall_s" in v})
    check(report["ok"], f"co-tenancy gates: {report['gates']}")
    steps, n = tr["steps"], tr["n_layers"]
    want = {"flash_fwd": steps * (1 + tr["remat"]) * n,
            "flash_bwd_dq": steps * n, "flash_bwd_dkv": steps * n}
    check(tr["launches"] == want, f"train tenant launches {tr['launches']}"
                                  f", want {want}")
    check(de["launches"]["flash_fwd"] == de["n_layers"] * de["generates"]
          and de["launches"]["flash_bwd_dq"] == 0,
          f"decode tenant launches {de['launches']} for {de['generates']} "
          f"generates")
    return {"cotenancy_train": tr["launches"],
            "cotenancy_decode": de["launches"]}


def _kernel_name(mangled: str) -> str:
    """``flash_fwd_bf16_sm90<64,2>`` from a mangled kernel name."""
    m = re.search(r"\d(flash_[a-z0-9_]+?)I((?:Li\d+E)+)E", mangled)
    if not m:
        return mangled
    return f"{m.group(1)}<{','.join(re.findall(r'Li(\d+)E', m.group(2)))}>"


def sass_phase() -> dict:
    """Disassemble each built kernel library (``cuobjdump``): per kernel,
    registers, static shared memory, local memory (spills) and whether its
    machine code holds HGMMA (wgmma) and UTMALDG (TMA load) instructions.
    Fails unless every ``*_sm90`` kernel holds both and spills nothing, and
    each library has one."""
    tool = os.path.join(os.path.dirname(FA._nvcc()), "cuobjdump")
    fields = {}
    for name in FA._ENTRIES:
        lib = str(FA._lib_path(name))
        sass = subprocess.run([tool, "--dump-sass", lib], capture_output=True,
                              text=True, check=True, timeout=300).stdout
        usage = subprocess.run([tool, "--dump-resource-usage", lib],
                               capture_output=True, text=True, check=True,
                               timeout=300).stdout
        kernels = {}
        for chunk in sass.split("Function : ")[1:]:
            fn = chunk.split(None, 1)[0]
            kernels[_kernel_name(fn)] = {
                "hgmma": "HGMMA" in chunk, "utmaldg": "UTMALDG" in chunk}
        for fn, res in re.findall(r"Function (\S+):\s*\n\s*(REG:.*)", usage):
            entry = kernels.setdefault(_kernel_name(fn), {})
            for key, val in re.findall(r"(REG|SHARED|LOCAL|STACK):(\d+)",
                                       res):
                entry[key.lower()] = int(val)
        hopper = {k: v for k, v in kernels.items() if "_sm90<" in k}
        check(bool(hopper), f"{name}: no sm90 kernel in {lib}")
        for kname, info in hopper.items():
            check(info.get("hgmma") and info.get("utmaldg"),
                  f"{kname}: HGMMA/UTMALDG missing from its SASS: {info}")
            check(info.get("local") == 0, f"{kname}: local memory {info}")
        fields[name] = kernels
    return fields


def _counts() -> dict:
    return {"flash_fwd": FA.FLASH_FWD_LAUNCHES,
            "flash_bwd_dq": FA.FLASH_BWD_DQ_LAUNCHES,
            "flash_bwd_dkv": FA.FLASH_BWD_DKV_LAUNCHES}


def dq_launch(prof) -> dict:
    """The bf16 dq kernel's launch in a finished profiler run, as its trace
    records it: the block shape, registers a thread, and the consumer
    warpgroups the block holds (128 threads each beside the producer
    warp's 32)."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke-trace-") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
    for e in events:
        if (e.get("cat") == "kernel"
                and "flash_bwd_dq_bf16_sm90" in e.get("name", "")):
            block = e["args"]["block"]
            return {"block": block,
                    "registers": e["args"].get("registers per thread"),
                    "warpgroups": (math.prod(block) - 32) // 128}
    raise RuntimeError("no bf16 dq launch in the profiler's trace: "
                       f"{collections.Counter(e.get('cat') for e in events)}")


def _synced_s(fn) -> float:
    """Host seconds of ``fn()``, synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _clone_state(state: dict) -> dict:
    return {"cache": [{kv: t.clone() for kv, t in layer.items()}
                      for layer in state["cache"]],
            **{key: state[key].clone() for key in ("pos", "active", "token")}}


def _norm_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


def chunked_paged_phase(cfg: M.ModelConfig, params, tokens) -> dict:
    """Phase 5c at flagship width in bf16, bench_workload.py's traffic.

    (a) The 1024-token prompt admitted whole (``admit_bucketed`` through
    the kernel) and chunked (``admit_chunked``, 16 pieces of 64): the last
    layer's K/V agree within the bf16 tolerance, and the chunked admission
    launched the kernel ``n_layers`` times a piece. (b) With 7 slots of the
    mix decoding, ``admit_interleaved`` puts the 1024-token prompt into
    slot 7, 8 decode steps after each piece: the co-tenants emit what the
    same chunks emit with no admission, bit for bit. (c) The paged server
    at 16 slots (the mix twice, one tenant, so the second 8 share prefix
    pages) on a pool sized by ``pages_for_grant``: two 64-step chunks emit
    bit for bit what a contiguous 16-slot server admitted by
    ``admit_chunked`` emits, slot i + 8 what slot i does, and releasing
    every slot frees every page. Returns the phase's fields; its
    ``launches`` are the kernel's launches on each path."""
    n = cfg.n_layers
    long_prompt = tokens(PROMPT_MIX[-1])
    pieces = len(long_prompt) // PIECE
    torch.cuda.reset_peak_memory_stats()
    counted = {}

    def count(path: str, fn, want: int):
        torch.cuda.synchronize()
        FA.FLASH_FWD_LAUNCHES = 0
        out = fn()
        torch.cuda.synchronize()
        counted[path] = FA.FLASH_FWD_LAUNCHES
        check(counted[path] == want,
              f"{path}: {counted[path]} kernel launches, want {want}")
        return out

    # (a) Whole against chunked admission.
    st_w = S.init_server_state(cfg, 1, SERVE_MAX_LEN)
    st_c = S.init_server_state(cfg, 1, SERVE_MAX_LEN)
    S.admit_bucketed(params, st_w, long_prompt, 0,
                     attn_fn=FA.flash_attention)
    count("chunked_admit", lambda: S.admit_chunked(
        params, st_c, long_prompt, 0, chunk=PIECE), n * pieces)
    kv_err = max(_norm_err(st_c["cache"][-1][kv][0, :len(long_prompt)],
                           st_w["cache"][-1][kv][0, :len(long_prompt)])
                 for kv in ("k", "v"))
    check(kv_err <= OUT_TOL["bfloat16"],
          f"chunked vs whole admission: last layer K/V error {kv_err}")
    first_agrees = int(st_w["token"][0]) == int(st_c["token"][0])

    # (b) Interleaved admission beside 7 decoding slots. The reference runs
    # the same chunks on a clone with no admission; one 128-step chunk sums
    # the same scores split otherwise between cache and ring, so it agrees
    # only up to rounding (reported, not gated).
    slots = len(PROMPT_MIX)
    st = S.init_server_state(cfg, slots, SERVE_MAX_LEN)
    for slot, length in enumerate(PROMPT_MIX[:-1]):
        S.admit_chunked(params, st, tokens(length), slot, chunk=PIECE)
    ref, one = _clone_state(st), _clone_state(st)
    em_ref = torch.cat([S.serve_chunk(params, ref, INTERLEAVE_STEPS)[1]
                        for _ in range(pieces)])
    _, em_one = S.serve_chunk(params, one, pieces * INTERLEAVE_STEPS)
    del ref, one
    _, em = count("interleaved_admit", lambda: S.admit_interleaved(
        params, st, long_prompt, slots - 1, chunk=PIECE,
        decode_steps=INTERLEAVE_STEPS), n * pieces)
    co = slice(0, slots - 1)
    check(tuple(em.shape) == (pieces * INTERLEAVE_STEPS, slots),
          f"interleaved emitted {tuple(em.shape)}")
    check(torch.equal(em[:, co], em_ref[:, co]),
          "interleaved admission changed a co-tenant's stream")
    check(bool((em[:, -1] == -1).all()), "the admitted slot emitted early")
    check(bool((em[:, co] >= 0).all()), "a co-tenant was silent")
    same_prefill = (int(st["token"][-1]) == int(st_c["token"][0])
                    and all(torch.equal(a[kv][-1, :len(long_prompt)],
                                        b[kv][0, :len(long_prompt)])
                            for a, b in zip(st["cache"], st_c["cache"])
                            for kv in ("k", "v")))
    check(same_prefill, "interleaved and chunked admission of one prompt "
                        "differ")

    # Host times of the two admissions (bench_workload.py's chunked_prefill:
    # the pause a co-tenant sees per piece is the chunked time / pieces),
    # and of a 64-step chunk of the 8-slot contiguous server.
    whole_s = [_synced_s(lambda: S.admit_bucketed(
        params, st_w, long_prompt, 0, attn_fn=FA.flash_attention))
        for _ in range(3)]
    chunked_s = [_synced_s(lambda: S.admit_chunked(
        params, st_c, long_prompt, 0, chunk=PIECE)) for _ in range(3)]
    rows8_s = [_synced_s(lambda: S.serve_chunk(params, st, PIECE))
               for _ in range(3)]
    del st, st_w, st_c

    # (c) The paged server against a contiguous one, 16 slots each.
    prompts = [tokens(length) for length in PROMPT_MIX]
    pslots = 2 * len(prompts)
    total = S.pages_for_grant(cfg, GRANT_GIB, PIECE, headroom=PAGED_HEADROOM)
    pool = P.PagePool(total, page_tokens=PIECE)
    st_p = S.init_paged_state(cfg, pslots, SERVE_MAX_LEN, total, PIECE)
    st_r = S.init_server_state(cfg, pslots, SERVE_MAX_LEN)
    for slot in range(pslots):
        S.admit_chunked(params, st_r, prompts[slot % len(prompts)], slot,
                        chunk=PIECE)
    shareable = sum(P.shareable_pages(len(p), PIECE) for p in prompts)
    paged_pieces = (2 * sum(P.pages_for(len(p), PIECE) for p in prompts)
                    - shareable)

    def paged_path():
        for slot in range(pslots):
            S.admit_paged(params, st_p, pool, prompts[slot % len(prompts)],
                          slot, tenant="tenant-a")
        first = st_p["token"].clone()
        return first, [S.serve_chunk_paged(params, st_p, pool, PIECE)[1]
                       for _ in range(2)]

    first, em_p = count("paged_serving", paged_path, n * paged_pieces)
    check(torch.equal(first, st_r["token"]),
          "paged first tokens differ from the contiguous server's")
    em_r = [S.serve_chunk(params, st_r, PIECE)[1] for _ in range(2)]
    em_p, em_r = torch.cat(em_p), torch.cat(em_r)
    check(torch.equal(em_p, em_r),
          "paged streams differ from the contiguous server's")
    half = len(prompts)
    check(torch.equal(em_p[:, half:], em_p[:, :half]),
          "prefix-shared slots emit other streams than their leaders")
    check(bool((em_p >= 0).all()), "a paged slot was silent")
    stats = pool.stats()
    check(stats["prefixHits"] == shareable,
          f"prefixHits {stats['prefixHits']}, want {shareable}")

    paged16_s = [_synced_s(lambda: S.serve_chunk_paged(params, st_p, pool,
                                                       PIECE))
                 for _ in range(3)]
    rows16_s = [_synced_s(lambda: S.serve_chunk(params, st_r, PIECE))
                for _ in range(3)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_s = _synced_s(lambda: S.serve_chunk_paged(params, st_p, pool,
                                                       PIECE))
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    check(busy_us > 0, "the profiler saw no kernel on the card")
    peak = torch.cuda.max_memory_allocated()
    held = pool.stats()
    for slot in range(pslots):
        S.release_paged(st_p, pool, slot)
    check(pool.pages_free() == total,
          f"{total - pool.pages_free()} pages leaked after release")
    del st_p, st_r

    # bench_decode_paged's density arithmetic at its grant.
    rows_cap = S.max_batch_for_grant(cfg, DENSITY_GRANT_GIB, SERVE_MAX_LEN)
    pages_cap = S.pages_for_grant(cfg, DENSITY_GRANT_GIB, PIECE)
    admitted = used = 0
    while rows_cap:
        need = P.pages_for(min(PROMPT_MIX[admitted % len(PROMPT_MIX)]
                               + DENSITY_NEW_TOKENS, SERVE_MAX_LEN), PIECE)
        if used + need > pages_cap:
            break
        used, admitted = used + need, admitted + 1
    return {
        "launches": {"chunked_serving": counted["chunked_admit"]
                     + counted["interleaved_admit"],
                     "paged_serving": counted["paged_serving"]},
        "launches_by_run": counted,
        "prompt_len": len(long_prompt), "piece": PIECE, "pieces": pieces,
        "chunked_vs_whole_kv_norm_err": kv_err,
        "first_token_agrees": first_agrees,
        "whole_admit_ms": [1e3 * s for s in whole_s],
        "chunked_admit_ms": [1e3 * s for s in chunked_s],
        "max_pause_ms": 1e3 * min(chunked_s) / pieces,
        "interleaved_decode_steps": INTERLEAVE_STEPS,
        "interleaved_cotenant_tokens": int(em[:, co].numel()),
        "one_chunk_equal_tokens": int((em[:, co] == em_one[:, co]).sum()),
        "paged_pool_pages": total,
        "paged_pool_bytes": total * S.cache_hbm_bytes(cfg, 1, PIECE),
        "prefix": held,
        "paged_pieces": paged_pieces,
        "streams_rows": half, "streams_paged": pslots,
        "rows_chunk_ms": [1e3 * s for s in rows8_s],
        "paged_chunk_ms": [1e3 * s for s in paged16_s],
        "rows16_chunk_ms": [1e3 * s for s in rows16_s],
        "per_stream_ratio": min(rows8_s) / min(paged16_s),
        "paged_chunk_busy_share": busy_us / (prof_s * 1e6),
        "peak_bytes": peak,
        "density": {"grant_hbm_gib": DENSITY_GRANT_GIB,
                    "decode_budget": DENSITY_NEW_TOKENS,
                    "whole_row_streams": rows_cap, "pages_total": pages_cap,
                    "paged_streams": admitted,
                    "streams_per_row_stream": (admitted / rows_cap
                                               if rows_cap else None)},
    }


def train_phase(cfg: M.ModelConfig, tokens) -> dict:
    """Drive the flagship train step as a user builds it
    (``train.make_train_step(cfg)``: flash attention on the card, remat
    from the config): a warm-up step, then ``TRAIN_STEPS`` steps on one
    fixed batch with the launch counters set to 0 just before. Then one
    step under the profiler, and the loss and gradients at the same
    weights against plain attention. Returns the phase's fields."""
    init_fn, step, place_batch = T.make_train_step(cfg)
    batch = tokens(*TRAIN_BATCH)
    targets = torch.roll(batch, -1, dims=1)
    params, opt = init_fn(torch.Generator(device="cuda").manual_seed(2),
                          batch)
    batch, targets = place_batch(batch, targets)
    params, opt, warm = step(params, opt, batch, targets)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = cfg.n_layers
    want = {"flash_fwd": (1 + cfg.remat) * n, "flash_bwd_dq": n,
            "flash_bwd_dkv": n}
    FA.FLASH_FWD_LAUNCHES = 0
    FA.FLASH_BWD_DQ_LAUNCHES = 0
    FA.FLASH_BWD_DKV_LAUNCHES = 0
    params, opt, losses, secs, per_step, retries = timed_steps(
        step, params, opt, batch, targets)
    launches = _counts()
    for counts in per_step:
        check(counts == want, f"launches per train step {counts}, "
                              f"want {want}")
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses), f"train losses {losses}")
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    check(peak < GRANT_GIB << 30, f"train step peak {peak} bytes is over "
                                  f"the {GRANT_GIB} GiB grant")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, _ = step(params, opt, batch, targets)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    on_card = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in on_card)
    check(busy_us > 0, "the profiler saw no kernel on the card")
    by_name = collections.Counter()
    for e in on_card:
        by_name[e.name[:80]] += e.time_range.elapsed_us()
    dq = dq_launch(prof)

    # The same weights through plain attention and PyTorch's autograd, on
    # 2 of the batch's rows (the plain attention holds [B, H, L, L]).
    def loss_and_grads(attn_fn):
        opt.zero_grad(set_to_none=True)
        loss = T.loss_fn(params, batch[:2], targets[:2], cfg, attn_fn=attn_fn)
        loss.backward()
        return loss.item(), {name: p.grad.float()
                             for name, p in params.named_parameters()}

    k_loss, k_grads = loss_and_grads(FA.flash_attention)
    p_loss, p_grads = loss_and_grads(M.causal_attention)
    opt.zero_grad(set_to_none=True)
    loss_err = abs(k_loss - p_loss) / abs(p_loss)
    grad_errs = {name: ((k_grads[name] - g).abs().max()
                        / g.abs().max()).item()
                 for name, g in p_grads.items()}
    worst = max(grad_errs, key=grad_errs.get)
    check(loss_err <= TRAIN_LOSS_TOL, f"kernel vs plain loss {loss_err}")
    check(grad_errs[worst] <= TRAIN_GRAD_TOL,
          f"kernel vs plain grad of {worst}: {grad_errs[worst]}")
    mean_s = sum(secs) / len(secs)
    return {
        "batch": list(TRAIN_BATCH), "remat": cfg.remat,
        "warmup_loss": warm.item(), "losses": losses, "step_s": secs,
        "step_s_mean": mean_s,
        "tokens_per_s": TRAIN_BATCH[0] * TRAIN_BATCH[1] / mean_s,
        "launches": launches, "launches_per_step": want,
        "alloc_retries": retries, "profiled_step_s": prof_s,
        "profiled_device_ops": len(on_card),
        "profiled_device_us_top": dict(by_name.most_common(10)),
        "device_busy_share": busy_us / (prof_s * 1e6),
        "profiled_device_ms": busy_us / 1e3,
        "dq_launch": dq,
        "peak_bytes": peak, "grant_bytes": GRANT_GIB << 30,
        "vs_plain_loss_rel_err": loss_err,
        "vs_plain_max_grad_err": grad_errs[worst],
        "vs_plain_worst_leaf": worst,
    }


def timed_steps(step, params, opt, batch, targets, n: int = TRAIN_STEPS):
    """``n`` train steps on one batch, each timed to its end on the card:
    (params, opt, losses, seconds, launches of each step, allocator
    retries, i.e. cached blocks freed to make room under the cap)."""
    losses, secs, per_step = [], [], []
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    for _ in range(n):
        before = _counts()
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, batch, targets)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(loss.item())
        per_step.append({k: c - before[k] for k, c in _counts().items()})
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries
    return params, opt, losses, secs, per_step, retries


def train_steps_uncapped(cfg: M.ModelConfig, tokens) -> dict:
    """Phase 5b's timed steps again with the grant's allocator cap lifted,
    after the counted run: does the cap, rather than the card or the
    host, set the step time?"""
    init_fn, step, _ = T.make_train_step(cfg)
    batch = tokens(*TRAIN_BATCH)
    targets = torch.roll(batch, -1, dims=1)
    params, opt = init_fn(torch.Generator(device="cuda").manual_seed(2),
                          batch)
    params, opt, _ = step(params, opt, batch, targets)
    torch.cuda.synchronize()
    *_, secs, _, retries = timed_steps(step, params, opt, batch, targets)
    mean_s = sum(secs) / len(secs)
    return {"step_s": secs, "step_s_mean": mean_s,
            "tokens_per_s": TRAIN_BATCH[0] * TRAIN_BATCH[1] / mean_s,
            "alloc_retries": retries}


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time per call of ``fn`` over ``iters`` back-to-back calls,
    CUDA events around the run, after ``warmup`` calls. Where the host
    sends calls slower than the card runs them, this is host time."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, reps: int = 20) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph and
    replayed, so the host's per-call cost drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = time_ms(graph.replay, iters=5, warmup=1) / reps
    del graph
    return ms


def time_shape(q, k, v, q_offset: int, kv_offset: int,
               dn: str) -> dict:
    """Device times of the kernel, its plain version and the library
    yardstick on one input, the kernel's eager per-call time, and the
    card's least time for the same work (published peaks)."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    # Visible (query, key) pairs of these offsets: what the work needs.
    seen = (q_offset + torch.arange(lq) - kv_offset + 1).clamp(0, lk)
    pairs = int(seen.sum())
    ops = 4 * b * h * d * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() \
        + 4 * b * lq * h
    t_ops, t_bytes = ops / PEAK_OPS[dn], nbytes / PEAK_BYTES
    mask = (q_offset + torch.arange(lq, device="cuda")[:, None]
            >= kv_offset + torch.arange(lk, device="cuda")[None, :])
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    # Self-attention takes SDPA's causal flag (its flash backend); offset
    # blocks need the explicit mask.
    causal = q_offset == kv_offset and lq == lk
    lib_kw = {"is_causal": True} if causal else {"attn_mask": mask}

    def kernel():
        return FA.flash_fwd_kernel(q, k, v, q_offset, kv_offset)

    def plain():
        return FA.flash_block_with_lse_plain(q, k, v, q_offset, kv_offset)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, **lib_kw)

    with torch.inference_mode():
        return {
            "kernel_ms": device_ms(kernel),
            "kernel_call_ms": time_ms(kernel),
            "plain_ms": device_ms(plain),
            "library_ms": device_ms(library),
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": nbytes,
        }


def library_bwd(q, k, v, do, q_offset: int, kv_offset: int, dn: str):
    """(name, fn): one PyTorch call computing dq, dk and dv of the same
    attention from its own forward's residuals, a yardstick the port never
    calls. Flash attention's backward takes bf16 self-attention (its
    causal flag); memory-efficient attention's takes fp32, and offset
    blocks with the mask as an additive bias."""
    b, lq, h, _ = q.shape
    lk = k.shape[1]
    aten = torch.ops.aten
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    causal = q_offset == kv_offset and lq == lk
    with torch.inference_mode():
        if dn == "bfloat16" and causal:
            out, lse, cq, ck, mq, mk, seed, off, _ = (
                aten._scaled_dot_product_flash_attention(qt, kt, vt, 0.0,
                                                         True))
            return "_scaled_dot_product_flash_attention_backward", (
                lambda: aten._scaled_dot_product_flash_attention_backward(
                    dot, qt, kt, vt, out, lse, cq, ck, mq, mk, 0.0, True,
                    seed, off))
        bias = None
        if not causal:
            mask = (q_offset + torch.arange(lq, device="cuda")[:, None]
                    >= kv_offset + torch.arange(lk, device="cuda")[None, :])
            # Rows of the bias start 16-element aligned, as the kernel wants.
            bias = torch.zeros((lq, -(-lk // 16) * 16), dtype=q.dtype,
                               device="cuda")[:, :lk]
            bias.masked_fill_(~mask, float("-inf"))
            bias = bias.expand(b, h, lq, lk)
        out, lse, seed, off = aten._scaled_dot_product_efficient_attention(
            qt, kt, vt, bias, True, 0.0, causal)
        return "_scaled_dot_product_efficient_attention_backward", (
            lambda: aten._scaled_dot_product_efficient_attention_backward(
                dot, qt, kt, vt, bias, out, lse, seed, off, 0.0,
                [True, True, True, False], causal))


def time_bwd_shape(q, k, v, q_offset: int, kv_offset: int, dn: str) -> dict:
    """Device times of each backward kernel, of the plain version and of
    the library yardstick (each of which computes dq, dk and dv), each
    kernel's eager per-call time, and each kernel's least time on the card
    for its work (published peaks)."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    do = torch.randn(q.shape, generator=torch.Generator(device="cuda")
                     .manual_seed(3), device="cuda").to(q.dtype)
    with torch.inference_mode():
        out, lse = FA.flash_fwd_kernel(q, k, v, q_offset, kv_offset)
        delta = FA.flash_bwd_delta(do, out, None)
    # Visible (query, key) pairs of these offsets: what the work needs.
    seen = (q_offset + torch.arange(lq) - kv_offset + 1).clamp(0, lk)
    pairs = int(seen.sum())
    el, stats = q.element_size(), 2 * 4 * b * lq * h   # lse and delta
    work = {  # ops; bytes: inputs read once, gradients written once
        "flash_bwd_dq": (6 * b * h * d * pairs,
                         (3 * q.numel() + k.numel() + v.numel()) * el
                         + stats),
        "flash_bwd_dkv": (8 * b * h * d * pairs,
                          (2 * q.numel() + 2 * k.numel() + 2 * v.numel())
                          * el + stats),
    }
    fns = {
        "flash_bwd_dq": lambda: FA.flash_bwd_dq_kernel(
            q, k, v, do, lse, delta, q_offset, kv_offset),
        "flash_bwd_dkv": lambda: FA.flash_bwd_dkv_kernel(
            q, k, v, do, lse, delta, q_offset, kv_offset),
    }
    lib_name, library = library_bwd(q, k, v, do, q_offset, kv_offset, dn)
    result = {"library": lib_name}
    with torch.inference_mode():
        for name, fn in fns.items():
            ops, nbytes = work[name]
            t_ops, t_bytes = ops / PEAK_OPS[dn], nbytes / PEAK_BYTES
            result[name] = {
                "kernel_ms": device_ms(fn), "call_ms": time_ms(fn),
                "bound_ms": 1e3 * max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "ops": ops, "bytes": nbytes,
            }
        result["plain_ms"] = device_ms(lambda: FA.flash_bwd_plain(
            q, k, v, out, lse, do, None, q_offset, kv_offset), reps=5)
        result["library_ms"] = device_ms(library)
    result["pair_ms"] = (result["flash_bwd_dq"]["kernel_ms"]
                         + result["flash_bwd_dkv"]["kernel_ms"])
    return result


if __name__ == "__main__":
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as tmp:
        code = main(tmp)
    sys.exit(code)
