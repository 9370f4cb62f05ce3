"""On-card smoke run of the PyTorch / CUDA port (``tpushare_torch``).

    python3 chip_smoke.py

Needs one NVIDIA Hopper card (compute capability 9.0) and the CUDA
toolkit. It builds the flash-attention forward kernel from the sources
in this checkout, holds it against its plain PyTorch version, then
drives the flagship LM's forward and serving path through the entry
points a user calls, at full flagship width, under an injected HBM
grant. One line per phase; then a ``kernels`` JSON line, the card's
name and power limit as nvidia-smi gives them, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises and exits
nonzero; so does a host without a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from tpushare_torch import entry as E
from tpushare_torch.runtime import torchenv
from tpushare_torch.workload import flash_attention as FA
from tpushare_torch.workload import model as M
from tpushare_torch.workload import serving as S

#: Kernel vs plain version on the card, rows that see a key:
#: normalized out error (max |diff| / max |plain|) and absolute lse error.
#: fp32 differs only by summation order; bf16 adds the output's rounding.
OUT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LSE_TOL = {"float32": 1e-3, "bfloat16": 2e-2}
#: Prefill / decode logits against the full forward, normalized (bf16).
LOGIT_TOL = 2e-2

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
}
TIMED_SHAPE = "b_long_prompt"
GRANT_GIB = 16


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
    phase("1 device", card=card, torch=torch.__version__,
          cuda=torch.version.cuda, capability=list(cap),
          count=torch.cuda.device_count())

    # 2. Build the kernel from this checkout's sources.
    phase("2 build", flash_fwd_seconds=FA.build_seconds())

    # 3. Kernel against its plain version, on the card.
    errs = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {}
    for name, (b, lq, lk, h, d, qo, ko) in SHAPES.items():
        for dt in (torch.bfloat16, torch.float32):
            dn = str(dt).split(".")[1]
            q, k, v = (torch.randn((b, n, h, d), generator=gen,
                                   device="cuda").to(dt)
                       for n in (lq, lk, lk))
            inputs[name, dn] = (q, k, v, qo, ko)
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
    phase("3 kernel vs plain", **{f"{n}/{d}": e for (n, d), e in errs.items()})

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
    del params, state, cache

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

    # 7. Times at every phase-3 shape; the kernels line reads shape 3(b).
    # The grant's cap has been measured; lift it for the timing harness.
    torch.cuda.set_per_process_memory_fraction(1.0)
    timings = {}
    for (name, dn), (q, k, v, qo, ko) in inputs.items():
        timings[name, dn] = time_shape(q, k, v, qo, ko, dn)
    phase("7 timings", card=card,
          **{f"{n}/{d}": t for (n, d), t in timings.items()})
    main_t = timings[TIMED_SHAPE, "bfloat16"]
    kernel = {
        "name": "flash_fwd",
        "route": "cuda",
        "source": "tpushare_torch/csrc/flash_fwd.cu",
        "replaces": "tpushare/workload/flash_attention.py:61 (_flash_kernel)",
        "launches": launches,
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
    }
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


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


if __name__ == "__main__":
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as tmp:
        code = main(tmp)
    sys.exit(code)
