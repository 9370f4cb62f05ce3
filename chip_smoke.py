"""On-card smoke run of the PyTorch / CUDA port (``tpushare_torch``).

    python3 chip_smoke.py

Needs one NVIDIA Hopper card (compute capability 9.0) and the CUDA
toolkit. It builds the flash-attention kernels (forward, and the dq and
dk/dv backward) from the sources in this checkout, holds each against its
plain PyTorch version, runs ``cogpucheck.py``'s co-tenancy suite (train
and decode tenants as processes under grants carved from the card that
NVIDIA discovery sizes), then drives the flagship LM's forward, serving
(whole, chunked, interleaved and paged admission, the slot and paged
servers), training and sharded training paths through the entry points a
user calls, at full flagship width, under an injected HBM grant. Sharded
training (phase 5d), the pipelines and ring-MoE (phase 5e), and the
checkpoint lifecycle (phase 5f: an async save, resume on the same and on
another mesh, an unsharded restore that serves, tensor-parallel
serving) run gangs of rank processes on the one card, each under a grant
of its share of the card, their collectives over gloo through the host.
Phase 5g trains the flagship in fp32 (the fp32 kernels, forward and
backward, in split-three TF32 on the tensor cores) against plain
attention; phase 5h runs the reference dry run, ``python -m
tpushare_torch.entry`` at its tiny width (head_dim 16: training in the
reference's bf16, the other parts in fp32) with every part, as a gang on
the card held to the same gang on the host. Phase 3 also holds the bf16
kernels to their plain version at L = 16384 and 32768; phase 8 runs the
sections of ``bench_workload_torch.py`` (attention to L = 32768, flagship
and large training, decode, continuous and paged serving) at the
reference's shapes and prints its JSON document. The entry points the
JAX package jits run as CUDA graphs (``workload.graphs``) from their
second call; phase 9 replays each against its eager body
(``graphs.disabled()``) from the same state, bit for bit, the sampled
ones from generators seeded alike, and counts each kernel's launches in
a profiler trace of the replays against what their captures recorded.
One line per phase;
then a ``kernels`` JSON line, the card's name and power limit as
nvidia-smi gives them, and as the last line ``{"ok": true, "device":
{...}}``. Any failure raises and exits nonzero; so does a host without a
CUDA device.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
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

import bench_workload_torch as BW
import cogpucheck
from tpushare_torch import entry as E
from tpushare_torch.deviceplugin import discovery
from tpushare_torch.runtime import launch, torchenv
from tpushare_torch.workload import checkpoint as CK
from tpushare_torch.workload import flash_attention as FA
from tpushare_torch.workload import graphs
from tpushare_torch.workload import model as M
from tpushare_torch.workload import moe
from tpushare_torch.workload import paging as P
from tpushare_torch.workload import parallel as par
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
#: cores, fp32 outside them (the SIMT units), TF32 tensor cores, and HBM3
#: bandwidth. The fp32 kernels run each product as three TF32 passes
#: (split-three TF32), so their least time counts 3 x ops at the TF32 rate,
#: with the SIMT units' time for the same ops beside it.
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12

#: Phase 2b: kernels each library must hold (the head dims 16, 64 and 128
#: of each dtype; dk/dv's other instances are checked as found).
SASS_KERNELS = {
    "flash_fwd": [f"flash_fwd_{kind}<{d}>" for kind in ("bf16_sm90", "tf32x3")
                  for d in (16, 64, 128)],
    "flash_bwd": ["flash_bwd_dq_bf16_sm90<16>", "flash_bwd_dkv_bf16_sm90<16,1>",
                  *(f"flash_bwd_dq_{kind}<{d}>" for kind in ("bf16_sm90",
                                                             "tf32x3")
                    for d in (16, 64, 128))],
}
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
#: Head dim 16 in both dtypes (the dry run's tiny width, whose train part
#: runs bf16 and the rest fp32): the tiny dry run's block, [2, 16] tokens
#: at 4 heads of 16; a ragged block of 77 queries at offset 223 against
#: 300 keys; and a block of 32 Q and KV tiles, 1 x 2048 at 4 heads of 16.
D16_SHAPES = {
    "tiny_block": (2, 16, 16, 4, 16, 0, 0),
    "tiny_tail_offset": (2, 77, 300, 4, 16, 223, 0),
    "d16_2048": (1, 2048, 2048, 4, 16, 0, 0),
}
#: Phase 7 times bf16 at head dim 16 at these.
D16_TIMED = ("tiny_block", "d16_2048")
#: fp32 alone: 8192 tokens at D = 64 and 128, where the forward and the
#: backward sum 128 tiles into each output row (four times (f)'s), so
#: that the growth of their error with L shows.
F32_SHAPES = {
    "long_8192_d64": (1, 8192, 8192, 4, 64, 0, 0),
    "long_8192_d128": (1, 8192, 8192, 4, 128, 0, 0),
}
#: The bench twin's attention shapes past 2048 tokens, bf16 at head dim
#: 128, as (B, L, H): the kernels run at the whole shape and are held to
#: the plain version, which keeps [B, H, L, L] fp32 scores, on the heads
#: listed (each (b, h) is a row of the kernels' grid of its own).
LONG_SHAPES = {"l2048": (4, 2048, 8), "l8192": (1, 8192, 8),
               "l16384": (1, 16384, 2), "l32768": (1, 32768, 8)}
LONG_HEADS = {"l2048": tuple(range(8)), "l8192": tuple(range(8)),
              "l16384": (0, 1), "l32768": (0, 7)}
TIMED_SHAPE = "b_long_prompt"       # the forward's line: a long prefill
TRAIN_SHAPE = "f_flagship_train"    # the backward's line: one train step
#: The fp32 forward's record: the train step's shape and the wide one.
FP32_FWD_SHAPES = ("f_flagship_train", "c_large_width", "b_long_prompt")
PIECE_SHAPE = "g_chunk_piece"       # the chunked and paged pieces' launch
#: Phases 3 and 3b also hold the kernels to their plain version at the
#: blocks phase 5d's sharded paths hand them (flagship, 8 x 2048 global):
#: a (2, 2, 2) ring rank's [4, 1024] tokens at H = 4 against its own
#: block, (h) a past block, every key visible to every row, and (i) a
#: future block, where every row sees no key; a (1, 1, 4) ring rank's
#: [8, 512] tokens at H = 8 against a past block; a (2, 2, 2) Ulysses
#: rank's whole sequence at its H / sp = 2 heads.
SHARDED_SHAPES = {
    "ring_own": (4, 1024, 1024, 4, 64, 1024, 1024),
    "h_ring_past": (4, 1024, 1024, 4, 64, 1024, 0),
    "i_ring_future": (4, 1024, 1024, 4, 64, 0, 1024),
    "ring_114_past": (8, 512, 512, 8, 64, 512, 0),
    "ulysses_heads": (4, 2048, 2048, 2, 64, 0, 0),
    # Phase 5e's 4D pipe: a (1, 2, 2, 2) rank's microbatch of [1, 1024]
    # tokens at H / tp = 4 heads, against its own, a past and a future
    # block of the sp ring inside its stage.
    "pipe_ring_own": (1, 1024, 1024, 4, 64, 1024, 1024),
    "pipe_ring_past": (1, 1024, 1024, 4, 64, 1024, 0),
    "pipe_ring_future": (1, 1024, 1024, 4, 64, 0, 1024),
    # Phase 5f: a (2, 2, 1) rank's [4, 2048] tokens at H / tp = 4 heads
    # (training, sp = 1), and the tp decode's prefill of its [4, 128]
    # prompts at 4 heads.
    "tp_train_rank": (4, 2048, 2048, 4, 64, 0, 0),
    "tp_prefill": (4, 128, 128, 4, 64, 0, 0),
}
#: Phase 7c times (h) and (i), bf16, forward and backward (with a nonzero
#: lse cotangent, as the ring's merge hands back).
RING_SHAPES = {name: SHARDED_SHAPES[name]
               for name in ("h_ring_past", "i_ring_future")}
#: Shapes whose backward check adds a nonzero lse cotangent: a long
#: prompt, a chunk at an offset, and every ring block, whose backward
#: gets the cotangent ``merge_partials`` returns.
DLSE_SHAPES = ("b_long_prompt", "d_chunk_offsets", "ring_own",
               "h_ring_past", "i_ring_future", "ring_114_past",
               "pipe_ring_own", "pipe_ring_past", "pipe_ring_future",
               "tiny_tail_offset")
TRAIN_BATCH = (8, 2048)             # cochipcheck's batch, bench_train's L
TRAIN_STEPS = 5
GRANT_GIB = 16
#: Phase 5c: bench_workload.py's serving traffic (bench_decode_continuous,
#: bench_decode_paged; the prompt mix is the twin's ``BW.PROMPT_MIX``):
#: the cache length, the chunk and page size and the decode steps between
#: interleaved pieces.
SERVE_MAX_LEN = 2048
PIECE = 64
INTERLEAVE_STEPS = 8
#: The paged pool is pages_for_grant(cfg, GRANT_GIB, headroom=0.5): the
#: grant's allocator cap is 0.9 of the slice (14.4 GiB) and the phase
#: holds about 1.2 GiB beside the pool (the gathered views and the decode
#: step's fp32 copies of them), so the default 0.8 (a 12.7 GiB pool)
#: would leave the cap almost no room.
PAGED_HEADROOM = 0.5
#: Phase 5d: gangs of rank processes on the card, as (ranks, mesh
#: dp,tp,sp, attention strategies); each rank trains its shard of the
#: flagship at phase 5b's global batch, SHARDED_STEPS steps a strategy,
#: under a grant of floor(card GiB / ranks). A gang that is not done by
#: its deadline is killed and fails the phase.
GANGS = ((4, "1,1,4", ("ring",)), (8, "2,2,2", ("ring", "ulysses")))
SHARDED_STEPS = 3
GANG_DEADLINE_S = 480
#: Phase 5e: pipeline and expert parallelism, gangs of (name, ranks,
#: training mesh dp,tp,sp, dry-run parts) at flagship width on phase 5b's
#: batch. P1: the 1F1B pipe on a (2, 1, 1, 2) mesh (the pipe over the
#: training mesh's sp = 2, dp taking the rest), M = 4, attention the
#: kernels, 2 layers a stage, then the GPipe forward over the same stages.
#: P2: the 4D pipe on (1, 2, 2, 2), ring-flash over sp inside the stages,
#: M = 8; then the ring-MoE over the (2, 2, 2) mesh's sp group (E = 4,
#: fp32). PIPE_CALLS calls of each, at the same weights.
PIPE_GANGS = (("P1", 4, "2,1,2", ("dp_pp",)),
              ("P2", 8, "2,2,2", ("4d", "moe")))
PIPE_CALLS = 2
#: Phase 5f: checkpoint, resume and tensor-parallel serving of the
#: flagship at phase 5b's global batch, gangs of CKPT_RANKS ranks over
#: gloo: (a) a (2, 2, 1) gang takes CKPT_STEPS steps with an async save
#: after step CKPT_AT; (b) a fresh (2, 2, 1) gang and (c) a (1, 1, 4) ring
#: gang restore step CKPT_AT and take the steps after it; (d) this process
#: restores the weights unsharded and serves; (e) a (2, 2, 1) gang serves
#: them tensor-parallel, both as the entry's serve part does at flagship
#: width (``entry.serve_setup``: 8 prompts of 128 tokens, 64 new).
CKPT_RANKS, CKPT_STEPS, CKPT_AT = 4, 3, 2
#: The GPipe forward's last-stage hidden states against one process's
#: blocks (bf16, normalized), and the ring-MoE's fp32 output and
#: gradients against ``moe_ffn_reference`` on one process (normalized;
#: the same arithmetic in another order).
GPIPE_TOL = 2e-2
MOE_TOL = 1e-4
#: Phase 5g: the flagship train step in fp32 through the kernels against
#: the same step through plain attention, at the same weights and batch:
#: relative loss and normalized gradients. fp32 on both sides; they differ
#: by summation order and the split-three TF32 products (about 1e-6 a
#: product relative; tests/test_torch_tf32x3.py). FP32_STEPS timed steps.
FP32_LOSS_TOL, FP32_GRAD_TOL = 1e-5, 1e-4
FP32_STEPS = 3
#: Phase 5h: the reference dry run, ``python -m tpushare_torch.entry`` at
#: its default tiny width with every part (both attention strategies), a
#: gang of DRYRUN_RANKS gloo ranks on the card, held to the same gang with
#: ``--device cpu``. The train part is bf16, as the reference's, and held
#: at phase 5b's bounds (the card's kernels round P and dS to bf16 where
#: the host's plain attention rounds elsewhere); the other parts are fp32
#: and held at phase 5g's (losses relative; gradients, the MoE's output,
#: the GPipe's hidden states and the served prefill logits normalized).
DRYRUN_RANKS = 8
DRYRUN_ATTENTION = ("ring", "ulysses")
#: Phase 8: the bench twin's sections at the reference's shapes and, for
#: attention and training, its repetitions; the three serving sections,
#: whose eager steps take most of the twin's time, time BENCH_SERVE_ITERS
#: calls in each of BENCH_SERVE_REPS runs.
BENCH_SERVE_ITERS, BENCH_SERVE_REPS = 3, 1
#: The twin's density arithmetic, as both packages give it: whole-row
#: streams, pages and paged streams under the 8 GiB grant, and the ratio.
BENCH_DENSITY = (406, 12992, 1334, 3.29)


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

    # 3. Kernel against its plain version, on the card: within the
    # tolerance on rows that see a key, out 0 and lse NEG_INF on the rest,
    # as the plain version gives them.
    errs = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = random_inputs(gen, SHAPES)
    sharded_inputs = random_inputs(gen, SHARDED_SHAPES)
    d16_inputs = random_inputs(gen, D16_SHAPES)
    f32_inputs = random_inputs(gen, F32_SHAPES, (torch.float32,))
    for (name, dn), (q, k, v, qo, ko) in {**inputs, **sharded_inputs,
                                          **d16_inputs,
                                          **f32_inputs}.items():
        lq = q.shape[1]
        with torch.inference_mode():
            out, lse = FA.flash_fwd_kernel(q, k, v, qo, ko)
            torch.cuda.synchronize()
            p_out, p_lse = FA.flash_block_with_lse_plain(q, k, v, qo, ko)
        vis = qo + torch.arange(lq, device="cuda") >= ko
        check(bool(torch.isfinite(out.float()).all()),
              f"{name}/{dn}: non-finite output")
        check(bool((out[:, ~vis] == 0).all())
              and bool((lse[:, ~vis] == FA.NEG_INF).all())
              and bool((p_lse[:, ~vis] == FA.NEG_INF).all()),
              f"{name}/{dn}: rows that see no key: out is not 0 or lse is "
              f"not NEG_INF")
        # On a block no row of which sees a key, every row is held to
        # the plain version's zeros.
        sel = vis if bool(vis.any()) else ~vis
        diff = (out.float() - p_out.float())[:, sel].abs().max().item()
        e = {"max_abs_err": diff, "no_key_rows": int((~vis).sum())}
        if bool(vis.any()):
            e["norm_err"] = diff / p_out.float()[:, vis].abs().max().item()
            e["lse_err"] = (lse - p_lse)[:, vis].abs().max().item()
            check(e["norm_err"] <= OUT_TOL[dn],
                  f"{name}/{dn}: out error {e['norm_err']}")
            check(e["lse_err"] <= LSE_TOL[dn],
                  f"{name}/{dn}: lse error {e['lse_err']}")
        else:
            check(diff == 0, f"{name}/{dn}: out {diff} off the plain "
                             f"version's zeros")
        errs[name, dn] = e
    no_key = no_key_rows(gen)
    refusals = tma_refusals(inputs["a_flagship_prefill", "bfloat16"][0],
                            inputs["a_flagship_prefill", "float32"][0])
    phase("3 kernel vs plain", tma_refusal=refusals, no_key_rows=no_key,
          **{f"{n}/{d}": e for (n, d), e in errs.items()})
    long_lengths = long_length_phase(gen)
    phase("3 long lengths", card=card, **long_lengths)

    # 3b. Backward kernels against their plain version, from the forward
    # kernel's out and lse, at the same shapes and inputs and at the edge
    # shapes (and at head dim 16): within the tolerance on rows and
    # keys that see something, dq exactly 0 on rows that see nothing and
    # dk, dv exactly 0 on keys no row sees, the same dq from a second
    # launch.
    bwd_errs = {}
    edge_inputs = random_inputs(gen, BWD_EDGE_SHAPES)
    for (name, dn), (q, k, v, qo, ko) in {**inputs, **sharded_inputs,
                                          **edge_inputs, **d16_inputs,
                                          **f32_inputs}.items():
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
        check(bool((got[1][:, ~keys] == 0).all())
              and bool((got[2][:, ~keys] == 0).all()),
              f"{name}/{dn}: dk or dv is not 0 on keys no row sees")
        check(torch.equal(got[0], dq_again), f"{name}/{dn}: two dq launches "
              f"differ")
        e = {"dlse": dlse is not None}
        for gname, g, r, sel in zip(("dq", "dk", "dv"), got, ref,
                                    (rows, keys, keys)):
            check(bool(torch.isfinite(g).all()), f"{name}/{dn}: {gname} "
                  f"not finite")
            if not bool(sel.any()):
                # Nothing sees anything: the plain version's zeros.
                diff = (g.float() - r.float()).abs().max().item()
                check(diff == 0, f"{name}/{dn}: {gname} {diff} off the "
                                 f"plain version's zeros")
                e[f"{gname}_abs_err"] = diff
                continue
            g, r = g.float()[:, sel], r.float()[:, sel]
            diff = (g - r).abs().max().item()
            e[f"{gname}_abs_err"] = diff
            e[f"{gname}_norm_err"] = diff / r.abs().max().item()
            check(e[f"{gname}_norm_err"] <= GRAD_TOL[dn],
                  f"{name}/{dn}: {gname} error {e[f'{gname}_norm_err']}")
        bwd_errs[name, dn] = e
    # No atomics: a second launch on the same inputs gives the same bits,
    # in both dtypes.
    bitwise = {}
    for dn in ("bfloat16", "float32"):
        q, k, v, qo, ko = inputs[TRAIN_SHAPE, dn]
        do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
        with torch.inference_mode():
            out, lse = FA.flash_fwd_kernel(q, k, v, qo, ko)
            delta = FA.flash_bwd_delta(do, out, None)
            runs = [(FA.flash_bwd_dq_kernel(q, k, v, do, lse, delta),
                     *FA.flash_bwd_dkv_kernel(q, k, v, do, lse, delta))
                    for _ in range(2)]
        bitwise[dn] = all(torch.equal(a, b) for a, b in zip(*runs))
        check(bitwise[dn], f"two {dn} backward launches gave different "
                           f"gradients")
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
    del runs, out, lse, delta, do, qkv, ref, edge_inputs, sharded_inputs
    del f32_inputs, got, dq_again, g, r

    # 4. Forward through the entry point; from here the launches count
    # (replays of compiled steps add what their capture launched).
    FA.FLASH_FWD_LAUNCHES = 0
    graphs.reset_stats()
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
    prof_s, on_card, _ = profiled(lambda: S.generate(
        params, prompt, cfg, n_new=64, max_len=256,
        attn_fn=FA.flash_attention))
    prefills += 1
    busy_share = _busy_us(on_card) / (prof_s * 1e6)

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
          launches=launches, replayed=_replayed())
    replayed = {"serving": _replayed()}
    del state, cache

    # 5c. Chunked, interleaved and paged admission and the paged server,
    # with bench_workload.py's traffic; each path's pieces are the forward
    # kernel at their offsets, counted from 0 per path.
    graphs.reset_stats()
    served = chunked_paged_phase(cfg, params, tokens)
    phase("5c chunked and paged serving", replayed=_replayed(), **served)
    replayed["chunked_paged_serving"] = _replayed()
    del params

    # 5b. Training at flagship width under the grant: the train step a
    # user builds, with its defaults (kernel-backed flash attention, remat).
    train = train_phase(cfg, tokens)
    phase("5b training", **train)
    replayed["training"] = train["replayed"]

    # 5d. Sharded training: gangs of ranks on this card through the entry
    # point's rank body, held to the single-process kernel step.
    ref = single_process_step(cfg)
    sharded = sharded_phase(cfg, inv.chips[0].hbm_gib, ref=ref)
    phase("5d sharded training", card=card, **sharded)

    # 5e. Pipeline and expert parallelism: the 1F1B pipe (and GPipe) with
    # the kernels in every stage, the 4D pipe with ring-flash in the
    # stages, and the ring-MoE, held to the same single-process step.
    piped = pipe_phase(cfg, inv.chips[0].hbm_gib, ref)
    phase("5e pipeline and expert parallelism", card=card, **piped)
    del ref

    # 5f. Checkpoint, resume and tp serving: a gang saves asynchronously,
    # fresh gangs on the same and on another mesh resume from it, one
    # process restores it unsharded and serves, a tp gang serves it.
    lifecycle = checkpoint_phase(cfg, inv.chips[0].hbm_gib)
    phase("5f checkpoint, resume and tp serving", card=card, **lifecycle)

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

    # 5g. The flagship train step in fp32, without the cap as 7a (its
    # plain-attention twin holds [B, H, L, L] fp32 scores): the fp32
    # kernels' full-width path, held to plain attention.
    train32 = fp32_train_phase(tokens)
    phase("5g fp32 flagship training", card=card, **train32)

    # 5h. The reference dry run as a user starts it, tiny width (head_dim
    # 16; training bf16, the other parts fp32), every part, a gang on the
    # card held to the same gang on the host.
    dry = dryrun_phase(inv.chips[0].hbm_gib)
    phase("5h tiny dry run", card=card, **dry)
    timings, bwd_timings = {}, {}
    d16_timed = {(name, dn): x for (name, dn), x in d16_inputs.items()
                 if name in D16_TIMED and dn == "bfloat16"}
    for (name, dn), (q, k, v, qo, ko) in {**inputs, **d16_timed}.items():
        timings[name, dn] = time_shape(q, k, v, qo, ko, dn)
        bwd_timings[name, dn] = time_bwd_shape(q, k, v, qo, ko, dn)
    del d16_inputs
    phase("7 timings", card=card,
          **{f"{n}/{d}": t for (n, d), t in timings.items()})
    phase("7b backward timings", card=card,
          dq_warpgroups=train["dq_launch"]["warpgroups"],
          **{f"{n}/{d}": t for (n, d), t in bwd_timings.items()})
    ring_t = ring_step_timings(gen)
    phase("7c ring-step timings", card=card, **ring_t)

    # 8. The bench twin: bench_workload_torch.py's sections in this process
    # at the reference's shapes, their launches counted from 0 per section.
    bench = bench_phase(card)
    phase("8 bench twin", card=card, **bench)
    replayed.update({f"bench_{section}": counts
                     for section, counts in bench["replayed"].items()})

    # 9. The compiled steps: each captured entry point replayed against its
    # eager body from the same state, at flagship width under the grant.
    compiled = compiled_phase(M.ModelConfig(), grant)
    phase("9 compiled steps", card=card, **compiled)
    replayed["compiled_steps"] = compiled["replayed"]
    main_t = timings[TIMED_SHAPE, "bfloat16"]
    piece_t = timings[PIECE_SHAPE, "bfloat16"]
    by_path = {"serving": launches,
               "training": train["launches"]["flash_fwd"],
               **served["launches"],
               **{path: counts["flash_fwd"]
                  for path, counts in cotenancy.items()},
               **{path: counts["flash_fwd"]
                  for path, counts in sharded["launches"].items()},
               **{path: counts["flash_fwd"]
                  for path, counts in piped["launches"].items()},
               **{path: counts["flash_fwd"]
                  for path, counts in lifecycle["launches"].items()},
               **dryrun_paths(dry, "flash_fwd", train=True),
               **fp32_paths(train32, dry, "flash_fwd"),
               **bench_paths(bench, "flash_fwd")}
    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "design": "tma+wgmma",
        "source": "tpushare_torch/csrc/flash_fwd.cu",
        "replaces": "tpushare/workload/flash_attention.py:61 (_flash_kernel)",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "replay_launches_by_path": {path: counts["flash_fwd"]
                                    for path, counts in replayed.items()},
        "replay_launches_are": REPLAY_LAUNCHES_ARE,
        "traced_replay_launches": {
            path: counts["flash_fwd"]
            for path, counts in compiled["traced_launches"].items()},
        "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
        "max_norm_err": max(e["norm_err"] for e in errs.values()
                            if "norm_err" in e),
        "max_lse_err": max(e["lse_err"] for e in errs.values()
                           if "lse_err" in e),
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
        "ring_shapes": {name: _pick(ring_t[name]["forward"])
                        for name in RING_SHAPES},
        "d16": {f"{name} bfloat16": _times(timings[name, "bfloat16"],
                                           "kernel_call_ms")
                for name in D16_TIMED},
        "d16_launches_by_path": dryrun_paths(dry, "flash_fwd", train=True),
        "fp32": {
            **fp32_record(timings[TRAIN_SHAPE, "float32"],
                          "3xtf32+mma.sync+cp.async",
                          fp32_paths(train32, dry, "flash_fwd"),
                          call_key="kernel_call_ms"),
            "shapes": {name: {**_times(timings[name, "float32"],
                                       "kernel_call_ms"),
                              "simt_bound_ms":
                                  timings[name, "float32"]["simt_bound_ms"]}
                       for name in FP32_FWD_SHAPES},
            "max_norm_err": max(e["norm_err"] for (_, dn), e in errs.items()
                                if dn == "float32" and "norm_err" in e),
            "max_lse_err": max(e["lse_err"] for (_, dn), e in errs.items()
                               if dn == "float32" and "lse_err" in e)},
    }]
    train_t = bwd_timings[TRAIN_SHAPE, "bfloat16"]
    train_t32 = bwd_timings[TRAIN_SHAPE, "float32"]
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
                counts[kname] for counts in [
                    *cotenancy.values(), *sharded["launches"].values(),
                    *piped["launches"].values(),
                    *lifecycle["launches"].values()]) + sum(
                dryrun_paths(dry, kname, train=True).values()) + sum(
                fp32_paths(train32, dry, kname).values()) + sum(
                bench_paths(bench, kname).values()),
            "replay_launches_by_path": {
                path: counts[kname] for path, counts in replayed.items()},
            "replay_launches_are": REPLAY_LAUNCHES_ARE,
            "traced_replay_launches": {
                path: counts[kname]
                for path, counts in compiled["traced_launches"].items()},
            "launches_by_path": {"training": train["launches"][kname],
                                 **{path: counts[kname] for path, counts
                                    in cotenancy.items()},
                                 **{path: counts[kname] for path, counts
                                    in sharded["launches"].items()},
                                 **{path: counts[kname] for path, counts
                                    in piped["launches"].items()},
                                 **{path: counts[kname] for path, counts
                                    in lifecycle["launches"].items()},
                                 **dryrun_paths(dry, kname, train=True),
                                 **fp32_paths(train32, dry, kname),
                                 **bench_paths(bench, kname)},
            "max_abs_err": max(e[f"{g}_abs_err"] for e in bwd_errs.values()
                               for g in grads),
            "max_norm_err": max(e[f"{g}_norm_err"] for e in bwd_errs.values()
                                for g in grads if f"{g}_norm_err" in e),
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
            "ring_shapes": {
                name: {**_pick(ring_t[name]["backward"][kname]),
                       "plain_ms": ring_t[name]["backward"]["plain_ms"],
                       "library_ms": ring_t[name]["backward"]["library_ms"]}
                for name in RING_SHAPES},
            "d16": {f"{name} bfloat16": _times({
                **bwd_timings[name, "bfloat16"][kname],
                "plain_ms": bwd_timings[name, "bfloat16"]["plain_ms"],
                "library_ms": bwd_timings[name, "bfloat16"]["library_ms"]})
                for name in D16_TIMED},
            "d16_launches_by_path": dryrun_paths(dry, kname, train=True),
            "fp32": {
                **fp32_record({**train_t32[kname],
                               "plain_ms": train_t32["plain_ms"],
                               "library_ms": train_t32["library_ms"]},
                              "3xtf32+mma.sync+cp.async",
                              fp32_paths(train32, dry, kname)),
                "pair_ms": train_t32["pair_ms"],
                "max_norm_err": max(
                    e[f"{g}_norm_err"] for (_, dn), e in bwd_errs.items()
                    if dn == "float32" for g in grads
                    if f"{g}_norm_err" in e)},
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def dryrun_paths(dry: dict, kname: str, train: bool) -> dict:
    """A kernel's launches in phase 5h's dry run on the card, by path: its
    train parts (bf16) or its other parts (fp32)."""
    return {f"dryrun_{path}": counts[kname]
            for path, counts in dry["launches"].items()
            if path.startswith("train_") == train}


def fp32_paths(train32: dict, dry: dict, kname: str) -> dict:
    """A kernel's fp32 launches on the main path, by path: phase 5g's
    train steps and the fp32 parts of phase 5h's dry run."""
    return {"training_fp32": train32["launches"][kname],
            **dryrun_paths(dry, kname, train=False)}


def bench_paths(bench: dict, kname: str) -> dict:
    """A kernel's launches in phase 8's bench twin, by section."""
    return {f"bench_{section}": counts[kname]
            for section, counts in bench["launches"].items()
            if counts[kname]}


def fp32_record(t: dict, design: str, by_path: dict,
                call_key: str = "call_ms") -> dict:
    """The kernels line's fp32 record of one kernel at the train shape
    (f): its design, times, both bounds and its launches by path."""
    return {"design": design, "shape": f"{TRAIN_SHAPE} float32",
            **_times(t, call_key), "simt_bound_ms": t["simt_bound_ms"],
            "vs_library": t["kernel_ms"] / t["library_ms"],
            "launches": sum(by_path.values()), "launches_by_path": by_path}


def _times(t: dict, call_key: str = "call_ms") -> dict:
    """A timing's kernel, call, plain and library ms and its bound."""
    return {"kernel_ms": t["kernel_ms"], "call_ms": t[call_key],
            "plain_ms": t["plain_ms"], "library_ms": t["library_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"]}


def tma_refusals(q: torch.Tensor, q32: torch.Tensor) -> dict:
    """TMA reads the bf16 tiles and 16-byte cp.async the fp32 ones: a base
    off the 16-byte grid (a view one element into an allocation shaped
    like ``q``, or ``q32`` in fp32) is refused by each of the six wrappers
    with ``ValueError``, before any launch. Returns each message."""
    odd, odd32 = (torch.empty(t.numel() + 1, dtype=t.dtype,
                              device="cuda")[1:].view(t.shape)
                  for t in (q, q32))
    stats = torch.zeros(q.shape[:3], device="cuda")     # lse and delta
    calls = {
        "flash_fwd": lambda: FA.flash_fwd_kernel(odd, odd, odd),
        "flash_bwd_dq": lambda: FA.flash_bwd_dq_kernel(odd, odd, odd, odd,
                                                       stats, stats),
        "flash_bwd_dkv": lambda: FA.flash_bwd_dkv_kernel(odd, odd, odd, odd,
                                                         stats, stats),
        "fp32_flash_fwd": lambda: FA.flash_fwd_kernel(odd32, odd32, odd32),
        "fp32_flash_bwd_dq": lambda: FA.flash_bwd_dq_kernel(
            odd32, odd32, odd32, odd32, stats, stats),
        "fp32_flash_bwd_dkv": lambda: FA.flash_bwd_dkv_kernel(
            odd32, odd32, odd32, odd32, stats, stats),
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
              f"misaligned input to {name}: {refused[name]!r}")
    return refused


def random_inputs(gen: torch.Generator, shapes: dict,
                  dtypes=(torch.bfloat16, torch.float32)) -> dict:
    """q, k, v and the offsets at each shape (B, Lq, Lk, H, D, q_offset,
    kv_offset), in each of ``dtypes``, keyed by (shape name, dtype
    name)."""
    inputs = {}
    for name, (b, lq, lk, h, d, qo, ko) in shapes.items():
        for dt in dtypes:
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
    machine code holds HGMMA (wgmma) and UTMALDG (TMA load), or HMMA
    (mma.sync) and LDGSTS (cp.async) instructions. Fails unless every
    ``*_sm90`` kernel holds the first two, every fp32 ``*_tf32x3`` kernel
    the last two, each spills nothing, and each library holds the kernels
    of ``SASS_KERNELS``."""
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
                "hgmma": "HGMMA" in chunk, "utmaldg": "UTMALDG" in chunk,
                "hmma": "HMMA" in chunk, "ldgsts": "LDGSTS" in chunk}
        for fn, res in re.findall(r"Function (\S+):\s*\n\s*(REG:.*)", usage):
            entry = kernels.setdefault(_kernel_name(fn), {})
            for key, val in re.findall(r"(REG|SHARED|LOCAL|STACK):(\d+)",
                                       res):
                entry[key.lower()] = int(val)
        missing = set(SASS_KERNELS[name]) - set(kernels)
        check(not missing, f"{name}: {sorted(missing)} not in {lib}")
        hopper = {k: v for k, v in kernels.items() if "_sm90<" in k}
        for kname, info in hopper.items():
            check(info.get("hgmma") and info.get("utmaldg"),
                  f"{kname}: HGMMA/UTMALDG missing from its SASS: {info}")
            check(info.get("local") == 0, f"{kname}: local memory {info}")
        for kname, info in kernels.items():
            if "_tf32x3<" in kname:
                check(info.get("hmma") and info.get("ldgsts")
                      and info.get("local") == 0,
                      f"{kname}: HMMA/LDGSTS missing or local memory: "
                      f"{info}")
        fields[name] = kernels
    return fields


def _counts() -> dict:
    return {"flash_fwd": FA.FLASH_FWD_LAUNCHES,
            "flash_bwd_dq": FA.FLASH_BWD_DQ_LAUNCHES,
            "flash_bwd_dkv": FA.FLASH_BWD_DKV_LAUNCHES}


def _zero_counts() -> None:
    FA.FLASH_FWD_LAUNCHES = 0
    FA.FLASH_BWD_DQ_LAUNCHES = 0
    FA.FLASH_BWD_DKV_LAUNCHES = 0


def _replayed() -> dict:
    """Each kernel's launches inside graph replays since
    ``graphs.reset_stats()``, over every compiled step."""
    out = dict.fromkeys(_counts(), 0)
    for st in graphs.stats().values():
        for kname, counter in zip(out, graphs.COUNTERS):
            out[kname] += st["launches"][counter]
    return out


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


#: Host seconds the profiler's window is held open on each side of the
#: traced call. Without it a trace now and then loses the card's records
#: near the window's end, or all of them, and a count of launches in it
#: comes out short (``tools/trace_drops.py`` counts how often).
TRACE_PAD_S = 0.02


def profiled(fn) -> tuple[float, list, profile]:
    """``fn()`` under the profiler: its host seconds, synchronized on both
    sides, the card's events in it, and the profile. Fails if the
    profiler saw no kernel on the card."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_PAD_S)
        secs = _synced_s(fn)
        time.sleep(TRACE_PAD_S)
    on_card = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    check(sum(e.time_range.elapsed_us() for e in on_card) > 0,
          "the profiler saw no kernel on the card")
    return secs, on_card, prof


def _busy_us(on_card: list) -> float:
    return sum(e.time_range.elapsed_us() for e in on_card)


def _by_name(on_card: list) -> collections.Counter:
    """Device microseconds by kernel name (cut to 80 characters)."""
    by_name = collections.Counter()
    for e in on_card:
        by_name[e.name[:80]] += e.time_range.elapsed_us()
    return by_name


def bench_breakdown(cfg: M.ModelConfig, batch: int) -> dict:
    """One profiled flash train step of the bench twin's shape
    (``make_train_step(cfg, attn_fn=flash_attention)``, ``batch`` x
    ``cfg.max_seq_len``, no allocator cap), after two untimed steps: its
    host ms, the card's busy ms and share, the flash kernels' device ms,
    and the largest device times by kernel name."""
    init_fn, step, _ = T.make_train_step(cfg, attn_fn=FA.flash_attention)
    tokens = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq_len),
                           generator=_dev_gen(0), device="cuda")
    targets = torch.roll(tokens, -1, dims=1)
    params, opt = init_fn(_dev_gen(0), tokens)
    for _ in range(2):
        step(params, opt, tokens, targets)
    secs, on_card, _ = profiled(lambda: step(params, opt, tokens, targets))
    by_name = _by_name(on_card)
    busy = sum(by_name.values())
    return {"host_ms": secs * 1e3, "device_ms": busy / 1e3,
            "busy_share": busy / (secs * 1e6),
            "flash_device_ms": sum(us for name, us in by_name.items()
                                   if "flash_" in name) / 1e3,
            "top_device_us": dict(by_name.most_common(8))}


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
    long_prompt = tokens(BW.PROMPT_MIX[-1])
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
    slots = len(BW.PROMPT_MIX)
    st = S.init_server_state(cfg, slots, SERVE_MAX_LEN)
    for slot, length in enumerate(BW.PROMPT_MIX[:-1]):
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
    prompts = [tokens(length) for length in BW.PROMPT_MIX]
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
    prof_s, on_card, _ = profiled(lambda: S.serve_chunk_paged(
        params, st_p, pool, PIECE))
    busy_us = _busy_us(on_card)
    peak = torch.cuda.max_memory_allocated()
    held = pool.stats()
    for slot in range(pslots):
        S.release_paged(st_p, pool, slot)
    check(pool.pages_free() == total,
          f"{total - pool.pages_free()} pages leaked after release")
    del st_p, st_r
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
        "density": BW.paged_density(),
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
    _zero_counts()
    graphs.reset_stats()
    params, opt, losses, secs, per_step, retries = timed_steps(
        step, params, opt, batch, targets)
    launches = _counts()
    replayed = _replayed()
    for counts in per_step:
        check(counts == want, f"launches per train step {counts}, "
                              f"want {want}")
    peak = torch.cuda.max_memory_allocated()
    peak_reserved = torch.cuda.max_memory_reserved()
    check(all(math.isfinite(x) for x in losses), f"train losses {losses}")
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    check(peak < GRANT_GIB << 30, f"train step peak {peak} bytes is over "
                                  f"the {GRANT_GIB} GiB grant")

    prof_s, on_card, prof = profiled(lambda: step(params, opt, batch,
                                                  targets))
    busy_us = _busy_us(on_card)
    by_name = _by_name(on_card)
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
        "replayed": replayed, "peak_reserved_bytes": peak_reserved,
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


def _dev_gen(seed: int) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(seed)


def single_process_step(cfg: M.ModelConfig) -> dict:
    """Phase 5b's single-process kernel step (``make_train_step(cfg)``) on
    the dry run's weights and 8 x 2048 batch (``entry.dryrun_generator``):
    its loss and gradients, and, from the same weights before the step, the
    hidden states its blocks give the batch (the flash kernel, inference
    mode), which the sharded phases are held to."""
    torch.cuda.empty_cache()
    tokens = torch.randint(0, cfg.vocab_size, TRAIN_BATCH,
                           generator=E.dryrun_generator(1)).cuda()
    init_fn, step, _ = T.make_train_step(cfg)
    params, opt = init_fn(E.dryrun_generator(0), tokens)
    with torch.inference_mode():
        x = params.embed[tokens]
        positions = torch.arange(tokens.shape[1], device="cuda").expand(
            tokens.shape)
        for blk in params.blocks:
            x = M._run_block(blk, x, positions, FA.flash_attention)
    _, _, loss = step(params, opt, tokens, torch.roll(tokens, -1, 1))
    out = {"loss": loss.item(), "hidden": x,
           "grads": {n: p.grad.float() for n, p in params.named_parameters()}}
    del params, opt, tokens
    torch.cuda.empty_cache()
    return out


def sharded_phase(cfg: M.ModelConfig, card_gib: int, gangs=GANGS,
                  backend: str = "gloo", ref: dict | None = None) -> dict:
    """Phase 5d: sharded training of the flagship on this card.

    First the single-process kernel step (:func:`single_process_step`,
    unless ``ref`` holds it). Then each of ``gangs`` through
    ``runtime.launch``: ranks of ``python -m tpushare_torch.entry --parts
    train`` (the rank body ``entry.dryrun_multichip``) with the gang env a
    pod gets, drawing the same weights and batch.
    With ``backend`` gloo every rank runs on card 0 under a grant of
    floor(``card_gib`` / ranks); with nccl (``tools/nccl_gang.py``) rank
    i owns card i whole, with no grant.
    Fails unless, for every mesh and strategy, the first step's loss is
    within ``TRAIN_LOSS_TOL`` relative and every gathered gradient within
    ``TRAIN_GRAD_TOL`` normalized of the single-process step's, ring and
    Ulysses agree within the same bounds on a mesh that runs both, every
    rank's ``SHARDED_STEPS`` losses are finite and the same, and every
    rank launched each kernel as the design says a step: ring
    2·n_layers·sp forwards (remat) and n_layers·sp of each backward,
    Ulysses 2·n_layers and n_layers. Returns the phase's fields;
    ``launches`` sums the counts every rank measured in each of its
    steps, by path. Step times are host
    clocks over collectives that go through the host (gloo), not a
    collective speed."""
    ref = ref or single_process_step(cfg)
    ref_loss = ref["loss"]
    ref = ref["grads"]
    n = cfg.n_layers
    fields = {"single_process_loss": ref_loss, "gangs": {}}
    launches = {"sharded_ring": collections.Counter(),
                "sharded_ulysses": collections.Counter()}
    with tempfile.TemporaryDirectory(prefix="chip_smoke-gang-") as tmp:
        for world, mesh, attentions in gangs:
            sp = int(mesh.split(",")[2])
            save = os.path.join(tmp, f"grads-{mesh}.pt")
            grant = card_gib // world if backend == "gloo" else None
            t0 = time.perf_counter()
            records = launch.launch(
                ["-m", "tpushare_torch.entry", "--mesh", mesh,
                 "--parts", "train", "--attention", *attentions,
                 "--width", "flagship",
                 "--steps", str(SHARDED_STEPS), "--device", "cuda",
                 "--backend", backend, "--save-grads", save], world,
                deadline_s=GANG_DEADLINE_S, grant_gib=grant,
                card_gib=card_gib if grant is not None else None)
            gang_s = time.perf_counter() - t0
            saved = torch.load(save)
            gang = {"ranks": world, "grant_gib": grant, "seconds": gang_s,
                    "backend": records[0]["backend"],
                    "memory_fraction": records[0]["memory_fraction"]}
            for attention in attentions:
                per_rank = [r["paths"][attention] for r in records]
                want = ({"flash_fwd": 2 * n * sp, "flash_bwd_dq": n * sp,
                         "flash_bwd_dkv": n * sp} if attention == "ring" else
                        {"flash_fwd": 2 * n, "flash_bwd_dq": n,
                         "flash_bwd_dkv": n})
                for rank, path in enumerate(per_rank):
                    steps = path["launches_per_step"]
                    check(len(steps) == SHARDED_STEPS,
                          f"{mesh}/{attention} rank {rank} counted "
                          f"{len(steps)} steps, ran {SHARDED_STEPS}")
                    for counts in steps:
                        check(counts == want and min(counts.values()) > 0,
                              f"{mesh}/{attention} rank {rank} launches "
                              f"{counts}, want {want}")
                        launches[f"sharded_{attention}"].update(counts)
                losses = per_rank[0]["losses"]
                check(all(math.isfinite(x) for x in losses),
                      f"{mesh}/{attention} losses {losses}")
                check(all(p["losses"] == losses for p in per_rank),
                      f"{mesh}/{attention}: ranks disagree on the loss")
                got = saved[attention]
                loss_err = abs(got["loss"] - ref_loss) / abs(ref_loss)
                grad_errs = {name: _norm_err(g.cuda(), ref[name])
                             for name, g in got["grads"].items()}
                worst = max(grad_errs, key=grad_errs.get)
                check(loss_err <= TRAIN_LOSS_TOL,
                      f"{mesh}/{attention} loss {got['loss']} vs single "
                      f"process {ref_loss}")
                check(grad_errs[worst] <= TRAIN_GRAD_TOL,
                      f"{mesh}/{attention} grad of {worst}: "
                      f"{grad_errs[worst]}")
                gang[attention] = {
                    "losses": losses, "vs_single_loss_rel_err": loss_err,
                    "vs_single_max_grad_err": grad_errs[worst],
                    "vs_single_worst_leaf": worst,
                    "launches_per_step": want,
                    "step_ms_by_rank": [p["step_ms"] for p in per_rank],
                    "peak_bytes_by_rank": [p["peak_bytes"]
                                           for p in per_rank],
                    "card_used_bytes": max(p["card_used_bytes"]
                                           for p in per_rank),
                }
            if {"ring", "ulysses"} <= set(attentions):
                ring, uly = saved["ring"], saved["ulysses"]
                pair_loss = abs(ring["loss"] - uly["loss"]) / abs(
                    ring["loss"])
                pair_grad = max(_norm_err(uly["grads"][k], g)
                                for k, g in ring["grads"].items())
                check(pair_loss <= TRAIN_LOSS_TOL
                      and pair_grad <= TRAIN_GRAD_TOL,
                      f"ring vs ulysses at {mesh}: loss {pair_loss}, "
                      f"grads {pair_grad}")
                gang.update(ring_vs_ulysses_loss_rel_err=pair_loss,
                            ring_vs_ulysses_max_grad_err=pair_grad)
            fields["gangs"][mesh] = gang
            del saved
    fields.update(launches={k: dict(v) for k, v in launches.items()},
                  step_time_clock=f"host, collectives over {backend}"
                  + (" via host" if backend == "gloo" else ""))
    return fields


def moe_reference(mesh_shape: str) -> dict:
    """The ring-MoE part's function on one process: ``moe_ffn_reference``
    on the part's full params and global tokens (``entry.moe_inputs`` at
    flagship width, E = 2·sp of the gang's training mesh), its output and
    the gradients of mean(y²), fp32."""
    dp, tp, sp = (int(x) for x in mesh_shape.split(","))
    params, x = E.moe_inputs("flagship", par.Mesh(dp, tp, sp, 0, {}),
                             torch.device("cuda"))
    for v in params.values():
        v.requires_grad_()
    y = moe.moe_ffn_reference(params, x)
    y.square().mean().backward()
    return {"y": y.detach(), "grads": {k: v.grad for k, v in params.items()}}


def pipe_phase(cfg: M.ModelConfig, card_gib: int, ref: dict,
               gangs=PIPE_GANGS) -> dict:
    """Phase 5e: pipeline and expert parallelism of the flagship on this
    card. Each of ``gangs`` through ``runtime.launch``: ranks of ``python
    -m tpushare_torch.entry --parts ...`` at flagship width, over gloo,
    under grants of floor(``card_gib`` / ranks), drawing the dry run's
    weights and batch, ``PIPE_CALLS`` calls of each part.

    Fails unless, for each pipe, the first call's loss is within
    ``TRAIN_LOSS_TOL`` relative and every gathered gradient (stages and
    edge) within ``TRAIN_GRAD_TOL`` normalized of the single-process step
    ``ref``; the GPipe forward's last-stage hidden states within
    ``GPIPE_TOL`` of ``ref``'s; the ring-MoE's output and gradients within
    ``MOE_TOL`` of :func:`moe_reference`; every rank's losses finite and
    the same on every call and rank; and every rank launched each kernel
    as designed a call: with k = n_layers / pp layers a stage, M
    microbatches and s = sp under the ring (else 1), the 1F1B step
    2·k·M·s forwards (the F tick and the B tick's recompute) and k·M·s of
    each backward, the GPipe forward k·M·s forwards and nothing else, the
    MoE none. Returns the phase's fields; ``launches`` sums the counts
    every rank measured in each call, by path. Call times are host
    clocks over collectives through the host (gloo)."""
    torch.cuda.empty_cache()
    fields = {"single_process_loss": ref["loss"], "gangs": {}}
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke-pipe-") as tmp:
        for name, world, mesh, parts in gangs:
            save = os.path.join(tmp, f"{name}.pt")
            grant = card_gib // world
            t0 = time.perf_counter()
            records = launch.launch(
                ["-m", "tpushare_torch.entry", "--mesh", mesh, "--parts",
                 *parts, "--width", "flagship", "--steps", str(PIPE_CALLS),
                 "--device", "cuda", "--backend", "gloo", "--save-grads",
                 save], world, deadline_s=GANG_DEADLINE_S, grant_gib=grant,
                card_gib=card_gib)
            gang = {"ranks": world, "training_mesh": mesh, "grant_gib": grant,
                    "seconds": time.perf_counter() - t0,
                    "memory_fraction": records[0]["memory_fraction"]}
            saved = torch.load(save)
            for part in parts:
                per_rank = [r["parts"][part] for r in records]
                losses = per_rank[0]["losses"]
                check(len(losses) == PIPE_CALLS
                      and all(math.isfinite(x) for x in losses)
                      and len(set(losses)) == 1
                      and all(p["losses"] == losses for p in per_rank),
                      f"{name}/{part}: losses by rank "
                      f"{[p['losses'] for p in per_rank]}")
                if part == "moe":
                    gang[part] = moe_part_fields(per_rank, saved["moe"],
                                                 moe_reference(mesh))
                    for p in per_rank:
                        for counts in p["launches_per_call"]:
                            check(not any(counts.values()),
                                  f"{name}/moe launched {counts}")
                    continue
                got = saved[f"pipe_{part}"]
                shape = per_rank[0]["mesh_shape"]
                k = cfg.n_layers // shape["pp"]
                m = per_rank[0]["microbatches"]
                s = shape["sp"] if part == "4d" else 1
                want = {"flash_fwd": 2 * k * m * s, "flash_bwd_dq": k * m * s,
                        "flash_bwd_dkv": k * m * s}
                path = launches.setdefault(f"pipe_1f1b_{part}",
                                           collections.Counter())
                for rank, p in enumerate(per_rank):
                    for counts in p["launches_per_call"]:
                        check(counts == want,
                              f"{name}/{part} rank {rank} launches "
                              f"{counts}, want {want}")
                        path.update(counts)
                loss_err = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
                grad_errs = {n: _norm_err(g.cuda(), ref["grads"][n])
                             for n, g in got["grads"].items()}
                check(set(grad_errs) == set(ref["grads"]),
                      f"{name}/{part}: gradients of {sorted(grad_errs)}")
                worst = max(grad_errs, key=grad_errs.get)
                check(loss_err <= TRAIN_LOSS_TOL,
                      f"{name}/{part} loss {got['loss']} vs single process "
                      f"{ref['loss']}")
                check(grad_errs[worst] <= TRAIN_GRAD_TOL,
                      f"{name}/{part} grad of {worst}: {grad_errs[worst]}")
                fields_part = {
                    "mesh_shape": shape, "microbatches": m,
                    "layers_per_stage": k, "losses": losses,
                    "vs_single_loss_rel_err": loss_err,
                    "vs_single_max_grad_err": grad_errs[worst],
                    "vs_single_worst_leaf": worst,
                    "launches_per_call": want,
                    "stash_peak_by_rank": [p["stash_peak"] for p in per_rank],
                    "call_ms_by_rank": [p["call_ms"] for p in per_rank],
                    "peak_bytes_by_rank": [p["peak_bytes"] for p in per_rank],
                    "card_used_bytes": max(p["card_used_bytes"]
                                           for p in per_rank)}
                if part == "dp_pp":
                    want_g = {"flash_fwd": k * m, "flash_bwd_dq": 0,
                              "flash_bwd_dkv": 0}
                    gpath = launches.setdefault(f"pipe_gpipe_{part}",
                                                collections.Counter())
                    for rank, p in enumerate(per_rank):
                        check(p["gpipe"]["launches"] == want_g,
                              f"{name}/gpipe rank {rank} launches "
                              f"{p['gpipe']['launches']}, want {want_g}")
                        gpath.update(p["gpipe"]["launches"])
                    hidden_err = _norm_err(got["gpipe"].cuda().float(),
                                           ref["hidden"].float())
                    check(hidden_err <= GPIPE_TOL,
                          f"{name}/gpipe hidden states off one process's by "
                          f"{hidden_err}")
                    fields_part["gpipe"] = {
                        "launches_per_call": want_g,
                        "vs_single_hidden_err": hidden_err,
                        "call_ms_by_rank": [p["gpipe"]["call_ms"]
                                            for p in per_rank]}
                gang[part] = fields_part
            fields["gangs"][name] = gang
            del saved
    fields.update(launches={k: dict(v) for k, v in launches.items()},
                  call_time_clock="host, collectives over gloo via host")
    return fields


def _same_weights(got: dict, want: dict) -> bool:
    return set(got) == set(want) and all(torch.equal(got[n], want[n])
                                         for n in want)


def checkpoint_phase(cfg: M.ModelConfig, card_gib: int) -> dict:
    """Phase 5f: the train → checkpoint → restore → serve lifecycle of the
    flagship (bf16, phase 5b's 8 x 2048 global batch, the dry run's
    weights), gangs of ``CKPT_RANKS`` ranks of ``python -m
    tpushare_torch.entry`` over gloo under grants of floor(``card_gib`` /
    ranks), the checkpoint in a temporary directory:

    (a) a (2, 2, 1) gang takes ``CKPT_STEPS`` steps with an async save
        after step ``CKPT_AT`` (``--ckpt-every``), so the next step runs
        while the write drains;
    (b) a fresh (2, 2, 1) gang restores step ``CKPT_AT`` (``--resume``)
        and takes the steps after it: its losses and final weights equal
        (a)'s bit for bit, its restored weights the saved ones;
    (c) a (1, 1, 4) ring gang does the same: restored weights bit for
        bit, the next loss within ``TRAIN_LOSS_TOL`` of (a)'s;
    (d) this process restores the weights unsharded (bit for bit),
        ``generate`` s the serve part's prompts (``entry.serve_setup``,
        8 x (128 + 64)) with the flash prefill, and its prefill logits
        are within
        ``LOGIT_TOL`` of ``forward`` on the restored weights;
    (e) a (2, 2, 1) gang restores the weights tp-sharded and runs the same
        ``generate`` (the entry's ``serve`` part): its prefill logits
        within ``LOGIT_TOL`` of (d)'s, every token in vocab.

    Each leg's launch counters are reset just before it (each step or
    call in a rank), and every rank must launch, a step, 2·L·sp / L·sp /
    L·sp (L = ``n_layers``; sp = 1 in (a) and (b), 4 in (c)), and L
    forwards a prefill in (d) and (e). Returns the phase's fields;
    ``launches`` sums the counts by leg. Host clocks throughout."""
    n = cfg.n_layers
    grant = card_gib // CKPT_RANKS
    fields, launches = {"grant_gib": grant}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke-ckpt-") as tmp:
        ckdir = os.path.join(tmp, "ckpt")

        def gang(leg, mesh, part, *extra):
            save = os.path.join(tmp, f"{leg}.pt")
            t0 = time.perf_counter()
            records = launch.launch(
                ["-m", "tpushare_torch.entry", "--mesh", mesh, "--parts",
                 part, "--width", "flagship", "--steps", str(CKPT_STEPS),
                 "--device", "cuda", "--backend", "gloo", "--save-grads",
                 save, "--ckpt-dir", ckdir, *extra], CKPT_RANKS,
                deadline_s=GANG_DEADLINE_S, grant_gib=grant,
                card_gib=card_gib)
            return records, torch.load(save), time.perf_counter() - t0

        def train_leg(leg, mesh, *extra):
            records, saved, secs = gang(leg, mesh, "train", *extra)
            sp = int(mesh.split(",")[2])
            want = {"flash_fwd": 2 * n * sp, "flash_bwd_dq": n * sp,
                    "flash_bwd_dkv": n * sp}
            path = launches.setdefault(f"checkpoint_{leg}",
                                       collections.Counter())
            per_rank = [r["paths"]["ring"] for r in records]
            losses = per_rank[0]["losses"]
            for rank, p in enumerate(per_rank):
                check(p["losses"] == losses, f"5f({leg}) rank {rank} "
                      f"losses {p['losses']}, rank 0 {losses}")
                for counts in p["launches_per_step"]:
                    check(counts == want, f"5f({leg}) rank {rank} launches "
                          f"{counts}, want {want}")
                    path.update(counts)
            check(all(math.isfinite(x) for x in losses),
                  f"5f({leg}) losses {losses}")
            rec = {"mesh": mesh, "seconds": secs, "steps": per_rank[0][
                "steps"], "losses": losses, "launches_per_step": want,
                "step_ms_by_rank": [p["step_ms"] for p in per_rank],
                "checkpoint_by_rank": [p["checkpoint"] for p in per_rank],
                "peak_bytes_by_rank": [p["peak_bytes"] for p in per_rank]}
            return rec, saved["checkpoint"]

        # (a) Train and save asynchronously after step CKPT_AT.
        a, got_a = train_leg("a", "2,2,1", "--ckpt-every", str(CKPT_AT))
        check(a["steps"] == list(range(1, CKPT_STEPS + 1))
              and all(c["saved_steps"] == [CKPT_AT]
                      for c in a["checkpoint_by_rank"]),
              f"5f(a) saved {a['checkpoint_by_rank']}")
        on_disk = sorted(os.listdir(ckdir))
        check(on_disk == [str(CKPT_AT)], f"5f(a) left {on_disk}")
        saved_w = got_a["weights"][CKPT_AT]
        ck = a["checkpoint_by_rank"]
        a.update(save_blocked_ms=[c["save_blocked_ms"][0] for c in ck],
                 durable_ms=[c["durable_ms"] for c in ck],
                 checkpoint_bytes=ck[0]["bytes"])
        fields["a"] = a

        # (b) Resume on the same mesh: bit for bit.
        b, got_b = train_leg("b", "2,2,1", "--resume")
        check(b["steps"] == list(range(CKPT_AT + 1, CKPT_STEPS + 1)),
              f"5f(b) ran steps {b['steps']}")
        check(_same_weights(got_b["weights"]["restored"], saved_w),
              "5f(b) restored weights differ from the saved ones")
        check(b["losses"] == a["losses"][CKPT_AT:],
              f"5f(b) losses {b['losses']}, uninterrupted "
              f"{a['losses'][CKPT_AT:]}")
        check(_same_weights(got_b["weights"]["final"],
                            got_a["weights"]["final"]),
              "5f(b) final weights differ from the uninterrupted run's")
        b["restore_ms"] = [x["restore_ms"] for x in b["checkpoint_by_rank"]]
        fields["b"] = b

        # (c) Resume on another mesh: a (1, 1, 4) ring.
        c, got_c = train_leg("c", "1,1,4", "--resume")
        check(_same_weights(got_c["weights"]["restored"], saved_w),
              "5f(c) restored weights differ from the saved ones")
        loss_err = abs(c["losses"][0] - a["losses"][CKPT_AT]) / abs(
            a["losses"][CKPT_AT])
        check(loss_err <= TRAIN_LOSS_TOL,
              f"5f(c) loss {c['losses'][0]} vs (a)'s "
              f"{a['losses'][CKPT_AT]}")
        c.update(vs_a_loss_rel_err=loss_err,
                 restore_ms=[x["restore_ms"] for x in c["checkpoint_by_rank"]])
        fields["c"] = c

        # (d) Restore unsharded in this process and serve.
        torch.cuda.empty_cache()
        dev = torch.device("cuda")
        ckptr = CK.Checkpointer(CK.CheckpointConfig(ckdir))
        params = M.init_params(_dev_gen(9), cfg)
        opt = T.make_optimizer()(params.parameters())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, step = ckptr.restore(params, opt)
        torch.cuda.synchronize()
        restore_ms = 1e3 * (time.perf_counter() - t0)
        ckptr.close()
        check(step == CKPT_AT, f"5f(d) restored step {step}")
        check(_same_weights({k: p.detach().cpu() for k, p in
                             params.named_parameters()}, saved_w),
              "5f(d) restored weights differ from the saved ones")
        del opt
        _, shape, n_new, max_len = E.serve_setup("flagship", None)
        prompts = E.serve_prompts(cfg, shape, dev)
        d_launches = launches.setdefault("checkpoint_d_serve",
                                         collections.Counter())
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = S.generate(params, prompts, cfg, n_new, max_len,
                         attn_fn=FA.flash_attention)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        counts = _counts()
        check(counts == {"flash_fwd": n, "flash_bwd_dq": 0,
                         "flash_bwd_dkv": 0},
              f"5f(d) generate launched {counts}")
        d_launches.update(counts)
        check(tuple(out.shape) == (shape[0], max_len)
              and torch.equal(out[:, :shape[1]], prompts)
              and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
              f"5f(d) stream {tuple(out.shape)} lost its prompt or left "
              f"the vocab")
        FA.FLASH_FWD_LAUNCHES = 0
        logits, _ = S.prefill(params, prompts, S.init_cache(
            cfg, shape[0], max_len), attn_fn=FA.flash_attention)
        check(FA.FLASH_FWD_LAUNCHES == n,
              f"5f(d) prefill launched {FA.FLASH_FWD_LAUNCHES}")
        d_launches.update(_counts())
        with torch.inference_mode():
            ref = M.forward(params, prompts, cfg)[:, -1]
        d_err = _norm_err(logits, ref)
        check(d_err <= LOGIT_TOL, f"5f(d) prefill logits off forward by "
                                  f"{d_err}")
        fields["d"] = {"restored_step": step, "restore_ms": restore_ms,
                       "restore_stats": ckptr.last_restore_stats,
                       "generate_s": gen_s,
                       "new_tok_per_s": shape[0] * n_new / gen_s,
                       "prefill_vs_forward_err": d_err,
                       "launches_per_prefill": n}
        del params

        # (e) The tp decode, from the same checkpoint.
        records, got_e, secs = gang("e", "2,2,1", "serve", "--resume")
        e_launches = launches.setdefault("checkpoint_e_serve",
                                         collections.Counter())
        want = {"flash_fwd": n, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
        per_rank = [r["parts"]["serve"] for r in records]
        for rank, p in enumerate(per_rank):
            check(p["launches"] == want, f"5f(e) rank {rank} launched "
                  f"{p['launches']}, want {want}")
            check(p["restored_step"] == CKPT_AT and p["heads_per_rank"] == 4
                  and p["prompt_kept"] and p["in_vocab"]
                  and p["tokens_shape"] == [shape[0], max_len],
                  f"5f(e) rank {rank}: {p}")
            e_launches.update(p["launches"])
        e_err = _norm_err(got_e["serve"]["prefill_logits"].cuda(), logits)
        check(e_err <= LOGIT_TOL, f"5f(e) prefill logits off one "
                                  f"process's by {e_err}")
        agree = (got_e["serve"]["tokens"].cuda() == out).float().mean()
        fields["e"] = {
            "seconds": secs, "vs_single_prefill_err": e_err,
            "stream_agreement_with_d": agree.item(),
            "heads_per_rank": per_rank[0]["heads_per_rank"],
            "launches_per_prefill": want,
            "restore_ms_by_rank": [p["restore_ms"] for p in per_rank],
            "restore_stats_by_rank": [p["restore_stats"]
                                      for p in per_rank],
            "generate_ms_by_rank": [p["generate_ms"] for p in per_rank],
            "new_tok_per_s_by_rank": [p["new_tok_per_s"] for p in per_rank],
            "peak_bytes_by_rank": [p["peak_bytes"] for p in per_rank]}
    fields.update(launches={k: dict(v) for k, v in launches.items()},
                  clock="host, collectives over gloo via host")
    return fields


def moe_part_fields(per_rank: list, got: dict, want: dict) -> dict:
    """Phase 5e's ring-MoE checks: the gathered output and gradients
    against one process's within ``MOE_TOL``."""
    errs = {"y": _norm_err(got["y"].cuda(), want["y"]),
            **{k: _norm_err(g.cuda(), want["grads"][k])
               for k, g in got["grads"].items()}}
    worst = max(errs, key=errs.get)
    check(set(errs) == {"y", "router", "w1", "w2"} and errs[worst] <= MOE_TOL,
          f"ring-MoE {worst} off one process's by {errs[worst]}")
    return {"experts": per_rank[0]["experts"],
            "experts_per_rank": per_rank[0]["experts_per_rank"],
            "tokens_per_rank": per_rank[0]["tokens_per_rank"],
            "losses": per_rank[0]["losses"], "vs_single_errs": errs,
            "call_ms_by_rank": [p["call_ms"] for p in per_rank],
            "peak_bytes_by_rank": [p["peak_bytes"] for p in per_rank],
            "card_used_bytes": max(p["card_used_bytes"] for p in per_rank)}


def fp32_train_phase(tokens) -> dict:
    """Phase 5g: the flagship train step in fp32 (``ModelConfig(dtype=
    torch.float32)``, remat, phase 5b's 8 x 2048 batch) as a user builds
    it, ``make_train_step(cfg)``: a warm-up step, then ``FP32_STEPS``
    steps on one batch with the launch counters set to 0 just before, one
    step under the profiler, and the loss and gradients at the same
    weights against plain attention on the same whole batch. Fails unless
    every step launched the fp32 kernels ``2·n_layers`` / ``n_layers`` /
    ``n_layers`` times, the losses are finite, and the kernels' loss is
    within ``FP32_LOSS_TOL`` relative and every gradient within
    ``FP32_GRAD_TOL`` normalized of plain attention's. Runs without the
    grant's cap (plain attention holds [B, H, L, L] fp32 scores). Returns
    the phase's fields: the step's device ms, the backward pair's and the
    forward's share of it, and peak bytes."""
    cfg = M.ModelConfig(dtype=torch.float32)
    init_fn, step, place_batch = T.make_train_step(cfg)
    batch = tokens(*TRAIN_BATCH)
    targets = torch.roll(batch, -1, dims=1)
    params, opt = init_fn(_dev_gen(2), batch)
    batch, targets = place_batch(batch, targets)
    params, opt, warm = step(params, opt, batch, targets)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = cfg.n_layers
    want = {"flash_fwd": (1 + cfg.remat) * n, "flash_bwd_dq": n,
            "flash_bwd_dkv": n}
    _zero_counts()
    params, opt, losses, secs, per_step, retries = timed_steps(
        step, params, opt, batch, targets, n=FP32_STEPS)
    launches = _counts()
    for counts in per_step:
        check(counts == want, f"launches per fp32 train step {counts}, "
                              f"want {want}")
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses), f"fp32 losses {losses}")

    prof_s, on_card, _ = profiled(lambda: step(params, opt, batch, targets))
    busy_us = _busy_us(on_card)
    pair_us = sum(e.time_range.elapsed_us() for e in on_card
                  if "flash_bwd_" in e.name and "_tf32x3" in e.name)
    fwd_us = sum(e.time_range.elapsed_us() for e in on_card
                 if "flash_fwd_tf32x3" in e.name)
    check(pair_us > 0 and fwd_us > 0,
          "the profiled fp32 step ran no fp32 flash kernel")

    def loss_and_grads(attn_fn):
        opt.zero_grad(set_to_none=True)
        loss = T.loss_fn(params, batch, targets, cfg, attn_fn=attn_fn)
        loss.backward()
        return loss.item(), {name: p.grad.clone()
                             for name, p in params.named_parameters()}

    k_loss, k_grads = loss_and_grads(FA.flash_attention)
    p_loss, p_grads = loss_and_grads(M.causal_attention)
    opt.zero_grad(set_to_none=True)
    loss_err = abs(k_loss - p_loss) / abs(p_loss)
    grad_errs = {name: _norm_err(k_grads[name], g)
                 for name, g in p_grads.items()}
    worst = max(grad_errs, key=grad_errs.get)
    check(loss_err <= FP32_LOSS_TOL, f"fp32 kernel vs plain loss {loss_err}")
    check(grad_errs[worst] <= FP32_GRAD_TOL,
          f"fp32 kernel vs plain grad of {worst}: {grad_errs[worst]}")
    mean_s = sum(secs) / len(secs)
    return {
        "batch": list(TRAIN_BATCH), "remat": cfg.remat,
        "dtype": str(cfg.dtype), "cap": "none (lifted, as 7a)",
        "warmup_loss": warm.item(), "losses": losses, "step_s": secs,
        "step_s_mean": mean_s,
        "tokens_per_s": TRAIN_BATCH[0] * TRAIN_BATCH[1] / mean_s,
        "launches": launches, "launches_per_step": want,
        "alloc_retries": retries, "profiled_step_s": prof_s,
        "profiled_device_ms": busy_us / 1e3,
        "device_busy_share": busy_us / (prof_s * 1e6),
        "bwd_pair_device_ms": pair_us / 1e3,
        "bwd_pair_share": pair_us / busy_us,
        "fwd_device_ms": fwd_us / 1e3, "fwd_share": fwd_us / busy_us,
        "peak_bytes": peak,
        "vs_plain_loss_rel_err": loss_err,
        "vs_plain_max_grad_err": grad_errs[worst],
        "vs_plain_worst_leaf": worst,
    }


def _dryrun_checks(part: str, got: dict, want: dict,
                   loss_tol: float = FP32_LOSS_TOL,
                   tol: float = FP32_GRAD_TOL) -> dict:
    """One saved part of the card's dry run against the host's: losses
    relative (``loss_tol``), every other tensor normalized (``tol``).
    Returns the errors."""
    errs = {}
    if "loss" in want:
        errs["loss_rel_err"] = abs(got["loss"] - want["loss"]) / abs(
            want["loss"])
        check(errs["loss_rel_err"] <= loss_tol,
              f"dry run {part}: loss {got['loss']} on the card, "
              f"{want['loss']} on the host")
    tensors = {**{f"grad/{k}": g for k, g in want.get("grads", {}).items()},
               **{k: want[k] for k in ("y", "gpipe", "prefill_logits")
                  if k in want}}
    got_t = {**{f"grad/{k}": g for k, g in got.get("grads", {}).items()},
             **{k: got[k] for k in ("y", "gpipe", "prefill_logits")
                if k in got}}
    check(set(got_t) == set(tensors) and bool(tensors),
          f"dry run {part}: saved {sorted(got_t)}, want {sorted(tensors)}")
    tensor_errs = {k: _norm_err(got_t[k], w) for k, w in tensors.items()}
    worst = max(tensor_errs, key=tensor_errs.get)
    check(tensor_errs[worst] <= tol,
          f"dry run {part}: {worst} off the host's by {tensor_errs[worst]}")
    errs.update(max_norm_err=tensor_errs[worst], worst=worst)
    if "tokens" in want:
        errs["tokens_equal"] = bool(torch.equal(got["tokens"],
                                                want["tokens"]))
    return errs


def dryrun_phase(card_gib: int) -> dict:
    """Phase 5h: ``python -m tpushare_torch.entry`` as a user runs it, its
    default tiny width (4 heads of 16) and every part (dp x tp x sp
    training with ``DRYRUN_ATTENTION`` in bf16, the ring-MoE, the four
    pipes and the tp decode in fp32), one gang of ``DRYRUN_RANKS`` gloo
    ranks on the card under grants of floor(``card_gib`` / ranks), then
    the same gang with ``--device cpu``. Fails if a part raises, unless
    every part ran in its dtype and every rank launched the kernels as
    designed in every part (training: ring 2·L·sp / L·sp / L·sp with
    remat, Ulysses 2·L / L / L; a pipe 2·k·M·s / k·M·s / k·M·s; the decode
    L forwards a prefill; the MoE none; every attention part some), and
    unless every saved loss, gradient and output of the card's run agrees
    with the host's (:func:`_dryrun_checks`: training at phase 5b's bf16
    bounds, the rest at 5g's). Returns the phase's fields; ``launches``
    sums every rank's counts by path."""
    torch.cuda.empty_cache()
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke-dryrun-") as tmp:
        for device in ("cuda", "cpu"):
            save = os.path.join(tmp, f"{device}.pt")
            grant = card_gib // DRYRUN_RANKS if device == "cuda" else None
            t0 = time.perf_counter()
            records = launch.launch(
                ["-m", "tpushare_torch.entry", "--attention",
                 *DRYRUN_ATTENTION, "--device", device, "--backend", "gloo",
                 "--save-grads", save], DRYRUN_RANKS,
                deadline_s=GANG_DEADLINE_S, grant_gib=grant,
                card_gib=card_gib if grant is not None else None)
            runs[device] = {"records": records, "saved": torch.load(save),
                            "seconds": time.perf_counter() - t0}
    card, host = runs["cuda"], runs["cpu"]
    records = card["records"]
    rec0 = records[0]
    check(all(r["device"].startswith("cuda") for r in records),
          f"card ranks ran on {[r['device'] for r in records]}")
    check(set(card["saved"]) == set(host["saved"]),
          f"card saved {sorted(card['saved'])}, host "
          f"{sorted(host['saved'])}")
    sp = rec0["mesh_shape"]["sp"]
    launches, fields = {}, {}

    def count(path: str, per_rank: list, want: dict) -> None:
        total = launches.setdefault(path, collections.Counter())
        for rank, calls in enumerate(per_rank):
            for counts in calls:
                check(counts == want,
                      f"dry run {path} rank {rank} launches {counts}, "
                      f"want {want}")
                total.update(counts)

    for attention in DRYRUN_ATTENTION:
        n = 2                                   # the tiny config's layers
        s = sp if attention == "ring" else 1
        want = {"flash_fwd": 2 * n * s, "flash_bwd_dq": n * s,
                "flash_bwd_dkv": n * s}
        count(f"train_{attention}",
              [r["paths"][attention]["launches_per_step"] for r in records],
              want)
        dtype = rec0["paths"][attention]["dtype"]
        check(dtype == "torch.bfloat16", f"dry run train_{attention} ran "
                                         f"{dtype}")
        fields[f"train_{attention}"] = {
            "launches_per_step": want, "dtype": dtype,
            "losses": rec0["paths"][attention]["losses"],
            "step_ms_by_rank": [r["paths"][attention]["step_ms"]
                                for r in records],
            **_dryrun_checks(attention, card["saved"][attention],
                             host["saved"][attention], TRAIN_LOSS_TOL,
                             TRAIN_GRAD_TOL)}
    for part in E.PARTS[1:-1]:
        per_rank = [r["parts"][part] for r in records]
        p0 = per_rank[0]
        if part == "moe":
            want = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
        else:
            k, m = p0["layers_per_stage"], p0["microbatches"]
            s = p0["mesh_shape"]["sp"] if part == "4d" else 1
            want = {"flash_fwd": 2 * k * m * s, "flash_bwd_dq": k * m * s,
                    "flash_bwd_dkv": k * m * s}
        count(part, [p["launches_per_call"] for p in per_rank], want)
        check(part == "moe" or p0["dtype"] == "torch.float32",
              f"dry run {part} ran {p0.get('dtype')}")
        key = "moe" if part == "moe" else f"pipe_{part}"
        fields[part] = {"launches_per_call": want,
                        "dtype": p0.get("dtype"), "losses": p0["losses"],
                        "call_ms_by_rank": [p["call_ms"] for p in per_rank],
                        **_dryrun_checks(part, card["saved"][key],
                                         host["saved"][key])}
        if part == "dp_pp":
            count("gpipe", [[p["gpipe"]["launches"]] for p in per_rank],
                  {"flash_fwd": k * m, "flash_bwd_dq": 0,
                   "flash_bwd_dkv": 0})
    serve = [r["parts"]["serve"] for r in records]
    check(serve[0]["dtype"] == "torch.float32",
          f"dry run serve ran {serve[0]['dtype']}")
    n_serve = 2                                 # the decode's layers
    count("serve", [[p["launches"]] for p in serve],
          {"flash_fwd": n_serve, "flash_bwd_dq": 0, "flash_bwd_dkv": 0})
    fields["serve"] = {"dtype": serve[0]["dtype"],
                       "heads_per_rank": serve[0]["heads_per_rank"],
                       "new_tok_per_s_by_rank": [p["new_tok_per_s"]
                                                 for p in serve],
                       **_dryrun_checks("serve", card["saved"]["serve"],
                                        host["saved"]["serve"])}
    check(all(sum(launches[p].values()) > 0 for p in launches
              if p != "moe"), f"an attention part launched no kernel: "
                              f"{launches}")
    return {"ranks": DRYRUN_RANKS, "mesh_shape": rec0["mesh_shape"],
            "batch": rec0["batch"], "grant_gib": card_gib // DRYRUN_RANKS,
            "card_seconds": card["seconds"], "cpu_seconds": host["seconds"],
            "parts": fields,
            "launches": {p: dict(c) for p, c in launches.items()},
            "step_time_clock": "host, collectives over gloo via host"}


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


def bounds(ops: int, nbytes: int, dn: str) -> dict:
    """The card's least time for ``ops`` operations and ``nbytes`` bytes
    (published peaks): bf16 at the tensor cores' rate; fp32 at the rate the
    fp32 kernels run, three TF32 passes an operation on the tensor cores
    (``bound_by`` "3xTF32 ops" where they bound it), with the SIMT units'
    time for the same work beside it (``simt_bound_ms``)."""
    t_bytes = nbytes / PEAK_BYTES
    if dn == "bfloat16":
        t_ops, by = ops / PEAK_OPS[dn], "operations"
    else:
        t_ops, by = 3 * ops / PEAK_TF32, "3xTF32 ops"
    out = {"bound_ms": 1e3 * max(t_ops, t_bytes),
           "bound_by": by if t_ops >= t_bytes else "bytes",
           "ops": ops, "bytes": nbytes}
    if dn == "float32":
        out["simt_bound_ms"] = 1e3 * max(ops / PEAK_OPS[dn], t_bytes)
    return out


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
    # Inputs are read once where a row sees a key; out and lse are written.
    reads = (q.numel() + k.numel() + v.numel()) if pairs else 0
    nbytes = (reads + q.numel()) * q.element_size() + 4 * b * lq * h
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
            **bounds(ops, nbytes, dn),
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


def time_bwd_shape(q, k, v, q_offset: int, kv_offset: int, dn: str,
                   dlse: torch.Tensor | None = None) -> dict:
    """Device times of each backward kernel, of the plain version and of
    the library yardstick (each of which computes dq, dk and dv), each
    kernel's eager per-call time, and each kernel's least time on the card
    for its work (published peaks). ``dlse`` is the lse cotangent folded
    into delta."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    do = torch.randn(q.shape, generator=torch.Generator(device="cuda")
                     .manual_seed(3), device="cuda").to(q.dtype)
    with torch.inference_mode():
        out, lse = FA.flash_fwd_kernel(q, k, v, q_offset, kv_offset)
        delta = FA.flash_bwd_delta(do, out, dlse)
    # Visible (query, key) pairs of these offsets: what the work needs.
    seen = (q_offset + torch.arange(lq) - kv_offset + 1).clamp(0, lk)
    pairs = int(seen.sum())
    el, stats = q.element_size(), 2 * 4 * b * lq * h   # lse and delta
    # ops; bytes: inputs read once (where a row sees a key), gradients
    # written once.
    some = 1 if pairs else 0
    work = {
        "flash_bwd_dq": (6 * b * h * d * pairs,
                         (q.numel() + some * (2 * q.numel() + k.numel()
                                              + v.numel())) * el
                         + some * stats),
        "flash_bwd_dkv": (8 * b * h * d * pairs,
                          (k.numel() + v.numel() + some * (
                              2 * q.numel() + k.numel() + v.numel())) * el
                          + some * stats),
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
            result[name] = {"kernel_ms": device_ms(fn), "call_ms": time_ms(fn),
                            **bounds(*work[name], dn)}
        result["plain_ms"] = device_ms(lambda: FA.flash_bwd_plain(
            q, k, v, out, lse, do, dlse, q_offset, kv_offset), reps=5)
        result["library_ms"] = device_ms(library)
        if dlse is None:
            # The yardstick's own distance from the plain version, beside
            # the kernels' in phase 3b (its outputs are [B, H, L, D]).
            plain = FA.flash_bwd_plain(q, k, v, out, lse, do, None,
                                       q_offset, kv_offset)
            result["library_norm_err"] = {
                g: _norm_err(x.transpose(1, 2), r) for g, x, r in
                zip(("dq", "dk", "dv"), library()[:3], plain)}
    result["pair_ms"] = (result["flash_bwd_dq"]["kernel_ms"]
                         + result["flash_bwd_dkv"]["kernel_ms"])
    return result


def _pick(t: dict) -> dict:
    """A timing's kernel, plain, library and bound fields."""
    return {key: t[key] for key in ("kernel_ms", "plain_ms", "library_ms",
                                    "bound_ms", "bound_by") if key in t}


def long_length_phase(gen: torch.Generator) -> dict:
    """Phase 3 at ``LONG_SHAPES``: the forward, dq and dk/dv kernels at the
    whole shape, held on ``LONG_HEADS`` to the plain version (from the
    kernel's out and lse, as phase 3b) at phase 3's bf16 bounds, and their
    device times at the whole shape beside SDPA's and its backward's, the
    plain version's on one head, and the bounds. Returns the fields."""
    fields = {}
    for name, (b, L, h) in LONG_SHAPES.items():
        d = 128
        q, k, v, do = (torch.randn((b, L, h, d), generator=gen,
                                   device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        with torch.inference_mode():
            out, lse = FA.flash_fwd_kernel(q, k, v)
            delta = FA.flash_bwd_delta(do, out, None)
            dq = FA.flash_bwd_dq_kernel(q, k, v, do, lse, delta)
            dk, dv = FA.flash_bwd_dkv_kernel(q, k, v, do, lse, delta)
            torch.cuda.synchronize()
            for t in (out, lse, dq, dk, dv):
                check(bool(torch.isfinite(t).all()), f"{name}: not finite")
            e = {"shape": [b, L, h, d], "heads_checked": list(LONG_HEADS[name])}
            for hd in LONG_HEADS[name]:
                one = slice(hd, hd + 1)
                qh, kh, vh, doh = (t[:, :, one] for t in (q, k, v, do))
                p_out, p_lse = FA.flash_block_with_lse_plain(qh, kh, vh)
                errs = {"out": _norm_err(out[:, :, one], p_out),
                        "lse": (lse[:, :, one] - p_lse).abs().max().item()}
                ref = FA.flash_bwd_plain(qh, kh, vh, out[:, :, one],
                                         lse[:, :, one], doh)
                del p_out, p_lse
                for gname, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
                    errs[gname] = _norm_err(g[:, :, one], r)
                del ref
                check(errs["out"] <= OUT_TOL["bfloat16"]
                      and errs["lse"] <= LSE_TOL["bfloat16"]
                      and max(errs[g] for g in ("dq", "dk", "dv"))
                      <= GRAD_TOL["bfloat16"],
                      f"{name} head {hd}: kernels off the plain version "
                      f"{errs}")
                for key, err in errs.items():
                    e[f"{key}_err"] = max(e.get(f"{key}_err", 0.0), err)
            torch.cuda.empty_cache()
            pairs = L * (L + 1) // 2 * b * h
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            _, library = library_bwd(q, k, v, do, 0, 0, "bfloat16")
            one = slice(0, 1)
            qh, kh, vh, doh = (t[:, :, one] for t in (q, k, v, do))
            oh, lh = out[:, :, one], lse[:, :, one]
            e["times"] = {
                "flash_fwd": {
                    "kernel_ms": device_ms(lambda: FA.flash_fwd_kernel(
                        q, k, v), reps=5),
                    **bounds(4 * d * pairs, 4 * q.numel() * 2
                             + 4 * b * L * h, "bfloat16")},
                "flash_bwd_dq": {
                    "kernel_ms": device_ms(lambda: FA.flash_bwd_dq_kernel(
                        q, k, v, do, lse, delta), reps=5),
                    **bounds(6 * d * pairs, 5 * q.numel() * 2
                             + 8 * b * L * h, "bfloat16")},
                "flash_bwd_dkv": {
                    "kernel_ms": device_ms(lambda: FA.flash_bwd_dkv_kernel(
                        q, k, v, do, lse, delta), reps=5),
                    **bounds(8 * d * pairs, 6 * q.numel() * 2
                             + 8 * b * L * h, "bfloat16")},
                "library_fwd_ms": device_ms(
                    lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                           is_causal=True),
                    reps=5),
                "library_bwd_ms": device_ms(library, reps=5),
                "plain_fwd_one_head_ms": time_ms(
                    lambda: FA.flash_block_with_lse_plain(qh, kh, vh),
                    iters=2, warmup=1),
                "plain_bwd_one_head_ms": time_ms(
                    lambda: FA.flash_bwd_plain(qh, kh, vh, oh, lh, doh),
                    iters=2, warmup=1),
            }
        fields[name] = e
        del q, k, v, do, out, lse, delta, dq, dk, dv, qt, kt, vt, library
        del qh, kh, vh, doh, oh, lh
        torch.cuda.empty_cache()
    return fields


def _launch_check(section: str, got: dict, want: dict) -> None:
    check(got == want, f"bench {section}: launches {got}, want {want}")


def bench_phase(card: str) -> dict:
    """Phase 8: ``bench_workload_torch``'s sections on this card, through
    its functions, at the reference's shapes (the serving sections at
    ``BENCH_SERVE_ITERS`` x ``BENCH_SERVE_REPS`` timed calls), and its JSON
    document. Fails unless one flash forward + backward launches one
    forward, one dq and one dk/dv and the plain side none; every section
    launched the kernels as designed; the paged streams are the contiguous
    ones bit for bit; the density is ``BENCH_DENSITY``; the card's peak is
    known and every MFU a number; and ``flash_runs_32k`` passed. A failing
    performance gate is printed, not failed (the twin's ``--gate`` is
    opt-in). Also times SDPA's forward + backward through the twin's
    harness at each attention shape, a yardstick beside its flash_ms, and
    the bound of each: 14 x D operations a visible pair at the bf16 peak
    (4 x D forward, 10 x D for a backward that recomputes S once), with
    ``split_bound_ms`` beside it for the 18 x D the three kernels do (dq
    and dk/dv each recompute S and dP); and
    profiles one step of each train shape (:func:`bench_breakdown`)."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    kind = torch.cuda.get_device_name(0)
    power = card.rsplit(",", 1)[-1].strip()
    zero = dict.fromkeys(_counts(), 0)
    per_call = dict.fromkeys(_counts(), 1)

    replayed = {}

    def counted(fn, section: str | None = None):
        torch.cuda.synchronize()
        _zero_counts()
        graphs.reset_stats()
        out = fn()
        torch.cuda.synchronize()
        if section:
            replayed[section] = _replayed()
        return out, _counts()

    q, k, v = BW.attention_inputs(2048, 4, 8, torch.device("cuda"))
    _launch_check("one flash fwd+bwd", counted(
        lambda: float(BW.fwd_bwd(FA.flash_attention)(q, k, v)))[1], per_call)
    _launch_check("one plain fwd+bwd", counted(
        lambda: float(BW.fwd_bwd(M.causal_attention)(q, k, v)))[1], zero)
    del q, k, v
    launches = {}
    attn, launches["attention"] = counted(lambda: BW.bench_attention(False),
                                         "attention")
    calls = sum(BW.WARMUP + 2 * n for *_, n in BW.ATTENTION_SHAPES)
    _launch_check("attention", launches["attention"],
                  dict.fromkeys(zero, calls))

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            *(t.transpose(1, 2) for t in (q, k, v)),
            is_causal=True).transpose(1, 2)

    yardstick = {}
    for L, b, h, n in BW.ATTENTION_SHAPES:
        q, k, v = BW.attention_inputs(L, b, h, torch.device("cuda"))
        ms, counts = counted(lambda: 1e3 * BW._time_scalar_fn(
            BW.fwd_bwd(sdpa), q, k, v, iters=n))
        _launch_check(f"SDPA at {L}", counts, zero)
        d = BW.HEAD_DIM
        pairs = b * h * (L * (L + 1) // 2)
        nbytes = 8 * q.numel() * q.element_size() + 8 * b * L * h
        yardstick[str(L)] = {
            "flash_ms": attn[str(L)]["flash_ms"], "sdpa_ms": ms,
            **bounds(14 * d * pairs, nbytes, "bfloat16"),
            "split_bound_ms": bounds(18 * d * pairs, nbytes,
                                     "bfloat16")["bound_ms"]}
        del q, k, v
    torch.cuda.empty_cache()

    # A side's steps: its loss step, the warm-up and the twin's default
    # (the reference's) 10 x 2 timed steps, 8 x 2 for the large config.
    flagship = M.ModelConfig()
    large_cfg = BW.large_config()
    train, launches["train"] = counted(lambda: BW.bench_train(kind, False),
                                       "train")
    _launch_check("train", launches["train"], dict.fromkeys(
        zero, (1 + BW.WARMUP + 10 * 2) * flagship.n_layers))
    large, launches["train_large"] = counted(lambda: BW.bench_train(
        kind, False, cfg=large_cfg, batch=8, iters=8, sides=("flash",)),
        "train_large")
    _launch_check("train_large", launches["train_large"], dict.fromkeys(
        zero, (1 + BW.WARMUP + 8 * 2) * large_cfg.n_layers))

    serve_kw = {"iters": BENCH_SERVE_ITERS, "reps": BENCH_SERVE_REPS}
    serving, launches["decode"] = counted(
        lambda: BW.bench_decode(False, **serve_kw), "decode")
    _launch_check("decode", launches["decode"], zero)
    continuous, launches["continuous"] = counted(
        lambda: BW.bench_decode_continuous(False, **serve_kw), "continuous")
    pieces = continuous["chunked_prefill"]["pieces"]
    _launch_check("continuous", launches["continuous"],
                  {**zero, "flash_fwd": 2 * pieces * flagship.n_layers})
    paged, launches["paged"] = counted(
        lambda: BW.bench_decode_paged(False, **serve_kw), "paged")
    page = paged["page_tokens"]
    rows_pieces = sum(P.pages_for(n, page) for n in BW.PROMPT_MIX)
    shared = sum(P.shareable_pages(n, page) for n in BW.PROMPT_MIX)
    _launch_check("paged", launches["paged"], {
        **zero, "flash_fwd": (3 * rows_pieces - shared) * flagship.n_layers})

    doc = BW.document(kind, power, attn, train, large, serving, continuous,
                      paged, gated=True)
    check(paged["bit_identical"], "bench paged streams differ from the rows'")
    dens = paged["density"]
    check((dens["whole_row_streams"], dens["pages_total"],
           dens["paged_streams"], dens["streams_per_row_stream"])
          == BENCH_DENSITY, f"bench density {dens}")
    check(doc["peak_bf16_tflops"] is not None, f"no bf16 peak for {kind!r}")
    mfus = [train["xla"]["mfu"], train["flash"]["mfu"], large["flash"]["mfu"]]
    check(all(isinstance(m, float) and math.isfinite(m) for m in mfus),
          f"bench MFU values {mfus}")
    check(doc["gates"]["flash_runs_32k"]["pass"], "flash did not run 32k")
    for L, entry in attn.items():
        check(math.isfinite(entry["flash_ms"]) and (
            entry["xla_ms"] is not None or entry.get("xla_skip_reason")),
              f"bench attention at {L}: {entry}")
    breakdown = {"train": bench_breakdown(dataclasses.replace(
                     flagship, remat=False), 16),
                 "train_large": bench_breakdown(large_cfg, 8)}
    torch.cuda.empty_cache()
    return {"seconds": time.perf_counter() - t0, "launches": launches,
            "replayed": replayed,
            "train_breakdown": breakdown,
            "serve_iters": BENCH_SERVE_ITERS, "serve_reps": BENCH_SERVE_REPS,
            "failed_gates": [g for g, v in doc["gates"].items()
                             if v["gated"] and not v["pass"]],
            "attention_yardstick": yardstick, "document": doc}


def _state_equal(a: dict, b: dict, tensors: tuple[str, ...]) -> bool:
    """Two server states alike bit for bit: ``tensors``' entries (a list
    of per-layer K/V dicts, or one tensor each), compared as bytes."""
    def flat(state):
        for key in tensors:
            val = state[key]
            if isinstance(val, list):
                yield from (layer[kv] for layer in val for kv in ("k", "v"))
            else:
                yield val
    return all(torch.equal(x.view(torch.uint8) if x.dtype.is_floating_point
                           else x, y.view(torch.uint8)
                           if y.dtype.is_floating_point else y)
               for x, y in zip(flat(a), flat(b), strict=True))


def _clone_paged(state: dict) -> dict:
    return {"pages": [{kv: t.clone() for kv, t in layer.items()}
                      for layer in state["pages"]],
            **{key: state[key].clone()
               for key in ("table", "pos", "active", "token")}}


def _copy_state(state: dict, src: dict) -> None:
    """Write ``src``'s tensors into ``state``'s in place (a compiled
    step's bound cache keeps its address), and its pos / active / token
    back into ``state``."""
    with torch.inference_mode():
        for key, val in src.items():
            if isinstance(val, list):
                for dst, layer in zip(state[key], val):
                    for kv in ("k", "v"):
                        dst[kv].copy_(layer[kv])
            elif key in ("pos", "active", "token"):
                state[key] = val.clone()
            else:
                state[key].copy_(val)


def _peak() -> int:
    """The allocator's peak reserved bytes since the last call (or the
    last reset), and a new reset."""
    peak = torch.cuda.max_memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    return peak


def _same_draws(*pairs) -> bool:
    """Each pair of generators at one state: the compiled path's and the
    eager path's drew alike."""
    return all(torch.equal(a.get_state(), b.get_state()) for a, b in pairs)


#: What the kernels line's ``replay_launches_by_path`` counts.
REPLAY_LAUNCHES_ARE = (
    "derived: each replay adds the launches its capture recorded. "
    "traced_replay_launches are counted by kernel name in a profiler trace "
    "of one call of each compiled path in phase 9, which fails unless they "
    "equal the derived count")
#: What each flash kernel's (mangled) name in a trace holds, bf16 or fp32.
TRACE_NAMES = {"flash_fwd": "flash_fwd_", "flash_bwd_dq": "flash_bwd_dq_",
               "flash_bwd_dkv": "flash_bwd_dkv_"}


def _replays(name: str, fn, calls: int = 1) -> tuple:
    """``fn()`` under the profiler; it must replay ``calls`` graphs of the
    compiled step ``name`` and run no wrapper. Fails unless it did, and
    unless each flash kernel's launches on the card, counted by name in
    the trace, equal both what the replayed captures recorded and what
    the launch counters added. Returns ``(fn()'s result, the traced
    launches)``."""
    stats = graphs.stats()[name]
    replays, booked = stats["replays"], dict(stats["launches"])
    before = _counts()
    result = []
    _, on_card, _ = profiled(lambda: result.append(fn()))
    traced = {k: sum(part in e.name for e in on_card)
              for k, part in TRACE_NAMES.items()}
    stats = graphs.stats()[name]
    booked = {k: stats["launches"][c] - booked[c]
              for k, c in zip(TRACE_NAMES, graphs.COUNTERS)}
    counted = {k: c - before[k] for k, c in _counts().items()}
    check(stats["replays"] == replays + calls
          and traced == booked == counted,
          f"9 {name}: {stats['replays'] - replays} replays of {calls}; "
          f"the trace holds {traced}, the captures recorded {booked}, "
          f"the counters grew {counted}; the trace's kernels: "
          f"{sorted({e.name[:60] for e in on_card})[:12]}")
    return result[0], traced


def _turns_ms(eager, compiled, rounds: int = 2) -> dict:
    """Host ms of ``eager()`` (under ``graphs.disabled()``) and of
    ``compiled()`` (a replay), synchronized, in turns: eager, compiled,
    compiled, eager, ``rounds`` times."""
    times = {"eager_ms": [], "compiled_ms": []}

    def one(kind):
        if kind == "eager_ms":
            with graphs.disabled():
                s = _synced_s(eager)
        else:
            s = _synced_s(compiled)
        times[kind].append(1e3 * s)

    for _ in range(rounds):
        for kind in ("eager_ms", "compiled_ms", "compiled_ms", "eager_ms"):
            one(kind)
    times["eager_over_compiled"] = (min(times["eager_ms"])
                                    / min(times["compiled_ms"]))
    return times


def compiled_phase(cfg: M.ModelConfig, grant) -> dict:
    """Phase 9: the compiled steps (``workload.graphs``) at flagship width
    under the grant's allocator cap. Each captured entry point runs the
    same call twice from one starting state: replayed, and under
    ``graphs.disabled()`` (the eager body); the sampled ones (``generate``,
    an admission, both chunks) are captured drawing from one generator
    and replayed with it or another, against eager calls from generators
    seeded alike. Fails unless every stream, state, cache or page pool,
    generator, loss and weight is bit-identical, each kernel's launches
    in a profiler trace of the replays are those their captures recorded
    (``_replays``), and the bucketed admissions miss once a bucket.
    Records each entry point's capture seconds, eager and replay host ms
    in turns, the traced launches, the graph pools' bytes, and each
    serving section's peak reserved bytes under the cap (up to its check;
    its turns count in the next section's)."""
    fraction = torchenv.apply_memory_fraction(grant)
    graphs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    memory_before = {"allocated": torch.cuda.memory_allocated(),
                     "reserved": torch.cuda.memory_reserved()}
    gen = _dev_gen(9)
    fields = {"memory_fraction": fraction}
    traced = {}

    # 3 flagship train steps at 8 x 2048 (bf16, remat), replayed, then the
    # same steps eager from the same weights, while the card holds nothing
    # else of this phase. Under the grant's cap a replayed step's pool and
    # an eager step's working set do not fit together, so the graph is
    # freed before the eager steps, and the two are timed in turns with
    # the cap lifted (as phase 7a times the step).
    init_fn, step, _ = T.make_train_step(cfg)
    batch = torch.randint(0, cfg.vocab_size, TRAIN_BATCH, generator=gen,
                          device="cuda")
    targets = torch.roll(batch, -1, dims=1)
    p_g, o_g = init_fn(_dev_gen(2), batch)
    losses_g = [step(p_g, o_g, batch, targets)[2].item()]
    for _ in range(2):
        # The loss alone is kept: a name left holding the step's
        # optimizer would keep the train graph (7.66 GB) alive.
        out, traced["train_step"] = _replays(
            "train_step", lambda: step(p_g, o_g, batch, targets)[2])
        losses_g.append(out.item())
    train_pool = graphs.pool_bytes()
    graphs.clear()
    torch.cuda.empty_cache()
    p_e, o_e = init_fn(_dev_gen(2), batch)
    with graphs.disabled():
        losses_e = [step(p_e, o_e, batch, targets)[2].item()
                    for _ in range(3)]
    same_w = all(torch.equal(a, b) for a, b in zip(p_g.parameters(),
                                                   p_e.parameters()))
    check(losses_g == losses_e and same_w,
          f"9 train: replayed steps differ from eager ones: {losses_g} vs "
          f"{losses_e}, weights equal {same_w}")
    del p_e, o_e
    torch.cuda.set_per_process_memory_fraction(1.0)
    step(p_g, o_g, batch, targets)                  # the capture again
    fields["train_step"] = {"batch": list(TRAIN_BATCH), "remat": cfg.remat,
                            "memory_before": memory_before,
                            "pool_bytes": train_pool,
                            "losses": losses_g, "bit_identical": True,
                            "turns_cap": "none", **_turns_ms(
        lambda: step(p_g, o_g, batch, targets),
        lambda: step(p_g, o_g, batch, targets))}
    del p_g, o_g, batch, targets
    torchenv.apply_memory_fraction(grant)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(gen, cfg)

    def ids(*shape):
        return torch.randint(0, cfg.vocab_size, shape, generator=gen,
                             device="cuda")

    # generate 8 x (128 + 64), plain and flash prefill.
    prompt = ids(8, 128)
    for name, attn in (("generate", None),
                       ("generate_flash", FA.flash_attention)):
        def gen_call(attn=attn):
            return S.generate(params, prompt, cfg, n_new=64, max_len=256,
                              attn_fn=attn)
        first = gen_call()
        replayed, traced[name] = _replays("generate", gen_call)
        with graphs.disabled():
            eager = gen_call()
        check(torch.equal(first, eager) and torch.equal(replayed, eager),
              f"9 {name}: replayed stream differs from the eager one")
        fields[name] = {"bit_identical": True,
                        "peak_reserved_bytes": _peak(),
                        **_turns_ms(gen_call, gen_call)}

    # generate sampled (flash prefill): captured drawing from one
    # generator, replayed with it and with another, against eager calls
    # from generators seeded alike.
    def sampled_call(g):
        return S.generate(params, prompt, cfg, n_new=64, max_len=256,
                          attn_fn=FA.flash_attention, temperature=0.8,
                          generator=g)
    got = []
    ga, gb, ra, rb = (_dev_gen(s) for s in (21, 22, 21, 22))
    got.append(sampled_call(ga))
    for g in (ga, gb):
        out, traced["generate_sampled"] = _replays(
            "generate", lambda g=g: sampled_call(g))
        got.append(out)
    with graphs.disabled():
        want = [sampled_call(g) for g in (ra, ra, rb)]
    check(all(torch.equal(a, b) for a, b in zip(got, want))
          and _same_draws((ga, ra), (gb, rb)),
          "9 generate_sampled: replayed streams or generators differ from "
          "the eager ones")
    check(not torch.equal(got[0], got[1]), "9 generate_sampled: a replay "
                                           "drew the capture's stream again")
    fields["generate_sampled"] = {
        "temperature": 0.8, "generators": 2, "bit_identical": True,
        "peak_reserved_bytes": _peak(),
        **_turns_ms(lambda: sampled_call(ra), lambda: sampled_call(ga))}

    # Bucketed admissions of the twin's mix through the flash kernel, into
    # a fresh state, then again into recycled slots.
    lengths = BW.PROMPT_MIX
    rounds = [[ids(length) for length in lengths] for _ in range(2)]
    st_g = S.init_server_state(cfg, len(lengths), SERVE_MAX_LEN)
    st_e = S.init_server_state(cfg, len(lengths), SERVE_MAX_LEN)
    S.reset_admission_stats()

    def admit_round(state, prompts):
        for slot, p in enumerate(prompts):
            S.release(state, slot)
            S.admit_bucketed(params, state, p, slot,
                             attn_fn=FA.flash_attention)

    admit_round(st_g, rounds[0])
    _, traced["admit"] = _replays(
        "admit", lambda: admit_round(st_g, rounds[1]), len(lengths))
    admissions = S.admission_stats()
    with graphs.disabled():
        for prompts in rounds:
            admit_round(st_e, prompts)
    keys = ("cache", "pos", "active", "token")
    check(_state_equal(st_g, st_e, keys),
          "9 admit: replayed admissions left another state than eager")
    buckets = {S.bucket_len(length, max_len=SERVE_MAX_LEN)
               for length in lengths}
    check(set(admissions) == buckets
          and all(e["jitMisses"] == 1 for e in admissions.values()),
          f"9 admit: not one miss a bucket: {admissions}")
    fields["admit"] = {"admissions": admissions, "bit_identical": True,
                       "peak_reserved_bytes": _peak(),
                       **_turns_ms(lambda: admit_round(st_e, rounds[1]),
                                   lambda: admit_round(st_g, rounds[1]))}

    # A sampled admission into slot 3, captured with one generator and
    # replayed with another, against eager ones seeded alike.
    def sampled_admit(state, g):
        S.release(state, 3)
        S.admit(params, state, rounds[0][3], 3, attn_fn=FA.flash_attention,
                temperature=0.7, generator=g)
    ga, gb, ra, rb = (_dev_gen(s) for s in (31, 32, 31, 32))
    same = []
    for g, r in ((ga, ra), (gb, rb)):
        if g is ga:
            sampled_admit(st_g, g)                  # the capture
        else:
            _, traced["admit_sampled"] = _replays(
                "admit", lambda: sampled_admit(st_g, g))
        with graphs.disabled():
            sampled_admit(st_e, r)
        same.append(_state_equal(st_g, st_e, keys))
    check(all(same) and _same_draws((ga, ra), (gb, rb)),
          f"9 admit_sampled: replayed admissions differ from eager ones "
          f"({same})")
    fields["admit_sampled"] = {"temperature": 0.7, "generators": 2,
                               "bit_identical": True,
                               "peak_reserved_bytes": _peak()}

    # A 64-step chunk at 8 slots (one released), from the admitted state.
    S.release(st_g, 2)
    S.serve_chunk(params, st_g, PIECE)             # the capture
    before = _clone_state(st_g)
    em_g, traced["serve_chunk"] = _replays(
        "serve_chunk", lambda: S.serve_chunk(params, st_g, PIECE)[1])
    with graphs.disabled():
        _, em_e = S.serve_chunk(params, before, PIECE)
    check(torch.equal(em_g, em_e) and _state_equal(st_g, before, keys),
          "9 serve_chunk: replayed chunk differs from the eager one")
    check(bool((em_g[:, 2] == -1).all()), "9 serve_chunk: released slot "
                                          "emitted")
    fields["serve_chunk"] = {"slots": len(lengths), "n_steps": PIECE,
                             "bit_identical": True,
                             "peak_reserved_bytes": _peak(), **_turns_ms(
        lambda: S.serve_chunk(params, dict(before), PIECE),
        lambda: S.serve_chunk(params, dict(st_g), PIECE))}

    # The chunk sampled (slot 1 greedy among sampled slots): each call from
    # the same state, the capture drawing from one generator and the
    # replay from another, against eager chunks seeded alike.
    temps = torch.full((len(lengths),), 0.9, device="cuda")
    temps[1] = 0.0
    start = _clone_state(st_g)
    ga, gb, ra, rb = (_dev_gen(s) for s in (41, 42, 41, 42))
    same = []
    for g, r in ((ga, ra), (gb, rb)):
        _copy_state(st_g, start)
        if g is ga:
            em_g = S.serve_chunk(params, st_g, PIECE, temps, g)[1]
        else:
            em_g, traced["serve_chunk_sampled"] = _replays(
                "serve_chunk", lambda: S.serve_chunk(params, st_g, PIECE,
                                                     temps, g)[1])
        eager_st = _clone_state(start)
        with graphs.disabled():
            em_e = S.serve_chunk(params, eager_st, PIECE, temps, r)[1]
        same.append(torch.equal(em_g, em_e)
                    and _state_equal(st_g, eager_st, keys))
    check(all(same) and _same_draws((ga, ra), (gb, rb)),
          f"9 serve_chunk_sampled: replayed chunks differ from eager ones "
          f"({same})")
    fields["serve_chunk_sampled"] = {"temperature": 0.9, "generators": 2,
                                     "bit_identical": True,
                                     "peak_reserved_bytes": _peak()}
    del st_g, st_e, before, start, eager_st

    # The paged chunk at 16 streams: the mix twice (prefix pages shared),
    # one stream that self-retires inside the compared chunk, and a
    # released stream whose unmapped table row clamps to page 0, which an
    # active stream holds.
    pslots = 2 * len(lengths)
    retire_at = SERVE_MAX_LEN - PIECE - PIECE // 2
    pages = 2 * sum(P.pages_for(min(length + 2 * PIECE, SERVE_MAX_LEN),
                                PIECE) for length in lengths) + 64
    pool = P.PagePool(pages, page_tokens=PIECE)
    pst = S.init_paged_state(cfg, pslots, SERVE_MAX_LEN, pages, PIECE)
    for slot in range(pslots - 1):
        S.admit_paged(params, pst, pool, rounds[0][slot % len(lengths)],
                      slot, tenant="tenant-a")
    S.admit_paged(params, pst, pool, ids(retire_at), pslots - 1)
    S.release_paged(pst, pool, 5)
    S.ensure_chunk_pages(pst, pool, PIECE)
    S._serve_chunk_paged(params, pst, PIECE, None, None)   # the capture
    S.ensure_chunk_pages(pst, pool, PIECE)
    holds_page0 = bool(((pst["table"] == 0) & pst["active"][:, None])
                       .any())
    check(holds_page0, "9 paged: no active stream holds page 0")
    pbefore = _clone_paged(pst)
    pem_g, traced["serve_chunk_paged"] = _replays(
        "serve_chunk_paged",
        lambda: S._serve_chunk_paged(params, pst, PIECE, None, None)[1])
    with graphs.disabled():
        _, pem_e = S._serve_chunk_paged(params, pbefore, PIECE, None, None)
    pkeys = ("pages", "table", "pos", "active", "token")
    check(torch.equal(pem_g, pem_e) and _state_equal(pst, pbefore, pkeys),
          "9 paged: replayed chunk differs from the eager one")
    live = pem_g[:, pslots - 1] >= 0
    check(bool(live.any()) and not bool(live.all()),
          "9 paged: the long stream did not retire inside the chunk")
    fields["serve_chunk_paged"] = {
        "streams": pslots, "n_steps": PIECE, "pool_pages": pages,
        "retired_after_steps": int(live.sum()), "bit_identical": True,
        "peak_reserved_bytes": _peak(),
        **_turns_ms(
            lambda: S._serve_chunk_paged(params, dict(pbefore), PIECE,
                                         None, None),
            lambda: S._serve_chunk_paged(params, dict(pst), PIECE, None,
                                         None))}

    # The paged chunk sampled, as the contiguous one, from the state after
    # the compared chunk, its pages mapped for the next.
    _copy_state(pst, pbefore)
    S.ensure_chunk_pages(pst, pool, PIECE)
    pbefore = _clone_paged(pst)
    ptemps = torch.full((pslots,), 1.0, device="cuda")
    ga, gb, ra, rb = (_dev_gen(s) for s in (51, 52, 51, 52))
    same = []
    for g, r in ((ga, ra), (gb, rb)):
        _copy_state(pst, pbefore)
        if g is ga:
            pem_g = S._serve_chunk_paged(params, pst, PIECE, ptemps, g)[1]
        else:
            pem_g, traced["serve_chunk_paged_sampled"] = _replays(
                "serve_chunk_paged", lambda: S._serve_chunk_paged(
                    params, pst, PIECE, ptemps, g)[1])
        eager_st = _clone_paged(pbefore)
        with graphs.disabled():
            pem_e = S._serve_chunk_paged(params, eager_st, PIECE, ptemps,
                                         r)[1]
        same.append(torch.equal(pem_g, pem_e)
                    and _state_equal(pst, eager_st, pkeys))
    check(all(same) and _same_draws((ga, ra), (gb, rb)),
          f"9 serve_chunk_paged_sampled: replayed chunks differ from eager "
          f"ones ({same})")
    fields["serve_chunk_paged_sampled"] = {
        "temperature": 1.0, "generators": 2, "bit_identical": True,
        "peak_reserved_bytes": _peak()}
    del pst, pbefore, pool, eager_st

    # The forward make_forward_fn builds, at the entry's shape.
    fwd = T.make_forward_fn(cfg)
    toks = ids(2, 256)
    first = fwd(params, toks)
    replayed, traced["forward"] = _replays("forward",
                                           lambda: fwd(params, toks))
    with graphs.disabled():
        eager = fwd(params, toks)
    check(torch.equal(first, eager) and torch.equal(replayed, eager),
          "9 forward: replayed logits differ from the eager ones")
    fields["forward"] = {"bit_identical": True,
                         "peak_reserved_bytes": _peak(),
                         **_turns_ms(lambda: fwd(params, toks),
                                     lambda: fwd(params, toks))}

    captured = {}
    for rec in graphs.CAPTURES:
        captured.setdefault(rec["name"], []).append(rec)
    fields["graphs"] = graphs.stats()
    fields["replayed"] = _replayed()
    fields["traced_launches"] = traced
    fields["captures"] = {
        name: {"count": len(recs),
               "seconds": [r["seconds"] for r in recs],
               "growth": [r["growth"] for r in recs]}
        for name, recs in captured.items()}
    fields["serving_pool_bytes"] = graphs.pool_bytes()
    fields["serving_peak_reserved_bytes"] = max(
        [torch.cuda.max_memory_reserved()]
        + [f["peak_reserved_bytes"] for f in fields.values()
           if isinstance(f, dict) and "peak_reserved_bytes" in f])
    del params
    graphs.clear()
    torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(1.0)
    return fields


def ring_step_timings(gen: torch.Generator) -> dict:
    """Phase 7c: ``RING_SHAPES`` in bf16, forward (:func:`time_shape`)
    and backward with a nonzero lse cotangent (:func:`time_bwd_shape`),
    and the future block's kernel times over the past block's."""
    result = {}
    for name, (b, lq, lk, h, d, qo, ko) in RING_SHAPES.items():
        q, k, v = (torch.randn((b, n, h, d), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for n in (lq, lk, lk))
        dlse = torch.randn((b, lq, h), generator=gen, device="cuda")
        result[name] = {
            "shape": [b, lq, lk, h, d, qo, ko],
            "forward": time_shape(q, k, v, qo, ko, "bfloat16"),
            "backward": time_bwd_shape(q, k, v, qo, ko, "bfloat16", dlse),
        }
    past, future = result["h_ring_past"], result["i_ring_future"]
    result["future_over_past"] = {
        "flash_fwd": future["forward"]["kernel_ms"]
        / past["forward"]["kernel_ms"],
        **{kname: future["backward"][kname]["kernel_ms"]
           / past["backward"][kname]["kernel_ms"]
           for kname in ("flash_bwd_dq", "flash_bwd_dkv")}}
    return result


if __name__ == "__main__":
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as tmp:
        code = main(tmp)
    sys.exit(code)
