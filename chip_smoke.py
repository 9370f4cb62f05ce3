"""On-card smoke run of the PyTorch / CUDA port (``tpushare_torch``).

    python3 chip_smoke.py

Needs one NVIDIA Hopper card (compute capability 9.0) and the CUDA
toolkit. Phase 0 is the node side of a grant: discovery through the
native shim, and the device plugin's allocation of a 16 GiB grant, whose
env this process runs in. It builds the flash-attention kernels (forward,
and the dq and dk/dv backward) from the sources in this checkout, holds
each against its plain PyTorch version, runs ``cogpucheck.py``'s
co-tenancy suite (train and decode tenants as processes under grants
carved from the card that NVIDIA discovery sizes), starts a tenant in
exactly the allocation's env that serves the flagship inside the grant
(phase 2d), and runs the node daemon (phase 2e: the port's device plugin
annotates a node with the card and advertises it, matches and commits a
pod the extender assumed in Allocate, in process and over gRPC to a fake
kubelet, a tenant serves in the response's env, and the grant watchdog
sweeps its heartbeat) and the scheduler extender (phase 2f: the port's
``serve_stack`` places a tenant on the card's node through filter,
prioritize and bind over HTTP, the daemon commits that very pod over
gRPC and the tenant serves in its env; then a seeded churn binds 4,096
pods on a fleet of 1,024 H100 nodes, with p50 and p99 of the three
verbs, twice, with the continuous profiler armed, its cost ledger held
to ``/metrics`` and its pprof suite checked, and disarmed after) and
gangs (phase 2g: a gang of four placed on the card's node by
the extender, all or nothing through bind, and granted by the daemon
over gRPC trains flagship steps on the card in gloo ranks started from
only their Allocate responses; the controller reaps a gang that lost a
member, a gang that never reaches quorum is rolled back at its TTL, and
256 gangs of four whole nodes churn through the 1,024-node fleet, none
ever bound in part), tenancy and HA (phase 2h) and defragmentation with
the pod-journey SLOs (phase 2i: a pod that fragmentation leaves pending
binds on the card's node after the defrag executor moves a pod off it,
once a burning SLO has aborted its first plan, and serves on the card)
and fleet autoscaling with the serving router (phase 2j, in
``chip_smoke_autoscale.py``: a router's scale-out puts a decode pod on
the card's node, where it serves, after the autoscaler holds with
capacity-exists; a second scale-out holds with defrag-first, then
scales the fleet up by a node the pod binds on, which the trough
drains and deletes), then drives the flagship LM's forward, serving
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
The chunked, interleaved and paged prefill pieces are among them: the
forward reads a piece's offsets from device memory, and phase 3 replays
one captured launch at several offsets against the launch-argument
kernel, bit for bit. Phase 9b runs the compiled sharded steps in gangs
of ``python3 chip_smoke.py --compiled-gang SPEC`` ranks: (a) a one-rank
NCCL gang through the mesh branches of the train step (with a
checkpoint restore whose next step replays) and ``generate``, compiled
against eager bit for bit and traced, (b) a two-rank gloo gang whose
(1, 1, 2) ring step stays eager by the backend rule, and (c), on a host
of four cards or more, the four-card NCCL gangs ``tools/nccl_gang.py
--compiled`` runs.
One line per phase;
then a ``kernels`` JSON line, the card's name and power limit as
nvidia-smi gives them, and as the last line ``{"ok": true, "device":
{...}}``. Any failure raises and exits nonzero; so does a host without a
CUDA device.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import http.client
import json
import math
import os
import random
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

import bench_workload_torch as BW
import chip_smoke_autoscale as CA
import cogpucheck
from tpushare_torch import entry as E
from tpushare_torch import obs as tobs
from tpushare_torch import profiling as tprofiling
from tpushare_torch import slo as tslo
from tpushare_torch import trace as ttrace
from tpushare_torch.cache.cache import SchedulerCache
from tpushare_torch.cmd import main as extender_main
from tpushare_torch.defrag import frag as tfrag
from tpushare_torch.deviceplugin import discovery, kubelet, plugin, watchdog
from tpushare_torch.gang.planner import QUORUM_HOLD_MARKER
from tpushare_torch.k8s import events as tevents
from tpushare_torch.k8s.builders import make_pod
from tpushare_torch.k8s.errors import NotFoundError
from tpushare_torch.k8s.fake import FakeApiServer
from tpushare_torch.utils import pod as podutils
from tpushare_torch.runtime import launch, torchenv
from tpushare_torch.utils import const
from tpushare_torch.workload import checkpoint as CK
from tpushare_torch.workload import collectives as C
from tpushare_torch.workload import convert
from tpushare_torch.workload import flash_attention as FA
from tpushare_torch.workload import graphs
from tpushare_torch.workload import model as M
from tpushare_torch.workload import moe
from tpushare_torch.workload import paging as P
from tpushare_torch.workload import parallel as par
from tpushare_torch.workload import pipeline as PP
from tpushare_torch.workload import serving as S
from tpushare_torch.workload import train as T
from tpushare_torch.routes import pprof as tpprof
from tpushare_torch.utils import locks as tlocks
from tpushare_torch.utils import runtime as gc_runtime

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
#: Phase 3's one captured launch, many offsets: a compiled piece's launch,
#: 64 queries against the slot's whole 2048-key row at 8 heads of 64, its
#: (q_offset, 0) read from device memory; replayed at each of these.
DEVICE_OFFSET_SHAPE = (1, 64, 2048, 8, 64)
DEVICE_OFFSETS = (0, 64, 960, 1984)
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
#: Phase 0's pod: its heartbeat directory is ``<usage dir>/<uid>``.
SMOKE_POD_UID = "chip-smoke"
#: Phase 2d: the flag that runs this script as the allocated tenant, the
#: only variables of this process's env the tenant gets (the rest is the
#: allocation's), its request (phase 5's ``generate``) and its deadline.
TENANT_FLAG = "--allocated-tenant"
TENANT_KEEP_ENV = ("PATH", "HOME", "PYTHONPATH", "TMPDIR", "LD_LIBRARY_PATH",
                   "CUDA_HOME", "CUDA_PATH", "PYTHONPYCACHEPREFIX")
TENANT_BATCH, TENANT_PROMPT, TENANT_NEW = 8, 128, 64
TENANT_DEADLINE_S = 180
#: Phase 2e: the flag that runs this script as the daemon's tenant (phase
#: 2d's, which then heartbeats every DAEMON_BEAT_S seconds and holds the
#: card until its stdin closes), the fake apiserver's node, and the pods
#: the extender assumed on the first card as (name, GiB) in assume order:
#: in-process Allocate takes 7 GiB (the first pod, not the 4 GiB one),
#: then over gRPC 7 GiB again, which the earlier of the last two pods
#: must win. DAEMON_SWEEPS sweeps, a second apart, at most.
HELD_TENANT_FLAG = "--held-tenant"
#: The held tenant started ahead of its grant: it imports, then waits for
#: a ``GO`` line on its stdin before it touches the card (phase 2i).
GATED_TENANT_FLAG = "--gated-tenant"
DAEMON_BEAT_S = 1.0
DAEMON_NODE = "chip-smoke-node"
DAEMON_PODS = (("early", 7), ("small", 4), ("wire-early", 7),
               ("wire-late", 7))
DAEMON_SWEEPS = 30
#: The keys of a heartbeat, as the grant watchdog reads them.
HEARTBEAT_KEYS = {"bytes_in_use", "peak_bytes", "bytes_limit", "source",
                  "ts", "pid"}
#: Phase 2f: the scheduler extender. The card's node; the fleet beside it,
#: ``bench.py``'s scale fleet of 1,024 nodes (``SCALE_NODES``), each an
#: H100 host of 8 cards as ``discovery.fake_inventory(chips=8)`` makes
#: it; the tenant's GiB; a copy of ``bench.py``'s ``SIZE_MIX`` (GiB slices
#: and whole 4-card pods, with their weights) and ``SCALE_TTL_ROUNDS``
#: (this script may not import ``bench.py``, which imports the JAX
#: package); the pods the churn binds, its seed and its round cap.
EXTENDER_NODE = "chip-smoke-extender-node"
EXTENDER_FLEET = 1024
EXTENDER_FLEET_CARDS = 8
EXTENDER_TENANT_GIB = 7
EXTENDER_SIZE_MIX = (("hbm", 16, 20), ("hbm", 24, 15), ("hbm", 44, 20),
                     ("chip", 4, 45))
EXTENDER_TTL_ROUNDS = (2, 5)
EXTENDER_BOUND = 4096
EXTENDER_SEED = 11
EXTENDER_MAX_ROUNDS = 60
#: Phase 2f's NotReady leg: ``fleet_nodes_ready`` must drop by one within
#: this many ticks of the timeline's sampler.
NOTREADY_TICKS = 3
#: The retrospective layer's families of ``/metrics``.
TIMELINE_FAMILIES = (
    "tpushare_build_info", "tpushare_uptime_seconds",
    "tpushare_anomaly_fired_total", "tpushare_timeline_dropped_total",
    "tpushare_timeline_series", "tpushare_witness_events_matched_total",
    "tpushare_witness_events_late_total",
    "tpushare_witness_events_missing_total",
    "tpushare_witness_events_spurious_total")
#: The timeline overhead gates (``bench.py``'s ``_timeline_overhead_probe``
#: and ``_blackbox_overhead_probe``, run by ``tools/extender_phases.py
#: --overhead``, not by this script's main): batches of mutation-free
#: filter + prioritize sequences in each arm, the least batch p99 of each
#: arm, and the on arm may add at most max(5% of the off arm's p99,
#: 0.2 ms).
OVERHEAD_BATCHES, OVERHEAD_PER_BATCH = 5, 500
OVERHEAD_LIMIT, OVERHEAD_FLOOR_MS = 0.05, 0.2
#: The profiler's attribution check (``bench.py``'s
#: ``SCALE_GATE_ATTRIBUTION`` over ``SCALE_ATTRIBUTION_TOP`` frames a
#: verb): the share of the scheduling verbs' profiled time that their
#: listed frames explain. Phase 2f records it beside this bound.
PROFILE_ATTRIBUTION, PROFILE_ATTRIBUTION_TOP = 0.90, 100
#: The verbs of the churn, and the ledger's splits that 2f reports and
#: holds ``/metrics``' ``tpushare_verb_*`` families to.
PROFILE_VERBS = ("filter", "prioritize", "bind")
LEDGER_FAMILIES = {
    "decisions": "tpushare_verb_decisions_total",
    "wallSeconds": "tpushare_verb_wall_seconds_total",
    "cpuSeconds": "tpushare_verb_cpu_seconds_total",
    "lockWaitSeconds": "tpushare_verb_lock_wait_seconds_total",
    "apiSeconds": "tpushare_verb_apiserver_seconds_total",
    "queueWaitSeconds": "tpushare_verb_queue_wait_seconds_total"}
#: Phase 2g: gangs. The card's node; the gang of GANG_MEMBERS members
#: (``w-0`` ...) that the extender places there, each asking for a
#: GANG_MEMBERS-th of the card's GiB, trains GANG_STEPS flagship steps as
#: a (GANG_MEMBERS, 1, 1) gloo gang; the TTL a group is given before its
#: last member fails to come; the churn's gangs of GANG_MEMBERS whole H100
#: nodes (``chips=8``) on phase 2f's fleet, GANG_CHURN_WINDOW gangs
#: arriving a round, their members shuffled together, its seed and round
#: cap.
GANG_NODE = "chip-smoke-gang-node"
GANG_GROUP = "smoke"
GANG_MEMBERS = 4
GANG_STEPS = 3
GANG_TTL_S = 0.5
GANG_CHURN_GANGS = 256
GANG_CHURN_WINDOW = 16
GANG_CHURN_SEED = 13
GANG_CHURN_MAX_ROUNDS = 80
#: Phase 2h: tenancy and HA. The two replicas' Lease and its renewal
#: period (s); the card's node and TENANCY_FLEET H100 nodes beside it;
#: the victim's and the preemptor's GiB (the PDB'd pod's too); the tenants
#: (namespaces): the victim's borrows (guarantee 0), the PDB'd pod's
#: runs within its guarantee, the fillers of priority 20 are another's,
#: the preemptor's has no spec until phase (e) caps it; the priorities.
TENANCY_LEASE_S = 2.0
TENANCY_RENEW_S = 0.5
TENANCY_NODE = "chip-smoke-tenancy-node"
TENANCY_FLEET = 7
TENANCY_GIB = 16
TENANCY_SERVE, TENANCY_GUARDED = "team-serve", "team-guarded"
TENANCY_STEADY, TENANCY_BURST = "team-steady", "team-burst"
TENANCY_FILL_PRIORITY, TENANCY_PREEMPT_PRIORITY = 20, 10
#: Phase 2h (f): the admission review's pod, more GiB than a card holds.
TENANCY_OVERSIZE_GIB = 96
#: Phase 2h (g): bench.py's preempt twins (bench_preempt on 8 saturated
#: nodes, bench_gang_preempt with a priority-5 gang of 4 whole-node
#: members), then the preempt verb alone over phase 2f's 1,024 saturated
#: nodes, PREEMPT_REPEATS times.
PREEMPT_BENCH_NODES = 8
PREEMPT_GANG_HOSTS = 4
PREEMPT_REPEATS = 5
#: Phase 2f: the reference's gates on the churn's journeys and on its
#: end-of-churn fragmentation (``bench.py``'s ``GATE_POD_E2E_P99_S``,
#: ``GATE_STRANDED_RATIO``), recorded beside the churn's numbers.
GATE_POD_E2E_P99_S = 30.0
GATE_STRANDED_RATIO = 0.15
#: Phase 2i: defragmentation and pod-journey SLOs. The card's node and
#: DEFRAG_FLEET H100 nodes beside it; the card left with DEFRAG_SPLINTER_GIB
#: free (a splinter under TENANCY_GIB), holding the pod the plan moves
#: (DEFRAG_MOVABLE_GIB, the largest movable pod there), DEFRAG_FILLERS
#: fillers of DEFRAG_FILLER_GIB and a pod with a checkpoint in flight; each
#: fleet card left with DEFRAG_MOVABLE_GIB + 1 free (room for the moved
#: pod, none for a TENANCY_GIB pod). The SLO ConfigMap's namespace; its
#: objective that the fill's journeys burn (each bound later than 1 ms
#: after its creation), and the one that lifts the burn; the executor's
#: posture and budget (no loop tick within the phase).
DEFRAG_NODE = "chip-smoke-defrag-node"
DEFRAG_FLEET = 3
DEFRAG_SPLINTER_GIB = 10
DEFRAG_MOVABLE_GIB = 8
DEFRAG_FILLER_GIB = 7
DEFRAG_FILLERS = 5
DEFRAG_SLO_NAMESPACE = "chip-smoke-slos"
DEFRAG_BURNING_SLO = {"chip-smoke-bind-1ms": {
    "signal": "pod_e2e", "objective": 0.5, "thresholdSeconds": 0.001,
    "fastBurn": 1.0}}
DEFRAG_LIFTED_SLO = {"chip-smoke-bind-600s": {
    "signal": "pod_e2e", "objective": 0.99, "thresholdSeconds": 600}}
DEFRAG_ENV = {"TPUSHARE_DEFRAG_MODE": "active",
              "TPUSHARE_DEFRAG_INTERVAL_S": "3600",
              "TPUSHARE_DEFRAG_MAX_MOVES": "4",
              "TPUSHARE_DEFRAG_MOVES_PER_HOUR": "20",
              "TPUSHARE_DEFRAG_NODE_COOLDOWN_S": "300",
              "TPUSHARE_DEFRAG_MAX_CONCURRENT": "2",
              "TPUSHARE_SLO_NAMESPACE": DEFRAG_SLO_NAMESPACE}
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


#: When this process started its phases: each phase line carries the
#: seconds since (``elapsed_s``), so a run's time can be split by phase.
_STARTED = time.perf_counter()
#: Held by an in-process leg of phases 5d-5h, which run in two lanes at
#: once, from resetting this process's launch counters to reading them.
_COUNTED = threading.Lock()


def phase(name: str, **fields) -> None:
    fields.setdefault("elapsed_s", time.perf_counter() - _STARTED)
    print(f"[{name}] " + json.dumps(fields, sort_keys=True), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def concurrently(*calls):
    """Run each call (of no arguments) in a thread of its own and return
    their results in order. Waits for every call to end, then raises the
    first failure: a gang of a lane that did not fail runs to its end or
    its deadline, so no process is left behind."""
    results, errors = [None] * len(calls), [None] * len(calls)

    def run(i: int, call) -> None:
        try:
            results[i] = call()
        except BaseException as exc:        # re-raised below, in order
            errors[i] = exc

    threads = [threading.Thread(target=run, args=(i, call),
                                name=f"chip_smoke-lane-{i}")
               for i, call in enumerate(calls)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for exc in errors:
        if exc is not None:
            raise exc
    return results


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(usage_dir: str) -> int:
    # 0. Grant: the node side of a grant, before anything touches CUDA
    # (discovery never does): the native shim's inventory, the device
    # plugin's allocation of GRANT_GIB on the first card, and this
    # process configured from exactly the env that allocation emits.
    try:
        total_mib = int(nvidia_smi("memory.total").split()[0])
    except (OSError, subprocess.SubprocessError) as exc:
        print(f"chip_smoke: no NVIDIA card ({exc})", file=sys.stderr)
        return 2
    inv = discovery.discover_host()
    check(inv is not None, "discovery found no NVIDIA card")
    check(inv.source == "native", f"discovery ran the {inv.source} rung, "
                                  f"not the native shim")
    alloc = plugin.build_allocation(inv, [inv.chips[0].index], GRANT_GIB,
                                    pod_uid=SMOKE_POD_UID,
                                    usage_dir=usage_dir)
    missing = [host for host, _ in alloc.devices if not os.path.exists(host)]
    check(not missing, f"the allocation mounts devices that do not exist: "
                       f"{missing}")
    usage_file = alloc.envs[const.ENV_USAGE_FILE]
    os.environ.update(alloc.envs)
    grant = torchenv.configure()
    check(os.environ[const.ENV_CUDA_VISIBLE_DEVICES] == "0",
          f"CUDA_VISIBLE_DEVICES {os.environ[const.ENV_CUDA_VISIBLE_DEVICES]}")
    phase("0 grant", source=inv.source, chip_ids=list(grant.chip_ids),
          hbm_pod_gib=grant.hbm_pod_gib, hbm_chip_gib=grant.hbm_chip_gib,
          envs=alloc.envs, devices=[host for host, _ in alloc.devices],
          mounts=alloc.mounts, annotations=alloc.annotations)

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    # Every process this script starts (a gang's ranks, a tenant) imports
    # torch. Where the interpreter is told to write no bytecode, each one
    # compiles torch's sources anew, seconds of CPU a process
    # (tools/process_start_probe.py); a cache under the checkout's build/
    # lets every process but the first skip that.
    os.environ["PYTHONPYCACHEPREFIX"] = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build", "pycache")
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)

    # 1. Device.
    card = nvidia_smi("name,power.limit")
    cap = torch.cuda.get_device_capability(0)
    check(cap == (9, 0), f"needs compute capability (9, 0), got {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # What the device plugin advertises for this host (phase 0's
    # inventory): as many cards as torch sees, none sized past what
    # nvidia-smi says it holds.
    chips = plugin.chip_devices(inv)
    rungs = {name: scan() for name, scan in (
        ("native", lambda: discovery.NativeDiscovery().discover()),
        ("devfs", discovery.devfs_scan), ("sysfs", discovery.sysfs_scan),
        ("procfs", discovery.procfs_scan), ("env", discovery.env_discover))}
    phase("1 device", card=card, torch=torch.__version__,
          cuda=torch.version.cuda, capability=list(cap),
          count=torch.cuda.device_count(), memory_total_mib=total_mib,
          inventory=dataclasses.asdict(inv),
          advertised={"hbm": len(plugin.hbm_devices(inv)),
                      "chips": [(d.id, d.health) for d in chips]},
          rungs={name: r and [r.chip_count, r.tpu_type]
                 for name, r in rungs.items()})
    check({d.health for d in chips} == {plugin.HEALTHY},
          "an advertised card is unhealthy")
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

    # 2d. A tenant started in exactly the allocation's env serves the
    # flagship through the forward kernel inside the grant's cap and
    # heartbeats where the allocation mounted its usage file.
    tenant = allocated_tenant_phase(alloc, inv.chips[0].hbm_gib)
    phase("2d allocated tenant", card=card, **tenant)

    # 2e. The node daemon: annotate, advertise, match and commit an assumed
    # pod in Allocate (in process, then over gRPC), serve a tenant in the
    # wire response's env and sweep its heartbeat with the watchdog.
    daemon = node_daemon_phase(inv, total_mib, usage_dir)
    phase("2e node daemon", card=card, **daemon)

    # 2f. The scheduler extender: the port's serve_stack places a tenant
    # on this card's node over HTTP, the port's daemon commits that pod
    # over gRPC, the tenant serves in its env; then a seeded churn binds
    # EXTENDER_BOUND pods on a fleet of EXTENDER_FLEET H100 nodes.
    extender = extender_phase(inv, usage_dir)
    phase("2f extender", card=card, **extender)

    # 2g. Gangs: a gang of four placed on this card's node by the port's
    # extender (all or nothing through bind) and granted by the port's
    # daemon trains flagship steps on the card from only those grants,
    # held to the single-process step (computed once, here, and handed on
    # to phase 5d); then the reaper, the TTL rollback and a churn of 256
    # gangs through 1,024 H100 nodes.
    step_ref = single_process_step(M.ModelConfig())
    gang = gang_phase(inv, usage_dir, step_ref)
    phase("2g gang", card=card, **gang)

    # 2h. Tenancy and HA: two extender replicas under leader election over
    # one apiserver; a tenant placed and granted on this card serves until
    # the leader fails over and a priority pod preempts it, then the
    # preemptor serves in its place; quota and admission on the new
    # leader; bench.py's preempt twins and the preempt verb at 1,024 nodes.
    # 2i's tenant starts now, gated before CUDA: its imports overlap 2h.
    gated = defrag_tenant(inv, usage_dir)
    tenancy = tenancy_phase(inv, usage_dir)
    phase("2h tenancy", card=card, **tenancy)
    # 2j's tenant starts now, gated: its imports overlap 2i.
    gated_2j = autoscale_tenant(inv, usage_dir)

    # 2i. Defragmentation and pod-journey SLOs: the card's node filled to a
    # splinter leaves a pod pending; a burning SLO aborts the defrag
    # executor's first plan, the next moves a pod off the card (never the
    # one with a checkpoint in flight), and the pending pod binds there,
    # is granted and serves on the card, its journey closed bound.
    defrag = defrag_phase(inv, usage_dir, tenant=gated)
    phase("2i defrag and SLO", card=card, **defrag)

    # 2j. Autoscaling and the serving router: a surge's scale-out places
    # a decode pod on the card's node (after a capacity-exists hold),
    # granted and served on the card; a second surge holds defrag-first,
    # then buys a node the next decode pod binds on; the trough drains
    # and deletes it. The host twins run beside it.
    autoscale = autoscale_phase(inv, usage_dir, tenant=gated_2j)
    phase("2j host twins", card=card, **autoscale.pop("twin_documents"))
    phase("2j autoscale and router", card=card, **autoscale)

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
    device_offsets = device_offsets_phase(gen)
    bwd_offsets = device_offsets_bwd_phase(gen)
    phase("3 device offsets", card=card, **device_offsets,
          backward=bwd_offsets)

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
    replayed = {"serving": _replayed(), "allocated_tenant": tenant["replayed"]}
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

    # 5d-5h. The gang phases, in two lanes at once, each lane's gangs
    # granted from half the card: a gang spends most of its time starting
    # its ranks (tools/process_start_probe.py), not on the card.
    ref, step_ref = step_ref, None
    card_gib = inv.chips[0].hbm_gib
    lane_gib = card_gib // 2
    torch.cuda.empty_cache()

    def lane_a() -> tuple[dict, dict]:
        # 5d. Sharded training: gangs of ranks on this card through the
        # entry point's rank body, held to the single-process kernel step.
        sharded = sharded_phase(cfg, card_gib, ref=ref, pool_gib=lane_gib)
        phase("5d sharded training", card=card, **sharded)
        # 5f. Checkpoint, resume and tp serving: a gang saves
        # asynchronously, fresh gangs on the same and on another mesh
        # resume from it, one process restores it unsharded and serves, a
        # tp gang serves it.
        return sharded, checkpoint_phase(cfg, card_gib, pool_gib=lane_gib)

    def lane_b() -> tuple[dict, dict, dict]:
        # 5e. Pipeline and expert parallelism: the 1F1B pipe (and GPipe)
        # with the kernels in every stage, the 4D pipe with ring-flash in
        # the stages, and the ring-MoE, held to the same single-process
        # step.
        piped = pipe_phase(cfg, card_gib, ref, pool_gib=lane_gib)
        phase("5e pipeline and expert parallelism", card=card, **piped)
        # 5f's pipe legs: a pipe gang's checkpoint in the reference's
        # stacked layout, resumed on another tp, whole in this process,
        # and refused onto another stage count.
        pipe_ckpt = pipe_checkpoint_phase(cfg, card_gib, fraction,
                                          pool_gib=lane_gib)
        # 5h. The reference dry run as a user starts it, tiny width (head
        # dim 16; training bf16, the other parts fp32), every part, a gang
        # on the card held to the same gang on the host.
        dry = dryrun_phase(card_gib, pool_gib=lane_gib)
        phase("5h tiny dry run", card=card, **dry)
        return piped, pipe_ckpt, dry

    (sharded, lifecycle), (piped, pipe_ckpt, dry) = concurrently(lane_a,
                                                                 lane_b)
    del ref
    lifecycle["launches"].update(pipe_ckpt.pop("launches"))
    phase("5f checkpoint, resume and tp serving", card=card, **lifecycle,
          pipe=pipe_ckpt)

    # 6. Heartbeat, and whether the grant's allocator cap holds.
    snap = torchenv.write_usage()
    with open(usage_file, encoding="utf-8") as f:
        beat = json.load(f)
    check(set(beat) == HEARTBEAT_KEYS, f"heartbeat keys {set(beat)}")
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
    # 8b. The router's replay at the admission overhead phase 8 measured.
    phase("8b router replay at the card's overhead",
          **CA.router_overhead_replay(
              card, bench["document"]["continuous_admission_overhead_pct"]))
    replayed.update({f"bench_{section}": counts
                     for section, counts in bench["replayed"].items()})

    # 9. The compiled steps: each captured entry point replayed against its
    # eager body from the same state, at flagship width under the grant.
    compiled = compiled_phase(M.ModelConfig(), grant)
    phase("9 compiled steps", card=card, **compiled)
    replayed["compiled_steps"] = compiled["replayed"]
    replayed["compiled_pieces"] = compiled["replayed_pieces"]

    # 9b. The compiled sharded steps: gangs whose train step, generate,
    # pipe calls and ring-MoE replay a CUDA graph a rank under NCCL, held
    # to their eager calls; a gloo gang stays eager.
    meshed = compiled_mesh_phase(M.ModelConfig(), inv.chip_count)
    phase("9b compiled sharded steps", card=card, **meshed)
    replayed.update(meshed["replayed"])
    traced_launches = {**compiled["traced_launches"],
                       **meshed["traced_launches"]}
    main_t = timings[TIMED_SHAPE, "bfloat16"]
    piece_t = timings[PIECE_SHAPE, "bfloat16"]
    by_path = {"serving": launches,
               "allocated_tenant": tenant["launches"],
               "node_daemon_tenant": daemon["launches"],
               "extender_tenant": extender["launches"],
               "gang_tenant": gang["launches"]["flash_fwd"],
               **tenancy["launches"],
               **defrag["launches"],
               **autoscale["launches"],
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
               **bench_paths(bench, "flash_fwd"),
               **{path: counts["flash_fwd"]
                  for path, counts in meshed["launches"].items()}}
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
            for path, counts in traced_launches.items()},
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
        "device_offsets": {
            "shape": list(DEVICE_OFFSET_SHAPE),
            "replayed_at": list(DEVICE_OFFSETS),
            **{dn: {key: rec[key] for key in (
                "timed_offset", "device_offset_kernel_ms",
                "device_offset_call_ms", "kernel_ms", "kernel_call_ms",
                "plain_ms", "library_ms", "bound_ms", "bound_by")}
               | {"max_norm_err": max(e["norm_err"]
                                      for e in rec["offsets"].values())}
               for dn, rec in device_offsets.items()}},
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
                    gang["launches"],
                    *cotenancy.values(), *sharded["launches"].values(),
                    *piped["launches"].values(),
                    *lifecycle["launches"].values(),
                    *meshed["launches"].values()]) + sum(
                dryrun_paths(dry, kname, train=True).values()) + sum(
                fp32_paths(train32, dry, kname).values()) + sum(
                bench_paths(bench, kname).values()),
            "replay_launches_by_path": {
                path: counts[kname] for path, counts in replayed.items()},
            "replay_launches_are": REPLAY_LAUNCHES_ARE,
            "traced_replay_launches": {
                path: counts[kname]
                for path, counts in traced_launches.items()},
            "launches_by_path": {"training": train["launches"][kname],
                                 "gang_tenant": gang["launches"][kname],
                                 **{path: counts[kname] for path, counts
                                    in cotenancy.items()},
                                 **{path: counts[kname] for path, counts
                                    in sharded["launches"].items()},
                                 **{path: counts[kname] for path, counts
                                    in piped["launches"].items()},
                                 **{path: counts[kname] for path, counts
                                    in lifecycle["launches"].items()},
                                 **{path: counts[kname] for path, counts
                                    in meshed["launches"].items()},
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
            "device_offsets": {
                "shape": bwd_offsets["timed"]["bfloat16"]["shape"],
                "checked_at": {"offsets": list(DEVICE_OFFSETS),
                               "shape": list(DEVICE_OFFSET_SHAPE[:4]),
                               "head_dims": [16, 64, 128]},
                **{dn: {**t[kname], "plain_ms": t["plain_ms"],
                        "library_ms": t["library_ms"]}
                   for dn, t in bwd_offsets["timed"].items()}},
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


def device_offsets_phase(gen: torch.Generator) -> dict:
    """One forward launch captured in a CUDA graph with its offsets in
    device memory (``DEVICE_OFFSET_SHAPE``, bf16 and fp32), replayed with
    the pair set to each of ``DEVICE_OFFSETS``: every replay must give the
    bits of the launch-argument kernel at that offset, and hold the
    phase-3 tolerances against the plain version. Then, at offset 960,
    the device ms of the device-offset launch and of the launch-argument
    one on the same inputs, the eager call ms, the plain and library ms
    and the bound (the keys past the piece are masked and never loaded,
    so the work and the bytes are what (g) needs at 1024 keys)."""
    b, lq, lk, h, d = DEVICE_OFFSET_SHAPE
    fields = {}
    for dt in (torch.bfloat16, torch.float32):
        dn = str(dt).split(".")[1]
        q, k, v = (torch.randn((b, n, h, d), generator=gen,
                               device="cuda").to(dt) for n in (lq, lk, lk))
        pair = torch.zeros(2, dtype=torch.int32, device="cuda")
        with torch.inference_mode():
            graph, got = _capture_once(lambda: FA.flash_fwd_kernel(
                q, k, v, pair[0:1], pair[1:2]))
            per = {}
            for off in DEVICE_OFFSETS:
                pair.copy_(torch.tensor([off, 0], dtype=torch.int32))
                graph.replay()
                out, lse = FA.flash_fwd_kernel(q, k, v, off, 0)
                torch.cuda.synchronize()
                p_out, p_lse = FA.flash_block_with_lse_plain(q, k, v, off, 0)
                same = torch.equal(got[0], out) and torch.equal(got[1], lse)
                check(same, f"3 device offsets/{dn}: the replay at offset "
                            f"{off} differs from the launch-argument kernel")
                e = {"bit_identical": same,
                     "norm_err": _norm_err(got[0], p_out),
                     "lse_err": (got[1] - p_lse).abs().max().item()}
                check(e["norm_err"] <= OUT_TOL[dn]
                      and e["lse_err"] <= LSE_TOL[dn],
                      f"3 device offsets/{dn} at {off}: {e}")
                per[off] = e
            del graph
            off = 960
            pair.copy_(torch.tensor([off, 0], dtype=torch.int32))
            timed = time_shape(q, k, v, off, 0, dn)
            timed["device_offset_kernel_ms"] = device_ms(
                lambda: FA.flash_fwd_kernel(q, k, v, pair[0:1], pair[1:2]))
            timed["device_offset_call_ms"] = time_ms(
                lambda: FA.flash_fwd_kernel(q, k, v, pair[0:1], pair[1:2]))
        fields[dn] = {"offsets": per, "timed_offset": off, **timed}
    return fields


def device_offsets_bwd_phase(gen: torch.Generator) -> dict:
    """Phase 3's device offsets, the backward half.

    (1) At ``DEVICE_OFFSET_SHAPE`` with head dims 16, 64 and 128, bf16 and
    fp32, a nonzero lse cotangent: one dq and one dk/dv launch captured
    in a CUDA graph with the offsets pair in device memory, replayed at
    each of ``DEVICE_OFFSETS`` (the forward's lse and delta at that offset
    copied into the captured inputs first), must give the bits of the
    launch-argument kernels at that offset, and so must an eager
    device-offset launch. (2) ``flash_block_with_lse`` with the pair as
    its offsets, forward and backward through autograd captured in one
    CUDA graph (D = 64, both dtypes), replayed at each offset, must give
    out, lse, dq, dk and dv bit for bit as eager autograd with int
    offsets; a profiler trace of one replay must hold one forward, one dq
    and one dk/dv launch. (3) At ring block (h) (``RING_SHAPES``,
    offsets (1024, 0), dlse nonzero), both dtypes: each backward kernel's
    device ms with the pair in device memory beside the launch-argument
    launch on the same inputs, with (h)'s bound, plain and library ms
    (:func:`time_bwd_shape`), and (4) every wrapper there with offsets
    that are not one buffer's (:func:`_offsets_apart`). These launches
    compare and time the kernels; none is counted on a path."""
    b, lq, lk, h, _ = DEVICE_OFFSET_SHAPE
    fields = {"replays": {}, "autograd_graph": {}, "timed": {},
              "apart": {}}
    pair = torch.zeros(2, dtype=torch.int32, device="cuda")

    def set_pair(off):
        pair.copy_(torch.tensor([off, 0], dtype=torch.int32))

    for dt in (torch.bfloat16, torch.float32):
        dn = str(dt).split(".")[1]
        for d in (16, 64, 128):
            q, k, v = (torch.randn((b, n, h, d), generator=gen,
                                   device="cuda").to(dt)
                       for n in (lq, lk, lk))
            do = torch.randn(q.shape, generator=gen, device="cuda").to(dt)
            dlse = torch.randn((b, lq, h), generator=gen, device="cuda")
            with torch.inference_mode():
                lse = torch.empty((b, lq, h), dtype=torch.float32,
                                  device="cuda")
                delta = torch.empty_like(lse)
                set_pair(DEVICE_OFFSETS[-1])
                graph, got = _capture_once(lambda: (
                    FA.flash_bwd_dq_kernel(q, k, v, do, lse, delta,
                                           pair[0:1], pair[1:2]),
                    *FA.flash_bwd_dkv_kernel(q, k, v, do, lse, delta,
                                             pair[0:1], pair[1:2])))
                per = {}
                for off in DEVICE_OFFSETS:
                    out, lse_off = FA.flash_fwd_kernel(q, k, v, off, 0)
                    lse.copy_(lse_off)
                    delta.copy_(FA.flash_bwd_delta(do, out, dlse))
                    set_pair(off)
                    graph.replay()
                    want = (FA.flash_bwd_dq_kernel(q, k, v, do, lse, delta,
                                                   off, 0),
                            *FA.flash_bwd_dkv_kernel(q, k, v, do, lse,
                                                     delta, off, 0))
                    eager = (FA.flash_bwd_dq_kernel(q, k, v, do, lse, delta,
                                                    pair[0:1], pair[1:2]),
                             *FA.flash_bwd_dkv_kernel(q, k, v, do, lse,
                                                      delta, pair[0:1],
                                                      pair[1:2]))
                    torch.cuda.synchronize()
                    same = {g: torch.equal(x, w) and torch.equal(e, w)
                            for g, x, e, w in zip(("dq", "dk", "dv"), got,
                                                  eager, want)}
                    check(all(same.values()) and all(
                        bool(torch.isfinite(x).all()) for x in got),
                          f"3 device offsets/backward {dn} D={d} at {off}: "
                          f"bit-identical {same}")
                    per[off] = same
                del graph, got
            fields["replays"][f"{dn}/d{d}"] = per
        fields["autograd_graph"][dn] = _autograd_offsets_graph(gen, dt, pair)
        name = "h_ring_past"
        bb, lq_h, lk_h, hh, dd, qo, ko = RING_SHAPES[name]
        q, k, v = (torch.randn((bb, n, hh, dd), generator=gen,
                               device="cuda").to(dt) for n in (lq_h, lk_h,
                                                               lk_h))
        dlse = torch.randn((bb, lq_h, hh), generator=gen, device="cuda")
        base = time_bwd_shape(q, k, v, qo, ko, dn, dlse)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(dt)
        pair.copy_(torch.tensor([qo, ko], dtype=torch.int32))
        with torch.inference_mode():
            out, lse = FA.flash_fwd_kernel(q, k, v, qo, ko)
            delta = FA.flash_bwd_delta(do, out, dlse)
            fns = {"flash_bwd_dq": FA.flash_bwd_dq_kernel,
                   "flash_bwd_dkv": FA.flash_bwd_dkv_kernel}
            timed = {"shape": [bb, lq_h, lk_h, hh, dd, qo, ko],
                     "library": base["library"],
                     "plain_ms": base["plain_ms"],
                     "library_ms": base["library_ms"]}
            for kname, fn in fns.items():
                timed[kname] = {
                    "launch_argument_kernel_ms": device_ms(
                        lambda: fn(q, k, v, do, lse, delta, qo, ko)),
                    "device_offset_kernel_ms": device_ms(
                        lambda: fn(q, k, v, do, lse, delta, pair[0:1],
                                   pair[1:2])),
                    "device_offset_call_ms": time_ms(
                        lambda: fn(q, k, v, do, lse, delta, pair[0:1],
                                   pair[1:2])),
                    **{key: base[kname][key] for key in (
                        "bound_ms", "bound_by", "ops", "bytes")}}
            fields["apart"][dn] = _offsets_apart(q, k, v, do, lse, delta,
                                                 qo, ko, dn)
        fields["timed"][dn] = timed
    return fields


def _offsets_apart(q, k, v, do, lse, delta, qo: int, ko: int,
                   dn: str) -> dict:
    """Each kernel's wrapper at ring block (h) with offsets that are not
    adjacent elements of one buffer, (tensor, int), (int, tensor) and two
    separate tensors, so the wrapper puts their pair together on the
    card: eager, and captured in a CUDA graph and replayed, out, lse, dq,
    dk and dv bit for bit the launch-argument launches'. (h)'s grid takes
    more than one wave, so late blocks read the pair well after the
    wrapper's later allocations."""
    def calls(q_off, kv_off):
        return (*FA.flash_fwd_kernel(q, k, v, q_off, kv_off),
                FA.flash_bwd_dq_kernel(q, k, v, do, lse, delta, q_off,
                                       kv_off),
                *FA.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, q_off,
                                         kv_off))

    def one(x):
        return torch.tensor([x], dtype=torch.int32, device="cuda")

    want = calls(qo, ko)
    forms = {"tensor_int": (one(qo), ko), "int_tensor": (qo, one(ko)),
             "two_tensors": (one(qo), one(ko))}
    fields = {}
    for form, offs in forms.items():
        eager = calls(*offs)
        graph, got = _capture_once(lambda offs=offs: calls(*offs))
        graph.replay()
        torch.cuda.synchronize()
        same = {name: torch.equal(e, w) and torch.equal(g, w)
                for name, e, g, w in zip(("out", "lse", "dq", "dk", "dv"),
                                         eager, got, want)}
        check(all(same.values()), f"3 device offsets/apart {dn} {form}: "
                                  f"bit-identical {same}")
        fields[form] = same
        del graph, got
    return fields


def _autograd_offsets_graph(gen: torch.Generator, dt: torch.dtype,
                            pair: torch.Tensor) -> dict:
    """``flash_block_with_lse(q, k, v, pair[0:1], pair[1:2])`` and its
    backward (``torch.autograd.grad`` with a nonzero lse cotangent) in one
    CUDA graph at ``DEVICE_OFFSET_SHAPE`` (D = 64), replayed at each of
    ``DEVICE_OFFSETS`` against eager autograd with the same offsets as
    ints: out, lse, dq, dk and dv bit for bit. One replay is traced: one
    forward, one dq and one dk/dv launch."""
    dn = str(dt).split(".")[1]
    b, lq, lk, h, d = DEVICE_OFFSET_SHAPE
    q, k, v = (torch.randn((b, n, h, d), generator=gen, device="cuda")
               .to(dt).requires_grad_() for n in (lq, lk, lk))
    do = torch.randn(q.shape, generator=gen, device="cuda").to(dt)
    dlse = torch.randn((b, lq, h), generator=gen, device="cuda")

    def step(q_off, kv_off):
        out, lse = FA.flash_block_with_lse(q, k, v, q_off, kv_off)
        grads = torch.autograd.grad((out, lse), (q, k, v), (do, dlse))
        return (out.detach(), lse.detach(), *grads)

    pair.copy_(torch.tensor([DEVICE_OFFSETS[-1], 0], dtype=torch.int32))
    graph, got = _capture_once(lambda: step(pair[0:1], pair[1:2]))
    per, traced = {}, None
    for off in DEVICE_OFFSETS:
        pair.copy_(torch.tensor([off, 0], dtype=torch.int32))
        if traced is None:
            _, on_card, _ = profiled(graph.replay)
            traced = {kname: sum(part in e.name for e in on_card)
                      for kname, part in TRACE_NAMES.items()}
        else:
            graph.replay()
        want = step(off, 0)
        torch.cuda.synchronize()
        same = {name: torch.equal(x, w) for name, x, w in zip(
            ("out", "lse", "dq", "dk", "dv"), got, want)}
        check(all(same.values()), f"3 device offsets/autograd graph {dn} at "
                                  f"{off}: bit-identical {same}")
        per[off] = same
    check(traced == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1},
          f"3 device offsets/autograd graph {dn}: a replay launched "
          f"{traced}")
    del graph
    return {"offsets": per, "traced_launches_a_replay": traced}


def _capture_once(fn):
    """``fn()`` captured in a CUDA graph after a warm-up on a side stream:
    (the graph, its static outputs)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


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


def tenant_env(alloc: plugin.ContainerAllocation, environ=None) -> dict:
    """Phase 2d's tenant env: ``TENANT_KEEP_ENV`` of ``environ`` (this
    process's by default), this checkout first on ``PYTHONPATH``, and
    the allocation's envs; nothing else."""
    src = os.environ if environ is None else environ
    env = {k: src[k] for k in TENANT_KEEP_ENV if k in src}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.dirname(os.path.abspath(__file__)),
                    env.get("PYTHONPATH")) if p)
    return {**env, **alloc.envs}


def allocated_tenant_phase(alloc: plugin.ContainerAllocation,
                           card_gib: int) -> dict:
    """Phase 2d: start ``python3 chip_smoke.py --allocated-tenant`` with
    only ``TENANT_KEEP_ENV`` of this process's env and the allocation's
    envs (none of this process's ``TPUSHARE_*`` or
    ``CUDA_VISIBLE_DEVICES``), and hold what it prints: one card, the
    grant's cap, ``n_layers`` forward launches a prefill, and a heartbeat
    with the watchdog's keys, within the grant, in the allocation's usage
    file. Returns the phase's fields; ``launches`` is the tenant's
    forward count."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = tenant_env(alloc)
    t0 = time.perf_counter()
    proc = subprocess.run(["python3", os.path.join(repo, "chip_smoke.py"),
                           TENANT_FLAG], env=env, cwd=repo,
                          capture_output=True, text=True,
                          timeout=TENANT_DEADLINE_S)
    seconds = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    check(proc.returncode == 0 and lines,
          f"allocated tenant exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    got = json.loads(lines[-1])
    want_cap = round(int(alloc.envs[const.ENV_HBM_POD]) / card_gib
                     * torchenv.DEFAULT_HEADROOM, 3)
    check(got["device_count"] == 1, f"the tenant sees {got['device_count']} "
                                    f"cards")
    check(got["cuda_visible_devices"] == "0",
          f"the tenant's CUDA_VISIBLE_DEVICES {got['cuda_visible_devices']}")
    check(got["cap"] == want_cap, f"the tenant's cap {got['cap']}, want "
                                  f"{want_cap}")
    check(got["launches"] == got["n_layers"] * got["prefills"],
          f"the tenant launched the forward kernel {got['launches']} times "
          f"for {got['prefills']} prefills of {got['n_layers']} layers")
    beat = got["heartbeat"]
    with open(alloc.envs[const.ENV_USAGE_FILE], encoding="utf-8") as f:
        on_disk = json.load(f)
    check(set(beat) == HEARTBEAT_KEYS and on_disk == beat,
          f"the tenant's heartbeat {beat} against its usage file {on_disk}")
    grant_bytes = int(alloc.envs[const.ENV_HBM_POD]) << 30
    check(0 < beat["bytes_in_use"] <= grant_bytes,
          f"the tenant holds {beat['bytes_in_use']} bytes under a "
          f"{grant_bytes}-byte grant")
    return {**got, "seconds": seconds, "grant_bytes": grant_bytes,
            "env_keys": sorted(env)}


def allocated_tenant(hold: bool = False, gated: bool = False) -> int:
    """The tenant of phase 2d, run in the allocation's env: configure
    from the grant before CUDA starts, cap the allocator, build the
    flagship from a seed, serve ``generate`` 8 x (128 + 64) twice through
    ``best_attn_fn`` (the first call captures, the second replays),
    heartbeat to the allocation's usage file, and print one JSON line.
    Held (phase 2e), it then heartbeats every ``DAEMON_BEAT_S`` seconds
    (``torchenv.start_usage_reporter``), prints ``READY`` and keeps the
    card until its stdin closes. Gated (phase 2i), it first waits for a
    ``GO`` line on its stdin, exits 3 on anything else, and its JSON line
    also holds when it reached the gate and left it and its first
    request's token stream."""
    gated_unix = go_unix = None
    if gated:
        gated_unix = time.time()
        if sys.stdin.readline().strip() != cogpucheck.GO:
            return 3
        go_unix = time.time()
    grant = torchenv.configure()
    check(grant is not None, "the tenant has no grant in its env")
    cap = torchenv.apply_memory_fraction(grant)
    cfg = M.ModelConfig()
    params = M.init_params(torch.Generator(device="cuda").manual_seed(0),
                           cfg)
    prompt = torch.randint(
        0, cfg.vocab_size, (TENANT_BATCH, TENANT_PROMPT),
        generator=torch.Generator(device="cuda").manual_seed(1),
        device="cuda")
    attn = FA.best_attn_fn()
    _zero_counts()
    graphs.reset_stats()
    outs, seconds, done_unix = [], [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(S.generate(params, prompt, cfg, n_new=TENANT_NEW,
                               max_len=TENANT_PROMPT + TENANT_NEW,
                               attn_fn=attn))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        done_unix.append(time.time())
    check(torch.equal(outs[0], outs[1]), "two greedy requests differ")
    check(tuple(outs[0].shape) == (TENANT_BATCH, TENANT_PROMPT + TENANT_NEW)
          and torch.equal(outs[0][:, :TENANT_PROMPT], prompt),
          f"generate gave {tuple(outs[0].shape)}")
    beat = torchenv.write_usage()
    check(beat is not None, "the tenant wrote no heartbeat")
    if hold:
        torchenv.start_usage_reporter(interval=DAEMON_BEAT_S)
    print(json.dumps({
        "device_count": torch.cuda.device_count(),
        "cuda_visible_devices": os.environ.get(
            const.ENV_CUDA_VISIBLE_DEVICES),
        "nvidia_visible_devices": os.environ.get(
            const.ENV_NVIDIA_VISIBLE_DEVICES),
        "chip_ids": list(grant.chip_ids), "cap": cap,
        "launches": FA.FLASH_FWD_LAUNCHES, "prefills": len(outs),
        "n_layers": cfg.n_layers, "replayed": _replayed(),
        "first_request_s": seconds[0], "request_s": seconds[1],
        "first_request_done_unix": done_unix[0],
        "tok_per_s": TENANT_BATCH * TENANT_NEW / seconds[1],
        "pid": os.getpid(), "heartbeat": beat,
        **({"gated_unix": gated_unix, "go_unix": go_unix,
            "stream": outs[0].tolist()} if gated else {})}), flush=True)
    if hold:
        print(cogpucheck.READY, flush=True)
        sys.stdin.read()
    return 0


def daemon_pods(inv: discovery.HostInventory) -> list[dict]:
    """Phase 2e's pods as the extender's bind leaves them on
    ``DAEMON_NODE``: ``DAEMON_PODS`` assumed on the first card, one
    nanosecond apart in that order, uids ``uid-<name>``."""
    chip = inv.chips[0]
    return [cogpucheck.assumed_pod(name, gib, chip.index, chip.hbm_gib,
                                   assume_ns=i + 1, node=DAEMON_NODE)
            for i, (name, gib) in enumerate(DAEMON_PODS)]


def wire_allocation(resp) -> plugin.ContainerAllocation:
    """A ``ContainerAllocateResponse`` from the wire as the plugin's
    allocation."""
    return plugin.ContainerAllocation(
        envs=dict(resp.envs),
        devices=tuple((d.host_path, d.container_path) for d in resp.devices),
        annotations=dict(resp.annotations),
        mounts=tuple((m.host_path, m.container_path, m.read_only)
                     for m in resp.mounts))


def daemon_sweep_gates(sweep: dict, annotations: dict, uid: str,
                       grant_gib: int) -> dict[str, bool]:
    """Phase 2e(d)'s verdicts on the tenant ``uid`` from a sweep document
    and its pod's annotations: its heartbeat fresh, its use above 0 and
    within its grant, no tenant over its grant, and the pod annotated
    with its use and not as an overrunner."""
    entry = next((t for t in sweep["tenants"] if t["uid"] == uid), None)
    fresh = entry is not None and entry["used_gib"] is not None
    return {
        "fresh": fresh,
        "within_grant": fresh and not entry["overrun"]
        and 0 < entry["used_gib"] <= grant_gib,
        "no_overrun": sweep["overruns"] == [],
        "annotated": const.ANN_HBM_USED in annotations
        and const.ANN_OVERRUN not in annotations,
    }


def node_daemon_phase(inv: discovery.HostInventory, total_mib: int,
                      usage_dir: str) -> dict:
    """Phase 2e: the node daemon on this host's cards. (a) The port's
    plugin annotates a node of the fake apiserver from phase 0's
    inventory (the card's GiB and model) and advertises a device a GiB,
    all healthy. (b) Of ``DAEMON_PODS``, in-process
    ``preferred_ids_batch`` and ``allocate_hbm_batch`` of 7 GiB match and
    commit "early" and hand back ``build_allocation``'s response; then
    ``run_node_daemon`` serves both resources to a ``FakeKubelet``, whose
    GetPreferredAllocation and Allocate of 7 GiB go over gRPC and must
    match "wire-early". The H100 machines this runs on have grpc and
    protobuf (grpc 1.80.0, protobuf 6.33.6 when checked), so the round
    trip always runs: the import is unconditional.
    (c) A tenant started in exactly the wire response's env serves the
    flagship (phase 2d's tenant, held) and (d) the port's
    ``GrantWatchdog`` sweeps until its heartbeat is fresh: within its
    grant, no overrun; its heartbeat beside ``nvidia-smi``'s figure for
    its process."""
    card_name = torch.cuda.get_device_name(0)
    model = discovery.parse_model(card_name)
    chip = inv.chips[0]
    api = FakeApiServer()
    api.create_node({"apiVersion": "v1", "kind": "Node",
                     "metadata": {"name": DAEMON_NODE}})
    for doc in daemon_pods(inv):
        api.create_pod(doc)

    def assigned(name):
        return api.get_pod("default", name).annotations[
            const.ANN_ASSIGNED] == const.ASSIGNED_TRUE

    with tempfile.TemporaryDirectory(prefix="chip_smoke-plugins-") as pdir:
        # (a) Annotate and advertise.
        plug = plugin.TPUSharePlugin(DAEMON_NODE, api, inv, state_dir=pdir,
                                     usage_dir=usage_dir)
        plug.annotate_node()
        ann = api.get_node(DAEMON_NODE).annotations
        check(ann[const.ANN_NODE_CHIP_HBM]
              == ",".join(str(c.hbm_gib) for c in inv.chips)
              and ann.get(const.ANN_NODE_TPU_TYPE) == model == inv.tpu_type
              and const.ANN_NODE_TOPOLOGY not in ann,
              f"node annotations {ann} for {card_name!r}")
        check(all(c.hbm_gib == discovery.HBM_GIB_BY_TYPE[model]
                  and c.hbm_gib << 10 <= total_mib
                  and c.device_path == f"/dev/nvidia{c.index}"
                  for c in inv.chips), f"inventory {inv}")
        devs = plug.hbm_devices()
        check(len(devs) == inv.total_hbm_gib
              and {d.health for d in devs} == {plugin.HEALTHY},
              f"{len(devs)} GiB devices advertised, health "
              f"{ {d.health for d in devs} }")
        avail = [d.id for d in devs]
        # (b) In process, then over the wire.
        t0 = time.perf_counter()
        [ids] = plug.preferred_ids_batch(const.HBM_RESOURCE, [(avail, 7)])
        preferred_ms = (time.perf_counter() - t0) * 1e3
        check(ids == [plugin.HBM_DEV_FMT.format(chip=chip.index, gib=g)
                      for g in range(7)], f"preferred {ids}")
        t0 = time.perf_counter()
        [alloc] = plug.allocate_hbm_batch([ids])
        allocate_ms = (time.perf_counter() - t0) * 1e3
        check(assigned("early") and not assigned("small"),
              "Allocate of 7 GiB did not commit the earlier pod alone")
        want = plugin.build_allocation(inv, [chip.index], 7,
                                       pod_uid="uid-early",
                                       usage_dir=usage_dir)
        check(alloc == want, f"Allocate gave {alloc}, want {want}")
        fake = kubelet.FakeKubelet(pdir)
        fake.start()
        servers = []
        try:
            servers = kubelet.run_node_daemon(DAEMON_NODE, api, inv,
                                              plugin_dir=pdir,
                                              usage_dir=usage_dir)
            endpoint = kubelet.socket_name(const.HBM_RESOURCE)
            registered = sorted(r.resource_name for r in fake.registrations)
            wire_devs = fake.snapshot_devices(endpoint)
            t0 = time.perf_counter()
            wire_ids = fake.preferred(endpoint, avail, 7)
            wire_preferred_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            resp = fake.allocate(endpoint, wire_ids)
            wire_allocate_ms = (time.perf_counter() - t0) * 1e3
        finally:
            for server in servers:
                server.stop()
            fake.stop()
    check(registered == sorted((const.HBM_RESOURCE, const.CHIP_RESOURCE)),
          f"kubelet saw {registered}")
    check(len(wire_devs) == inv.total_hbm_gib
          and {d.health for d in wire_devs} == {plugin.HEALTHY},
          f"ListAndWatch sent {len(wire_devs)} devices")
    check(wire_ids == ids, f"GetPreferredAllocation gave {wire_ids}")
    check(assigned("wire-early") and not assigned("wire-late")
          and not assigned("small"),
          "Allocate over gRPC did not commit the earlier pod alone")
    wire = wire_allocation(resp.container_responses[0])
    want = plugin.build_allocation(inv, [chip.index], 7,
                                   pod_uid="uid-wire-early",
                                   usage_dir=usage_dir)
    check(wire == want, f"Allocate over gRPC gave {wire}, want {want}")
    # (c) and (d).
    tenant = held_tenant_phase(wire, chip.hbm_gib, api, "wire-early",
                               usage_dir)
    return {"node_annotations": ann, "advertised_gib": len(devs),
            "registered": registered, "matched": "early",
            "wire_matched": "wire-early", "envs": wire.envs,
            "devices": [host for host, _ in wire.devices],
            "preferred_ms": preferred_ms, "allocate_ms": allocate_ms,
            "wire_preferred_ms": wire_preferred_ms,
            "wire_allocate_ms": wire_allocate_ms, **tenant}


class ServingTenant:
    """``python3 chip_smoke.py --held-tenant`` (phase 2d's tenant, held) in
    an allocation's env: :meth:`start` waits for its ``READY`` and returns
    the JSON it printed; :meth:`stop` closes its stdin, as kubelet kills
    the container, and returns its exit code. ``TENANT_DEADLINE_S`` bounds
    the wait for ``READY``. ``gated`` starts ``--gated-tenant`` instead:
    :meth:`launch` starts the process ahead of its grant, so its imports
    overlap other work, and :meth:`start` sends it ``GO``."""

    def __init__(self, alloc: plugin.ContainerAllocation,
                 gated: bool = False):
        self.alloc = alloc
        self.gated = gated
        self.proc = None
        self.err = None
        self.ready_s = None
        self.started_unix = None

    def launch(self) -> None:
        repo = os.path.dirname(os.path.abspath(__file__))
        self.err = tempfile.TemporaryFile(mode="w+", encoding="utf-8")
        self.started_unix = time.time()
        self.proc = subprocess.Popen(
            ["python3", os.path.join(repo, "chip_smoke.py"),
             GATED_TENANT_FLAG if self.gated else HELD_TENANT_FLAG],
            env=tenant_env(self.alloc), cwd=repo, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=self.err, text=True)

    def start(self) -> dict:
        t0 = time.perf_counter()
        if self.proc is None:
            self.launch()
        if self.gated:
            self.proc.stdin.write(cogpucheck.GO + "\n")
            self.proc.stdin.flush()
        deadline = threading.Timer(TENANT_DEADLINE_S, self.proc.kill)
        deadline.start()
        try:
            lines = []
            for line in self.proc.stdout:
                if line.strip() == cogpucheck.READY:
                    break
                lines.append(line)
        finally:
            deadline.cancel()
        self.ready_s = time.perf_counter() - t0
        self.err.seek(0)
        results = [ln for ln in lines if ln.startswith("{")]
        check(bool(results), f"the held tenant printed no result: "
                             f"{self.err.read()[-2000:]}")
        return json.loads(results[-1])

    def stop(self) -> int | None:
        if self.proc is None:
            return None
        try:
            self.proc.stdin.close()
        except OSError:
            pass
        try:
            self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.err.close()
        return self.proc.returncode


def held_tenant_phase(alloc: plugin.ContainerAllocation, card_gib: int,
                      api: FakeApiServer, pod: str, usage_dir: str,
                      node: str = DAEMON_NODE) -> dict:
    """Phase 2e (c) and (d): a :class:`ServingTenant` in ``alloc``'s env,
    held as phase 2d holds it, swept with the port's ``GrantWatchdog``
    while it holds the card, a second apart, until its heartbeat is
    fresh; ``daemon_sweep_gates`` must all hold. Releases the tenant and
    returns the phase's fields; ``launches`` is its forward count."""
    grant = int(alloc.envs[const.ENV_HBM_POD])
    tenant = ServingTenant(alloc)
    try:
        got = tenant.start()
        want_cap = round(grant / card_gib * torchenv.DEFAULT_HEADROOM, 3)
        check(got["device_count"] == 1 and got["cuda_visible_devices"] == "0"
              and got["cap"] == want_cap
              and got["launches"] == got["n_layers"] * got["prefills"],
              f"the daemon's tenant: {got}")
        wd = watchdog.GrantWatchdog(node, api, usage_dir=usage_dir)
        uid = api.get_pod("default", pod).uid
        for sweeps in range(1, DAEMON_SWEEPS + 1):
            sweep = wd.sweep()
            if daemon_sweep_gates(sweep, {}, uid, grant)["fresh"]:
                break
            time.sleep(1.0)
        apps = cogpucheck._compute_apps()
        annotations = api.get_pod("default", pod).annotations
        with open(alloc.envs[const.ENV_USAGE_FILE], encoding="utf-8") as f:
            beat = json.load(f)
    finally:
        code = tenant.stop()
    check(code == 0, f"the daemon's tenant exited {code}")
    gates = daemon_sweep_gates(sweep, annotations, uid, grant)
    check(all(gates.values()), f"sweep {sweep} with {annotations}: {gates}")
    check(set(beat) == HEARTBEAT_KEYS and beat["pid"] == got["pid"],
          f"the heartbeat {beat}")
    smi_mib = (apps or {}).get(got["pid"])
    [entry] = [t for t in sweep["tenants"] if t["uid"] == uid]
    return {"tenant": {k: got[k] for k in (
                "device_count", "cuda_visible_devices",
                "nvidia_visible_devices", "chip_ids", "cap", "launches",
                "prefills", "n_layers", "first_request_s", "request_s",
                "tok_per_s", "pid")},
            "launches": got["launches"], "ready_s": tenant.ready_s,
            "sweeps": sweeps, "sweep_entry": entry, "gates": gates,
            "pod_annotations": annotations,
            "heartbeat_bytes": beat["bytes_in_use"],
            "heartbeat_peak_bytes": beat["peak_bytes"],
            "nvidia_smi_apps_mib": apps,
            "nvidia_smi_mib": smi_mib if smi_mib is not None
            else "not visible",
            "smi_minus_heartbeat_bytes": (smi_mib << 20) - beat[
                "bytes_in_use"] if smi_mib is not None else "not visible"}


class ExtenderClient:
    """One keep-alive connection to the extender, as kube-scheduler's
    transport keeps one. ``post`` returns the status, the JSON body and
    the handler's ms from ``Server-Timing`` (handler and gate queue);
    ``last_bind`` holds the last bind's status and body,
    ``last_traceparent`` the last reply's ``traceparent`` header and
    ``sent`` the POSTs sent, by path."""

    def __init__(self, server):
        self.address = server.server_address[:2]
        self.conn = http.client.HTTPConnection(*self.address, timeout=60)
        self.prefix = "/tpushare-scheduler"
        #: The last bind's status and body (``schedule``); None before.
        self.last_bind: tuple[int, object] | None = None
        self.last_traceparent: str | None = None
        self.sent: collections.Counter = collections.Counter()

    def _send(self, method: str, path: str, **kw
              ) -> http.client.HTTPResponse:
        """One request on the kept connection, and its response. The
        server closes a connection idle past its socket timeout
        (``TPUSHARE_HTTP_TIMEOUT_S``, 30 s), unread: a request that finds
        it closed goes again on a new one, as kube-scheduler's transport
        sends it again."""
        try:
            self.conn.request(method, path, **kw)
            return self.conn.getresponse()
        except (http.client.RemoteDisconnected, ConnectionResetError,
                BrokenPipeError):
            self.conn.close()
            self.conn.request(method, path, **kw)
            return self.conn.getresponse()

    def post(self, path: str, doc: dict) -> tuple[int, object, float]:
        self.sent[path] += 1
        resp = self._send("POST", self.prefix + path,
                          body=json.dumps(doc).encode(),
                          headers={"Content-Type": "application/json"})
        body = json.loads(resp.read())
        self.last_traceparent = resp.getheader("traceparent")
        timing = {name.strip(): float(dur) for name, _, dur in (
            part.partition(";dur=")
            for part in (resp.getheader("Server-Timing") or "").split(","))
            if dur}
        return resp.status, body, sum(timing.values())

    def get(self, path: str, prefixed: bool = True) -> dict:
        resp = self._send("GET", (self.prefix if prefixed else "") + path)
        check(resp.status == 200, f"GET {path}: {resp.status}")
        return json.loads(resp.read())

    def text(self, path: str) -> bytes:
        """GET a path of the server's root; its body, which must be a
        200."""
        resp = self._send("GET", path)
        body = resp.read()
        check(resp.status == 200, f"GET {path}: {resp.status} {body[:200]}")
        return body

    def metrics(self) -> dict:
        """``/metrics``, parsed (``parse_metrics``)."""
        return parse_metrics(self.text("/metrics").decode())

    def decision(self, namespace: str, name: str) -> dict:
        """The pod's newest decision, ``/debug/trace/<ns>/<pod>``."""
        return self.get(f"/debug/trace/{namespace}/{name}", prefixed=False)

    def healthz(self) -> str:
        resp = self._send("GET", "/healthz")
        check(resp.status == 200, f"GET /healthz: {resp.status}")
        return resp.read().decode()

    def schedule(self, pod, candidates: list[str]
                 ) -> tuple[str | None, float, float]:
        """filter, prioritize over the nodes that passed, bind to the
        first of the best scores, as kube-scheduler does. Returns (the
        node bound, or None; the three handlers' ms; the wire's ms)."""
        t0 = time.perf_counter()
        status, passed, h_f = self.post("/filter", {
            "Pod": pod.raw, "NodeNames": candidates})
        check(status == 200, f"filter: {status} {passed}")
        if not passed["NodeNames"]:
            return None, h_f, (time.perf_counter() - t0) * 1e3
        status, ranked, h_p = self.post("/prioritize", {
            "Pod": pod.raw, "NodeNames": passed["NodeNames"]})
        check(status == 200, f"prioritize: {status} {ranked}")
        best = max(ranked, key=lambda e: e["Score"])["Host"]
        status, result, h_b = self.post("/bind", {
            "PodName": pod.name, "PodNamespace": pod.namespace,
            "PodUID": pod.uid, "Node": best})
        wire_ms = (time.perf_counter() - t0) * 1e3
        self.last_bind = (status, result)
        return (best if status == 200 else None), h_f + h_p + h_b, wire_ms

    def close(self) -> None:
        self.conn.close()


def parse_metrics(text: str) -> dict:
    """The samples of a text-format 0.0.4 body: ``{(name, labels):
    value}``, ``labels`` a sorted tuple of (name, value) pairs."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        # A bucket's OpenMetrics exemplar (``# {trace_id=...} v ts``).
        line = line.split(" # ", 1)[0]
        head, _, value = line.rpartition(" ")
        name, _, labels = head.partition("{")
        pairs = tuple(sorted(re.findall(r'(\w+)="((?:[^"\\]|\\.)*)"',
                                        labels)))
        out[(name, pairs)] = float(value)
    return out


def sample(samples: dict, name: str, **labels) -> float:
    """One sample of ``parse_metrics``' result; 0.0 for a labelled child
    never made (a counter that never counted)."""
    return samples.get((name, tuple(sorted(labels.items()))), 0.0)


def rise(after: dict, before: dict, name: str, **labels) -> float:
    return sample(after, name, **labels) - sample(before, name, **labels)


class Scraper:
    """A Prometheus server's view of the extender: a thread that GETs
    ``/metrics`` every ``every`` seconds over its own connection until
    :meth:`stop`, which scrapes once more and returns that last scrape,
    parsed. Keeps each scrape's ms, and the body's bytes and series."""

    def __init__(self, address, every: float = 1.0):
        self.conn = http.client.HTTPConnection(*address, timeout=60)
        self.every = every
        self.ms: list[float] = []
        self.bytes = self.series = 0
        self.error: BaseException | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="chip-smoke-scraper",
                                        daemon=True)
        self._thread.start()

    def scrape(self) -> str:
        t0 = time.perf_counter()
        self.conn.request("GET", "/metrics")
        resp = self.conn.getresponse()
        body = resp.read()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        check(resp.status == 200, f"a scrape: {resp.status} {body[:200]}")
        text = body.decode()
        self.bytes = len(body)
        self.series = sum(1 for line in text.splitlines()
                          if line and not line.startswith("#"))
        return text

    def _run(self) -> None:
        try:
            while not self._stop.wait(self.every):
                self.scrape()
        except BaseException as exc:  # noqa: BLE001 - raised in stop()
            self.error = exc

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join(60)
        try:
            if self.error is not None:
                raise self.error
            return parse_metrics(self.scrape())
        finally:
            self.conn.close()

    def abandon(self) -> None:
        """Stop without the last scrape (the run already failed)."""
        self._stop.set()
        self._thread.join(60)
        self.conn.close()

    def fields(self) -> dict:
        p50, _ = _percentiles(self.ms)
        return {"scrapes": len(self.ms), "scrape_p50_ms": p50,
                "scrape_max_ms": max(self.ms), "scrape_bytes": self.bytes,
                "scrape_series": self.series}


#: The fake's calls that are apiserver requests, with the HTTP method the
#: port's ApiClient sends for each.
_API_METHODS = {"get_pod": "GET", "list_pods": "GET", "update_pod": "PUT",
                "bind_pod": "POST", "delete_pod": "DELETE",
                "evict_pod": "POST", "get_node": "GET", "list_nodes": "GET",
                "update_node": "PUT", "create_event": "POST",
                "get_configmap": "GET", "list_pdbs": "GET"}


class WireTimedApi(FakeApiServer):
    """The port's fake apiserver, each request noted on the calling
    thread's open decision span (``trace.note_api_call``), as the port's
    ``ApiClient`` notes its HTTP round trips: a decision traced over the
    fake counts its apiserver requests as it would against a cluster."""


def _timed(name: str, method: str):
    call = getattr(FakeApiServer, name)

    def timed(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return call(self, *args, **kwargs)
        finally:
            ttrace.note_api_call(time.perf_counter() - t0, method, name)
    return timed


for _name, _method in _API_METHODS.items():
    setattr(WireTimedApi, _name, _timed(_name, _method))


def bound_trace_checks(api: FakeApiServer, client: ExtenderClient,
                       namespace: str, name: str, node: str,
                       positions: list[int], gib: int) -> dict:
    """A pod ``client.schedule`` just bound: its decision (``/debug/
    trace``) is ``bound`` on ``node`` with filter, prioritize and bind
    spans and, under bind at depth 1, an ``allocate`` span noting its
    cards and GiB with at least two apiserver requests (the grant's PUT
    and the binding); its ``trace-id`` annotation, the bind reply's
    ``traceparent`` and its ``TPUShareBound`` Event's ``[trace <id>]``
    name that decision."""
    doc = client.decision(namespace, name)
    tid = api.get_pod(namespace, name).annotations.get(const.ANN_TRACE_ID)
    check(tid == doc["traceId"], f"{name}'s trace-id {tid}, /debug/trace "
                                 f"{doc['traceId']}")
    check(doc["outcome"] == "bound" and doc["node"] == node,
          f"{name}'s decision: {doc['outcome']} on {doc['node']}")
    spans = [(s["phase"], s["depth"]) for s in doc["spans"]]
    for want in (("filter", 0), ("prioritize", 0), ("bind", 0)):
        check(want in spans, f"{name}'s spans {spans} lack {want}")
    at = spans.index(("bind", 0))
    check(spans[at + 1:at + 2] == [("allocate", 1)],
          f"{name}'s bind span holds no allocate span: {spans}")
    alloc = doc["spans"][at + 1]
    attrs = alloc.get("attrs", {})
    check(attrs.get("chips") == positions and attrs.get("hbmGiB") == gib
          and alloc["apiCalls"] >= 2, f"{name}'s allocate span: {alloc}")
    check(client.last_traceparent == ttrace.format_traceparent(tid),
          f"the bind's traceparent {client.last_traceparent}, id {tid}")
    check(tevents.flush(), "events did not flush")
    bound = [e["message"] for _, e in api.events
             if e["reason"] == tevents.REASON_BOUND
             and e["involvedObject"]["name"] == name]
    check(bound and bound[-1].endswith(f"[trace {tid}]"),
          f"{name}'s TPUShareBound Event: {bound}")
    return {"trace_id": tid, "spans": spans, "outcome": doc["outcome"],
            "allocate_api_calls": alloc["apiCalls"],
            "allocate_attrs": attrs,
            "traceparent": client.last_traceparent}


def advertised_node(name: str, inv: discovery.HostInventory) -> dict:
    """A Node as kubelet reports it once the daemon registered: capacity
    is the count of devices advertised for each resource."""
    counts = {const.HBM_RESOURCE: str(len(plugin.hbm_devices(inv))),
              const.CHIP_RESOURCE: str(len(plugin.chip_devices(inv)))}
    return {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": name},
            "status": {"capacity": counts, "allocatable": dict(counts)}}


def extender_fleet(api: FakeApiServer, nodes: int) -> list[str]:
    """``nodes`` H100 hosts of ``EXTENDER_FLEET_CARDS`` cards, each
    annotated by the port's plugin from its inventory."""
    inv = discovery.fake_inventory(chips=EXTENDER_FLEET_CARDS)
    names = [f"h100-{i:04d}" for i in range(nodes)]
    for name in names:
        api.create_node(advertised_node(name, inv))
        plugin.TPUSharePlugin(name, api, inv, usage_dir="").annotate_node()
    return names


def draw_shape(rng) -> tuple[str, int]:
    """``bench.py``'s ``_draw_shape`` over ``EXTENDER_SIZE_MIX``."""
    total = sum(w for _, _, w in EXTENDER_SIZE_MIX)
    roll = rng.uniform(0, total)
    for kind, size, w in EXTENDER_SIZE_MIX:
        roll -= w
        if roll <= 0:
            return kind, size
    return EXTENDER_SIZE_MIX[-1][0], EXTENDER_SIZE_MIX[-1][1]


def scale_candidates(rng, names: list[str]) -> list[str]:
    """``bench.py``'s ``_scale_candidates``: the nodes kube-scheduler
    offers an extender at this fleet size (its adaptive
    percentageOfNodesToScore, max(50 - n/125, 5)% with a 100-node
    floor); about 430 of 1,024, all of 16."""
    n = len(names)
    k = int(max(n * max(50.0 - n / 125.0, 5.0) / 100.0, min(100, n)))
    return list(names) if k >= n else rng.sample(names, k)


def ledger_checks(api: FakeApiServer, stack, client: ExtenderClient,
                  names: list[str]) -> dict:
    """Over ``names``: no card holds more than its GiB; inspect's used GiB
    equals the sum of the grants bound there (the ``hbm-pod`` of every
    live pod bound to a node of ``names``); a cache rebuilt from the
    apiserver, as after a restart, equals the live ledger."""
    wanted = set(names)
    doc = client.get("/inspect")
    nodes = [n for n in doc["nodes"] if n["name"] in wanted]
    over = [(n["name"], c["id"]) for n in nodes for c in n["chips"]
            if c["usedHBM"] > c["totalHBM"]]
    check(not over, f"cards over their GiB: {over[:8]}")
    used = sum(n["usedHBM"] for n in nodes)
    total = sum(n["totalHBM"] for n in nodes)
    granted = sum(podutils.get_hbm_from_pod_annotation(p)
                  for p in api.list_pods()
                  if p.node_name in wanted and podutils.is_assumed(p)
                  and not podutils.is_complete_pod(p))
    check(used == granted, f"inspect says {used} GiB used, the bound "
                           f"grants {granted}")
    rebuilt = SchedulerCache(api.get_node, api.list_pods)
    rebuilt.build()
    live = stack.controller.cache
    differ = [n for n in names if rebuilt.get_node_info(n).get_available_hbm()
              != live.get_node_info(n).get_available_hbm()]
    check(not differ, f"rebuilt ledger differs on {differ[:8]}")
    return {"used_gib": used, "total_gib": total, "granted_gib": granted}


def pod_e2e_p99_s(after: dict, before: dict) -> float | None:
    """p99 of ``tpushare_pod_e2e_scheduling_seconds`` over the journeys
    closed between two scrapes, as ``bench.py``'s ``_pod_e2e_p99_s``
    reads it: the buckets' counts summed across tenants and outcomes, and
    the first bucket bound holding 99% of them; None when none closed."""
    family = "tpushare_pod_e2e_scheduling_seconds"
    buckets: dict[float, float] = {}
    total = 0.0
    for (name, labels), value in after.items():
        grown = value - before.get((name, labels), 0.0)
        if name == family + "_bucket":
            le = float(dict(labels)["le"])
            buckets[le] = buckets.get(le, 0.0) + grown
        elif name == family + "_count":
            total += grown
    if total <= 0:
        return None
    want = 0.99 * total
    for le in sorted(buckets):
        if buckets[le] >= want:
            return le
    return float("inf")


def churn_gates(after: dict, before: dict, stack) -> dict:
    """Phase 2f's journey and fragmentation numbers, as ``bench.py
    --scale`` reads them after its churn: the churn's ``pod_e2e_p99_s``,
    and ``stranded_hbm_ratio``, the frag index of the ledger against the
    filter verb's ``DemandTracker`` shapes over the fleet's GiB; each
    beside the reference's gate and whether it passes (recorded, not
    enforced)."""
    p99 = pod_e2e_p99_s(after, before)
    infos = stack.controller.cache.sharing_node_infos()
    report = tfrag.cluster_report(infos, stack.predicate.demand.shapes())
    total = sum(i.total_hbm for i in infos)
    ratio = report["strandedHBM"] / total if total else 0.0
    return {"pod_e2e_p99_s": p99, "stranded_hbm_ratio": ratio,
            "stranded_hbm_gib": report["strandedHBM"],
            "journey_gates": {
                "pod_e2e_p99_s": {"value": p99,
                                  "limit": GATE_POD_E2E_P99_S,
                                  "pass": p99 is None
                                  or p99 <= GATE_POD_E2E_P99_S},
                "stranded_hbm_ratio": {"value": ratio,
                                       "limit": GATE_STRANDED_RATIO,
                                       "pass": ratio <= GATE_STRANDED_RATIO}}}


def _percentiles(xs: list[float]) -> tuple[float, float]:
    """p50 and p99, nearest rank."""
    ordered = sorted(xs)
    if not ordered:
        return 0.0, 0.0
    rank = lambda q: ordered[min(len(ordered) - 1,
                                 max(0, math.ceil(q * len(ordered)) - 1))]
    return rank(0.50), rank(0.99)


def extender_churn(api: FakeApiServer, stack, client: ExtenderClient,
                   names: list[str], target: int = EXTENDER_BOUND,
                   seed: int = EXTENDER_SEED,
                   scrape_every: float | None = 1.0) -> dict:
    """``bench.py``'s scale churn (``bench_scale``) over ``names``: each
    round the pods past their TTL succeed, max(n/2, 48) pods of
    ``EXTENDER_SIZE_MIX`` arrive, and up to twice that many of the
    backlog are scheduled over HTTP on the candidates
    ``scale_candidates`` offers, until ``target`` pods are bound. A
    ``Scraper`` GETs ``/metrics`` every ``scrape_every`` seconds
    throughout (None: never) and once at the end; then
    ``tpushare_filter_requests_total`` and the three verbs' latency
    ``_count``s must have risen by the requests sent, the node
    gauges ``tpushare_node_hbm_used_gib`` of ``names`` must sum to the
    ledger's used GiB, and ``/debug/flight`` must hold 256 decisions with
    no recording drop. Returns p50 and p99 of filter + prioritize + bind
    on the handlers' clock and on the wire's, the pods bound, the mean
    GiB utilisation from round 2 on, the final ``ledger_checks``, the
    scrapes' ms, bytes and series, and ``churn_gates``."""
    rng = random.Random(seed)
    before, sent0 = client.metrics(), dict(client.sent)
    scraper = Scraper(client.address, scrape_every) if scrape_every else None
    try:
        arrivals = max(len(names) // 2, 48)
        backlog, live, handler_ms, wire_ms, util = [], [], [], [], []
        seq = bound = rounds = 0
        t0 = time.perf_counter()
        while bound < target and rounds < EXTENDER_MAX_ROUNDS:
            rnd, rounds = rounds, rounds + 1
            still = []
            for name, expires in live:
                if expires <= rnd:
                    api.update_pod_status("default", name, "Succeeded")
                else:
                    still.append((name, expires))
            live = still
            check(stack.controller.wait_idle(timeout=120),
                  "the extender's controller did not settle")
            for _ in range(arrivals):
                kind, size = draw_shape(rng)
                name = f"churn-{seq:05d}"
                seq += 1
                pod = api.create_pod(make_pod(name, chips=size)
                                     if kind == "chip" else
                                     make_pod(name, hbm=size))
                backlog.append((pod, rng.randint(*EXTENDER_TTL_ROUNDS)))
            kept = []
            for i, (pod, ttl) in enumerate(backlog):
                if i >= 2 * arrivals or bound >= target:
                    kept.extend(backlog[i:])
                    break
                node, h_ms, w_ms = client.schedule(
                    pod, scale_candidates(rng, names))
                if node is None:
                    kept.append((pod, ttl))
                    continue
                handler_ms.append(h_ms)
                wire_ms.append(w_ms)
                bound += 1
                live.append((pod.name, rnd + ttl))
            backlog = kept
            doc = client.get("/inspect")
            if rnd >= 2:
                util.append(100.0 * sum(n["usedHBM"] for n in doc["nodes"]
                                        if n["name"] != EXTENDER_NODE)
                            / sum(n["totalHBM"] for n in doc["nodes"]
                                  if n["name"] != EXTENDER_NODE))
        seconds = time.perf_counter() - t0
        check(bound >= target, f"the churn bound {bound} pods in {rounds} "
                               f"rounds, not {target}")
        check(stack.controller.wait_idle(timeout=120),
              "the extender's controller did not settle")
    except BaseException:
        if scraper is not None:
            scraper.abandon()
        raise
    after = scraper.stop() if scraper is not None else client.metrics()
    h50, h99 = _percentiles(handler_ms)
    w50, w99 = _percentiles(wire_ms)
    ledger = ledger_checks(api, stack, client, names)
    sent = {p: client.sent[p] - sent0.get(p, 0)
            for p in ("/filter", "/prioritize", "/bind")}
    counted = {"/filter": rise(after, before,
                               "tpushare_filter_requests_total")}
    for verb in ("filter", "prioritize", "bind"):
        counted[f"{verb}_count"] = rise(
            after, before, f"tpushare_{verb}_latency_seconds_count")
    check(counted == {"/filter": sent["/filter"],
                      **{f"{p[1:]}_count": n for p, n in sent.items()}},
          f"/metrics counted {counted}, the churn sent {sent}")
    wanted = set(names)
    gauged = sum(v for (n, labels), v in after.items()
                 if n == "tpushare_node_hbm_used_gib"
                 and dict(labels).get("node") in wanted)
    check(gauged == ledger["used_gib"],
          f"tpushare_node_hbm_used_gib sums to {gauged}, the ledger "
          f"{ledger['used_gib']}")
    flight = client.get("/debug/flight", prefixed=False)
    check(len(flight["decisions"]) == ttrace.DEFAULT_CAPACITY
          and flight["recordingDrops"] == 0,
          f"/debug/flight holds {len(flight['decisions'])} decisions, "
          f"{flight['recordingDrops']} drops")
    gates = churn_gates(after, before, stack)
    return {"nodes": len(names), "bound": bound, "rounds": rounds,
            "backlog": len(backlog), "seconds": seconds,
            "handler_p50_ms": h50, "handler_p99_ms": h99,
            "wire_p50_ms": w50, "wire_p99_ms": w99,
            "gib_utilisation_pct": (sum(util) / len(util) if util
                                    else 0.0),
            "sent": sent, "metrics_gib_used": gauged,
            "flight_decisions": len(flight["decisions"]),
            **(scraper.fields() if scraper is not None else {}), **ledger,
            **gates}


def exemplars(text: str, verb: str) -> list[tuple[str, str]]:
    """(``le``, trace id) of each ``tpushare_<verb>_latency_seconds``
    bucket line of a ``/metrics`` body that carries an OpenMetrics
    exemplar."""
    return re.findall(rf'^tpushare_{verb}_latency_seconds_bucket'
                      rf'\{{le="([^"]+)"\}} \S+ # \{{trace_id="([^"]+)"\}}',
                      text, flags=re.M)


def timeline(client: ExtenderClient, query: str = "") -> dict:
    """``/debug/timeline``, with ``query`` (``window=...&series=...``)."""
    return client.get("/debug/timeline" + (f"?{query}" if query else ""),
                      prefixed=False)


def markers_of(doc: dict, kind: str) -> list[dict]:
    return [m for m in doc["markers"] if m["kind"] == kind]


@contextlib.contextmanager
def _env(**values):
    """``os.environ`` with ``values`` (None unsets), put back after."""
    prior = {k: os.environ.get(k) for k in values}
    try:
        for key, val in values.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val
        yield
    finally:
        for key, val in prior.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val


def extender_restart(api: FakeApiServer, stack, server,
                     client: ExtenderClient, names: list[str],
                     traced: dict, position: int, journal: str) -> tuple:
    """Phase 2f (e'): the extender restarts over the fleet it has. The
    first stack stops (``shutdown_stack``, then ``obs.stop``, which
    drains, fsyncs and closes the journal), and ``trace.reset`` and
    ``obs.reset`` stand in for the process boundary; a second
    ``serve_stack`` over the same apiserver and journal directory must
    then resolve the tenant's decision (``/debug/trace?id=``) restored
    from the journal, ``bound`` on the card's node with the spans it had;
    end its timeline in a ``restart`` marker whose ``replayed`` counts the
    journal's records, after the first stack's markers; report its
    journal armed and replayed with no drop; and rebuild the live ledger
    (``ledger_checks``, the tenant's GiB on its card in inspect). Returns
    (the new stack, server and client, the leg's fields); ``restart_s``
    runs from the second ``serve_stack`` to its first 200 on
    ``/debug/timeline``."""
    client.close()
    extender_main.shutdown_stack(stack, server)
    tobs.stop()
    frames = len(tobs.replay(journal))
    ttrace.reset()
    tobs.reset()
    t0 = time.perf_counter()
    stack, server = extender_main.serve_stack(api)
    client = ExtenderClient(server)
    doc = timeline(client)
    restart_s = time.perf_counter() - t0
    tid = traced["trace_id"]
    chain = client.get(f"/debug/trace?id={tid}", prefixed=False)
    target = chain["target"]
    spans = [(s["phase"], s["depth"]) for s in target["spans"]]
    check(target["traceId"] == tid and target.get("restored") is True
          and target["outcome"] == "bound"
          and target["node"] == EXTENDER_NODE
          and spans == [tuple(s) for s in traced["spans"]],
          f"the restarted extender's decision {tid}: {target}")
    last = doc["markers"][-1]
    check(last["kind"] == "restart"
          and last["attrs"] == {"replayed": str(frames)},
          f"the restart marker: {last}, the journal held {frames} frames")
    before = [m for m in doc["markers"] if m["cursor"] < last["cursor"]]
    check(any(m["kind"] == "restart" and m["attrs"]["replayed"] == "0"
              for m in before),
          f"the first stack's markers are not before the restart: "
          f"{doc['markers']}")
    box = client.get("/debug/blackbox", prefixed=False)
    journal_doc = box["journal"] or {}
    check(box["armed"] and box["replayed"]
          and len(journal_doc.get("segments", [])) >= 1
          and journal_doc.get("drops") == 0,
          f"/debug/blackbox after the restart: {box}")
    check(stack.controller.wait_idle(timeout=120),
          "the restarted extender's controller did not settle")
    ledger = ledger_checks(api, stack, client, [EXTENDER_NODE, *names])
    [card] = [c for n in client.get(f"/inspect/{EXTENDER_NODE}")["nodes"]
              for c in n["chips"] if c["id"] == position]
    check(card["usedHBM"] == EXTENDER_TENANT_GIB,
          f"inspect after the restart, the tenant's card: {card}")
    return stack, server, client, {
        "restart_s": restart_s, "replayed": frames,
        "restored_trace": tid, "restored_spans": spans,
        "markers_before": [m["kind"] for m in before],
        "segments": len(journal_doc["segments"]),
        "frames_written": journal_doc.get("framesWritten"),
        "ledger_used_gib": ledger["used_gib"]}


def extender_timeline_checks(api: FakeApiServer, client: ExtenderClient,
                             fleet_nodes: int) -> dict:
    """Phase 2f after the churn: the timeline holds the fleet's size and
    the filter and bind p99 series, ``fleet_nodes`` last reading
    ``fleet_nodes``; every exemplar on the bind family names the trace
    id of a pod the apiserver has bound; the scrape declares the
    retrospective layer's families. Returns the timeline's drops and the
    anomaly firings by rule (recorded, not gated)."""
    wanted = ("fleet_nodes", "fleet_nodes_ready", "verb_p99_ms:filter",
              "verb_p99_ms:bind")
    query = "series=" + ",".join(wanted)
    # A churn shorter than a sampler tick (the CPU tests') waits for one.
    _until(lambda: all(s in timeline(client, query)["series"]
                       for s in wanted),
           2 * timeline(client)["intervalSeconds"] + 1.0,
           f"the timeline's {wanted}", every=0.05)
    doc = timeline(client, query)
    check(doc["series"]["fleet_nodes"]["last"] == fleet_nodes,
          f"fleet_nodes reads {doc['series']['fleet_nodes']['last']}")
    text = client.text("/metrics").decode()
    bound = {p.annotations.get(const.ANN_TRACE_ID) for p in api.list_pods()
             if p.node_name}
    binds = exemplars(text, "bind")
    strays = [tid for _, tid in binds if tid not in bound]
    check(binds and not strays, f"bind exemplars {binds}: {strays} name "
                                f"no pod bound in the apiserver")
    absent = [fam for fam in TIMELINE_FAMILIES
              if f"# TYPE {fam} " not in text]
    check(not absent, f"/metrics lacks {absent}")
    return {"timeline_drops": doc["drops"],
            "anomalies_fired": doc["anomalies"]["fired"],
            "bind_exemplars": len(binds),
            "series_last": {s: doc["series"][s]["last"] for s in wanted}}


def notready_leg(api: FakeApiServer, client: ExtenderClient,
                 node: str, fleet_nodes: int) -> dict:
    """Phase 2f (f'): a fleet node's ``Ready`` condition turns ``False``
    in the apiserver: one ``node-notready`` marker naming it, one
    ``TPUShareNodeNotReady`` Warning Event whose ``[timeline <cursor>]``
    is that marker's, and ``fleet_nodes_ready`` one below
    ``fleet_nodes`` within ``NOTREADY_TICKS`` sampler ticks."""
    t0 = time.perf_counter()
    doc = api.get_node(node)
    doc.raw.setdefault("status", {})["conditions"] = [
        {"type": "Ready", "status": "False", "reason": "KubeletNotReady"}]
    api.update_node(doc)
    _until(lambda: markers_of(timeline(client), "node-notready"), 30,
           "the node-notready marker", every=0.05)
    marked = markers_of(timeline(client), "node-notready")
    check(len(marked) == 1 and marked[0]["attrs"] == {"node": node},
          f"node-notready markers: {marked}")
    check(tevents.flush(), "events did not flush")
    warned = [e for _, e in api.events
              if e["reason"] == tevents.REASON_NODE_NOTREADY]
    check(len(warned) == 1 and warned[0]["type"] == "Warning"
          and warned[0]["message"].endswith(
              f"[timeline {marked[0]['cursor']}]"),
          f"NotReady Events: {warned}")
    budget = NOTREADY_TICKS * timeline(client)["intervalSeconds"]
    _until(lambda: timeline(client, "series=fleet_nodes_ready")["series"]
           .get("fleet_nodes_ready", {}).get("last") == fleet_nodes - 1,
           max(t0 + budget - time.perf_counter(), 0.0),
           f"fleet_nodes_ready one below the fleet, {NOTREADY_TICKS} "
           f"sampler ticks after the update", every=0.05)
    ready_s = time.perf_counter() - t0
    return {"node": node, "cursor": marked[0]["cursor"],
            "event": warned[0]["message"], "ready_drop_s": ready_s,
            "seconds": time.perf_counter() - t0}


def arm_profiler() -> object:
    """Arm the port's continuous profiler over phase 2f's churns, as
    ``bench.py --scale`` arms it and the deployed ``main`` does by
    default (``profiling.reset(); profiling.start()``), the contention
    registry emptied with it. Returns the ``SIGPROF`` handler it
    replaced, for ``disarm_profiler``."""
    handler = signal.getsignal(signal.SIGPROF)
    tlocks.reset_contention()
    tprofiling.reset()
    check(tprofiling.start(), "the continuous profiler was armed already")
    return handler


def disarm_profiler(handler: object) -> dict:
    """``profiling.stop()``; then no ``ITIMER_PROF`` may be left firing
    into the phases that follow in this process (gRPC, gloo, NCCL,
    CUDA), and ``SIGPROF``'s handler must be ``handler`` again."""
    tprofiling.stop()
    timer = signal.getitimer(signal.ITIMER_PROF)
    check(timer == (0.0, 0.0), f"ITIMER_PROF still set: {timer}")
    check(signal.getsignal(signal.SIGPROF) == handler,
          f"SIGPROF's handler is {signal.getsignal(signal.SIGPROF)}, "
          f"not {handler} as before the churns")
    return {"itimer_prof": list(timer), "sigprof_restored": True}


def _fetch(address, path: str) -> tuple[int, str, bytes]:
    """GET ``path`` over a connection of its own: status, Content-Type,
    body."""
    conn = http.client.HTTPConnection(*address, timeout=120)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type") or "", resp.read()
    finally:
        conn.close()


def attribution_share(verbs: dict) -> float:
    """``bench.py``'s attribution arithmetic over ``/debug/hotspots``'
    verbs: the scheduling verbs' coverage, weighted by each verb's
    profiled seconds (the decision probe) or estimated seconds (the
    sampler)."""
    sched = {v: d for v, d in verbs.items()
             if v in ("filter", "prioritize", "bind", "preempt")}
    weight = lambda d: float(d.get("profiledSeconds")
                             or d.get("estSeconds") or 0)
    total = sum(weight(d) for d in sched.values())
    return (sum(weight(d) * d["coverage"] for d in sched.values()) / total
            if total else 0.0)


def ledger_metrics_checks(client: ExtenderClient) -> dict:
    """After a churn, the extender idle: the cost ledger's decisions for
    each verb equal ``tpushare_verb_decisions_total{verb}`` on a scrape,
    and every ``tpushare_verb_*`` split of the ledger's snapshot is the
    scrape's sample, verb for verb. Returns the snapshot."""
    scraped = client.metrics()
    ledger = tprofiling.ledger().snapshot()
    for verb in PROFILE_VERBS:
        check(ledger.get(verb, {}).get("decisions", 0) > 0,
              f"the cost ledger counted no {verb}: {ledger}")
    for key, family in LEDGER_FAMILIES.items():
        got = {dict(labels)["verb"]: v for (n, labels), v in scraped.items()
               if n == family}
        want = {verb: float(row[key]) for verb, row in ledger.items()}
        check(got == want, f"{family} scraped {got}, the ledger {want}")
    return ledger


def mutex_profile_checks(client: ExtenderClient) -> dict:
    """``/debug/pprof/mutex`` renders exactly ``locks.
    contention_snapshot()``: read between two equal snapshots (a
    background thread may contend in between; then it is read again).
    Returns the sites with their count and seconds."""
    for _ in range(5):
        snap = tlocks.contention_snapshot()
        body = client.text("/debug/pprof/mutex").decode()
        want = tlocks.render_mutex_profile()
        if tlocks.contention_snapshot() == snap:
            break
    else:
        check(False, "the contention registry never held still")
    check(body == want, f"/debug/pprof/mutex: {body[:400]!r}, the "
                        f"registry renders {want[:400]!r}")
    return {site: {"count": c, "seconds": w}
            for site, (c, w) in sorted(snap.items(), key=lambda kv: -kv[1][1])}


def pprof_checks(client: ExtenderClient, server) -> dict:
    """The pprof suite of the churned stack, the profiler armed:
    ``/debug/pprof/profile?seconds=1`` gives collapsed stacks naming the
    port's HTTP workers (``_http_worker``, ``server.py``) while a second,
    overlapping profile answers 409; ``/debug/pprof/trace?seconds=1``
    parses as JSON; ``/debug/pprof/heap?stop=1`` answers 200 and leaves
    ``tracemalloc`` stopped; ``/debug/threads`` names every HTTP worker
    of ``server``."""
    import tracemalloc

    first: dict = {}
    t = threading.Thread(target=lambda: first.update(got=_fetch(
        client.address, "/debug/pprof/profile?seconds=1&hz=100")),
        name="chip-smoke-profile", daemon=True)
    t.start()
    _until(lambda: tpprof._profile_lock._owner is not None or not
           t.is_alive(), 10, "the first CPU profile to start")
    busy, _, busy_body = _fetch(client.address,
                                "/debug/pprof/profile?seconds=1")
    t.join(60)
    status, ctype, profile = first["got"]
    text = profile.decode()
    stacks = [ln for ln in text.splitlines()[1:] if ln]
    check(status == 200 and ctype.startswith("text/plain")
          and text.startswith("# collapsed-stack profile:")
          and any("_http_worker (server.py:" in ln for ln in stacks),
          f"/debug/pprof/profile: {status} {ctype} {text[:400]!r}")
    check(busy == 409, f"an overlapping profile answered {busy} "
                       f"{busy_body[:200]!r}")
    status, ctype, body = _fetch(client.address,
                                 "/debug/pprof/trace?seconds=1")
    events = json.loads(body)["traceEvents"]
    check(status == 200 and ctype == "application/json" and events,
          f"/debug/pprof/trace: {status} {ctype} {len(events)} events")
    status, _, heap = _fetch(client.address, "/debug/pprof/heap?stop=1")
    check(status == 200 and not tracemalloc.is_tracing(),
          f"/debug/pprof/heap?stop=1: {status}, tracing "
          f"{tracemalloc.is_tracing()}")
    dump = client.text("/debug/threads").decode()
    workers = [t.name for t in server._http_threads]
    check(workers and all(f"--- {w} (" in dump for w in workers),
          f"/debug/threads names {dump.count('--- ')} threads, not the "
          f"workers {workers}")
    return {"profile_stacks": len(stacks), "profile_bytes": len(profile),
            "overlap_status": busy, "trace_events": len(events),
            "heap_stop": heap.decode().strip(), "threads_named":
            len(workers)}


def profiler_legs(client: ExtenderClient, server) -> dict:
    """Phase 2f's profiling legs on the churned stack, the profiler
    armed since before the churn: the profiler's status (driver, passes,
    ``overhead_ratio``, drops), the ledger's ``verbCosts`` for filter,
    prioritize and bind, held to ``/metrics`` (``ledger_metrics_checks``),
    ``/debug/hotspots`` (an entry for each verb, the top five frames of
    every bucket, ``other`` and ``idle`` included; the attribution share
    at ``top=100`` beside 0.90, recorded, not gated),
    ``/debug/profile/continuous``' lines and bytes, the mutex profile
    (``mutex_profile_checks``) and the pprof suite (``pprof_checks``)."""
    t0 = time.perf_counter()
    ledger = ledger_metrics_checks(client)
    hot = client.get(f"/debug/hotspots?top={PROFILE_ATTRIBUTION_TOP}"
                     "&window=3600", prefixed=False)
    for verb in PROFILE_VERBS:
        check(verb in hot["verbs"], f"/debug/hotspots has no {verb}: "
                                    f"{sorted(hot['verbs'])}")
    check(hot["verbCosts"] == ledger,
          f"/debug/hotspots' verbCosts {hot['verbCosts']}, the ledger "
          f"{ledger}")
    share = attribution_share(hot["verbs"])
    continuous = client.text("/debug/profile/continuous?window=3600")
    check(continuous.startswith(b"# continuous-profile:"),
          f"/debug/profile/continuous: {continuous[:200]!r}")
    mutex = mutex_profile_checks(client)
    pprof = pprof_checks(client, server)
    status = tprofiling.profiler().status()
    return {"driver": status["driver"],
            "sampling_passes": status["samplingPasses"],
            "overhead_ratio": status["overheadRatio"],
            "drops": status["drops"],
            "decision_drops": tprofiling.decisions().drops,
            "recording_drops": ttrace.recorder().drops.value,
            "verb_costs": {v: ledger[v] for v in PROFILE_VERBS},
            "engines": {v: hot["verbs"][v].get("engine")
                        for v in PROFILE_VERBS},
            "top_frames": {v: [[f["frame"], f["share"]]
                               for f in d["frames"][:5]]
                           for v, d in sorted(hot["verbs"].items())},
            "attribution": share,
            "attribution_pass": share >= PROFILE_ATTRIBUTION,
            "continuous_lines": continuous.count(b"\n") + 1,
            "continuous_bytes": len(continuous),
            "mutex_sites": mutex, **pprof,
            "legs_s": time.perf_counter() - t0}


def tenant_lock_wait(client: ExtenderClient, name: str) -> list:
    """The tenant's decision's spans: phase, ``lockWaitSeconds`` and any
    ``worstLockSite``."""
    doc = client.decision("default", name)
    return [{"phase": s["phase"], "lockWaitSeconds": s["lockWaitSeconds"],
             "worstLockSite": s.get("attrs", {}).get("worstLockSite")}
            for s in doc["spans"]]


def extender_phase(inv: discovery.HostInventory, usage_dir: str,
                   fleet: int = EXTENDER_FLEET,
                   target: int = EXTENDER_BOUND) -> dict:
    """Phase 2f: (a) the port's ``serve_stack`` over the port's
    ``FakeApiServer``, HTTP on 127.0.0.1, its black-box journal armed in
    a directory of the phase's own and its ``obs`` reset; (b) the port's
    plugin annotates the card's node from phase 0's inventory and
    ``fleet`` H100 nodes beside it; (c) a ``EXTENDER_TENANT_GIB`` GiB pod
    placed on the card's node as kube-scheduler places it, filter
    (offered the card's node alone, as a ``nodeSelector`` would),
    prioritize, bind, the bind bucket of ``/metrics`` carrying its trace
    id as an exemplar; (d) the port's daemon, over gRPC to a
    ``FakeKubelet``, matches and commits that very pod and answers with
    ``build_allocation``'s response for the card the extender chose; (e)
    the tenant serves the flagship in that response's env, ``n_layers``
    forward launches a prefill, its heartbeat fresh and within its grant
    (``held_tenant_phase``); (e') the extender restarts and replays the
    tenant's decision from the journal (``extender_restart``), which is
    then disarmed; (f) ``extender_churn`` binds ``target`` pods on the
    fleet on the second stack, with the interpreter's GC thresholds, the
    timeline on and the continuous profiler armed (``arm_profiler``), as
    ``bench.py --scale`` runs its churn; then ``profiler_legs`` and
    ``extender_timeline_checks``; (f') a fleet node goes NotReady
    (``notready_leg``); (g) ``gc_posture_churn`` runs the churn again on
    a fresh fleet under the reference extender's GC posture, the
    profiler still armed, which ``disarm_profiler`` then stops. The
    tenant's decision's lock waits are reported. The tenant's
    decision trace and the metrics of its bind are checked on the way
    (``bound_trace_checks``; the fake is a ``WireTimedApi``, so the
    allocate span counts its apiserver requests)."""
    api = WireTimedApi()
    journal = tempfile.mkdtemp(prefix="chip_smoke-journal-")
    tobs.reset()
    try:
        with _env(TPUSHARE_BLACKBOX_DIR=journal):
            stack, server = extender_main.serve_stack(api)
            client = ExtenderClient(server)
            try:
                first = extender_first_stack(api, stack, client, inv,
                                             usage_dir, fleet)
                names = first["names"]
                stack, server, client, restart = extender_restart(
                    api, stack, server, client, names, first["traced"],
                    first["position"], journal)
            except BaseException:
                client.close()
                extender_main.shutdown_stack(stack, server)
                raise
        # (f) The churn on the second stack: timeline on, journal off,
        # the continuous profiler armed over it and over (g).
        handler = arm_profiler()
        try:
            try:
                tobs.stop_blackbox()
                churn = extender_churn(api, stack, client, names,
                                       target=target)
                profiled = profiler_legs(client, server)
                watched = extender_timeline_checks(api, client,
                                                   len(names) + 1)
                t0 = time.perf_counter()
                notready = notready_leg(api, client, names[0],
                                        len(names) + 1)
                notready["leg_s"] = time.perf_counter() - t0
            finally:
                client.close()
                extender_main.shutdown_stack(stack, server)
            # (g) The same churn under the reference extender's GC
            # posture.
            posture = gc_posture_churn(fleet, target)
            profiled["after_gc_posture"] = tprofiling.profiler().status()
            profiled["verb_costs_both_churns"] = {
                v: row for v, row in tprofiling.ledger().snapshot().items()
                if v in PROFILE_VERBS}
        finally:
            disarmed = disarm_profiler(handler)
    finally:
        tobs.stop_blackbox()
        shutil.rmtree(journal, ignore_errors=True)
    profiled.update(disarmed)
    return {"tenant_node": first["node"], "tenant_card": first["card"],
            "tenant_position": first["position"],
            "tenant_trace": first["traced"],
            "tenant_handler_ms": first["handler_ms"],
            "tenant_wire_ms": first["wire_ms"],
            "tenant_bind_exemplar": first["exemplar"],
            "committed": first["committed"], "envs": first["envs"],
            "fleet_seconds": first["fleet_s"], "restart": restart,
            "tenant_lock_wait": first["lock_wait"],
            "churn": churn, "profiler": profiled, "timeline": watched,
            "notready": notready, "churn_gc_posture": posture,
            **first["served"]}


def extender_first_stack(api: FakeApiServer, stack,
                         client: ExtenderClient,
                         inv: discovery.HostInventory, usage_dir: str,
                         fleet: int) -> dict:
    """Phase 2f (b) to (e) on the first stack (see ``extender_phase``)."""
    before = client.metrics()
    # (b) The card's node, then the fleet.
    api.create_node(advertised_node(EXTENDER_NODE, inv))
    with tempfile.TemporaryDirectory(prefix="chip_smoke-ext-") as pdir:
        plug = plugin.TPUSharePlugin(EXTENDER_NODE, api, inv,
                                     state_dir=pdir, usage_dir=usage_dir)
        plug.annotate_node()
        t0 = time.perf_counter()
        names = extender_fleet(api, fleet)
        fleet_s = time.perf_counter() - t0
        check(stack.controller.wait_idle(timeout=120),
              "the extender's controller did not settle")
        # (c) The tenant, placed through the three verbs.
        tenant = api.create_pod(make_pod(
            "extender-tenant", hbm=EXTENDER_TENANT_GIB,
            uid="uid-extender-tenant"))
        node, handler_ms, wire_ms = client.schedule(tenant,
                                                    [EXTENDER_NODE])
        check(node == EXTENDER_NODE, f"the tenant was bound to {node}")
        placed = api.get_pod("default", tenant.name)
        position = podutils.get_chip_ids_from_annotation(placed)
        check(placed.node_name == EXTENDER_NODE and len(position) == 1
              and placed.annotations[const.ANN_HBM_POD]
              == str(EXTENDER_TENANT_GIB)
              and not podutils.is_assigned(placed),
              f"the bound tenant: {placed.raw}")
        traced = bound_trace_checks(api, client, "default", tenant.name,
                                    EXTENDER_NODE, position,
                                    EXTENDER_TENANT_GIB)
        text = client.text("/metrics").decode()
        after = parse_metrics(text)
        gauged = sample(after, "tpushare_node_hbm_used_gib",
                        node=EXTENDER_NODE)
        binds = rise(after, before, "tpushare_bind_latency_seconds_count")
        check(gauged == EXTENDER_TENANT_GIB
              and binds == client.sent["/bind"],
              f"/metrics: {gauged} GiB used on the card's node, "
              f"{binds} binds of {client.sent['/bind']} sent")
        # The only bind so far: its bucket names its trace id.
        exemplar = exemplars(text, "bind")
        check(len(exemplar) == 1 and exemplar[0][1] == traced["trace_id"],
              f"bind exemplars {exemplar}, the tenant's trace id "
              f"{traced['trace_id']}")
        traced.update(hbm_used_gib=gauged, binds_counted=binds)
        lock_wait = tenant_lock_wait(client, tenant.name)
        chip = inv.chips[position[0]]
        # (d) The daemon's Allocate over gRPC.
        grants = NodeGrants(EXTENDER_NODE, api, inv, pdir, usage_dir)
        try:
            wire, _ = grants.allocate(tenant.name, EXTENDER_TENANT_GIB)
        finally:
            grants.close()
    ids = grants.held[tenant.name]
    check(ids == [plugin.HBM_DEV_FMT.format(chip=chip.index, gib=g)
                  for g in range(EXTENDER_TENANT_GIB)],
          f"GetPreferredAllocation gave {ids}")
    check(podutils.is_assigned(api.get_pod("default", tenant.name)),
          "the daemon did not commit the pod the extender bound")
    want = plugin.build_allocation(inv, [chip.index], EXTENDER_TENANT_GIB,
                                   pod_uid=tenant.uid, usage_dir=usage_dir)
    check(wire == want, f"Allocate over gRPC gave {wire}, want {want}")
    # (e) The tenant on the card.
    served = held_tenant_phase(wire, chip.hbm_gib, api, tenant.name,
                               usage_dir, node=EXTENDER_NODE)
    return {"names": names, "node": node, "card": chip.index,
            "position": position[0], "traced": traced,
            "handler_ms": handler_ms, "wire_ms": wire_ms,
            "exemplar": exemplar[0], "committed": tenant.name,
            "envs": wire.envs, "fleet_s": fleet_s, "served": served,
            "lock_wait": lock_wait}


def _probe_batch(client: ExtenderClient, names: list[str], rng, pod,
                 per_batch: int) -> float:
    """One batch of ``bench.py``'s mutation-free filter → prioritize
    sequence on ``scale_candidates``; its p99 on the handlers' clock."""
    lat = []
    for _ in range(per_batch):
        status, res, h_f = client.post("/filter", {
            "Pod": pod.raw, "NodeNames": scale_candidates(rng, names)})
        check(status == 200, f"probe filter: {status} {res}")
        h_p = 0.0
        if res["NodeNames"]:
            status, _, h_p = client.post("/prioritize", {
                "Pod": pod.raw, "NodeNames": res["NodeNames"]})
            check(status == 200, f"probe prioritize: {status}")
        lat.append(h_f + h_p)
    return _percentiles(lat)[1]


def _probe_verdict(p99s: dict) -> dict:
    """``bench.py``'s estimator: the least batch p99 of each arm; the on
    arm may add max(OVERHEAD_LIMIT of the off arm, OVERHEAD_FLOOR_MS)."""
    off, on = min(p99s[False]), min(p99s[True])
    delta_ms = max(on - off, 0.0)
    limit_ms = max(OVERHEAD_LIMIT * off, OVERHEAD_FLOOR_MS)
    return {"p99_off_ms": off, "p99_on_ms": on, "delta_ms": delta_ms,
            "limit_ms": limit_ms, "pass": delta_ms <= limit_ms,
            "batch_p99s_off_ms": p99s[False],
            "batch_p99s_on_ms": p99s[True]}


def timeline_overhead_probe(api: FakeApiServer, client: ExtenderClient,
                            names: list[str], rng,
                            batches: int = OVERHEAD_BATCHES,
                            per_batch: int = OVERHEAD_PER_BATCH) -> dict:
    """``bench.py``'s ``_timeline_overhead_probe`` on the port: batches in
    turns with the timeline off (``TPUSHARE_TIMELINE=off``, sampler
    stopped) and on (sampler, ``note_verb`` and the exemplars)."""
    pod = api.create_pod(make_pod("timeline-probe", hbm=24))
    p99s: dict = {True: [], False: []}
    try:
        for _ in range(batches):
            for armed in (False, True):
                with _env(TPUSHARE_TIMELINE=None if armed else "off"):
                    tobs.start() if armed else tobs.stop()
                    p99s[armed].append(_probe_batch(client, names, rng, pod,
                                                    per_batch))
    finally:
        tobs.start()
    return _probe_verdict(p99s)


def blackbox_overhead_probe(api: FakeApiServer, client: ExtenderClient,
                            names: list[str], rng,
                            batches: int = OVERHEAD_BATCHES,
                            per_batch: int = OVERHEAD_PER_BATCH) -> dict:
    """``bench.py``'s ``_blackbox_overhead_probe`` on the port: the
    timeline on in both arms; the journal (in a temporary directory) and
    the push exporter (to a sink on localhost) armed in turns."""
    import http.server

    class Sink(http.server.BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def do_POST(self):  # noqa: N802 (stdlib casing)
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

    sink = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Sink)
    threading.Thread(target=sink.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{sink.server_address[1]}/telemetry"
    pod = api.create_pod(make_pod("blackbox-probe", hbm=24))
    p99s: dict = {True: [], False: []}
    sent = 0
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke-probe-") as tmp:
            for _ in range(batches):
                for armed in (False, True):
                    with _env(TPUSHARE_BLACKBOX_DIR=tmp if armed else None,
                              TPUSHARE_EXPORT_URL=url if armed else None):
                        if armed:
                            tobs.start()
                        p99s[armed].append(_probe_batch(
                            client, names, rng, pod, per_batch))
                        if armed:
                            exporter = tobs.exporter()
                            tobs.stop_blackbox()
                            sent += exporter.sent_records
    finally:
        tobs.stop_blackbox()
        sink.shutdown()
        sink.server_close()
    return {**_probe_verdict(p99s), "exported_records": sent}


def profiler_overhead_probe(api: FakeApiServer, client: ExtenderClient,
                            names: list[str], rng,
                            batches: int = OVERHEAD_BATCHES,
                            per_batch: int = OVERHEAD_PER_BATCH) -> dict:
    """``bench.py``'s ``_overhead_probe`` on the port: batches in turns
    with the continuous profiler stopped and armed (``profiling.stop()``
    / ``profiling.start()``: the sampler and the duty-cycled decision
    probe). It is left stopped afterwards, and ``ITIMER_PROF`` with it."""
    pod = api.create_pod(make_pod("profiler-probe", hbm=24))
    p99s: dict = {True: [], False: []}
    try:
        for _ in range(batches):
            for armed in (False, True):
                tprofiling.start() if armed else tprofiling.stop()
                p99s[armed].append(_probe_batch(client, names, rng, pod,
                                                per_batch))
        driver = tprofiling.profiler().driver()
        passes = tprofiling.profiler().status()["samplingPasses"]
    finally:
        tprofiling.stop()
    return {**_probe_verdict(p99s), "driver": driver,
            "sampling_passes": passes}


def overhead_phase(fleet: int = EXTENDER_FLEET, seed: int = EXTENDER_SEED,
                   batches: int = OVERHEAD_BATCHES,
                   per_batch: int = OVERHEAD_PER_BATCH) -> dict:
    """The three overhead gates on phase 2f's fleet (the card's node left
    out): a ``serve_stack`` over ``fleet`` H100 nodes, then
    ``timeline_overhead_probe``, ``blackbox_overhead_probe`` and
    ``profiler_overhead_probe``. Not run
    by ``main`` (about 40 s it does not have): ``tools/
    extender_phases.py --overhead`` runs it. A failing gate is recorded,
    not raised."""
    rng = random.Random(seed)
    api = FakeApiServer()
    tobs.reset()
    stack, server = extender_main.serve_stack(api)
    client = ExtenderClient(server)
    try:
        names = extender_fleet(api, fleet)
        check(stack.controller.wait_idle(timeout=120),
              "the extender's controller did not settle")
        t0 = time.perf_counter()
        timeline_gate = timeline_overhead_probe(api, client, names, rng,
                                                batches, per_batch)
        t1 = time.perf_counter()
        blackbox_gate = blackbox_overhead_probe(api, client, names, rng,
                                                batches, per_batch)
        t2 = time.perf_counter()
        tprofiling.reset()
        profiler_gate = profiler_overhead_probe(api, client, names, rng,
                                                batches, per_batch)
        t3 = time.perf_counter()
    finally:
        tprofiling.reset()
        client.close()
        extender_main.shutdown_stack(stack, server)
    return {"nodes": fleet, "timeline": {**timeline_gate,
                                         "seconds": t1 - t0},
            "blackbox": {**blackbox_gate, "seconds": t2 - t1},
            "profiler": {**profiler_gate, "seconds": t3 - t2}}


def gang_pod(name: str, gib: int, group: str, minimum: int,
             chips: int = 0, extra: dict | None = None) -> dict:
    """A gang member's pod: ``gib`` GiB (or ``chips`` whole cards) in
    pod group ``group`` of ``minimum`` members."""
    return make_pod(name, hbm=0 if chips else gib, chips=chips,
                    uid=f"uid-{name}", annotations={
                        const.ANN_POD_GROUP: group,
                        const.ANN_POD_GROUP_MIN: str(minimum),
                        **(extra or {})})


def gang_binds(api: FakeApiServer, client: ExtenderClient, group: str,
               names: list[str], gib: int, node: str,
               extra: dict | None = None) -> dict:
    """Phase 2g (b): create the members of ``group`` and place each through
    filter, prioritize and bind over HTTP, offered ``node`` alone. Every
    bind before the last must answer 500 with the quorum hold, post no
    binding, and show the group in inspect's ``gangs`` with one member
    more reserved and ``tpushare_gangs_pending`` 1; the last commits every
    member to ``node`` and the gauge reads 0. Then each member's
    ``trace-id`` annotation, its ``TPUShareGangCommitted`` Event's
    ``[trace <id>]`` and its newest ``/debug/trace`` decision are one id.
    Returns the binds' handler and wire ms, the gauge after each bind and
    the members' trace ids."""
    pods = [api.create_pod(gang_pod(n, gib, group, len(names), extra=extra))
            for n in names]
    handler_ms, wire_ms, pending = [], [], []
    for i, pod in enumerate(pods):
        bound, h_ms, w_ms = client.schedule(pod, [node])
        handler_ms.append(h_ms)
        wire_ms.append(w_ms)
        pending.append(sample(client.metrics(), "tpushare_gangs_pending"))
        status, body = client.last_bind
        if i < len(pods) - 1:
            check(bound is None and status == 500
                  and QUORUM_HOLD_MARKER in body["Error"],
                  f"bind {i + 1} of {group}: {status} {body}")
            check(not any(api.get_pod("default", p.name).node_name
                          for p in pods),
                  f"{group}: a binding was posted below quorum")
            held = {g["name"]: g for g in client.get("/inspect").get(
                "gangs", [])}
            check(held.get(group, {}).get("reserved") == i + 1,
                  f"inspect's gangs after bind {i + 1}: {held}")
        else:
            check(bound == node and status == 200,
                  f"the last bind of {group}: {status} {body}")
    placed = [api.get_pod("default", p.name).node_name for p in pods]
    check(placed == [node] * len(pods), f"{group} bound to {placed}")
    check(pending == [1.0] * (len(pods) - 1) + [0.0],
          f"tpushare_gangs_pending after each bind: {pending}")
    check(tevents.flush(), "events did not flush")
    committed = {e["involvedObject"]["name"]: e["message"]
                 for _, e in api.events
                 if e["reason"] == tevents.REASON_GANG_COMMITTED}
    ids = {}
    for pod in pods:
        tid = api.get_pod("default", pod.name).annotations.get(
            const.ANN_TRACE_ID)
        newest = client.decision("default", pod.name)["traceId"]
        event = committed.get(pod.name, "")
        check(tid and tid == newest and event.endswith(f"[trace {tid}]"),
              f"{pod.name}: trace-id {tid}, /debug/trace {newest}, "
              f"Event {event!r}")
        ids[pod.name] = tid
    return {"handler_ms": handler_ms, "wire_ms": wire_ms,
            "gangs_pending": pending, "trace_ids": ids}


def gang_grants(api: FakeApiServer, inv: discovery.HostInventory,
                pdir: str, usage_dir: str, names: list[str], gib: int,
                group: str) -> tuple[list[plugin.ContainerAllocation],
                                     list[float]]:
    """Phase 2g (c): the port's daemon over gRPC to a ``FakeKubelet``:
    GetPreferredAllocation and Allocate for each member in turn, kubelet's
    available devices shrinking by each grant. Each response must be
    ``build_allocation``'s for that pod with the gang's group and size,
    and every member ``assigned``. Returns the allocations and each
    member's preferred + Allocate ms."""
    grants = NodeGrants(GANG_NODE, api, inv, pdir, usage_dir)
    allocs, ms = [], []
    try:
        for name in names:
            alloc, grant_ms = grants.allocate(name, gib)
            allocs.append(alloc)
            ms.append(grant_ms)
    finally:
        grants.close()
    for name, alloc in zip(names, allocs):
        pod = api.get_pod("default", name)
        check(podutils.is_assigned(pod), f"the daemon did not commit {name}")
        cards = [inv.chips[p].index
                 for p in podutils.get_chip_ids_from_annotation(pod)]
        want = plugin.build_allocation(inv, cards, gib, pod_uid=pod.uid,
                                       group=group, group_size=len(names),
                                       usage_dir=usage_dir)
        check(alloc == want, f"Allocate for {name} gave {alloc}, want {want}")
    return allocs, ms


def gang_train(api: FakeApiServer, allocs: list, names: list[str],
               gib: int, usage_dir: str, ref: dict) -> dict:
    """Phase 2g (d): the gang trains GANG_STEPS flagship steps on the card,
    rank i started in member i's Allocate response alone
    (``tenant_env``), the launcher adding only the coordinator and
    ``JOB_COMPLETION_INDEX``; a (GANG_MEMBERS, 1, 1) mesh over gloo. Every
    rank must launch the forward 2·n_layers times and each backward
    n_layers times a step, the ranks' losses must agree and be finite, the
    first step's loss and gathered gradients must be within phase 5d's
    bounds of ``ref`` (``single_process_step``), and the port's watchdog
    must find each member's heartbeat fresh and within its grant."""
    world = len(allocs)
    n = M.ModelConfig().n_layers  # the entry's flagship width
    want = {"flash_fwd": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
    with tempfile.TemporaryDirectory(prefix="chip_smoke-2g-") as tmp:
        save = os.path.join(tmp, "grads.pt")
        t0 = time.perf_counter()
        records = launch.launch(
            ["-m", "tpushare_torch.entry", "--mesh", f"{world},1,1",
             "--parts", "train", "--width", "flagship",
             "--steps", str(GANG_STEPS), "--device", "cuda",
             "--backend", "gloo", "--save-grads", save], world,
            deadline_s=GANG_DEADLINE_S,
            envs=[tenant_env(a) for a in allocs])
        seconds = time.perf_counter() - t0
        saved = torch.load(save)["ring"]
    per_rank = [r["paths"]["ring"] for r in records]
    launches = collections.Counter()
    for rank, path in enumerate(per_rank):
        steps = path["launches_per_step"]
        check(len(steps) == GANG_STEPS, f"rank {rank} counted {len(steps)} "
                                        f"steps, ran {GANG_STEPS}")
        for counts in steps:
            check(counts == want, f"rank {rank} launches {counts}, "
                                  f"want {want}")
            launches.update(counts)
    losses = per_rank[0]["losses"]
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(all(p["losses"] == losses for p in per_rank),
          "the gang's ranks disagree on the loss")
    loss_err = abs(saved["loss"] - ref["loss"]) / abs(ref["loss"])
    grad_errs = {k: _norm_err(g.cuda(), ref["grads"][k])
                 for k, g in saved["grads"].items()}
    worst = max(grad_errs, key=grad_errs.get)
    check(loss_err <= TRAIN_LOSS_TOL, f"the gang's loss {saved['loss']} vs "
                                      f"one process {ref['loss']}")
    check(grad_errs[worst] <= TRAIN_GRAD_TOL,
          f"the gang's grad of {worst}: {grad_errs[worst]}")
    sweep = watchdog.GrantWatchdog(GANG_NODE, api,
                                   usage_dir=usage_dir).sweep()
    gates = {}
    for name, rec in zip(names, records):
        pod = api.get_pod("default", name)
        gates[name] = daemon_sweep_gates(sweep, pod.annotations, pod.uid,
                                         gib)
        check(all(gates[name].values()) and rec.get("heartbeat"),
              f"{name}'s heartbeat: {gates[name]} {rec.get('heartbeat')}")
    return {"ranks": world, "seconds": seconds, "losses": losses,
            "vs_single_loss_rel_err": loss_err,
            "vs_single_max_grad_err": grad_errs[worst],
            "vs_single_worst_leaf": worst, "launches_per_step": want,
            "launches": dict(launches),
            "devices": [r["device"] for r in records],
            "memory_fraction": records[0]["memory_fraction"],
            "step_ms_by_rank": [p["step_ms"] for p in per_rank],
            "peak_bytes_by_rank": [p["peak_bytes"] for p in per_rank],
            "heartbeat_bytes_by_rank": [r["heartbeat"]["bytes_in_use"]
                                        for r in records],
            "gates": gates}


def _gone(api: FakeApiServer, names: list[str], timeout: float = 30.0
          ) -> bool:
    """True once none of ``names`` is in the apiserver, within
    ``timeout`` seconds."""
    def alive(name):
        try:
            api.get_pod("default", name)
            return True
        except NotFoundError:
            return False
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not any(alive(n) for n in names):
            return True
        time.sleep(0.02)
    return False


def _node_used_gib(stack, client: ExtenderClient, node: str) -> tuple:
    """(the ledger's, inspect's) GiB in use on ``node``, once the
    controller settled."""
    check(stack.controller.wait_idle(timeout=60),
          "the extender's controller did not settle")
    info = stack.controller.cache.get_node_info(node)
    return (sum(c.get_used_hbm() for c in info.chips.values()),
            client.get(f"/inspect/{node}")["nodes"][0]["usedHBM"])


def gang_reaper(api: FakeApiServer, stack, client: ExtenderClient,
                names: list[str], gib: int) -> dict:
    """Phase 2g (e): evict one member of the committed gang mid-run (a
    delete, as ``tests/test_controller.py:302``): the port's controller
    must delete the survivors (below ``pod-group-min``) and the node's
    ledger and inspect return to 0 GiB. Then a gang of the same shape with
    ``pod-group-reap: "false"`` loses a member and keeps its survivors;
    they are deleted after, back to 0 GiB."""
    before = client.metrics()
    t0 = time.perf_counter()
    api.delete_pod("default", names[2])
    survivors = [n for n in names if n != names[2]]
    check(_gone(api, survivors), f"the reaper left {survivors}")
    reap_s = time.perf_counter() - t0
    reaped_count = rise(client.metrics(), before,
                        "tpushare_gangs_reaped_total")
    check(reaped_count == 1, f"tpushare_gangs_reaped_total rose by "
                             f"{reaped_count} at the reap")
    used = _node_used_gib(stack, client, GANG_NODE)
    check(used == (0, 0), f"after the reap the node holds {used} GiB")
    keep = [f"k-{i}" for i in range(len(names))]
    gang_binds(api, client, "keep", keep, gib, GANG_NODE,
               extra={const.ANN_POD_GROUP_REAP: "false"})
    api.delete_pod("default", keep[1])
    check(stack.controller.wait_idle(timeout=60),
          "the extender's controller did not settle")
    time.sleep(0.5)  # a reap would have been issued by now
    check(stack.controller.wait_idle(timeout=60),
          "the extender's controller did not settle")
    kept = [n for n in keep if n != keep[1]]
    check(all(api.get_pod("default", n).node_name == GANG_NODE
              for n in kept), "an opted-out gang was reaped")
    for n in kept:
        api.delete_pod("default", n)
    used_after = _node_used_gib(stack, client, GANG_NODE)
    check(used_after == (0, 0), f"the node holds {used_after} GiB")
    events_ok = tevents.flush()
    reaped = sorted(e["involvedObject"]["name"] for _, e in api.events
                    if e["reason"] == tevents.REASON_GANG_REAPED)
    check(events_ok and reaped == sorted(survivors),
          f"GangReaped Events on {reaped}")
    opted = rise(client.metrics(), before, "tpushare_gangs_reaped_total")
    check(opted == 1, f"the opted-out gang counted a reap ({opted})")
    return {"reaped": survivors, "reap_seconds": reap_s,
            "reaped_counted": reaped_count,
            "kept_opted_out": kept, "used_gib_after": used_after[0]}


def gang_ttl(api: FakeApiServer, stack, client: ExtenderClient,
             gib: int) -> dict:
    """Phase 2g (f): a gang of GANG_MEMBERS in which one member never
    comes. The planner's ``ttl`` is set to GANG_TTL_S before its first
    member binds (as the reference's tests build ``GangPlanner(ttl=...)``)
    and put back after; once the housekeeping thread's ``expire_stale``
    ran, the reservations must be gone from the ledger and inspect, their
    annotations stripped and no pod bound."""
    planner = stack.binder.gang_planner
    old_ttl, planner.ttl = planner.ttl, GANG_TTL_S
    names = [f"t-{i}" for i in range(GANG_MEMBERS)]
    try:
        pods = [api.create_pod(gang_pod(n, gib, "ttl", GANG_MEMBERS))
                for n in names]
        for pod in pods[:-1]:
            bound, _, _ = client.schedule(pod, [GANG_NODE])
            check(bound is None and QUORUM_HOLD_MARKER in
                  client.last_bind[1]["Error"],
                  f"{pod.name}: {client.last_bind}")
        held = _node_used_gib(stack, client, GANG_NODE)
        reserved = (len(pods) - 1) * gib
        check(held == (reserved, reserved), f"reserved {held} GiB")
        t0 = time.perf_counter()
        deadline = time.monotonic() + 30
        while "default/ttl" in planner.stats():
            check(time.monotonic() < deadline, "the gang never expired")
            time.sleep(0.05)
        rollback_s = time.perf_counter() - t0
    finally:
        planner.ttl = old_ttl
    used = _node_used_gib(stack, client, GANG_NODE)
    check(used == (0, 0), f"after the rollback the node holds {used} GiB")
    for n in names:
        pod = api.get_pod("default", n)
        check(not pod.node_name and not any(
            k in pod.annotations for k in const.GRANT_ANNOTATIONS),
            f"{n} after the rollback: {pod.raw}")
    check("gangs" not in client.get("/inspect"), "inspect keeps the gang")
    for n in names:
        api.delete_pod("default", n)
    return {"reserved_gib": held[0], "rollback_seconds": rollback_s,
            "used_gib_after": used[0]}


def _all_or_none(api: FakeApiServer, groups: dict[str, list[str]]) -> int:
    """How many gangs of ``groups`` are bound; fails if one is bound in
    part."""
    bound: collections.Counter = collections.Counter()
    for pod in api.list_pods():
        group = pod.annotations.get(const.ANN_POD_GROUP)
        if group in groups and pod.node_name:
            bound[group] += 1
    half = {g: k for g, k in bound.items() if k != len(groups[g])}
    check(not half, f"gangs bound in part: {half}")
    return len(bound)


def gang_churn(api: FakeApiServer, stack, client: ExtenderClient,
               names: list[str], gangs: int = GANG_CHURN_GANGS,
               seed: int = GANG_CHURN_SEED) -> dict:
    """Phase 2g (g): ``gangs`` gangs of GANG_MEMBERS whole H100 nodes
    (``chips=8``) on the fleet ``names``. Each round GANG_CHURN_WINDOW
    gangs arrive, their members shuffled together as a kube-scheduler's
    queue delivers them, and the backlog is scheduled over HTTP on the
    candidates ``scale_candidates`` offers. A member the filter finds no
    room for waits for the next round; one held below quorum is reserved
    and is bound by its gang's commit (not scheduled again). A gang's
    commit latency runs from the start of its first reserving member's
    filter to the end of the bind that committed it (its bindings are
    posted inside that bind). After every round each gang must be bound
    all or none. Returns p50 / p99 of the commit latency, the gangs
    committed and the rounds."""
    rng = random.Random(seed)
    groups: dict[str, list[str]] = {}
    backlog, first, done = [], {}, {}
    rounds = 0
    t_all = time.perf_counter()
    while len(done) < gangs and rounds < GANG_CHURN_MAX_ROUNDS:
        rounds += 1
        window = []
        for g in range(len(groups),
                       min(len(groups) + GANG_CHURN_WINDOW, gangs)):
            group = f"churn-g{g:03d}"
            groups[group] = [f"{group}-{i}" for i in range(GANG_MEMBERS)]
            window += [(group, api.create_pod(gang_pod(
                n, 0, group, GANG_MEMBERS, chips=EXTENDER_FLEET_CARDS)))
                for n in groups[group]]
        rng.shuffle(window)
        check(stack.controller.wait_idle(timeout=120),
              "the extender's controller did not settle")
        kept = []
        for group, pod in backlog + window:
            if group in done:
                continue
            client.last_bind = None
            t0 = time.perf_counter()
            node, _, _ = client.schedule(pod, scale_candidates(rng, names))
            if client.last_bind is None:
                kept.append((group, pod))  # no candidate had room
                continue
            status, body = client.last_bind
            first.setdefault(group, t0)
            if node is not None:
                done[group] = time.perf_counter()
            else:
                check(status == 500 and QUORUM_HOLD_MARKER in body["Error"],
                      f"{pod.name}: {status} {body}")
        backlog = kept
        _all_or_none(api, groups)
    seconds = time.perf_counter() - t_all
    check(len(done) == gangs, f"{len(done)} of {gangs} gangs committed in "
                              f"{rounds} rounds")
    check(stack.controller.wait_idle(timeout=120),
          "the extender's controller did not settle")
    committed = _all_or_none(api, groups)
    latency = [1e3 * (done[g] - first[g]) for g in done]
    p50, p99 = _percentiles(latency)
    return {"nodes": len(names), "gangs": gangs, "members": GANG_MEMBERS,
            "committed": committed, "rounds": rounds, "seconds": seconds,
            "commit_p50_ms": p50, "commit_p99_ms": p99,
            "commit_max_ms": max(latency)}


def gang_marker_checks(client: ExtenderClient, gangs: int) -> dict:
    """Phase 2g's timeline: exactly one ``gang-commit`` marker for each
    gang committed (the smoke gang, the reaper's opted-out gang and each
    of the churn's ``gangs``), each of ``GANG_MEMBERS`` members, and one
    ``gang-rollback`` marker, the TTL leg's gang of one member short."""
    doc = timeline(client)
    commits = markers_of(doc, "gang-commit")
    got = collections.Counter(m["attrs"]["gang"] for m in commits)
    want = collections.Counter([GANG_GROUP, "keep", *(
        f"churn-g{g:03d}" for g in range(gangs))])
    check(got == want and {m["attrs"]["members"] for m in commits}
          == {str(GANG_MEMBERS)},
          f"gang-commit markers: {len(commits)}, "
          f"{sorted((got - want) | (want - got))} off")
    rolled = [(m["attrs"]["gang"], m["attrs"]["members"])
              for m in markers_of(doc, "gang-rollback")]
    check(rolled == [("ttl", str(GANG_MEMBERS - 1))],
          f"gang-rollback markers: {rolled}")
    return {"gang_commit": len(commits), "gang_rollback": rolled,
            "smoke": [m for m in commits
                      if m["attrs"]["gang"] == GANG_GROUP][0]}


def gang_phase(inv: discovery.HostInventory, usage_dir: str,
               ref: dict | None, fleet: int = EXTENDER_FLEET,
               gangs: int = GANG_CHURN_GANGS) -> dict:
    """Phase 2g: gangs through the port's extender and daemon. (a) The
    port's ``serve_stack`` over the port's ``FakeApiServer``, the card's
    node annotated by the port's plugin from phase 0's inventory; (b) a
    gang of GANG_MEMBERS members of a GANG_MEMBERS-th of the card's GiB
    commits at quorum through the three verbs over HTTP
    (``gang_binds``); (c) the port's daemon grants all of them over gRPC
    (``gang_grants``); (d) with ``ref`` (phase 5d's
    ``single_process_step``), the gang trains on the card from only those
    grants (``gang_train``; ``ref`` None leaves it out, as the CPU tests
    do); (e) the reaper (``gang_reaper``); (f) the TTL rollback
    (``gang_ttl``); (g) ``gangs`` gangs churn through ``fleet`` H100
    nodes (``gang_churn``); (h) the timeline's gang markers
    (``gang_marker_checks``). Returns the phase's fields; ``launches`` is
    the gang's kernel launches, summed over its ranks and steps."""
    t_phase = time.perf_counter()
    card_gib = inv.chips[0].hbm_gib
    gib = card_gib // GANG_MEMBERS
    names = [f"w-{i}" for i in range(GANG_MEMBERS)]
    api = FakeApiServer()
    tobs.reset()
    stack, server = extender_main.serve_stack(api)
    client = ExtenderClient(server)
    try:
        api.create_node(advertised_node(GANG_NODE, inv))
        with tempfile.TemporaryDirectory(prefix="chip_smoke-gang-") as pdir:
            plugin.TPUSharePlugin(GANG_NODE, api, inv, state_dir=pdir,
                                  usage_dir=usage_dir).annotate_node()
            check(stack.controller.wait_idle(timeout=60),
                  "the extender's controller did not settle")
            binds = gang_binds(api, client, GANG_GROUP, names, gib,
                               GANG_NODE)
            allocs, grant_ms = gang_grants(api, inv, pdir, usage_dir, names,
                                           gib, GANG_GROUP)
        trained = (gang_train(api, allocs, names, gib, usage_dir, ref)
                   if ref is not None else None)
        reaper = gang_reaper(api, stack, client, names, gib)
        ttl = gang_ttl(api, stack, client, gib)
        t0 = time.perf_counter()
        fleet_names = extender_fleet(api, fleet)
        fleet_s = time.perf_counter() - t0
        check(stack.controller.wait_idle(timeout=120),
              "the extender's controller did not settle")
        churn = gang_churn(api, stack, client, fleet_names, gangs)
        marked = gang_marker_checks(client, gangs)
    finally:
        client.close()
        extender_main.shutdown_stack(stack, server)
    return {"member_gib": gib, "card_gib": card_gib, "markers": marked,
            "bind_handler_ms": binds["handler_ms"],
            "bind_wire_ms": binds["wire_ms"],
            "gangs_pending": binds["gangs_pending"],
            "trace_ids": binds["trace_ids"],
            "grant_ms": grant_ms, "envs": [a.envs for a in allocs],
            "train": trained, "reaper": reaper, "ttl": ttl,
            "fleet_seconds": fleet_s, "churn": churn,
            "seconds": time.perf_counter() - t_phase,
            "launches": trained["launches"] if trained else {}}


def gc_posture_churn(fleet: int = EXTENDER_FLEET,
                     target: int = EXTENDER_BOUND) -> dict:
    """Phase 2f's GC turn: the same seeded churn on a fresh fleet under
    the reference extender's GC posture, as ``bench.py --scale`` takes it:
    ``tune_gc()`` at start, ``gc.collect(); tune_gc(freeze=True)`` after
    the warm start (fleet annotated, informer synced), decision traces on
    and ``/metrics`` read once at the end (``bench.py`` reads its registry
    once; no scrape a second). The previous
    thresholds come back and the heap is unfrozen afterwards, so later
    phases run as before."""
    before = gc.get_threshold()
    api = FakeApiServer()
    stack = server = client = None
    try:
        gc_runtime.tune_gc()
        stack, server = extender_main.serve_stack(api)
        client = ExtenderClient(server)
        names = extender_fleet(api, fleet)
        check(stack.controller.wait_idle(timeout=120),
              "the extender's controller did not settle")
        gc.collect()
        gc_runtime.tune_gc(freeze=True)
        frozen = gc.get_freeze_count()
        churn = extender_churn(api, stack, client, names, target=target,
                               scrape_every=None)
    finally:
        if client is not None:
            client.close()
        if stack is not None:
            extender_main.shutdown_stack(stack, server)
        gc.unfreeze()
        gc.set_threshold(*before)
    return {**churn, "thresholds": [gc_runtime.DEFAULT_GEN0,
                                    gc_runtime.DEFAULT_GEN1,
                                    gc_runtime.DEFAULT_GEN2],
            "frozen_objects": frozen, "restored_thresholds": list(before)}


def card_free_bytes() -> int:
    """The card's free bytes, as CUDA counts them across every
    process."""
    return torch.cuda.mem_get_info()[0]


def tenancy_pod(name: str, namespace: str, gib: int, priority: int,
                labels: dict | None = None) -> dict:
    return make_pod(name, hbm=gib, namespace=namespace, priority=priority,
                    uid=f"uid-{name}", labels=labels)


def quota_configmap(entries: dict) -> dict:
    return {"apiVersion": "v1", "kind": "ConfigMap",
            "metadata": {"name": const.QUOTA_CONFIGMAP,
                         "namespace": os.environ.get(
                             "TPUSHARE_QUOTA_NAMESPACE", "kube-system")},
            "data": {t: json.dumps(spec) for t, spec in entries.items()}}


def _until(pred, timeout: float, what: str, every: float = 0.01) -> float:
    """Seconds until ``pred()`` held; fails the run after ``timeout``."""
    t0 = time.perf_counter()
    while not pred():
        check(time.perf_counter() - t0 < timeout, f"{what} within {timeout} s")
        time.sleep(every)
    return time.perf_counter() - t0


class NodeGrants:
    """The port's daemon for one node over gRPC to a ``FakeKubelet``, as
    kubelet drives it: each :meth:`allocate` of ``gib`` GiB takes
    GetPreferredAllocation and Allocate from the devices no pod holds, and
    :meth:`release` hands a dead pod's devices back."""

    def __init__(self, node: str, api: FakeApiServer,
                 inv: discovery.HostInventory, pdir: str, usage_dir: str):
        self.fake = kubelet.FakeKubelet(pdir)
        self.fake.start()
        self.servers = kubelet.run_node_daemon(node, api, inv,
                                               plugin_dir=pdir,
                                               usage_dir=usage_dir)
        self.endpoint = kubelet.socket_name(const.HBM_RESOURCE)
        self.avail = [d.id for d in plugin.hbm_devices(inv)]
        self.held: dict[str, list[str]] = {}

    def allocate(self, pod: str, gib: int
                 ) -> tuple[plugin.ContainerAllocation, float]:
        t0 = time.perf_counter()
        ids = self.fake.preferred(self.endpoint, self.avail, gib)
        resp = self.fake.allocate(self.endpoint, ids)
        ms = (time.perf_counter() - t0) * 1e3
        self.avail = [d for d in self.avail if d not in ids]
        self.held[pod] = ids
        return wire_allocation(resp.container_responses[0]), ms

    def release(self, pod: str) -> None:
        self.avail += self.held.pop(pod)

    def close(self) -> None:
        for srv in self.servers:
            srv.stop()
        self.fake.stop()


def _granted(api: FakeApiServer, inv: discovery.HostInventory, name: str,
             namespace: str, gib: int, usage_dir: str,
             alloc: plugin.ContainerAllocation) -> None:
    pod = api.get_pod(namespace, name)
    check(podutils.is_assigned(pod), f"the daemon did not commit {name}")
    cards = [inv.chips[p].index
             for p in podutils.get_chip_ids_from_annotation(pod)]
    want = plugin.build_allocation(inv, cards, gib, pod_uid=pod.uid,
                                   usage_dir=usage_dir)
    check(alloc == want, f"Allocate for {name} gave {alloc}, want {want}")


def _serving(tenant, got: dict, alloc: plugin.ContainerAllocation,
             card_gib: int, api: FakeApiServer, node: str, pod: str,
             namespace: str, usage_dir: str) -> dict:
    """A served tenant's checks: one card, the grant's cap, ``n_layers``
    forward launches a prefill, its heartbeat fresh and within its grant
    in the watchdog's sweep."""
    grant = int(alloc.envs[const.ENV_HBM_POD])
    want_cap = round(grant / card_gib * torchenv.DEFAULT_HEADROOM, 3)
    check(got["device_count"] == 1 and got["cuda_visible_devices"] == "0"
          and got["cap"] == want_cap
          and got["launches"] == got["n_layers"] * got["prefills"],
          f"the tenant {pod}: {got}")
    wd = watchdog.GrantWatchdog(node, api, usage_dir=usage_dir)
    uid = api.get_pod(namespace, pod).uid
    for sweeps in range(1, DAEMON_SWEEPS + 1):
        sweep = wd.sweep()
        gates = daemon_sweep_gates(sweep, {}, uid, grant)
        if gates["fresh"]:
            break
        time.sleep(1.0)
    check(gates["fresh"] and gates["within_grant"],
          f"the tenant {pod}'s heartbeat in the sweep: {sweep}")
    [entry] = [t for t in sweep["tenants"] if t["uid"] == uid]
    return {"launches": got["launches"], "prefills": got["prefills"],
            "n_layers": got["n_layers"], "tok_per_s": got["tok_per_s"],
            "first_request_s": got["first_request_s"],
            "ready_s": tenant.ready_s, "used_gib": entry["used_gib"],
            "sweeps": sweeps}


def tenancy_ha(api: FakeApiServer, client: ExtenderClient,
               other: ExtenderClient, names: list[str],
               electors: list) -> dict:
    """Phase 2h (a): exactly one of the two electors holds the Lease, its
    replica's ``/healthz`` reads "ok leader" and the other's "ok
    follower", and its ``/metrics`` ``tpushare_leader`` 1.0 and the
    other's 0.0; the follower answers bind with 503, both answer filter
    alike."""
    holders = [e.identity for e in electors if e.is_leader()]
    lease = api.get_lease("kube-system", electors[0].name)
    check(len(holders) == 1 and lease["spec"]["holderIdentity"] == holders[0],
          f"Lease holders {holders}, the Lease says {lease['spec']}")
    health = [client.healthz(), other.healthz()]
    check(health == ["ok leader", "ok follower"], f"/healthz {health}")
    gauge = [sample(c.metrics(), "tpushare_leader") for c in (client, other)]
    check(gauge == [1.0, 0.0], f"tpushare_leader {gauge}")
    probe = api.create_pod(tenancy_pod("ha-probe", TENANCY_STEADY, 8,
                                       TENANCY_FILL_PRIORITY))
    status, body, _ = other.post("/bind", {
        "PodName": probe.name, "PodNamespace": probe.namespace,
        "PodUID": probe.uid, "Node": names[1]})
    check(status == 503 and body == {"Error": "not the leader"},
          f"the follower's bind: {status} {body}")
    check(not api.get_pod(probe.namespace, probe.name).node_name,
          "the follower bound a pod")
    filters = [c.post("/filter", {"Pod": probe.raw, "NodeNames": names})
               for c in (client, other)]
    check([f[0] for f in filters] == [200, 200]
          and filters[0][1] == filters[1][1]
          and filters[0][1]["NodeNames"],
          f"filter on both replicas: {filters}")
    api.delete_pod(probe.namespace, probe.name)
    return {"leader": holders[0], "healthz": health, "leader_gauge": gauge,
            "follower_bind_status": status}


def tenancy_failover(api: FakeApiServer, stacks: list, clients: list,
                     electors: list, names: list[str]) -> dict:
    """Phase 2h (c): stop the leader's elector; the follower takes the
    Lease and answers its first 200 on bind (a pod of 8 GiB on a node of
    the fleet); ``tpushare_leader`` swaps (0.0 on the old leader's
    server, 1.0 on the new's), then the old leader's server stops; no
    card goes over its GiB, on the new leader's ledger and in the
    apiserver."""
    probe = api.create_pod(tenancy_pod("failover-probe", TENANCY_STEADY, 8,
                                       TENANCY_FILL_PRIORITY))
    bind = {"PodName": probe.name, "PodNamespace": probe.namespace,
            "PodUID": probe.uid, "Node": names[1]}
    t0 = time.perf_counter()
    electors[0].stop()
    statuses = []

    def bound():
        status, _, _ = clients[1].post("/bind", bind)
        statuses.append(status)
        return status == 200
    seconds = _until(bound, 5 * TENANCY_LEASE_S, "the follower's first bind",
                     every=0.05)
    check(electors[1].is_leader(), "the follower bound without the Lease")
    check(set(statuses[:-1]) <= {503}, f"binds before the hand-off: "
                                       f"{sorted(set(statuses))}")
    gauge = [sample(c.metrics(), "tpushare_leader") for c in clients]
    check(gauge == [0.0, 1.0], f"tpushare_leader after the failover {gauge}")
    clients[0].close()
    extender_main.shutdown_stack(*stacks[0])
    stacks[0] = clients[0] = None
    check(stacks[1][0].controller.wait_idle(timeout=60),
          "the new leader's controller did not settle")
    checks = ledger_checks(api, stacks[1][0], clients[1], names)
    return {"failover_s": seconds, "binds_refused_first": len(statuses) - 1,
            "leader_gauge_after": gauge,
            "lease_s": TENANCY_LEASE_S, "renew_s": TENANCY_RENEW_S,
            "ledger": checks}


def tenancy_quota(api: FakeApiServer, stack, client: ExtenderClient,
                  names: list[str], spec: dict) -> dict:
    """Phase 2h (e): cap the preemptor's tenant at its usage; its next
    pod is refused by filter with the quota reason on every node, counted
    once in ``tpushare_quota_denied_total{tenant}``, and a Warning Event
    follows; raise the cap and it binds; ``/debug/quota`` equals the
    ledger's usage, and every ``tpushare_quota_*`` gauge equals
    ``/debug/quota``."""
    quota = stack.controller.quota
    used = quota.usage(TENANCY_BURST)[0]
    meta = quota_configmap({})["metadata"]
    cm = api.get_configmap(meta["namespace"], meta["name"])

    def configs() -> int:
        return len(markers_of(timeline(client), "config"))
    # Each replica's start applied the ConfigMap once.
    seeded = configs()
    check(seeded == 2, f"{seeded} config markers from the two starts")

    def apply(limit: int) -> None:
        cm.raw["data"] = {**quota_configmap(spec)["data"],
                          TENANCY_BURST: json.dumps({"limitHBM": limit})}
        before = configs()
        api.update_configmap(cm)
        _until(lambda: quota.config_for(TENANCY_BURST).limit_hbm == limit,
               30, "the quota ConfigMap applied")
        # One write, one config marker (from the one replica left).
        _until(lambda: configs() == before + 1, 5,
               "the write's config marker")
    apply(used)
    pod = api.create_pod(tenancy_pod("burst-next", TENANCY_BURST,
                                     TENANCY_GIB, TENANCY_PREEMPT_PRIORITY))
    before = client.metrics()
    status, doc, denied_ms = client.post("/filter", {"Pod": pod.raw,
                                                     "NodeNames": names})
    denied = rise(client.metrics(), before, "tpushare_quota_denied_total",
                  tenant=TENANCY_BURST)
    check(denied == 1, f"tpushare_quota_denied_total rose by {denied}")
    reasons = set(doc["FailedNodes"].values())
    check(status == 200 and not doc["NodeNames"] and len(reasons) == 1
          and next(iter(reasons)).startswith(
              f"quota: tenant {TENANCY_BURST} over HBM limit"),
          f"the capped tenant's filter: {doc}")
    check(tevents.flush(), "events did not flush")
    warned = [e for _, e in api.events
              if e["reason"] == tevents.REASON_QUOTA_DENIED
              and e["involvedObject"]["name"] == pod.name
              and e["type"] == "Warning"]
    check(len(warned) == 1, f"quota Warning Events: {warned}")
    apply(used + TENANCY_GIB)
    node, handler_ms, _ = client.schedule(pod, names)
    check(node is not None, f"the raised cap still refuses: "
                            f"{client.last_bind}")
    check(stack.controller.wait_idle(timeout=60),
          "the extender's controller did not settle")
    snap = client.get("/debug/quota", prefixed=False)["tenants"]
    usage: dict = {}
    for p in api.list_pods():
        if p.node_name and podutils.is_assumed(p) \
                and not podutils.is_complete_pod(p):
            h, n = usage.get(p.namespace, (0, 0))
            usage[p.namespace] = (h + podutils.get_hbm_from_pod_annotation(p),
                                  n + 1)
    got = {t["tenant"]: (t["usedHBM"], t["pods"]) for t in snap if t["pods"]}
    check(got == usage, f"/debug/quota {got}, the ledger {usage}")
    gauges = client.metrics()
    keys = {"usedHBM": "used_hbm_gib", "usedChips": "used_chips",
            "borrowedHBM": "borrowed_hbm_gib",
            "borrowedChips": "borrowed_chips",
            "guaranteeHBM": "guarantee_hbm_gib",
            "limitHBM": "limit_hbm_gib",
            "guaranteeChips": "guarantee_chips", "limitChips": "limit_chips"}
    differ = [(t["tenant"], k, t[k]) for t in snap for k in keys
              if k in t and (("tpushare_quota_" + keys[k], (
                  ("tenant", t["tenant"]),)) not in gauges
                  or sample(gauges, "tpushare_quota_" + keys[k],
                            tenant=t["tenant"]) != t[k])]
    check(not differ, f"tpushare_quota_* against /debug/quota: {differ}")
    check(configs() == seeded + 2, f"{configs()} config markers after two "
                                   f"writes on {seeded}")
    return {"config_markers": configs(), "capped_at_gib": used,
            "reason": next(iter(reasons)),
            "denied_counted": denied,
            "filter_handler_ms": denied_ms, "raised_to_gib": used +
            TENANCY_GIB, "bound_to": node, "bind_handler_ms": handler_ms,
            "snapshot": snap}


def tenancy_admission(client: ExtenderClient, card_gib: int) -> dict:
    """Phase 2h (f): the admission webhook denies a pod asking more GiB
    than any card holds, with the fleet's limit, and allows one that
    fits."""
    out = {}
    for name, gib in (("oversize", TENANCY_OVERSIZE_GIB),
                      ("fits", TENANCY_GIB)):
        status, doc, ms = client.post("/validate", {
            "apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": {"uid": f"review-{name}",
                        "object": make_pod(name, hbm=gib)}})
        check(status == 200, f"validate {name}: {status} {doc}")
        out[name] = {"response": doc["response"], "handler_ms": ms}
    denied, allowed = out["oversize"]["response"], out["fits"]["response"]
    check(denied["allowed"] is False and denied["status"]["code"] == 422
          and f"the largest chip in the fleet has {card_gib} GiB"
          in denied["status"]["message"], f"the oversize review: {denied}")
    check(allowed == {"uid": "review-fits", "allowed": True},
          f"the fitting review: {allowed}")
    return out


def tenancy_phase(inv: discovery.HostInventory, usage_dir: str,
                  fleet: int = EXTENDER_FLEET,
                  bench_nodes: int = PREEMPT_BENCH_NODES,
                  gang_hosts: int = PREEMPT_GANG_HOSTS) -> dict:
    """Phase 2h: tenancy and HA on the card. (a) Two port extenders over
    one fake apiserver, each with its own ``LeaderElector``
    (``tenancy_ha``), on the card's node and ``TENANCY_FLEET`` H100 nodes;
    a quota ConfigMap: the victim's tenant borrows, the PDB'd pod's
    tenant runs within its guarantee. (b) A priority-0 pod of
    ``TENANCY_GIB`` GiB placed on the card's node through the leader,
    granted by the port's daemon over gRPC, served on the card
    (``ServingTenant``); the rest of the card's GiB held by ledger-only
    pods (granted, nothing started): one priority-0 pod of the victim's
    size under a PodDisruptionBudget of ``minAvailable`` 1 and two of
    priority 20. (c) The failover (``tenancy_failover``). (d) A priority
    10 pod of ``TENANCY_GIB`` GiB: filter refuses the card's node;
    ``/preempt`` names the serving tenant alone; eviction through the
    fake's eviction (which refuses the PDB'd pod), the tenant's process
    stopped, the card memory it freed, the preemptor bound, granted and
    served on the card; its time from ``/preempt`` to the end of its first
    request, split. (e) ``tenancy_quota``; (f) ``tenancy_admission``; (g)
    ``preempt_benches``. Returns the phase's fields; ``launches`` are the
    two tenants' forward counts."""
    from tpushare_torch.k8s.leader import LeaderElector

    t_phase = time.perf_counter()
    card_gib = inv.chips[0].hbm_gib
    fill = card_gib - 2 * TENANCY_GIB
    fillers = ((fill - 7) // 2, fill - (fill - 7) // 2)
    spec = {TENANCY_SERVE: {"guaranteeHBM": 0},
            TENANCY_GUARDED: {"guaranteeHBM": TENANCY_GIB}}
    api = FakeApiServer()
    api.create_configmap(quota_configmap(spec))
    # Both replicas live in this process and share one timeline, as the
    # reference's in-process stacks do: its markers are both replicas'.
    tobs.reset()
    electors = [LeaderElector(api, f"chip-smoke-replica-{i}",
                              lease_duration=TENANCY_LEASE_S,
                              renew_period=TENANCY_RENEW_S)
                for i in range(2)]
    electors[0].start()
    _until(electors[0].is_leader, 30, "the first replica's Lease")
    electors[1].start()
    stacks, clients, tenants, grants = [], [], [], None
    try:
        for e in electors:
            stacks.append(extender_main.serve_stack(api, leader=e))
            clients.append(ExtenderClient(stacks[-1][1]))
        api.create_node(advertised_node(TENANCY_NODE, inv))
        with tempfile.TemporaryDirectory(prefix="chip_smoke-ten-") as pdir:
            plugin.TPUSharePlugin(TENANCY_NODE, api, inv, state_dir=pdir,
                                  usage_dir=usage_dir).annotate_node()
            fleet_inv = discovery.fake_inventory(chips=EXTENDER_FLEET_CARDS)
            names = [TENANCY_NODE]
            for i in range(TENANCY_FLEET):
                names.append(f"h100-tenancy-{i}")
                api.create_node(advertised_node(names[-1], fleet_inv))
                plugin.TPUSharePlugin(names[-1], api, fleet_inv,
                                      usage_dir="").annotate_node()
            for stack, _ in stacks:
                check(stack.controller.wait_idle(timeout=60),
                      "an extender's controller did not settle")
            ha = tenancy_ha(api, clients[0], clients[1], names, electors)
            leader = clients[0]
            # (b) The victim, served; then the ledger-only pods.
            grants = NodeGrants(TENANCY_NODE, api, inv, pdir, usage_dir)
            victim = api.create_pod(tenancy_pod("victim", TENANCY_SERVE,
                                                TENANCY_GIB, 0))
            node, _, _ = leader.schedule(victim, [TENANCY_NODE])
            check(node == TENANCY_NODE, f"the victim went to {node}")
            alloc, victim_allocate_ms = grants.allocate("victim",
                                                        TENANCY_GIB)
            _granted(api, inv, "victim", TENANCY_SERVE, TENANCY_GIB,
                     usage_dir, alloc)
            tenants.append(ServingTenant(alloc))
            served_victim = _serving(
                tenants[0], tenants[0].start(), alloc, card_gib, api,
                TENANCY_NODE, "victim", TENANCY_SERVE, usage_dir)
            api.create_pdb({
                "apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
                "metadata": {"name": "guarded", "namespace": TENANCY_GUARDED},
                "spec": {"minAvailable": 1,
                         "selector": {"matchLabels": {"app": "guarded"}}},
                "status": {"disruptionsAllowed": 0, "currentHealthy": 1,
                           "desiredHealthy": 1, "expectedPods": 1}})
            ledger_only = [("guarded", TENANCY_GUARDED, TENANCY_GIB, 0,
                            {"app": "guarded"})] + [
                (f"steady-{i}", TENANCY_STEADY, gib, TENANCY_FILL_PRIORITY,
                 None) for i, gib in enumerate(fillers)]
            for name, ns, gib, prio, labels in ledger_only:
                pod = api.create_pod(tenancy_pod(name, ns, gib, prio,
                                                 labels))
                node, _, _ = leader.schedule(pod, [TENANCY_NODE])
                check(node == TENANCY_NODE, f"{name} went to {node}")
                got_alloc, _ = grants.allocate(name, gib)
                _granted(api, inv, name, ns, gib, usage_dir, got_alloc)
            doc = leader.get(f"/inspect/{TENANCY_NODE}")
            [card] = [c for n in doc["nodes"] for c in n["chips"]]
            check(card["usedHBM"] == card["totalHBM"] == card_gib,
                  f"the card's node is not full: {card}")
            # (c) The failover.
            failover = tenancy_failover(api, stacks, clients, electors,
                                        names)
            stack, client = stacks[1][0], clients[1]
            # The hand-off on the timeline: each acquisition, in order.
            # A stopped elector stamps nothing as it steps down (it sets
            # its flag and stops renewing, as the reference's does).
            leaders = [(m["detail"], m["attrs"]["identity"])
                       for m in markers_of(timeline(client), "leader")]
            check(leaders == [("acquired leadership", e.identity)
                              for e in electors],
                  f"leader markers: {leaders}")
            failover["leader_markers"] = leaders
            # (d) The preemption.
            pre = api.create_pod(tenancy_pod(
                "preemptor", TENANCY_BURST, TENANCY_GIB,
                TENANCY_PREEMPT_PRIORITY))
            status, doc, _ = client.post("/filter", {
                "Pod": pre.raw, "NodeNames": [TENANCY_NODE]})
            check(status == 200 and not doc["NodeNames"],
                  f"the preemptor fits without a preemption: {doc}")
            before = client.metrics()
            free_before = card_free_bytes()
            t0_unix = time.time()
            t0 = time.perf_counter()
            status, plan, preempt_handler_ms = client.post("/preempt", {
                "Pod": pre.raw,
                "NodeNameToMetaVictims": {TENANCY_NODE: {"Pods": []}}})
            t_preempt = time.perf_counter()
            victims_counted = rise(client.metrics(), before,
                                   "tpushare_preempt_victims_total")
            check(victims_counted == 1, f"tpushare_preempt_victims_total "
                                        f"rose by {victims_counted}")
            want = {"NodeNameToMetaVictims": {TENANCY_NODE: {
                "Pods": [{"UID": victim.uid}], "NumPDBViolations": 0}}}
            check(status == 200 and plan == want,
                  f"/preempt named {plan}, want the serving tenant alone")
            api.evict_pod(TENANCY_SERVE, "victim")
            t_evict = time.perf_counter()
            exit_code = tenants[0].stop()
            t_exit = time.perf_counter()
            check(exit_code == 0, f"the victim exited {exit_code}")
            freed = card_free_bytes() - free_before
            grants.release("victim")
            try:
                api.evict_pod(TENANCY_GUARDED, "guarded")
                refused = None
            except Exception as exc:  # noqa: BLE001 - the 429 is the check
                refused = getattr(exc, "status", repr(exc))
            check(refused == 429, f"the PDB'd pod's eviction: {refused}")
            check(stack.controller.wait_idle(timeout=60),
                  "the extender's controller did not settle")
            node, bind_handler_ms, _ = client.schedule(pre, [TENANCY_NODE])
            t_bind = time.perf_counter()
            check(node == TENANCY_NODE, f"the preemptor went to {node}: "
                                        f"{client.last_bind}")
            # The decision that bound the preemptor began at /preempt.
            decided = client.decision(TENANCY_BURST, pre.name)
            noted = [s.get("attrs", {}).get("victimsPerNode")
                     for s in decided["spans"] if s["phase"] == "preempt"]
            check(decided["outcome"] == "bound"
                  and decided["traceId"] == api.get_pod(
                      TENANCY_BURST, pre.name).annotations.get(
                      const.ANN_TRACE_ID)
                  and noted == [{TENANCY_NODE: 1}],
                  f"the preemptor's decision: {decided}")
            alloc, pre_allocate_ms = grants.allocate("preemptor",
                                                     TENANCY_GIB)
            t_alloc = time.perf_counter()
            _granted(api, inv, "preemptor", TENANCY_BURST, TENANCY_GIB,
                     usage_dir, alloc)
            tenants.append(ServingTenant(alloc))
            got = tenants[1].start()
            first_s = got["first_request_done_unix"] - t0_unix
            served_pre = _serving(tenants[1], got, alloc, card_gib, api,
                                  TENANCY_NODE, "preemptor", TENANCY_BURST,
                                  usage_dir)
            checks = ledger_checks(api, stack, client, names)
            # (e), (f).
            quota = tenancy_quota(api, stack, client, names, spec)
            admission = tenancy_admission(client, card_gib)
    finally:
        for tenant in tenants:
            tenant.stop()
        if grants is not None:
            grants.close()
        for c in clients:
            if c is not None:
                c.close()
        for pair in stacks:
            if pair is not None:
                extender_main.shutdown_stack(*pair)
        for e in electors:
            e.stop()
    benches = preempt_benches(fleet, bench_nodes, gang_hosts)
    return {
        "ha": ha, "failover": failover, "card_gib": card_gib,
        "fillers_gib": [TENANCY_GIB, *fillers],
        "victim": served_victim, "victim_allocate_ms": victim_allocate_ms,
        "preempt": {
            "plan": plan, "handler_ms": preempt_handler_ms,
            "wire_ms": (t_preempt - t0) * 1e3,
            "card_freed_bytes": freed,
            "to_first_request_done_s": first_s,
            "split_s": {"preempt": t_preempt - t0,
                        "eviction": t_evict - t_preempt,
                        "process_exit": t_exit - t_evict,
                        "bind": t_bind - t_exit,
                        "allocate": t_alloc - t_bind,
                        "to_first_request_done": first_s - (t_alloc - t0)},
            "bind_handler_ms": bind_handler_ms,
            "allocate_ms": pre_allocate_ms,
            "pdb_eviction_refused": refused,
            "victims_counted": victims_counted,
            "decision_victims_per_node": noted[0],
            "decision_spans": [s["phase"] for s in decided["spans"]]},
        "preemptor": served_pre, "ledger": checks, "quota": quota,
        "admission": admission, **benches,
        "seconds": time.perf_counter() - t_phase,
        "launches": {"tenancy_victim": served_victim["launches"],
                     "tenancy_preemptor": served_pre["launches"]}}


def slo_configmap(namespace: str, entries: dict) -> dict:
    return {"apiVersion": "v1", "kind": "ConfigMap",
            "metadata": {"name": const.SLO_CONFIGMAP,
                         "namespace": namespace},
            "data": {name: json.dumps(spec)
                     for name, spec in entries.items()}}


def _slo_rows(client: ExtenderClient) -> dict:
    return {row["slo"]: row for row in
            client.get("/debug/slo", prefixed=False)["slos"]}


def defrag_fill(card_gib: int, fleet_card_gib: int) -> dict:
    """Phase 2i's sizing: the card's pods (the movable one, the fillers,
    the one with a checkpoint in flight) as (name, GiB), each fleet
    card's one pod's GiB, and what is left free on each."""
    ckpt = (card_gib - DEFRAG_SPLINTER_GIB - DEFRAG_MOVABLE_GIB
            - DEFRAG_FILLERS * DEFRAG_FILLER_GIB)
    check(ckpt > 0, f"a card of {card_gib} GiB holds no checkpointing pod")
    card = ([("defrag-movable", DEFRAG_MOVABLE_GIB)]
            + [(f"defrag-filler-{i}", DEFRAG_FILLER_GIB)
               for i in range(DEFRAG_FILLERS)]
            + [("defrag-ckpt", ckpt)])
    fleet = fleet_card_gib - DEFRAG_MOVABLE_GIB - 1
    check(fleet_card_gib - fleet < TENANCY_GIB,
          f"a fleet card of {fleet_card_gib} GiB takes a "
          f"{TENANCY_GIB} GiB pod")
    return {"card": card, "card_free_gib": DEFRAG_SPLINTER_GIB,
            "fleet_pod_gib": fleet, "fleet_free_gib": fleet_card_gib - fleet}


def plain_stream_checks(stream: list, device: str = "cuda",
                        cfg: M.ModelConfig | None = None) -> dict:
    """The gated tenant's first request against this process's: the same
    seeded flagship and prompt (``allocated_tenant``'s), ``generate``
    through ``best_attn_fn`` here must give the same tokens, bit for bit;
    and under the plain model (``model.forward``, plain attention) fed
    that stream, each new token must be the plain argmax or within
    ``LOGIT_TOL`` (of the largest logit) of it, since bf16 attention
    moves near-ties."""
    cfg = cfg or M.ModelConfig()
    params = M.init_params(torch.Generator(device=device).manual_seed(0),
                           cfg, device=device)
    prompt = torch.randint(
        0, cfg.vocab_size, (TENANT_BATCH, TENANT_PROMPT),
        generator=torch.Generator(device=device).manual_seed(1),
        device=device)
    got = torch.tensor(stream, device=device)
    check(tuple(got.shape) == (TENANT_BATCH, TENANT_PROMPT + TENANT_NEW)
          and torch.equal(got[:, :TENANT_PROMPT], prompt),
          f"the tenant's stream {tuple(got.shape)} is not its prompt's")
    with torch.inference_mode():
        again = S.generate(params, prompt, cfg, n_new=TENANT_NEW,
                           max_len=TENANT_PROMPT + TENANT_NEW,
                           attn_fn=FA.best_attn_fn(device))
        logits = M.forward(params, got[:, :-1], cfg)[:, TENANT_PROMPT - 1:]
    equal = bool(torch.equal(again, got))
    check(equal, "the tenant's stream is not the one this process "
                 "computes from the same weights and prompt")
    chosen = logits.gather(-1, got[:, TENANT_PROMPT:, None])[..., 0]
    gap = ((logits.max(-1).values - chosen)
           / logits.abs().amax(-1)).max().item()
    agree = (logits.argmax(-1) == got[:, TENANT_PROMPT:]).float().mean()
    check(gap <= LOGIT_TOL, f"a token of the stream is {gap} under the "
                            f"plain model's greedy choice")
    del params, again, logits
    return {"tokens_equal": equal, "plain_argmax_agree": agree.item(),
            "plain_max_gap": gap, "new_tokens": TENANT_BATCH * TENANT_NEW}


def autoscale_tenant(inv: discovery.HostInventory,
                     usage_dir: str) -> ServingTenant:
    """Phase 2j's tenant (``chip_smoke_autoscale.autoscale_tenant``)."""
    return CA.autoscale_tenant(sys.modules[__name__], inv, usage_dir)


def autoscale_phase(inv: discovery.HostInventory, usage_dir: str,
                    fleet: int = CA.AUTOSCALE_FLEET,
                    tenant: ServingTenant | None = None) -> dict:
    """Phase 2j (``chip_smoke_autoscale.autoscale_phase``)."""
    return CA.autoscale_phase(sys.modules[__name__], inv, usage_dir,
                              fleet=fleet, tenant=tenant)


DEFRAG_PENDING = "defrag-pending"


def defrag_tenant(inv: discovery.HostInventory,
                  usage_dir: str) -> ServingTenant:
    """Phase 2i's tenant, started now, gated: in the allocation the
    port's daemon will give the pending pod on the first card, so its
    imports overlap whatever runs before ``GO``."""
    tenant = ServingTenant(plugin.build_allocation(
        inv, [inv.chips[0].index], TENANCY_GIB,
        pod_uid=f"uid-{DEFRAG_PENDING}", usage_dir=usage_dir), gated=True)
    tenant.launch()
    return tenant


def defrag_phase(inv: discovery.HostInventory, usage_dir: str,
                 fleet: int = DEFRAG_FLEET,
                 tenant: ServingTenant | None = None) -> dict:
    """Phase 2i: defragmentation and pod-journey SLOs on the card. One
    port extender (``serve_stack``, ``DEFRAG_ENV``: the executor active,
    its loop a hour away, the SLO ConfigMap trusted from
    ``DEFRAG_SLO_NAMESPACE``) over a fake apiserver, with the card's node
    as the port's daemon advertises it and ``fleet`` fake H100 nodes. The
    tenant that will serve is ``tenant`` (``defrag_tenant``, started
    before; else started now), gated, in the allocation its pod will get.
    (a) The SLO ConfigMap with an objective each bind
    burns; the card filled with ledger-only pods (``defrag_fill``:
    granted over gRPC, nothing started) to a splinter under
    ``TENANCY_GIB``, one of them then annotated with a checkpoint in
    flight; each fleet card filled to leave room for the movable pod and
    not for ``TENANCY_GIB``; a ``TENANCY_GIB`` pod that filter refuses on
    every node; ``/metrics``' stranded GiB equal to the frag index over
    the port's ledger, ``/debug/defrag`` naming the card's node. (b) An
    active tick aborts on the burning objective: counted, nothing
    evicted, its Event and marker, ``/debug/slo`` burning; the ConfigMap
    rewritten lifts it. (c) The next tick moves the movable pod off the
    card through the fake's eviction API and the budget (never the
    checkpointing pod), counted, its Event and marker; the owner's
    successor placed on the planned node; the pending pod bound on the
    card's node, granted, served by the tenant (``plain_stream_checks``),
    its journey bound after its refused attempts, counted; the stranded
    gauge down to the frag index after the move. Returns the phase's
    fields; ``launches`` is the tenant's forward count."""
    t_phase = time.perf_counter()
    card_gib = inv.chips[0].hbm_gib
    fleet_inv = discovery.fake_inventory(chips=EXTENDER_FLEET_CARDS)
    sizing = defrag_fill(card_gib, fleet_inv.chips[0].hbm_gib)
    tenant = tenant or defrag_tenant(inv, usage_dir)
    predicted = tenant.alloc
    tobs.reset()
    tslo.reset()
    api = FakeApiServer()
    stack = server = client = grants = None
    try:
        with _env(**DEFRAG_ENV):
            stack, server = extender_main.serve_stack(api)
        client = ExtenderClient(server)
        ex = stack.controller.defrag
        check((ex.mode, ex.interval_s, ex.planner.max_moves,
               ex.budget.per_hour, ex.budget.node_cooldown_s,
               ex.budget.max_concurrent) == ("active", 3600.0, 4, 20, 300.0,
                                             2),
              f"the executor did not read DEFRAG_ENV: {ex.status()}")
        # (a) The objectives, then the fill.
        api.create_configmap(slo_configmap(DEFRAG_SLO_NAMESPACE,
                                           DEFRAG_BURNING_SLO))
        api.create_configmap(slo_configmap("kube-system",
                                           DEFRAG_LIFTED_SLO))
        _until(lambda: set(tslo.engine().config().slos)
               == set(DEFRAG_BURNING_SLO), 30, "the SLO ConfigMap applied")
        api.create_node(advertised_node(DEFRAG_NODE, inv))
        with tempfile.TemporaryDirectory(prefix="chip_smoke-dfg-") as pdir:
            plugin.TPUSharePlugin(DEFRAG_NODE, api, inv, state_dir=pdir,
                                  usage_dir=usage_dir).annotate_node()
            names = [DEFRAG_NODE]
            for i in range(fleet):
                names.append(f"h100-defrag-{i}")
                api.create_node(advertised_node(names[-1], fleet_inv))
                plugin.TPUSharePlugin(names[-1], api, fleet_inv,
                                      usage_dir="").annotate_node()
            check(stack.controller.wait_idle(timeout=60),
                  "the extender's controller did not settle")
            grants = NodeGrants(DEFRAG_NODE, api, inv, pdir, usage_dir)
            for name, gib in sizing["card"]:
                pod = api.create_pod(make_pod(name, hbm=gib,
                                              uid=f"uid-{name}"))
                node, _, _ = client.schedule(pod, [DEFRAG_NODE])
                check(node == DEFRAG_NODE, f"{name} went to {node}")
                alloc, _ = grants.allocate(name, gib)
                _granted(api, inv, name, "default", gib, usage_dir, alloc)
            ckpt = api.get_pod("default", "defrag-ckpt")
            ckpt.metadata.setdefault("annotations", {})[
                const.ANN_CKPT_IN_FLIGHT] = "true"
            api.update_pod(ckpt)
            fills = 0
            for node in names[1:]:
                for _ in range(EXTENDER_FLEET_CARDS):
                    pod = api.create_pod(make_pod(
                        f"defrag-fleet-{fills}", hbm=sizing["fleet_pod_gib"],
                        uid=f"uid-defrag-fleet-{fills}"))
                    fills += 1
                    got, _, _ = client.schedule(pod, [node])
                    check(got == node, f"{pod.name} went to {got}")
            check(stack.controller.wait_idle(timeout=60),
                  "the extender's controller did not settle")
            movable = {p: ex.planner.movable(
                stack.controller.cache.get_pod(f"uid-{p}"))
                for p in ("defrag-ckpt", "defrag-movable")}
            check(movable == {"defrag-ckpt": (False, "checkpoint in flight"),
                              "defrag-movable": (True, "")},
                  f"movable: {movable}")
            pending = api.create_pod(make_pod(DEFRAG_PENDING,
                                              hbm=TENANCY_GIB,
                                              uid=f"uid-{DEFRAG_PENDING}"))
            node, _, _ = client.schedule(pending, names)
            check(node is None, f"the pending pod fit on {node}")
            metrics = client.metrics()
            shapes = stack.predicate.demand.shapes()
            report = tfrag.cluster_report(
                stack.controller.cache.sharing_node_infos(), shapes)
            stranded = sample(metrics, "tpushare_cluster_stranded_hbm_gib")
            check(shapes == [(TENANCY_GIB, 0)] and stranded > 0
                  and stranded == report["strandedHBM"],
                  f"stranded {stranded} GiB, the frag index "
                  f"{report['strandedHBM']} over {shapes}")
            status = client.get("/debug/defrag", prefixed=False)
            [card_row] = [n for n in status["frag"]["nodes"]
                          if n["node"] == DEFRAG_NODE]
            check(card_row["freeHBM"] == card_row["strandedHBM"]
                  == sizing["card_free_gib"] and card_row["score"] == 1.0
                  and sample(metrics, "tpushare_node_frag_score",
                             node=DEFRAG_NODE) == 1.0,
                  f"the card's node in /debug/defrag: {card_row}")
            # (b) The burning objective aborts the tick.
            burning = _slo_rows(client)
            check(burning["chip-smoke-bind-1ms"]["burning"]
                  and "chip-smoke-bind-600s" not in burning,
                  f"/debug/slo: {burning}")
            before = client.metrics()
            pods_before = sorted(p.uid for p in api.list_pods())
            aborted = ex.tick()
            after = client.metrics()
            check(aborted is not None and aborted["status"] == "aborted"
                  and aborted["abortReason"] == "slo-burn"
                  and {m["status"] for m in aborted["moves"]} == {"aborted"},
                  f"the burning tick: {aborted}")
            abort_counts = {
                "slo_burn": rise(after, before,
                                 "tpushare_defrag_plans_aborted_total",
                                 reason="slo-burn"),
                "evicted": rise(after, before, "tpushare_defrag_moves_total",
                                outcome="evicted")}
            check(abort_counts == {"slo_burn": 1.0, "evicted": 0.0}
                  and sorted(p.uid for p in api.list_pods()) == pods_before,
                  f"the abort: {abort_counts}")
            check(tevents.flush(), "the Events did not flush")
            reasons = [e["reason"] for _, e in api.events]
            check(tevents.REASON_DEFRAG_ABORTED in reasons
                  and tevents.REASON_SLO_BURN in reasons,
                  f"Events after the abort: {reasons}")
            doc = timeline(client)
            abort_markers = markers_of(doc, "defrag-abort")
            check(len(abort_markers) == 1
                  and abort_markers[0]["attrs"]["reason"] == "slo-burn"
                  and markers_of(doc, "slo-burn"),
                  f"markers: {[m['kind'] for m in doc['markers']]}")
            cm = api.get_configmap(DEFRAG_SLO_NAMESPACE, const.SLO_CONFIGMAP)
            cm.raw["data"] = slo_configmap(DEFRAG_SLO_NAMESPACE,
                                           DEFRAG_LIFTED_SLO)["data"]
            api.update_configmap(cm)
            lift_s = _until(lambda: not any(
                r["burning"] for r in tslo.engine().evaluate())
                and set(tslo.engine().config().slos)
                == set(DEFRAG_LIFTED_SLO), 30, "the burn lifted")
            check(not any(r["burning"] for r in _slo_rows(client).values()),
                  "/debug/slo still burns")
            # (c) The move, the successor, the pending pod on the card.
            before = client.metrics()
            t0_unix, t0 = time.time(), time.perf_counter()
            plan = ex.tick()
            t_tick = time.perf_counter()
            after = client.metrics()
            check(plan is not None and plan["status"] == "executed"
                  and plan["unblocks"] == [f"default/{pending.name}"]
                  and plan["moves"]
                  and all(m["status"] == "evicted" for m in plan["moves"])
                  and any(m["from"] == DEFRAG_NODE for m in plan["moves"])
                  and not any(m["pod"] == "default/defrag-ckpt"
                              for m in plan["moves"]),
                  f"the plan: {plan}")
            moved = {m["pod"].split("/", 1)[1]: m for m in plan["moves"]}
            evicted = rise(after, before, "tpushare_defrag_moves_total",
                           outcome="evicted")
            budget = client.get("/debug/defrag", prefixed=False)["budget"]
            check(evicted == len(moved) and budget["usedLastHour"]
                  == len(moved) and budget["perHour"] == 20
                  and not set(moved) & {p.name for p in api.list_pods()},
                  f"evicted {evicted}, the budget {budget}")
            check(tevents.flush(), "the Events did not flush")
            moves_evented = [e["involvedObject"]["name"]
                             for _, e in api.events
                             if e["reason"] == tevents.REASON_DEFRAG_MOVE]
            plan_markers = [m for m in markers_of(timeline(client),
                                                  "defrag-plan")
                            if m["attrs"]["plan"] == plan["id"]]
            check(sorted(moves_evented) == sorted(moved)
                  and len(plan_markers) == 1,
                  f"move Events {moves_evented}, markers {plan_markers}")
            t_plan = plan_markers[0]["ts"] - t0_unix
            for name, move in moved.items():
                if name in grants.held:
                    grants.release(name)
                gib = dict(sizing["card"]).get(name, sizing["fleet_pod_gib"])
                fresh = api.create_pod(make_pod(name, hbm=gib,
                                                uid=f"uid-{name}-2"))
                node, _, _ = client.schedule(fresh, [move["to"]])
                check(node == move["to"] and node != DEFRAG_NODE,
                      f"{name}'s successor went to {node}, planned "
                      f"{move['to']}")
            t_rebind = time.perf_counter()
            check(stack.controller.wait_idle(timeout=60),
                  "the extender's controller did not settle")
            before = client.metrics()
            node, bind_handler_ms, _ = client.schedule(
                api.get_pod("default", pending.name), names)
            t_bind = time.perf_counter()
            check(node == DEFRAG_NODE, f"the pending pod went to {node}: "
                                       f"{client.last_bind}")
            alloc, allocate_ms = grants.allocate(pending.name, TENANCY_GIB)
            t_alloc = time.perf_counter()
            _granted(api, inv, pending.name, "default", TENANCY_GIB,
                     usage_dir, alloc)
            check(alloc == predicted, "the grant is not the env the "
                                      "tenant was started in")
            got = tenant.start()
            served = _serving(tenant, got, alloc, card_gib, api,
                              DEFRAG_NODE, pending.name, "default",
                              usage_dir)
            check(stack.controller.wait_idle(timeout=60),
                  "the extender's controller did not settle")
            after = client.metrics()
            journey = client.get(f"/debug/journey/default/{pending.name}",
                                 prefixed=False)
            refused = [client.get(f"/debug/trace?id={a['traceId']}",
                                  prefixed=False)["target"]["outcome"]
                       for a in journey["attempts"][:-1]]
            e2e_counted = rise(
                after, before, "tpushare_pod_e2e_scheduling_seconds_count",
                tenant="default", outcome="bound")
            check(journey["outcome"] == "bound"
                  and journey["attemptsTotal"] >= 2
                  and refused and set(refused) == {"unschedulable"}
                  and journey["attempts"][-1]["outcome"] == "bound"
                  and e2e_counted == 1,
                  f"the pending pod's journey {journey}, refused "
                  f"{refused}, counted {e2e_counted}")
            shapes = stack.predicate.demand.shapes()
            report = tfrag.cluster_report(
                stack.controller.cache.sharing_node_infos(), shapes)
            stranded_after = sample(after,
                                    "tpushare_cluster_stranded_hbm_gib")
            check(stranded_after == report["strandedHBM"] < stranded,
                  f"stranded {stranded_after} GiB after the move, the "
                  f"frag index {report['strandedHBM']}, before {stranded}")
            free_before = card_free_bytes()
            code = tenant.stop()
            freed = card_free_bytes() - free_before
            check(code == 0, f"the tenant exited {code}")
            stream = plain_stream_checks(got["stream"])
            checks = ledger_checks(api, stack, client, names)
    finally:
        tenant.stop()
        if grants is not None:
            grants.close()
        if client is not None:
            client.close()
        if stack is not None:
            extender_main.shutdown_stack(stack, server)
    first_start = got["first_request_done_unix"] - got["first_request_s"]
    to_first = got["first_request_done_unix"] - t0_unix
    return {
        "card_gib": card_gib, "fleet_nodes": fleet, "sizing": sizing,
        "movable": {p: list(v) for p, v in movable.items()},
        "stranded_gib_before": stranded, "stranded_gib_after":
        stranded_after, "frag_nodes": len(status["frag"]["nodes"]),
        "card_node_frag": card_row, "abort": {
            "plan_status": aborted["status"],
            "reason": aborted["abortReason"],
            "cancelled": len(aborted["moves"]), **abort_counts,
            "lift_s": lift_s},
        "plan": {"moves": [{k: m[k] for k in ("pod", "from", "to",
                                              "status")}
                           for m in plan["moves"]],
                 "unblocks": plan["unblocks"], "evicted": evicted,
                 "budget": budget},
        "pending_bind_handler_ms": bind_handler_ms,
        "allocate_ms": allocate_ms,
        "journey": {k: journey[k] for k in (
            "outcome", "attemptsTotal", "e2eSeconds", "queueWaitSeconds",
            "inVerbSeconds")} | {"refused": refused},
        "tenant": served, "stream": stream, "card_freed_bytes": freed,
        "tenant_import_s": got["gated_unix"] - tenant.started_unix,
        "to_first_request_done_s": to_first,
        "split_s": {"plan": t_plan,
                    "eviction": (t_tick - t0) - t_plan,
                    "recreate_and_rebind": t_rebind - t_tick,
                    "pending_bind": t_bind - t_rebind,
                    "grant": t_alloc - t_bind,
                    # Past the grant until the tenant left its gate: the
                    # rest of its imports, where they outlast the phase.
                    "import_left": got["go_unix"] - (t0_unix + t_alloc - t0),
                    "process_start": first_start - got["go_unix"],
                    "first_request": got["first_request_s"]},
        "ledger": checks, "seconds": time.perf_counter() - t_phase,
        "launches": {"defrag_tenant": served["launches"]}}



def _saturated(api: FakeApiServer, client: ExtenderClient,
               names: list[str], gib: int) -> None:
    """bench.py's fill: a pod of a whole card's GiB a card, each placed by
    filter and bind over HTTP."""
    for i in range(len(names) * EXTENDER_FLEET_CARDS):
        pod = api.create_pod(make_pod(f"filler-{i:04d}", hbm=gib))
        status, doc, _ = client.post("/filter", {"Pod": pod.raw,
                                                 "NodeNames": names})
        check(status == 200 and doc["NodeNames"], f"filler {i}: {doc}")
        status, doc, _ = client.post("/bind", {
            "PodName": pod.name, "PodNamespace": "default",
            "PodUID": pod.uid, "Node": doc["NodeNames"][0]})
        check(status == 200, f"filler {i}'s bind: {doc}")


def _evict_plan(api: FakeApiServer, plan: dict) -> tuple[str, int]:
    """bench.py's pick: the node of the fewest victims; its victims
    deleted. Returns the node and the victims."""
    node, victims = min(plan["NodeNameToMetaVictims"].items(),
                        key=lambda kv: len(kv[1]["Pods"]))
    uids = {v["UID"] for v in victims["Pods"]}
    for p in api.list_pods():
        if p.uid in uids:
            api.delete_pod(p.namespace, p.name)
    return node, len(uids)


def bench_preempt_twin(nodes: int) -> dict:
    """``bench.py``'s ``bench_preempt`` on ``nodes`` H100 nodes of 8 x 79
    GiB, saturated: filter fails everywhere, ``/preempt`` plans, the
    victims are deleted, filter again until the node passes, bind.
    Returns ``preempt_place_ms`` and the victims."""
    api = FakeApiServer()
    stack, server = extender_main.serve_stack(api)
    client = ExtenderClient(server)
    try:
        names = extender_fleet(api, nodes)
        check(stack.controller.wait_idle(timeout=60), "did not settle")
        gib = discovery.fake_inventory(chips=EXTENDER_FLEET_CARDS
                                       ).chips[0].hbm_gib
        _saturated(api, client, names, gib)
        urgent = api.create_pod(make_pod("urgent", hbm=gib, priority=1000))
        t0 = time.perf_counter()
        status, doc, _ = client.post("/filter", {"Pod": urgent.raw,
                                                 "NodeNames": names})
        check(status == 200 and not doc["NodeNames"], "fleet not saturated")
        status, plan, _ = client.post("/preempt", {
            "Pod": urgent.raw,
            "NodeNameToMetaVictims": {n: {"Pods": []} for n in names}})
        check(status == 200 and plan["NodeNameToMetaVictims"], f"{plan}")
        node, victims = _evict_plan(api, plan)

        def passes():
            _, doc, _ = client.post("/filter", {"Pod": urgent.raw,
                                                "NodeNames": [node]})
            return bool(doc["NodeNames"])
        _until(passes, 10, "the freed node passing filter", every=0.001)
        status, doc, _ = client.post("/bind", {
            "PodName": "urgent", "PodNamespace": "default",
            "PodUID": urgent.uid, "Node": node})
        ms = (time.perf_counter() - t0) * 1e3
        check(status == 200, f"the urgent pod's bind: {doc}")
    finally:
        client.close()
        extender_main.shutdown_stack(stack, server)
    return {"preempt_place_ms": ms, "victims": victims, "nodes": nodes}


def bench_gang_preempt_twin(hosts: int) -> dict:
    """``bench.py``'s ``bench_gang_preempt``: a priority-5 gang of
    ``hosts`` whole-node members (8 cards each) on ``hosts`` saturated
    H100 nodes; each member's filter fails, ``/preempt`` plans, the
    victims are deleted and the member's ``nominatedNodeName`` recorded,
    as kube-scheduler does; the nominations must land on distinct hosts;
    then the members bind and the last commits the gang. Returns
    ``gang_preempt_place_ms`` and the victims."""
    api = FakeApiServer()
    stack, server = extender_main.serve_stack(api)
    client = ExtenderClient(server)
    try:
        names = extender_fleet(api, hosts)
        check(stack.controller.wait_idle(timeout=60), "did not settle")
        gib = discovery.fake_inventory(chips=EXTENDER_FLEET_CARDS
                                       ).chips[0].hbm_gib
        _saturated(api, client, names, gib)
        ann = {const.ANN_POD_GROUP: "urgent-slice",
               const.ANN_POD_GROUP_MIN: str(hosts)}
        members = [api.create_pod(make_pod(
            f"gw-{i}", chips=EXTENDER_FLEET_CARDS, priority=5,
            annotations=ann)) for i in range(hosts)]
        evicted, nominated = 0, {}
        t0 = time.perf_counter()
        for member in members:
            status, doc, _ = client.post("/filter", {"Pod": member.raw,
                                                     "NodeNames": names})
            check(status == 200 and not doc["NodeNames"],
                  "fleet not saturated for a gang member")
            status, plan, _ = client.post("/preempt", {
                "Pod": member.raw,
                "NodeNameToMetaVictims": {n: {"Pods": []} for n in names}})
            check(status == 200 and plan["NodeNameToMetaVictims"], f"{plan}")
            node, n = _evict_plan(api, plan)
            evicted += n
            fresh = api.get_pod(member.namespace, member.name)
            fresh.raw.setdefault("status", {})["nominatedNodeName"] = node
            api.update_pod(fresh)
            nominated[member.name] = node
            check(stack.controller.wait_idle(timeout=10), "did not settle")
        check(len(set(nominated.values())) == hosts,
              f"the nominations did not steer the members apart: "
              f"{nominated}")
        for member in members:
            client.post("/bind", {
                "PodName": member.name, "PodNamespace": member.namespace,
                "PodUID": member.uid, "Node": nominated[member.name]})
        _until(lambda: all(api.get_pod("default", m.name).node_name
                           for m in members), 30, "the gang's commit",
               every=0.0005)
        ms = (time.perf_counter() - t0) * 1e3
        placed = {api.get_pod("default", m.name).node_name for m in members}
        check(len(placed) == hosts, f"the gang landed on {placed}")
    finally:
        client.close()
        extender_main.shutdown_stack(stack, server)
    return {"gang_preempt_place_ms": ms, "victims": evicted,
            "hosts": hosts, "nominated": nominated}


def preempt_at_scale(nodes: int) -> dict:
    """``bench_preempt``'s preempt verb over ``nodes`` saturated H100
    nodes: the fillers (a whole card's GiB on every card) are written
    with the grant annotations bind writes, so the cache's rebuild reads
    them and the fill costs no HTTP; then an urgent pod's filter fails on
    all of them and ``/preempt`` over the whole candidate map is timed
    ``PREEMPT_REPEATS`` times on the handlers' clock and the wire's. Each
    answer names one victim on every node."""
    api = FakeApiServer()
    names = extender_fleet(api, nodes)
    gib = discovery.fake_inventory(chips=EXTENDER_FLEET_CARDS
                                   ).chips[0].hbm_gib
    t0 = time.perf_counter()
    seq = 0
    for name in names:
        for card in range(EXTENDER_FLEET_CARDS):
            seq += 1
            api.create_pod(make_pod(
                f"filler-{seq:05d}", hbm=gib, node_name=name,
                uid=f"uid-filler-{seq:05d}", phase="Running", annotations={
                    const.ANN_CHIP_IDX: str(card),
                    const.ANN_HBM_POD: str(gib),
                    const.ANN_HBM_CHIP: str(gib),
                    const.ANN_ASSIGNED: const.ASSIGNED_TRUE,
                    const.ANN_ASSUME_TIME: str(seq)}))
    fill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    stack, server = extender_main.serve_stack(api)
    build_s = time.perf_counter() - t0
    client = ExtenderClient(server)
    try:
        check(stack.controller.wait_idle(timeout=120), "did not settle")
        urgent = api.create_pod(make_pod("urgent", hbm=gib, priority=1000))
        t0 = time.perf_counter()
        status, doc, filter_handler_ms = client.post("/filter", {
            "Pod": urgent.raw, "NodeNames": names})
        filter_wire_ms = (time.perf_counter() - t0) * 1e3
        check(status == 200 and not doc["NodeNames"]
              and len(doc["FailedNodes"]) == nodes, "fleet not saturated")
        body = {"Pod": urgent.raw,
                "NodeNameToMetaVictims": {n: {"Pods": []} for n in names}}
        handler_ms, wire_ms = [], []
        for _ in range(PREEMPT_REPEATS):
            t0 = time.perf_counter()
            status, plan, h_ms = client.post("/preempt", body)
            wire_ms.append((time.perf_counter() - t0) * 1e3)
            handler_ms.append(h_ms)
            victims = plan["NodeNameToMetaVictims"]
            check(status == 200 and len(victims) == nodes
                  and all(len(v["Pods"]) == 1 for v in victims.values()),
                  f"/preempt over {nodes} nodes named "
                  f"{sum(len(v['Pods']) for v in victims.values())} "
                  f"victims on {len(victims)} nodes")
    finally:
        client.close()
        extender_main.shutdown_stack(stack, server)
    return {"nodes": nodes, "fillers": seq, "fill_s": fill_s,
            "cache_build_s": build_s,
            "filter_handler_ms": filter_handler_ms,
            "filter_wire_ms": filter_wire_ms,
            "preempt_handler_ms": handler_ms, "preempt_wire_ms": wire_ms,
            "victims_per_node": 1}


def preempt_benches(fleet: int, bench_nodes: int, gang_hosts: int) -> dict:
    """Phase 2h (g): ``bench_preempt_twin``, ``bench_gang_preempt_twin``
    and ``preempt_at_scale``."""
    return {"bench_preempt": bench_preempt_twin(bench_nodes),
            "bench_gang_preempt": bench_gang_preempt_twin(gang_hosts),
            "preempt_at_scale": preempt_at_scale(fleet)}


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


def _replayed(steps=None) -> dict:
    """Each kernel's launches inside graph replays since
    ``graphs.reset_stats()``, over every compiled step (or those named in
    ``steps``)."""
    out = dict.fromkeys(_counts(), 0)
    for name, st in graphs.stats().items():
        if steps is not None and name not in steps:
            continue
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
    """Host seconds of ``fn()``, synchronized on both sides (on a host
    without a card, the call's own)."""
    card = torch.cuda.is_available()
    if card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    if card:
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
                  backend: str = "gloo", ref: dict | None = None, *,
                  pool_gib: int | None = None) -> dict:
    """Phase 5d: sharded training of the flagship on this card.

    First the single-process kernel step (:func:`single_process_step`,
    unless ``ref`` holds it). Then each of ``gangs`` through
    ``runtime.launch``: ranks of ``python -m tpushare_torch.entry --parts
    train`` (the rank body ``entry.dryrun_multichip``) with the gang env a
    pod gets, drawing the same weights and batch.
    With ``backend`` gloo every rank runs on card 0 under a grant of
    floor(``pool_gib`` / ranks) (the whole card's ``card_gib`` by
    default); with nccl (``tools/nccl_gang.py``) rank
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
            grant = ((pool_gib or card_gib) // world if backend == "gloo"
                     else None)
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
               gangs=PIPE_GANGS, *, pool_gib: int | None = None) -> dict:
    """Phase 5e: pipeline and expert parallelism of the flagship on this
    card. Each of ``gangs`` through ``runtime.launch``: ranks of ``python
    -m tpushare_torch.entry --parts ...`` at flagship width, over gloo,
    under grants of floor(``pool_gib`` / ranks) (``card_gib`` by
    default), drawing the dry run's
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
            grant = (pool_gib or card_gib) // world
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


def checkpoint_phase(cfg: M.ModelConfig, card_gib: int, *,
                     pool_gib: int | None = None) -> dict:
    """Phase 5f: the train → checkpoint → restore → serve lifecycle of the
    flagship (bf16, phase 5b's 8 x 2048 global batch, the dry run's
    weights), gangs of ``CKPT_RANKS`` ranks of ``python -m
    tpushare_torch.entry`` over gloo under grants of floor(``pool_gib`` /
    ranks) (``card_gib`` by default), the checkpoint in a temporary
    directory:

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
    grant = (pool_gib or card_gib) // CKPT_RANKS
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
        with _COUNTED:
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


def pipe_checkpoint_phase(cfg: M.ModelConfig, card_gib: int,
                          fraction: float, *,
                          pool_gib: int | None = None) -> dict:
    """Phase 5f's pipe legs: checkpoints of a 1F1B flagship pipe gang
    (bf16, phase 5b's 8 x 2048 global batch, the dry run's weights, M =
    4) in the reference's stacked layout, gangs of ``python -m
    tpushare_torch.entry`` over gloo under grants of floor(``pool_gib`` /
    ranks) (``card_gib`` by default), the checkpoint in a temporary
    directory:

    (f) a (2, 1, 1, 2) gang (the ``dp_pp`` part of a (2, 1, 2) training
        mesh) takes ``CKPT_STEPS`` AdamW steps with an async save after
        step ``CKPT_AT``;
    (g) a fresh 8-rank (2, 2, 1, 2) gang (``dp_tp_pp``) restores that
        step, tp 1 -> 2 on the same two stages: its gathered weights and
        both AdamW moments bit for bit the saved ones, its next loss
        within ``TRAIN_LOSS_TOL`` of (f)'s;
    (h) this process restores the whole stacked tree (at the stage count
        the checkpoint holds) bit for bit and takes the next step with
        ``flagship_pipeline_reference`` and AdamW on the card, without
        the grant's cap (its plain attention holds [B, H, L, L] fp32
        scores): the loss within ``TRAIN_LOSS_TOL`` of (f)'s;
    (i) a gang of four ranks whose ``pipe`` part pipes over the sp axis
        of a (1, 1, 4) mesh, four stages, resumes from that checkpoint:
        the gang fails on a ``ValueError`` naming both counts, raised in
        ``Checkpointer._check_stages``, which reads the metadata alone,
        with no frame of ``dcp.load`` in the failing rank's traceback.

    Every rank must launch, each call, 2·k·M forwards and k·M of each
    backward (k = n_layers / 2 layers a stage), and the GPipe forward
    that (f)'s part runs after k·M forwards. Returns the legs' fields and
    ``launches`` by leg. Host clocks throughout."""
    fields, launches = {}, {}
    pool = pool_gib or card_gib
    with tempfile.TemporaryDirectory(prefix="chip_smoke-pipe-ckpt-") as tmp:
        ckdir = os.path.join(tmp, "ckpt")

        def leg(name, world, mesh, part, *extra):
            save = os.path.join(tmp, f"{name}.pt")
            grant = pool // world
            t0 = time.perf_counter()
            records = launch.launch(
                ["-m", "tpushare_torch.entry", "--mesh", mesh, "--parts",
                 part, "--width", "flagship", "--steps", str(CKPT_STEPS),
                 "--device", "cuda", "--backend", "gloo", "--save-grads",
                 save, "--ckpt-dir", ckdir, *extra], world,
                deadline_s=GANG_DEADLINE_S, grant_gib=grant,
                card_gib=card_gib)
            secs = time.perf_counter() - t0
            got = torch.load(save)[f"pipe_{part}"]["checkpoint"]
            per_rank = [r["parts"][part] for r in records]
            shape = per_rank[0]["mesh_shape"]
            k = cfg.n_layers // shape["pp"]
            m = per_rank[0]["microbatches"]
            want = {"flash_fwd": 2 * k * m, "flash_bwd_dq": k * m,
                    "flash_bwd_dkv": k * m}
            path = launches.setdefault(f"pipe_checkpoint_{name}",
                                       collections.Counter())
            losses = per_rank[0]["losses"]
            for rank, p in enumerate(per_rank):
                check(p["losses"] == losses, f"5f({name}) rank {rank} "
                      f"losses {p['losses']}, rank 0 {losses}")
                for counts in p["launches_per_call"]:
                    check(counts == want, f"5f({name}) rank {rank} "
                          f"launches {counts}, want {want}")
                    path.update(counts)
                if "gpipe" in p:
                    want_g = {"flash_fwd": k * m, "flash_bwd_dq": 0,
                              "flash_bwd_dkv": 0}
                    check(p["gpipe"]["launches"] == want_g,
                          f"5f({name}) gpipe rank {rank} launches "
                          f"{p['gpipe']['launches']}, want {want_g}")
                    launches.setdefault(f"pipe_checkpoint_{name}_gpipe",
                                        collections.Counter()).update(
                        p["gpipe"]["launches"])
            check(all(math.isfinite(x) for x in losses),
                  f"5f({name}) losses {losses}")
            ck = [p["checkpoint"] for p in per_rank]
            rec = {"ranks": world, "training_mesh": mesh, "part": part,
                   "mesh_shape": shape, "grant_gib": grant, "seconds": secs,
                   "steps": per_rank[0]["steps"], "losses": losses,
                   "launches_per_call": want,
                   "call_ms_by_rank": [p["call_ms"] for p in per_rank],
                   "peak_bytes_by_rank": [p["peak_bytes"] for p in per_rank],
                   "checkpoint_by_rank": ck}
            return rec, got["states"]

        # (f) Train the dp x pp pipe, save asynchronously after CKPT_AT.
        f, states_f = leg("f", 4, "2,1,2", "dp_pp", "--ckpt-every",
                          str(CKPT_AT))
        ck = f["checkpoint_by_rank"]
        check(f["steps"] == list(range(1, CKPT_STEPS + 1))
              and all(c["saved_steps"] == [CKPT_AT] for c in ck),
              f"5f(f) saved {ck}")
        pipe_dir = os.path.join(ckdir, E.PIPE_CKPT_SUBDIR)
        on_disk = sorted(os.listdir(pipe_dir))
        check(on_disk == [str(CKPT_AT)], f"5f(f) left {on_disk}")
        saved = states_f[CKPT_AT]
        check(int(saved["step"]) == CKPT_AT, f"5f(f) saved step "
                                             f"{saved['step']}")
        f.update(save_blocked_ms=[c["save_blocked_ms"][0] for c in ck],
                 durable_ms=[c["durable_ms"] for c in ck],
                 checkpoint_bytes=ck[0]["bytes"])
        fields["f"] = f

        # (g) A fresh dp x tp x pp gang of 8 resumes: tp 1 -> 2.
        g, states_g = leg("g", 8, "2,2,2", "dp_tp_pp", "--resume")
        check(g["steps"] == list(range(CKPT_AT + 1, CKPT_STEPS + 1))
              and all(c["restored_step"] == CKPT_AT
                      for c in g["checkpoint_by_rank"]),
              f"5f(g) ran steps {g['steps']}")
        check(_same_weights(states_g["restored"], saved),
              "5f(g) restored weights or moments differ from the saved ones")
        loss_err = abs(g["losses"][0] - f["losses"][CKPT_AT]) / abs(
            f["losses"][CKPT_AT])
        check(loss_err <= TRAIN_LOSS_TOL, f"5f(g) loss {g['losses'][0]} vs "
                                          f"(f)'s {f['losses'][CKPT_AT]}")
        g.update(vs_f_loss_rel_err=loss_err, restored_bit_identical=True,
                 restore_ms=[c["restore_ms"]
                             for c in g["checkpoint_by_rank"]])
        fields["g"] = g

        # (h) The whole stacked tree in this process, and the next step.
        with _COUNTED:
            torch.cuda.empty_cache()
            torch.cuda.set_per_process_memory_fraction(1.0)
            params = M.init_params(_dev_gen(9), cfg)
            stage = PP.flagship_stage([{k: p.detach() for k, p in
                                        blk.named_parameters()}
                                       for blk in params.blocks])
            edge = PP.flagship_edge(params.embed.detach(),
                                    params.final_norm.detach())
            del params
            opt = T.make_optimizer()([*stage.parameters(), *edge.parameters()])
            ckptr = CK.Checkpointer(CK.CheckpointConfig(pipe_dir),
                                    pipe_axis="pp")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, step = ckptr.restore((stage, edge), opt)
            torch.cuda.synchronize()
            restore_ms = 1e3 * (time.perf_counter() - t0)
            ckptr.close()
            check(step == CKPT_AT, f"5f(h) restored step {step}")
            whole = convert.pipeline_state(opt, stage, edge,
                                           n_stages=f["mesh_shape"]["pp"])
            check(_same_weights(whole, saved),
                  "5f(h) the restored stacked tree differs from the saved one")
            tokens = torch.randint(0, cfg.vocab_size, TRAIN_BATCH,
                                   generator=E.dryrun_generator(1)).cuda()
            _zero_counts()
            loss = PP.flagship_pipeline_reference(cfg, stage, edge, tokens,
                                                  torch.roll(tokens, -1, 1))
            loss.backward()
            opt.step()
            h_loss = loss.item()
            check(_counts() == dict.fromkeys(_counts(), 0),
                  f"5f(h) the plain reference launched {_counts()}")
            f_loss = f["losses"][CKPT_AT]
            h_err = abs(h_loss - f_loss) / abs(f_loss)
            check(math.isfinite(h_loss) and h_err <= TRAIN_LOSS_TOL,
                  f"5f(h) loss {h_loss} vs (f)'s {f_loss}")
            fields["h"] = {"restored_step": step, "restore_ms": restore_ms,
                           "restore_stats": ckptr.last_restore_stats,
                           "restored_bit_identical": True, "next_loss": h_loss,
                           "vs_f_loss_rel_err": h_err,
                           "n_stages": f["mesh_shape"]["pp"]}

            del stage, edge, opt, loss
            torch.cuda.empty_cache()
            torch.cuda.set_per_process_memory_fraction(fraction)

        # (i) A 4-stage gang is refused before dcp.load.
        want = (f"ValueError: the checkpoint holds a pipe of "
                f"{f['mesh_shape']['pp']} stages, the target has 4")
        t0 = time.perf_counter()
        try:
            launch.launch(
                ["-m", "tpushare_torch.entry", "--mesh", "1,1,4", "--parts",
                 "pipe", "--width", "flagship", "--device", "cuda",
                 "--backend", "gloo", "--ckpt-dir", ckdir, "--resume"], 4,
                deadline_s=GANG_DEADLINE_S, grant_gib=pool // 4,
                card_gib=card_gib)
            refused = None
        except launch.GangError as exc:
            refused = str(exc)
        # dcp.load lives in state_dict_loader.py: no frame of it is in
        # the traceback of a refusal raised before it.
        check(refused is not None and want in refused
              and "in _check_stages" in refused
              and "state_dict_loader" not in refused,
              f"5f(i) a 4-stage gang: {refused!r}")
        fields["i"] = {"ranks": 4, "training_mesh": "1,1,4", "part": "pipe",
                       "refused": want, "raised_in": "_check_stages",
                       "seconds": time.perf_counter() - t0}
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


def dryrun_phase(card_gib: int, *, pool_gib: int | None = None) -> dict:
    """Phase 5h: ``python -m tpushare_torch.entry`` as a user runs it, its
    default tiny width (4 heads of 16) and every part (dp x tp x sp
    training with ``DRYRUN_ATTENTION`` in bf16, the ring-MoE, the four
    pipes and the tp decode in fp32), one gang of ``DRYRUN_RANKS`` gloo
    ranks on the card under grants of floor(``pool_gib`` / ranks)
    (``card_gib`` by default) and, at the same time, the same gang with
    ``--device cpu``. Fails if a part raises, unless
    every part ran in its dtype and every rank launched the kernels as
    designed in every part (training: ring 2·L·sp / L·sp / L·sp with
    remat, Ulysses 2·L / L / L; a pipe 2·k·M·s / k·M·s / k·M·s; the decode
    L forwards a prefill; the MoE none; every attention part some), and
    unless every saved loss, gradient and output of the card's run agrees
    with the host's (:func:`_dryrun_checks`: training at phase 5b's bf16
    bounds, the rest at 5g's). Returns the phase's fields; ``launches``
    sums every rank's counts by path."""
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke-dryrun-") as tmp:

        def run(device: str) -> dict:
            save = os.path.join(tmp, f"{device}.pt")
            grant = ((pool_gib or card_gib) // DRYRUN_RANKS
                     if device == "cuda" else None)
            t0 = time.perf_counter()
            records = launch.launch(
                ["-m", "tpushare_torch.entry", "--attention",
                 *DRYRUN_ATTENTION, "--device", device, "--backend", "gloo",
                 "--save-grads", save], DRYRUN_RANKS,
                deadline_s=GANG_DEADLINE_S, grant_gib=grant,
                card_gib=card_gib if grant is not None else None)
            return {"records": records, "saved": torch.load(save),
                    "seconds": time.perf_counter() - t0}

        card, host = concurrently(lambda: run("cuda"), lambda: run("cpu"))
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
            "batch": rec0["batch"],
            "grant_gib": (pool_gib or card_gib) // DRYRUN_RANKS,
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
    # Inputs are read once where a row sees a key, K and V up to the last
    # key a row sees; out and lse are written.
    reads = (q.numel() + 2 * b * int(seen.max()) * h * d) if pairs else 0
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


#: Phase 9's admissions, as (slot, prompt length) into the 8-slot server:
#: the twin's 1024-token prompt and two whose last piece is padded, three
#: lengths in three slots, every piece through one graph.
ADMIT_PROMPTS = ((5, 1024), (2, 500), (7, 777))
#: The graphs of the prefill pieces (``workload.serving``).
PIECE_STEPS = ("prefill_chunk", "prefill_paged_piece")

#: What the kernels line's ``replay_launches_by_path`` counts.
REPLAY_LAUNCHES_ARE = (
    "derived: each replay adds the launches its capture recorded "
    "(compiled_pieces: the part of compiled_steps that the prefill "
    "pieces' replays made). "
    "traced_replay_launches are counted by kernel name in a profiler trace "
    "of one call of each compiled path in phase 9, and of one replay a "
    "graph on every rank in phase 9b (compiled_mesh_*: summed over the "
    "ranks), which fail unless they equal the derived count")
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


def _turns_ms(eager, compiled, rounds: int = 1, reset=None) -> dict:
    """Host ms of ``eager()`` (under ``graphs.disabled()``) and of
    ``compiled()`` (a replay), synchronized, in turns: eager, compiled,
    compiled, eager, ``rounds`` times (one by default: two timed calls of
    each, in both orders); ``reset()``, when given, runs before each
    call, untimed."""
    times = {"eager_ms": [], "compiled_ms": []}

    def one(kind):
        if reset is not None:
            reset()
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


def compiled_admissions(cfg: M.ModelConfig, params, ids,
                        traced: dict) -> dict:
    """Phase 9's admissions, each compiled (the pieces and the finalize
    replay their graphs) and eager (``graphs.disabled()``) from one state,
    bit for bit in caches, page pools, tables, slots, emitted tokens and
    generators: (a) ``admit_chunked`` of ``ADMIT_PROMPTS`` (three lengths
    in three slots) and a sampled one twice, from two generators; (b)
    ``admit_interleaved`` of the 1024-token prompt beside seven decoding
    slots, greedy twice, then sampled (admission and co-tenants) from two
    generators; (c) ``admit_paged`` of the 1024-token prompt into two
    slots of one tenant (the second shares 15 prefix pages), one of 500
    tokens, and a sampled one from two generators. Each piece key misses
    once and never again on its cache; ``traced`` gets the flash launches
    of every call whose pieces all replay (``_replays``)."""
    n = cfg.n_layers
    slots = len(BW.PROMPT_MIX)
    keys = ("cache", "pos", "active", "token")
    prompts = {length: ids(length) for _, length in ADMIT_PROMPTS}
    fields = {}
    # Earlier steps of the phase (the 16-stream paged server's admissions)
    # left misses, and finalize keys of their slot count, which bind only
    # the weights: count this section's own.
    steps = (*PIECE_STEPS, "finalize_admit")
    keys_before = {name: graphs.cache_size(name) for name in steps}
    misses_before = {name: graphs.stats().get(name, {}).get("misses", 0)
                     for name in steps}

    def new(name: str) -> tuple[int, int]:
        """(keys, misses) of ``name`` this section added."""
        return (graphs.cache_size(name) - keys_before[name],
                graphs.stats()[name]["misses"] - misses_before[name])

    def pieces(length: int) -> int:
        return -(-length // PIECE)

    def run(step: str, fn, calls: int, trace_as: str | None):
        """``fn()``; traced as ``trace_as`` (``_replays``: ``calls``
        replays of ``step``, ``n_layers`` flash launches each) when
        given."""
        if trace_as is None:
            return fn()
        got, traced[trace_as] = _replays(step, fn, calls)
        check(traced[trace_as]["flash_fwd"] == n * calls,
              f"9 {trace_as}: {traced[trace_as]} traced for {calls} pieces")
        return got

    # (a) Chunked: three prompts in three slots, then a sampled one.
    st_g = S.init_server_state(cfg, slots, SERVE_MAX_LEN)
    st_e = S.init_server_state(cfg, slots, SERVE_MAX_LEN)
    misses = []
    for i, (slot, length) in enumerate(ADMIT_PROMPTS):
        run("prefill_chunk", lambda slot=slot, length=length:
                S.admit_chunked(params, st_g, prompts[length], slot,
                                chunk=PIECE), pieces(length),
                None if i == 0 else f"admit_chunked_{length}")
        with graphs.disabled():
            S.admit_chunked(params, st_e, prompts[length], slot, chunk=PIECE)
        check(_state_equal(st_g, st_e, keys), f"9 admit_chunked {length}: "
                                              f"replayed pieces differ")
        misses.append(new("prefill_chunk"))
    check(misses == [(1, 1)] * len(ADMIT_PROMPTS),
          f"9 admit_chunked: piece (keys, misses) {misses}")
    slot, length = ADMIT_PROMPTS[1]
    gens = [(_dev_gen(s), _dev_gen(s)) for s in (61, 62)]
    same = []
    for i, (g, r) in enumerate(gens):
        S.release(st_g, slot)
        S.release(st_e, slot)
        run("prefill_chunk", lambda g=g: S.admit_chunked(
            params, st_g, prompts[length], slot, chunk=PIECE,
            temperature=0.7, generator=g), pieces(length),
            "admit_chunked_sampled" if i else None)
        with graphs.disabled():
            S.admit_chunked(params, st_e, prompts[length], slot,
                            chunk=PIECE, temperature=0.7, generator=r)
        same.append(_state_equal(st_g, st_e, keys))
    check(all(same) and _same_draws(*gens),
          f"9 admit_chunked_sampled: replays differ from eager ({same})")
    fields["chunked"] = {
        "prompts": [list(p) for p in ADMIT_PROMPTS], "piece": PIECE,
        "piece_keys_misses": misses, "bit_identical": True,
        "finalize_keys": new("finalize_admit")[0],
        "peak_reserved_bytes": _peak()}
    check(fields["chunked"]["finalize_keys"] == 2,
          f"9 admit_chunked: {fields['chunked']['finalize_keys']} new "
          f"finalize keys, not one greedy and one sampled")

    # (b) Interleaved: four more of the mix decoding beside the three, the
    # 1024-token prompt into slot 6, 8 decode steps after each piece.
    for slot in (0, 1, 3, 4):
        S.admit_chunked(params, st_g, ids(BW.PROMPT_MIX[slot]), slot,
                        chunk=PIECE)
    _copy_state(st_e, _clone_state(st_g))
    big = prompts[1024]
    temps = torch.full((slots,), 0.9, device=st_g["pos"].device)
    temps[1] = 0.0
    runs = [({}, None), ({}, "admit_interleaved")]
    for s_ in (71, 72):
        runs.append(({"temperature": 0.7, "serve_temperature": temps,
                      "generator": s_}, "admit_interleaved_sampled"
                     if s_ == 72 else None))
    same, draws = [], []
    for kw, trace_as in runs:
        kw_g, kw_e = dict(kw), dict(kw)
        if "generator" in kw:
            g, r = _dev_gen(kw["generator"]), _dev_gen(kw["generator"])
            kw_g.update(generator=g, serve_generator=g)
            kw_e.update(generator=r, serve_generator=r)
            draws.append((g, r))
        for st in (st_g, st_e):
            S.release(st, 6)
        em_g = run("prefill_chunk", lambda kw_g=kw_g: S.admit_interleaved(
            params, st_g, big, 6, chunk=PIECE, decode_steps=INTERLEAVE_STEPS,
            **kw_g)[1], pieces(1024), trace_as)
        with graphs.disabled():
            em_e = S.admit_interleaved(params, st_e, big, 6, chunk=PIECE,
                                       decode_steps=INTERLEAVE_STEPS,
                                       **kw_e)[1]
        same.append(torch.equal(em_g, em_e)
                    and _state_equal(st_g, st_e, keys))
    check(all(same) and _same_draws(*draws),
          f"9 admit_interleaved: replays differ from eager ({same})")
    check(new("prefill_chunk") == (1, 1),
          f"9 admit_interleaved: piece (keys, misses) "
          f"{new('prefill_chunk')}")
    fields["interleaved"] = {"decode_steps": INTERLEAVE_STEPS,
                             "runs": len(runs), "bit_identical": True,
                             "peak_reserved_bytes": _peak()}
    del st_g, st_e

    # (c) Paged: the 1024-token prompt twice for one tenant (prefix pages
    # shared), 500 tokens, then 777 sampled from two generators.
    total = 96
    pools = [P.PagePool(total, page_tokens=PIECE) for _ in range(2)]
    pst_g, pst_e = (S.init_paged_state(cfg, slots, SERVE_MAX_LEN, total,
                                       PIECE) for _ in range(2))
    pkeys = ("pages", "table", "pos", "active", "token")
    shared = P.shareable_pages(1024, PIECE)
    plan = [(0, 1024, {}, None, pieces(1024)),
            (1, 1024, {}, "admit_paged_shared", pieces(1024) - shared),
            (2, 500, {}, "admit_paged_500", pieces(500))]
    plan += [(3, 777, {"temperature": 0.7, "generator": s_},
              "admit_paged_sampled" if s_ == 82 else None, pieces(777))
             for s_ in (81, 82)]
    same, draws = [], []
    for slot, length, kw, trace_as, calls in plan:
        kw_g, kw_e = dict(kw), dict(kw)
        if "generator" in kw:
            g, r = _dev_gen(kw["generator"]), _dev_gen(kw["generator"])
            kw_g["generator"], kw_e["generator"] = g, r
            draws.append((g, r))
            for st, pool in zip((pst_g, pst_e), pools):
                if bool(st["active"][slot]):
                    S.release_paged(st, pool, slot)
        run("prefill_paged_piece", lambda: S.admit_paged(
            params, pst_g, pools[0], prompts[length], slot, tenant="a",
            **kw_g), calls, trace_as)
        with graphs.disabled():
            S.admit_paged(params, pst_e, pools[1], prompts[length], slot,
                          tenant="a", **kw_e)
        same.append(_state_equal(pst_g, pst_e, pkeys)
                    and pools[0].stats() == pools[1].stats())
    check(all(same) and _same_draws(*draws),
          f"9 admit_paged: replays differ from eager ({same})")
    check(pools[0].stats()["prefixHits"] == shared,
          f"9 admit_paged: prefixHits {pools[0].stats()['prefixHits']}, "
          f"want {shared}")
    check(int(pst_g["token"][1]) == int(pst_g["token"][0]),
          "9 admit_paged: the prefix-shared slot's first token differs")
    check(new("prefill_paged_piece") == (1, 1),
          f"9 admit_paged: paged piece (keys, misses) "
          f"{new('prefill_paged_piece')}")
    fields["paged"] = {"prefix_hits": shared, "bit_identical": True,
                       "pool": pools[0].stats(),
                       "peak_reserved_bytes": _peak()}
    fields["graphs"] = {name: graphs.stats()[name]
                        for name in (*PIECE_STEPS, "finalize_admit")}
    return fields


def admission_turns(cfg: M.ModelConfig, params, ids) -> dict:
    """Host ms, eager against compiled in turns (``_turns_ms``), of the
    three admissions of the 1024-token prompt at C = 64 on the 8-slot
    server: ``admit_chunked`` (and the pause a piece, the twin's
    ``max_pause_ms``: the admission over its pieces); ``admit_interleaved``
    beside seven decoding slots, and the pause a co-tenant sees: its
    order run by hand, each piece timed alone (synchronized on both
    sides) between the 8-step chunks; ``admit_paged`` of the prompt (no
    shared page). Each call starts from the same state (``reset``,
    untimed). Then one compiled piece of each kind at offset 960 under
    the profiler (``_piece_device``)."""
    slots, length = len(BW.PROMPT_MIX), 1024
    pieces = length // PIECE
    prompt = ids(length)
    state = S.init_server_state(cfg, slots, SERVE_MAX_LEN)
    for slot, n in enumerate(BW.PROMPT_MIX[:-1]):
        S.admit_chunked(params, state, ids(n), slot, chunk=PIECE)
    start = _clone_state(state)
    dev = state["pos"].device
    slot_t, tl_t = S._scalar(slots - 1, dev), S._scalar(length, dev)
    carry = params.embed.new_zeros((1, params.embed.shape[1]))

    def reset():
        _copy_state(state, start)

    def chunked():
        S.admit_chunked(params, state, prompt, slots - 1, chunk=PIECE)

    def interleaved():
        S.admit_interleaved(params, state, prompt, slots - 1, chunk=PIECE,
                            decode_steps=INTERLEAVE_STEPS)

    @torch.inference_mode()
    def pauses() -> list[float]:
        """``admit_interleaved``'s pieces and chunks, each piece's host
        ms alone: what a co-tenant waits between its chunks."""
        h, ms = carry, []
        for i in range(pieces):
            off = S._scalar(i * PIECE, dev)
            ms.append(1e3 * _synced_s(lambda: S._prefill_chunk(
                params, state, prompt[i * PIECE:(i + 1) * PIECE], slot_t,
                off, tl_t, h)))
            S.serve_chunk(params, state, INTERLEAVE_STEPS)
        return ms

    for fn in (chunked, interleaved):             # the captures
        reset()
        fn()
    out = {"prompt_len": length, "piece": PIECE, "pieces": pieces,
           "decode_steps": INTERLEAVE_STEPS}
    out["chunked"] = _turns_ms(chunked, chunked, reset=reset)
    out["interleaved"] = _turns_ms(interleaved, interleaved, reset=reset)
    for kind in ("eager_ms", "compiled_ms"):
        out[f"pause_per_piece_{kind}"] = min(out["chunked"][kind]) / pieces
    for mode in ("eager", "compiled", "compiled", "eager"):
        reset()
        with graphs.disabled() if mode == "eager" else contextlib.nullcontext():
            ms = pauses()
        out.setdefault(f"cotenant_pause_{mode}_ms", []).append(
            {"median": sorted(ms)[len(ms) // 2], "max": max(ms)})

    # One compiled piece at offset 960, and the gather alone.
    reset()
    off_t = S._scalar(960, dev)
    tokens = prompt[960:960 + PIECE]

    @torch.inference_mode()
    def piece():
        return S._prefill_chunk(params, state, tokens, slot_t, off_t, tl_t,
                                carry)

    def gather():
        for layer in state["cache"]:
            layer["k"].index_select(0, slot_t)
            layer["v"].index_select(0, slot_t)

    out["piece_contiguous"] = _piece_device(piece, gather)
    del state, start

    pages = 2 * pieces + 2
    pool = P.PagePool(pages, page_tokens=PIECE)
    pst = S.init_paged_state(cfg, slots, SERVE_MAX_LEN, pages, PIECE)

    def paged():
        S.admit_paged(params, pst, pool, prompt, 0)

    def paged_reset():
        if bool(pst["active"][0]):
            S.release_paged(pst, pool, 0)

    paged_reset()
    paged()                                        # the capture
    out["paged"] = _turns_ms(paged, paged, reset=paged_reset)
    out["paged_pause_per_piece_compiled_ms"] = (
        min(out["paged"]["compiled_ms"]) / pieces)
    piece_t = S._scalar(15, dev)
    slot0 = S._scalar(0, dev)
    P_, _, _, _ = S._paged_dims(pst)

    @torch.inference_mode()
    def paged_piece():
        return S._prefill_paged_piece(params, pst, tokens, slot0, piece_t,
                                      tl_t, carry)

    def paged_gather():
        row = pst["table"].index_select(0, slot0)[0].clamp(0, P_ - 1)
        for pg in pst["pages"]:
            pg["k"].index_select(0, row)
            pg["v"].index_select(0, row)

    out["piece_paged"] = _piece_device(paged_piece, paged_gather)
    paged_reset()
    del pst, pool
    return out


def _piece_device(piece, gather) -> dict:
    """One compiled piece (its key already captured) under the profiler,
    after two untimed calls: host ms, the card's busy ms, the flash
    kernels' device ms, the largest device times by name, and the index
    selects' (the gather and the carry's row) in the trace; and the
    gather's device ms alone (``device_ms``: its K and V rows, every
    layer, back to back) and its share of the busy ms."""
    for _ in range(2):
        piece()
    secs, on_card, _ = profiled(piece)
    by_name = _by_name(on_card)
    busy_ms = sum(by_name.values()) / 1e3
    gather_ms = device_ms(gather)
    selects_ms = sum(us for name, us in by_name.items()
                     if "indexSelect" in name) / 1e3
    return {"host_ms": 1e3 * secs, "device_ms": busy_ms,
            "flash_device_ms": sum(us for name, us in by_name.items()
                                   if "flash_fwd_" in name) / 1e3,
            "gather_device_ms": gather_ms,
            "gather_share": gather_ms / busy_ms,
            "index_select_traced_ms": selects_ms,
            "index_select_traced_share": selects_ms / busy_ms,
            "top_device_us": dict(by_name.most_common(8))}


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

    # The chunked, interleaved and paged admissions, greedy and sampled,
    # compiled against eager; then their host ms in turns and a piece's
    # device ms.
    fields["admissions"] = compiled_admissions(cfg, params, ids, traced)
    fields["admission_turns"] = admission_turns(cfg, params, ids)

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
    fields["replayed_pieces"] = _replayed(PIECE_STEPS)
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


#: Phase 9b: the compiled sharded steps (``graphs.run`` under a mesh),
#: each rank of a gang running the rank body :func:`compiled_gang_rank`
#: (``python3 chip_smoke.py --compiled-gang SPEC``). On one card: (a) a
#: one-rank NCCL gang, mesh (1, 1, 1), through the mesh branches of the
#: train step and ``generate``, and a checkpoint restore between steps;
#: (b) a two-rank gloo gang, a (1, 1, 2) ring step. On four cards or more
#: (c) :data:`FOUR_CARD_CASES`, one rank a card over NCCL, the cases
#: ``tools/nccl_gang.py`` runs.
COMPILED_GANG_FLAG = "--compiled-gang"
ONE_CARD_CASES = (
    {"name": "train_1x1x1", "kind": "train", "mesh": [1, 1, 1],
     "steps": 3, "restore": True},
    {"name": "generate_1x1x1", "kind": "generate", "mesh": [1, 1, 1]})
GLOO_CASES = (
    {"name": "train_1x1x2_gloo", "kind": "train", "mesh": [1, 1, 2],
     "steps": 2},)
FOUR_CARD_CASES = (
    {"name": "train_ring_1x2x2", "kind": "train", "mesh": [1, 2, 2],
     "attention": "ring", "steps": 3},
    {"name": "train_ulysses_1x2x2", "kind": "train", "mesh": [1, 2, 2],
     "attention": "ulysses", "steps": 3},
    {"name": "train_2x2x1", "kind": "train", "mesh": [2, 2, 1], "steps": 3},
    {"name": "generate_2x2x1", "kind": "generate", "mesh": [2, 2, 1]},
    {"name": "pipe_1f1b_2x1x1x2", "kind": "pipe", "mesh": [2, 1, 1, 2],
     "kw": {"dp_axis": "dp"}, "m": 4, "gpipe": True},
    {"name": "pipe_1f1b_1x1x2x2", "kind": "pipe", "mesh": [1, 1, 2, 2],
     "kw": {"sp_axis": "sp"}, "m": 8},
    {"name": "moe_1x2x2", "kind": "moe", "mesh": [1, 2, 2]})
#: Compiled calls of each case (the key's eager first call, then
#: replays), then as many eager calls from the same init.
COMPILED_CALLS = 3
COMPILED_GANG_DEADLINE_S = 420


def _gang_config(width: str):
    """(config, global batch) of a compiled gang's cases: the flagship at
    phase 5b's 8 x 2048, or the dry run's tiny width in fp32 (a host
    smoke of the rank body)."""
    if width == "flagship":
        return M.ModelConfig(), TRAIN_BATCH
    cfg, _ = E.dryrun_config("tiny", par.Mesh(1, 1, 2, 0, {}))
    return dataclasses.replace(cfg, dtype=torch.float32), (8, 32)


def _sync_if(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _traced_call(name: str, fn, dev: torch.device, captured: bool):
    """``fn()``, a replay of ``name`` traced (:func:`_replays`) where the
    step is captured; else the call and its counted launches."""
    if captured and dev.type == "cuda":
        return _replays(name, fn)
    before = _counts()
    out = fn()
    return out, {k: c - before[k] for k, c in _counts().items()}


def _gang_record(dev: torch.device, mesh, counts0: dict, t0: float) -> dict:
    """What every case of a compiled gang records beside its checks: the
    registry's stats and captures, the graph pools, peak memory, the
    launches the case made, its seconds."""
    captured = {}
    for rec in graphs.CAPTURES:
        captured.setdefault(rec["name"], []).append(
            {"seconds": rec["seconds"], "growth": list(rec["growth"])})
    out = {"mesh": mesh.shape, "backend": mesh.backend,
           "captured_here": graphs.captures(dev, mesh),
           "stats": graphs.stats(), "captures": captured,
           "launches": {k: c - counts0[k] for k, c in _counts().items()},
           "replayed": _replayed(), "seconds": time.perf_counter() - t0}
    if dev.type == "cuda":
        out.update(pool_bytes=graphs.pool_bytes(),
                   peak_reserved_bytes=torch.cuda.max_memory_reserved(dev),
                   peak_allocated_bytes=torch.cuda.max_memory_allocated(dev))
    return out


def _gang_train(case: dict, dev: torch.device, width: str, begin: tuple,
                saved: dict) -> dict:
    """The sharded train step eager, then compiled (``COMPILED_CALLS``
    steps, or ``steps``: the key's first call, then replays, the last
    traced) from the same init: losses, weights and AdamW state bit for
    bit; then host ms in turns. With ``restore``, a
    save after the steps, one more step, a restore, and the step after it
    must replay and repeat that step's loss bit for bit, ``step`` on the
    parameters' device. Keeps the first step's loss and gathered
    gradients in ``saved``."""
    cfg, shape = _gang_config(width)
    mesh = par.make_mesh(*case["mesh"])
    init_fn, step, place = T.make_train_step(
        cfg, mesh, attention=case.get("attention"), device=dev)
    tokens = torch.randint(0, cfg.vocab_size, shape,
                           generator=E.dryrun_generator(1)).to(dev)
    shard = place(tokens, torch.roll(tokens, -1, dims=1))
    captured = graphs.captures(dev, mesh)
    steps = case.get("steps", COMPILED_CALLS)

    params, opt = init_fn(E.dryrun_generator(0), tokens)
    with graphs.disabled():
        eager = [step(params, opt, *shard)[2] for _ in range(steps)]
        eager += list(params.parameters()) + [
            t for st in opt.state.values() for t in st.values()]
    params, opt = init_fn(E.dryrun_generator(0), tokens)
    losses, per_step, traced = [], [], None
    for i in range(steps):
        last = captured and i == steps - 1 and i > 0
        loss, counted = _traced_call(
            "train_step", lambda: step(params, opt, *shard)[2], dev, last)
        per_step.append(counted)
        traced = counted if last else traced
        losses.append(loss)
        if i == 0:
            grads = par.gather_shards(
                {n: p.grad for n, p in params.named_parameters()}, mesh)
            saved[case["name"]] = {
                "loss": loss.item(),
                "grads": {n: g.float().cpu() for n, g in grads.items()}}
    compiled = losses + list(params.parameters()) + [
        t for st in opt.state.values() for t in st.values()]
    check(all(torch.equal(a, b) for a, b in zip(compiled, eager,
                                                 strict=True)),
          f"9b {case['name']}: compiled steps differ from eager ones")
    del eager, compiled
    out = {"losses": [x.item() for x in losses],
           "bit_identical": True, "launches_per_step": per_step,
           "traced_replay_launches": traced,
           "capturable": bool(opt.param_groups[0]["capturable"])}
    if case.get("restore"):
        out["restore"] = _gang_restore(step, params, opt, shard, captured)
    if captured:
        # Under gloo the compiled path is the eager body: nothing to time.
        out["turns"] = _turns_ms(lambda: step(params, opt, *shard),
                                 lambda: step(params, opt, *shard))
    return {**_gang_record(dev, mesh, *begin), **out}


def _gang_restore(step, params, opt, shard, captured: bool) -> dict:
    """Save (one process's checkpoint of this rank's state), take a step,
    restore, take the step again: it must not miss (where the step is
    ``captured``, both steps replay) and must give the step's loss again,
    bit for bit, with AdamW's ``step`` on the parameters' device."""
    before = graphs.stats()["train_step"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke-restore-") as tmp:
        ckpt = CK.Checkpointer(CK.CheckpointConfig(tmp))
        ckpt.save(1, params, opt, force=True)
        ckpt.wait()
        after_save = step(params, opt, *shard)[2].clone()
        restored = ckpt.restore(params, opt)
        ckpt.close()
    again = step(params, opt, *shard)[2]
    stats = graphs.stats()["train_step"]
    on_device = all(st["step"].device == p.device
                    for p, st in opt.state.items())
    check(restored is not None and stats["misses"] == before["misses"]
          and stats["replays"] == before["replays"] + 2 * captured
          and torch.equal(again, after_save) and on_device,
          f"9b restore: misses {before['misses']} -> {stats['misses']}, "
          f"replays {before['replays']} -> {stats['replays']}, loss "
          f"{again.item()} against {after_save.item()}, step on the "
          f"parameters' device {on_device}")
    return {"misses_after": stats["misses"], "replayed": captured,
            "loss_repeated": True, "step_on_device": on_device}


def _gang_generate(case: dict, dev: torch.device, width: str, begin: tuple,
                   saved: dict) -> dict:
    """``generate(mesh=)``, 8 x (128 + 64) at flagship width: greedy
    compiled (a capture, then a traced replay) against eager, and sampled
    (captured drawing from one generator, replayed with it and another)
    against eager calls from generators seeded alike on every rank; every
    rank must hold the same streams. Then host ms in turns."""
    cfg, _ = _gang_config(width)
    mesh = par.make_mesh(*case["mesh"])
    rows, prompt, n_new = ((8, 128, 64) if width == "flagship"
                           else (2, 8, 4))
    params = par.shard_params(M.init_params(E.dryrun_generator(4), cfg,
                                            dev), mesh)
    prompts = torch.randint(0, cfg.vocab_size, (rows, prompt),
                            generator=E.dryrun_generator(5)).to(dev)
    attn = FA.best_attn_fn(dev)
    captured = graphs.captures(dev, mesh)

    def call(g=None):
        return S.generate(params, prompts, cfg, n_new, prompt + n_new,
                          attn_fn=attn, temperature=0.8 if g else 0.0,
                          generator=g, mesh=mesh)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    first = call()
    replayed, traced = _traced_call("generate", call, dev, captured)
    with graphs.disabled():
        eager = call()
    ga, gb, ra, rb = (gen(x) for x in (21, 22, 21, 22))
    got = [call(ga)]
    for g in (ga, gb):
        got.append(_traced_call("generate", lambda g=g: call(g), dev,
                                captured)[0])
    with graphs.disabled():
        want = [call(g) for g in (ra, ra, rb)]
    draws = all(torch.equal(a.get_state(), b.get_state())
                for a, b in ((ga, ra), (gb, rb)))
    every = C.all_gather(torch.stack(got)[None], mesh.group(*mesh.axes), 0)
    check(torch.equal(first, eager) and torch.equal(replayed, eager)
          and all(torch.equal(a, b) for a, b in zip(got, want)) and draws,
          f"9b {case['name']}: compiled streams or draws differ from eager")
    check(bool((every == every[0]).all()), f"9b {case['name']}: ranks hold "
                                           f"different sampled streams")
    check(tuple(first.shape) == (rows, prompt + n_new)
          and torch.equal(first[:, :prompt], prompts),
          f"9b {case['name']}: stream {tuple(first.shape)}")
    out = {"bit_identical": True, "ranks_agree": True,
           "shape": list(first.shape), "traced_replay_launches": traced,
           "turns": _turns_ms(call, call),
           "sampled_turns": _turns_ms(lambda: call(ra), lambda: call(ga),
                                      rounds=1)}
    return {**_gang_record(dev, mesh, *begin), **out}


def _gang_pipe(case: dict, dev: torch.device, width: str, begin: tuple,
               saved: dict) -> dict:
    """A flagship pipe (``make_flagship_pipeline`` over pp, the case's
    axes), eager and then compiled from the same init: with ``gpipe``,
    first the GPipe forward of the stages (a capture, a traced replay);
    then ``COMPILED_CALLS`` 1F1B calls (the last traced) with an eager
    AdamW step after each; hidden states, losses, gradients and weights
    bit for bit; then host ms in turns. Keeps the first call's loss and
    gathered gradients, and the GPipe's last-stage hidden states, in
    ``saved``."""
    cfg, shape = _gang_config(width)
    mesh = par.make_mesh(*case["mesh"])
    kw, m = case.get("kw", {}), case["m"]
    init_fn, train_fn = PP.make_flagship_pipeline(
        cfg, mesh, "pp", n_microbatches=m, device=dev, **kw)
    tokens = torch.randint(0, cfg.vocab_size, shape,
                           generator=E.dryrun_generator(1)).to(dev)
    targets = torch.roll(tokens, -1, dims=1)
    captured = graphs.captures(dev, mesh)
    gen = E.dryrun_generator

    def calls(stage, edge, call) -> list:
        """``COMPILED_CALLS`` 1F1B calls ``call(i)``, an eager AdamW step
        after each: each loss and gradient, then the weights."""
        params = [*stage.parameters(), *edge.parameters()]
        opt = T.make_optimizer()(params)
        got = []
        for i in range(COMPILED_CALLS):
            got += [call(i), *(p.grad.clone() for p in params)]
            opt.step()
        return got + [p.detach().clone() for p in params]

    stage, edge = init_fn(gen(0))
    fwd = (PP.make_pipeline_fn(train_fn.stage_fn, mesh, "pp",
                               n_microbatches=m)
           if case.get("gpipe") else None)
    with torch.no_grad():
        x = edge["embed"][tokens.chunk(mesh.dp)[mesh.dp_rank]]
    with graphs.disabled():
        hidden = fwd(stage, x) if fwd else None
        eager = calls(stage, edge,
                      lambda i: train_fn(stage, edge, tokens, targets))
    stage, edge = init_fn(gen(0))
    out, per_call = {}, []
    if fwd:
        first = fwd(stage, x)
        replayed, out["gpipe_traced"] = _traced_call(
            "pipe_gpipe", lambda: fwd(stage, x), dev, captured)
        check(torch.equal(first, hidden) and torch.equal(replayed, hidden),
              f"9b {case['name']}: GPipe calls differ from eager")
        every = C.all_gather(first[None], mesh.group("dp", "pp"), 0)
        saved[f"{case['name']}_gpipe"] = torch.cat(
            [PP.last_stage_output(o)
             for o in every[mesh.pp - 1::mesh.pp]]).cpu()
        out["gpipe_turns"] = _turns_ms(lambda: fwd(stage, x),
                                       lambda: fwd(stage, x))

    def compiled_call(i):
        last = captured and i == COMPILED_CALLS - 1
        loss, counted = _traced_call(
            "pipe_1f1b", lambda: train_fn(stage, edge, tokens, targets),
            dev, last)
        per_call.append(counted)
        if last:
            out["traced_replay_launches"] = counted
        if i == 0:
            saved[case["name"]] = {
                "loss": loss.item(),
                "grads": {n: g.float() for n, g in E.pipe_grads(
                    stage, edge, mesh, "pp", kw.get("tp_axis")).items()}}
        return loss

    compiled = calls(stage, edge, compiled_call)
    check(all(torch.equal(a, b) for a, b in zip(compiled, eager,
                                                 strict=True)),
          f"9b {case['name']}: compiled pipe calls differ from eager ones")
    n = len(list(stage.parameters())) + len(list(edge.parameters()))
    out.update(bit_identical=True, launches_per_call=per_call,
               microbatches=m, layers_per_stage=cfg.n_layers // mesh.pp,
               stash_peak=train_fn.pipe.stash_peak,
               losses=[x.item() for x in compiled[:COMPILED_CALLS * (n + 1)
                                                  :n + 1]],
               turns=_turns_ms(
                   lambda: train_fn(stage, edge, tokens, targets),
                   lambda: train_fn(stage, edge, tokens, targets)))
    return {**_gang_record(dev, mesh, *begin), **out}


def _gang_moe(case: dict, dev: torch.device, width: str, begin: tuple,
              saved: dict) -> dict:
    """The ring-MoE's value and gradient over sp (``entry.moe_inputs``:
    E = 2·sp, fp32), ``COMPILED_CALLS`` calls eager, then as many
    compiled (the last traced): losses, outputs and gradients bit for
    bit. Keeps the last call's output and gradients, gathered, in
    ``saved``."""
    mesh = par.make_mesh(*case["mesh"])
    params, x = E.moe_inputs(width if width == "flagship" else "tiny", mesh,
                             dev)
    xs = x.chunk(mesh.sp, dim=1)[mesh.sp_rank]
    vg = moe.make_ring_moe_value_and_grad(mesh, "sp")
    captured = graphs.captures(dev, mesh)

    def calls(call) -> tuple[dict, list]:
        """``COMPILED_CALLS`` calls ``call(placed, i)`` on fresh shards:
        the shards, and each loss, output and gradient."""
        placed = {k: v.clone().requires_grad_() for k, v in
                  moe.place_moe_params(params, mesh, "sp").items()}
        got = []
        for i in range(COMPILED_CALLS):
            got += [*call(placed, i),
                    *(placed[k].grad.clone() for k in sorted(placed))]
        return placed, got

    with graphs.disabled():
        _, eager = calls(lambda placed, i: vg(placed, xs, x.numel()))
    out = {}

    def compiled_call(placed, i):
        last = captured and i == COMPILED_CALLS - 1
        got, counted = _traced_call(
            "moe_value_and_grad", lambda: vg(placed, xs, x.numel()), dev,
            last)
        if last:
            out["traced_replay_launches"] = counted
        return got

    placed, compiled = calls(compiled_call)
    check(all(torch.equal(a, b) for a, b in zip(compiled, eager,
                                                 strict=True)),
          f"9b {case['name']}: compiled MoE calls differ from eager ones")
    loss, y = compiled[-5:-3]
    group = mesh.sp_group
    saved[case["name"]] = {
        "loss": loss.item(), "y": C.all_gather(y, group, 1).cpu(),
        "grads": {"router": placed["router"].grad.cpu(),
                  **{k: C.all_gather(placed[k].grad, group, 0).cpu()
                     for k in ("w1", "w2")}}}
    out.update(bit_identical=True, experts=params["w1"].shape[0],
               turns=_turns_ms(lambda: vg(placed, xs, x.numel()),
                               lambda: vg(placed, xs, x.numel())))
    return {**_gang_record(dev, mesh, *begin), **out}


GANG_CASES = {"train": _gang_train, "generate": _gang_generate,
              "pipe": _gang_pipe, "moe": _gang_moe}


def compiled_gang_rank(spec: dict) -> int:
    """One rank of a compiled gang: join the gang (``spec["backend"]``,
    one card a rank over NCCL), run each of ``spec["cases"]`` (a fresh
    registry and stats each), print one JSON line of every case's record;
    rank 0 saves the cases' first-step arrays to ``spec["save"]``. Any
    failed check raises."""
    dev = torch.device(spec.get("device", "cuda"))
    width = spec.get("width", "flagship")
    if torchenv.init_distributed(backend=spec["backend"], device=dev) is None:
        # A gang of one is no gang by the pod's env: its group is made here.
        if dev.type == "cuda":
            torch.cuda.set_device(0)
        torch.distributed.init_process_group(
            spec["backend"], world_size=1, rank=0,
            init_method=f"tcp://localhost:{launch.free_port()}")
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    rank = torch.distributed.get_rank()
    record, saved = {"rank": rank, "device": str(dev), "cases": {}}, {}
    try:
        for case in spec["cases"]:
            graphs.clear()
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
            begin = (_counts(), time.perf_counter())
            record["cases"][case["name"]] = GANG_CASES[case["kind"]](
                case, dev, width, begin, saved)
        if rank == 0 and spec.get("save"):
            torch.save(saved, spec["save"])
    finally:
        # A graph that holds NCCL work keeps its communicator: free the
        # graphs before the groups go.
        graphs.clear()
        torch.distributed.destroy_process_group()
    print(json.dumps(record), flush=True)
    return 0


def compiled_gang(cases, world: int, backend: str, *, save=None,
                  env=None, width: str = "flagship",
                  device: str = "cuda") -> list[dict]:
    """Run ``cases`` in one gang of ``world`` ranks of
    :func:`compiled_gang_rank` (``runtime.launch``) and hold what the
    ranks agree on: every rank's stats and captures' growth equal, one
    miss a key and, where the gang captures, a replay for every later
    call. Returns the rank records."""
    spec = {"cases": list(cases), "backend": backend, "save": save,
            "width": width, "device": device}
    records = launch.launch(
        [os.path.abspath(__file__), COMPILED_GANG_FLAG, json.dumps(spec)],
        world, deadline_s=COMPILED_GANG_DEADLINE_S, env=env)
    for case in cases:
        recs = [r["cases"][case["name"]] for r in records]
        first = recs[0]
        check(all(r["stats"] == first["stats"]
                  and [[c["growth"] for c in v] for v in
                       r["captures"].values()]
                  == [[c["growth"] for c in v] for v in
                      first["captures"].values()] for r in recs),
              f"9b {case['name']}: ranks disagree on the registry: "
              f"{[r['stats'] for r in recs]}")
        for name, st in first["stats"].items():
            check(st["misses"] >= 1, f"9b {case['name']}: {name} {st}")
            if first["captured_here"]:
                check(st["replays"] > 0 and len(first["captures"][name])
                      == st["misses"],
                      f"9b {case['name']}: {name} {st}, captures "
                      f"{first['captures'].get(name)}")
            else:
                check(st["replays"] == 0 and not first["captures"],
                      f"9b {case['name']}: {name} captured under "
                      f"{first['backend']}: {st}")
    return records


def _traced_equal_recorded(name: str, recs: list[dict]) -> dict:
    """A case's traced replay launches, one dict a graph it traced, each
    equal to the growth its capture recorded (the rank body's
    ``_replays`` already held them to the counters)."""
    out = {}
    for key in ("traced_replay_launches", "gpipe_traced"):
        traced = recs[0].get(key)
        if traced is None or not recs[0]["captured_here"]:
            continue
        graph = {"gpipe_traced": "pipe_gpipe"}.get(key) or {
            "train": "train_step", "generate": "generate",
            "pipe": "pipe_1f1b", "moe": "moe_value_and_grad"}[
            name.split("_")[0]]
        growth = dict(zip(_counts(), recs[0]["captures"][graph][-1]
                          ["growth"]))
        check(all(r.get(key) == traced for r in recs) and traced == growth,
              f"9b {name}: traced {traced}, recorded {growth}")
        out[graph] = traced
    return out


def four_card_gangs(cfg: M.ModelConfig, cards: int, ref: dict | None = None,
                    env=None, strict: bool = True) -> dict:
    """(c) :data:`FOUR_CARD_CASES`, one NCCL gang of four ranks (one a
    card) for the cases of each kind: each compiled against eager bit for
    bit, traced, and the first step of each train case and pipe held to
    the single-process kernel step ``ref`` at phase 5b's bounds (the
    GPipe's hidden states at ``GPIPE_TOL``, the MoE at ``MOE_TOL`` against
    one process). A gang that fails is recorded under ``failed`` and the
    other kinds still run; with ``strict`` a failure then raises. What
    ``tools/nccl_gang.py --compiled`` runs."""
    check(cards >= 4, f"the four-card gangs need four cards, have {cards}")
    ref = ref or single_process_step(cfg)
    fields = {"cards": cards, "ranks": 4, "backend": "nccl", "seconds": {},
              "cases": {}, "failed": {}}
    kinds = dict.fromkeys(c["kind"] for c in FOUR_CARD_CASES)
    for kind in kinds:
        cases = [c for c in FOUR_CARD_CASES if c["kind"] == kind]
        t0 = time.perf_counter()
        try:
            with tempfile.TemporaryDirectory(prefix="chip_smoke-9b-") as tmp:
                save = os.path.join(tmp, "saved.pt")
                records = compiled_gang(cases, 4, "nccl", save=save, env=env)
                saved = torch.load(save)
            for case in cases:
                fields["cases"][case["name"]] = _four_card_case(
                    case, records, saved, ref)
        except (launch.GangError, RuntimeError) as exc:
            fields["failed"][kind] = str(exc)[-3000:]
        fields["seconds"][kind] = time.perf_counter() - t0
    check(not (strict and fields["failed"]),
          f"9b (c): gangs failed: {fields['failed']}")
    return fields


def _four_card_case(case: dict, records: list, saved: dict,
                    ref: dict) -> dict:
    """A four-card case's fields, and its first step held to the single
    process's."""
    name = case["name"]
    recs = [r["cases"][name] for r in records]
    rec = {"mesh": case["mesh"], **_gang_fields(recs),
           "traced": _traced_equal_recorded(name, recs)}
    got = saved.get(name)
    if case["kind"] in ("train", "pipe"):
        loss_err = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
        errs = {n: _norm_err(g.cuda(), ref["grads"][n])
                for n, g in got["grads"].items()}
        worst = max(errs, key=errs.get)
        check(set(errs) == set(ref["grads"])
              and loss_err <= TRAIN_LOSS_TOL
              and errs[worst] <= TRAIN_GRAD_TOL,
              f"9b {name}: first step off the single process's: loss "
              f"{loss_err}, {worst} {errs[worst]}")
        rec.update(vs_single_loss_rel_err=loss_err,
                   vs_single_max_grad_err=errs[worst],
                   vs_single_worst_leaf=worst)
    if case.get("gpipe"):
        err = _norm_err(saved[f"{name}_gpipe"].cuda().float(),
                        ref["hidden"].float())
        check(err <= GPIPE_TOL, f"9b {name}: GPipe hidden off by {err}")
        rec["gpipe_vs_single_hidden_err"] = err
    if case["kind"] == "moe":
        want = moe_reference(",".join(map(str, case["mesh"])))
        errs = {"y": _norm_err(got["y"].cuda(), want["y"]),
                **{k: _norm_err(g.cuda(), want["grads"][k])
                   for k, g in got["grads"].items()}}
        worst = max(errs, key=errs.get)
        check(set(errs) == {"y", "router", "w1", "w2"}
              and errs[worst] <= MOE_TOL,
              f"9b {name}: {worst} off one process's by {errs[worst]}")
        rec["vs_single_errs"] = errs
    return rec


def _gang_fields(recs: list[dict]) -> dict:
    """The per-rank numbers of a case, side by side."""
    first = recs[0]
    keys = ("turns", "sampled_turns", "gpipe_turns", "peak_reserved_bytes",
            "peak_allocated_bytes", "pool_bytes", "seconds", "launches",
            "replayed", "launches_per_step", "launches_per_call",
            "stash_peak", "restore", "capturable", "losses")
    out = {"backend": first["backend"], "captured": first["captured_here"],
           "stats": first["stats"],
           "capture_s": {n: [c["seconds"] for c in v]
                         for n, v in first["captures"].items()}}
    for key in keys:
        if key in first:
            out[f"{key}_by_rank"] = [r.get(key) for r in recs]
    return out


def compiled_mesh_phase(cfg: M.ModelConfig, cards: int, ref=None,
                        env=None) -> dict:
    """Phase 9b on this host: (a) :data:`ONE_CARD_CASES` in a one-rank
    NCCL gang (its collectives are no-ops at size 1: the train step
    reduces nothing, ring attention over one shard shifts nothing) and,
    at the same time, (b) :data:`GLOO_CASES` in a two-rank gloo gang on
    the card, eager by the backend rule; then (c) with four cards or more,
    :func:`four_card_gangs`. Returns the phase's fields; ``launches``
    sums each path's launches over its ranks, ``replayed`` and
    ``traced_launches`` those inside replays (derived, and traced)."""
    fields = {"cards": cards, "gangs": []}
    launches, replayed, traced = {}, {}, {}

    def timed(cases, world: int, backend: str) -> tuple[list, float]:
        t0 = time.perf_counter()
        records = compiled_gang(cases, world, backend, env=env)
        return records, time.perf_counter() - t0

    (one, one_s), (two, two_s) = concurrently(
        lambda: timed(ONE_CARD_CASES, 1, "nccl"),
        lambda: timed(GLOO_CASES, 2, "gloo"))
    fields["a_one_rank_nccl"] = {
        "collectives": "none issued: every group of a (1,1,1) mesh holds "
                       "one rank",
        "seconds": one_s,
        **{c["name"]: {**_gang_fields([one[0]["cases"][c["name"]]]),
                       "traced": _traced_equal_recorded(
                           c["name"], [one[0]["cases"][c["name"]]]),
                       **{k: one[0]["cases"][c["name"]].get(k)
                          for k in ("bit_identical", "restore", "shape")}}
           for c in ONE_CARD_CASES}}
    fields["gangs"].append("a: 1 rank, nccl, (1,1,1)")
    for c in ONE_CARD_CASES:
        rec = one[0]["cases"][c["name"]]
        check(rec["captured_here"] and rec["stats"][
            {"train": "train_step", "generate": "generate"}[c["kind"]]][
            "replays"] > 0, f"9b (a) {c['name']}: nothing replayed")
    for c in GLOO_CASES:
        recs = [r["cases"][c["name"]] for r in two]
        check(not recs[0]["captured_here"]
              and recs[0]["stats"]["train_step"]["keys"] == 1
              and not any(r["capturable"] for r in recs),
              f"9b (b): a gloo gang captured or made AdamW capturable: "
              f"{recs[0]['stats']}")
        fields["b_two_rank_gloo"] = {"seconds": two_s,
                                     c["name"]: _gang_fields(recs)}
    fields["gangs"].append("b: 2 ranks, gloo, (1,1,2) ring, eager")
    groups = [(one, ONE_CARD_CASES), (two, GLOO_CASES)]
    if cards >= 4:
        # Every card of the host to the ranks, rank i on card i.
        four = four_card_gangs(cfg, cards, ref, env={
            **(env or {}),
            "CUDA_VISIBLE_DEVICES": ",".join(map(str, range(cards)))})
        fields["c_four_card_nccl"] = four
        fields["gangs"].append("c: 4 ranks, nccl, one a card")
        groups.append((None, FOUR_CARD_CASES))
        for case in FOUR_CARD_CASES:
            rec = four["cases"][case["name"]]
            path = f"compiled_mesh_{case['name']}_4cards"
            launches[path] = _sum_counts(rec["launches_by_rank"])
            replayed[path] = _sum_counts(rec["replayed_by_rank"])
            traced[path] = _sum_counts(rec["traced"].values())
    else:
        fields["c_four_card_nccl"] = (f"not run: {cards} card(s); "
                                      f"tools/nccl_gang.py runs it on four")
    for records, cases in groups[:2]:
        for case in cases:
            recs = [r["cases"][case["name"]] for r in records]
            path = f"compiled_mesh_{case['name']}"
            launches[path] = _sum_counts(r["launches"] for r in recs)
            replayed[path] = _sum_counts(r["replayed"] for r in recs)
            if recs[0]["captured_here"]:
                traced[path] = _sum_counts(_traced_equal_recorded(
                    case["name"], recs).values())
    fields.update(launches=launches, replayed=replayed,
                  traced_launches=traced)
    return fields


def _sum_counts(dicts) -> dict:
    out = dict.fromkeys(_counts(), 0)
    for d in dicts:
        for k in out:
            out[k] += d[k]
    return out


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
    if sys.argv[1:] == [TENANT_FLAG]:
        sys.exit(allocated_tenant())
    if sys.argv[1:] == [HELD_TENANT_FLAG]:
        sys.exit(allocated_tenant(hold=True))
    if sys.argv[1:] == [GATED_TENANT_FLAG]:
        sys.exit(allocated_tenant(hold=True, gated=True))
    if sys.argv[1:2] == [COMPILED_GANG_FLAG]:
        sys.exit(compiled_gang_rank(json.loads(sys.argv[2])))
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as tmp:
        code = main(tmp)
    sys.exit(code)
