"""Causal flash attention, forward and backward: the hand-written CUDA
kernels (``tpushare_torch/csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``), their
plain PyTorch versions, and the autograd wiring between them.

Port of ``tpushare/workload/flash_attention.py``. Dispatch goes by where
the tensors lie: a CPU tensor takes the plain versions; a CUDA tensor
launches the kernels or raises. There is no fallback on the card and no
switch that swaps the plain versions in.

Each kernel source is built with ``nvcc`` for ``sm_90a`` into a shared
library with plain C entries, at first use, under ``build/tpushare_torch/``
in the checkout, named by the hash of its source and of every header in
``csrc/`` (a changed source or header builds anew), and loaded with
``ctypes``. Launches go to the current stream. All three bf16 kernels
(forward, dq and dk/dv) read their tiles with TMA, and all three fp32
kernels with 16-byte ``cp.async``; both need a 16-byte aligned base and
strides that are multiples of 16 bytes (:func:`tma_problem`), and every
wrapper raises on anything else. The fp32 kernels run their products on
the tensor cores in split-three TF32, which keeps fp32's precision (one
TF32 pass would not). Head dims are 16, 64 and 128 in both dtypes.

Gradients: :func:`flash_block_with_lse` (and :func:`flash_attention`, its
output alone) are one ``torch.autograd.Function`` when an input requires
grad, the twin of the JAX package's ``custom_vjp`` pair. Its forward saves
``(q, k, v, out, lse)``; its backward runs the dq and dk/dv kernels with
the lse cotangent folded into ``delta``. The raw kernel entries refuse
inputs that require grad, so none of them is ever silently
non-differentiable.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch
from torch.autograd.function import once_differentiable

from tpushare_torch.utils.device import resolve_device
from tpushare_torch.workload import model as M

NEG_INF = -2.0 ** 30  # large-but-finite: keeps exp() exact zeros, no NaNs

#: Kernel launches so far; each incremented once per launch, nowhere else.
FLASH_FWD_LAUNCHES = 0
FLASH_BWD_DQ_LAUNCHES = 0
FLASH_BWD_DKV_LAUNCHES = 0

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpushare_torch"
#: Head dims the kernels are built for, in both dtypes.
_HEAD_DIMS = (16, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: Library -> {C entry: (pointer arguments, stride arguments)}. Every entry
#: then takes dtype, B, H, Lq, Lk, D, the strides, q_offset, kv_offset and
#: the stream.
_ENTRIES = {
    "flash_fwd": {"tpushare_flash_fwd": (5, 9)},
    "flash_bwd": {"tpushare_flash_bwd_dq": (7, 12),
                  "tpushare_flash_bwd_dkv": (8, 12)},
}
_fns: dict[str, ctypes._CFuncPtr] = {}
_lib_lock = threading.Lock()


# --------------------------------------------------------------------------
# Build and bind
# --------------------------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the flash-attention kernels")


def _lib_path(name: str) -> Path:
    """The library built from ``{name}.cu``, named by the hash of that
    source and of every ``csrc/*.cuh`` it may include."""
    digest = hashlib.sha256()
    for src in (_CSRC / f"{name}.cu", *sorted(_CSRC.glob("*.cuh"))):
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    return _BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def nvcc_command(source: str | Path, out: str | Path) -> list[str]:
    """The ``nvcc`` command that builds the kernel source ``source`` into
    the shared library ``out``."""
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-o", str(out), str(source)]


def bind_library(path: str | Path, name: str) -> dict[str, ctypes._CFuncPtr]:
    """Load the library ``path`` built from ``{name}.cu`` and type its C
    entries."""
    lib = ctypes.CDLL(str(path))
    fns = {}
    for sym, (n_ptr, n_strides) in _ENTRIES[name].items():
        fn = getattr(lib, sym)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * n_strides
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[sym] = fn
    return fns


def build(*names: str) -> dict[str, float]:
    """Compile each named kernel library (all by default) that has no
    build of its exact source, one ``nvcc`` each, all started together.
    Returns the seconds from the common start until each build was
    collected (0.0 for one found built)."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds, jobs = {}, {}
    t0 = time.perf_counter()
    try:
        for name in names or tuple(_ENTRIES):
            lib = _lib_path(name)
            if lib.exists():
                seconds[name] = 0.0
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            cmd = nvcc_command(_CSRC / f"{name}.cu", tmp)
            jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True),
                          tmp, lib)
        failed = []
        for name, (proc, tmp, lib) in jobs.items():
            _, err = proc.communicate()
            seconds[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc failed ({proc.returncode}):\n"
                              f"{err}")
            else:
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for proc, tmp, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return seconds


def _bind(entry: str) -> ctypes._CFuncPtr:
    """The C entry ``entry``, its library built and loaded on first use."""
    with _lib_lock:
        if entry not in _fns:
            name = next(n for n, e in _ENTRIES.items() if entry in e)
            build(name)
            _fns.update(bind_library(_lib_path(name), name))
        return _fns[entry]


def build_seconds() -> dict[str, float]:
    """Build (or find) every kernel library, all together, and load each;
    the seconds each build took."""
    seconds = build()
    for entries in _ENTRIES.values():
        for entry in entries:
            _bind(entry)
    return seconds


def _launch(entry: str, args: tuple, q: torch.Tensor) -> None:
    """Call a C entry on q's device and current stream; raise on a CUDA
    error."""
    fn = _fns.get(entry) or _bind(entry)
    # The launch goes to the current device; switch only when q is elsewhere
    # (the context manager costs as much as the rest of a wrapper).
    if q.get_device() == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(q.device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")


# --------------------------------------------------------------------------
# The kernels' wrappers and their plain versions
# --------------------------------------------------------------------------

def _check_kernel_inputs(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> None:
    """Raise on anything the kernels do not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, L, H, D]")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} must "
                         f"share B, H and D")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the kernel "
                         f"takes float32 or bfloat16, all alike")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[-1]} not supported by the "
                         f"kernels (one of {_HEAD_DIMS})")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the head_dim axis of q, k, v must be unit-stride")
    if any(t.requires_grad for t in (q, k, v)):
        raise ValueError("the raw kernel entries record no gradient; call "
                         "flash_block_with_lse, or call them on detached "
                         "tensors or under torch.inference_mode()")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"the kernel needs q, k, v on one CUDA device, got "
                         f"{q.device}/{k.device}/{v.device}")


def _check_bwd_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, lse: torch.Tensor,
                      delta: torch.Tensor) -> None:
    """Raise on anything the backward kernels do not take."""
    if (do.shape != q.shape or do.dtype != q.dtype or do.stride(-1) != 1
            or do.requires_grad or do.device != q.device):
        raise ValueError(f"do must be like q: {tuple(do.shape)} {do.dtype} "
                         f"on {do.device}, unit-stride head_dim, no grad")
    rows = tuple(q.shape[:3])
    for name, t in (("lse", lse), ("delta", delta)):
        if (tuple(t.shape) != rows or t.dtype != torch.float32
                or not t.is_contiguous() or t.requires_grad
                or t.device != q.device):
            raise ValueError(f"{name} must be contiguous float32 {rows} on "
                             f"{q.device} with no grad, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    _check_kernel_inputs(q, k, v)


def tma_problem(shape, strides, data_ptr: int, itemsize: int) -> str | None:
    """Why TMA (or 16-byte ``cp.async``, which has the same rule) cannot
    read a [B, L, H, D] tensor of this shape, these element strides, base
    address and element size, or None if it can: a 16-byte aligned base
    and (batch, length, head) strides that are positive multiples of 16
    bytes below 2**40 (an axis of size 1 is never stepped, so its stride
    does not matter)."""
    if data_ptr % 16:
        return f"its base address {data_ptr:#x} is not 16-byte aligned"
    for axis, n, s in zip(("batch", "length", "head"), shape[:3],
                          strides[:3]):
        nbytes = s * itemsize
        if n > 1 and (nbytes <= 0 or nbytes % 16 or nbytes >= 1 << 40):
            return (f"its {axis} stride of {nbytes} bytes is not a positive "
                    f"multiple of 16 below 2**40")
    return None


def _read_problem(t: torch.Tensor) -> str | None:
    """:func:`tma_problem` of a tensor, with the common case in one test
    (the wrapper's host time is on the serving path): aligned base,
    positive strides in multiples of 16 bytes below 2**40 bytes."""
    ptr, (sb, sl, sh, _) = t.data_ptr(), t.stride()
    size = t.element_size()
    if (ptr % 16 == 0 and (sb | sl | sh) % (16 // size) == 0
            and 0 < min(sb, sl, sh) and max(sb, sl, sh) * size < 1 << 40):
        return None
    return tma_problem(t.shape, t.stride(), ptr, size)


def _check_tma(**tensors: torch.Tensor) -> None:
    """Raise unless every tensor given can be read as the kernels read
    it: by TMA in bf16, by 16-byte ``cp.async`` in fp32 (the same rule)."""
    for name, t in tensors.items():
        problem = _read_problem(t)
        if problem:
            feed = ("TMA-fed bf16" if t.dtype == torch.bfloat16
                    else "cp.async-fed fp32")
            raise ValueError(f"{name} cannot feed the {feed} kernel: "
                             f"{problem}")


def _kernel_cotangent(do: torch.Tensor) -> torch.Tensor:
    """``do`` as the backward kernels read it: a fresh contiguous copy
    when its layout is one they cannot (e.g. the stride-0 cotangent of a
    ``sum()``, or a view at an odd offset), else ``do`` itself. The
    caller does not choose the cotangent's layout, so it is copied, not
    refused."""
    if do.stride(-1) != 1 or _read_problem(do):
        return do.clone(memory_format=torch.contiguous_format)
    return do


def _strides(*ts: torch.Tensor) -> tuple[int, ...]:
    """(batch, length, head) strides of each [B, L, H, D] tensor."""
    return tuple(s for t in ts for s in t.stride()[:3])


def flash_fwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_offset: int = 0, kv_offset: int = 0
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel: ([B, Lq, H, D] out in q's dtype,
    [B, Lq, H] fp32 lse)."""
    global FLASH_FWD_LAUNCHES
    _check_kernel_inputs(q, k, v)
    _check_tma(q=q, k=k, v=v)
    b, lq, h, d = q.shape
    out = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, lq, h), dtype=torch.float32, device=q.device)
    _launch("tpushare_flash_fwd",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), _DTYPE_CODE[q.dtype], b, h, lq, k.shape[1], d,
             *_strides(q, k, v), int(q_offset), int(kv_offset)), q)
    FLASH_FWD_LAUNCHES += 1
    return out, lse


def flash_bwd_dq_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, lse: torch.Tensor,
                        delta: torch.Tensor, q_offset: int = 0,
                        kv_offset: int = 0) -> torch.Tensor:
    """Launch the dq kernel: [B, Lq, H, D] dq in q's dtype. ``lse`` is the
    forward's, ``delta`` = rowsum(do * out) - dlse, both fp32 [B, Lq, H]."""
    global FLASH_BWD_DQ_LAUNCHES
    _check_bwd_inputs(q, k, v, do, lse, delta)
    _check_tma(q=q, k=k, v=v, do=do)
    b, lq, h, d = q.shape
    dq = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    _launch("tpushare_flash_bwd_dq",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
             _DTYPE_CODE[q.dtype], b, h, lq, k.shape[1], d,
             *_strides(q, k, v, do), int(q_offset), int(kv_offset)), q)
    FLASH_BWD_DQ_LAUNCHES += 1
    return dq


def flash_bwd_dkv_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         do: torch.Tensor, lse: torch.Tensor,
                         delta: torch.Tensor, q_offset: int = 0,
                         kv_offset: int = 0
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the dk/dv kernel: ([B, Lk, H, D] dk, dv) in k's dtype, from
    the same inputs as :func:`flash_bwd_dq_kernel`."""
    global FLASH_BWD_DKV_LAUNCHES
    _check_bwd_inputs(q, k, v, do, lse, delta)
    _check_tma(q=q, k=k, v=v, do=do)
    b, lq, h, d = q.shape
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch("tpushare_flash_bwd_dkv",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             _DTYPE_CODE[q.dtype], b, h, lq, k.shape[1], d,
             *_strides(q, k, v, do), int(q_offset), int(kv_offset)), q)
    FLASH_BWD_DKV_LAUNCHES += 1
    return dk, dv


def _mask(lq: int, lk: int, q_offset: int, kv_offset: int,
          device: torch.device) -> torch.Tensor:
    """[Lq, Lk] causal mask on global positions."""
    q_pos = q_offset + torch.arange(lq, device=device)
    kv_pos = kv_offset + torch.arange(lk, device=device)
    return q_pos[:, None] >= kv_pos[None, :]


def flash_block_with_lse_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, q_offset: int = 0,
                               kv_offset: int = 0
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's plain version, twin of the JAX package's
    ``_xla_block_with_lse``: same (out [B, Lq, H, D], lse [B, Lq, H]
    fp32) semantics, with all softmax arithmetic in fp32. A row that
    sees no key gets what the kernel gives it, out 0 and lse
    ``NEG_INF``, where the XLA twin averages ``v``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = _mask(q.shape[1], k.shape[1], q_offset, kv_offset, q.device)
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    # On a row that sees a key exp(NEG_INF - m) is already 0; on one that
    # sees none, m is NEG_INF too and only the mask zeroes p.
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p / l.clamp_min(1e-30), v.float())
    lse = (m + torch.log(l.clamp_min(1e-30)))[..., 0]        # [B, H, Lq]
    lse = torch.where(l[..., 0] > 0, lse, torch.full_like(lse, NEG_INF))
    return out.to(q.dtype), lse.transpose(1, 2)


def flash_bwd_delta(do: torch.Tensor, out: torch.Tensor,
                    dlse: torch.Tensor | None) -> torch.Tensor:
    """delta = rowsum(do * out) - dlse, fp32 [B, Lq, H]: the lse cotangent
    folds in here (with p = exp(s - lse), d lse / d s = p)."""
    delta = (do.float() * out.float()).sum(dim=-1)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


def flash_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                    dlse: torch.Tensor | None = None, q_offset: int = 0,
                    kv_offset: int = 0
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' plain version, twin of the JAX package's
    ``_flash_bwd_call`` in the port's layout ([B, L, H, D] tensors, lse
    and dlse [B, Lq, H]), with the kernels' formulas in fp32. Returns
    (dq, dk, dv) in the input dtypes."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    mask = _mask(q.shape[1], k.shape[1], q_offset, kv_offset, q.device)
    lse_t = lse.float().transpose(1, 2)[..., None]            # [B, H, Lq, 1]
    p = torch.where(mask, torch.exp(torch.clamp_max(s - lse_t, 30.0)), 0.0)
    delta = flash_bwd_delta(do, out, dlse).transpose(1, 2)[..., None]
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------------------------
# Dispatch and autograd
# --------------------------------------------------------------------------

def _block_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_offset: int, kv_offset: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        return flash_block_with_lse_plain(q, k, v, q_offset, kv_offset)
    return flash_fwd_kernel(q, k, v, q_offset, kv_offset)


def _block_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                    dlse: torch.Tensor | None, q_offset: int,
                    kv_offset: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv): :func:`flash_bwd_plain` on the CPU, the dq and dk/dv
    kernels on the card (delta is a plain reduction there, as the JAX
    package left it to XLA)."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, out, lse, do, dlse, q_offset,
                               kv_offset)
    do = _kernel_cotangent(do)
    delta = flash_bwd_delta(do, out, dlse)
    dq = flash_bwd_dq_kernel(q, k, v, do, lse, delta, q_offset, kv_offset)
    dk, dv = flash_bwd_dkv_kernel(q, k, v, do, lse, delta, q_offset,
                                  kv_offset)
    return dq, dk, dv


class _FlashBlock(torch.autograd.Function):
    """Twin of the JAX package's ``custom_vjp`` on ``flash_block_with_lse``:
    the forward saves (q, k, v, out, lse); the backward rebuilds each
    tile's probabilities from them, so no [Lq, Lk] matrix is stored."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, kv_offset):
        out, lse = _block_forward(q.detach(), k.detach(), v.detach(),
                                  q_offset, kv_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.offsets = (q_offset, kv_offset)
        # An unused output's cotangent arrives as None, not zeros.
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    @once_differentiable
    def backward(ctx, do, dlse):
        if do is None and dlse is None:
            return None, None, None, None, None
        q, k, v, out, lse = (t.detach() for t in ctx.saved_tensors)
        if do is None:
            do = torch.zeros_like(out)
        dq, dk, dv = _block_backward(q, k, v, out, lse, do, dlse,
                                     *ctx.offsets)
        return dq, dk, dv, None, None


def flash_block_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_offset: int = 0, kv_offset: int = 0
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Local Q against one KV block at global offsets: (out [B, Lq, H, D],
    lse [B, Lq, H] fp32), the statistic :func:`merge_partials` combines.
    A row that sees no key gets out 0 and ``lse = NEG_INF``, on the CPU
    and on the card alike, and its gradient is 0: dq is 0 there and it
    adds nothing to dk or dv. (The JAX package's Pallas kernel and XLA
    twin disagree on such rows; ``merge_partials`` weighs them 0 either
    way.) Differentiable in q, k and v (both outputs) when grad is
    enabled; otherwise nothing is saved."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashBlock.apply(q, k, v, q_offset, kv_offset)
    return _block_forward(q, k, v, q_offset, kv_offset)


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Causal flash attention, [B, L, H, D] layout (the model's)."""
    return flash_block_with_lse(q, k, v)[0]


def merge_partials(o1: torch.Tensor, lse1: torch.Tensor, o2: torch.Tensor,
                   lse2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Exactly combine two normalized partial attentions over disjoint KV
    sets from their log-sum-exps. Returns the merged output in fp32."""
    m = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - m)
    w2 = torch.exp(lse2 - m)
    denom = (w1 + w2).clamp_min(1e-30)
    out = (o1.float() * (w1 / denom)[..., None]
           + o2.float() * (w2 / denom)[..., None])
    return out, m + torch.log(denom)


def supported(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Can the kernels, forward and backward, take these inputs?"""
    try:
        _check_kernel_inputs(q, k, v)
        _check_tma(q=q, k=k, v=v)
    except ValueError:
        return False
    return True


def best_attn_fn(device: str | torch.device = "cuda"):
    """The attention for ``device``: the kernel-backed
    :func:`flash_attention` on CUDA, for every length; the plain
    :func:`model.causal_attention` on the CPU."""
    if resolve_device(device).type == "cuda":
        return flash_attention
    return M.causal_attention
