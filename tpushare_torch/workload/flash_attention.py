"""Causal flash attention, forward: the hand-written CUDA kernel
(``tpushare_torch/csrc/flash_fwd.cu``) and its plain PyTorch version.

Port of the forward surface of ``tpushare/workload/flash_attention.py``.
Dispatch goes by where the tensors lie: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises. There is no
fallback on the card and no switch that swaps the plain version in.

The kernel is built with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C entry, at first use, under ``build/tpushare_torch/`` in
the checkout, named by the hash of its source (a changed source builds
anew), and loaded with ``ctypes``. It launches on the current stream.

Gradients are outside this module: the kernel entry refuses inputs that
require grad, so it is never silently non-differentiable.
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

from tpushare_torch.utils.device import resolve_device
from tpushare_torch.workload import model as M

NEG_INF = -2.0 ** 30  # large-but-finite: keeps exp() exact zeros, no NaNs

#: Kernel launches so far; incremented once per launch, nowhere else.
FLASH_FWD_LAUNCHES = 0

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "flash_fwd.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpushare_torch"
_HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib: ctypes.CDLL | None = None
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
                       "the flash-attention kernel")


def build() -> Path:
    """Compile the kernel library unless a build of this exact source
    exists; returns its path."""
    src = _SOURCE.read_bytes()
    digest = hashlib.sha256(src).hexdigest()[:16]
    lib = _BUILD_DIR / f"libflash_fwd-{digest}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-o", tmp, str(_SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.tpushare_flash_fwd
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                           + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 2
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def build_seconds() -> float:
    """Build (or find) and load the kernel library; the seconds it took."""
    t0 = time.perf_counter()
    _load()
    return time.perf_counter() - t0


# --------------------------------------------------------------------------
# The kernel's wrapper and its plain version
# --------------------------------------------------------------------------

def _check_kernel_inputs(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> None:
    """Raise on anything the kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, L, H, D]")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} must "
                         f"share B, H and D")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[-1]} not supported by the "
                         f"kernel (one of {_HEAD_DIMS})")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the kernel "
                         f"takes float32 or bfloat16, all alike")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the head_dim axis of q, k, v must be unit-stride")
    if any(t.requires_grad for t in (q, k, v)):
        raise ValueError("the flash forward kernel has no backward here; "
                         "call it under torch.inference_mode()")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"the kernel needs q, k, v on one CUDA device, got "
                         f"{q.device}/{k.device}/{v.device}")


def flash_fwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_offset: int = 0, kv_offset: int = 0
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel: ([B, Lq, H, D] out in q's dtype,
    [B, Lq, H] fp32 lse)."""
    global FLASH_FWD_LAUNCHES
    _check_kernel_inputs(q, k, v)
    fn = (_lib if _lib is not None else _load()).tpushare_flash_fwd
    b, lq, h, d = q.shape
    lk = k.shape[1]
    out = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, lq, h), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _DTYPE_CODE[q.dtype], b, h, lq, lk, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(q_offset), int(kv_offset))
    # The launch goes to the current device; switch only when q is elsewhere
    # (the context manager costs as much as the rest of this wrapper).
    if q.get_device() == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(q.device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash forward kernel launch failed: CUDA error "
                           f"{err}")
    FLASH_FWD_LAUNCHES += 1
    return out, lse


def flash_block_with_lse_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, q_offset: int = 0,
                               kv_offset: int = 0
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version, twin of the JAX package's
    ``_xla_block_with_lse``: same (out [B, Lq, H, D], lse [B, Lq, H]
    fp32) semantics, with all softmax arithmetic in fp32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
    kv_pos = kv_offset + torch.arange(k.shape[1], device=q.device)
    mask = q_pos[:, None] >= kv_pos[None, :]
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p / l.clamp_min(1e-30), v.float())
    lse = (m + torch.log(l.clamp_min(1e-30)))[..., 0]        # [B, H, Lq]
    lse = torch.where(l[..., 0] > 0, lse, torch.full_like(lse, NEG_INF))
    return out.to(q.dtype), lse.transpose(1, 2)


def flash_block_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_offset: int = 0, kv_offset: int = 0
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Local Q against one KV block at global offsets: (out [B, Lq, H, D],
    lse [B, Lq, H] fp32), the statistic :func:`merge_partials` combines.
    Rows that see no key are unspecified in ``out`` and carry
    ``lse = NEG_INF``."""
    if q.device.type == "cpu":
        return flash_block_with_lse_plain(q, k, v, q_offset, kv_offset)
    return flash_fwd_kernel(q, k, v, q_offset, kv_offset)


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
    """Can the kernel take these inputs?"""
    try:
        _check_kernel_inputs(q, k, v)
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
