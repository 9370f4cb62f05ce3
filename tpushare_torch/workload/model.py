"""Flagship workload: the transformer LM of ``tpushare/workload/model.py``
in PyTorch.

The parameters live in an ``nn.Module`` whose names and layouts are the
JAX tree's (``embed [V, d]``, ``blocks.i.wqkv [d, 3, H, hd]``,
``blocks.i.wo [H, hd, d]`` ...), so weights carry across by plain copy
(:mod:`tpushare_torch.workload.convert`). The layer math stays plain
functions on tensors, rounding to the activation dtype at the same
points as the JAX code, so bf16 results track the reference.

Tensor parallelism: a block whose weights hold this rank's share of the
heads and of the ffn's hidden axis (``parallel.shard_params``) takes the
tp process group as ``tp``; the normed input of each sharded product then
goes through :func:`collectives.copy_to` and its partial output through
:func:`collectives.reduce_from`, the two all-reduces GSPMD inserts in the
JAX package. With ``tp=None`` (one device) nothing is added.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpushare_torch.utils.device import resolve_device
from tpushare_torch.workload import collectives as C


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 1536
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    #: Recompute each block in the backward pass (``torch.utils.checkpoint``)
    #: when grad is enabled; under inference mode it has no effect.
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def tiny(self) -> "ModelConfig":
        return dataclasses.replace(
            self, vocab_size=256, d_model=64, n_heads=4, n_layers=2,
            d_ff=128, max_seq_len=128)

    def large(self) -> "ModelConfig":
        """The scale-up shape (~0.5B params, head_dim 128)."""
        return dataclasses.replace(
            self, d_model=2048, n_heads=16, n_layers=8, d_ff=5632)


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

class Block(nn.Module):
    """One decoder block's weights (uninitialized until filled)."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        d, h, hd, ff = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
        kw = {"dtype": cfg.dtype, "device": device}
        self.attn_norm = nn.Parameter(torch.ones(d, **kw))
        self.wqkv = nn.Parameter(torch.empty(d, 3, h, hd, **kw))
        self.wo = nn.Parameter(torch.empty(h, hd, d, **kw))
        self.ffn_norm = nn.Parameter(torch.ones(d, **kw))
        self.w_gate = nn.Parameter(torch.empty(d, ff, **kw))
        self.w_up = nn.Parameter(torch.empty(d, ff, **kw))
        self.w_down = nn.Parameter(torch.empty(ff, d, **kw))


class Transformer(nn.Module):
    """The flagship's parameters, laid out as the JAX tree. On the
    ``meta`` device it allocates nothing, which is how the grant sizer
    counts weight bytes."""

    def __init__(self, cfg: ModelConfig, device: str | torch.device):
        super().__init__()
        dev = torch.device(device)
        kw = {"dtype": cfg.dtype, "device": dev}
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model,
                                              **kw))
        self.final_norm = nn.Parameter(torch.ones(cfg.d_model, **kw))
        self.blocks = nn.ModuleList(Block(cfg, dev)
                                    for _ in range(cfg.n_layers))


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device: str | torch.device = "cuda") -> Transformer:
    """Random weights, ``normal / sqrt(fan_in)`` drawn in fp32 from
    ``generator`` (on the generator's device) and cast to ``cfg.dtype``;
    norms start at one."""
    dev = resolve_device(device)
    params = Transformer(cfg, dev)

    def fill(p: nn.Parameter, fan_in: int) -> None:
        w = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                        device=generator.device) / math.sqrt(fan_in)
        p.copy_(w.to(device=dev, dtype=cfg.dtype))

    with torch.no_grad():
        fill(params.embed, cfg.d_model)
        for blk in params.blocks:
            fill(blk.wqkv, cfg.d_model)
            fill(blk.wo, cfg.d_model)
            fill(blk.w_gate, cfg.d_model)
            fill(blk.w_up, cfg.d_model)
            fill(blk.w_down, cfg.d_ff)
    return params


def param_count(params: Transformer) -> int:
    """Number of parameters (elements), as the JAX package counts its
    tree's leaves."""
    return sum(p.numel() for p in params.parameters())


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def rotary(x: torch.Tensor, positions: torch.Tensor,
           base: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding over the last (head_dim) axis;
    ``positions`` [B, L] are absolute positions."""
    half = x.shape[-1] // 2
    freqs = base ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].float() * freqs           # [B, L, half]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_offset: int = 0, kv_offset: int = 0) -> torch.Tensor:
    """Masked attention between (possibly different) Q and KV blocks.

    q [B, Lq, H, D], k/v [B, Lk, H, D]; offsets are the global positions
    of element 0 of each block, so the causal mask compares global
    indices. Scores are fp32; probabilities are cast to ``v``'s dtype
    before the PV product, as in the JAX reference."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
    kv_pos = kv_offset + torch.arange(k.shape[1], device=q.device)
    mask = q_pos[:, None] >= kv_pos[None, :]
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def qkv_proj(block: Block, x: torch.Tensor, positions: torch.Tensor,
             tp=None):
    """Normed fused-qkv projection + rotary on q/k, shared by the forward
    and the serving path's KV capture. Returns [B, L, H, hd] each (the
    block's heads); ``v`` is a strided view of the fused product."""
    h = rms_norm(x, block.attn_norm)
    if tp is not None:
        h = C.copy_to(h, tp)
    d, _, nh, hd = block.wqkv.shape
    qkv = (h @ block.wqkv.reshape(d, 3 * nh * hd)).unflatten(-1,
                                                            (3, nh, hd))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    return rotary(q, positions), rotary(k, positions), v


def out_proj(block: Block, out: torch.Tensor, tp=None) -> torch.Tensor:
    """Attention-output projection: [B, L, H, hd] -> [B, L, d]."""
    nh, hd, d = block.wo.shape
    y = out.reshape(*out.shape[:2], nh * hd) @ block.wo.reshape(nh * hd, d)
    return y if tp is None else C.reduce_from(y, tp)


def attention_delta(block: Block, x: torch.Tensor, positions: torch.Tensor,
                    attn_fn, tp=None) -> torch.Tensor:
    """The attention sublayer's pre-residual contribution."""
    q, k, v = qkv_proj(block, x, positions, tp)
    return out_proj(block, attn_fn(q, k, v), tp)


def attention_block(block: Block, x: torch.Tensor, positions: torch.Tensor,
                    attn_fn, tp=None) -> torch.Tensor:
    return x + attention_delta(block, x, positions, attn_fn, tp)


def ffn_delta(block: Block, x: torch.Tensor, tp=None) -> torch.Tensor:
    """The SwiGLU ffn's pre-residual contribution."""
    h = rms_norm(x, block.ffn_norm)
    if tp is not None:
        h = C.copy_to(h, tp)
    gate = F.silu(h @ block.w_gate)
    y = (gate * (h @ block.w_up)) @ block.w_down
    return y if tp is None else C.reduce_from(y, tp)


def ffn_block(block: Block, x: torch.Tensor, tp=None) -> torch.Tensor:
    return x + ffn_delta(block, x, tp)


def _run_block(block: Block, x: torch.Tensor, positions: torch.Tensor,
               attn_fn, tp=None) -> torch.Tensor:
    return ffn_block(block, attention_block(block, x, positions, attn_fn, tp),
                     tp)


def logits_from_hidden(params: Transformer, x: torch.Tensor) -> torch.Tensor:
    """Final norm and the tied unembedding; fp32 logits from a product in
    the activation dtype."""
    x = rms_norm(x, params.final_norm)
    return (x @ params.embed.T).float()


def forward(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig,
            positions: torch.Tensor | None = None,
            attn_fn=None, tp=None) -> torch.Tensor:
    """Token ids [B, L] -> logits [B, L, vocab] (fp32).

    ``attn_fn`` defaults to :func:`causal_attention`; pass
    ``flash_attention.best_attn_fn(device)`` for the kernel. With
    ``cfg.remat`` and grad enabled, each block is recomputed in the
    backward pass instead of keeping its activations, as the JAX package
    wraps it in ``jax.checkpoint``. ``tp`` is the tensor-parallel group
    of tp-sharded ``params``; a sequence shard passes its global
    ``positions``."""
    if positions is None:
        positions = torch.arange(tokens.shape[1],
                                 device=tokens.device).expand(tokens.shape)
    if attn_fn is None:
        attn_fn = causal_attention
    remat = cfg.remat and torch.is_grad_enabled()
    x = params.embed[tokens]
    for block in params.blocks:
        if remat:
            # The model draws no random numbers, so there is no RNG state
            # to preserve for the recompute; saving it would read the
            # card's generator, which a CUDA graph capture refuses.
            x = checkpoint(_run_block, block, x, positions, attn_fn, tp,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _run_block(block, x, positions, attn_fn, tp)
    return logits_from_hidden(params, x)
