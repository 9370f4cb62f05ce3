"""Single-device training of the flagship LM: loss, optimizer, train step
and the forward the entry point uses.

Port of ``tpushare/workload/train.py`` in its single-device form
(``mesh=None``). On the card attention is the kernel-backed
:func:`flash_attention.flash_attention`, whose backward runs the dq and
dk/dv kernels. The sharded forms (a mesh, ring or Ulysses attention) are
not ported yet and are refused.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from tpushare_torch.utils.device import resolve_device
from tpushare_torch.workload import flash_attention as FA
from tpushare_torch.workload import model as M


def loss_fn(params: M.Transformer, tokens: torch.Tensor,
            targets: torch.Tensor, cfg: M.ModelConfig,
            positions: torch.Tensor | None = None,
            attn_fn=None) -> torch.Tensor:
    """Mean negative log-likelihood of ``targets`` [B, L] under the fp32
    logits of ``tokens`` [B, L]."""
    logits = M.forward(params, tokens, cfg, positions=positions,
                       attn_fn=attn_fn)
    return F.cross_entropy(logits.flatten(0, 1), targets.flatten())


def make_optimizer(lr: float = 3e-4):
    """AdamW with optax.adamw's defaults (betas 0.9/0.999, eps 1e-8, weight
    decay 0.01 on every parameter), as a factory to call on the
    parameters: torch's optimizer holds them, optax's does not."""
    return functools.partial(torch.optim.AdamW, lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=0.01)


def make_train_step(cfg: M.ModelConfig, mesh=None, optimizer=None,
                    use_ring_attention: bool = True,
                    attention: str | None = None, *, attn_fn=None,
                    device: str | torch.device = "cuda"):
    """Build ``(init_fn, step, place_batch)`` for one device, with the
    reference's parameters in the reference's order.

    ``optimizer`` is a factory as :func:`make_optimizer` returns (its
    default). ``attention`` and ``use_ring_attention`` are validated as
    the reference validates them; without a mesh, as there, they pick
    nothing. A mesh (sequence-parallel ring or Ulysses attention) is
    refused until the parallel slice is ported. ``attn_fn`` defaults to
    ``best_attn_fn(device)``: the kernel-backed flash attention on the
    card."""
    if attention is not None and attention not in ("ring", "ulysses"):
        raise ValueError(f"unknown attention strategy {attention!r}; "
                         "expected 'ring' or 'ulysses'")
    if attention is not None and not use_ring_attention:
        raise ValueError(
            "attention= requests sequence parallelism but "
            "use_ring_attention=False disables it; drop one of the two")
    if mesh is not None:
        raise NotImplementedError(
            "sharded training (a mesh, ring or Ulysses attention) is not "
            "ported yet; make_train_step runs on one device")
    dev = resolve_device(device)
    optimizer = optimizer or make_optimizer()
    attn_fn = attn_fn or FA.best_attn_fn(dev)

    def init_fn(generator: torch.Generator, example_tokens: torch.Tensor):
        """(params, opt_state): weights from ``generator`` and the
        optimizer over them. ``example_tokens`` is unused, as in JAX."""
        params = M.init_params(generator, cfg, dev)
        return params, optimizer(params.parameters())

    def step(params: M.Transformer, opt_state: torch.optim.Optimizer,
             tokens: torch.Tensor, targets: torch.Tensor,
             positions: torch.Tensor | None = None):
        """One forward, backward and AdamW update: ``(params, opt_state,
        loss)``. Updates ``params`` and ``opt_state`` in place and returns
        them (the JAX step donates their buffers instead)."""
        opt_state.zero_grad(set_to_none=True)
        loss = loss_fn(params, tokens, targets, cfg, positions=positions,
                       attn_fn=attn_fn)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return init_fn, step, lambda tokens, targets: (tokens, targets)


def make_forward_fn(cfg: M.ModelConfig, seq_len: int | None = None,
                    device: str | torch.device = "cuda"):
    """Single-device forward ``fwd(params, tokens) -> fp32 logits`` under
    ``torch.inference_mode()``, attention from ``best_attn_fn(device)``.
    ``seq_len`` is taken for the JAX signature: the kernel takes every
    length, so it picks nothing here."""
    attn_fn = FA.best_attn_fn(device)

    @torch.inference_mode()
    def fwd(params: M.Transformer, tokens: torch.Tensor) -> torch.Tensor:
        return M.forward(params, tokens, cfg, attn_fn=attn_fn)
    return fwd
