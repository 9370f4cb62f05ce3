"""Training of the flagship LM: loss, optimizer, train step and the
forward the entry point uses.

Port of ``tpushare/workload/train.py``. On one device (``mesh=None``)
attention is the kernel-backed :func:`flash_attention.flash_attention` on
the card, whose backward runs the dq and dk/dv kernels. Over a
:class:`parallel.Mesh` each rank trains its (dp, tp, sp) shard: ring or
Ulysses attention over sp through the same kernels, the tp pair of
all-reduces in every block, and gradients all-reduced over dp × sp.

The single-device step and :func:`make_forward_fn`'s forward are
compiled steps (:mod:`graphs`), as the JAX package jits them: on the card
the step's forward, backward and AdamW update replay one CUDA graph a
batch shape. Sharded steps stay eager (their gloo collectives go through
the host).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from tpushare_torch.utils.device import resolve_device
from tpushare_torch.workload import collectives as C
from tpushare_torch.workload import flash_attention as FA
from tpushare_torch.workload import graphs
from tpushare_torch.workload import model as M
from tpushare_torch.workload import parallel as par


def loss_fn(params: M.Transformer, tokens: torch.Tensor,
            targets: torch.Tensor, cfg: M.ModelConfig,
            positions: torch.Tensor | None = None,
            attn_fn=None, tp=None) -> torch.Tensor:
    """Mean negative log-likelihood of ``targets`` [B, L] under the fp32
    logits of ``tokens`` [B, L]."""
    logits = M.forward(params, tokens, cfg, positions=positions,
                       attn_fn=attn_fn, tp=tp)
    return F.cross_entropy(logits.flatten(0, 1), targets.flatten())


def make_optimizer(lr: float = 3e-4):
    """AdamW with optax.adamw's defaults (betas 0.9/0.999, eps 1e-8, weight
    decay 0.01 on every parameter), as a factory to call on the
    parameters: torch's optimizer holds them, optax's does not."""
    return functools.partial(torch.optim.AdamW, lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=0.01)


def make_train_step(cfg: M.ModelConfig, mesh: par.Mesh | None = None,
                    optimizer=None, use_ring_attention: bool = True,
                    attention: str | None = None, *, attn_fn=None,
                    device: str | torch.device = "cuda"):
    """Build ``(init_fn, step, place_batch)``, with the reference's
    parameters in the reference's order.

    ``optimizer`` is a factory as :func:`make_optimizer` returns (its
    default). Without a mesh, the step trains one device, and
    ``attention`` and ``use_ring_attention`` pick nothing (they are
    validated as the reference validates them); ``attn_fn`` defaults to
    ``best_attn_fn(device)``, the kernel-backed flash attention on the
    card.

    With a :class:`parallel.Mesh` (this rank's place in the gang), each
    rank trains its shard:

    * ``init_fn`` draws the full weights from the generator, as one
      device would, and keeps this rank's tp shard, so every mesh starts
      from the same weights;
    * ``place_batch`` takes the global batch, which every rank makes
      alike, and returns this rank's (dp, sp) shard;
    * attention is ``attention`` over sp: ``"ring"`` (the default) or
      ``"ulysses"``; ``use_ring_attention=False`` turns sequence
      parallelism off (each rank then takes whole sequences of its dp
      shard, and sp ranks are replicas);
    * ``step`` runs the shard's loss at the shard's global positions,
      all-reduces gradients over dp × sp only (tp ranks already hold
      equal gradients of replicated weights, and distinct shards of the
      rest), steps AdamW on the shard, and returns the global mean
      loss."""
    if attention is not None and attention not in ("ring", "ulysses"):
        raise ValueError(f"unknown attention strategy {attention!r}; "
                         "expected 'ring' or 'ulysses'")
    if attention is not None and not use_ring_attention:
        raise ValueError(
            "attention= requests sequence parallelism but "
            "use_ring_attention=False disables it; drop one of the two")
    if mesh is not None and not isinstance(mesh, par.Mesh):
        raise TypeError(f"mesh must be a parallel.Mesh (make_mesh), got "
                        f"{type(mesh).__name__}")
    dev = resolve_device(device)
    optimizer = optimizer or make_optimizer()
    if mesh is None:
        attn_fn = attn_fn or FA.best_attn_fn(dev)
    elif attn_fn is None:
        if not use_ring_attention:
            attn_fn = FA.best_attn_fn(dev)
        elif (attention or "ring") == "ring":
            attn_fn = par.make_ring_attn_fn(mesh)
        else:
            attn_fn = par.make_ulysses_attn_fn(mesh)
    sequence = mesh is not None and use_ring_attention
    tp = mesh.tp_group if mesh is not None and mesh.tp > 1 else None

    def init_fn(generator: torch.Generator, example_tokens: torch.Tensor):
        """(params, opt_state): weights from ``generator`` (this rank's
        shard of them under a mesh) and the optimizer over them, made
        capturable for the compiled single-card step.
        ``example_tokens`` is unused, as in JAX."""
        params = M.init_params(generator, cfg, dev)
        if mesh is not None:
            params = par.shard_params(params, mesh)
            return params, optimizer(params.parameters())
        if dev.type == "cuda":
            return params, optimizer(params.parameters(), capturable=True)
        return params, optimizer(params.parameters())

    def place_batch(tokens: torch.Tensor, targets: torch.Tensor):
        if mesh is None:
            return tokens, targets
        return tuple(par.place_batch(mesh, x, sequence).to(dev)
                     for x in (tokens, targets))

    def reduce_grads(params: M.Transformer,
                     loss: torch.Tensor) -> torch.Tensor:
        """Mean of every gradient, and of the loss, over dp × sp: one
        fp32 all-reduce of them all. Returns the global loss."""
        grads = [p.grad for p in params.parameters()]
        flat = torch.cat([g.float().flatten() for g in grads]
                         + [loss.detach().float().reshape(1)])
        flat = C.all_reduce(flat, mesh.grad_group) / (mesh.dp * mesh.sp)
        for g, part in zip(grads, flat[:-1].split([g.numel()
                                                   for g in grads])):
            g.copy_(part.view_as(g))
        return flat[-1]

    def step(params: M.Transformer, opt_state: torch.optim.Optimizer,
             tokens: torch.Tensor, targets: torch.Tensor,
             positions: torch.Tensor | None = None):
        """One forward, backward and AdamW update: ``(params, opt_state,
        loss)``. Updates ``params`` and ``opt_state`` in place and returns
        them (the JAX step donates their buffers instead). Under a mesh,
        ``tokens`` and ``targets`` are this rank's shard (``place_batch``)
        and ``positions`` default to its global positions."""
        if mesh is None:
            loss = compiled_step(params, opt_state, tokens, targets,
                                 positions)
            return params, opt_state, loss
        if sequence and positions is None:
            b, ls = tokens.shape
            positions = par.global_positions(mesh, b * mesh.dp,
                                             ls * mesh.sp, tokens.device)
        opt_state.zero_grad(set_to_none=True)
        loss = loss_fn(params, tokens, targets, cfg, positions=positions,
                       attn_fn=attn_fn, tp=tp)
        loss.backward()
        if mesh.dp * mesh.sp > 1:
            loss = reduce_grads(params, loss)
        opt_state.step()
        return params, opt_state, loss.detach()

    def compiled_step(params, opt_state, tokens, targets, positions):
        """The single-card step as one compiled step a batch shape: the
        forward, backward and AdamW update; the gradients come out with
        the loss, so each step's are the parameters' ``.grad`` as in the
        eager step. ``zero_grad(set_to_none=True)`` runs before the
        capture, so the graph's gradients are its own static tensors."""
        plist = list(params.parameters())

        def body(tokens, targets, *pos):
            loss = loss_fn(params, tokens, targets, cfg,
                           positions=pos[0] if pos else None,
                           attn_fn=attn_fn)
            loss.backward()
            opt_state.step()
            return (loss.detach(), *(p.grad for p in plist))

        def bound():
            return (*plist, *(t for state in opt_state.state.values()
                              for t in state.values()
                              if isinstance(t, torch.Tensor)))

        hyper = tuple((k, v) for group in opt_state.param_groups
                      for k, v in sorted(group.items()) if k != "params")
        loss, *grads = graphs.run(
            "train_step", body,
            (tokens, targets) + (() if positions is None else (positions,)),
            static=(cfg, attn_fn, hyper), bound=bound, group="train",
            prepare=lambda: opt_state.zero_grad(set_to_none=True))
        for p, g in zip(plist, grads):
            p.grad = g
        return loss

    return init_fn, step, place_batch


def make_forward_fn(cfg: M.ModelConfig, seq_len: int | None = None,
                    device: str | torch.device = "cuda"):
    """Single-device forward ``fwd(params, tokens) -> fp32 logits`` under
    ``torch.inference_mode()``, attention from ``best_attn_fn(device)``,
    compiled (:mod:`graphs`) a tokens shape as the JAX package jits it.
    ``seq_len`` is taken for the JAX signature: the kernel takes every
    length, so it picks nothing here."""
    attn_fn = FA.best_attn_fn(device)

    @torch.inference_mode()
    def fwd(params: M.Transformer, tokens: torch.Tensor) -> torch.Tensor:
        return graphs.run(
            "forward", lambda t: M.forward(params, t, cfg, attn_fn=attn_fn),
            (tokens,), static=(cfg, attn_fn), bound=params.parameters)
    return fwd
