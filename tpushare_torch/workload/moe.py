"""Expert parallelism: the ring-MoE feed-forward layer.

Port of ``tpushare/workload/moe.py``. A mixture-of-experts FFN whose E
experts are sharded over a mesh axis: each rank holds E/n of them, and
the expert weights (not the tokens) travel around the axis's ring
(:func:`collectives.shift`), as ring attention moves K/V. After n steps
every token has met every expert; shapes stay static, nothing is
dropped, and the layer composes with sequence parallelism by reusing the
``sp`` axis, whose ranks already hold the activations' sequence shards.

Gating is the reference's dense softmax mixture: every expert contributes,
weighted by the router. The router is replicated; its gradient is
all-reduced over the ring's group (:func:`collectives.copy_to`), as the
reference's replicated in_spec sums it. Each expert's gradient travels
home through the shift's backward.

The expert math is the reference's, with one trap: ``jax.nn.gelu``
defaults to the tanh approximation, ``torch.nn.functional.gelu`` to the
exact erf form, so the port asks for ``approximate="tanh"``.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from tpushare_torch.utils.device import resolve_device
from tpushare_torch.workload import collectives as C
from tpushare_torch.workload.parallel import Mesh


def init_moe_params(generator: torch.Generator, d_model: int, d_ff: int,
                    n_experts: int,
                    device: str | torch.device = "cuda") -> dict:
    """Router + stacked expert weights, fp32, drawn from ``generator`` (on
    the generator's device) with the reference's scales: ``router`` [D, E]
    at 1/sqrt(D), ``w1`` [E, D, F] at sqrt(2/D), ``w2`` [E, F, D] at
    sqrt(2/F)."""
    dev = resolve_device(device)

    def draw(shape, scale):
        return (torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=generator.device) * scale).to(dev)

    return {"router": draw((d_model, n_experts), 1.0 / math.sqrt(d_model)),
            "w1": draw((n_experts, d_model, d_ff), math.sqrt(2.0 / d_model)),
            "w2": draw((n_experts, d_ff, d_model), math.sqrt(2.0 / d_ff))}


def _mix(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
         gates: torch.Tensor) -> torch.Tensor:
    """The experts ``w1``/``w2`` of ``x``, weighted by their ``gates``."""
    h = F.gelu(torch.einsum("...d,edf->...ef", x, w1), approximate="tanh")
    y = torch.einsum("...ef,efd->...ed", h, w2)
    return torch.einsum("...ed,...e->...d", y, gates)


def moe_ffn_reference(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Single-device dense mixture: the numerics the ring must match."""
    gates = torch.softmax(x @ params["router"], dim=-1)       # [..., E]
    return _mix(x, params["w1"], params["w2"], gates)


def make_ring_moe_fn(mesh: Mesh, axis_name: str = "sp"):
    """Build ``fn(params, x) -> y`` over ``mesh.group(axis_name)``: ``x``
    is this rank's token shard ([B, S/n, D], the sequence sharded as the
    attention layers leave it), ``params`` this rank's shard
    (:func:`place_moe_params`: the whole router, E/n experts).

    n - 1 rotations, then one compute-only step: the last rotation would
    feed nothing. At step k the experts in hand started on group rank
    ``(idx - k) mod n``, so their gates are that slice of the router's."""
    group = mesh.group(axis_name)

    def fn(params: dict, x: torch.Tensor) -> torch.Tensor:
        n, idx = dist.get_world_size(group), dist.get_rank(group)
        w1, w2 = params["w1"], params["w2"]
        e = w1.shape[0]
        gates = torch.softmax(x @ C.copy_to(params["router"], group), dim=-1)
        out = None
        for k in range(n):
            if k:
                w1, w2 = C.shift(w1, group), C.shift(w2, group)
            src = (idx - k) % n
            part = _mix(x, w1, w2, gates[..., src * e:(src + 1) * e])
            out = part if out is None else out + part
        return out

    return fn


def place_moe_params(params: dict, mesh: Mesh, axis_name: str = "sp") -> dict:
    """This rank's shard: the router whole, and its E/n experts of ``w1``
    and ``w2`` (the EP memory win)."""
    n, idx = mesh.size(axis_name), mesh.index(axis_name)
    n_experts = params["w1"].shape[0]
    if n_experts % n:
        raise ValueError(f"{n_experts} experts do not split over "
                         f"{axis_name!r} ({n})")
    return {"router": params["router"].clone(),
            **{k: params[k].chunk(n)[idx].clone() for k in ("w1", "w2")}}
