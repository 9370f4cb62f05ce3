"""Carry the JAX package's parameter trees into the port, and back.

The trees travel as numpy arrays (``{"embed", "final_norm", "blocks":
[{...}, ...]}``, the layout of ``tpushare.workload.model.init_params``;
the pipeline's stacked stage tree and edge; the MoE's router and expert
stacks; optax's AdamW state), so this module needs no JAX. bf16 goes
through fp32, which is exact in both directions.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.checkpoint.state_dict import (
    get_optimizer_state_dict, set_optimizer_state_dict)

from tpushare_torch.utils.device import resolve_device
from tpushare_torch.workload import collectives as C
from tpushare_torch.workload import parallel as par
from tpushare_torch.workload import pipeline as P
from tpushare_torch.workload.model import ModelConfig, Transformer

_BLOCK_KEYS = ("attn_norm", "wqkv", "wo", "ffn_norm", "w_gate", "w_up",
               "w_down")


def _copy(param: torch.nn.Parameter, array, name: str) -> None:
    src = torch.tensor(np.asarray(array, dtype=np.float32))
    if tuple(src.shape) != tuple(param.shape):
        raise ValueError(f"{name}: shape {tuple(src.shape)} does not match "
                         f"the config's {tuple(param.shape)}")
    param.copy_(src.to(device=param.device, dtype=param.dtype))


def params_from_jax(tree: dict, cfg: ModelConfig,
                    device: str | torch.device = "cuda") -> Transformer:
    """The port's module holding the weights of a JAX param tree whose
    leaves are numpy arrays (``jax.tree_util.tree_map(np.asarray, p)``)."""
    params = Transformer(cfg, resolve_device(device))
    if len(tree["blocks"]) != cfg.n_layers:
        raise ValueError(f"tree has {len(tree['blocks'])} blocks, config "
                         f"has {cfg.n_layers} layers")
    with torch.no_grad():
        _copy(params.embed, tree["embed"], "embed")
        _copy(params.final_norm, tree["final_norm"], "final_norm")
        for i, (blk, src) in enumerate(zip(params.blocks, tree["blocks"])):
            for key in _BLOCK_KEYS:
                _copy(getattr(blk, key), src[key], f"blocks.{i}.{key}")
    return params


def _tree(params: Transformer, leaf) -> dict:
    """The JAX-layout tree of ``leaf(name, parameter)`` for every parameter."""
    return {
        "embed": leaf("embed", params.embed),
        "final_norm": leaf("final_norm", params.final_norm),
        "blocks": [{key: leaf(f"blocks.{i}.{key}", getattr(blk, key))
                    for key in _BLOCK_KEYS}
                   for i, blk in enumerate(params.blocks)],
    }


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def params_to_numpy(params: Transformer) -> dict:
    """The JAX-layout tree of fp32 numpy arrays holding ``params``."""
    return _tree(params, lambda name, p: _numpy(p))


def grads_to_numpy(params: Transformer) -> dict:
    """The JAX-layout tree of fp32 numpy arrays holding each parameter's
    ``.grad``, leaf for leaf against ``jax.grad`` of the same loss."""
    def grad(name: str, p: torch.nn.Parameter) -> np.ndarray:
        if p.grad is None:
            raise ValueError(f"{name} has no gradient")
        return _numpy(p.grad)

    return _tree(params, grad)


# --------------------------------------------------------------------------
# Optimizer state
# --------------------------------------------------------------------------

def _named(tree: dict) -> dict:
    """``{parameter name: leaf}`` of a JAX-layout tree."""
    return {"embed": tree["embed"], "final_norm": tree["final_norm"],
            **{f"blocks.{i}.{key}": blk[key]
               for i, blk in enumerate(tree["blocks"]) for key in _BLOCK_KEYS}}


def opt_state_from_jax(opt_state, params: Transformer,
                       optimizer: torch.optim.Optimizer
                       ) -> torch.optim.Optimizer:
    """Fill ``optimizer`` (the port's AdamW over ``params``) with the JAX
    package's optax ``adamw`` state, numpy leaves
    (``jax.tree_util.tree_map(np.asarray, opt_state)``): its
    ``(ScaleByAdamState(count, mu, nu), EmptyState(), EmptyState())``
    gives every parameter's ``step`` (count), ``exp_avg`` (mu) and
    ``exp_avg_sq`` (nu), the moments in the parameter's dtype. The
    optimizer's hyperparameters stay its own. Returns ``optimizer``."""
    count, mu, nu = opt_state[0]          # ScaleByAdamState, a namedtuple
    mu, nu = _named(mu), _named(nu)
    state = {}
    for name, p in params.named_parameters():
        if tuple(np.shape(mu[name])) != tuple(p.shape):
            raise ValueError(f"{name}: moment shape {np.shape(mu[name])} "
                             f"does not match the parameter's "
                             f"{tuple(p.shape)}")
        state[name] = {
            "step": torch.tensor(float(np.asarray(count)),
                                 dtype=torch.float32),
            "exp_avg": torch.tensor(np.asarray(mu[name], np.float32)),
            "exp_avg_sq": torch.tensor(np.asarray(nu[name], np.float32))}
    groups = get_optimizer_state_dict(params, optimizer)["param_groups"]
    set_optimizer_state_dict(params, optimizer, {"state": state,
                                                 "param_groups": groups})
    return optimizer


def opt_state_to_numpy(optimizer: torch.optim.Optimizer,
                       params: Transformer) -> dict:
    """The optimizer's AdamW state as the fields of optax's
    ``ScaleByAdamState``: ``{"count": int32, "mu": tree, "nu": tree}``,
    JAX-layout trees of fp32 numpy arrays. An optimizer that has taken
    no step has count 0 and zero moments, as optax's init."""
    def leaf(key):
        def get(name, p):
            st = optimizer.state.get(p, {})
            return _numpy(st[key]) if key in st else np.zeros(
                tuple(p.shape), np.float32)
        return get

    steps = {float(st["step"]) for st in optimizer.state.values()
             if "step" in st}
    if len(steps) > 1:
        raise ValueError(f"parameters have taken different step counts "
                         f"{sorted(steps)}; optax keeps one")
    return {"count": np.int32(steps.pop() if steps else 0),
            "mu": _tree(params, leaf("exp_avg")),
            "nu": _tree(params, leaf("exp_avg_sq"))}


# --------------------------------------------------------------------------
# Pipeline and MoE trees
# --------------------------------------------------------------------------

def moe_params_from_jax(tree: dict,
                        device: str | torch.device = "cuda") -> dict:
    """The port's MoE params (fp32 tensors) from a JAX ``init_moe_params``
    tree of numpy arrays."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(tree[k], dtype=np.float32),
                            device=dev) for k in ("router", "w1", "w2")}


def pipeline_params_from_jax(stacked: dict, edge: dict, mesh, axis_name: str,
                             tp_axis: str | None = None,
                             device: str | torch.device = "cuda"):
    """(stage, edge) of this rank, fp32, from the reference's flagship pipe
    tree (``make_flagship_pipeline``'s ``init_fn``: ``stacked`` leaves
    [n_stages, per_stage, ...] by block weight name, ``edge`` the embedding
    and final norm), numpy leaves: its stage on the pipe axis, the tp
    shard of it under ``tp_axis``, and the edge whole."""
    dev = resolve_device(device)

    def tensor(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=dev)

    n_stages, per_stage = np.shape(stacked["wqkv"])[:2]
    P._check_stage_count(n_stages, mesh, axis_name)
    idx = mesh.index(axis_name)
    blocks = [{k: tensor(stacked[k][idx][j]) for k in _BLOCK_KEYS}
              for j in range(per_stage)]
    return (P.flagship_stage(blocks, mesh, tp_axis),
            P.flagship_edge(tensor(edge["embed"]), tensor(edge["final_norm"])))


def pipeline_grads_to_numpy(stage, edge, mesh, axis_name: str,
                            tp_axis: str | None = None):
    """The reference's (``g_stacked``, ``g_edge``) trees of fp32 numpy
    arrays from every rank's ``.grad``: each block weight's gradient
    gathered over tp (its shards) and over the pipe axis (the stages),
    leaves [n_stages, per_stage, ...]. A collective over those groups;
    every rank gets the trees."""
    stacked = {}
    for key in _BLOCK_KEYS:
        g = torch.stack([getattr(blk, key).grad for blk in stage])
        axis = par.TP_AXIS.get(key)
        if tp_axis is not None and axis is not None:
            g = C.all_gather(g, mesh.group(tp_axis), axis + 1)
        stacked[key] = _numpy(C.all_gather(g[None], mesh.group(axis_name),
                                           0))
    return stacked, {k: _numpy(p.grad) for k, p in edge.items()}
