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
    """An fp32 numpy copy of ``t`` (never a view of a host tensor, which
    a later in-place update, such as an optimizer step, would change)."""
    return np.array(t.detach().float().cpu().numpy(), copy=True)


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


def set_optimizer_state(module: torch.nn.Module,
                        optimizer: torch.optim.Optimizer,
                        state: dict) -> None:
    """Set ``optimizer``'s per-parameter state from ``state`` (by
    ``module``'s parameter names; host tensors will do). A value whose
    key the optimizer already holds for that parameter is copied into the
    tensor it holds: a compiled step reads that state in place and is
    keyed on its addresses (:mod:`graphs`), so a restore that replaced
    the tensors would miss its key and capture again. A new value is
    placed as ``Optimizer.load_state_dict`` places it: ``step`` in fp32 on
    its parameter's device for a capturable (or fused) AdamW and on the
    host for another, the rest in the parameter's dtype on its device.
    The param groups stay the optimizer's own."""
    params = dict(module.named_parameters())
    group_of = {id(p): g for g in optimizer.param_groups
                for p in g["params"]}
    with torch.no_grad():
        for name, values in state.items():
            p = params[name]
            group = group_of[id(p)]
            held = optimizer.state[p]
            for key, value in values.items():
                value = torch.as_tensor(value)
                if key in held:
                    held[key].copy_(value)
                elif key == "step":
                    on_card = group.get("capturable") or group.get("fused")
                    held[key] = value.to(
                        dtype=torch.float32,
                        device=p.device if on_card else "cpu", copy=True)
                else:
                    held[key] = value.to(dtype=p.dtype, device=p.device,
                                         copy=True)


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
    set_optimizer_state(params, optimizer, state)
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


def _stage_shard(stacked: dict, idx: int, j: int, key: str, mesh,
                 tp_axis: str | None) -> np.ndarray:
    """Block ``j`` of stage ``idx`` of a stacked leaf, this rank's tp
    shard of it under ``tp_axis`` (as ``pipeline.flagship_stage`` splits
    the weights)."""
    a = np.asarray(stacked[key][idx][j], dtype=np.float32)
    axis = par.TP_AXIS.get(key)
    if tp_axis is not None and axis is not None and mesh.size(tp_axis) > 1:
        a = np.split(a, mesh.size(tp_axis), axis=axis)[mesh.index(tp_axis)]
    return a


def pipeline_opt_state_from_jax(opt_state, stage, edge,
                                optimizer: torch.optim.Optimizer, mesh,
                                axis_name: str,
                                tp_axis: str | None = None
                                ) -> torch.optim.Optimizer:
    """Fill ``optimizer`` (the port's AdamW over ``[*stage.parameters(),
    *edge.parameters()]``, this rank's pipe state) with the reference's
    optax ``adamw`` state over ``(stacked, edge)``, numpy leaves: its
    ``ScaleByAdamState`` gives every parameter's ``step`` (count), and
    ``exp_avg`` and ``exp_avg_sq`` (mu and nu: this rank's stage on the
    pipe axis, its tp shard under ``tp_axis``, the edge's whole). The
    twin of :func:`opt_state_from_jax`; the optimizer's hyperparameters
    stay its own. Returns ``optimizer``."""
    count, (mu_st, mu_edge), (nu_st, nu_edge) = opt_state[0]
    n_stages = np.shape(mu_st["wqkv"])[0]
    P._check_stage_count(n_stages, mesh, axis_name)
    idx = mesh.index(axis_name)
    step = float(np.asarray(count))
    module = torch.nn.ModuleDict({"stage": stage, "edge": edge})
    state = {}
    for fqn, p in module.named_parameters():
        part, _, name = fqn.partition(".")
        if part == "stage":
            j, _, key = name.partition(".")
            mu, nu = (_stage_shard(t, idx, int(j), key, mesh, tp_axis)
                      for t in (mu_st, nu_st))
        else:
            mu, nu = (np.asarray(t[name], np.float32)
                      for t in (mu_edge, nu_edge))
        if mu.shape != tuple(p.shape):
            raise ValueError(f"{fqn}: moment shape {mu.shape} does not "
                             f"match the parameter's {tuple(p.shape)}")
        state[fqn] = {"step": torch.tensor(step, dtype=torch.float32),
                      "exp_avg": torch.tensor(mu),
                      "exp_avg_sq": torch.tensor(nu)}
    set_optimizer_state(module, optimizer, state)
    return optimizer


def _gathered(stage, edge, mesh, axis_name: str, tp_axis: str | None, get,
              n_stages: int = 1):
    """The reference's (stacked, edge) trees of fp32 numpy arrays of
    ``get(name, parameter)``, leaves [n_stages, per_stage, ...]
    (``pipeline.stage_tree``): under ``mesh`` each block weight's gathered
    over tp (its shards) and over the pipe axis (the stages), a
    collective over those groups that gives every rank the trees; with
    ``mesh`` None, ``stage`` holds every block of ``n_stages`` stages."""
    stacked = P.stage_tree(stage, 1 if mesh is not None else n_stages, get)
    for key, g in stacked.items() if mesh is not None else ():
        axis = par.TP_AXIS.get(key)
        if tp_axis is not None and axis is not None:
            g = C.all_gather(g, mesh.group(tp_axis), axis + 2)
        stacked[key] = C.all_gather(g, mesh.group(axis_name), 0)
    return ({k: _numpy(t) for k, t in stacked.items()},
            {k: _numpy(get(k, p)) for k, p in edge.items()})


def pipeline_grads_to_numpy(stage, edge, mesh, axis_name: str,
                            tp_axis: str | None = None):
    """The reference's (``g_stacked``, ``g_edge``) trees of fp32 numpy
    arrays from every rank's ``.grad``: each block weight's gradient
    gathered over tp (its shards) and over the pipe axis (the stages),
    leaves [n_stages, per_stage, ...]. A collective over those groups;
    every rank gets the trees."""
    def grad(name, p):
        if p.grad is None:
            raise ValueError(f"{name} has no gradient")
        return p.grad

    return _gathered(stage, edge, mesh, axis_name, tp_axis, grad)


def pipeline_params_to_numpy(stage, edge, mesh, axis_name: str = "pp",
                             tp_axis: str | None = None, *,
                             n_stages: int = 1):
    """The reference's (``stacked``, ``edge``) trees of fp32 numpy arrays
    holding the pipe's weights, gathered as
    :func:`pipeline_grads_to_numpy` gathers the gradients (a
    collective); with ``mesh`` None, of one process whose ``stage`` holds
    every block of ``n_stages`` stages."""
    return _gathered(stage, edge, mesh, axis_name, tp_axis,
                     lambda name, p: p.detach(), n_stages)


def pipeline_opt_state_to_numpy(optimizer: torch.optim.Optimizer, stage,
                                edge, mesh, axis_name: str = "pp",
                                tp_axis: str | None = None, *,
                                n_stages: int = 1) -> dict:
    """The pipe's AdamW state as the fields of optax's ``ScaleByAdamState``
    over ``(stacked, edge)``: ``{"count": int32, "mu": (stacked, edge),
    "nu": (stacked, edge)}``, fp32 numpy, each moment gathered as
    :func:`pipeline_params_to_numpy` gathers its parameter (a
    collective, or one process's with ``mesh`` None). An optimizer that
    has taken no step has count 0 and zero moments, as optax's init."""
    def moment(key):
        def get(name, p):
            st = optimizer.state.get(p, {})
            return st[key] if key in st else torch.zeros_like(p)
        return _gathered(stage, edge, mesh, axis_name, tp_axis, get,
                         n_stages)

    steps = {float(st["step"]) for st in optimizer.state.values()
             if "step" in st}
    if len(steps) > 1:
        raise ValueError(f"parameters have taken different step counts "
                         f"{sorted(steps)}; optax keeps one")
    return {"count": np.int32(steps.pop() if steps else 0),
            "mu": moment("exp_avg"), "nu": moment("exp_avg_sq")}


def pipeline_state(optimizer: torch.optim.Optimizer, stage, edge,
                   mesh=None, axis_name: str = "pp",
                   tp_axis: str | None = None, *,
                   n_stages: int = 1) -> dict:
    """The pipe's weights and AdamW state in the reference's stacked
    layout, as host tensors in the weights' dtype by key: ``weight/<w>``
    and ``weight/<edge name>``, the same under ``exp_avg/`` and
    ``exp_avg_sq/``, and the ``step``. Gathered under ``mesh`` as
    :func:`pipeline_params_to_numpy` gathers (a collective), or one
    process's with ``mesh`` None and ``n_stages``."""
    dtype = edge["embed"].dtype
    trees = {"weight": pipeline_params_to_numpy(
        stage, edge, mesh, axis_name, tp_axis, n_stages=n_stages)}
    adam = pipeline_opt_state_to_numpy(optimizer, stage, edge, mesh,
                                       axis_name, tp_axis, n_stages=n_stages)
    trees.update(exp_avg=adam["mu"], exp_avg_sq=adam["nu"])
    out = {f"{kind}/{k}": torch.from_numpy(a).to(dtype)
           for kind, (stacked, ends) in trees.items()
           for k, a in {**stacked, **ends}.items()}
    out["step"] = torch.tensor(int(adam["count"]))
    return out
