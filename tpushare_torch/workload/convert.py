"""Carry the JAX package's parameter tree into the port, and back.

The tree travels as numpy arrays (``{"embed", "final_norm", "blocks":
[{...}, ...]}``, the layout of ``tpushare.workload.model.init_params``),
so this module needs no JAX. bf16 goes through fp32, which is exact in
both directions.
"""

from __future__ import annotations

import numpy as np
import torch

from tpushare_torch.utils.device import resolve_device
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


def params_to_numpy(params: Transformer) -> dict:
    """The JAX-layout tree of fp32 numpy arrays holding ``params``."""
    def arr(p: torch.Tensor) -> np.ndarray:
        return p.detach().float().cpu().numpy()

    return {
        "embed": arr(params.embed),
        "final_norm": arr(params.final_norm),
        "blocks": [{key: arr(getattr(blk, key)) for key in _BLOCK_KEYS}
                   for blk in params.blocks],
    }
