"""Entry point: the flagship forward on one card.

Counterpart of the JAX package's graft entry: the flagship LM at vocab
8192 over tokens ``[2, 256]``, attention from ``best_attn_fn`` (the CUDA
flash kernel on the card).
"""

from __future__ import annotations

import torch

from tpushare_torch.utils.device import resolve_device
from tpushare_torch.workload import flash_attention as FA
from tpushare_torch.workload import model as M

ENTRY_CONFIG = M.ModelConfig(vocab_size=8192, d_model=512, n_heads=8,
                             n_layers=4, d_ff=1536, max_seq_len=512)


def entry(device: str | torch.device = "cuda"):
    """(forward fn, example args) for the flagship model on ``device``.
    The forward runs under ``torch.inference_mode()`` and returns fp32
    logits [2, 256, 8192]."""
    dev = resolve_device(device)
    cfg = ENTRY_CONFIG
    params = M.init_params(torch.Generator().manual_seed(0), cfg, dev)
    tokens = torch.zeros((2, 256), dtype=torch.long, device=dev)
    attn_fn = FA.best_attn_fn(dev)

    @torch.inference_mode()
    def fwd(params: M.Transformer, tokens: torch.Tensor) -> torch.Tensor:
        return M.forward(params, tokens, cfg, attn_fn=attn_fn)

    return fwd, (params, tokens)
