"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on. The card is the default
    everywhere; a host without one must ask for the CPU explicitly
    rather than have work move there behind its back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the host")
    return dev
