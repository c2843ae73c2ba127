"""Device choice for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names another.

    Raises when CUDA is asked for (or left as the default) and the process has
    none; it never falls back to the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU")
    return dev
