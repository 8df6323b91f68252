"""Device choice for the port's entry points.

Every entry point takes ``device``; ``None`` means ``"cuda"``. A CUDA
request on a machine without CUDA raises — the port never carries on on the
CPU unless the caller asked for the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without CUDA raises RuntimeError."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested (device=None means 'cuda') but "
            f"CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
