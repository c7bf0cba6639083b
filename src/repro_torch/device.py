"""Device resolution shared by every entry point of the port.

Entry points take ``device="cuda"`` by default. A CUDA request on a
machine without a CUDA device raises: the CPU is used only when the
caller passes ``device="cpu"`` (as the tests do).
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device must exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU explicitly")
    return dev
