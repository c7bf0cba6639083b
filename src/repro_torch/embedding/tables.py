"""Embedding table initialisation (port of ``repro.embedding.tables``).

Tables start as host numpy arrays drawn from a numpy seed, so a caller
can feed the same arrays to both packages; the session moves them to
the device.
"""
from __future__ import annotations

import numpy as np

__all__ = ["init_codebook"]


def init_codebook(rng: np.random.Generator, k_rows: int, dim: int,
                  scale: float = 0.1) -> np.ndarray:
    """f32 [k_rows, dim] ~ N(0, scale^2)."""
    return (rng.standard_normal((k_rows, dim), dtype=np.float32)
            * np.float32(scale))
