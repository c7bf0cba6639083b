"""Embedding table initialisation and the legacy lookup entry points
(port of ``repro.embedding.tables``).

Tables start as host numpy arrays drawn from a numpy seed, so a caller
can feed the same arrays to both packages (the reference draws from a
``jax.random`` key, which numpy cannot reproduce); the caller moves them
to the device. The lookups are thin wrappers over an
``EmbeddingEngine``; ``via=None`` auto-selects the backend from the
tensors' device ("cuda" on a GPU, "gather" on the CPU).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .engine import EmbeddingEngine, EmbeddingSpec

__all__ = ["EmbeddingSpec", "init_embedding", "embed_lookup",
           "init_codebook", "codebook_lookup", "embedding_bag"]


def init_embedding(rng: np.random.Generator, n_rows: int, dim: int,
                   scale: float = 0.1) -> np.ndarray:
    """f32 [n_rows, dim] ~ N(0, scale^2)."""
    return (rng.standard_normal((n_rows, dim), dtype=np.float32)
            * np.float32(scale))


def init_codebook(rng: np.random.Generator, k_rows: int, dim: int,
                  scale: float = 0.1) -> np.ndarray:
    """f32 [k_rows, dim] ~ N(0, scale^2)."""
    return init_embedding(rng, k_rows, dim, scale)


def _engine(table, via: Optional[str]) -> EmbeddingEngine:
    spec = EmbeddingSpec(n_rows=int(table.shape[0]), dim=int(table.shape[-1]))
    return EmbeddingEngine(spec, backend=via)


def embed_lookup(table, ids, *, via: Optional[str] = None):
    """Full-table lookup. table [N, d], ids int [...] -> [..., d]."""
    return _engine(table, via).full_lookup(table, ids)


def codebook_lookup(codebook, sketch_idx, ids, *, combine: str = "sum",
                    via: Optional[str] = None):
    """Compressed lookup: rows = Σ_h Z[sketch_idx[ids, h]] (paper §3.2/4.5).

    codebook [K, d], sketch_idx int [N, H], ids int [...] -> [..., d];
    duplicate sketch indices contribute once (binary Y).
    """
    spec = EmbeddingSpec(n_rows=int(sketch_idx.shape[0]),
                         dim=int(codebook.shape[-1]),
                         k_rows=int(codebook.shape[0]),
                         n_hot=int(sketch_idx.shape[-1]))
    return EmbeddingEngine(spec, backend=via).codebook_lookup(
        codebook, sketch_idx, ids, combine=combine)


def embedding_bag(table, values, segment_ids, num_segments: int,
                  mode: str = "sum", weights=None, *,
                  via: Optional[str] = None):
    """``torch.nn.EmbeddingBag`` through the engine: table [N, d], values
    int [nnz] (flattened multi-hot indices), segment_ids int [nnz] (the
    bag of each value, in any order) -> [num_segments, d]."""
    return _engine(table, via).bag_lookup(table, values, segment_ids,
                                          num_segments, mode=mode,
                                          weights=weights)
