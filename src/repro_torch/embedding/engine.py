"""EmbeddingEngine: one dispatch layer for every embedding lookup
(port of ``repro.embedding.engine``, the parts the serving slice uses).

The compressed lookup e = Σ_h Z[sketch[i, h]] with the BINARY-Y rule: a
duplicate sketch index contributes once (paper §3.2). (Uncompressed
tables are used as they are; bag lookups come with their kernel.)

Backends (registry):

  * "gather": plain tensor indexing — any device.
  * "cuda":   the hand-written codebook_lookup kernel (registered by
              ``repro_torch.kernels.ops`` on first use).

Auto-selection: lookups on a CUDA tensor go to "cuda", on the CPU to
"gather".

Fused scorers (registry, same dispatch one level up): "cuda", the
fused_topk kernel, is the one scorer. ``topk`` is the dense readout's
top-k, in ``lax.top_k``'s order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.kernels.ref import dedup_keep_mask, topk

__all__ = ["EmbeddingSpec", "EmbeddingEngine", "LookupBackend",
           "register_backend", "get_backend", "normalize_backend",
           "dedup_keep_mask", "register_scorer", "get_scorer", "fused_topk",
           "topk"]


@dataclasses.dataclass(frozen=True)
class EmbeddingSpec:
    """Static description of one (possibly compressed) table."""
    n_rows: int                     # logical vocabulary size
    dim: int
    k_rows: Optional[int] = None    # codebook rows if compressed
    n_hot: int = 1                  # sketch multiplicity (SCU -> 2)


class LookupBackend:
    """One codebook-lookup strategy. Subclass + register.

    Contract:
      codebook_sum(codebook [K,d], rows_idx [..., H])    -> [..., d]
          sum over h of codebook[rows_idx[..., h]], where a repeated
          index in a row counts once (first occurrence; binary Y).
    """
    name: str = "?"

    def codebook_sum(self, codebook, rows_idx):
        raise NotImplementedError


_REGISTRY: Dict[str, LookupBackend] = {}


def register_backend(backend: LookupBackend) -> LookupBackend:
    _REGISTRY[backend.name] = backend
    return backend


def _ensure_registered():
    # the "cuda" backend and scorers live with their kernels
    if "cuda" not in _REGISTRY:
        import repro_torch.kernels.ops  # noqa: F401


def get_backend(name: str) -> LookupBackend:
    _ensure_registered()
    if name not in _REGISTRY:
        raise KeyError(f"unknown lookup backend {name!r}; "
                       f"registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def normalize_backend(name: Optional[str]) -> Optional[str]:
    """"auto"/None mean auto-selection (None); anything else must name a
    registered backend (KeyError otherwise, listing what exists)."""
    if name is None or name == "auto":
        return None
    get_backend(name)
    return name


_SCORERS: Dict[str, Any] = {}


def register_scorer(name: str, fn) -> None:
    _SCORERS[name] = fn


def get_scorer(name: str):
    _ensure_registered()
    if name not in _SCORERS:
        raise KeyError(f"unknown fused scorer {name!r}; "
                       f"registered: {sorted(_SCORERS)}")
    return _SCORERS[name]


def fused_topk(u, items, k, *, scale=None, mask=None, exclude=None,
               block=1024):
    """One-pass score -> top-k over the item axis.

    Returns ``(values [B, k] f32, ids [B, k] int32)`` equal to the top-k
    of ``u @ items.T + mask`` with ``lax.top_k``'s order, without the
    [B, N] score matrix (scorer "cuda"). int8 ``items``
    dequantize through the per-row f32 ``scale``; ``exclude`` is a
    (rows, cols) pair scored -inf.
    """
    return get_scorer("cuda")(u, items, k, scale=scale, mask=mask,
                              exclude=exclude, block=block)


class GatherBackend(LookupBackend):
    """Plain tensor indexing — the safe default on every device."""
    name = "gather"

    def codebook_sum(self, codebook, rows_idx):
        keep = dedup_keep_mask(rows_idx)
        rows = codebook[rows_idx]                          # [..., H, d]
        return torch.where(keep[..., None], rows, 0.0).sum(dim=-2)


register_backend(GatherBackend())


@dataclasses.dataclass(frozen=True)
class EmbeddingEngine:
    """Routes lookups for one table through the selected backend.

    backend: explicit override ("gather" | "cuda" | None for auto).
    """
    spec: EmbeddingSpec
    backend: Optional[str] = None

    def resolve(self, device: torch.device) -> LookupBackend:
        """The override, else "cuda" on a CUDA device, else "gather"."""
        if self.backend is not None and self.backend != "auto":
            return get_backend(self.backend)
        return get_backend("cuda" if device.type == "cuda" else "gather")

    def codebook_lookup(self, codebook, sketch_idx, ids=None):
        """Compressed lookup e = Σ_h Z[sketch[i, h]] (paper §3.2/§4.5).

        codebook [K, d], sketch_idx int [N, H], ids int [...] -> [..., d];
        ``ids=None`` looks up every row, [N, d]. Duplicate sketch indices
        contribute once (binary Y) on every backend.
        """
        rows_idx = sketch_idx if ids is None else sketch_idx[ids]
        return self.resolve(codebook.device).codebook_sum(codebook, rows_idx)
