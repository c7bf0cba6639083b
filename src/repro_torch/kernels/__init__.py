"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

  * :mod:`.codebook_lookup` — out[b] = Σ_h Z[idx[b, h]] (replaces
    ``codebook_lookup_pallas``).
  * :mod:`.fused_topk` — top-k of u·itemsᵀ + mask without the score
    matrix (replaces ``fused_topk_pallas``).
  * :mod:`.ref` — the plain versions; :mod:`.platform` — nvcc build and
    ctypes load; :mod:`.ops` — registration into the embedding layer.

Importing this package compiles and loads nothing.
"""
from . import platform, ref
from .codebook_lookup import codebook_lookup
from .fused_topk import fused_topk

__all__ = ["platform", "ref", "codebook_lookup", "fused_topk"]
