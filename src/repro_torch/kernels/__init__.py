"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

  * :mod:`.codebook_lookup` — out[b] = Σ_h Z[idx[b, h]] (replaces
    ``codebook_lookup_pallas``).
  * :mod:`.fused_topk` — top-k of u·itemsᵀ + mask without the score
    matrix (replaces ``fused_topk_pallas``), and its codebook variant
    over implicit items Σ_h Z[sketch[i, h]] (replaces
    ``fused_topk_codebook_pallas``).
  * :mod:`.embedding_bag` — the CSR gather-sum (replaces
    ``embedding_bag_pallas``; also the lookups' backward).
  * :mod:`.dot_interaction` — DLRM's strictly-lower triangle of X·Xᵀ per
    example (replaces ``dot_interaction_pallas``).
  * :mod:`.flash_attention` — blocked online-softmax attention, forward
    (replaces ``flash_attention_pallas``).
  * :mod:`.ref` — the plain versions; :mod:`.platform` — nvcc build and
    ctypes load; :mod:`.ops` — the public ``dot_interaction`` and
    ``flash_attention`` entry points (the reference's arguments and
    shape checks) and the registration into the embedding layer, with
    the gradients.

Importing this package compiles and loads nothing.
"""
from . import platform, ref
from .codebook_lookup import codebook_lookup
from .dot_interaction import dot_interaction
from .embedding_bag import csr_gather_sum, embedding_bag
from .flash_attention import flash_attention
from .fused_topk import fused_topk, fused_topk_codebook

__all__ = ["platform", "ref", "codebook_lookup", "csr_gather_sum",
           "dot_interaction", "embedding_bag", "flash_attention",
           "fused_topk", "fused_topk_codebook"]
