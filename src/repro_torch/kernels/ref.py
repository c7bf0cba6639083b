"""Plain PyTorch versions of the port's kernels (the correctness
contracts, port of ``repro.kernels.ref``).

Each function here computes what one CUDA kernel computes, with ordinary
tensor ops, on any device. The kernel wrappers use them for tensors on
the CPU; the tests hold them against the JAX reference, and
``chip_smoke.py`` holds the kernels against them on the card.
"""
from __future__ import annotations

import torch

__all__ = ["dedup_keep_mask", "codebook_lookup", "codebook_lookup_dedup",
           "expand_items", "topk", "fused_topk"]


def dedup_keep_mask(rows_idx: torch.Tensor) -> torch.Tensor:
    """bool [..., H]: True where an index is the FIRST occurrence in its
    row (the paper's binary Y: duplicates contribute once)."""
    h = rows_idx.shape[-1]
    keep = torch.ones(rows_idx.shape, dtype=torch.bool,
                      device=rows_idx.device)
    for i in range(1, h):
        dup = torch.zeros(rows_idx.shape[:-1], dtype=torch.bool,
                          device=rows_idx.device)
        for j in range(i):
            dup = dup | (rows_idx[..., i] == rows_idx[..., j])
        keep[..., i] = ~dup
    return keep


def codebook_lookup(codebook: torch.Tensor, idx: torch.Tensor,
                    binary: bool = False) -> torch.Tensor:
    """codebook [K, d], idx int [B, H] -> [B, d] = Σ_h Z[idx[:, h]],
    summed in h order from zero (so the CUDA kernel, which adds in the
    same order, equals it bit for bit). ``binary``: a repeated index in
    a row counts once (first occurrence wins)."""
    keep = dedup_keep_mask(idx) if binary and idx.shape[1] > 1 else None
    out = torch.zeros(idx.shape[0], codebook.shape[1], dtype=codebook.dtype,
                      device=codebook.device)
    for h in range(idx.shape[1]):
        rows = codebook[idx[:, h].long()]
        if keep is not None:
            rows = torch.where(keep[:, h, None], rows, 0.0)
        out = out + rows
    return out


def codebook_lookup_dedup(codebook: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """Binary-Y lookup (paper §3.2): duplicates within a row count once."""
    return codebook_lookup(codebook, idx, binary=True)


def expand_items(items: torch.Tensor, scale=None) -> torch.Tensor:
    """The f32 item matrix the fused top-k scores against: int8 rows are
    dequantized as ``q.float() * scale[i]``."""
    if scale is not None:
        return items.float() * scale.float()[:, None]
    return items.float()


def topk(scores: torch.Tensor, k: int):
    """Row-wise top-k with ``lax.top_k``'s order: highest value first,
    lowest index among equal values (rows with fewer than k finite
    scores fill with the lowest-index -inf entries). ``torch.topk``
    promises no tie order, so this is a stable descending sort. Values
    compare by IEEE equality, so -0.0 and +0.0 tie (``lax.top_k`` ranks
    +0.0 first; the reference's fused kernel ties them too)."""
    vals, ids = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], ids[:, :k].to(torch.int32)


def fused_topk(u, items, k, *, scale=None, mask=None, exclude=None):
    """top-k of ``u @ items.T + mask`` with exclusions set to -inf.

    u [B, d] f32; items [N, d] f32, or int8 with ``scale`` f32 [N];
    mask f32 [N] added to every row; exclude a (rows, cols) pair of int
    tensors (excluded items score -inf and remain candidates).
    Returns (values f32 [B, k], ids int32 [B, k]) in ``topk`` order.
    """
    k = int(k)
    n = int(items.shape[0])
    if k > n:
        raise ValueError(f"k={k} exceeds n_items={n}")
    s = u.float() @ expand_items(items, scale).T
    if mask is not None:
        s = s + mask.float()[None, :]
    if exclude is not None and len(exclude[0]):
        rows = torch.as_tensor(exclude[0], device=s.device).long()
        cols = torch.as_tensor(exclude[1], device=s.device).long()
        ok = (rows >= 0) & (rows < s.shape[0]) & (cols >= 0) & (cols < n)
        s[rows[ok], cols[ok]] = float("-inf")
    return topk(s, k)
