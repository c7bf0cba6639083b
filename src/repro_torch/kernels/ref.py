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
           "segment_sum", "embedding_bag", "csr_gather_sum", "expand_items",
           "topk", "fused_topk"]


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


def segment_sum(rows: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """rows [M, d], segment_ids int [M] (any order) -> [num_segments, d]:
    each segment is a left fold of its rows in index order from +0.0,
    the order of ``jax.ops.segment_sum`` on the CPU (a serial
    scatter-add) and of the CSR gather-sum kernel. Empty segments are 0.

    A stable sort groups each segment's rows in index order; step r adds
    every segment's r-th row at once, so no step adds two rows into one
    sum and the order holds on a GPU too. Steps: the largest segment's
    size (reading it is one sync). Differentiable in ``rows`` (the
    in-place adds go into a fresh tensor that autograd records).
    """
    out = torch.zeros(num_segments, *rows.shape[1:], dtype=rows.dtype,
                      device=rows.device)
    m = int(segment_ids.shape[0])
    if m == 0:
        return out
    order = torch.sort(segment_ids, stable=True).indices
    seg = segment_ids[order].long()
    pos = torch.arange(m, device=rows.device)
    first = torch.ones(m, dtype=torch.bool, device=rows.device)
    first[1:] = seg[1:] != seg[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    by_rank = torch.sort(rank, stable=True).indices
    seg = seg[by_rank]
    src = order[by_rank]
    lo = 0
    for c in torch.bincount(rank).tolist():
        out.index_add_(0, seg[lo:lo + c], rows[src[lo:lo + c]])
        lo += c
    return out


def embedding_bag(table: torch.Tensor, values: torch.Tensor,
                  segment_ids: torch.Tensor,
                  num_segments: int) -> torch.Tensor:
    """table [N, d], values int [nnz], segment_ids int [nnz] ->
    [num_segments, d] bag sums, each folded in value order from +0.0
    (so the CSR gather-sum kernel, which adds in the same order, equals
    it bit for bit). Empty bags are zero rows."""
    return segment_sum(table[values.long()], segment_ids, num_segments)


def csr_gather_sum(src: torch.Tensor, idx: torch.Tensor,
                   ptr: torch.Tensor) -> torch.Tensor:
    """out[s] = Σ_{j in [ptr[s], ptr[s+1])} src[idx[j]], added in j order
    from +0.0: the CSR kernel's contract. ptr int [S + 1], ascending."""
    n_seg = int(ptr.shape[0]) - 1
    seg = torch.repeat_interleave(
        torch.arange(n_seg, device=src.device), (ptr[1:] - ptr[:-1]).long())
    return embedding_bag(src, idx, seg, n_seg)


def expand_items(items: torch.Tensor, scale=None, sketch=None) -> torch.Tensor:
    """The f32 item matrix the fused top-k scores against. int8 rows are
    dequantized first, as ``q.float() * scale[r]`` (per row of ``items``:
    per codebook row when a sketch is given); with ``sketch`` int [N, H]
    the rows then expand as Σ_h Z[sketch[i, h]] under the binary-Y rule,
    added in h order from +0.0 (the order of the JAX reference)."""
    v = items.float()
    if scale is not None:
        v = v * scale.float()[:, None]
    if sketch is not None:
        v = codebook_lookup(v, sketch, binary=True)
    return v


def topk(scores: torch.Tensor, k: int):
    """Row-wise top-k with ``lax.top_k``'s order: highest value first,
    lowest index among equal values (rows with fewer than k finite
    scores fill with the lowest-index -inf entries). ``torch.topk``
    promises no tie order, so this is a stable descending sort. Values
    compare by IEEE equality, so -0.0 and +0.0 tie (``lax.top_k`` ranks
    +0.0 first; the reference's fused kernel ties them too). NaN ranks
    above every number, lowest index first among NaNs, as in
    ``lax.top_k`` for a NaN with a clear sign bit (``lax.top_k`` ranks a
    NaN with the sign bit set below -inf; this order ranks every NaN
    first, as the CUDA selection does)."""
    vals, ids = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], ids[:, :k].to(torch.int32)


def fused_topk(u, items, k, *, sketch=None, scale=None, mask=None,
               exclude=None):
    """top-k of ``u @ V.T + mask`` with exclusions set to -inf, where V
    is ``expand_items(items, scale, sketch)``.

    u [B, d] f32; items [N, d] f32, or int8 with ``scale`` f32 [N]; with
    ``sketch`` int [N, H], items is a codebook [K, d] (``scale`` [K]);
    mask f32 [N] added to every row; exclude a (rows, cols) pair of int
    tensors (excluded items score -inf and remain candidates).
    Returns (values f32 [B, k], ids int32 [B, k]) in ``topk`` order.
    """
    k = int(k)
    n = int(items.shape[0] if sketch is None else sketch.shape[0])
    if k > n:
        raise ValueError(f"k={k} exceeds n_items={n}")
    s = u.float() @ expand_items(items, scale, sketch).T
    if mask is not None:
        s = s + mask.float()[None, :]
    if exclude is not None and len(exclude[0]):
        rows = torch.as_tensor(exclude[0], device=s.device).long()
        cols = torch.as_tensor(exclude[1], device=s.device).long()
        ok = (rows >= 0) & (rows < s.shape[0]) & (cols >= 0) & (cols < n)
        s[rows[ok], cols[ok]] = float("-inf")
    return topk(s, k)
