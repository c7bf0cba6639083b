"""The kernels' public entry points and their binding into the embedding
layer.

``dot_interaction`` and ``flash_attention`` are the ports of the
reference's ``repro.kernels.ops`` entry points of the same names, with
its arguments, defaults and shape checks; the block arguments set
nothing else (the CUDA kernels choose their own tiling).

Importing this module also registers the "cuda" lookup backend and the
"cuda" fused scorer into ``repro_torch.embedding.engine`` (the engine
defers this import until a lookup or scorer is first asked for). Both
launch the hand-written kernels for CUDA tensors and run the kernels'
plain versions for CPU tensors; nothing here falls back from a CUDA
tensor to a plain version.

Every lookup is a ``torch.autograd.Function`` (port of the reference's
``custom_vjp``s, ``repro/kernels/ops.py:96-119`` and ``:145-168``): the
forward runs a kernel, and the backward stably sorts the looked-up row
ids (masked entries sorted past the last row) and sums the cotangent
rows into each table row with the CSR gather-sum kernel
(:func:`.embedding_bag.scatter_rows`); nothing in it waits on the host.
With a stable sort, equal rows add in the reference's index order, and
two runs are bitwise equal: no float atomics. A bf16 or f16 table's
gradient has its dtype: its rows are summed in f32 and rounded once (the
reference's ``segment_sum`` of a bf16 cotangent on XLA's CPU rounds
after every add; ROADMAP Queue 3 records the difference).
"""
from __future__ import annotations

import torch

from repro_torch.embedding.engine import (LookupBackend, bag_combine,
                                          register_backend, register_scorer)

from .codebook_lookup import codebook_lookup
from .dot_interaction import dot_interaction as _dot_interaction
from .embedding_bag import embedding_bag, scatter_rows
from .flash_attention import flash_attention as _flash_attention
from .fused_topk import fused_topk
from .ref import dedup_keep_mask

__all__ = ["CudaBackend", "dot_interaction", "flash_attention"]


def _check_tiles(name, *sizes_and_blocks):
    """The reference's assertion that each size divides into its tile,
    ``min(block, size)`` (``dot_interaction.py:41``,
    ``flash_attention.py:82``), as a ValueError."""
    for what, size, block in sizes_and_blocks:
        tile = min(int(block), int(size))
        if tile <= 0 or size % tile:
            raise ValueError(f"{name}: {what} {size} is not divisible by its "
                             f"tile {tile}")


def dot_interaction(x, *, block_b=128):
    """x [B, F, d] -> [B, F(F-1)/2]: per example the strictly-lower
    triangle of X·Xᵀ (``np.tril_indices(F, -1)`` order), f32 sums, in
    x's dtype. B must divide into ``min(block_b, B)``."""
    _check_tiles("dot_interaction", ("batch", x.shape[0], block_b))
    return _dot_interaction(x)


def flash_attention(q, k, v, *, causal=True, block_q=128, block_k=128):
    """q/k/v [B, H, S, d] -> [B, H, Sq, d] in q's dtype: attention with
    scale 1/√d, f32 softmax, causal fill -1e30 (top-left aligned). Sq and
    Skv must divide into ``min(block_q, Sq)`` and ``min(block_k, Skv)``.
    Non-contiguous inputs (a transposed [B, S, H, d] view) are copied."""
    _check_tiles("flash_attention", ("Sq", q.shape[2], block_q),
                 ("Skv", k.shape[2], block_k))
    return _flash_attention(q, k, v, causal=causal)


class _CodebookSum(torch.autograd.Function):
    """out[b] = Σ_h Z[idx[b, h]] (first occurrence only when ``binary``);
    dZ[r] = Σ over the kept (b, h) with idx[b, h] == r of g[b]."""

    @staticmethod
    def forward(ctx, codebook, idx, binary):
        ctx.save_for_backward(idx)
        ctx.binary = binary
        ctx.k_rows = codebook.shape[0]
        return codebook_lookup(codebook, idx, binary=binary)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        b, h = idx.shape
        dest = idx.reshape(-1)
        src = torch.arange(b * h, device=idx.device) // h
        if ctx.binary and h > 1:
            # a dropped duplicate goes to row k_rows, past the last row the
            # sum reads: no boolean indexing, so no host sync
            keep = dedup_keep_mask(idx).reshape(-1)
            dest = torch.where(keep, dest.long(), ctx.k_rows)
        return scatter_rows(g, dest, src, ctx.k_rows), None, None


class _BlockRows(torch.autograd.Function):
    """A row block's rows of global ids (exact zeros outside the block) by
    the codebook_lookup kernel (H = 1); dT[r] = Σ over the ids j equal to
    lo + r of g[j], by the CSR gather-sum, ids outside the block dropped
    past the last row (no long run of them into one row)."""

    @staticmethod
    def forward(ctx, table, ids, lo):
        local = ids.reshape(-1).long() - lo
        n = table.shape[0]
        inr = (local >= 0) & (local < n)
        out = codebook_lookup(table, torch.where(inr, local, 0)[:, None].int(),
                              binary=False)
        ctx.save_for_backward(torch.where(inr, local, n))
        ctx.n_rows = n
        out = torch.where(inr[:, None], out, 0.0)
        return out.reshape(*ids.shape, table.shape[-1])

    @staticmethod
    def backward(ctx, g):
        (dest,) = ctx.saved_tensors
        src = torch.arange(dest.shape[0], device=dest.device)
        g = g.reshape(-1, g.shape[-1]).contiguous()
        return scatter_rows(g, dest, src, ctx.n_rows), None, None


class _Bag(torch.autograd.Function):
    """Bag sums (segments in any order); dT[n] = Σ_{j: values[j] == n}
    g[segment_ids[j]]."""

    @staticmethod
    def forward(ctx, table, values, segment_ids, num_segments):
        ctx.save_for_backward(values, segment_ids)
        ctx.n_rows = table.shape[0]
        return embedding_bag(table, values, segment_ids, num_segments)

    @staticmethod
    def backward(ctx, g):
        values, segment_ids = ctx.saved_tensors
        return (scatter_rows(g, values, segment_ids, ctx.n_rows),
                None, None, None)


class CudaBackend(LookupBackend):
    """Lookups through the codebook_lookup kernel (which applies the
    binary-Y rule itself) and the CSR gather-sum kernel, with the
    gradients above. No per-value bag weights (the engine sends weighted
    bags to "gather"); bags may come in any segment order (the bag
    wrapper sorts them stably)."""
    name = "cuda"
    supports_bag_weights = False

    def full(self, table, ids):
        # the ids come from the caller and the kernel checks no index
        if ids.numel():
            lo, hi = torch.aminmax(ids.reshape(-1))
            if bool((lo < 0) | (hi >= table.shape[0])):
                raise ValueError(f"ids must lie in [0, {table.shape[0]})")
        flat = ids.reshape(-1, 1).int()
        out = _CodebookSum.apply(table, flat, False)
        return out.reshape(*ids.shape, table.shape[-1])

    def block(self, table, ids, lo):
        return _BlockRows.apply(table, ids, int(lo))

    def codebook_sum(self, codebook, rows_idx):
        h = rows_idx.shape[-1]
        out = _CodebookSum.apply(codebook, rows_idx.reshape(-1, h).int(),
                                 True)
        return out.reshape(*rows_idx.shape[:-1], codebook.shape[-1])

    def bag(self, table, values, segment_ids, num_segments, mode="sum",
            weights=None):
        if weights is not None:
            raise NotImplementedError(
                "the cuda embedding_bag has no per-value weights; the engine "
                "sends weighted bags to the gather backend")
        out = _Bag.apply(table, values, segment_ids, num_segments)
        return bag_combine(out, segment_ids, num_segments, mode)


register_backend(CudaBackend())
register_scorer("cuda", fused_topk)
