"""The kernels' binding into the embedding layer.

Importing this module registers the "cuda" lookup backend and the
"cuda" fused scorer into ``repro_torch.embedding.engine`` (the engine
defers this import until a lookup or scorer is first asked for). Both
launch the hand-written kernels for CUDA tensors and run the kernels'
plain versions for CPU tensors; nothing here falls back from a CUDA
tensor to a plain version.

Every lookup is a ``torch.autograd.Function`` (port of the reference's
``custom_vjp``s, ``repro/kernels/ops.py:96-119`` and ``:145-168``): the
forward runs a kernel, and the backward drops masked entries, stably
sorts the looked-up row ids and sums the cotangent rows into each table
row with the CSR gather-sum kernel (:func:`.embedding_bag.scatter_rows`).
With a stable sort, equal rows add in the reference's index order, and
two runs are bitwise equal: no float atomics.
"""
from __future__ import annotations

import torch

from repro_torch.embedding.engine import (LookupBackend, bag_combine,
                                          register_backend, register_scorer)

from .codebook_lookup import codebook_lookup
from .embedding_bag import embedding_bag, scatter_rows
from .fused_topk import fused_topk
from .ref import dedup_keep_mask

__all__ = ["CudaBackend"]


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
            keep = dedup_keep_mask(idx).reshape(-1)
            dest, src = dest[keep], src[keep]
        return scatter_rows(g, dest, src, ctx.k_rows), None, None


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
