"""What one call of each hand-written kernel moves and computes.

One function a kernel: the call's tensors (CUDA, CPU or meta: only their
shapes and dtypes are read) -> :class:`Cost`, the bytes the call must
move (each input read once, each output written once) and its
operations, f32 ones (``ops``) apart from products of two bf16 or f16
values summed in f32 on the tensor cores (``ops16``). :func:`bound` puts
a cost against the H100 SXM's published peaks. ``chip_smoke.py``'s kernel
rows and ``launch.op_analysis``'s reckoning of a whole step both take
their numbers from here.

A kernel's data can let it read less than its shapes say: a lookup whose
ids repeat reads fewer distinct rows, a CSR gather-sum whose ``ptr`` ends
before ``idx`` does sums fewer values. ``rows=`` and ``nnz=`` give those
counts where the caller knows them (the smoke counts them on the card);
left out, they follow from the shapes alone, which is what a reckoning on
meta tensors can know.

While a ``launch.op_analysis`` count runs, :data:`observer` is set and
every kernel wrapper hands its call to :func:`observe` (one check of a
module attribute when no count runs).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = ["Cost", "bound", "codebook_lookup", "csr_gather_sum",
           "dot_interaction", "flash_attention", "attention_ops",
           "fused_topk", "fused_topk_codebook", "observe", "observer",
           "HBM_BYTES_PER_S", "F32_OPS_PER_S", "F16_OPS_PER_S"]

# published H100 SXM peaks (NVIDIA data sheet, dense): HBM bandwidth, the
# f32 rate outside the tensor cores, and the bf16/f16 tensor-core rate with
# f32 accumulation
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F16_OPS_PER_S = 989e12

_WIDE = (torch.float32, torch.float64)

# the running count (``launch.op_analysis.OpAnalysis``) or None
observer = None


class Cost(NamedTuple):
    bytes: float
    ops: float = 0.0            # at the f32 rate
    ops16: float = 0.0          # at the bf16/f16 tensor rate


def bound(cost: Cost) -> tuple:
    """(bound_ms, bound_by): the larger of the bytes over HBM bandwidth and
    the operations over their type's rate."""
    t_bytes = cost.bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (cost.ops / F32_OPS_PER_S + cost.ops16 / F16_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _split(ops: float, dtype: torch.dtype) -> Cost:
    """``ops`` at the f32 rate for f32 inputs, at the tensor rate for
    16-bit ones."""
    return Cost(0.0, ops, 0.0) if dtype in _WIDE else Cost(0.0, 0.0, ops)


def codebook_lookup(codebook: torch.Tensor, idx: torch.Tensor, *,
                    rows: Optional[int] = None) -> Cost:
    """out[b] = Σ_h Z[idx[b, h]]: idx read, ``rows`` distinct codebook
    rows read (default: every lookup a row, at most the codebook), out
    written; one add a looked-up element."""
    b, h = idx.shape
    k, d = codebook.shape
    rows = min(k, b * h) if rows is None else rows
    es = codebook.element_size()
    return Cost(_nbytes(idx) + es * (rows * d + b * d), b * h * d)


def csr_gather_sum(src: torch.Tensor, idx: torch.Tensor, ptr: torch.Tensor,
                   weight: Optional[torch.Tensor] = None, *,
                   nnz: Optional[int] = None,
                   rows: Optional[int] = None) -> Cost:
    """out[s] = Σ_{j∈[ptr[s], ptr[s+1])} (w[j]·) src[idx[j]]: ``nnz``
    values summed (default: all of idx), ``rows`` distinct source rows read
    (default: at most one a value, at most the table), idx (and w) and ptr
    read, out written; one add a value's element, and one multiply with a
    weight."""
    r, d = src.shape
    n_seg = ptr.shape[0] - 1
    nnz = idx.shape[0] if nnz is None else nnz
    rows = min(r, nnz) if rows is None else rows
    es = src.element_size()
    moved = (es * (rows * d + n_seg * d) + idx.element_size() * nnz
             + ptr.element_size() * (n_seg + 1))
    if weight is not None:
        moved += weight.element_size() * nnz
    return Cost(moved, (2 if weight is not None else 1) * nnz * d)


def dot_interaction(x: torch.Tensor) -> Cost:
    """The strictly-lower triangle of X·Xᵀ per example: x read, out
    written; a multiply-add a pair and element."""
    b, f, d = x.shape
    p = f * (f - 1) // 2
    return _split(2.0 * b * p * d, x.dtype)._replace(
        bytes=x.element_size() * (x.numel() + b * p))


def attention_ops(b: int, h: int, sq: int, skv: int, d: int,
                  causal: bool) -> float:
    """Multiply-adds x 2 of q·kᵀ and P·V over the (query, key) pairs the
    mask keeps (key position <= query position when causal)."""
    if not causal:
        pairs = sq * skv
    elif sq <= skv:
        pairs = sq * (sq + 1) // 2
    else:
        pairs = skv * (skv + 1) // 2 + (sq - skv) * skv
    return 4.0 * b * h * pairs * d


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> Cost:
    """q, k, v read and out written once; q·kᵀ and P·V over the kept pairs
    (16-bit inputs: every product at the tensor rate)."""
    b, h, sq, d = q.shape
    ops = attention_ops(b, h, sq, k.shape[2], d, causal)
    return _split(ops, q.dtype)._replace(
        bytes=q.element_size() * (2 * q.numel() + k.numel() + v.numel()))


def fused_topk(u: torch.Tensor, items: torch.Tensor, k: int, *,
               scale=None, mask=None) -> Cost:
    """u and items (and scale, mask) read, values and ids written; a
    multiply-add a (row, item, element), and a scale multiply a score for
    int8 items."""
    b, d = u.shape
    n = items.shape[0]
    moved = _nbytes(u) + _nbytes(items) + 8 * b * k
    for t in (scale, mask):
        if t is not None:
            moved += _nbytes(t)
    ops = 2.0 * b * n * d + (b * n if scale is not None else 0)
    return Cost(moved, ops)


def fused_topk_codebook(u: torch.Tensor, codebook: torch.Tensor,
                        sketch: torch.Tensor, k: int, *, scale=None,
                        mask=None) -> Cost:
    """u, the codebook, the sketch (and scale, mask) read, values and ids
    written; each item row summed from its H codebook rows, then a
    multiply-add a (row, item, element)."""
    b, d = u.shape
    n, h = sketch.shape
    moved = _nbytes(u) + _nbytes(codebook) + _nbytes(sketch) + 8 * b * k
    for t in (scale, mask):
        if t is not None:
            moved += _nbytes(t)
    return Cost(moved, 2.0 * b * n * d + n * h * d)


def observe(name: str, cost: Cost, fn, *args, **kwargs):
    """One kernel call under a running count: ``observer`` records it (its
    name and cost) and runs ``fn`` (the wrapper, called again with the
    observer cleared), counting none of what runs inside."""
    global observer
    obs, observer = observer, None
    try:
        return obs.kernel(name, cost, fn, *args, **kwargs)
    finally:
        observer = obs
