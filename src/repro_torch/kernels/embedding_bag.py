"""EmbeddingBag through the CSR gather-sum kernel (``csrc/embedding_bag.cu``).

Replaces ``repro/kernels/embedding_bag.py::embedding_bag_pallas``. One
kernel, ``out[s] = Σ_{j∈[ptr[s], ptr[s+1])} src[idx[j]]`` added in j
order, serves the bag forward (:func:`embedding_bag`) and both backward
passes of the embedding layer (:func:`scatter_rows`, used by
``kernels/ops.py``). Its weighted instantiation, ``Σ_j w[j]·src[idx[j]]``
with each product rounded on its own, is the LightGCN propagation,
forward and backward (``models/lightgcn.py``). Its 16-bit instantiation
(bf16, f16 rows summed in f32 and rounded once) is the backward of the
LM token lookup. On a CUDA tensor a wrapper launches the kernel (or
raises); on a CPU tensor it runs the plain version,
``ref.csr_gather_sum``, which the kernel equals bit for bit.
``csr_gather_sum.launches`` counts kernel launches, of every kind;
``csr_gather_sum.launches_weighted`` and ``.launches_16`` the weighted
and the 16-bit ones alone. On meta tensors :func:`csr_gather_sum` returns
the output's shape; under a ``launch.op_analysis`` count each call is
counted once at its ``cost.csr_gather_sum``, and :func:`embedding_bag`
takes the card's route (the stable sort, then the kernel) on the CPU too.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import cost, platform, ref

__all__ = ["csr_gather_sum", "embedding_bag", "scatter_rows"]

_NAME = "embedding_bag"


@functools.cache
def _entry(kind: str):
    """The C entry point of ``kind`` ("f32", "weighted" or "16": bf16 and
    f16 rows), bound once per process."""
    lib = platform.load(_NAME)
    fn = {"f32": lib.csr_gather_sum_launch,
          "weighted": lib.csr_gather_sum_weighted_launch,
          "16": lib.csr_gather_sum16_launch}[kind]
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * (5 if kind == "weighted" else 4)
                   + [ctypes.c_int64, ctypes.c_int]
                   + ([ctypes.c_int] if kind == "16" else [])
                   + [ctypes.c_void_p])
    return fn


def csr_gather_sum(src: torch.Tensor, idx: torch.Tensor, ptr: torch.Tensor,
                   weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """src f32, bf16 or f16 [R, d], idx int32 [nnz], ptr int64 [S + 1] ->
    [S, d] in src's dtype; with ``weight`` f32 [nnz] (f32 src only),
    value j is scaled by weight[j] first. 16-bit rows are summed in f32
    and rounded to the dtype once.

    ptr must ascend from 0 (values past ptr[S] are not read) and idx lie
    in [0, R); the kernel checks neither (the callers here build both)."""
    if src.dim() != 2 or idx.dim() != 1 or ptr.dim() != 1:
        raise ValueError(f"src [R, d], idx [nnz] and ptr [S + 1] expected, "
                         f"got {tuple(src.shape)}, {tuple(idx.shape)} and "
                         f"{tuple(ptr.shape)}")
    if weight is not None and weight.shape != idx.shape:
        raise ValueError(f"weight must be [nnz] like idx, got "
                         f"{tuple(weight.shape)} and {tuple(idx.shape)}")
    if weight is not None and src.dtype in (torch.bfloat16, torch.float16):
        raise TypeError(f"the weighted csr_gather_sum takes f32 src, not "
                        f"{src.dtype}")
    if cost.observer is not None:
        return cost.observe(_NAME, cost.csr_gather_sum(src, idx, ptr, weight),
                            csr_gather_sum, src, idx, ptr, weight)
    if src.device.type == "cpu":
        return ref.csr_gather_sum(src, idx, ptr, weight)
    if all(t.device.type == "meta" for t in (src, idx, ptr, weight)
           if t is not None):
        return torch.empty(ptr.shape[0] - 1, src.shape[1], dtype=src.dtype,
                           device="meta")
    dev = src.device
    if dev.type != "cuda" or idx.device != dev or ptr.device != dev or (
            weight is not None and weight.device != dev):
        raise ValueError(f"csr_gather_sum needs src, idx, ptr and weight on "
                         f"one CUDA device, got {src.device}, {idx.device}, "
                         f"{ptr.device} and "
                         f"{None if weight is None else weight.device}")
    if (src.dtype not in platform.DTYPES or idx.dtype != torch.int32
            or ptr.dtype != torch.int64 or (
                weight is not None and weight.dtype != torch.float32)):
        raise TypeError(f"csr_gather_sum takes f32, bf16 or f16 src, int32 "
                        f"idx, int64 ptr and f32 weight, got {src.dtype}, "
                        f"{idx.dtype}, {ptr.dtype} and "
                        f"{None if weight is None else weight.dtype}")
    src = src.contiguous()
    idx = idx.contiguous()
    ptr = ptr.contiguous()
    rows = int(ptr.shape[0]) - 1
    out = torch.empty(rows, src.shape[1], dtype=src.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (src.data_ptr(), idx.data_ptr(), ptr.data_ptr(), out.data_ptr(),
            rows, src.shape[1])
    if weight is not None:
        weight = weight.contiguous()
        status = _entry("weighted")(src.data_ptr(), idx.data_ptr(),
                                    weight.data_ptr(), ptr.data_ptr(),
                                    out.data_ptr(), rows, src.shape[1],
                                    stream)
    elif src.dtype == torch.float32:
        status = _entry("f32")(*args, stream)
    else:
        status = _entry("16")(*args, platform.DTYPES[src.dtype], stream)
    platform.check(status, _NAME)
    csr_gather_sum.launches += 1
    if weight is not None:
        csr_gather_sum.launches_weighted += 1
    elif src.dtype != torch.float32:
        csr_gather_sum.launches_16 += 1
    return out


csr_gather_sum.launches = 0
csr_gather_sum.launches_weighted = 0
csr_gather_sum.launches_16 = 0


def _ptr(sorted_ids: torch.Tensor, n: int) -> torch.Tensor:
    """int64 [n + 1] boundaries of the runs of 0..n-1 in ``sorted_ids``."""
    return torch.searchsorted(sorted_ids,
                              torch.arange(n + 1, device=sorted_ids.device))


def embedding_bag(table: torch.Tensor, values: torch.Tensor,
                  segment_ids: torch.Tensor,
                  num_segments: int) -> torch.Tensor:
    """table f32 [N, d], values int [nnz], segment_ids int [nnz] in any
    order -> [num_segments, d] bag sums, each added in value order from
    +0.0; empty bags are zero rows. Unsorted segment ids are stably
    sorted (values carried along) before the kernel runs, so each bag
    keeps its values' order and the result is the same.

    Raises on values outside [0, N) or segment ids outside
    [0, num_segments), and on non-integer indices.
    """
    if values.dim() != 1 or segment_ids.shape != values.shape:
        raise ValueError(f"values and segment_ids must be [nnz], got "
                         f"{tuple(values.shape)} and "
                         f"{tuple(segment_ids.shape)}")
    for name, t in (("values", values), ("segment_ids", segment_ids)):
        if t.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"{name} must be int32 or int64, got {t.dtype}")
    seg = segment_ids.long()
    unsorted = False
    if values.shape[0]:
        lo_v, hi_v = torch.aminmax(values)
        lo_s, hi_s = torch.aminmax(seg)
        bad = ((seg[1:] < seg[:-1]).any(), lo_v < 0,
               hi_v >= table.shape[0], lo_s < 0, hi_s >= num_segments)
        unsorted, *out_of_range = torch.stack(bad).tolist()
        if any(out_of_range):
            raise ValueError(f"embedding_bag: values must lie in "
                             f"[0, {table.shape[0]}) and segment_ids in "
                             f"[0, {num_segments})")
    if table.device.type == "cpu" and cost.observer is None:
        return ref.embedding_bag(table, values, segment_ids, num_segments)
    if unsorted:
        seg, perm = torch.sort(seg, stable=True)
        values = values[perm]
    return csr_gather_sum(table, values.int(), _ptr(seg, num_segments))


def scatter_rows(g: torch.Tensor, dest: torch.Tensor, src: torch.Tensor,
                 num_rows: int) -> torch.Tensor:
    """out[r] = Σ_{j: dest[j] == r} g[src[j]], added in j order from +0.0
    (the order of ``jax.ops.segment_sum`` on the CPU), in g's dtype (a
    16-bit g is summed in f32 and rounded once): the backward of a
    gather. A stable sort by ``dest`` keeps equal rows in j order, and
    the CSR gather-sum adds them; no float atomics. g [M, d]; dest and
    src int [J] with dest in [0, num_rows] and src in [0, M): an entry
    with dest == num_rows is dropped."""
    dest_sorted, perm = torch.sort(dest.long(), stable=True)
    return csr_gather_sum(g, src[perm].int(), _ptr(dest_sorted, num_rows))
