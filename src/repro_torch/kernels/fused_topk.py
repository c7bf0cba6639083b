"""Fused score -> top-k kernel (``csrc/fused_topk.cu``).

Replaces ``repro/kernels/fused_topk.py::fused_topk_pallas``: the top-k
of ``u @ items.T + mask`` per row, with ``lax.top_k``'s order (highest
value first, lowest id among equals), without the [B, N] score matrix.
On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs the plain version, ``ref.fused_topk``.
``fused_topk.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import platform, ref

__all__ = ["fused_topk", "exclusion_csr"]

_NAME = "fused_topk"
_MAX_ROWS = 65535 * 8           # grid.y = ceil(rows / 8) <= 65535


def _entry():
    """(launch fn, k cap, d cap) of the built library; the caps are
    compile-time constants of the kernel source."""
    lib = platform.load(_NAME)
    fn = lib.fused_topk_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] * 5)
    return fn, lib.fused_topk_max_k(), lib.fused_topk_max_dim()


def exclusion_csr(exclude, rows: int, n: int, device):
    """(ptr int32 [rows + 1], ids int32) of the (row, item) exclusion
    pairs: row r's excluded items are ``ids[ptr[r]:ptr[r + 1]]``,
    ascending. Pairs outside [0, rows) x [0, n) are dropped. Built on
    ``device`` with one sort."""
    r = torch.as_tensor(exclude[0], device=device).long()
    c = torch.as_tensor(exclude[1], device=device).long()
    ok = (r >= 0) & (r < rows) & (c >= 0) & (c < n)
    key = torch.sort(r[ok] * n + c[ok]).values
    ptr = torch.searchsorted(key, torch.arange(rows + 1, device=device) * n)
    return ptr.to(torch.int32), (key % n).to(torch.int32)


def fused_topk(u: torch.Tensor, items: torch.Tensor, k: int, *, scale=None,
               mask=None, exclude=None, block: int = 1024):
    """``top-k(u @ items.T + mask)`` -> (values f32 [B, k], ids int32 [B, k]).

    u f32 [B, d]; items f32 [N, d], or int8 with ``scale`` f32 [N]
    (dequantized in the kernel); ``mask`` f32 [N] is added to every row;
    ``exclude`` is a (rows, cols) pair of int arrays whose items score
    -inf in those rows (and remain candidates). ``block`` is the number
    of items one thread block scores before its partial top-k is merged.
    k must not exceed N nor the kernel's cap (32); d must not exceed 256.
    """
    k = int(k)
    if u.dim() != 2 or items.dim() != 2 or u.shape[1] != items.shape[1]:
        raise ValueError(f"u [B, d] and items [N, d] expected, got "
                         f"{tuple(u.shape)} and {tuple(items.shape)}")
    rows, d = u.shape
    n = int(items.shape[0])
    if k > n:
        raise ValueError(f"k={k} exceeds n_items={n}")
    if u.device.type == "cpu":
        return ref.fused_topk(u, items, k, scale=scale, mask=mask,
                              exclude=exclude)
    dev = u.device
    if dev.type != "cuda" or items.device != dev:
        raise ValueError(f"fused_topk needs u and items on one CUDA device, "
                         f"got {u.device} and {items.device}")
    launch, max_k, max_dim = _entry()
    if not 1 <= k <= max_k:
        raise ValueError(f"fused_topk takes 1 <= k <= {max_k}, got k={k}")
    if d > max_dim or rows > _MAX_ROWS:
        raise ValueError(f"fused_topk takes d <= {max_dim} and at most "
                         f"{_MAX_ROWS} rows, got d={d}, rows={rows}")
    if u.dtype != torch.float32:
        raise TypeError(f"u must be f32, got {u.dtype}")
    quantized = scale is not None
    want = torch.int8 if quantized else torch.float32
    if items.dtype != want:
        raise TypeError(f"items must be {want} "
                        f"({'with' if quantized else 'without'} scale), "
                        f"got {items.dtype}")
    for name, t in (("scale", scale), ("mask", mask)):
        if t is not None and (t.device != dev or t.dtype != torch.float32
                              or tuple(t.shape) != (n,)):
            raise ValueError(f"{name} must be f32 [{n}] on {dev}")
    u = u.contiguous()
    items = items.contiguous()
    scale = scale.contiguous() if quantized else None
    mask = mask.contiguous() if mask is not None else None
    ex_ptr = ex_ids = None
    if exclude is not None and len(exclude[0]):
        ex_ptr, ex_ids = exclusion_csr(exclude, rows, n, dev)
    chunk = max(1, int(block))
    n_chunks = -(-n // chunk)
    part_v = torch.empty(rows, n_chunks, k, dtype=torch.float32, device=dev)
    part_i = torch.empty(rows, n_chunks, k, dtype=torch.int32, device=dev)
    out_v = torch.empty(rows, k, dtype=torch.float32, device=dev)
    out_i = torch.empty(rows, k, dtype=torch.int32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    status = launch(
        u.data_ptr(), items.data_ptr(), ptr(scale), ptr(mask), ptr(ex_ptr),
        ptr(ex_ids), rows, n, d, k, chunk, int(quantized),
        part_v.data_ptr(), part_i.data_ptr(), out_v.data_ptr(),
        out_i.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    platform.check(status, _NAME)
    fused_topk.launches += 1
    return out_v, out_i


fused_topk.launches = 0
