"""Fused score -> top-k kernel (``csrc/fused_topk.cu``), two variants.

  * :func:`fused_topk` replaces ``repro/kernels/fused_topk.py::
    fused_topk_pallas``: the top-k of ``u @ items.T + mask`` per row.
  * :func:`fused_topk_codebook` replaces ``fused_topk_codebook_pallas``:
    the items are implicit, ``v_i = Σ_h dedup(Z[sketch[i, h]])``, and the
    expanded item table never exists.

Both give ``lax.top_k``'s order (highest value first, lowest id among
equals, NaN first) without the [B, N] score matrix. On a CUDA tensor a
wrapper launches its kernel (or raises); on a CPU tensor it runs the
plain version, ``ref.fused_topk``. ``fused_topk.launches`` and
``fused_topk_codebook.launches`` count kernel launches.
"""
from __future__ import annotations

import ctypes
import weakref

import torch

from . import platform, ref

__all__ = ["fused_topk", "fused_topk_codebook", "exclusion_csr"]

_NAME = "fused_topk"
_MAX_ROWS = 65535 * 8           # grid.y = ceil(rows / 8) <= 65535


def _lib():
    """(library, k cap, d cap); the caps are compile-time constants of
    the kernel source."""
    lib = platform.load(_NAME)
    return lib, lib.fused_topk_max_k(), lib.fused_topk_max_dim()


def _dense_entry(lib):
    fn = lib.fused_topk_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] * 5)
    return fn


def _codebook_entry(lib):
    fn = lib.fused_topk_codebook_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] * 5)
    return fn


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


def _check(u, items, k, n, scale, mask, scale_rows):
    """Validate a CUDA call; returns the loaded library."""
    dev = u.device
    if dev.type != "cuda" or items.device != dev:
        raise ValueError(f"fused_topk needs u and items on one CUDA device, "
                         f"got {u.device} and {items.device}")
    lib, max_k, max_dim = _lib()
    rows, d = u.shape
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
    for name, t, size in (("scale", scale, scale_rows), ("mask", mask, n)):
        if t is not None and (t.device != dev or t.dtype != torch.float32
                              or tuple(t.shape) != (size,)):
            raise ValueError(f"{name} must be f32 [{size}] on {dev}")
    return lib


def _run(launch, lead, u, k, n, scale, mask, exclude, block):
    """Allocate the outputs and the chunk scratch, launch, check.
    ``lead`` are the variant's item arguments (contiguous tensors, None
    or ints) that come after ``u`` in its C entry point."""
    dev = u.device
    rows = u.shape[0]
    ex_ptr = ex_ids = None
    if exclude is not None and len(exclude[0]):
        ex_ptr, ex_ids = exclusion_csr(exclude, rows, n, dev)
    chunk = max(1, int(block))
    n_chunks = -(-n // chunk)
    part_v = torch.empty(rows, n_chunks, k, dtype=torch.float32, device=dev)
    part_i = torch.empty(rows, n_chunks, k, dtype=torch.int32, device=dev)
    out_v = torch.empty(rows, k, dtype=torch.float32, device=dev)
    out_i = torch.empty(rows, k, dtype=torch.int32, device=dev)
    args = [u.contiguous(), *lead,
            None if mask is None else mask.contiguous(), ex_ptr, ex_ids]

    def arg(a):
        return a.data_ptr() if isinstance(a, torch.Tensor) else a

    status = launch(
        *map(arg, args), rows, n, u.shape[1], k, chunk,
        int(scale is not None), part_v.data_ptr(), part_i.data_ptr(),
        out_v.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    platform.check(status, _NAME)
    return out_v, out_i


# id(sketch) -> (weak reference, in-place version, largest entry) of each
# live sketch tensor whose range was checked
_CHECKED_SKETCHES: dict = {}


def _check_sketch(sketch: torch.Tensor, k_rows: int) -> None:
    """Raise unless every entry of ``sketch`` lies in [0, k_rows). A
    sketch is frozen once built, so the scan and its host sync run on a
    tensor's first use and again only after an in-place write to it
    (which bumps ``sketch._version``); later calls compare the cached
    largest entry with ``k_rows``."""
    key = id(sketch)
    seen = _CHECKED_SKETCHES.get(key)
    if (seen is None or seen[0]() is not sketch
            or seen[1] != sketch._version):
        lo, hi = 0, -1
        if sketch.numel():
            lo, hi = torch.stack(torch.aminmax(sketch)).tolist()
        if lo < 0:
            raise ValueError(f"sketch entries must lie in [0, {k_rows})")
        ref_ = weakref.ref(sketch,
                           lambda _, key=key: _CHECKED_SKETCHES.pop(key, None))
        seen = _CHECKED_SKETCHES[key] = (ref_, sketch._version, hi)
    if seen[2] >= k_rows:
        raise ValueError(f"sketch entries must lie in [0, {k_rows})")


def _shapes(u, items, k, n):
    if u.dim() != 2 or items.dim() != 2 or u.shape[1] != items.shape[1]:
        raise ValueError(f"u [B, d] and items [N, d] expected, got "
                         f"{tuple(u.shape)} and {tuple(items.shape)}")
    if k > n:
        raise ValueError(f"k={k} exceeds n_items={n}")


def fused_topk(u: torch.Tensor, items: torch.Tensor, k: int, *, sketch=None,
               scale=None, mask=None, exclude=None, block: int = 1024):
    """``top-k(u @ items.T + mask)`` -> (values f32 [B, k], ids int32 [B, k]).

    u f32 [B, d]; items f32 [N, d], or int8 with ``scale`` f32 [N]
    (dequantized in the kernel); ``mask`` f32 [N] is added to every row;
    ``exclude`` is a (rows, cols) pair of int arrays whose items score
    -inf in those rows (and remain candidates). ``block`` is the number
    of items one thread block scores before its partial top-k is merged.
    k must not exceed N nor the kernel's cap (32); d must not exceed 256.
    With ``sketch`` int32 [N, H], ``items`` is a codebook and the call
    goes to :func:`fused_topk_codebook`.
    """
    if sketch is not None:
        return fused_topk_codebook(u, items, sketch, k, scale=scale,
                                   mask=mask, exclude=exclude, block=block)
    k = int(k)
    n = int(items.shape[0])
    _shapes(u, items, k, n)
    if u.device.type == "cpu":
        return ref.fused_topk(u, items, k, scale=scale, mask=mask,
                              exclude=exclude)
    lib = _check(u, items, k, n, scale, mask, n)
    lead = (items.contiguous(),
            None if scale is None else scale.contiguous())
    out = _run(_dense_entry(lib), lead, u, k, n, scale, mask, exclude,
               block)
    fused_topk.launches += 1
    return out


fused_topk.launches = 0


def fused_topk_codebook(u: torch.Tensor, codebook: torch.Tensor,
                        sketch: torch.Tensor, k: int, *, scale=None,
                        mask=None, exclude=None, block: int = 1024):
    """``top-k(u @ V.T + mask)`` with V [N, d] implicit: item i is
    Σ_h Z[sketch[i, h]] under the binary-Y rule (a repeated index in a
    sketch row counts once), each codebook row dequantized first.

    u f32 [B, d]; codebook f32 [K, d], or int8 with ``scale`` f32 [K]
    (per codebook row); sketch int32 [N, H] with entries in [0, K)
    (checked on a sketch's first use, :func:`_check_sketch`); mask,
    exclude, block, the caps and the
    result as for :func:`fused_topk`. The ragged last chunk is masked in
    the kernel, which never reads past item N - 1.
    """
    k = int(k)
    if sketch.dim() != 2:
        raise ValueError(f"sketch must be [N, H], got {tuple(sketch.shape)}")
    n = int(sketch.shape[0])
    _shapes(u, codebook, k, n)
    if u.device.type == "cpu":
        return ref.fused_topk(u, codebook, k, sketch=sketch, scale=scale,
                              mask=mask, exclude=exclude)
    lib = _check(u, codebook, k, n, scale, mask, int(codebook.shape[0]))
    if sketch.device != u.device or sketch.dtype != torch.int32:
        raise TypeError(f"sketch must be int32 on {u.device}, got "
                        f"{sketch.dtype} on {sketch.device}")
    _check_sketch(sketch, int(codebook.shape[0]))
    lead = (codebook.contiguous(),
            None if scale is None else scale.contiguous(),
            sketch.contiguous(), int(sketch.shape[1]))
    out = _run(_codebook_entry(lib), lead, u, k, n, scale, mask, exclude,
               block)
    fused_topk_codebook.launches += 1
    return out


fused_topk_codebook.launches = 0
