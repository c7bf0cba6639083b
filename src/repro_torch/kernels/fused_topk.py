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
``fused_topk_codebook.launches`` count kernel launches. On meta tensors a
wrapper returns the result's shapes; under a ``launch.op_analysis`` count
each call is counted once at its ``cost`` function.
"""
from __future__ import annotations

import ctypes
import weakref

import torch

from . import cost, platform, ref

__all__ = ["fused_topk", "fused_topk_codebook", "exclusion_csr",
           "plan_chunk", "shares_bounds"]

_NAME = "fused_topk"
_MIN_CHUNK = 256
# list slots of a row's chunks at most (chunks x 32 x lane_keys(k)): one
# block merges a row's chunk lists, so a batch of a few rows waits on it
# at k 65-128 (``tools/fused_topk_parity.py`` times the chunk sizes)
_MERGE_SLOTS = 16384
# rows x keys a lane from which a call's chunks share the rows' bounds
# (see :func:`shares_bounds`)
_SHARE_WORK = 256
_MAX_GRID_Y = 65535
_ENTRIES: dict = {}             # the loaded library's caps and entry points
# (device index, d, codebook, quantized, keys a lane) -> (rows per block,
# items per tile, score blocks the card holds at once)
_TILING: dict = {}


def _entries() -> dict:
    """{"max_k", "max_dim", "dense", "codebook", "tiling"} of the build of ``csrc/fused_topk.cu``, loaded on first use: its caps
    (compile-time constants of the source) and its C entry points."""
    if not _ENTRIES:
        lib = platform.load(_NAME)
        dense = lib.fused_topk_launch
        dense.restype = ctypes.c_int
        dense.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                          + [ctypes.c_void_p] * 6)
        codebook = lib.fused_topk_codebook_launch
        codebook.restype = ctypes.c_int
        codebook.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int]
                             + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                             + [ctypes.c_void_p] * 6)
        tiling = lib.fused_topk_tiling
        tiling.restype = ctypes.c_int
        tiling.argtypes = ([ctypes.c_int] * 4
                           + [ctypes.POINTER(ctypes.c_int)] * 3)
        _ENTRIES.update(max_k=lib.fused_topk_max_k(),
                        max_dim=lib.fused_topk_max_dim(), dense=dense,
                        codebook=codebook, tiling=tiling)
    return _ENTRIES


def lane_keys(k: int) -> int:
    """The keys each lane of the kernel's warp-wide sorted list holds for
    a top-k of ``k``: 1, 2 or 4 (a list of 32, 64 or 128 keys), as
    ``csrc/fused_topk.cu::lane_keys`` picks its instance."""
    return 1 if k <= 32 else (2 if k <= 64 else 4)


def _tiling(dev, d: int, codebook: bool, quantized: bool, k: int) -> tuple:
    """(query rows per block, items per tile, score blocks the card holds
    at once) of the kernel instance for this call, as the build reports
    them (its tiling, and its occupancy at width d and top-k size k times
    the card's multiprocessors); asked once per device, d, loader and
    list size (:func:`lane_keys`)."""
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    r = lane_keys(int(k))
    key = (i, int(d), bool(codebook), bool(quantized), r)
    if key not in _TILING:
        out = [ctypes.c_int() for _ in range(3)]
        with torch.cuda.device(i):
            platform.check(_entries()["tiling"](
                *key[1:4], 32 * r, *map(ctypes.byref, out)), _NAME)
        sms = torch.cuda.get_device_properties(i).multi_processor_count
        _TILING[key] = (out[0].value, out[1].value, out[2].value * sms)
    return _TILING[key]


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


def shares_bounds(rows: int, k: int) -> bool:
    """Whether a call of ``rows`` query rows at top-``k`` passes the
    kernel its bounds scratch, so that a row's chunks share a lower bound
    on its k-th key (lists of 64 and 128 keys, k 33-128; see the head of
    ``csrc/fused_topk.cu``). Only where rows x :func:`lane_keys` reaches
    ``_SHARE_WORK``: for fewer rows the scratch's memset and each block's
    trips to L2 for the bound cost more than the merges it saves
    (``tools/fused_topk_parity.py`` times both settings)."""
    r = lane_keys(int(k))
    return r > 1 and int(rows) * r >= _SHARE_WORK


def plan_chunk(rows: int, n: int, *, rows_per_block: int,
               items_per_tile: int, slots: int, block=None,
               k: int = 1) -> int:
    """Items one thread block scores (its chunk). ``block``, when given,
    is the caller's choice. Otherwise the chunks are sized so that the
    grid (chunks x groups of ``rows_per_block`` rows) fills the ``slots``
    blocks the card holds at once without passing them (a block more
    would wait for a second wave, nearly doubling the call: 136 blocks
    on 132 slots at B 512, k 100), in whole tiles of ``items_per_tile``
    and at least 256 items: small batches spread over the card, and large
    ones keep few chunk lists to merge. A row's chunk lists hold at most
    ``_MERGE_SLOTS`` list slots at top-``k`` (32 x :func:`lane_keys`
    slots a chunk: fewer, larger chunks at k 65-128 when the batch is
    small). Where the groups alone pass the slots, each group takes one
    chunk. An empty batch (``rows`` 0) is planned as one group; its call
    launches nothing."""
    if block is not None:
        return max(1, int(block))
    groups = max(1, -(-int(rows) // rows_per_block))
    want = max(1, min(int(slots) // groups,
                      _MERGE_SLOTS // (32 * lane_keys(max(1, int(k))))))
    chunk = -(-int(n) // want)
    chunk = -(-chunk // items_per_tile) * items_per_tile
    return max(_MIN_CHUNK, chunk)


def _check(u, items, k, n, scale, mask, scale_rows):
    """Validate a CUDA call."""
    dev = u.device
    if dev.type != "cuda" or items.device != dev:
        raise ValueError(f"fused_topk needs u and items on one CUDA device, "
                         f"got {u.device} and {items.device}")
    lib = _entries()
    max_k, max_dim = lib["max_k"], lib["max_dim"]
    d = u.shape[1]
    if not 1 <= k <= max_k:
        raise ValueError(f"fused_topk takes 1 <= k <= {max_k}, got k={k}")
    if d > max_dim:
        raise ValueError(f"fused_topk takes d <= {max_dim}, got d={d}")
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


def _run(variant, lead, u, k, n, scale, mask, exclude, block):
    """Plan the chunks, allocate the outputs and the chunk scratch, launch
    the ``variant`` ("dense" or "codebook") entry point, check. ``lead``
    are the variant's item arguments that come after ``u`` in it."""
    dev = u.device
    rows, d = u.shape
    per_block, per_tile, slots = _tiling(dev, d, variant == "codebook",
                                         scale is not None, k)
    if rows > _MAX_GRID_Y * per_block:
        raise ValueError(f"fused_topk takes at most {_MAX_GRID_Y * per_block}"
                         f" rows, got {rows}")
    ex_ptr = ex_ids = None
    if exclude is not None and len(exclude[0]):
        ex_ptr, ex_ids = exclusion_csr(exclude, rows, n, dev)
    chunk = plan_chunk(rows, n, rows_per_block=per_block,
                       items_per_tile=per_tile, slots=slots, block=block,
                       k=k)
    n_chunks = -(-n // chunk)
    part_v = torch.empty(rows, n_chunks, k, dtype=torch.float32, device=dev)
    part_i = torch.empty(rows, n_chunks, k, dtype=torch.int32, device=dev)
    bounds = (torch.empty(rows * n_chunks, dtype=torch.int64, device=dev)
              if shares_bounds(rows, k) else None)
    out_v = torch.empty(rows, k, dtype=torch.float32, device=dev)
    out_i = torch.empty(rows, k, dtype=torch.int32, device=dev)
    args = [u.contiguous(), *lead,
            None if mask is None else mask.contiguous(), ex_ptr, ex_ids]

    def arg(a):
        return a.data_ptr() if isinstance(a, torch.Tensor) else a

    status = _entries()[variant](
        *map(arg, args), rows, n, d, k, chunk,
        int(scale is not None), part_v.data_ptr(), part_i.data_ptr(),
        arg(bounds), out_v.data_ptr(), out_i.data_ptr(),
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


def _on_meta(*tensors) -> bool:
    """Every tensor given (None skipped) on the meta device."""
    return all(t.device.type == "meta" for t in tensors if t is not None)


def _empty(u, k, rows: int = 0):
    """Uninitialized values f32 [rows, k] and ids int32 [rows, k]: the
    result of an empty batch (rows 0), as the plain version gives it, and
    the result's shape on meta tensors; no kernel is launched."""
    return (torch.empty(rows, k, dtype=torch.float32, device=u.device),
            torch.empty(rows, k, dtype=torch.int32, device=u.device))


def _shapes(u, items, k, n):
    if u.dim() != 2 or items.dim() != 2 or u.shape[1] != items.shape[1]:
        raise ValueError(f"u [B, d] and items [N, d] expected, got "
                         f"{tuple(u.shape)} and {tuple(items.shape)}")
    if k > n:
        raise ValueError(f"k={k} exceeds n_items={n}")


def fused_topk(u: torch.Tensor, items: torch.Tensor, k: int, *, sketch=None,
               scale=None, mask=None, exclude=None, block=None):
    """``top-k(u @ items.T + mask)`` -> (values f32 [B, k], ids int32 [B, k]).

    u f32 [B, d]; items f32 [N, d], or int8 with ``scale`` f32 [N]
    (dequantized in the kernel); ``mask`` f32 [N] is added to every row;
    ``exclude`` is a (rows, cols) pair of int arrays whose items score
    -inf in those rows (and remain candidates). ``block`` is the number
    of items one thread block scores before its partial top-k is merged
    (default: :func:`plan_chunk`'s choice for the batch and the card).
    k must not exceed N nor the kernel's cap (128); d must not exceed
    256.
    With ``sketch`` int32 [N, H], ``items`` is a codebook and the call
    goes to :func:`fused_topk_codebook`.
    """
    if sketch is not None:
        return fused_topk_codebook(u, items, sketch, k, scale=scale,
                                   mask=mask, exclude=exclude, block=block)
    k = int(k)
    n = int(items.shape[0])
    _shapes(u, items, k, n)
    if cost.observer is not None:
        return cost.observe(_NAME, cost.fused_topk(u, items, k, scale=scale,
                                                   mask=mask),
                            fused_topk, u, items, k, scale=scale, mask=mask,
                            exclude=exclude, block=block)
    if u.device.type == "cpu":
        return ref.fused_topk(u, items, k, scale=scale, mask=mask,
                              exclude=exclude)
    if _on_meta(u, items, scale, mask):
        return _empty(u, k, u.shape[0])
    _check(u, items, k, n, scale, mask, n)
    if u.shape[0] == 0:
        return _empty(u, k)
    lead = (items.contiguous(),
            None if scale is None else scale.contiguous())
    out = _run("dense", lead, u, k, n, scale, mask, exclude, block)
    fused_topk.launches += 1
    return out


fused_topk.launches = 0


def fused_topk_codebook(u: torch.Tensor, codebook: torch.Tensor,
                        sketch: torch.Tensor, k: int, *, scale=None,
                        mask=None, exclude=None, block=None):
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
    if cost.observer is not None:
        return cost.observe("fused_topk_codebook", cost.fused_topk_codebook(
            u, codebook, sketch, k, scale=scale, mask=mask),
            fused_topk_codebook, u, codebook, sketch, k, scale=scale,
            mask=mask, exclude=exclude, block=block)
    if u.device.type == "cpu":
        return ref.fused_topk(u, codebook, k, sketch=sketch, scale=scale,
                              mask=mask, exclude=exclude)
    if _on_meta(u, codebook, sketch, scale, mask):
        return _empty(u, k, u.shape[0])
    _check(u, codebook, k, n, scale, mask, int(codebook.shape[0]))
    if sketch.device != u.device or sketch.dtype != torch.int32:
        raise TypeError(f"sketch must be int32 on {u.device}, got "
                        f"{sketch.dtype} on {sketch.device}")
    _check_sketch(sketch, int(codebook.shape[0]))
    if u.shape[0] == 0:
        return _empty(u, k)
    lead = (codebook.contiguous(),
            None if scale is None else scale.contiguous(),
            sketch.contiguous(), int(sketch.shape[1]))
    out = _run("codebook", lead, u, k, n, scale, mask, exclude, block)
    fused_topk_codebook.launches += 1
    return out


fused_topk_codebook.launches = 0
