"""Codebook lookup kernel: out[b] = Σ_h Z[idx[b, h]] (``csrc/codebook_lookup.cu``).

Replaces ``repro/kernels/codebook_lookup.py::codebook_lookup_pallas``.
On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs the plain version, ``ref.codebook_lookup``, which the
kernel equals bit for bit. f32 codebooks go to ``codebook_lookup_launch``,
bf16 and f16 ones (the LM token embedding) to ``codebook_lookup16_launch``;
the output has the codebook's dtype. ``codebook_lookup.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import platform, ref

__all__ = ["codebook_lookup"]

_NAME = "codebook_lookup"


_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
         ctypes.c_int, ctypes.c_int, ctypes.c_int]


@functools.cache
def _entry(wide: bool):
    """The C entry point of f32 (``wide``) or 16-bit codebooks, bound once
    per process."""
    lib = platform.load(_NAME)
    if wide:
        fn = lib.codebook_lookup_launch
        fn.argtypes = _ARGS + [ctypes.c_void_p]
    else:
        fn = lib.codebook_lookup16_launch
        fn.argtypes = _ARGS + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def codebook_lookup(codebook: torch.Tensor, idx: torch.Tensor, *,
                    binary: bool = False) -> torch.Tensor:
    """codebook f32, bf16 or f16 [K, d], idx int32 [B, H] -> [B, d] in the
    codebook's dtype (16-bit sums round each partial sum to the dtype,
    as the plain version's ``out + rows`` does).

    ``binary``: a repeated index within a row counts once (first
    occurrence wins). Indices must lie in [0, K); the kernel does not
    check them.
    """
    if codebook.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"codebook [K, d] and idx [B, H] expected, got "
                         f"{tuple(codebook.shape)} and {tuple(idx.shape)}")
    if codebook.device.type == "cpu":
        return ref.codebook_lookup(codebook, idx, binary=binary)
    if codebook.device.type != "cuda" or idx.device != codebook.device:
        raise ValueError(f"codebook_lookup needs codebook and idx on one "
                         f"CUDA device, got {codebook.device} and "
                         f"{idx.device}")
    if codebook.dtype not in platform.DTYPES or idx.dtype != torch.int32:
        raise TypeError(f"codebook_lookup takes an f32, bf16 or f16 codebook "
                        f"and int32 idx, got {codebook.dtype} and "
                        f"{idx.dtype}")
    codebook = codebook.contiguous()
    idx = idx.contiguous()
    rows, n_hot = idx.shape
    out = torch.empty(rows, codebook.shape[1], dtype=codebook.dtype,
                      device=codebook.device)
    args = (codebook.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, n_hot,
            codebook.shape[1], int(bool(binary)))
    stream = torch.cuda.current_stream(codebook.device).cuda_stream
    if codebook.dtype == torch.float32:
        status = _entry(True)(*args, stream)
    else:
        status = _entry(False)(*args, platform.DTYPES[codebook.dtype],
                               stream)
    platform.check(status, _NAME)
    codebook_lookup.launches += 1
    return out


codebook_lookup.launches = 0
