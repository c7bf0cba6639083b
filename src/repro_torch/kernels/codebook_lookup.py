"""Codebook lookup kernel: out[b] = Σ_h Z[idx[b, h]] (``csrc/codebook_lookup.cu``).

Replaces ``repro/kernels/codebook_lookup.py::codebook_lookup_pallas``.
On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs the plain version, ``ref.codebook_lookup``, which the
kernel equals bit for bit. ``codebook_lookup.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import platform, ref

__all__ = ["codebook_lookup"]

_NAME = "codebook_lookup"


def _entry():
    fn = platform.load(_NAME).codebook_lookup_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    return fn


def codebook_lookup(codebook: torch.Tensor, idx: torch.Tensor, *,
                    binary: bool = False) -> torch.Tensor:
    """codebook f32 [K, d], idx int32 [B, H] -> f32 [B, d].

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
    if codebook.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"codebook_lookup takes f32 codebook and int32 idx, "
                        f"got {codebook.dtype} and {idx.dtype}")
    codebook = codebook.contiguous()
    idx = idx.contiguous()
    rows, n_hot = idx.shape
    out = torch.empty(rows, codebook.shape[1], dtype=torch.float32,
                      device=codebook.device)
    status = _entry()(codebook.data_ptr(), idx.data_ptr(), out.data_ptr(),
                      rows, n_hot, codebook.shape[1], int(bool(binary)),
                      torch.cuda.current_stream(codebook.device).cuda_stream)
    platform.check(status, _NAME)
    codebook_lookup.launches += 1
    return out


codebook_lookup.launches = 0
