"""DLRM dot-interaction kernel (``csrc/dot_interaction.cu``).

Replaces ``repro/kernels/dot_interaction.py::dot_interaction_pallas``:
per example the strictly-lower triangle of X·Xᵀ, compacted in
``np.tril_indices(F, -1)`` order, without the [B, F, F] tensor. On a
CUDA tensor the wrapper launches the kernel (or raises); on a CPU tensor
it runs the plain version, ``ref.dot_interaction``.
``dot_interaction.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import platform, ref

__all__ = ["dot_interaction"]

_NAME = "dot_interaction"
_MAX_SMEM = 232448              # 227 KB, the shared memory a block may use


def _launch():
    fn = platform.load(_NAME).dot_interaction_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn


def dot_interaction(x: torch.Tensor) -> torch.Tensor:
    """x [B, F, d] (f32, bf16 or f16) -> [B, F(F-1)/2] in x's dtype; f32
    products and sums, one rounding at the store. On the card, one
    example's f32 tile (F x (d + 1) floats) must fit the shared memory a
    block may use (227 KB), or it raises ValueError."""
    if x.dim() != 3:
        raise ValueError(f"x [B, F, d] expected, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return ref.dot_interaction(x)
    if x.device.type != "cuda":
        raise ValueError(f"dot_interaction needs a CUDA or CPU tensor, got "
                         f"{x.device}")
    if x.dtype not in platform.DTYPES:
        raise TypeError(f"dot_interaction takes f32, bf16 or f16, got "
                        f"{x.dtype}")
    b, f, d = x.shape
    if f * (d + 1) * 4 > _MAX_SMEM:
        raise ValueError(f"dot_interaction: one example's tile (F={f}, d={d}: "
                         f"{f * (d + 1) * 4} bytes) exceeds the {_MAX_SMEM} "
                         f"bytes of shared memory a block may use")
    x = x.contiguous()
    out = torch.empty(b, f * (f - 1) // 2, dtype=x.dtype, device=x.device)
    status = _launch()(x.data_ptr(), out.data_ptr(), b, f, d,
                       platform.DTYPES[x.dtype],
                       torch.cuda.current_stream(x.device).cuda_stream)
    platform.check(status, _NAME)
    dot_interaction.launches += 1
    return out


dot_interaction.launches = 0
