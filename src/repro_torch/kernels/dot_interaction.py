"""DLRM dot-interaction kernel (``csrc/dot_interaction.cu``).

Replaces ``repro/kernels/dot_interaction.py::dot_interaction_pallas``:
per example the strictly-lower triangle of X·Xᵀ, compacted in
``np.tril_indices(F, -1)`` order, without the [B, F, F] tensor. On a
CUDA tensor the wrapper launches the kernel (or raises); on a CPU tensor
it runs the plain version, ``ref.dot_interaction``.
``dot_interaction.launches`` counts kernel launches. On meta tensors it
returns the output's shape; under a ``launch.op_analysis`` count the call
is counted once at its ``cost.dot_interaction``.
"""
from __future__ import annotations

import ctypes

import torch

from . import cost, platform, ref

__all__ = ["dot_interaction", "smem_bytes", "max_smem"]

_NAME = "dot_interaction"
_ENTRIES: dict = {}             # the loaded library's entry points and cap
_SMEM: dict = {}                # (F, d, dtype) -> the plan's shared memory


def _entries() -> dict:
    """{"launch", "smem_bytes", "max_smem"} of the build of
    ``csrc/dot_interaction.cu``, loaded on first use: the launch, the
    shared memory of its plan at (F, d, dtype), and the shared memory a
    block may use (a compile-time constant of the source)."""
    if not _ENTRIES:
        lib = platform.load(_NAME)
        launch = lib.dot_interaction_launch
        launch.restype = ctypes.c_int
        launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]
        smem = lib.dot_interaction_smem_bytes
        smem.restype = ctypes.c_int64
        smem.argtypes = [ctypes.c_int] * 3
        _ENTRIES.update(launch=launch, smem_bytes=smem,
                        max_smem=lib.dot_interaction_max_smem())
    return _ENTRIES


def smem_bytes(f: int, d: int, dtype: torch.dtype) -> int:
    """The shared memory (bytes) of the kernel's launch plan at (F, d,
    dtype), as the build reports it (asked once per shape); above
    :func:`max_smem` when no plan fits."""
    key = (int(f), int(d), dtype)
    if key not in _SMEM:
        _SMEM[key] = int(_entries()["smem_bytes"](key[0], key[1],
                                                  platform.DTYPES[dtype]))
    return _SMEM[key]


def max_smem() -> int:
    """The shared memory (bytes) a block of the build may use."""
    return int(_entries()["max_smem"])


def dot_interaction(x: torch.Tensor) -> torch.Tensor:
    """x [B, F, d] (f32, bf16 or f16) -> [B, F(F-1)/2] in x's dtype; f32
    products and sums, one rounding at the store. On the card, a launch
    plan of the kernel (at least one example's f32 rows) must fit the
    shared memory a block may use, as the build reports them
    (:func:`smem_bytes`, :func:`max_smem`), or it raises ValueError."""
    if x.dim() != 3:
        raise ValueError(f"x [B, F, d] expected, got {tuple(x.shape)}")
    if cost.observer is not None:
        return cost.observe(_NAME, cost.dot_interaction(x), dot_interaction,
                            x)
    if x.device.type == "cpu":
        return ref.dot_interaction(x)
    if x.device.type == "meta":
        b, f, _ = x.shape
        return torch.empty(b, f * (f - 1) // 2, dtype=x.dtype, device="meta")
    if x.device.type != "cuda":
        raise ValueError(f"dot_interaction needs a CUDA or CPU tensor, got "
                         f"{x.device}")
    if x.dtype not in platform.DTYPES:
        raise TypeError(f"dot_interaction takes f32, bf16 or f16, got "
                        f"{x.dtype}")
    b, f, d = x.shape
    need, cap = smem_bytes(f, d, x.dtype), max_smem()
    if need > cap:
        raise ValueError(f"dot_interaction: no launch plan fits (F={f}, "
                         f"d={d}: {need} bytes) in the {cap} bytes of shared "
                         f"memory a block may use")
    x = x.contiguous()
    out = torch.empty(b, f * (f - 1) // 2, dtype=x.dtype, device=x.device)
    status = _entries()["launch"](
        x.data_ptr(), out.data_ptr(), b, f, d, platform.DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    platform.check(status, _NAME)
    dot_interaction.launches += 1
    return out


dot_interaction.launches = 0
