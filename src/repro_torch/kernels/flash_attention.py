"""Blocked online-softmax attention kernel (``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention.py::flash_attention_pallas``
(forward only): softmax(q·kᵀ·scale + causal fill)·v with an f32 softmax,
without the [Sq, Skv] score matrix. On a CUDA tensor the wrapper
launches one of the kernel's two routes (or raises); on a CPU tensor it
runs the plain version, ``ref.flash_attention``.

The route follows from dtype and d before the launch (:func:`route`):
bf16 or f16 inputs with d <= 128 run on the tensor cores (``wgmma``
on the 16-bit values, f32 accumulation, P split in two 16-bit halves);
f32 inputs, and 16-bit inputs with 128 < d <= 256, run on the CUDA cores
in f32. ``flash_attention.launches`` counts launches of both routes,
``launches_tc`` and ``launches_cc`` each route's own. On meta tensors it
returns the output's shape; under a ``launch.op_analysis`` count the call
is counted once at its ``cost.flash_attention``.
"""
from __future__ import annotations

import ctypes

import torch

from . import cost, platform, ref

__all__ = ["flash_attention", "route"]

_NAME = "flash_attention"
_MAX_DIM = 256                  # the largest of the kernel's d instances
_TC_DTYPES = (torch.bfloat16, torch.float16)
_TC_MAX_DIM = 128               # the tensor-core route's largest instance


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel route that q of ``dtype`` and head width ``d`` take on
    the card: "tc" (tensor cores) or "cc" (CUDA cores, f32)."""
    return "tc" if dtype in _TC_DTYPES and d <= _TC_MAX_DIM else "cc"


def _launch(which: str):
    lib = platform.load(_NAME)
    fn = (lib.flash_attention_tc_launch if which == "tc"
          else lib.flash_attention_launch)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64]
                   + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p])
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q [B, H, Sq, d], k/v [B, H, Skv, d], all f32, all bf16 or all f16
    -> [B, H, Sq, d] in q's dtype. Scale ``ref.attention_scale(d)``;
    causal masks key positions after the query position (top-left
    aligned). On the card d <= 256."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q [B, H, Sq, d] and k, v [B, H, Skv, d] expected, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if cost.observer is not None:
        return cost.observe(_NAME, cost.flash_attention(q, k, v,
                                                        causal=causal),
                            flash_attention, q, k, v, causal=causal)
    if q.device.type == "cpu" and k.device == q.device == v.device:
        return ref.flash_attention(q, k, v, causal=causal)
    if q.device.type == "meta" and k.device == q.device == v.device:
        return torch.empty_like(q)
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError(f"flash_attention needs q, k, v on one CUDA device, "
                         f"got {q.device}, {k.device}, {v.device}")
    if q.dtype not in platform.DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes q, k, v all f32, all bf16 or "
                        f"all f16, got {q.dtype}, {k.dtype}, {v.dtype}")
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if d > _MAX_DIM:
        raise ValueError(f"flash_attention: d={d} exceeds the kernel's "
                         f"{_MAX_DIM}")
    which = route(q.dtype, d)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    status = _launch(which)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, sq,
        skv, d, int(bool(causal)), ref.attention_scale(d),
        platform.DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    platform.check(status, _NAME)
    flash_attention.launches += 1
    if which == "tc":
        flash_attention.launches_tc += 1
    else:
        flash_attention.launches_cc += 1
    return out


flash_attention.launches = 0
flash_attention.launches_tc = 0
flash_attention.launches_cc = 0
