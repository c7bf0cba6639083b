"""Gradient compression for the data-parallel all-reduce (port of
``repro.training.compress``).

  * "bf16": cast to bfloat16 around the mean-reduce (half the volume);
  * "int8": a per-tensor scale and int8 codes (a quarter). The
    round trip (:func:`compress_decompress`) rounds stochastically, so
    it is unbiased (QSGD-style); the synchronised mean
    (:func:`mean_grads_compressed`) rounds to nearest, sums the codes in
    int32 and scales the sum by the calling rank's own scale, as the
    reference does (ROADMAP Queue 3 keeps both behaviours).

Gradients are a dict of tensors, processed leaf by leaf in sorted-key
order (the reference's pytree order). The reference draws its rounding
bits with ``jax.random.bernoulli``; the port draws them from an explicit
``torch.Generator``, or takes the 0/1 mask ready-made (``up``), so a
caller can feed in another draw. Without a mesh under
:func:`repro_torch.distributed.use_mesh` (or one with no batch axis),
:func:`mean_grads_compressed` is the single-device round trip.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.parallel import axes_group
from repro_torch.distributed.sharding import (batch_axes, current_mesh,
                                              mesh_shape)

__all__ = ["compress_decompress", "mean_grads_compressed"]


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d f32 tensor on ``like``'s device. Dividing by a host scalar
    on CUDA multiplies by its reciprocal (not a division), so every
    divisor here is a device tensor."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _scale(g32: torch.Tensor) -> torch.Tensor:
    """max |g| / 127 + 1e-12, each step rounded to f32."""
    return g32.abs().max() / _f32(127.0, g32) + _f32(1e-12, g32)


def _check(method: str) -> None:
    if method not in ("none", "bf16", "int8"):
        raise ValueError(f"unknown compression {method!r}")


def compress_decompress(grads: Dict[str, torch.Tensor], method: str,
                        generator: Optional[torch.Generator] = None,
                        up: Optional[Dict[str, torch.Tensor]] = None):
    """Round-trip each gradient through the compressed representation
    (what the other side of the all-reduce would see).

    int8: q = clip(floor(g/s) + up, -127, 127) with ``up`` ~
    Bernoulli(g/s - floor(g/s)), drawn as ``rand < p`` from
    ``generator`` (on the gradient's device; the default generator when
    None), or given per leaf in ``up`` (0/1 or bool, the leaf's shape).
    """
    _check(method)
    if method == "none":
        return grads
    if method == "bf16":
        return {k: g.to(torch.bfloat16).to(g.dtype) for k, g in grads.items()}
    out = {}
    for k in sorted(grads):
        g = grads[k]
        g32 = g.float()
        s = _scale(g32)
        scaled = g32 / s
        low = torch.floor(scaled)
        p_up = scaled - low
        if up is None:
            bits = torch.rand(p_up.shape, generator=generator,
                              device=p_up.device) < p_up
        else:
            bits = up[k].to(device=p_up.device, dtype=torch.bool)
        q = torch.clamp(low + bits.float(), -127, 127).to(torch.int8)
        out[k] = (q.float() * s).to(g.dtype)
    return out


def mean_grads_compressed(grads: Dict[str, torch.Tensor], method: str = "bf16",
                          generator: Optional[torch.Generator] = None,
                          up: Optional[Dict[str, torch.Tensor]] = None):
    """The data-parallel gradient mean with a compressed payload.

    Under a mesh with batch axes (("pod",) "data": n ranks): bf16, a mean
    in bfloat16 (all-reduce SUM of the bf16 tensors over those axes,
    divided by n in bf16); int8, round-to-nearest codes at this rank's
    scale, an int32 all-reduce SUM, then ``* scale / n``. Without one:
    :func:`compress_decompress`.
    """
    _check(method)
    mesh = current_mesh()
    if mesh is None or not batch_axes(mesh):
        return compress_decompress(grads, method, generator, up)
    if method == "none":
        return grads
    axes = batch_axes(mesh)
    group = axes_group(mesh, axes)
    n = int(np.prod([mesh_shape(mesh)[a] for a in axes]))
    out = {}
    for k in sorted(grads):
        g = grads[k]
        if method == "bf16":
            x = g.to(torch.bfloat16, copy=True)
            dist.all_reduce(x, group=group)
            out[k] = (x / _f32(n, x).to(torch.bfloat16)).to(g.dtype)
        else:
            g32 = g.float()
            s = _scale(g32)
            total = torch.round(g32 / s).to(torch.int8).to(torch.int32)
            dist.all_reduce(total, group=group)
            out[k] = (total.float() * s / _f32(n, g32)).to(g.dtype)
    return out
