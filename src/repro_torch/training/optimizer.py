"""Optimizers over dicts of tensors: SGD, AdamW and Adafactor (port of
``repro.training.optimizer``).

Each optimizer is an ``Optimizer(init, update)`` pair, as in the
reference, with the reference's state layout (AdamW:
``{"step", "m": {...}, "v": {...}}``; Adafactor: ``{"step", "fac":
[...]}``, one entry per parameter in sorted-key order), so a checkpoint
of either package restores into the other. ``update(grads, state,
params)`` updates ``params`` and ``state`` IN PLACE under
``torch.no_grad()`` (the reference returns new trees; the port reuses the
buffers) and returns them. Math is in f32 whatever the parameters'
dtype, as in the reference; ``state["step"]`` is an int32 scalar tensor
on the parameters' device, so an update never waits on the host.

Over a mesh each rank updates its blocks of the params and state:
AdamW's update is elementwise (its clip takes the mesh's ``norm``);
Adafactor's ``reduce`` names, a param, the process groups that split
the dims its means run over, and each mean becomes a partial sum and
an all-reduce over that group (on one rank, or with no group, the mean
itself, so the update is the one-card update to the bit).

Memory: the gradient clip scales one leaf at a time (never a scaled copy
of every gradient), and AdamW's elementwise update runs over flat slices
of ``_SLICE`` elements, so its f32 temporaries stay at 256 MB each
whatever the leaf (dbrx-132b's expert weights hold 1.06e9 elements a
leaf). Every element gets the same operations in the same order, so the
result is the same to the bit.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping, NamedTuple, Optional, Tuple

import torch

__all__ = ["adamw", "adafactor", "sgd", "Optimizer", "global_norm",
           "FactorGroups"]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]  # (g, state, p)


def _leaves(tree: dict):
    """The (key, tensor) leaves of a dict of tensors, in sorted-key order
    (``jax.tree.flatten``'s order for dicts)."""
    return [(k, tree[k]) for k in sorted(tree)]


# elements of a leaf AdamW updates at a time (256 MB f32 temporaries)
_SLICE = 1 << 26


def global_norm(grads: dict) -> torch.Tensor:
    """sqrt(Σ_leaves Σ g²) in f32; each leaf's f32 copy is squared in
    place (one f32 temporary a leaf, not two)."""
    return torch.sqrt(sum(
        torch.sum(g.to(torch.float32, copy=True).square_())
        for _, g in _leaves(grads)))


def _clip_scale(grads: dict, grad_clip: Optional[float], norm=None):
    """The global-norm clip's scale (an f32 scalar tensor), or None: the
    caller multiplies each gradient by it as it reads the gradient.
    ``norm``: the norm function (default :func:`global_norm`)."""
    if grad_clip is None:
        return None
    gn = (norm or global_norm)(grads)
    return torch.clamp(grad_clip / torch.clamp(gn, min=1e-9), max=1.0)


def _clipped(g: torch.Tensor, scale) -> torch.Tensor:
    """``g * scale`` (the clip), or g."""
    return g if scale is None else g * scale


def _slices(*ts):
    """Same-shaped tensors as matching flat slices of at most ``_SLICE``
    elements (views: writes reach the tensors), or whole when they fit
    one slice or one is not contiguous. (A 0-dim leaf stays 0-dim: a
    0-dim bf16 gradient times the f32 clip scale promotes to f32, a
    1-element slice of it would not.)"""
    if ts[0].numel() <= _SLICE or not all(t.is_contiguous() for t in ts):
        yield ts
        return
    flat = [t.view(-1) for t in ts]
    for s in range(0, flat[0].numel(), _SLICE):
        yield tuple(f[s:s + _SLICE] for f in flat)


def _step(params: dict) -> torch.Tensor:
    """The int32 step counter, on the parameters' device."""
    device = next(iter(params.values())).device if params else None
    return torch.zeros((), dtype=torch.int32, device=device)


def sgd(lr: float = 1e-2) -> Optimizer:
    def init(params):
        return {"step": _step(params)}

    @torch.no_grad()
    def update(grads, state, params):
        for k, p in _leaves(params):
            p.copy_((p.float() - lr * grads[k].float()).to(p.dtype))
        state["step"].add_(1)
        return params, state

    return Optimizer(init, update)


def adamw(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0,
          grad_clip: Optional[float] = None,
          norm: Optional[Callable] = None) -> Optimizer:
    """AdamW; ``grad_clip`` clips by the global norm, ``norm(grads)`` where
    the gradients are blocks of a sharded model (the mesh's norm)."""
    def init(params):
        z = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
        return {"step": _step(params),
                "m": {k: z(p) for k, p in params.items()},
                "v": {k: z(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(grads, state, params):
        state["step"].add_(1)
        scale = _clip_scale(grads, grad_clip, norm)
        t = state["step"].float()
        bc1 = 1 - torch.pow(b1, t)
        bc2 = 1 - torch.pow(b2, t)
        for k, p in _leaves(params):
            for ps, gs, m, v in _slices(p, grads[k], state["m"][k],
                                        state["v"][k]):
                g32 = _clipped(gs, scale).float()
                m.copy_(b1 * m + (1 - b1) * g32)
                v.copy_(b2 * v + (1 - b2) * torch.square(g32))
                delta = lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps)
                              + weight_decay * ps.float())
                ps.copy_((ps.float() - delta).to(ps.dtype))
        return params, state

    return Optimizer(init, update)


class FactorGroups(NamedTuple):
    """The groups splitting a param's last dim, its second-to-last dim,
    and any of its dims (None: whole on this rank)."""
    last: Any = None
    second: Any = None
    every: Any = None


def _mean(x: torch.Tensor, dim, group, keepdim: bool = False):
    """``x.mean(dim)`` of a tensor whose ``dim`` (None: every dim) is
    split over ``group``: the partial sum, all-reduced, over the whole
    count; ``x.mean`` itself where the group is None or of one rank."""
    from repro_torch.distributed import parallel as par

    n = par.group_size(group)
    if n == 1:
        return x.mean() if dim is None else x.mean(dim=dim, keepdim=keepdim)
    if dim is None:
        s, count = x.sum(), x.numel() * n
    else:
        s, count = x.sum(dim=dim, keepdim=keepdim), x.shape[dim] * n
    return par.all_reduce(s, group) / count


def adafactor(lr: float = 1e-2, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0,
              grad_clip: Optional[float] = None, norm=None,
              reduce: Optional[Mapping[str, FactorGroups]] = None
              ) -> Optimizer:
    """Factored second moment: O(n+m) state per n x m matrix. On a mesh,
    ``reduce[key]`` (:class:`FactorGroups`) gives the groups over which
    a param's row means, column means and update RMS sum its blocks;
    ``norm`` the mesh's norm for ``grad_clip``."""
    none = FactorGroups()

    def init(params):
        fac = []
        for _, p in _leaves(params):
            if p.dim() >= 2:
                fac.append({"vr": torch.zeros(p.shape[:-1],
                                              dtype=torch.float32,
                                              device=p.device),
                            "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                              dtype=torch.float32,
                                              device=p.device)})
            else:
                fac.append({"v": torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device)})
        return {"step": _step(params), "fac": fac}

    @torch.no_grad()
    def update(grads, state, params):
        state["step"].add_(1)
        scale = _clip_scale(grads, grad_clip, norm)
        t = state["step"].float()
        beta = 1.0 - torch.pow(t, -decay)
        for (k, p), s in zip(_leaves(params), state["fac"]):
            grp = none if reduce is None else reduce.get(k, none)
            g32 = _clipped(grads[k], scale).float()
            g2 = torch.square(g32) + eps
            if p.dim() >= 2:
                s["vr"].copy_(beta * s["vr"]
                              + (1 - beta) * _mean(g2, -1, grp.last))
                s["vc"].copy_(beta * s["vc"]
                              + (1 - beta) * _mean(g2, -2, grp.second))
                r = s["vr"] / torch.clamp(
                    _mean(s["vr"], -1, grp.second, keepdim=True), min=eps)
                u = (g32 * torch.rsqrt(r)[..., None]
                     * torch.rsqrt(s["vc"])[..., None, :])
            else:
                s["v"].copy_(beta * s["v"] + (1 - beta) * g2)
                u = g32 * torch.rsqrt(s["v"])
            rms = torch.sqrt(_mean(torch.square(u), None, grp.every) + 1e-30)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            p.copy_((p.float() - lr * u).to(p.dtype))
        return params, state

    return Optimizer(init, update)
