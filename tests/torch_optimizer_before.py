"""The port's AdamW and Adafactor updates as they were before the update
ran over slices and clipped one leaf at a time (every gradient clipped
into a new dict first, each leaf updated whole): the oracle that
``tests/test_torch_train.py`` and ``tests/test_torch_cuda.py`` hold the
current updates against, bit for bit. No JAX: the ``cuda`` tests import
it too."""
import torch

from repro_torch.training.optimizer import _leaves


def _global_norm(grads):
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for _, g in _leaves(grads)))


def _clip(grads, grad_clip):
    if grad_clip is None:
        return grads
    gn = _global_norm(grads)
    scale = torch.clamp(grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
    return {k: g * scale for k, g in grads.items()}


@torch.no_grad()
def adamw_update(grads, state, params, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=0.0, grad_clip=None):
    state["step"].add_(1)
    grads = _clip(grads, grad_clip)
    t = state["step"].float()
    bc1 = 1 - torch.pow(b1, t)
    bc2 = 1 - torch.pow(b2, t)
    for k, p in _leaves(params):
        g32 = grads[k].float()
        m, v = state["m"][k], state["v"][k]
        m.copy_(b1 * m + (1 - b1) * g32)
        v.copy_(b2 * v + (1 - b2) * torch.square(g32))
        delta = lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps)
                      + weight_decay * p.float())
        p.copy_((p.float() - delta).to(p.dtype))
    return params, state


@torch.no_grad()
def adafactor_update(grads, state, params, lr=1e-2, decay=0.8, eps=1e-30,
                     clip_threshold=1.0, grad_clip=None):
    state["step"].add_(1)
    grads = _clip(grads, grad_clip)
    t = state["step"].float()
    beta = 1.0 - torch.pow(t, -decay)
    for (k, p), s in zip(_leaves(params), state["fac"]):
        g32 = grads[k].float()
        g2 = torch.square(g32) + eps
        if p.dim() >= 2:
            s["vr"].copy_(beta * s["vr"] + (1 - beta) * g2.mean(dim=-1))
            s["vc"].copy_(beta * s["vc"] + (1 - beta) * g2.mean(dim=-2))
            r = s["vr"] / torch.clamp(s["vr"].mean(dim=-1, keepdim=True),
                                      min=eps)
            u = (g32 * torch.rsqrt(r)[..., None]
                 * torch.rsqrt(s["vc"])[..., None, :])
        else:
            s["v"].copy_(beta * s["v"] + (1 - beta) * g2)
            u = g32 * torch.rsqrt(s["v"])
        rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        p.copy_((p.float() - lr * u).to(p.dtype))
    return params, state


def random_leaves(generator, device="cpu"):
    """Params and gradients to update: f32 and bf16 leaves, a scalar, a
    vector, matrices and a stacked 4-d leaf of 3 x 5 x 7 x 11 elements,
    and a transposed (not contiguous) f32 matrix; gradients of several
    scales, so the clip at 1.0 binds."""
    shapes = {"a": (3, 5, 7, 11), "b": (40, 33), "c": (129,), "d": (),
              "e": (6, 300), "f": (17, 19)}
    params, grads = {}, {}
    for i, (k, shp) in enumerate(sorted(shapes.items())):
        dt = torch.bfloat16 if i % 2 else torch.float32
        params[k] = torch.randn(shp, generator=generator).to(dt)
        grads[k] = (torch.randn(shp, generator=generator) * 10 ** (i - 3)
                    ).to(dt)
    params["f"] = params["f"].t()              # a strided leaf
    grads["f"] = grads["f"].t()
    return ({k: v.to(device) for k, v in params.items()},
            {k: v.to(device) for k, v in grads.items()})
