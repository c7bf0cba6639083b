"""Pipeline parallelism (GPipe) over the ranks of a mesh (port of
``repro.launch.pipeline``).

The "model" mesh axis is the STAGE axis: stage ``j`` holds blocks
``[j * bps, (j + 1) * bps)`` of the ``n_blocks`` (``bps = n_blocks /
n_stages``); activations flow stage to stage through a ring of
point-to-point exchanges inside a tick loop (``n_micro + n_stages - 1``
ticks, the classic GPipe schedule with its bubble). Stage 0 embeds each
microbatch (the codebook_lookup kernel on the card), the last stage
computes its chunked cross-entropy; the loss is summed over "model",
averaged over "data" and divided by ``n_micro * mb_local * seq``, then
one AdamW update.

The layouts are the reference's: the blocks over "model" on their stage
dim, the embedding's rows over "data" (where "data" divides them) and
the untied head's columns, the final norm replicated, and the AdamW
moments ZeRO-1'd over "data" (``sharding.opt_state_axes``). The
embedding and the head are all-gathered over "data" once a step
(``parallel.gather_param``: the reference's GSPMD gathers them once for
its replicated ``in_specs``), their gradients reduce-scattered back; a
ZeRO-1'd moment's update runs on the rank's block of the param, then
all-gathers it.

The reference's ``ppermute`` ring becomes :class:`_Ring`: each tick's
forward sends the stage's output to ``j + 1`` and receives from ``j - 1``
as one ``batch_isend_irecv`` pair on every rank, in the reference's
order; its backward sends the received tensor's cotangent to ``j - 1``
and receives the sent one's from ``j + 1``. A token leaf threaded through
every exchange (added, times 0, to each rank's loss, and its gradient
asked for) puts every exchange on every rank's backward path, so every
rank issues the matching exchanges in reverse, also where a received
tensor is unused (stage 0 embeds instead) or a sent one depends on no
param: per-rank autograd would otherwise skip them and leave a peer
waiting. On a world of 1 the ring is ``[(0, 0)]``, a
local copy by ``ppermute``'s semantics. The params not split over
"model" (embedding, final norm, head) are read on some stages only:
their gradients are summed over "model" after the backward, then over
"data" (the embedding's and the head's by their gather's
reduce-scatter).

Scope, as the reference's: dense LMs whose ``n_blocks`` the stage count
divides (qwen1.5-32b: 64 blocks); otherwise it raises (kimi-k2's 61).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import parallel as par
from repro_torch.distributed import sharding as sh
from repro_torch.launch.steps import (Cell, _cut, _flat, _full_batch,
                                      _mesh_plan, _nest, _Spec, mesh_norm)
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.training import optimizer as opt_lib

__all__ = ["build_pp_train_cell"]


class _Ring(torch.autograd.Function):
    """(x, token) -> (the tensor received from ``prv``, token): x sent to
    ``nxt``; backward, the cotangent sent to ``prv`` and ``nxt``'s
    received."""

    @staticmethod
    def forward(ctx, x, token, nxt: int, prv: int):
        ctx.nxt, ctx.prv = nxt, prv
        return par.ring_exchange(x, nxt, prv), token.clone()

    @staticmethod
    def backward(ctx, gy, gtoken):
        return (par.ring_exchange(gy, ctx.prv, ctx.nxt), gtoken, None,
                None)


def _pp_layouts(cfg, mesh) -> dict:
    """{"params", "opt"}: the blocks over "model" on their leading
    (block) dim, the embedding over ("data", None) where "data" divides
    its rows, the untied head over (None, "data"), the final norm
    replicated; the AdamW moments ZeRO-1'd over "data"
    (``repro/launch/pipeline.py:62-85``)."""
    shapes = _flat(T.param_shapes(cfg))
    n_data = sh.mesh_shape(mesh).get("data", 1)
    axes = {}
    for k, shp in shapes.items():
        if k.startswith("blocks/"):
            axes[k] = ("model",) + (None,) * (len(shp) - 1)
        elif k == "embed" and shp[0] % n_data == 0:
            axes[k] = ("data", None)
        elif k == "lm_head":
            axes[k] = (None, "data")
        else:
            axes[k] = (None,) * len(shp)

    def lay(ax, shp):
        return sh.Layout(mesh, sh.fit_spec(mesh, sh.logical_to_spec(mesh, ax),
                                           shp))
    m = {k: lay(ax, shapes[k]) for k, ax in sh.opt_state_axes(
        "adamw", axes, shapes)["m"].items()}
    return {"params": _nest({k: lay(ax, shapes[k]) for k, ax in axes.items()}),
            "opt": {"step": sh.Layout(mesh, ()), "m": m, "v": dict(m)}}


def build_pp_train_cell(cfg: T.TransformerConfig, *, global_batch: int,
                        seq: int, mesh, n_micro: int = 16, device="cuda",
                        args: Optional[tuple] = None) -> Cell:
    """The GPipe train cell of ``cfg`` on this rank of ``mesh``: its stage's
    blocks, its blocks of the embedding and the head, the final norm,
    AdamW (lr 3e-4, clip 1.0, the norm over every rank's blocks; its
    moments ZeRO-1'd over "data") and its rows of
    a global batch of ``global_batch`` sequences of ``seq`` tokens (ids
    uniform over the vocabulary from generator seed 0, params from
    ``init_params`` seed 0), or the whole ``args`` = (params, batch) cut
    into its blocks. ``Cell.fn(params, opt_state, batch)`` returns the
    updated params (in place), the state and the loss."""
    device = resolve_device(device)
    with par.use_groups(None):
        groups = par.rank_groups(mesh, global_batch)
    n_stages, j = groups.n_model, groups.model_rank
    if cfg.n_blocks % n_stages:
        raise ValueError(f"{cfg.name}: {cfg.n_blocks} blocks not divisible "
                         f"into {n_stages} stages")
    if cfg.moe is not None:
        raise ValueError(f"{cfg.name}: the pipeline runs dense LMs")
    bps = cfg.n_blocks // n_stages
    n_data = groups.n_data
    if global_batch % (n_data * n_micro):
        raise ValueError(f"a global batch of {global_batch} does not split "
                         f"into {n_data} data ranks x {n_micro} microbatches")
    mb_local = global_batch // (n_data * n_micro)
    layouts = _pp_layouts(cfg, mesh)
    splits, plan = _mesh_plan(mesh, layouts, groups, global_batch)
    groups = dataclasses.replace(groups, params=splits)
    if args is None:
        params = T.init_params(torch.Generator(device=device).manual_seed(0),
                               cfg, layouts=layouts["params"])
        batch = _full_batch({k: _Spec((global_batch, seq), torch.int32,
                                      cfg.vocab_size)
                             for k in ("tokens", "targets")}, device)
    else:
        params = _cut(layouts["params"], args[0])
        batch = args[1]
    rows = global_batch // n_data
    batch = {k: v.narrow(0, groups.data_rank * rows, rows)
             for k, v in batch.items()}
    flat_layouts = R.flat_params(layouts["params"])
    sharded = {k for k, lay in flat_layouts.items() if "model" in lay.axes}
    opt = opt_lib.adamw(lr=3e-4, grad_clip=1.0,
                        norm=mesh_norm(mesh, plan.state_layouts))
    opt_state = opt.init({k: plan.block(k, p)
                          for k, p in R.flat_params(params).items()})
    nxt = groups.model_peer((j + 1) % n_stages)
    prv = groups.model_peer((j - 1) % n_stages)
    n_ticks = n_micro + n_stages - 1
    denom = n_micro * mb_local * seq

    def stage(blocks, x, pos):
        for i in range(bps):
            blk = {k: v[i] for k, v in blocks.items()}
            x = T._maybe_checkpoint(T._block, x, blk, cfg, pos)
        return x

    def ce(p, x, tg):
        h = T.rms_norm(x, p["final_norm"])
        lc = min(cfg.loss_chunk, seq)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(max(1, seq // lc)):
            sl = slice(i * lc, (i + 1) * lc)
            total = total + T._maybe_checkpoint(T._ce_sum, p, h[:, sl],
                                                tg[:, sl], cfg)
        return total

    def loss_terms(params, b):
        """(this rank's summed CE, the loss it back-propagates, the token
        leaf)."""
        tk = b["tokens"].reshape(n_micro, mb_local, seq)
        tg = b["targets"].reshape(n_micro, mb_local, seq)
        pos = T._positions(mb_local, seq, tk.device)
        # the residual stream's dtype (gemma's embedding scale makes it
        # f32): every exchange sends and receives one dtype
        x_recv = torch.zeros((mb_local, seq, cfg.d_model),
                             dtype=torch.float32 if cfg.embed_scale
                             else cfg.torch_dtype, device=tk.device)
        token = token0 = torch.zeros((), device=tk.device,
                                     requires_grad=True)
        top = T._top_params(params, groups)     # whole over "data"
        loss_acc = torch.zeros((), dtype=torch.float32, device=tk.device)
        for t in range(n_ticks):
            m = t - j                       # the microbatch at this stage
            x_out = x_recv
            if 0 <= m < n_micro:
                x_in = T._embed(top, tk[m], cfg) if j == 0 else x_recv
                x_out = stage(params["blocks"], x_in, pos)
                if j == n_stages - 1:
                    loss_acc = loss_acc + ce(top, x_out, tg[m])
            x_recv, token = _Ring.apply(x_out, token, nxt, prv)
        return loss_acc, loss_acc / n_data / denom + 0 * token, token0

    def train_step(params, opt_state, b):
        flat = R.flat_params(params)
        leaves = list(flat.values())
        for p in leaves:
            p.requires_grad_(True)
        with T._f32_sums_ctx():
            loss_acc, obj, token0 = loss_terms(params, b)
            # the token's gradient too: autograd runs only the nodes on a
            # path to a requested input, and the token's path holds every
            # exchange (the first on the last stage sends the initial
            # zeros, which no param made)
            *grads, _ = torch.autograd.grad(obj, leaves + [token0],
                                            allow_unused=True)
        for p in leaves:
            p.requires_grad_(False)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(flat.items(), grads)}
        for k, g in grads.items():
            if k not in sharded:
                par.all_reduce(g, groups.model_group)
            par.all_reduce(g, plan.grad_groups[k])
        loss = par.all_reduce(loss_acc.detach().clone(), groups.model_group)
        if groups.data_group is not None:
            loss = par.all_reduce(loss, groups.data_group)
        loss = loss / n_data / denom
        blocks = {k: plan.block(k, p) for k, p in flat.items()}
        opt.update({k: plan.block(k, g) for k, g in grads.items()},
                   opt_state, blocks)
        for k, p in flat.items():
            plan.regather(k, p, blocks[k])
        return params, opt_state, loss

    return Cell(cfg.name, f"gpipe_{global_batch}x{seq}", "train", train_step,
                (params, opt_state, batch), donate=(0, 1),
                notes=(f"stages={n_stages},blocks_per_stage={bps},"
                       f"microbatches={n_micro},data={n_data},"
                       f"data_split={len(splits)},"
                       f"moments ZeRO-1 over data: {len(plan.zero1)} leaves"),
                mesh=mesh, layouts=layouts)
