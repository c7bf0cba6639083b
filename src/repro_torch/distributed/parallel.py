"""Tensor, data and pipeline parallelism over the ranks of a mesh: the
collectives the reference's GSPMD and ``shard_map`` insert, called
explicitly, and the autograd Functions that carry gradients across them.

A :class:`RankGroups` is one rank's view of a mesh under the logical
mapping: its "model" group (tensor and expert parallelism, the stage
axis of the pipeline) and its data group (the batch axes, flattened
when there are two). Model code reads it with :func:`current_groups`
inside :func:`use_groups` (the cells enter it); off a mesh there is
none and every model function runs its one-card path.

Gradients (Megatron-LM's conjugate pair and its vocabulary-parallel
cross-entropy):
  * :func:`copy_to_model` (*f*): identity forward, all-reduce of the
    cotangent over "model" backward; every replicated tensor that enters
    the model-parallel region (an activation, or a replicated param such
    as a norm scale or the router read there) goes through it, so the
    partial cotangents of the column-parallel branches are summed;
  * :func:`reduce_from_model` (*g*): all-reduce forward, identity
    backward (a row-parallel output, the expert combine);
  * :func:`mean_over_data`: the loss's mean over the data ranks (sum /
    n forward, cotangent / n backward), so the rank's gradients sum over
    the data ranks to the global batch's;
  * :func:`vocab_parallel_ce`: log-sum-exp by a max and a sum
    all-reduce, the gold logit by a masked gather and a sum all-reduce;
    its backward is softmax minus one-hot on the rank's vocabulary
    slice, with no collective;
  * :func:`gather_over_data`: all-gather forward, the rank's slice of
    the summed cotangent backward (the MoE whose experts do not divide
    the model axis runs on the global tokens, as the reference's GSPMD
    ``_mlp_moe`` does).
  * :func:`copy_to` / :func:`reduce_from`: *f* and *g* over any group
    (the data axes of LightGCN's edge blocks); :func:`sum_over_data`:
    *g* over the data ranks (a sum of each rank's share of a global
    ratio, such as SASRec's masked mean);
  * :func:`sum_keep_rows`: the sum over a group of every rank's partial
    rows, of which each rank keeps its batch rows (a reduce-scatter, by
    an all-reduce and a slice); backward, the cotangents of every rank's
    rows, all-gathered;
  * :func:`gather_rows`: a row-sharded table whole on every rank, its
    backward the rank's block of the (replicated) cotangent;
  * :func:`gather_param`: a param stored split over data axes (the
    reference's ZeRO'd serving params, FSDP, the "dp" mapping; a
    :class:`ParamSplit`) whole just in time, by one all-gather; its
    backward a reduce-scatter of the cotangent into the rank's block
    (FSDP's gradient), or the rank's slice where the batch is whole on
    every rank of the group.
The row-sharded lookup of the recsys cells built on these is
``models.recsys.row_lookup``.
``torch.distributed.nn.functional.all_reduce`` is not used: its backward
all-reduces again, which over-counts a replicated gradient n times.

Every collective passes through :func:`all_reduce`,
:func:`all_gather_cat`, :func:`reduce_scatter_cat` or
:func:`ring_exchange`, which count calls and bytes in :data:`COUNTS`
(``chip_smoke.py`` reads them a step). Over a group of one rank each is
the identity and issues nothing (nor counts): on a world of 1 no
collective runs.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Mapping, Optional

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import (_entry_axes, batch_axes,
                                              current_mapping, mesh_shape)

__all__ = ["RankGroups", "rank_groups", "data_axes", "axes_group", "use_groups",
           "current_groups", "RowBlock", "row_block",
           "COUNTS", "zero_counts", "all_reduce", "all_gather_cat",
           "ring_exchange", "copy_to", "reduce_from", "copy_to_model",
           "reduce_from_model", "mean_over_data", "sum_over_data",
           "vocab_parallel_ce", "gather_over_data", "sum_keep_rows",
           "gather_rows", "reduce_scatter_cat", "ParamSplit", "gather_param",
           "group_size"]

# collectives issued, and the bytes each kind moved in (all-reduce,
# all-gather, reduce-scatter: the whole tensor) or sent (ring)
COUNTS = {"collectives": 0, "all_reduce_bytes": 0, "all_gather_bytes": 0,
          "reduce_scatter_bytes": 0, "p2p_bytes": 0}


def zero_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def group_size(group) -> int:
    """The ranks of ``group`` (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over ``group`` in place (counted); returns ``t``."""
    if group_size(group) == 1:
        return t
    COUNTS["collectives"] += 1
    COUNTS["all_reduce_bytes"] += _nbytes(t)
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``t`` of ``group``, concatenated along ``dim`` in
    group-rank order (counted)."""
    n = group_size(group)
    if n == 1:
        return t
    t = t.contiguous()
    COUNTS["collectives"] += 1
    COUNTS["all_gather_bytes"] += _nbytes(t) * n
    out = torch.empty(n * t.numel(), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.reshape(-1), group=group)
    return torch.cat(out.view((n,) + tuple(t.shape)).unbind(0), dim=dim)


# torch 2.13 renames reduce_scatter_tensor (same signature)
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def reduce_scatter_cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum over ``group`` of every rank's ``t``, of which this rank
    keeps its block along ``dim`` (the blocks in group-rank order, the
    inverse of :func:`all_gather_cat`; counted)."""
    n = group_size(group)
    if n == 1:
        return t
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"{n} ways")
    COUNTS["collectives"] += 1
    COUNTS["reduce_scatter_bytes"] += _nbytes(t)
    blocks = torch.stack(t.chunk(n, dim=dim))
    out = torch.empty(blocks[0].numel(), dtype=t.dtype, device=t.device)
    _REDUCE_SCATTER(out, blocks.view(-1), group=group)
    return out.view(blocks.shape[1:])


def ring_exchange(x: torch.Tensor, to: int, frm: int) -> torch.Tensor:
    """Send ``x`` to global rank ``to`` and receive a tensor like it from
    ``frm``, as one ``batch_isend_irecv`` pair; a pair with this rank on
    both ends is a local copy (``ppermute``'s ``(i, i)``)."""
    me = dist.get_rank()
    if to == me and frm == me:
        return x.clone()
    COUNTS["collectives"] += 1
    COUNTS["p2p_bytes"] += _nbytes(x)
    x = x.contiguous()
    buf = torch.empty_like(x)
    for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, to),
                                     dist.P2POp(dist.irecv, buf, frm)]):
        w.wait()
    return buf


# ---------------------------------------------------------------------------
# one rank's groups
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RankGroups:
    """A rank's coordinates on the "model" axis and on the data axes.

    ``model_group`` / ``data_group`` are None where the mapping gives no
    such axis (and then ``n_*`` is 1); ``n_data`` counts the shards of
    the batch, 1 when the cell's batch is replicated over the data axes
    (it does not divide them). ``rows``: the :class:`RowBlock` of each
    row-sharded leaf of a cell, by its name (a recsys table or sketch,
    LightGCN's edges). ``params``: the :class:`ParamSplit` of each LM
    param stored split over data axes, by its flat key."""
    n_model: int
    model_rank: int
    model_group: Optional[object]
    n_data: int
    data_rank: int
    data_group: Optional[object]
    rows: Mapping[str, "RowBlock"] = dataclasses.field(default_factory=dict)
    params: Mapping[str, "ParamSplit"] = dataclasses.field(
        default_factory=dict)

    def model_peer(self, model_rank: int) -> int:
        """The global rank at ``model_rank`` on this rank's model axis."""
        return dist.get_process_group_ranks(self.model_group)[model_rank]


def axes_group(mesh, axes: tuple):
    """The process group over ``axes`` of ``mesh`` (one axis's, or the
    axes flattened, the first major); None for no axis."""
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def data_axes(mesh, batch: Optional[int] = None) -> tuple:
    """The mesh axes a cell's batch splits over under the current logical
    mapping ("tp": the batch axes; "dp": every axis), major first; none
    when they do not divide ``batch`` (it stays whole on every rank)."""
    sizes = mesh_shape(mesh)
    daxes = batch_axes(mesh)
    if current_mapping() != "tp" and "model" in sizes:
        daxes = daxes + ("model",)
    n = 1
    for a in daxes:
        n *= sizes[a]
    if batch is not None and batch % n:
        return ()
    return daxes


def rank_groups(mesh, batch: Optional[int] = None) -> RankGroups:
    """This rank's :class:`RankGroups` on ``mesh`` under the current
    logical mapping ("tp": "model" for tensor parallelism, the batch
    axes for data; "dp": no model axis, every axis for data). ``batch``:
    the cell's global batch; when the data axes do not divide it, the
    batch stays whole on every rank (the reference's ``_fit_spec``)."""
    sizes = mesh_shape(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    tp = current_mapping() == "tp" and "model" in sizes
    daxes = data_axes(mesh, batch)
    n_data = 1
    data_rank = 0
    for a in daxes:
        n_data *= sizes[a]
        data_rank = data_rank * sizes[a] + coord[a]
    return RankGroups(
        sizes["model"] if tp else 1, coord["model"] if tp else 0,
        mesh.get_group("model") if tp else None, n_data, data_rank,
        axes_group(mesh, daxes))


@dataclasses.dataclass(frozen=True)
class RowBlock:
    """This rank's block of a leaf's rows: rows [lo, lo + len) of its
    ``n_rows``, the rows split among the ranks of ``group`` (None: this
    rank holds every row). Ranks outside the group along other mesh axes
    hold the same block."""
    lo: int
    n_rows: int
    group: Optional[object] = None


def row_block(layout, n_rows: int) -> RowBlock:
    """The :class:`RowBlock` of a leaf of ``n_rows`` rows whose dim 0 is
    split as ``layout`` (a ``sharding.Layout`` on a ``DeviceMesh``) says."""
    axes = _entry_axes(layout.spec[0]) if layout.spec else ()
    if not axes:
        return RowBlock(0, n_rows)
    return RowBlock(layout._block(0, n_rows)[0], n_rows,
                    axes_group(layout.mesh, axes))


_GROUPS = contextvars.ContextVar("repro_torch_rank_groups", default=None)


@contextlib.contextmanager
def use_groups(groups: Optional[RankGroups]):
    """Model code in the block runs on ``groups`` (None: one card)."""
    token = _GROUPS.set(groups)
    try:
        yield groups
    finally:
        _GROUPS.reset(token)


def current_groups() -> Optional[RankGroups]:
    return _GROUPS.get()


# ---------------------------------------------------------------------------
# autograd Functions across the collectives
# ---------------------------------------------------------------------------
class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MeanOverData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.n = n
        return all_reduce(x.clone(), group) / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *f* over ``group``: ``x`` as it is; its cotangent
    all-reduced over the group (None: ``x`` itself)."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *g* over ``group``: the sum of every rank's ``x``; the
    cotangent passes through (None: ``x`` itself)."""
    return x if group is None else _ReduceFrom.apply(x, group)


def copy_to_model(x: torch.Tensor, groups: RankGroups) -> torch.Tensor:
    """*f* over the model axis."""
    return copy_to(x, groups.model_group)


def reduce_from_model(x: torch.Tensor, groups: RankGroups) -> torch.Tensor:
    """*g* over the model axis."""
    return reduce_from(x, groups.model_group)


def sum_over_data(x: torch.Tensor, groups: RankGroups) -> torch.Tensor:
    """*g* over the data ranks: the sum of every data rank's share (of a
    global sum or ratio), the cotangent passing through."""
    return reduce_from(x, groups.data_group)


def mean_over_data(x: torch.Tensor, groups: RankGroups) -> torch.Tensor:
    """The mean of ``x`` over the data ranks (each holds an equal share of
    the batch); the cotangent divided by their count."""
    if groups.data_group is None:
        return x
    return _MeanOverData.apply(x, groups.data_group, groups.n_data)


class _VocabCE(torch.autograd.Function):
    """lg [..., V_loc] f32: this rank's vocabulary slice [lo, lo + V_loc)
    of the logits; targets [...] global ids. Returns log-sum-exp minus
    the gold logit, [...], over the whole vocabulary: the ops of
    ``torch.logsumexp`` (amax, exp of the shifted logits, sum, log, +
    max) with the max and the sum all-reduced between."""

    @staticmethod
    def forward(ctx, lg, targets, lo, group):
        v_loc = lg.shape[-1]
        m = all_reduce(lg.amax(-1), group, dist.ReduceOp.MAX)
        m = m.masked_fill(m.abs() == float("inf"), 0)
        s = all_reduce(torch.sum(torch.exp(lg - m[..., None]), dim=-1),
                       group)
        lse = torch.log(s) + m
        local = targets.long() - lo
        inr = (local >= 0) & (local < v_loc)
        local = torch.where(inr, local, 0)
        gold = torch.gather(lg, -1, local[..., None])[..., 0]
        gold = all_reduce(torch.where(inr, gold, 0), group)
        ctx.save_for_backward(lg, lse, local, inr)
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        lg, lse, local, inr = ctx.saved_tensors
        d = g[..., None] * torch.exp(lg - lse[..., None])
        d.scatter_add_(-1, local[..., None],
                       torch.where(inr, -g, 0)[..., None])
        return d, None, None, None


def vocab_parallel_ce(lg: torch.Tensor, targets: torch.Tensor, lo: int,
                      groups: RankGroups) -> torch.Tensor:
    """Per-position cross-entropy over the vocabulary split across the
    model axis (this rank's logits ``lg`` hold ids [lo, lo + V_loc))."""
    return _VocabCE.apply(lg, targets, lo, groups.model_group)


class _GatherOverData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank):
        ctx.group, ctx.rank, ctx.b = group, rank, x.shape[0]
        return all_gather_cat(x, group, 0)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g.contiguous().clone(), ctx.group)
        return g.narrow(0, ctx.rank * ctx.b, ctx.b), None, None


def gather_over_data(x: torch.Tensor, groups: RankGroups) -> torch.Tensor:
    """Every data rank's ``x`` (its batch rows) concatenated on dim 0, in
    the batch's order; backward, this rank's rows of the summed
    cotangent."""
    if groups.data_group is None:
        return x
    return _GatherOverData.apply(x, groups.data_group, groups.data_rank)


# ---------------------------------------------------------------------------
# row-sharded tables
# ---------------------------------------------------------------------------
class _SumKeepRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rows_group, rank, split):
        ctx.rows_group, ctx.split = rows_group, split
        out = x.view_as(x) if group is None else all_reduce(x.clone(), group)
        if split:
            b = x.shape[0] // dist.get_world_size(rows_group)
            out = out.narrow(0, rank * b, b)
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.split:
            g = all_gather_cat(g, ctx.rows_group, 0)
        elif ctx.rows_group is not None:
            g = all_reduce(g.contiguous().clone(), ctx.rows_group)
        return g, None, None, None, None


def sum_keep_rows(x: torch.Tensor, group, groups: RankGroups,
                  split: bool = True) -> torch.Tensor:
    """``x`` [N, ...] (every rank's partial rows of the data ranks' N
    batch rows, all of them) summed over ``group``; of the sum this rank
    keeps its batch rows, when ``split`` (else all N, the same on every
    data rank). Backward: the cotangents of every data rank's rows
    all-gathered (when ``split``) or summed (else) over the data ranks:
    the cotangent of the whole of ``x``."""
    split = split and groups.data_group is not None
    return _SumKeepRows.apply(x, group, groups.data_group, groups.data_rank,
                              split)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[0]
        return all_gather_cat(x, group, 0)

    @staticmethod
    def backward(ctx, g):
        me = dist.get_rank(ctx.group)
        return g.narrow(0, me * ctx.n, ctx.n).contiguous(), None


def gather_rows(block: torch.Tensor, rows: RowBlock) -> torch.Tensor:
    """The whole of a row-sharded leaf on every rank (its blocks
    all-gathered over their group, in block order). Backward: this
    rank's block of the cotangent, which must be the same on every rank
    of the group (the whole leaf's gradient)."""
    if rows.group is None:
        return block
    return _GatherRows.apply(block, rows.group)


# ---------------------------------------------------------------------------
# params split over data axes (ZeRO'd serving params, FSDP, "dp")
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ParamSplit:
    """A param stored in blocks along ``dim`` over ``group`` (the data
    axes of its layout). ``partial``: each rank's cotangent of the whole
    param is its share of the batch's (the batch splits over the
    group's axes), so the backward sums them; else every rank holds the
    whole batch's cotangent and keeps its block."""
    dim: int
    group: object
    partial: bool = True

    def at_block(self) -> "ParamSplit":
        """The split of one block ``p[bi]`` of a block-stacked param
        whose ``dim`` is not 0."""
        return dataclasses.replace(self, dim=self.dim - 1)


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return all_gather_cat(x, split.group, split.dim)

    @staticmethod
    def backward(ctx, g):
        s = ctx.split
        if s.partial:
            return reduce_scatter_cat(g, s.group, s.dim), None
        n = group_size(s.group)
        b = g.shape[s.dim] // n
        return g.narrow(s.dim, dist.get_rank(s.group) * b, b), None


def gather_param(x: torch.Tensor, split: Optional[ParamSplit]) -> torch.Tensor:
    """A param block whole over its data axes (``split``; None or a group
    of one rank: ``x`` itself). Backward: the rank's block of the
    cotangent, summed over the group when ``split.partial``."""
    if split is None or group_size(split.group) == 1:
        return x
    return _GatherParam.apply(x, split)
