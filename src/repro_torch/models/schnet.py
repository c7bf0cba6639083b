"""SchNet (Schütt et al. 2017), a continuous-filter convolution GNN (port
of ``repro.models.schnet``).

For each edge (i <- j) the filter W(d_ij), an MLP over a radial-basis
expansion of the distance, gates the neighbor's feature; the messages
are summed into the receiver. ``n_interactions`` blocks, then an atomwise
readout; per-graph energies are a segment sum over the batch index.

The reference's ``jnp.take(h, src)`` and ``jax.ops.segment_sum`` are
autograd Functions over the CSR gather-sum kernel
(``kernels.embedding_bag.csr_gather_sum``): a segment sum is the kernel
over the edges stably sorted by receiver, the gather's gradient the
kernel over the edges stably sorted by sender. Each sum adds its rows in
edge order from +0.0, the order of XLA's serial scatter-add on the CPU,
with no float atomics. The sorts and CSR pointers (an :class:`EdgePlan`)
are built once per batch and serve every block, forward and backward.
The atom embedding is ``embedding_lookup`` on the port's engine
(codebook_lookup on the card, its backward the CSR gather-sum).

On a mesh (``distributed.parallel.use_groups``, entered by
``launch.steps.build_cell(mesh=...)``) whose data ranks split the batch,
each rank holds a block of the nodes and one of the edges (global node
ids), and the params whole. Each interaction all-gathers the node
features over the data ranks, gathers and segment-sums its edges into
the whole node range, and keeps its node block of the ranks' sum
(``parallel.sum_keep_rows``, a reduce-scatter); the losses are the
whole batch's (partial sums summed over the data ranks). This stands
for the reference's ``shard(x, "batch", None)`` annotations.

BACO does not apply: the only table is the ~100-row atomic-number
embedding.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.distributed import parallel as par
from repro_torch.embedding import embedding_lookup
from repro_torch.kernels.embedding_bag import _ptr, csr_gather_sum
from repro_torch.models.recsys import flat_params, params_from_numpy

__all__ = ["SchNetConfig", "EdgePlan", "edge_plan", "init_params",
           "params_from_numpy", "flat_params", "energy", "train_loss",
           "node_train_loss"]

# ``np.log(2.0)`` is a float64 numpy scalar: JAX (without x64) takes it as
# a strongly typed f32, so ``softplus(x) - np.log(2.0)`` subtracts the f32
# value, and promotes a 16-bit x to f32
_LOG2 = float(np.float32(np.log(2.0)))
_GAMMA = 10.0


@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    max_z: int = 100
    d_feat: int = 0      # >0: dense node features projected in (graph
                         # benchmarks à la Cora/Reddit) instead of Z-embed
    dtype: str = "float32"
    lookup_backend: "str | None" = None   # EmbeddingEngine override

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
def _lin(generator, i, o, device):
    w = torch.randn((i, o), generator=generator, dtype=torch.float32,
                    device=device).div_(math.sqrt(i))
    return {"w": w, "b": torch.zeros((o,), dtype=torch.float32,
                                     device=device)}


def init_params(generator, cfg: SchNetConfig, device=None) -> dict:
    """The reference's params tree (shapes and scales: lin weights
    N(0, 1/i), zero biases, the embedding N(0, 0.01)), drawn from the
    explicit ``generator`` on its device (or ``device``). Tests carry the
    reference's own params over with :func:`params_from_numpy`."""
    dev = torch.device(device) if device is not None else generator.device
    d, r = cfg.d_hidden, cfg.n_rbf
    params = {
        "embed": torch.randn((cfg.max_z, d), generator=generator,
                             dtype=torch.float32, device=dev).mul_(0.1),
        "out1": _lin(generator, d, d // 2, dev),
        "out2": _lin(generator, d // 2, 1, dev),
        "blocks": [],
    }
    if cfg.d_feat:
        params["in_proj"] = _lin(generator, cfg.d_feat, d, dev)
    for _ in range(cfg.n_interactions):
        params["blocks"].append({
            "filt1": _lin(generator, r, d, dev),
            "filt2": _lin(generator, d, d, dev),
            "in_lin": _lin(generator, d, d, dev),
            "mid": _lin(generator, d, d, dev),
            "out": _lin(generator, d, d, dev),
        })
    return params


# ---------------------------------------------------------------------------
# the edge plan and the two sums
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class EdgePlan:
    """The CSR plans of one batch's edges: ``dst_perm`` / ``dst_ptr`` the
    stable sort of the receivers and its pointers over the nodes (the
    segment sum), ``src_perm`` / ``src_ptr`` the same for the senders
    (the gather's gradient)."""
    src: torch.Tensor
    dst: torch.Tensor
    src_perm: torch.Tensor
    src_ptr: torch.Tensor
    dst_perm: torch.Tensor
    dst_ptr: torch.Tensor


def _sorted(ids: torch.Tensor, n: int):
    """(perm int32, ptr int64 [n + 1]): the stable sort of ``ids`` in
    [0, n) and the boundaries of its runs of 0..n-1."""
    ids_sorted, perm = torch.sort(ids.long(), stable=True)
    return perm.int(), _ptr(ids_sorted, n)


def edge_plan(src: torch.Tensor, dst: torch.Tensor, n: int) -> EdgePlan:
    src_perm, src_ptr = _sorted(src, n)
    dst_perm, dst_ptr = _sorted(dst, n)
    return EdgePlan(src.long(), dst.long(), src_perm, src_ptr, dst_perm,
                    dst_ptr)


class _Gather(torch.autograd.Function):
    """h[src]; dh[r] = Σ_{j: src[j] == r} g[j] in j order."""

    @staticmethod
    def forward(ctx, h, src, perm, ptr):
        ctx.save_for_backward(perm, ptr)
        return h.index_select(0, src)

    @staticmethod
    def backward(ctx, g):
        perm, ptr = ctx.saved_tensors
        return csr_gather_sum(g.contiguous(), perm, ptr), None, None, None


class _SegmentSum(torch.autograd.Function):
    """out[r] = Σ_{j: seg[j] == r} x[j] in j order; dx = g[seg]."""

    @staticmethod
    def forward(ctx, x, seg, perm, ptr):
        ctx.save_for_backward(seg)
        return csr_gather_sum(x, perm, ptr)

    @staticmethod
    def backward(ctx, g):
        (seg,) = ctx.saved_tensors
        return g.index_select(0, seg), None, None, None


def gather(h: torch.Tensor, plan: EdgePlan) -> torch.Tensor:
    """``jnp.take(h, src, axis=0)``."""
    return _Gather.apply(h, plan.src, plan.src_perm, plan.src_ptr)


def segment_sum(x: torch.Tensor, seg: torch.Tensor, perm: torch.Tensor,
                ptr: torch.Tensor) -> torch.Tensor:
    """``jax.ops.segment_sum(x, seg, num_segments=len(ptr) - 1)`` of x
    [M] or [M, d], with ``perm`` / ``ptr`` the stable sort of ``seg``."""
    if x.dim() == 1:
        return _SegmentSum.apply(x[:, None], seg, perm, ptr)[:, 0]
    return _SegmentSum.apply(x, seg, perm, ptr)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def _apply_lin(p, x):
    return x @ p["w"] + p["b"]


def _ssp(x):
    """Shifted softplus, ``jax.nn.softplus(x) - np.log(2.0)``:
    softplus is ``logaddexp(x, 0)`` (its gradient exp(x - out) is 0.5 at
    0), then the f32 log 2 is subtracted (a 16-bit x promotes to f32)."""
    return torch.logaddexp(x, x.new_zeros(())).float() - _LOG2


def rbf_centers(cfg: SchNetConfig, device=None) -> torch.Tensor:
    """``jnp.linspace(0.0, cutoff, n_rbf)`` in f32, as XLA computes it:
    ``start * (1 - t) + stop * t`` with t = i / (n - 1) folds, at start
    0, into i times the f32 constant cutoff / (n - 1); the last point is
    ``cutoff`` itself."""
    n = cfg.n_rbf
    if n == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    step = float(np.float32(cfg.cutoff) / np.float32(n - 1))
    out = torch.arange(n - 1, dtype=torch.float32, device=device) * step
    return torch.cat([out, torch.full((1,), cfg.cutoff, dtype=torch.float32,
                                      device=device)])


def _rbf_expand(dist, cfg: SchNetConfig):
    centers = rbf_centers(cfg, dist.device)
    return torch.exp(-_GAMMA * (dist[:, None] - centers[None, :]) ** 2)


def _cosine_cutoff(dist, cutoff):
    c = 0.5 * (torch.cos(math.pi * dist / cutoff) + 1.0)
    return torch.where(dist < cutoff, c, 0.0)


def _atoms(params, batch, cfg: SchNetConfig):
    """The node features entering the first block, and the node count."""
    if cfg.d_feat:
        feat = batch["feat"]
        return _apply_lin(params["in_proj"], feat).to(cfg.torch_dtype), \
            feat.shape[0]
    z = batch["z"]
    x = embedding_lookup(params["embed"], z, backend=cfg.lookup_backend)
    return x.to(cfg.torch_dtype), z.shape[0]


def _split_groups():
    """The rank's groups when the batch is split over data ranks, else
    None (one card, or a batch every rank holds whole)."""
    g = par.current_groups()
    return g if g is not None and g.data_group is not None else None


def _node_outputs(params, batch, cfg: SchNetConfig,
                  plan: Optional[EdgePlan]):
    """Every block, then the atomwise readout: [N] per-node outputs (on a
    mesh, of this rank's nodes)."""
    g = _split_groups()
    dist = batch["edge_dist"]
    x, n = _atoms(params, batch, cfg)
    if plan is None:
        n_all = n if g is None else n * g.n_data
        plan = edge_plan(batch["edge_src"], batch["edge_dst"], n_all)
    rbf = _rbf_expand(dist, cfg).to(cfg.torch_dtype)
    fcut = _cosine_cutoff(dist, cfg.cutoff).to(cfg.torch_dtype)
    for blk in params["blocks"]:
        w = _ssp(_apply_lin(blk["filt1"], rbf))
        w = _apply_lin(blk["filt2"], w) * fcut[:, None]     # [E, d]
        h = _apply_lin(blk["in_lin"], x)
        if g is not None:
            h = par.gather_over_data(h, g)
        msg = gather(h, plan) * w                           # gather + gate
        agg = segment_sum(msg, plan.dst, plan.dst_perm, plan.dst_ptr)
        if g is not None:
            agg = par.sum_keep_rows(agg, g.data_group, g)
        v = _ssp(_apply_lin(blk["mid"], agg))
        x = x + _apply_lin(blk["out"], v)
    h = _ssp(_apply_lin(params["out1"], x))
    return _apply_lin(params["out2"], h)[:, 0]              # [N]


def energy(params, batch, cfg: SchNetConfig, n_graphs: int = 1,
           plan: Optional[EdgePlan] = None) -> torch.Tensor:
    """batch: z int32 [N], edge_src / edge_dst int32 [E], edge_dist f32
    [E], graph_id int32 [N]. Returns the per-graph energy [n_graphs].
    ``plan``: the batch's :func:`edge_plan` (built here when None)."""
    atom_e = _node_outputs(params, batch, cfg, plan)
    perm, ptr = _sorted(batch["graph_id"], n_graphs)
    out = segment_sum(atom_e, batch["graph_id"].long(), perm, ptr)
    g = _split_groups()
    return out if g is None else par.sum_over_data(out, g)


def train_loss(params, batch, cfg: SchNetConfig,
               plan: Optional[EdgePlan] = None) -> torch.Tensor:
    targets = batch["targets"]
    g = _split_groups()
    if g is not None:
        targets = par.all_gather_cat(targets, g.data_group, 0)
    pred = energy(params, batch, cfg, n_graphs=targets.shape[0], plan=plan)
    return torch.mean((pred - targets) ** 2)


def node_train_loss(params, batch, cfg: SchNetConfig,
                    plan: Optional[EdgePlan] = None) -> torch.Tensor:
    """Per-node regression (the full-graph and sampled-training shapes),
    over ``node_mask`` when the batch has one."""
    pred = _node_outputs(params, batch, cfg, plan)
    mask = batch.get("node_mask")
    err = (pred - batch["node_targets"]) ** 2
    g = _split_groups()
    if mask is None:
        err = torch.mean(err)
        return err if g is None else par.mean_over_data(err, g)
    num, den = torch.sum(err * mask), torch.sum(mask)
    if g is not None:
        num, den = par.sum_over_data(num, g), par.sum_over_data(den, g)
    return num / torch.clamp_min(den, 1.0)
