"""LightGCN (He et al. 2020) over full or codebook tables, with BPR
(port of ``repro.models.lightgcn``).

The tables are either the full |U|x d / |V|x d matrices or codebooks
indexed through a frozen sketch (U = Y_u Z_u, V = Y_v Z_v). Propagation
runs over the training graph with symmetric 1/sqrt(d_u d_v) weights; the
final representation is the mean of the K+1 layer outputs.

Propagation is scatter-free, as in the reference: each side is a sorted
run of edges, and each output row is the weighted sum of its run, folded
in edge order from +0.0 by the weighted CSR gather-sum kernel
(``kernels.embedding_bag.csr_gather_sum``; its plain version on the CPU).
Its backward (``_Propagate``, the reference's custom VJP) is the same
sum under the opposite orientation. No float atomics: two runs are
bitwise equal. The reference reduces each run with a tree prefix scan
and a boundary difference, so the two agree to a tolerance, not bitwise.

On a mesh (``distributed.parallel.use_groups``, the cf cell of
``launch.steps.build_cell(mesh=...)``) the tables (or codebooks) and
sketches are this rank's blocks of "vocab" rows, the statics' edges the
rank's block of the user-sorted edges (``rows["edge_u"]``) and the BPR
batch its batch rows. :func:`bpr_loss_fn` all-gathers the tables and
sketches (``parallel.gather_rows``: E0 whole on every rank), propagates
its edge block and sums the partial layers over the edges' group
(Megatron's *f* and *g*), and reads its batch rows of the whole
(replicated) propagated tables, whose cotangent *f* sums over the data
ranks; each rank's table gradient is its block of the whole one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from repro_torch.core.graph import BipartiteGraph
from repro_torch.core.sketch import Sketch
from repro_torch.device import resolve_device
from repro_torch.distributed import parallel as par
from repro_torch.embedding import EmbeddingEngine, EmbeddingSpec, init_codebook
from repro_torch.kernels.embedding_bag import csr_gather_sum
from repro_torch.kernels.ops import _CodebookSum

__all__ = ["LightGCNConfig", "from_sketch", "engines", "make_statics",
           "sorted_edge_statics", "edge_norms", "kernel_edge_ids",
           "init_params", "all_embeddings", "bpr_loss_fn",
           "all_embeddings_seed", "bpr_loss_fn_seed", "eval_embeddings",
           "score_all_items"]


@dataclasses.dataclass(frozen=True)
class LightGCNConfig:
    n_users: int
    n_items: int
    dim: int = 64
    n_layers: int = 3
    l2: float = 1e-4
    # compression: None -> full tables (identity sketch)
    k_users: Optional[int] = None
    k_items: Optional[int] = None
    n_hot_users: int = 1
    # explicit EmbeddingEngine backend; None -> auto-select by device
    lookup_backend: Optional[str] = None


def from_sketch(graph: BipartiteGraph, sketch: Optional[Sketch], dim=64,
                n_layers=3, l2=1e-4,
                lookup_backend: Optional[str] = None) -> LightGCNConfig:
    if sketch is None:
        return LightGCNConfig(graph.n_users, graph.n_items, dim, n_layers, l2,
                              lookup_backend=lookup_backend)
    return LightGCNConfig(graph.n_users, graph.n_items, dim, n_layers, l2,
                          k_users=sketch.k_users, k_items=sketch.k_items,
                          n_hot_users=sketch.user_idx.shape[1],
                          lookup_backend=lookup_backend)


def engines(cfg: LightGCNConfig):
    """(user, item) EmbeddingEngines for this config's tables."""
    u = EmbeddingEngine(EmbeddingSpec(cfg.n_users, cfg.dim,
                                      k_rows=cfg.k_users,
                                      n_hot=cfg.n_hot_users),
                        backend=cfg.lookup_backend)
    v = EmbeddingEngine(EmbeddingSpec(cfg.n_items, cfg.dim,
                                      k_rows=cfg.k_items),
                        backend=cfg.lookup_backend)
    return u, v


def sorted_edge_statics(edge_u, edge_v, edge_norm, n_users: int,
                        n_items: int, perm_by_item=None,
                        device="cuda") -> dict:
    """Scatter-free propagation constants from a (user-sorted) edge
    list, as tensors on ``device``: both segment orientations as sorted
    runs plus both CSR indptrs, with the reference's keys, plus the int32
    edge ids the propagation kernel reads (``kernel_edge_ids``)."""
    dev = resolve_device(device)
    edge_u = np.asarray(edge_u)
    edge_v = np.asarray(edge_v)
    edge_norm = np.asarray(edge_norm)
    if edge_u.size and np.any(np.diff(edge_u) < 0):
        raise ValueError("edge_u must be sorted (BipartiteGraph edge "
                         "order); searchsorted indptrs would be garbage")
    perm = (np.asarray(perm_by_item) if perm_by_item is not None
            else np.argsort(edge_v, kind="stable"))
    indptr_u = np.searchsorted(edge_u, np.arange(n_users + 1,
                                                 dtype=np.int64))
    eu_byv = edge_u[perm]
    indptr_v = np.searchsorted(edge_v[perm], np.arange(n_items + 1,
                                                       dtype=np.int64))

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    statics = {
        "edge_u": t(edge_u, torch.int64),
        "edge_v": t(edge_v, torch.int64),
        "edge_norm": t(edge_norm, torch.float32),
        "edge_u_byitem": t(eu_byv, torch.int64),
        "edge_norm_byitem": t(edge_norm[perm], torch.float32),
        "indptr_u": t(indptr_u, torch.int64),
        "indptr_v": t(indptr_v, torch.int64),
    }
    for name, ids in kernel_edge_ids(edge_v, eu_byv).items():
        statics[name] = t(ids, torch.int32)
    return statics


def edge_norms(graph: BipartiteGraph) -> np.ndarray:
    """f32 1/sqrt(d_u d_v) per edge (degrees clamped at 1), host numpy,
    bitwise the reference's."""
    du = np.maximum(graph.user_degrees(), 1).astype(np.float32)
    dv = np.maximum(graph.item_degrees(), 1).astype(np.float32)
    return 1.0 / np.sqrt(du[graph.edge_u] * dv[graph.edge_v])


def make_statics(graph: BipartiteGraph, sketch: Optional[Sketch] = None,
                 device="cuda") -> dict:
    """Device-resident constants: normalized edges (both orientations)
    plus the sketch index arrays."""
    dev = resolve_device(device)
    statics = sorted_edge_statics(graph.edge_u, graph.edge_v,
                                  edge_norms(graph), graph.n_users,
                                  graph.n_items,
                                  perm_by_item=graph.perm_by_item,
                                  device=dev)
    if sketch is not None:
        statics["sketch_u"] = torch.as_tensor(sketch.user_idx,
                                              dtype=torch.int32, device=dev)
        statics["sketch_v"] = torch.as_tensor(sketch.item_idx,
                                              dtype=torch.int32, device=dev)
    return statics


def init_params(seed: int, cfg: LightGCNConfig, scale: float = 0.1) -> dict:
    """Host numpy tables drawn from ``np.random.default_rng(seed)``.
    (The reference draws from a jax.random key, which numpy cannot
    reproduce; tests hand the same arrays to both packages.)"""
    rng = np.random.default_rng(seed)
    nu = cfg.k_users if cfg.k_users is not None else cfg.n_users
    nv = cfg.k_items if cfg.k_items is not None else cfg.n_items
    return {"user_table": init_codebook(rng, nu, cfg.dim, scale),
            "item_table": init_codebook(rng, nv, cfg.dim, scale)}


def _base_embeddings(params, statics, cfg: LightGCNConfig):
    """Materialize E0 = [Y_u Z_u ; Y_v Z_v] (or the full tables)."""
    if cfg.k_users is not None:
        u_eng, v_eng = engines(cfg)
        u = u_eng.codebook_lookup(params["user_table"], statics["sketch_u"])
        v = v_eng.codebook_lookup(params["item_table"], statics["sketch_v"])
        return u, v
    return params["user_table"], params["item_table"]


def kernel_edge_ids(edge_v, edge_u_byitem) -> dict:
    """``{"edge_v_idx32", "edge_u_byitem_idx32"}``: int32 copies (host
    numpy) of the statics' edge ids, as the propagation kernel reads
    them. Every statics dict carries them (``sorted_edge_statics``,
    ``serve.session._pad_state``), so state whose edges are rewritten in
    place has its kernel ids rewritten with them."""
    return {"edge_v_idx32": np.asarray(edge_v).astype(np.int32),
            "edge_u_byitem_idx32": np.asarray(edge_u_byitem).astype(np.int32)}


def _kernel_edges(statics):
    """(user side, item side) of one layer, each (idx int32, weight,
    indptr): the user side sums item rows over the user-sorted edges, the
    item side user rows over the item-sorted edges."""
    return ((statics["edge_v_idx32"], statics["edge_norm"],
             statics["indptr_u"]),
            (statics["edge_u_byitem_idx32"], statics["edge_norm_byitem"],
             statics["indptr_v"]))


def _wsum(src, side):
    idx, w, ptr = side
    return csr_gather_sum(src, idx, ptr, w)


class _Propagate(torch.autograd.Function):
    """One scatter-free LightGCN layer (cu, cv) -> (nu, nv) (port of the
    reference's ``_make_propagate``, ``repro/models/lightgcn.py:154-183``).

    nu[u] = Σ_{edges e of u} w_e cv[v_e] and nv[v] = Σ_{edges e of v}
    w_e cu[u_e], each over its side's sorted edges. The adjoint of "sum
    over edges into user" is "sum over edges into item": the backward is
    the same weighted sums under the opposite orientation, and saves
    nothing but the statics."""

    @staticmethod
    def forward(ctx, cu, cv, statics):
        user_side, item_side = _kernel_edges(statics)
        ctx.sides = (user_side, item_side)
        return (_wsum(cv.contiguous(), user_side),
                _wsum(cu.contiguous(), item_side))

    @staticmethod
    @once_differentiable
    def backward(ctx, gnu, gnv):
        user_side, item_side = ctx.sides
        d_cv = _wsum(gnu.contiguous(), item_side)
        d_cu = _wsum(gnv.contiguous(), user_side)
        return d_cu, d_cv, None


def _layers(u, v, statics, cfg: LightGCNConfig, edge_group=None):
    """The mean of the K+1 layer outputs from base embeddings (u, v).
    ``edge_group``: the ranks the statics' edges are split over (each
    layer's partial sums are summed over them)."""
    acc_u, acc_v = u, v
    cu, cv = u, v
    for _ in range(cfg.n_layers):
        cu, cv = _Propagate.apply(par.copy_to(cu, edge_group),
                                  par.copy_to(cv, edge_group), statics)
        cu = par.reduce_from(cu, edge_group)
        cv = par.reduce_from(cv, edge_group)
        acc_u = acc_u + cu
        acc_v = acc_v + cv
    k = cfg.n_layers + 1
    return acc_u / k, acc_v / k


def all_embeddings(params, statics, cfg: LightGCNConfig):
    """LightGCN propagation; returns (U [n_users,d], V [n_items,d])."""
    u, v = _base_embeddings(params, statics, cfg)
    return _layers(u, v, statics, cfg)


def _rows(table, ids):
    """table[ids] through the codebook_lookup kernel (H = 1), whose
    backward sums the cotangent rows in the reference's order with the
    CSR gather-sum: deterministic, where the backward of plain indexing
    on a GPU accumulates in no fixed order. ``ids`` must lie in range
    (the samplers draw them so); nothing checks it, as a check would
    wait on the host."""
    return _CodebookSum.apply(table, ids.reshape(-1, 1).int(), False)


def bpr_loss_fn(params, statics, batch, cfg: LightGCNConfig):
    """BPR over (user, pos, neg) with L2 on the *ego* embeddings (port of
    ``repro/models/lightgcn.py:209-227``).

    The propagated and ego tables are concatenated per side so each batch
    index is gathered once (3 gathers: [U_all | U0] and [V_all | V0]); the
    ego half carries the regulariser. The base embeddings are computed
    once and feed both halves (the reference looks them up twice; the
    values are the same). On a mesh: the module docstring."""
    g = par.current_groups()
    edge_group = None
    if g is not None:
        params = {k: par.gather_rows(t, g.rows[k]) for k, t in params.items()}
        statics = dict(statics, **{k: par.gather_rows(statics[k], g.rows[k])
                                   for k in ("sketch_u", "sketch_v")
                                   if k in statics})
        edge_group = g.rows["edge_u"].group
    u0, v0 = _base_embeddings(params, statics, cfg)
    u_all, v_all = _layers(u0, v0, statics, cfg, edge_group)
    d = cfg.dim
    ucat = torch.cat([u_all, u0], dim=1)
    vcat = torch.cat([v_all, v0], dim=1)
    if g is not None:
        ucat = par.copy_to(ucat, g.data_group)
        vcat = par.copy_to(vcat, g.data_group)
    uu = _rows(ucat, batch["user"])
    pi = _rows(vcat, batch["pos"])
    ni = _rows(vcat, batch["neg"])
    pos = torch.sum(uu[:, :d] * pi[:, :d], dim=-1)
    neg = torch.sum(uu[:, :d] * ni[:, :d], dim=-1)
    loss = -torch.mean(torch.nn.functional.logsigmoid(pos - neg))
    reg = (torch.sum(uu[:, d:] ** 2) + torch.sum(pi[:, d:] ** 2)
           + torch.sum(ni[:, d:] ** 2)) / batch["user"].shape[0]
    loss = loss + cfg.l2 * reg
    return loss if g is None else par.mean_over_data(loss, g)


# ---------------------------------------------------------------------------
# frozen seed twins (port of ``repro/models/lightgcn.py:236-266``): the
# benchmark's "seed host loop" baseline, reached only through the
# ``host_seed`` trainer backend. The reference scatter-adds with
# ``jax.ops.segment_sum`` outside any Pallas kernel, so the faithful port
# is plain ``index_add_`` under autograd, not the CSR gather-sum kernel.
# ---------------------------------------------------------------------------
def all_embeddings_seed(params, statics, cfg: LightGCNConfig):
    """Seed propagation: ``index_add_`` scatter-adds of the weighted
    neighbour rows (frozen)."""
    u, v = _base_embeddings(params, statics, cfg)
    eu, ev, w = statics["edge_u"], statics["edge_v"], statics["edge_norm"]
    acc_u, acc_v = u, v
    cu, cv = u, v
    for _ in range(cfg.n_layers):
        nu = cv.new_zeros(cfg.n_users, cv.shape[1]).index_add(
            0, eu, cv[ev] * w[:, None])
        nv = cu.new_zeros(cfg.n_items, cu.shape[1]).index_add(
            0, ev, cu[eu] * w[:, None])
        cu, cv = nu, nv
        acc_u = acc_u + cu
        acc_v = acc_v + cv
    k = cfg.n_layers + 1
    return acc_u / k, acc_v / k


def bpr_loss_fn_seed(params, statics, batch, cfg: LightGCNConfig):
    """Seed BPR step (frozen): six separate readout gathers by plain
    indexing."""
    u_all, v_all = all_embeddings_seed(params, statics, cfg)
    uu = u_all[batch["user"]]
    pi = v_all[batch["pos"]]
    ni = v_all[batch["neg"]]
    pos = torch.sum(uu * pi, dim=-1)
    neg = torch.sum(uu * ni, dim=-1)
    loss = -torch.mean(torch.nn.functional.logsigmoid(pos - neg))
    u0, v0 = _base_embeddings(params, statics, cfg)
    reg = (torch.sum(u0[batch["user"]] ** 2) + torch.sum(v0[batch["pos"]] ** 2)
           + torch.sum(v0[batch["neg"]] ** 2)) / batch["user"].shape[0]
    return loss + cfg.l2 * reg


def eval_embeddings(params, statics, cfg: LightGCNConfig, user_ids):
    """(U[user_ids] [m,d], V [n_items,d]) propagated embeddings."""
    u_all, v_all = all_embeddings(params, statics, cfg)
    return u_all[user_ids], v_all


def score_all_items(params, statics, cfg: LightGCNConfig, user_ids):
    """[len(user_ids), n_items] scores (dense)."""
    u, v = eval_embeddings(params, statics, cfg, user_ids)
    return u @ v.T
