"""LightGCN forward (He et al. 2020) over full or codebook tables
(port of ``repro.models.lightgcn``, forward only).

The tables are either the full |U|x d / |V|x d matrices or codebooks
indexed through a frozen sketch (U = Y_u Z_u, V = Y_v Z_v). Propagation
runs over the training graph with symmetric 1/sqrt(d_u d_v) weights; the
final representation is the mean of the K+1 layer outputs.

Propagation is scatter-free, as in the reference: each side is a sorted
run of edges reduced by a prefix sum and a boundary difference
(``_segsum_sorted``). ``index_add_`` would be shorter, but its float
atomics make the sums differ from run to run on a GPU; the prefix sum is
deterministic.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.graph import BipartiteGraph
from repro_torch.core.sketch import Sketch
from repro_torch.device import resolve_device
from repro_torch.embedding import EmbeddingEngine, EmbeddingSpec, init_codebook

__all__ = ["LightGCNConfig", "from_sketch", "engines", "make_statics",
           "sorted_edge_statics", "edge_norms", "init_params", "all_embeddings",
           "eval_embeddings", "score_all_items"]


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
    runs plus both CSR indptrs."""
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
    indptr_v = np.searchsorted(edge_v[perm], np.arange(n_items + 1,
                                                       dtype=np.int64))

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    return {
        "edge_u": t(edge_u, torch.int64),
        "edge_v": t(edge_v, torch.int64),
        "edge_norm": t(edge_norm, torch.float32),
        "edge_u_byitem": t(edge_u[perm], torch.int64),
        "edge_norm_byitem": t(edge_norm[perm], torch.float32),
        "indptr_u": t(indptr_u, torch.int64),
        "indptr_v": t(indptr_v, torch.int64),
    }


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


def _segsum_sorted(data_t, indptr):
    """Segment sum of sorted runs: prefix sum + boundary difference.
    data_t [d, E] holds the E edge rows as columns, grouped into
    len(indptr)-1 contiguous runs; returns [d, len(indptr)-1].

    The scan runs along the contiguous (last) axis: PyTorch's CUDA scan
    along the leading axis of an [E, d] tensor gives each of the d
    columns one thread, which walks all E rows in turn.

    Precision caveat (as in the reference): each segment is a difference
    of two global prefix values, so its absolute error scales with the
    running-sum magnitude (~eps * |prefix|) rather than the segment's.
    For zero-mean embedding columns the prefix is a random walk
    (~sqrt(E) * scale), harmless at the repo's dataset scales; at 1e8+
    edges rebase the scan per chunk or scan in f64. The prefix sum's
    order also differs from the reference's tree scan, so results agree
    to a tolerance, not bitwise.
    """
    c = torch.cumsum(torch.nn.functional.pad(data_t, (1, 0)), dim=1)
    return c[:, indptr[1:]] - c[:, indptr[:-1]]


def all_embeddings(params, statics, cfg: LightGCNConfig):
    """LightGCN propagation; returns (U [n_users,d], V [n_items,d]).

    Layers run on transposed [d, n] embeddings, so each edge gather and
    each prefix sum walks contiguous memory."""
    u, v = _base_embeddings(params, statics, cfg)
    ev_u, w_u = statics["edge_v"], statics["edge_norm"]
    eu_i, w_i = statics["edge_u_byitem"], statics["edge_norm_byitem"]
    iu, iv = statics["indptr_u"], statics["indptr_v"]
    cu, cv = u.T.contiguous(), v.T.contiguous()
    acc_u, acc_v = cu, cv
    for _ in range(cfg.n_layers):
        cu, cv = (_segsum_sorted(cv[:, ev_u] * w_u, iu),
                  _segsum_sorted(cu[:, eu_i] * w_i, iv))
        acc_u = acc_u + cu
        acc_v = acc_v + cv
    k = cfg.n_layers + 1
    return (acc_u / k).T.contiguous(), (acc_v / k).T.contiguous()


def eval_embeddings(params, statics, cfg: LightGCNConfig, user_ids):
    """(U[user_ids] [m,d], V [n_items,d]) propagated embeddings."""
    u_all, v_all = all_embeddings(params, statics, cfg)
    return u_all[user_ids], v_all


def score_all_items(params, statics, cfg: LightGCNConfig, user_ids):
    """[len(user_ids), n_items] scores (dense)."""
    u, v = eval_embeddings(params, statics, cfg, user_ids)
    return u @ v.T
