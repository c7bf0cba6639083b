"""Uniform fanout neighbor sampler, GraphSAGE-style (port of
``repro.data.neighbor_sampler``, numpy only): the ``minibatch_lg`` GNN
cell's batches come from it.

Given a CSR adjacency and seed nodes, sample `fanout[h]` neighbors per
node per hop, building the union subgraph with relabeled node ids. Edges
point child -> parent (message flows toward seeds), matching SchNet's
(src=neighbor, dst=receiver) segment sum. Given the same seed, both
functions return bitwise what the reference's return.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

__all__ = ["sample_subgraph", "random_regular_csr"]


def random_regular_csr(n_nodes: int, avg_deg: int, seed: int = 0):
    """Synthetic CSR adjacency for sampler tests/benchmarks."""
    rng = np.random.default_rng(seed)
    deg = np.maximum(1, rng.poisson(avg_deg, n_nodes))
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, n_nodes, indptr[-1]).astype(np.int64)
    return indptr, indices


def sample_subgraph(indptr: np.ndarray, indices: np.ndarray,
                    seeds: np.ndarray, fanout: Sequence[int],
                    seed: int = 0,
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (node_ids, edge_src, edge_dst) with LOCAL indices.

    node_ids[0:len(seeds)] are the seeds; edge_src/edge_dst index into
    node_ids. Sampling is WITH replacement (standard GraphSAGE), so the
    subgraph sizes are exactly len(seeds)*prod-prefix(fanout) — static
    shapes, which the train step requires.
    """
    rng = np.random.default_rng(seed)
    node_list = [np.asarray(seeds, dtype=np.int64)]
    local_of = {int(g): i for i, g in enumerate(node_list[0])}
    edge_src_l, edge_dst_l = [], []
    frontier = node_list[0]
    frontier_local = np.arange(len(frontier))
    for f in fanout:
        deg = indptr[frontier + 1] - indptr[frontier]
        # sample f neighbors per frontier node (with replacement; nodes
        # without neighbors self-loop)
        offs = rng.integers(0, np.maximum(deg, 1)[:, None],
                            (len(frontier), f))
        nbr_global = np.where(
            deg[:, None] > 0,
            indices[np.minimum(indptr[frontier][:, None] + offs,
                               indptr[frontier + 1][:, None] - 1)],
            frontier[:, None])
        flat = nbr_global.reshape(-1)
        locals_ = np.empty(flat.shape[0], dtype=np.int64)
        for i, g in enumerate(flat):
            gi = int(g)
            if gi not in local_of:
                local_of[gi] = len(local_of)
            locals_[i] = local_of[gi]
        node_list.append(flat)
        edge_src_l.append(locals_)
        edge_dst_l.append(np.repeat(frontier_local, f))
        frontier = flat
        frontier_local = locals_
    n_local = len(local_of)
    node_ids = np.empty(n_local, dtype=np.int64)
    for g, i in local_of.items():
        node_ids[i] = g
    return (node_ids, np.concatenate(edge_src_l),
            np.concatenate(edge_dst_l))
