"""Synthetic interaction data (a copy of ``repro.data.synthetic``, numpy only).

Configuration-model power-law bipartite graphs with PLANTED co-clusters:
degree distributions like recommendation data, plus collaborative
structure for the clustering to find. The generator is numpy only, so
the same seed gives the same graph here and in the JAX package.

Generator: K* ground-truth co-clusters; each user draws a power-law degree
and samples items from its home cluster w.p. (1 - noise) and uniformly
otherwise, with item popularity power-law within clusters.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.core.graph import BipartiteGraph

__all__ = ["planted_coclusters", "paperlike_dataset", "DATASET_PRESETS"]

# Named presets mirroring Table 3 / Table 10 statistics.
DATASET_PRESETS: Dict[str, dict] = {
    "synth_xs":    dict(n_users=500, n_items=400, avg_deg=8, k_true=24),
    "beauty_s":    dict(n_users=2_236, n_items=1_210, avg_deg=9, k_true=40),
    "gowalla_s":   dict(n_users=2_986, n_items=4_098, avg_deg=34, k_true=60),
    "yelp2018_s":  dict(n_users=3_167, n_items=3_805, avg_deg=49, k_true=60),
    "amazon_s":    dict(n_users=5_264, n_items=9_160, avg_deg=57, k_true=80),
    "beauty":      dict(n_users=22_363, n_items=12_101, avg_deg=9, k_true=120),
    "gowalla":     dict(n_users=29_858, n_items=40_981, avg_deg=34, k_true=200),
    "yelp2018":    dict(n_users=31_668, n_items=38_048, avg_deg=49, k_true=200),
    "amazonbook":  dict(n_users=52_643, n_items=91_599, avg_deg=57, k_true=300),
    "movielens_l": dict(n_users=200_808, n_items=65_032, avg_deg=100, k_true=400),
    "steamgame_l": dict(n_users=500_000, n_items=15_474, avg_deg=3, k_true=300),
}


def planted_coclusters(n_users: int, n_items: int, k_true: int,
                       avg_deg: float, noise: float = 0.15,
                       alpha: float = 1.6, seed: int = 0,
                       ) -> Tuple[BipartiteGraph, np.ndarray, np.ndarray]:
    """Power-law bipartite graph with K* planted co-clusters.

    Returns (graph, true_user_cluster, true_item_cluster).
    """
    rng = np.random.default_rng(seed)
    uc = rng.integers(0, k_true, size=n_users)
    ic = rng.integers(0, k_true, size=n_items)
    # ensure non-empty item clusters
    ic[:k_true] = np.arange(k_true)
    # user degrees ~ truncated zipf with mean avg_deg
    raw = rng.zipf(alpha, size=n_users).astype(np.float64)
    raw = np.minimum(raw, n_items // 2 + 1)
    deg = np.maximum(1, np.round(raw * (avg_deg / raw.mean()))).astype(np.int64)
    deg = np.minimum(deg, max(4, n_items // 4))
    # per-cluster item lists + popularity weights (zipf within the cluster)
    order = np.argsort(ic, kind="stable")
    sorted_ic = ic[order]
    starts = np.searchsorted(sorted_ic, np.arange(k_true), side="left")
    ends = np.searchsorted(sorted_ic, np.arange(k_true), side="right")
    pop = 1.0 / (1.0 + rng.permutation(n_items))  # global zipf popularity
    edges_u, edges_v = [], []
    for c in range(k_true):
        members = np.flatnonzero(uc == c)
        if members.size == 0:
            continue
        home = order[starts[c]:ends[c]]
        if home.size == 0:
            home = np.arange(n_items)
        w_home = pop[home] / pop[home].sum()
        total = int(deg[members].sum())
        n_in = rng.binomial(total, 1.0 - noise)
        vin = rng.choice(home, size=n_in, p=w_home)
        vout = rng.choice(n_items, size=total - n_in,
                          p=pop / pop.sum())
        v = np.concatenate([vin, vout])
        rng.shuffle(v)
        u = np.repeat(members, deg[members])
        edges_u.append(u)
        edges_v.append(v[:u.size])
    eu = np.concatenate(edges_u)
    ev = np.concatenate(edges_v)
    g = BipartiteGraph.from_edges(n_users, n_items, eu, ev)
    return g, uc.astype(np.int32), ic.astype(np.int32)


def paperlike_dataset(name: str, seed: int = 0):
    """(graph, true_uc, true_ic, train_graph, test_edges) for a preset.

    Split: 90/10 per-user holdout of edges.
    """
    if name not in DATASET_PRESETS:
        raise KeyError(f"unknown preset {name!r}: {sorted(DATASET_PRESETS)}")
    p = DATASET_PRESETS[name]
    g, uc, ic = planted_coclusters(p["n_users"], p["n_items"], p["k_true"],
                                   p["avg_deg"], seed=seed)
    rng = np.random.default_rng(seed + 1)
    mask = rng.random(g.n_edges) < 0.9
    # keep at least one train edge per user
    first_edge = np.zeros(g.n_edges, dtype=bool)
    first_edge[np.unique(g.edge_u, return_index=True)[1]] = True
    mask |= first_edge
    train = BipartiteGraph.from_edges(g.n_users, g.n_items,
                                      g.edge_u[mask], g.edge_v[mask])
    test_edges = (g.edge_u[~mask], g.edge_v[~mask])
    return g, uc, ic, train, test_edges
