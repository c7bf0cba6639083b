"""Synthetic interaction data (a copy of ``repro.data.synthetic``, numpy only).

Configuration-model power-law bipartite graphs with PLANTED co-clusters:
degree distributions like recommendation data, plus collaborative
structure for the clustering to find. The generator is numpy only, so
the same seed gives the same graph here and in the JAX package.

Generator: K* ground-truth co-clusters; each user draws a power-law degree
and samples items from its home cluster w.p. (1 - noise) and uniformly
otherwise, with item popularity power-law within clusters.
``drifting_coclusters`` is the streaming workload: a warm prefix, then
waves of arriving users and items while memberships drift; it draws
exactly as the reference does, so a seed gives the same stream bitwise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.graph import BipartiteGraph

__all__ = ["planted_coclusters", "paperlike_dataset", "drifting_coclusters",
           "DriftStream", "StreamStep", "DATASET_PRESETS"]

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


# ---------------------------------------------------------------------------
# drifting planted co-clusters: the streaming workload generator
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StreamStep:
    """One event batch of a drift stream. New users occupy ids
    [n_users_before, n_users_before + n_new_users) (items likewise), so
    arrivals are always index suffixes — the layout StreamingGraph.grow
    and the cold-start assigner expect."""

    n_new_users: int
    n_new_items: int
    edge_u: np.ndarray
    edge_v: np.ndarray


@dataclasses.dataclass(frozen=True)
class DriftStream:
    """A planted-co-cluster interaction stream whose memberships
    migrate. ``base`` holds the warm prefix; replaying ``steps`` on top
    of it reproduces the full graph of every interaction."""

    n_users: int                 # final totals after all arrivals
    n_items: int
    n_warm_users: int            # sizes of the warm (t=0) prefix
    n_warm_items: int
    base: BipartiteGraph
    steps: Tuple[StreamStep, ...]
    true_uc: np.ndarray          # final ground-truth memberships
    true_ic: np.ndarray

    def full_edges(self) -> Tuple[np.ndarray, np.ndarray]:
        """Union of the base graph and every step's interactions."""
        eu = [self.base.edge_u] + [s.edge_u for s in self.steps]
        ev = [self.base.edge_v] + [s.edge_v for s in self.steps]
        return np.concatenate(eu), np.concatenate(ev)


def _step_rng(seed: int, t: int) -> np.random.Generator:
    """Per-step generator keyed by SeedSequence([seed, t]) — the same
    aliasing-proof spawning discipline as the BPR sampler's
    (seed, step) keying; streams with different seeds share no step
    streams even at equal t."""
    return np.random.default_rng(np.random.SeedSequence([seed, t]))


def _draw_cluster_edges(rng, users, uc, deg, n_items_avail, ic, pop,
                        noise):
    """Interactions for ``users``: each draws deg[u] items, preferring
    its home cluster w.p. (1 - noise), among the first
    ``n_items_avail`` items (the ones that exist yet)."""
    eu_out: List[np.ndarray] = []
    ev_out: List[np.ndarray] = []
    ic_avail = ic[:n_items_avail]
    pop_avail = pop[:n_items_avail] / pop[:n_items_avail].sum()
    for c in np.unique(uc[users]):
        us = users[uc[users] == c]
        home = np.flatnonzero(ic_avail == c)
        if home.size == 0:
            home = np.arange(n_items_avail)
        w_home = pop[home] / pop[home].sum()
        total = int(deg[us].sum())
        if total == 0:
            continue
        n_in = int(rng.binomial(total, 1.0 - noise))
        vin = rng.choice(home, size=n_in, p=w_home)
        vout = rng.choice(n_items_avail, size=total - n_in, p=pop_avail)
        v = np.concatenate([vin, vout])
        rng.shuffle(v)
        u = np.repeat(us, deg[us])
        eu_out.append(u)
        ev_out.append(v[:u.size])
    if not eu_out:
        return (np.empty(0, np.int64), np.empty(0, np.int64))
    return np.concatenate(eu_out), np.concatenate(ev_out)


def drifting_coclusters(n_users: int, n_items: int, k_true: int,
                        avg_deg: float, T: int = 6, *, warm: float = 0.6,
                        drift: float = 0.08, revisit: float = 0.25,
                        noise: float = 0.15, alpha: float = 1.6,
                        seed: int = 0) -> DriftStream:
    """Planted co-clusters under drift: the stream bench workload.

    A ``warm`` fraction of users/items exists at t=0 (the ``base``
    graph a deployment would cluster + train on); the rest arrive in T
    equal waves. Each step, a ``drift`` fraction of existing users
    migrates to a fresh random cluster, a ``revisit`` fraction of
    existing users emits new interactions under its CURRENT membership
    (so drifted tastes show up in the data), every arriving user draws
    a full degree's worth of interactions, and every arriving item is
    seeded with one interaction from its home cluster so no item
    enters the universe unreferenced.

    Determinism: step t draws from ``SeedSequence([seed, t])`` — equal
    seeds reproduce the stream bitwise; different seeds share nothing.
    """
    if not 0 < warm <= 1:
        raise ValueError(f"warm fraction must be in (0, 1], got {warm}")
    rng0 = _step_rng(seed, 0)
    uc = rng0.integers(0, k_true, size=n_users)
    ic = rng0.integers(0, k_true, size=n_items)
    n_warm_u = max(1, int(round(warm * n_users)))
    n_warm_v = max(k_true, int(round(warm * n_items)))
    if n_warm_v > n_items:
        raise ValueError(f"need n_items >= k_true/warm: {n_items} items, "
                         f"{k_true} clusters, warm={warm}")
    ic[:k_true] = np.arange(k_true)       # warm prefix covers every cluster
    raw = rng0.zipf(alpha, size=n_users).astype(np.float64)
    raw = np.minimum(raw, n_items // 2 + 1)
    deg = np.maximum(1, np.round(raw * (avg_deg / raw.mean()))
                     ).astype(np.int64)
    deg = np.minimum(deg, max(4, n_items // 4))
    pop = 1.0 / (1.0 + rng0.permutation(n_items))
    eu, ev = _draw_cluster_edges(rng0, np.arange(n_warm_u), uc, deg,
                                 n_warm_v, ic, pop, noise)
    base = BipartiteGraph.from_edges(n_warm_u, n_warm_v, eu, ev)

    cu, cv = n_warm_u, n_warm_v
    waves_u = np.diff(np.linspace(n_warm_u, n_users, T + 1).astype(int))
    waves_v = np.diff(np.linspace(n_warm_v, n_items, T + 1).astype(int))
    steps = []
    for t in range(1, T + 1):
        rng = _step_rng(seed, t)
        du, dv = int(waves_u[t - 1]), int(waves_v[t - 1])
        # membership drift among existing users
        n_drift = int(round(drift * cu))
        if n_drift:
            drifters = rng.choice(cu, size=n_drift, replace=False)
            uc[drifters] = rng.integers(0, k_true, size=n_drift)
        new_cu, new_cv = cu + du, cv + dv
        parts_u: List[np.ndarray] = []
        parts_v: List[np.ndarray] = []
        # arrivals interact immediately (items up to new_cv exist now)
        if du:
            au, av = _draw_cluster_edges(rng, np.arange(cu, new_cu), uc,
                                         deg, new_cv, ic, pop, noise)
            parts_u.append(au)
            parts_v.append(av)
        # each arriving item gets one seed interaction from its cluster
        if dv:
            items = np.arange(cv, new_cv)
            pick_u = np.empty(dv, np.int64)
            for j, it in enumerate(items):
                members = np.flatnonzero(uc[:new_cu] == ic[it])
                pick_u[j] = (rng.choice(members) if members.size
                             else rng.integers(0, new_cu))
            parts_u.append(pick_u)
            parts_v.append(items)
        # existing users revisit under their CURRENT (drifted) clusters
        n_back = int(round(revisit * cu))
        if n_back:
            backs = rng.choice(cu, size=n_back, replace=False)
            bdeg = np.maximum(1, deg // 3)
            bu, bv = _draw_cluster_edges(rng, backs, uc, bdeg, new_cv, ic,
                                         pop, noise)
            parts_u.append(bu)
            parts_v.append(bv)
        steps.append(StreamStep(
            du, dv,
            np.concatenate(parts_u) if parts_u else np.empty(0, np.int64),
            np.concatenate(parts_v) if parts_v else np.empty(0, np.int64)))
        cu, cv = new_cu, new_cv
    return DriftStream(n_users, n_items, n_warm_u, n_warm_v, base,
                       tuple(steps), uc.astype(np.int32),
                       ic.astype(np.int32))


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
