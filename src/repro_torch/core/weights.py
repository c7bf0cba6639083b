"""Node weighting schemes (a copy of ``repro.core.weights``, numpy only).

Table 2 of the paper: every classic method is (gamma, w_u, w_v, solver).
The weights parameterize the volume-balance penalty
    p(k) = (#edges into cluster k) - gamma * w_self * W_other_side(k).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .graph import BipartiteGraph

__all__ = ["make_weights", "WEIGHT_SCHEMES"]

WEIGHT_SCHEMES = (
    "hws",          # BACO: w_u = d(u)/sqrt|E|,  w_v = 1/sqrt|V|
    "modularity",   # Louvain/Leiden/LPAb: w = d(x)/sqrt|E| on both sides
    "cpm",          # constant 1 on both sides
    "reverse_hws",  # ablation: w_u = 1/sqrt|U|, w_v = d(v)/sqrt|E|
    "uniform_norm", # 1/sqrt|U| and 1/sqrt|V| (scale-free CPM)
)


def make_weights(graph: BipartiteGraph, scheme: str) -> Tuple[np.ndarray, np.ndarray]:
    """Return (w_users float64[|U|], w_items float64[|V|])."""
    e = max(graph.n_edges, 1)
    du = graph.user_degrees().astype(np.float64)
    dv = graph.item_degrees().astype(np.float64)
    if scheme == "hws":
        return du / np.sqrt(e), np.full(graph.n_items, 1.0 / np.sqrt(max(graph.n_items, 1)))
    if scheme == "modularity":
        return du / np.sqrt(e), dv / np.sqrt(e)
    if scheme == "cpm":
        return np.ones(graph.n_users), np.ones(graph.n_items)
    if scheme == "reverse_hws":
        return (np.full(graph.n_users, 1.0 / np.sqrt(max(graph.n_users, 1))),
                dv / np.sqrt(e))
    if scheme == "uniform_norm":
        return (np.full(graph.n_users, 1.0 / np.sqrt(max(graph.n_users, 1))),
                np.full(graph.n_items, 1.0 / np.sqrt(max(graph.n_items, 1))))
    raise ValueError(f"unknown weighting scheme {scheme!r}; options: {WEIGHT_SCHEMES}")
