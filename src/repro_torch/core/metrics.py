"""Clustering quality metrics used throughout the paper's experiments
(a copy of ``repro.core.metrics``, numpy only).

All metrics operate on labels in the shared id space (or per-side label
arrays) and the BipartiteGraph; they run host-side on the solver's
outputs. The stream layer's refresh selects its gamma probe by
``bipartite_modularity``.
"""
from __future__ import annotations

import numpy as np

from .graph import BipartiteGraph

__all__ = [
    "objective", "intra_edges", "gini", "accl",
    "bipartite_modularity", "bipartite_cpm", "cluster_sizes",
]


def _side_labels(graph: BipartiteGraph, labels: np.ndarray):
    return labels[:graph.n_users], labels[graph.n_users:]


def intra_edges(graph: BipartiteGraph, labels: np.ndarray) -> int:
    """Number of edges whose endpoints share a cluster (Σ_k s_k)."""
    lu, lv = _side_labels(graph, labels)
    return int(np.sum(lu[graph.edge_u] == lv[graph.edge_v]))


def objective(graph: BipartiteGraph, labels: np.ndarray, w_users, w_items,
              gamma: float) -> float:
    """Eq. (9): Σ_k s_k − γ Σ_k W_u(k)·W_v(k) (cross-pair volume form)."""
    lu, lv = _side_labels(graph, labels)
    n = graph.n_nodes
    wu_k = np.bincount(lu, weights=w_users, minlength=n)
    wv_k = np.bincount(lv, weights=w_items, minlength=n)
    return intra_edges(graph, labels) - gamma * float(wu_k @ wv_k)


def cluster_sizes(labels: np.ndarray) -> np.ndarray:
    """Sizes of the distinct clusters present in `labels` (any id space)."""
    _, cnt = np.unique(labels, return_counts=True)
    return cnt


def gini(sizes: np.ndarray) -> float:
    """Gini coefficient of cluster sizes (0 = perfectly balanced)."""
    s = np.sort(np.asarray(sizes, dtype=np.float64))
    k = s.size
    if k == 0 or s.sum() == 0:
        return 0.0
    cum = np.cumsum(s)
    # paper's form: (2/K) Σ_i (i/K − cum_i/total)
    i = np.arange(1, k + 1)
    return float((2.0 / k) * np.sum(i / k - cum / cum[-1]))


def accl(graph: BipartiteGraph, labels: np.ndarray) -> float:
    """Averaged cross-cluster links: inter-cluster edges / C(K,2)."""
    lu, lv = _side_labels(graph, labels)
    inter = graph.n_edges - intra_edges(graph, labels)
    k = np.unique(labels).size
    pairs = k * (k - 1) / 2.0
    return float(inter / pairs) if pairs > 0 else 0.0


def bipartite_modularity(graph: BipartiteGraph, labels: np.ndarray,
                         gamma: float = 1.0) -> float:
    """Barber's bipartite modularity, Eq. (1)."""
    lu, lv = _side_labels(graph, labels)
    e = max(graph.n_edges, 1)
    n = graph.n_nodes
    du_k = np.bincount(lu, weights=graph.user_degrees().astype(np.float64),
                       minlength=n)
    dv_k = np.bincount(lv, weights=graph.item_degrees().astype(np.float64),
                       minlength=n)
    return (intra_edges(graph, labels) - gamma * float(du_k @ dv_k) / e) / e


def bipartite_cpm(graph: BipartiteGraph, labels: np.ndarray,
                  gamma: float = 1.0) -> float:
    """Bipartite Constant Potts Model: Σ_k s_k − γ|U_k||V_k|."""
    lu, lv = _side_labels(graph, labels)
    n = graph.n_nodes
    nu_k = np.bincount(lu, minlength=n).astype(np.float64)
    nv_k = np.bincount(lv, minlength=n).astype(np.float64)
    return intra_edges(graph, labels) - gamma * float(nu_k @ nv_k)
