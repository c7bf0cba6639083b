"""Paper-faithful sequential solver — Algorithm 1 verbatim (CPU / numpy);
a copy of ``repro.core.solver_numpy``.

Asynchronous greedy sweep: nodes are visited in order, each immediately
adopts the best label among its neighbors' labels and its own, and the
global cluster weight sums (f64) are updated incrementally in O(1) per
move (§4.6). The side-synchronous solver in ``solver_torch`` is checked
against it for the objective, not the labels: the visit order differs by
design.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .graph import BipartiteGraph

__all__ = ["lp_solve_sequential"]


def lp_solve_sequential(graph: BipartiteGraph, w_users: np.ndarray,
                        w_items: np.ndarray, gamma: float,
                        budget: int | None = None, max_iters: int = 8,
                        init_labels: np.ndarray | None = None,
                        ) -> Tuple[np.ndarray, int]:
    """Algorithm 1. Returns (labels int32[n_nodes] shared id space, iters).

    init_labels warm-starts the sweep from a previous partition (e.g. the
    neighbouring gamma grid point in fit_gamma) instead of singletons.
    """
    nu, nv = graph.n_users, graph.n_items
    n = nu + nv
    u_indptr, u_nbrs = graph.user_csr()     # user -> item neighbors
    v_indptr, v_nbrs = graph.item_csr()     # item -> user neighbors
    if init_labels is None:
        labels = np.arange(n, dtype=np.int64)
    else:
        labels = np.asarray(init_labels, np.int64).copy()
    # global per-label weight sums, updated incrementally on every move
    w_u_by_label = np.zeros(n, dtype=np.float64)
    np.add.at(w_u_by_label, labels[:nu], w_users)
    w_v_by_label = np.zeros(n, dtype=np.float64)
    np.add.at(w_v_by_label, labels[nu:], w_items)

    gamma = float(gamma)
    it = 0
    for it in range(1, max_iters + 1):
        moved = 0
        # ---- users (Eq. 13) ------------------------------------------------
        for i in range(nu):
            nbrs = u_nbrs[u_indptr[i]:u_indptr[i + 1]]
            if nbrs.size == 0:
                continue
            nbr_labels = labels[nu + nbrs]
            cand, cnt = np.unique(nbr_labels, return_counts=True)
            own = labels[i]
            scores = cnt - gamma * w_users[i] * w_v_by_label[cand]
            own_score = (cnt[cand == own].sum()
                         - gamma * w_users[i] * w_v_by_label[own])
            j = int(np.argmax(scores))
            if scores[j] > own_score:
                w_u_by_label[own] -= w_users[i]
                labels[i] = cand[j]
                w_u_by_label[cand[j]] += w_users[i]
                moved += 1
        # ---- items (Eq. 14) ------------------------------------------------
        for j in range(nv):
            nbrs = v_nbrs[v_indptr[j]:v_indptr[j + 1]]
            if nbrs.size == 0:
                continue
            nbr_labels = labels[nbrs]
            cand, cnt = np.unique(nbr_labels, return_counts=True)
            own = labels[nu + j]
            scores = cnt - gamma * w_items[j] * w_u_by_label[cand]
            own_score = (cnt[cand == own].sum()
                         - gamma * w_items[j] * w_u_by_label[own])
            i2 = int(np.argmax(scores))
            if scores[i2] > own_score:
                w_v_by_label[own] -= w_items[j]
                labels[nu + j] = cand[i2]
                w_v_by_label[cand[i2]] += w_items[j]
                moved += 1
        if moved == 0:
            break
        # budget check AFTER the sweep (matches solver_jax): a warm-start
        # seed already within budget must still feel this gamma at least
        # once, else the whole grid collapses onto the seed partition
        if budget is not None:
            ku = np.unique(labels[:nu]).size
            kv = np.unique(labels[nu:]).size
            if ku + kv <= budget:
                break
    return labels.astype(np.int32), it
