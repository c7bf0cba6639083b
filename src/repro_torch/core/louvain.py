"""Louvain for the unified balanced co-clustering objective (Eq. 9); a
copy of ``repro.core.louvain``.

This is the GraphHash [56] baseline family: greedy local moves + graph
aggregation, optimizing  Σ_ij (B_ij − γ·w_i·w_j)·δ(i,j)  with the chosen
weighting scheme (modularity weights → classic bipartite Louvain; cpm
weights → CPM-Louvain). Pure numpy, host-side preprocessing.

Known limitation reproduced on purpose: the aggregation phase merges small
clusters, exhibiting the resolution limit the paper targets (§4.4 Remark).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .graph import BipartiteGraph

__all__ = ["louvain_solve"]


def _local_moves(nu, nv, u_indptr, u_nbrs, u_w_edges, v_indptr, v_nbrs,
                 v_w_edges, wu, wv, gamma, labels, max_sweeps=8):
    """Greedy sweeps over a (possibly aggregated) bipartite multigraph."""
    n = nu + nv
    w_u_by_label = np.bincount(labels[:nu], weights=wu, minlength=n)
    w_v_by_label = np.bincount(labels[nu:], weights=wv, minlength=n)
    for _ in range(max_sweeps):
        moved = 0
        for i in range(nu):
            sl = slice(u_indptr[i], u_indptr[i + 1])
            nbrs, wts = u_nbrs[sl], u_w_edges[sl]
            if nbrs.size == 0:
                continue
            nbr_labels = labels[nu + nbrs]
            cand, inv = np.unique(nbr_labels, return_inverse=True)
            cnt = np.bincount(inv, weights=wts)
            own = labels[i]
            scores = cnt - gamma * wu[i] * w_v_by_label[cand]
            own_score = (cnt[cand == own].sum()
                         - gamma * wu[i] * w_v_by_label[own])
            j = int(np.argmax(scores))
            if scores[j] > own_score + 1e-12:
                labels[i] = cand[j]
                moved += 1
        for j in range(nv):
            sl = slice(v_indptr[j], v_indptr[j + 1])
            nbrs, wts = v_nbrs[sl], v_w_edges[sl]
            if nbrs.size == 0:
                continue
            nbr_labels = labels[nbrs]
            cand, inv = np.unique(nbr_labels, return_inverse=True)
            cnt = np.bincount(inv, weights=wts)
            own = labels[nu + j]
            scores = cnt - gamma * wv[j] * w_u_by_label[cand]
            own_score = (cnt[cand == own].sum()
                         - gamma * wv[j] * w_u_by_label[own])
            i2 = int(np.argmax(scores))
            if scores[i2] > own_score + 1e-12:
                labels[nu + j] = cand[i2]
                moved += 1
        w_u_by_label = np.bincount(labels[:nu], weights=wu, minlength=n)
        w_v_by_label = np.bincount(labels[nu:], weights=wv, minlength=n)
        if moved == 0:
            break
    return labels


def louvain_solve(graph: BipartiteGraph, wu: np.ndarray, wv: np.ndarray,
                  gamma: float, max_levels: int = 5,
                  ) -> Tuple[np.ndarray, int]:
    """Returns (labels int32[n_nodes] shared id space, levels run)."""
    nu, nv = graph.n_users, graph.n_items
    # level-0 multigraph = the input graph with unit edge weights
    eu = graph.edge_u.astype(np.int64)
    ev = graph.edge_v.astype(np.int64)
    ew = np.ones(eu.shape[0], dtype=np.float64)
    cur_wu, cur_wv = wu.astype(np.float64), wv.astype(np.float64)
    # mapping from original nodes to current super-nodes (per side)
    map_u = np.arange(nu, dtype=np.int64)
    map_v = np.arange(nv, dtype=np.int64)
    levels = 0
    for levels in range(1, max_levels + 1):
        cnu, cnv = cur_wu.shape[0], cur_wv.shape[0]
        # CSR both ways for the multigraph
        o_u = np.argsort(eu, kind="stable")
        o_v = np.argsort(ev, kind="stable")
        u_indptr = np.zeros(cnu + 1, np.int64)
        np.cumsum(np.bincount(eu, minlength=cnu), out=u_indptr[1:])
        v_indptr = np.zeros(cnv + 1, np.int64)
        np.cumsum(np.bincount(ev, minlength=cnv), out=v_indptr[1:])
        labels = np.arange(cnu + cnv, dtype=np.int64)
        labels = _local_moves(cnu, cnv, u_indptr, ev[o_u], ew[o_u],
                              v_indptr, eu[o_v], ew[o_v],
                              cur_wu, cur_wv, gamma, labels)
        lu, lv = labels[:cnu], labels[cnu:]
        uniq_u, new_u = np.unique(lu, return_inverse=True)
        uniq_v, new_v = np.unique(lv, return_inverse=True)
        if uniq_u.size == cnu and uniq_v.size == cnv:
            break  # no merges -> converged
        # aggregate: same-label user(item) super-nodes merge; BUT user and
        # item super-nodes sharing a label stay linked only through edges.
        map_u = new_u[map_u]
        map_v = new_v[map_v]
        # merge parallel edges
        key = new_u[eu] * np.int64(uniq_v.size) + new_v[ev]
        skey, inv = np.unique(key, return_inverse=True)
        ew = np.bincount(inv, weights=ew)
        eu = skey // uniq_v.size
        ev = skey % uniq_v.size
        cur_wu = np.bincount(new_u, weights=cur_wu)
        cur_wv = np.bincount(new_v, weights=cur_wv)
        # keep cross-side co-membership: encode shared labels by re-running
        # moves at the next level (labels reset to singletons of supernodes).
    # produce final labels in the ORIGINAL shared id space; user cluster c
    # and item cluster c' co-labelled iff they were merged into the same
    # label at the last level with cross-side alignment pass below.
    nu2, nv2 = cur_wu.shape[0], cur_wv.shape[0]
    # final alignment: one LP-style pass assigning each item supernode to
    # the user-side label it connects to most (ties the two sides' ids).
    final = np.concatenate([np.arange(nu2, dtype=np.int64),
                            np.arange(nv2, dtype=np.int64) + nu2])
    o_u = np.argsort(eu, kind="stable")
    o_v = np.argsort(ev, kind="stable")
    u_indptr = np.zeros(nu2 + 1, np.int64)
    np.cumsum(np.bincount(eu, minlength=nu2), out=u_indptr[1:])
    v_indptr = np.zeros(nv2 + 1, np.int64)
    np.cumsum(np.bincount(ev, minlength=nv2), out=v_indptr[1:])
    final = _local_moves(nu2, nv2, u_indptr, ev[o_u], ew[o_u],
                         v_indptr, eu[o_v], ew[o_v],
                         cur_wu, cur_wv, gamma, final, max_sweeps=2)
    out = np.empty(nu + nv, dtype=np.int32)
    out[:nu] = final[map_u]
    out[nu:] = final[nu2 + map_v]
    return out, levels
