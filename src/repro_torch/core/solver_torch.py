"""Side-synchronous label propagation in PyTorch (port of
``repro.core.solver_jax``: ``_half_step``, ``lp_step``, ``solve_loop``,
``lp_solve`` and ``lp_solve_grid``).

Each node adopts the neighbor label maximizing

    p(k) = |N(x) ∩ C_k|  -  gamma * w_x * W_other(k)            (Eq. 13/14)

updating all users (item labels fixed), then all items (user labels
fixed). The labels must equal the reference's bit for bit, so every
floating-point step keeps the reference's arithmetic:

  * grouping by (node, candidate label) sorts ONE int64 key
    ``node * (n_labels + 1) + label`` (the reference's two-key
    ``lax.sort``); group sizes come from cummax/cummin boundaries
    (exact integers);
  * the score ``cnt - (gamma * w_self) * w_other`` is one fused
    multiply-add on the reference's CPU backend (XLA contracts it), so
    :func:`fma_sub` rounds it once, exactly as an FMA does;
  * the segmented leftmost argmax is the per-node max, then the minimum
    label among the maximizers (both order-free, so deterministic);
  * the per-label weight sums W(k) are f32 left folds in index order —
    what XLA's serial scatter-add computes — by
    :func:`segment_sum_ordered`, deterministic on any device (no two
    additions into one sum race).

The reference runs the sweep loop on the device (``lax.while_loop``).
Here it is a host loop: each sweep reads its convergence and budget
checks back to the host (one sync), and each ordered segment sum reads
its fold depth (one sync). Callers pass a ``stats`` dict and get
``sweeps`` and ``host_syncs`` counted into it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

from .graph import BipartiteGraph

__all__ = ["lp_solve", "lp_solve_grid", "lp_step", "count_side_labels",
           "solve_loop", "fma_sub", "segment_sum_ordered",
           "device_edges", "device_inputs"]

_NEG = -3e38


def _bump(stats: Optional[dict], key: str, n: int = 1) -> None:
    if stats is not None:
        stats[key] = stats.get(key, 0) + int(n)


def fma_sub(x: torch.Tensor, y: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """``c - x * y`` for f32 tensors, rounded ONCE to f32 (a fused
    multiply-add), as XLA's CPU backend computes the reference's score.

    ``x * y`` is exact in f64 (two 24-bit significands). ``c - x*y`` in
    f64 is rounded, and rounding that again to f32 could differ from a
    single rounding, so the f64 difference is rounded to odd first (the
    exact TwoSum error says whether it was inexact, and which way): a
    round-to-odd result with 29 spare bits rounds correctly to f32.
    """
    p = x.double() * y.double()
    a = c.double()
    s = a - p
    bb = s - a
    err = (a - (s - bb)) + (-p - bb)          # s + err == a - p exactly
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def segment_sum_ordered(values: torch.Tensor, segment_ids: torch.Tensor,
                        num_segments: int,
                        stats: Optional[dict] = None) -> torch.Tensor:
    """f32 sum of ``values`` per segment, each a left fold in index
    order — bitwise ``jax.ops.segment_sum`` on the CPU (a serial
    scatter-add) — and deterministic on a GPU.

    A stable sort groups each segment's entries in index order; step j
    then adds every segment's j-th entry at once. A step adds at most one
    value to each segment, so the order of additions is fixed even where
    ``index_add_`` uses atomics. The loop runs as many steps as the
    largest segment has entries; reading that depth is one sync.
    """
    out = torch.zeros(num_segments, dtype=torch.float32,
                      device=values.device)
    n = int(segment_ids.shape[0])
    if n == 0:
        return out
    order = torch.sort(segment_ids, stable=True).indices
    seg = segment_ids[order]
    pos = torch.arange(n, device=values.device)
    first = torch.ones(n, dtype=torch.bool, device=values.device)
    first[1:] = seg[1:] != seg[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    by_rank = torch.sort(rank, stable=True).indices
    seg = seg[by_rank]
    val = values[order[by_rank]]
    counts = torch.bincount(rank).tolist()
    _bump(stats, "host_syncs")
    lo = 0
    for c in counts:
        out.index_add_(0, seg[lo:lo + c], val[lo:lo + c])
        lo += c
    return out


def _half_step(node_of_edge, cand_lab_of_edge, w_self, w_other_by_label,
               own_labels, gamma, n_side: int, n_labels: int):
    """One parallel half-step for one side of the bipartite graph.

    node_of_edge: int64[E] updating-side endpoint, SORTED ascending.
    cand_lab_of_edge: int64[E] current label of the opposite endpoint.
    w_self: f32[n_side]; w_other_by_label: f32[n_labels];
    own_labels: int64[n_side]; gamma: f32 0-d tensor.
    Returns new labels int64[n_side].
    """
    dev = node_of_edge.device
    e = int(node_of_edge.shape[0])
    if e == 0:
        return own_labels
    stride = n_labels + 1
    key = torch.sort(node_of_edge * stride + cand_lab_of_edge).values
    node_s = key // stride
    lab_s = key % stride
    idx = torch.arange(e, device=dev)
    new_grp = torch.ones(e, dtype=torch.bool, device=dev)
    new_grp[1:] = key[1:] != key[:-1]
    is_last = torch.ones(e, dtype=torch.bool, device=dev)
    is_last[:-1] = new_grp[1:]
    start = torch.cummax(torch.where(new_grp, idx, 0), 0).values
    end = torch.flip(torch.cummin(torch.flip(
        torch.where(is_last, idx, e - 1), (0,)), 0).values, (0,))
    cnt = (end - start + 1).float()
    score = fma_sub(gamma * w_self[node_s], w_other_by_label[lab_s], cnt)
    # leftmost argmax per node == smallest label among the maximizers
    best = torch.full((n_side,), _NEG, dtype=torch.float32, device=dev)
    best = best.scatter_reduce(0, node_s, score, "amax", include_self=False)
    cand = torch.where(score == best[node_s], lab_s,
                       torch.full_like(lab_s, n_labels))
    best_lab = torch.full((n_side,), n_labels, dtype=torch.int64, device=dev)
    best_lab = best_lab.scatter_reduce(0, node_s, cand, "amin")
    # own label is always a candidate: exact integer count per node
    bounds = torch.searchsorted(node_s, torch.arange(n_side + 1, device=dev))
    own_hit = (cand_lab_of_edge == own_labels[node_of_edge]).long()
    cs = torch.zeros(e + 1, dtype=torch.int64, device=dev)
    cs[1:] = torch.cumsum(own_hit, 0)
    own_cnt = (cs[bounds[1:]] - cs[bounds[:-1]]).float()
    own_score = fma_sub(gamma * w_self, w_other_by_label[own_labels], own_cnt)
    move = (best > own_score) & (best_lab < n_labels)
    return torch.where(move, best_lab, own_labels)


def lp_step(labels, inputs, gamma, n_users: int, n_items: int,
            stats: Optional[dict] = None):
    """One full iteration = user half-step then item half-step."""
    eu, ev, eu_byv, ev_byv, wu, wv = inputs
    n = n_users + n_items
    item_labels = labels[n_users:]
    w_items_by_label = segment_sum_ordered(wv, item_labels, n, stats)
    new_u = _half_step(eu, item_labels[ev], wu, w_items_by_label,
                       labels[:n_users], gamma, n_users, n)
    w_users_by_label = segment_sum_ordered(wu, new_u, n, stats)
    new_v = _half_step(ev_byv, new_u[eu_byv], wv, w_users_by_label,
                       item_labels, gamma, n_items, n)
    return torch.cat([new_u, new_v])


def count_side_labels(labels, n_users: int, n_items: int):
    """(#distinct user labels, #distinct item labels) as 0-d tensors."""
    n = n_users + n_items
    pu = torch.zeros(n, dtype=torch.bool, device=labels.device)
    pv = torch.zeros(n, dtype=torch.bool, device=labels.device)
    pu[labels[:n_users]] = True
    pv[labels[n_users:]] = True
    return pu.sum(), pv.sum()


def solve_loop(step, labels, budget: int, max_iters: int, *, n_users: int,
               n_items: int, stats: Optional[dict] = None):
    """Run ``step`` (one sweep, labels -> labels) until the budget is
    met, a fixed point is reached, or ``max_iters`` sweeps ran.

    The reference's ``lax.while_loop`` semantics, as a host loop: the
    sweep that reproduces the previous labels is counted (it is the one
    that detects convergence), and the budget (0 = off) is checked after
    each sweep. Each sweep reads one (K, converged) pair to the host.
    """
    it = 0
    while it < max_iters:
        new = step(labels)
        it += 1
        ku, kv = count_side_labels(new, n_users, n_items)
        k, same = torch.stack([ku + kv,
                               (new == labels).all().long()]).tolist()
        _bump(stats, "sweeps")
        _bump(stats, "host_syncs")
        labels = new
        if (budget > 0 and k <= budget) or same:
            break
    return labels, it


def device_edges(graph: BipartiteGraph, device):
    """(eu, ev, eu_byv, ev_byv) int64 on ``device``, uploaded once per
    graph and device (both sorted orientations of the edge list)."""
    dev = torch.device(device)

    def upload():
        eu = torch.as_tensor(graph.edge_u, dtype=torch.int64, device=dev)
        ev = torch.as_tensor(graph.edge_v, dtype=torch.int64, device=dev)
        perm = torch.as_tensor(graph.perm_by_item, dtype=torch.int64,
                               device=dev)
        return eu, ev, eu[perm], ev[perm]

    return graph._memo(("torch_edges", str(dev)), upload)


def device_inputs(graph: BipartiteGraph, w_users, w_items, device):
    """(eu, ev, eu_byv, ev_byv, wu, wv) on ``device``."""
    dev = torch.device(device)
    wu = torch.as_tensor(np.asarray(w_users, np.float32), device=dev)
    wv = torch.as_tensor(np.asarray(w_items, np.float32), device=dev)
    return (*device_edges(graph, dev), wu, wv)


def _init_labels(graph: BipartiteGraph, init_labels, dev):
    if init_labels is None:
        return torch.arange(graph.n_nodes, dtype=torch.int64, device=dev)
    return torch.as_tensor(np.array(init_labels, dtype=np.int64),
                           device=dev)


def _solve(graph, inputs, gamma, budget, max_iters, lab0, stats):
    g = torch.tensor(gamma, dtype=torch.float32, device=lab0.device)
    nu, ni = graph.n_users, graph.n_items

    def step(labels):
        return lp_step(labels, inputs, g, nu, ni, stats)

    labels, it = solve_loop(step, lab0, 0 if budget is None else int(budget),
                            int(max_iters), n_users=nu, n_items=ni,
                            stats=stats)
    out = labels.to(torch.int32).cpu().numpy()
    _bump(stats, "host_syncs")
    return out, it


def lp_solve(graph: BipartiteGraph, w_users, w_items, gamma: float,
             budget: Optional[int] = None, max_iters: int = 8,
             init_labels=None, *, device="cuda",
             stats: Optional[dict] = None) -> Tuple[np.ndarray, int]:
    """Run side-synchronous LP until label budget met or max_iters.

    Returns (labels int32[n_nodes] in the shared id space, iters_run).
    Labels are NOT compacted; use Sketch/compact_labels downstream.
    """
    dev = resolve_device(device)
    inputs = device_inputs(graph, w_users, w_items, dev)
    return _solve(graph, inputs, float(gamma), budget, max_iters,
                  _init_labels(graph, init_labels, dev), stats)


def lp_solve_grid(graph: BipartiteGraph, w_users, w_items, gammas,
                  budget: Optional[int] = None, max_iters: int = 8,
                  init_labels=None, *, device="cuda",
                  stats: Optional[dict] = None):
    """Solve a gamma grid, one lane after another.

    gammas: float[L]. init_labels: None (singletons), [n] (one seed for
    every lane) or [L, n] (per-lane seeds). Each lane is exactly the
    single-lane solve (the reference's vmapped lanes are too).
    Returns (labels int32[L, n_nodes], iters int32[L]).
    """
    dev = resolve_device(device)
    inputs = device_inputs(graph, w_users, w_items, dev)
    init = None if init_labels is None else np.asarray(init_labels)
    labs, its = [], []
    for i, g in enumerate(np.asarray(gammas, np.float32).tolist()):
        seed = init[i] if init is not None and init.ndim == 2 else init
        lab, it = _solve(graph, inputs, g, budget, max_iters,
                         _init_labels(graph, seed, dev), stats)
        labs.append(lab)
        its.append(it)
    return np.stack(labs), np.asarray(its, np.int32)
