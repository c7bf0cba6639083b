"""Side-synchronous label propagation in PyTorch (port of
``repro.core.solver_jax``: ``_half_step``, ``lp_step``, ``solve_loop``,
``lp_solve``, ``lp_solve_grid``, the stream layer's ``lp_solve_capped``
and ``lp_cold_assign``, the edge-block streamed solve
``lp_solve_streamed`` and the host-driven ``lp_solve_hostloop``).

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
    additions into one sum race): on a GPU one CSR gather-sum kernel
    launch, on the CPU the plain version.

The reference runs the sweep loop on the device (``lax.while_loop``).
Here it is a host loop: each sweep reads its convergence and budget
checks back to the host (one sync), and each ordered segment sum on the
CPU reads its fold depth (one sync). Callers pass a ``stats`` dict and
get ``sweeps`` and ``host_syncs`` counted into it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.embedding_bag import scatter_rows
from repro_torch.kernels.ref import segment_sum
from repro_torch.obs import clock
from repro_torch.obs.trace import get_tracer

from .graph import BipartiteGraph, pad_rung

__all__ = ["lp_solve", "lp_solve_grid", "lp_solve_capped", "lp_cold_assign",
           "lp_solve_streamed", "lp_solve_hostloop", "lp_step",
           "count_side_labels", "solve_loop", "fma_sub",
           "segment_sum_ordered", "device_edges", "drop_device_edges",
           "device_inputs"]

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
    order from +0.0 — bitwise ``jax.ops.segment_sum`` on the CPU (a
    serial scatter-add).

    On a GPU the values are stably sorted by segment and summed by the
    CSR gather-sum kernel (``scatter_rows``), which folds each segment
    in index order: one launch, no host sync. On the CPU the plain
    version, ``kernels.ref.segment_sum``, adds one rank within every
    segment per step; reading its depth is one sync. Both give the same
    bits.
    """
    if values.device.type == "cuda":
        m = int(segment_ids.shape[0])
        return scatter_rows(values[:, None], segment_ids,
                            torch.arange(m, device=values.device),
                            num_segments)[:, 0]
    if segment_ids.shape[0]:
        _bump(stats, "host_syncs")
    return segment_sum(values, segment_ids, num_segments)


def _group_scores(node_of_edge, cand_lab_of_edge, w_self, w_other_by_label,
                  gamma, n_labels: int):
    """Group edges by (node, candidate label) — one sort of the int64 key
    ``node * (n_labels + 1) + label`` — and score each edge's group:
    ``cnt - (gamma * w_self) * w_other`` rounded once (Eq. 13/14), with
    the group size from cummax/cummin bounds. Returns (node_s, lab_s,
    score), sorted by node, then label."""
    dev = node_of_edge.device
    e = int(node_of_edge.shape[0])
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
    return node_s, lab_s, fma_sub(gamma * w_self[node_s],
                                  w_other_by_label[lab_s], cnt)


def _best_into(best, best_lab, node_s, lab_s, score, n_labels: int) -> None:
    """The leftmost argmax per node (the smallest label among the
    maximizers), written in place into ``best`` (filled with ``_NEG``)
    and ``best_lab`` (filled with ``n_labels``) at the nodes of
    ``node_s``. A node's own previous value is excluded from its max, so
    each node must appear in one call only."""
    best.scatter_reduce_(0, node_s, score, "amax", include_self=False)
    best_lab.scatter_reduce_(0, node_s, torch.where(
        score == best[node_s], lab_s, torch.full_like(lab_s, n_labels)),
        "amin")


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
    node_s, lab_s, score = _group_scores(node_of_edge, cand_lab_of_edge,
                                         w_self, w_other_by_label, gamma,
                                         n_labels)
    best = torch.full((n_side,), _NEG, dtype=torch.float32, device=dev)
    best_lab = torch.full((n_side,), n_labels, dtype=torch.int64, device=dev)
    _best_into(best, best_lab, node_s, lab_s, score, n_labels)
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


def drop_device_edges(graph: BipartiteGraph) -> None:
    """Forget every device's edge lists memoized by :func:`device_edges`
    (a later peak-memory reading then starts without them)."""
    for key in [k for k in graph._cache
                if isinstance(k, tuple) and k and k[0] == "torch_edges"]:
        del graph._cache[key]


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


def lp_solve_capped(graph: BipartiteGraph, w_users, w_items, gamma: float,
                    budget: Optional[int] = None, max_iters: int = 8,
                    init_labels=None, caps: Optional[dict] = None, *,
                    device="cuda", stats: Optional[dict] = None
                    ) -> Tuple[np.ndarray, int]:
    """The reference's ``lp_solve_capped`` signature over ``lp_solve``.

    The reference pads users, items and edges to capacity rungs so that
    a growing graph reuses one compiled program; its real labels are
    bitwise the unpadded solve's. Eager PyTorch compiles nothing, so
    ``caps`` is accepted and ignored and the solve runs unpadded.
    """
    del caps
    return lp_solve(graph, w_users, w_items, gamma, budget, max_iters,
                    init_labels, device=device, stats=stats)


# ---------------------------------------------------------------------------
# cold-start assignment: one half-step over only the new nodes' edges
# ---------------------------------------------------------------------------
def _cold_side(node_tail, opp_tail, opp_labels, w_self_side, own_side,
               w_opp_full, gamma: float, n_new: int, n_labels: int, dev,
               stats: Optional[dict] = None) -> np.ndarray:
    """One half-step for the cold nodes of one side. ``node_tail`` is
    0-based over the ``n_new`` cold nodes and sorted (the cold nodes are
    an index suffix, so their edges are a contiguous tail of that side's
    sorted edge orientation). The cluster weight totals (the
    volume-balance term) fold ALL opposite-side nodes, in index order;
    the sort/scan passes run over the cold nodes' edges only.

    The reference pads each input onto a power-of-two ladder to bound
    its compiles; pads carry weight 0 and a phantom node, so its real
    rows equal this unpadded half-step's."""
    def t(a, dtype):
        return torch.as_tensor(np.asarray(a, dtype), device=dev)

    opp_lab = t(opp_labels, np.int64)
    w_by_label = segment_sum_ordered(t(w_opp_full, np.float32), opp_lab,
                                     n_labels, stats)
    out = _half_step(t(node_tail, np.int64), opp_lab[t(opp_tail, np.int64)],
                     t(w_self_side, np.float32), w_by_label,
                     t(own_side, np.int64),
                     torch.tensor(float(gamma), dtype=torch.float32,
                                  device=dev), n_new, n_labels)
    return out.to(torch.int32).cpu().numpy()


def _cand_edge_mask(node_tail: np.ndarray, edge_lab: np.ndarray,
                    flat: np.ndarray, indptr: np.ndarray,
                    n_labels: int) -> np.ndarray:
    """bool[E_tail]: which cold edges carry a candidate label that
    survives pruning. ``flat``/``indptr`` are per-cold-node candidate
    label lists (CSR over the 0-based cold nodes, labels SORTED within
    each node's slice, as ``core.candidates`` emits them). Membership is
    one searchsorted over fused (node, label) int64 keys."""
    if flat.size == 0 or node_tail.size == 0:
        return np.zeros(node_tail.shape, bool)
    m = np.int64(n_labels) + 1
    reps = np.diff(np.asarray(indptr, np.int64))
    ckeys = np.repeat(np.arange(reps.size, dtype=np.int64), reps) * m \
        + np.asarray(flat, np.int64)
    keys = node_tail.astype(np.int64) * m + np.asarray(edge_lab, np.int64)
    pos = np.minimum(np.searchsorted(ckeys, keys), ckeys.size - 1)
    return ckeys[pos] == keys


def lp_cold_assign(graph: BipartiteGraph, labels, w_users, w_items,
                   gamma: float, n_new_users: int = 0,
                   n_new_items: int = 0,
                   cand_labels: Optional[dict] = None, *, device="cuda",
                   stats: Optional[dict] = None) -> np.ndarray:
    """Place brand-new users/items (index suffixes of their sides) into
    the existing partition with ONE LP half-step each, over only their
    incident edges (the reference's ``lp_cold_assign``).

    The score is Eq. 13/14, neighbor-label counts minus the
    gamma-weighted opposite-side cluster volume, so a cold node does not
    simply sink into the hottest cluster its neighbors touch; a cold
    node whose best candidate scores no better than staying alone keeps
    its fresh singleton label. ``labels`` must already be grown to the
    new universe (``stream.grow_labels``). Users are assigned first
    (item labels fixed), then items see the new user labels. Returns the
    updated labels (host int32[n_nodes]); old nodes never move.

    ``cand_labels`` (optional) prunes each cold node's candidates:
    {"user"/"item": (flat, indptr)} CSR lists of allowed labels, sorted
    within each node (``core.candidates.cold_candidate_sets``). Edges
    whose neighbor label is outside the list are dropped before the
    half-step; the node's own label always stays a candidate.
    """
    nu, nv, n = graph.n_users, graph.n_items, graph.n_nodes
    lab = np.array(labels, dtype=np.int32, copy=True)
    if lab.shape[0] != n:
        raise ValueError(f"labels must cover the grown universe: "
                         f"{lab.shape[0]} != {n} nodes")
    if not (0 <= n_new_users <= nu and 0 <= n_new_items <= nv):
        raise ValueError("n_new_users/n_new_items out of range")
    if n_new_users == 0 and n_new_items == 0:
        return lab
    dev = resolve_device(device)
    wu = np.asarray(w_users, np.float32)
    wv = np.asarray(w_items, np.float32)

    def prune(side, node_tail, opp_tail, opp_lab, own_lab):
        if cand_labels is None or side not in cand_labels:
            return node_tail, opp_tail
        flat, indptr = cand_labels[side]
        edge_lab = opp_lab[opp_tail]
        keep = _cand_edge_mask(node_tail, edge_lab, np.asarray(flat),
                               np.asarray(indptr), n)
        keep |= edge_lab == own_lab[node_tail]
        return node_tail[keep], opp_tail[keep]

    if n_new_users:
        u0 = nu - n_new_users
        lo = int(np.searchsorted(graph.edge_u, u0))
        node_tail = (graph.edge_u[lo:] - u0).astype(np.int32)
        node_tail, opp_tail = prune("user", node_tail, graph.edge_v[lo:],
                                    lab[nu:], lab[u0:nu])
        lab[u0:nu] = _cold_side(node_tail, opp_tail, lab[nu:], wu[u0:],
                                lab[u0:nu], wv, gamma, n_new_users, n, dev,
                                stats)
    if n_new_items:
        v0 = nv - n_new_items
        ev_byv, eu_byv = graph.edges_by_item()
        lo = int(np.searchsorted(ev_byv, v0))
        node_tail = (ev_byv[lo:] - v0).astype(np.int32)
        node_tail, opp_tail = prune("item", node_tail, eu_byv[lo:],
                                    lab[:nu], lab[nu + v0:])
        lab[nu + v0:] = _cold_side(node_tail, opp_tail, lab[:nu], wv[v0:],
                                   lab[nu + v0:], wu, gamma, n_new_items, n,
                                   dev, stats)
    return lab


# ---------------------------------------------------------------------------
# streamed edge-block solve: million-node graphs without device-resident
# edge lists
# ---------------------------------------------------------------------------
# The half-step is a per-node reduction over that node's incident edges;
# the only cross-node coupling, the per-label weight totals W(k), is an
# O(n) quantity computed from the LABELS. So the edge list stays on the
# host, in pinned memory, and each sweep streams it through the device in
# node-aligned blocks (``graph.edge_block_bounds``): each block runs the
# sort/scan passes of ``_half_step`` over its edges and writes each of
# its nodes' (best score, best label, own-label count) into [n_side + 1]
# accumulators; once every block of a side is in, the commit applies the
# move rule. Node alignment keeps every (node, label) group inside one
# block, so every count, score and tie-break is the in-memory value for
# any block size, and no label of a side changes before all its blocks
# are scored against the same labels of the other side.
#
# Pads: a block is padded to the plan's length with node id ``n_side``
# (it sorts last and forms groups of its own) and opposite id 0. PyTorch
# raises on an out-of-range gather or scatter where JAX clamps and drops,
# so ``w_self``, the own labels and the accumulators carry one spare row
# at index ``n_side`` that the pads read and write, and the commit
# slices it off.
def _stream_plan(graph: BipartiteGraph, block_edges: int) -> dict:
    """Host sweep plan: per side, int32 (node, opp) tensors of shape
    [n_blocks, pad] for its sorted edge orientation, cut at
    ``edge_block_bounds`` and padded to one ``pad_rung`` length.
    Label-independent, so one plan serves every sweep of every solve
    (memoized on the graph under the reference's key)."""
    def side_blocks(node_arr, opp_arr, bounds, n_side):
        widths = np.diff(bounds)
        pad = pad_rung(int(widths.max()) if widths.size else 1)
        nb = np.full((widths.size, pad), n_side, np.int32)
        ob = np.zeros((widths.size, pad), np.int32)
        for i, (lo, hi) in enumerate(zip(bounds[:-1].tolist(),
                                         bounds[1:].tolist())):
            nb[i, :hi - lo] = node_arr[lo:hi]
            ob[i, :hi - lo] = opp_arr[lo:hi]
        return {"node": torch.from_numpy(nb), "opp": torch.from_numpy(ob),
                "pad": pad}

    def build():
        ev_byv, eu_byv = graph.edges_by_item()
        return {"user": side_blocks(graph.edge_u, graph.edge_v,
                                    graph.edge_block_bounds("user",
                                                            block_edges),
                                    graph.n_users),
                "item": side_blocks(ev_byv, eu_byv,
                                    graph.edge_block_bounds("item",
                                                            block_edges),
                                    graph.n_items)}

    return graph._memo(f"stream_plan/{int(block_edges)}", build)


def _pin(plan: dict) -> None:
    """Move the plan's blocks to page-locked host memory (once per plan),
    so their H2D copies run asynchronously on the copy stream."""
    for side in ("user", "item"):
        for k in ("node", "opp"):
            if not plan[side][k].is_pinned():
                plan[side][k] = plan[side][k].pin_memory()


def _stream_block(acc_best, acc_lab, acc_own, node_b, opp_b, opp_labels,
                  w_self, w_other_by_label, own_labels, gamma,
                  n_labels: int) -> None:
    """Score one node-aligned block and write its nodes' results into
    the accumulators (in place). ``node_b``/``opp_b`` int64 [pad]; pads
    carry node ``n_side``; ``w_self``/``own_labels`` and the
    accumulators have the spare row ``n_side``. The arithmetic is
    ``_half_step``'s (``_group_scores``, ``_best_into``: every node lies
    in one block only) and an exact integer own-label count."""
    cand = opp_labels[opp_b]
    node_s, lab_s, score = _group_scores(node_b, cand, w_self,
                                         w_other_by_label, gamma, n_labels)
    _best_into(acc_best, acc_lab, node_s, lab_s, score, n_labels)
    acc_own.index_add_(0, node_b, (cand == own_labels[node_b]).long())


def _stream_commit(acc_best, acc_lab, acc_own, w_self, w_other_by_label,
                   own_labels, gamma, n_side: int, n_labels: int):
    """``_half_step``'s move rule over the accumulated results. Nodes no
    block touched (edgeless) keep best ``_NEG`` / label ``n_labels`` and
    never move."""
    own = own_labels[:n_side]
    own_score = fma_sub(gamma * w_self[:n_side], w_other_by_label[own],
                        acc_own[:n_side].float())
    best_lab = acc_lab[:n_side]
    move = (acc_best[:n_side] > own_score) & (best_lab < n_labels)
    return torch.where(move, best_lab, own)


def _streamed_half(blocks: dict, n_side: int, n_labels: int,
                   opp_labels, w_self, w_by_label, own_labels, gamma,
                   streams) -> torch.Tensor:
    """One half-step over a side's blocks. On a GPU each block's H2D
    copy runs on ``streams["copy"]`` into one of two device buffers; the
    next block's copy is issued before the current block computes, and
    the compute stream waits on a per-block event. The copy stream first
    waits for the work already on the compute stream (the buffers are
    fresh allocations that may reuse memory it still reads), and a
    buffer is refilled only after the compute stream has widened its
    previous contents (another event), so no block reads half-copied
    data and no copy overwrites live data."""
    dev = own_labels.device
    pad = blocks["pad"]
    n_blocks = int(blocks["node"].shape[0])
    acc_best = torch.full((n_side + 1,), _NEG, dtype=torch.float32,
                          device=dev)
    acc_lab = torch.full((n_side + 1,), n_labels, dtype=torch.int64,
                         device=dev)
    acc_own = torch.zeros(n_side + 1, dtype=torch.int64, device=dev)
    w_ext = torch.cat([w_self, w_self.new_zeros(1)])
    own_ext = torch.cat([own_labels, own_labels.new_full((1,), n_labels)])
    tracer = get_tracer()
    parent = tracer.current()
    on_gpu = dev.type == "cuda"
    if on_gpu:
        compute, copy = streams["compute"], streams["copy"]
        bufs = [(torch.empty(pad, dtype=torch.int32, device=dev),
                 torch.empty(pad, dtype=torch.int32, device=dev))
                for _ in range(2)]
        for pair in bufs:
            for t in pair:
                t.record_stream(copy)
        # the buffers may reuse memory that work already enqueued on the
        # compute stream still reads: no copy may start before it ends
        copy.wait_stream(compute)
        ready = [torch.cuda.Event() for _ in range(2)]
        free = [torch.cuda.Event() for _ in range(2)]

        def issue(i):
            slot = i % 2
            with torch.cuda.stream(copy):
                if i >= 2:
                    copy.wait_event(free[slot])
                bufs[slot][0].copy_(blocks["node"][i], non_blocking=True)
                bufs[slot][1].copy_(blocks["opp"][i], non_blocking=True)
                ready[slot].record(copy)

        if n_blocks:
            issue(0)
    for i in range(n_blocks):
        t0 = clock.now()
        if on_gpu:
            slot = i % 2
            if i + 1 < n_blocks:
                issue(i + 1)
            compute.wait_event(ready[slot])
            node_b = bufs[slot][0].long()
            opp_b = bufs[slot][1].long()
            free[slot].record(compute)
        else:
            node_b = blocks["node"][i].long()
            opp_b = blocks["opp"][i].long()
        _stream_block(acc_best, acc_lab, acc_own, node_b, opp_b, opp_labels,
                      w_ext, w_by_label, own_ext, gamma, n_labels)
        if parent is not None and parent.sampled:
            # launches are asynchronous on a GPU: this spans the enqueue
            # (with the next block's copy), not the device's work; the
            # sweep span above it carries the blocking wall time
            tracer.record_span("edge_block", t0, clock.now(),
                               parent=parent, block=i)
    return _stream_commit(acc_best, acc_lab, acc_own, w_ext, w_by_label,
                          own_ext, gamma, n_side, n_labels)


def lp_solve_streamed(graph: BipartiteGraph, w_users, w_items, gamma: float,
                      budget: Optional[int] = None, max_iters: int = 8,
                      init_labels=None, block_edges: int = 1 << 20, *,
                      device="cuda", stats: Optional[dict] = None
                      ) -> Tuple[np.ndarray, int]:
    """``lp_solve`` without the edge list on the device (the reference's
    ``lp_solve_streamed``).

    Edges stay in pinned host blocks of at most ``block_edges`` edges
    (node-aligned); each sweep copies them to the device behind the
    compute, so device residency is O(nodes + block), not O(edges).
    Labels and iterations are bit for bit ``lp_solve``'s for any block
    size, and the sweep, budget and convergence semantics are
    ``solve_loop``'s, the sweep that detects convergence included. The
    device edge memo of the in-memory solver is never touched.

    ``stats`` (optional dict) gets the reference's keys: blocks per
    side, padded block lengths, ``block_edges``, ``sweeps``, per-sweep
    seconds and the fastest sweep's ms, blocks per second, and
    ``peak_device_bytes``: on a GPU ``torch.cuda.max_memory_allocated``
    after resetting the peak at the start of the solve
    (``peak_bytes_source`` "max_memory_allocated"); on the CPU a
    residency estimate for the port's dtypes ("residency_estimate").
    """
    dev = resolve_device(device)
    n_users, n_items = graph.n_users, graph.n_items
    n = n_users + n_items
    on_gpu = dev.type == "cuda"
    if on_gpu:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    plan = _stream_plan(graph, int(block_edges))
    if on_gpu:
        _pin(plan)
    streams = ({"compute": torch.cuda.current_stream(dev),
                "copy": torch.cuda.Stream(dev)} if on_gpu else None)
    wu = torch.as_tensor(np.asarray(w_users, np.float32), device=dev)
    wv = torch.as_tensor(np.asarray(w_items, np.float32), device=dev)
    labels = _init_labels(graph, init_labels, dev)
    g = torch.tensor(float(gamma), dtype=torch.float32, device=dev)
    bud = 0 if budget is None else int(budget)
    it = 0
    done = False
    sweep_s = []
    tracer = get_tracer()
    while not done and it < max_iters:
        t0 = clock.now()
        # a child of the engine's "cluster_solve" when one is open, else
        # a root; the edge_block spans nest under it
        with tracer.span("lp_sweep", sweep=it) as sweep_sp:
            item_labels = labels[n_users:]
            w_items_by = segment_sum_ordered(wv, item_labels, n)
            new_u = _streamed_half(plan["user"], n_users, n, item_labels,
                                   wu, w_items_by, labels[:n_users], g,
                                   streams)
            w_users_by = segment_sum_ordered(wu, new_u, n)
            new_v = _streamed_half(plan["item"], n_items, n, new_u, wv,
                                   w_users_by, item_labels, g, streams)
            new = torch.cat([new_u, new_v])
            ku, kv = count_side_labels(new, n_users, n_items)
            k, same = torch.stack([ku + kv,
                                   (new == labels).all().long()]).tolist()
            converged = bool(same)
            within = bud > 0 and k <= bud
            sweep_sp.set(converged=converged)
        sweep_s.append(clock.now() - t0)
        labels = new
        it += 1
        done = within or converged
    out = labels.to(torch.int32).cpu().numpy()
    if stats is not None:
        upad, vpad = plan["user"]["pad"], plan["item"]["pad"]
        nbu = int(plan["user"]["node"].shape[0])
        nbv = int(plan["item"]["node"].shape[0])
        total = sum(sweep_s)
        if on_gpu:
            peak = int(torch.cuda.max_memory_allocated(dev))
            source = "max_memory_allocated"
        else:
            # labels old + new (int64 [n]), weights and W(k) (f32 [n]
            # each), three accumulators + spare-row copies of the own
            # labels and weights per side (f32 + 3 x int64 + f32), two
            # int32 block pairs, and a block's int64/f64 temporaries
            side = max(n_users, n_items) + 1
            peak = (16 * n + 8 * n + 32 * side + 16 * max(upad, vpad)
                    + 64 * max(upad, vpad))
            source = "residency_estimate"
        stats.update(
            n_blocks_user=nbu, n_blocks_item=nbv,
            block_pad_user=int(upad), block_pad_item=int(vpad),
            block_edges=int(block_edges), sweeps=int(it),
            sweep_s=list(sweep_s),
            sweep_ms=min(sweep_s) * 1e3 if sweep_s else 0.0,
            blocks_per_s=it * (nbu + nbv) / total if total > 0 else 0.0,
            peak_device_bytes=peak, peak_bytes_source=source)
    return out, it


# ---------------------------------------------------------------------------
# the host-driven loop with the seed's half-step (a benchmark reference)
# ---------------------------------------------------------------------------
def _half_step_seed(node_of_edge, cand_lab_of_edge, w_self, w_other_by_label,
                    own_labels, gamma, n_side: int, n_labels: int):
    """The reference's ``_half_step_seed``: grouping by two stable
    argsorts (label, then node) and gathers, group sizes by a count per
    group id, and segment max / min per node. Same labels as
    :func:`_half_step` bit for bit (same ``fma_sub`` score, exact
    counts)."""
    dev = node_of_edge.device
    e = int(node_of_edge.shape[0])
    if e == 0:
        return own_labels
    o1 = torch.sort(cand_lab_of_edge, stable=True).indices
    o2 = torch.sort(node_of_edge[o1], stable=True).indices
    order = o1[o2]
    node_s = node_of_edge[order]
    lab_s = cand_lab_of_edge[order]
    new_grp = torch.ones(e, dtype=torch.bool, device=dev)
    new_grp[1:] = (node_s[1:] != node_s[:-1]) | (lab_s[1:] != lab_s[:-1])
    gid = torch.cumsum(new_grp.long(), 0) - 1
    cnt = torch.bincount(gid, minlength=e).float()[gid]
    score = fma_sub(gamma * w_self[node_s], w_other_by_label[lab_s], cnt)
    best = torch.full((n_side,), float("-inf"), device=dev)
    best = best.scatter_reduce(0, node_s, score, "amax", include_self=False)
    best = torch.where(torch.isfinite(best), best,
                       torch.full_like(best, _NEG))
    cand = torch.where(score >= best[node_s], lab_s,
                       torch.full_like(lab_s, n_labels))
    best_lab = torch.full((n_side,), n_labels, dtype=torch.int64, device=dev)
    best_lab = best_lab.scatter_reduce(0, node_s, cand, "amin")
    own_cnt = torch.bincount(
        node_of_edge, weights=(cand_lab_of_edge
                               == own_labels[node_of_edge]).float(),
        minlength=n_side).float()
    own_score = fma_sub(gamma * w_self, w_other_by_label[own_labels], own_cnt)
    move = (best > own_score) & (best_lab < n_labels)
    return torch.where(move, best_lab, own_labels)


def lp_solve_hostloop(graph: BipartiteGraph, w_users, w_items, gamma: float,
                      budget: Optional[int] = None, max_iters: int = 8,
                      init_labels=None, *, device="cuda",
                      stats: Optional[dict] = None
                      ) -> Tuple[np.ndarray, int]:
    """The reference's ``lp_solve_hostloop``: the seed's half-step, one
    sweep at a time, with the budget read after each sweep and the whole
    labels array copied to the host to compare with the PREVIOUS
    sweep's (never with the input labels, so the first sweep never
    converges). A benchmark reference; never auto-selected."""
    dev = resolve_device(device)
    nu, ni = graph.n_users, graph.n_items
    n = nu + ni
    eu, ev, eu_byv, ev_byv, wu, wv = device_inputs(graph, w_users, w_items,
                                                   dev)
    labels = _init_labels(graph, init_labels, dev)
    g = torch.tensor(float(gamma), dtype=torch.float32, device=dev)
    it = 0
    prev = None
    for it in range(1, max_iters + 1):
        item_labels = labels[nu:]
        w_items_by = segment_sum_ordered(wv, item_labels, n, stats)
        new_u = _half_step_seed(eu, item_labels[ev], wu, w_items_by,
                                labels[:nu], g, nu, n)
        w_users_by = segment_sum_ordered(wu, new_u, n, stats)
        new_v = _half_step_seed(ev_byv, new_u[eu_byv], wv, w_users_by,
                                item_labels, g, ni, n)
        labels = torch.cat([new_u, new_v])
        _bump(stats, "sweeps")
        if budget is not None:
            ku, kv = count_side_labels(labels, nu, ni)
            _bump(stats, "host_syncs")
            if int(ku + kv) <= budget:
                break
        lab_np = labels.cpu().numpy()
        _bump(stats, "host_syncs")
        if prev is not None and np.array_equal(lab_np, prev):
            break
        prev = lab_np
    _bump(stats, "host_syncs")
    return labels.to(torch.int32).cpu().numpy(), it
