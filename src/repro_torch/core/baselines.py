"""ETC baseline zoo (paper §5.1); port of ``repro.core.baselines``.

Implemented here (16 of the paper's 18 + CCE in training/cce.py):
  random, frequency, double, hybrid (hashing family)
  lsh (SimHash over interaction rows)
  lp (gamma=0 label propagation), lpab (modularity-weight LP),
  louvain_modularity (GraphHash), louvain_cpm, double_graphhash,
  leiden (Louvain + balanced-LP refinement; labeled an approximation),
  scc (Dhillon'01 spectral co-clustering), sbc (Kluger'03 per-side
  spectral), itcc (information-theoretic co-clustering),
  baco variants (via core.baco)

CCE ("clustering the sketch", learned) lives in training/cce.py since it
couples to the training loop. Out of scope, documented in DESIGN.md:
LEGCF/DHE (learned, require per-epoch model surgery) and
infomap/BiMLPA/BRIM/EBMD — external adaptive-K community detectors the
paper runs via third-party packages.

Every builder returns a `Sketch` so downstream training is uniform.
The hashing, LSH, spectral, ITCC and Louvain builders are numpy/scipy
copies of the reference's and give its sketches for the same seed. The
builders that solve (``lp``, ``lpab``, the ``leiden`` refinement and the
BACO variants) run the port's solver on ``device``: ``build_sketch``
passes its ``device`` to those builders only, so every other builder
keeps the reference's signature and the kwarg guard accepts exactly
the reference's kwargs.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .graph import BipartiteGraph
from .sketch import Sketch, compact_labels
from .weights import make_weights
from . import solver_torch
from .louvain import louvain_solve

__all__ = ["build_sketch", "BASELINES"]


def _split_budget(graph: BipartiteGraph, budget: int):
    """Split total codebook budget across sides proportionally to counts."""
    nu, nv = graph.n_users, graph.n_items
    ku = max(1, int(round(budget * nu / (nu + nv))))
    kv = max(1, budget - ku)
    ku = min(ku, nu)
    kv = min(kv, nv)
    return ku, kv


def _hash(ids: np.ndarray, k: int, seed: int) -> np.ndarray:
    """Deterministic splittable integer hash -> [0, k)."""
    x = ids.astype(np.uint64) + np.uint64((seed * 0x9E3779B97F4A7C15) % (1 << 64))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    return (x % np.uint64(k)).astype(np.int32)


# --------------------------------------------------------------------------
# hashing family
# --------------------------------------------------------------------------
def random_sketch(graph, budget, seed=0):
    ku, kv = _split_budget(graph, budget)
    return Sketch(_hash(np.arange(graph.n_users), ku, seed)[:, None],
                  _hash(np.arange(graph.n_items), kv, seed + 1)[:, None],
                  ku, kv, method="random")


def frequency_sketch(graph, budget, seed=0):
    """Half the bins are private to the most frequent entities [16, 66]."""
    ku, kv = _split_budget(graph, budget)

    def per_side(deg, k, s):
        n = deg.shape[0]
        own = k // 2
        order = np.argsort(-deg, kind="stable")
        idx = np.empty(n, dtype=np.int32)
        top = order[:own]
        idx[top] = np.arange(own, dtype=np.int32)
        rest = order[own:]
        idx[rest] = own + _hash(rest, max(k - own, 1), s)
        return idx

    return Sketch(per_side(graph.user_degrees(), ku, seed)[:, None],
                  per_side(graph.item_degrees(), kv, seed + 1)[:, None],
                  ku, kv, method="frequency")


def double_sketch(graph, budget, seed=0):
    """Two independent hashes; embeddings summed (2-hot sketch) [66]."""
    ku, kv = _split_budget(graph, budget)
    u = np.stack([_hash(np.arange(graph.n_users), ku, seed),
                  _hash(np.arange(graph.n_users), ku, seed + 7)], axis=1)
    v = np.stack([_hash(np.arange(graph.n_items), kv, seed + 1),
                  _hash(np.arange(graph.n_items), kv, seed + 8)], axis=1)
    return Sketch(u, v, ku, kv, method="double")


def hybrid_sketch(graph, budget, seed=0):
    """Frequent entities get private bins; the rest are double-hashed [66]."""
    ku, kv = _split_budget(graph, budget)

    def per_side(deg, k, s):
        n = deg.shape[0]
        own = k // 2
        order = np.argsort(-deg, kind="stable")
        idx = np.empty((n, 2), dtype=np.int32)
        top = order[:own]
        idx[top, 0] = np.arange(own, dtype=np.int32)
        idx[top, 1] = idx[top, 0]            # degenerate 2-hot = 1-hot * 2
        rest = order[own:]
        idx[rest, 0] = own + _hash(rest, max(k - own, 1), s)
        idx[rest, 1] = own + _hash(rest, max(k - own, 1), s + 7)
        return idx

    return Sketch(per_side(graph.user_degrees(), ku, seed),
                  per_side(graph.item_degrees(), kv, seed + 1),
                  ku, kv, method="hybrid")


def lsh_sketch(graph, budget, seed=0, n_bits=16):
    """SimHash over interaction rows: sign(B @ R) bucketed mod K [10, 67]."""
    ku, kv = _split_budget(graph, budget)
    rng = np.random.default_rng(seed)

    def per_side(indptr, nbrs, dim, k):
        n = indptr.shape[0] - 1
        r = rng.standard_normal((dim, n_bits)).astype(np.float32)
        sig = np.zeros((n, n_bits), dtype=np.float32)
        # sparse row @ R accumulated via add.at (no |n|x|dim| dense)
        src = np.repeat(np.arange(n), np.diff(indptr))
        np.add.at(sig, src, r[nbrs])
        bits = (sig > 0).astype(np.uint64)
        code = np.zeros(n, dtype=np.uint64)
        for b in range(n_bits):
            code |= bits[:, b] << np.uint64(b)
        return (code % np.uint64(k)).astype(np.int32)

    ui, un = graph.user_csr()
    vi, vn = graph.item_csr()
    return Sketch(per_side(ui, un, graph.n_items, ku)[:, None],
                  per_side(vi, vn, graph.n_users, kv)[:, None],
                  ku, kv, method="lsh")


# --------------------------------------------------------------------------
# graph clustering family
# --------------------------------------------------------------------------
def _lp_family(graph, budget, scheme, gamma, max_iters=8, device="cuda"):
    wu, wv = make_weights(graph, scheme)
    labels, it = solver_torch.lp_solve(graph, wu, wv, gamma, budget,
                                       max_iters, device=device)
    ku, ul = compact_labels(labels[:graph.n_users])
    kv, il = compact_labels(labels[graph.n_users:])
    return Sketch(ul[:, None], il[:, None], ku, kv,
                  method=f"lp[{scheme},g={gamma}]",
                  meta={"iters": it, "gamma": gamma,
                        "joint_labels": labels.astype(np.int32)})


def lp_sketch(graph, budget, seed=0, max_iters=8, *, device="cuda"):
    """Plain LP [38]: gamma = 0, no balance control."""
    return _lp_family(graph, budget, "cpm", 0.0, max_iters=max_iters,
                      device=device)


def lpab_sketch(graph, budget, seed=0, gamma=1.0, max_iters=8, *,
                device="cuda"):
    """LPAb [3]: LP solver with modularity weights."""
    return _lp_family(graph, budget, "modularity", gamma,
                      max_iters=max_iters, device=device)


def _louvain_family(graph, budget, scheme, gamma):
    wu, wv = make_weights(graph, scheme)
    labels, lv = louvain_solve(graph, wu, wv, gamma)
    ku, ul = compact_labels(labels[:graph.n_users])
    kv, il = compact_labels(labels[graph.n_users:])
    return Sketch(ul[:, None], il[:, None], ku, kv,
                  method=f"louvain[{scheme},g={gamma}]",
                  meta={"levels": lv, "gamma": gamma,
                        "joint_labels": labels.astype(np.int32)})


def louvain_modularity_sketch(graph, budget, seed=0, gamma=1.0):
    """GraphHash [56]: bipartite-modularity Louvain."""
    return _louvain_family(graph, budget, "modularity", gamma)


def louvain_cpm_sketch(graph, budget, seed=0, gamma=None):
    if gamma is None:  # CPM gamma must sit at edge-density scale
        gamma = max(graph.n_edges / (graph.n_users * graph.n_items), 1e-9) * 4
    return _louvain_family(graph, budget, "cpm", gamma)


# --------------------------------------------------------------------------
# co-clustering family (spectral)
# --------------------------------------------------------------------------
def _kmeans(x, k, seed=0, iters=25):
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    k = min(k, n)
    centers = x[rng.choice(n, size=k, replace=False)]
    assign = np.zeros(n, dtype=np.int32)
    for _ in range(iters):
        d = ((x[:, None, :] - centers[None, :, :]) ** 2).sum(-1) \
            if n * k * x.shape[1] < 5e7 else None
        if d is None:  # chunked distance for big inputs
            d = np.empty((n, k), dtype=np.float32)
            x2 = (x * x).sum(-1, keepdims=True)
            c2 = (centers * centers).sum(-1)
            step = max(1, int(5e7 // max(k, 1)))
            for s in range(0, n, step):
                e = min(n, s + step)
                d[s:e] = x2[s:e] + c2[None, :] - 2.0 * x[s:e] @ centers.T
        new = d.argmin(1).astype(np.int32)
        if np.array_equal(new, assign):
            break
        assign = new
        for c in range(k):
            m = assign == c
            if m.any():
                centers[c] = x[m].mean(0)
    return assign


def scc_sketch(graph, budget, seed=0, n_vecs=None):
    """Spectral co-clustering [12]: SVD of D_u^-1/2 B D_v^-1/2 + k-means."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    ku, kv = _split_budget(graph, budget)
    k = min(ku, kv)
    ell = n_vecs or max(2, min(int(np.ceil(np.log2(max(k, 2)))) + 1, 32))
    du = np.maximum(graph.user_degrees(), 1).astype(np.float64)
    dv = np.maximum(graph.item_degrees(), 1).astype(np.float64)
    b = sp.coo_matrix((np.ones(graph.n_edges),
                       (graph.edge_u, graph.edge_v)),
                      shape=(graph.n_users, graph.n_items)).tocsr()
    bn = sp.diags(du ** -0.5) @ b @ sp.diags(dv ** -0.5)
    u, s, vt = spla.svds(bn, k=min(ell + 1, min(bn.shape) - 1))
    order = np.argsort(-s)[1:ell + 1]          # drop trivial top vector
    zu = (du[:, None] ** -0.5) * u[:, order]
    zv = (dv[:, None] ** -0.5) * vt[order].T
    z = np.concatenate([zu, zv], axis=0).astype(np.float32)
    joint = _kmeans(z, k, seed=seed)
    ku2, ul = compact_labels(joint[:graph.n_users])
    kv2, il = compact_labels(joint[graph.n_users:])
    return Sketch(ul[:, None], il[:, None], ku2, kv2, method="scc",
                  meta={"joint_labels": joint.astype(np.int32)})


def sbc_sketch(graph, budget, seed=0):
    """Spectral biclustering [29]: per-side k-means on singular vectors."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    ku, kv = _split_budget(graph, budget)
    ell = max(2, min(int(np.ceil(np.log2(max(min(ku, kv), 2)))) + 1, 32))
    du = np.maximum(graph.user_degrees(), 1).astype(np.float64)
    dv = np.maximum(graph.item_degrees(), 1).astype(np.float64)
    b = sp.coo_matrix((np.ones(graph.n_edges),
                       (graph.edge_u, graph.edge_v)),
                      shape=(graph.n_users, graph.n_items)).tocsr()
    bn = sp.diags(du ** -0.5) @ b @ sp.diags(dv ** -0.5)
    u, s, vt = spla.svds(bn, k=min(ell + 1, min(bn.shape) - 1))
    order = np.argsort(-s)[1:ell + 1]
    ul = _kmeans(u[:, order].astype(np.float32), ku, seed=seed)
    il = _kmeans(vt[order].T.astype(np.float32), kv, seed=seed + 1)
    ku2, ul = compact_labels(ul)
    kv2, il = compact_labels(il)
    return Sketch(ul[:, None], il[:, None], ku2, kv2, method="sbc")


def leiden_like_sketch(graph, budget, seed=0, gamma=1.0, *, device="cuda"):
    """Leiden [48], approximated: Louvain levels + a refinement pass.

    Leiden's contribution over Louvain is a refinement phase that splits
    badly-connected communities before aggregation. We approximate it by
    re-running the balanced LP solver INITIALIZED from the Louvain
    partition: the volume penalty breaks resolution-limit merges while
    well-connected communities survive. Labeled an approximation in the
    benchmark tables.
    """
    wu, wv = make_weights(graph, "modularity")
    labels, _ = louvain_solve(graph, wu, wv, gamma)
    refined, it = solver_torch.lp_solve(graph, wu, wv, gamma, budget,
                                        max_iters=3,
                                        init_labels=labels.astype(np.int32),
                                        device=device)
    ku, ul = compact_labels(refined[:graph.n_users])
    kv, il = compact_labels(refined[graph.n_users:])
    return Sketch(ul[:, None], il[:, None], ku, kv,
                  method="leiden(approx)",
                  meta={"gamma": gamma,
                        "joint_labels": refined.astype(np.int32)})


def itcc_sketch(graph, budget, seed=0, n_iters=12):
    """Information-theoretic co-clustering [13]: alternate row/column
    cluster updates minimizing the KL between p(u,v) and its co-cluster
    approximation. Dense p-matrix -> paper-scale graphs only."""
    ku, kv = _split_budget(graph, budget)
    rng = np.random.default_rng(seed)
    nu, nv = graph.n_users, graph.n_items
    p = graph.biadjacency().astype(np.float64)
    p /= p.sum()
    ru = rng.integers(0, ku, nu)
    rv = rng.integers(0, kv, nv)
    eps = 1e-12
    for _i in range(n_iters):
        # co-cluster joint + marginals
        pc = np.zeros((ku, kv))
        np.add.at(pc, (ru[:, None].repeat(nv, 1), rv[None, :].repeat(nu, 0)),
                  p)
        pu_c = pc.sum(1) + eps
        pv_c = pc.sum(0) + eps
        # q(v | item cluster) distributions per user row
        logq = np.log(pc + eps) - np.log(pu_c)[:, None] - np.log(pv_c)[None]
        # assign to the row cluster maximizing sum p(u,v) logq; random
        # tiebreak noise prevents the all-ties -> cluster-0 collapse at
        # the (uninformative) random init
        pv_agg = np.zeros((nu, kv))
        np.add.at(pv_agg.T, rv, p.T)
        su = pv_agg @ logq.T
        ru = np.argmax(su + 1e-9 * rng.random(su.shape), axis=1)
        pu_agg = np.zeros((nv, ku))
        np.add.at(pu_agg.T, ru, p)
        sv = pu_agg @ logq
        rv = np.argmax(sv + 1e-9 * rng.random(sv.shape), axis=1)
    ku2, ul = compact_labels(ru.astype(np.int64))
    kv2, il = compact_labels(rv.astype(np.int64))
    return Sketch(ul[:, None], il[:, None], ku2, kv2, method="itcc")


def double_graphhash_sketch(graph, budget, seed=0, gamma=1.0):
    """DoubleGraphHash [56]: two clusterings at different resolutions,
    combined as a 2-hot sketch (the graph analogue of double hashing)."""
    wu, wv = make_weights(graph, "modularity")
    l1, _ = louvain_solve(graph, wu, wv, gamma)
    l2, _ = louvain_solve(graph, wu, wv, gamma * 4.0)
    ku, u1, u2 = compact_labels(l1[:graph.n_users], l2[:graph.n_users])
    kv, v1, v2 = compact_labels(l1[graph.n_users:], l2[graph.n_users:])
    return Sketch(np.stack([u1, u2], 1), np.stack([v1, v2], 1), ku, kv,
                  method="double_graphhash",
                  meta={"joint_labels": l1.astype(np.int32)})


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------
def _baco(graph, budget, seed=0, *, device="cuda", **kw):
    # seed accepted for registry uniformity (BACO is deterministic);
    # everything else must name a real baco_build parameter — its
    # explicit signature is the typo guard
    from .baco import baco_build
    return baco_build(graph, budget=budget, device=device, **kw)


BASELINES = {
    "random": random_sketch,
    "frequency": frequency_sketch,
    "double": double_sketch,
    "hybrid": hybrid_sketch,
    "lsh": lsh_sketch,
    "lp": lp_sketch,
    "lpab": lpab_sketch,
    "louvain_modularity": louvain_modularity_sketch,   # GraphHash
    "louvain_cpm": louvain_cpm_sketch,
    "scc": scc_sketch,
    "sbc": sbc_sketch,
    "itcc": itcc_sketch,
    "double_graphhash": double_graphhash_sketch,
    "leiden": leiden_like_sketch,
    "baco": _baco,
    "baco_no_scu": lambda g, b, **kw: _baco(g, b, scu=False, **kw),
}


# kwargs a registry entry pins itself (callers may not override them)
_PRESET_KWARGS = {"baco_no_scu": {"scu"}}

# the builders that run the LP solver, and so take build_sketch's device
_SOLVING = frozenset({"lp", "lpab", "leiden", "baco", "baco_no_scu"})


def _allowed_kwargs(name: str) -> set:
    """Keyword names the selected builder really accepts. The baco
    variants forward to ``baco_build``, so its signature is the truth
    for them (minus any kwarg the variant pins, e.g. baco_no_scu's
    ``scu``); everything else is read off the builder itself."""
    import inspect
    if name.startswith("baco"):
        from .baco import baco_build
        target = baco_build
    else:
        target = BASELINES[name]
    kinds = (inspect.Parameter.POSITIONAL_OR_KEYWORD,
             inspect.Parameter.KEYWORD_ONLY)
    allowed = {p.name for p in inspect.signature(target).parameters.values()
               if p.kind in kinds} - {"graph", "budget", "device"}
    allowed -= _PRESET_KWARGS.get(name, set())
    return allowed | {"seed"}      # the registry always passes seed


def build_sketch(name: str, graph: BipartiteGraph, budget: int,
                 seed: int = 0, *, device="cuda", **kw) -> Sketch:
    """Build the named ETC sketch. Extra kwargs must name real
    parameters of the selected builder: kwargs are validated against
    the builder's explicit signature (no ``**_`` swallowing anywhere in
    the zoo), so a typo'd ``gamm=...`` raises TypeError up front
    instead of silently running defaults. ``device`` is where the
    builders that solve run their LP ("cuda" by default); the others
    run on the host and never see it."""
    if name not in BASELINES:
        raise KeyError(f"unknown ETC method {name!r}: {sorted(BASELINES)}")
    allowed = _allowed_kwargs(name)
    unknown = sorted(set(kw) - allowed)
    if unknown:
        raise TypeError(f"build_sketch({name!r}): unexpected keyword "
                        f"argument(s) {unknown}; valid kwargs: "
                        f"{sorted(allowed)}")
    if name in _SOLVING:
        kw["device"] = device
    return BASELINES[name](graph, budget, seed=seed, **kw)
