"""One-bit-minhash candidate pruning: sublinear-in-labels assignment
(a copy of ``repro.core.candidates``, numpy only).

Cold-start assignment and warm refreshes score a node against the
labels of its neighbors — O(degree) candidate labels per node, but on
large graphs with many live clusters that is still "every label any
neighbor touches". Saec-style similarity hashing (PAPERS.md) makes the
per-node candidate universe O(bucket): nodes with Jaccard-similar
neighborhoods collide in LSH buckets, and the labels of a node's
bucket-mates are the clusters it could plausibly join. This module is
the numpy-vectorized adaptation of the classic bucket-table +
prefix-sum query planner (SNIPPETS.md Snippet 2): band codes via
one-bit minhash, per-band SORTED code tables instead of dicts, and one
repeat/cumsum plan that gathers every query's bucket slices without a
Python loop over queries.

Scheme: H = n_bands * rows_per_band hash functions. For each function,
a node's signature is the minimum multiplicative hash over its
neighborhood; one-bit minhash keeps a single mixed bit of that minimum,
and ``rows_per_band`` bits pack into a band code. Two nodes with
neighborhood Jaccard J agree on a bit with probability (1 + J) / 2, so
they collide in a band with ((1 + J) / 2)^rows_per_band and in at least
one of n_bands bands with 1 - (1 - p)^n_bands — the usual S-curve; the
defaults (16 bands x 4 rows) put ~0.96 collision probability at
J = 0.3, and recall of the true argmax LABEL is higher still because a
cluster is recalled if ANY of its members collides.

Exactness contract: pruning never changes scores, only which labels are
scored (``solver_torch.lp_cold_assign(cand_labels=...)`` drops edges
whose label is outside the set). If the exact argmax label is in the
candidate set — the measured recall — the assignment is bitwise the
exact one.
"""
from __future__ import annotations

import numpy as np

from .graph import BipartiteGraph

__all__ = ["MinHashIndex", "cold_candidate_sets", "prune_graph",
           "candidate_recall"]


def _csr_unique_pairs(q_of: np.ndarray, vals: np.ndarray, n_q: int,
                      n_vals: int):
    """Dedup (query, value) pairs and CSR-ify: returns (flat, indptr)
    with values sorted ascending within each query's slice."""
    if q_of.size == 0:
        return (np.empty(0, np.int64),
                np.zeros(n_q + 1, np.int64))
    m = np.int64(n_vals) + 1
    keys = np.unique(q_of.astype(np.int64) * m + vals.astype(np.int64))
    q = keys // m
    flat = keys % m
    indptr = np.zeros(n_q + 1, np.int64)
    np.cumsum(np.bincount(q, minlength=n_q), out=indptr[1:])
    return flat, indptr


class MinHashIndex:
    """Banded one-bit-minhash index over node neighborhoods.

    ``fit`` hashes the indexed nodes' neighborhoods into per-band sorted
    code tables; ``query`` plans every query's bucket gathers with one
    prefix-sum pass and returns deduped candidate-node CSR lists.
    ``max_per_band`` caps how many bucket-mates a single band may
    contribute per query (degenerate mega-buckets — e.g. many identical
    tiny neighborhoods — would otherwise make "candidates" mean
    "everyone"); the cap keeps per-query work O(n_bands * cap).
    """

    def __init__(self, n_bands: int = 16, rows_per_band: int = 4,
                 seed: int = 0, max_per_band: int = 32):
        if n_bands < 1 or rows_per_band < 1 or rows_per_band > 16:
            raise ValueError("need n_bands >= 1, 1 <= rows_per_band <= 16")
        self.n_bands = int(n_bands)
        self.rows_per_band = int(rows_per_band)
        self.max_per_band = int(max_per_band)
        rng = np.random.default_rng(seed)
        # odd multipliers: bijective over Z/2^64, so the min picks a
        # uniform pseudo-random neighborhood element per hash
        self._mults = rng.integers(
            1, 1 << 62, size=self.n_bands * self.rows_per_band,
            dtype=np.uint64) * np.uint64(2) + np.uint64(1)
        self._codes_sorted = None
        self._order = None
        self._n_indexed = 0

    def _codes(self, indptr: np.ndarray, neighbors: np.ndarray,
               query: bool) -> np.ndarray:
        """int64[n_bands, n] band codes. Empty neighborhoods get codes
        outside the 2^rows range and DISJOINT between fit (positive) and
        query (negative) roles, so degree-0 nodes never collide with
        anything."""
        indptr = np.asarray(indptr, np.int64)
        n = indptr.size - 1
        e = int(indptr[-1])
        x = np.asarray(neighbors, np.uint64) + np.uint64(1)
        starts = np.minimum(indptr[:-1], max(e - 1, 0))
        empty = indptr[:-1] == indptr[1:]
        codes = np.zeros((self.n_bands, n), np.int64)
        ids = np.arange(n, dtype=np.int64)
        sentinel = (-ids - 1) if query else ((1 << self.rows_per_band) + ids)
        for b in range(self.n_bands):
            code = np.zeros(n, np.int64)
            for r in range(self.rows_per_band):
                a = self._mults[b * self.rows_per_band + r]
                mn = (np.minimum.reduceat(x * a, starts) if e
                      else np.zeros(n, np.uint64))
                bit = ((mn >> np.uint64(32)) & np.uint64(1)).astype(np.int64)
                code = (code << 1) | bit
            codes[b] = np.where(empty, sentinel, code)
        return codes

    def fit(self, indptr: np.ndarray, neighbors: np.ndarray) -> "MinHashIndex":
        codes = self._codes(indptr, neighbors, query=False)
        self._order = np.argsort(codes, axis=1, kind="stable")
        self._codes_sorted = np.take_along_axis(codes, self._order, axis=1)
        self._n_indexed = codes.shape[1]
        return self

    def query(self, indptr: np.ndarray, neighbors: np.ndarray):
        """Candidate indexed-node ids per query node.

        Returns (flat int64[C], indptr int64[n_q + 1]): node ids sorted
        ascending within each query's slice. One vectorized plan: per
        (query, band) bucket slice bounds by searchsorted, capped
        counts, then a single repeat/arange gather — the prefix-sum
        planning of the exemplar, without the per-query dict walk.
        """
        if self._codes_sorted is None:
            raise RuntimeError("fit() before query()")
        qc = self._codes(indptr, neighbors, query=True)
        n_q = qc.shape[1]
        lo = np.empty((self.n_bands, n_q), np.int64)
        hi = np.empty((self.n_bands, n_q), np.int64)
        for b in range(self.n_bands):
            lo[b] = np.searchsorted(self._codes_sorted[b], qc[b], "left")
            hi[b] = np.searchsorted(self._codes_sorted[b], qc[b], "right")
        cnt = np.minimum(hi - lo, self.max_per_band)
        # plan: flatten (band, query) slots, prefix-sum the capped
        # counts, expand to per-candidate (slot, within-bucket offset)
        flat_cnt = cnt.ravel()
        offs = np.concatenate([np.zeros(1, np.int64),
                               np.cumsum(flat_cnt)])
        total = int(offs[-1])
        slot = np.repeat(np.arange(flat_cnt.size), flat_cnt)
        within = np.arange(total, dtype=np.int64) - offs[slot]
        src = lo.ravel()[slot] + within
        band_of = slot // n_q
        q_of = slot % n_q
        nodes = self._order[band_of, src] if total else np.empty(0, np.int64)
        return _csr_unique_pairs(q_of, nodes, n_q, self._n_indexed)

    def candidate_labels(self, indptr: np.ndarray, neighbors: np.ndarray,
                         labels_of_indexed: np.ndarray, n_labels: int):
        """Candidate LABELS per query node: the labels carried by each
        query's bucket-mates, deduped and sorted per query — exactly the
        (flat, indptr) contract of ``lp_cold_assign(cand_labels=...)``.
        """
        nodes, iptr = self.query(indptr, neighbors)
        q_of = np.repeat(np.arange(iptr.size - 1, dtype=np.int64),
                         np.diff(iptr))
        lab = np.asarray(labels_of_indexed, np.int64)[nodes]
        return _csr_unique_pairs(q_of, lab, iptr.size - 1, n_labels)


def _side_candidates(indptr, neigh, warm_end, labels_side, opp_labels,
                     n_labels, neighbor_cap, **kw):
    """One side's cold candidate sets: fit the minhash index on the warm
    prefix of the side's CSR, query the cold tail, and union in the
    labels of up to ``neighbor_cap`` of each cold node's own neighbors.

    The neighbor nomination closes the structural hole a same-side
    index cannot: a label carried by NO warm same-side node (e.g. a
    lone opposite-side singleton the cold node should join) is
    invisible to bucket-mates, but the exact argmax is by definition a
    neighbor label — so for nodes with degree <= neighbor_cap the union
    is exhaustive (recall 1 by construction) and head nodes stay capped
    at O(n_bands * max_per_band + neighbor_cap) candidates, independent
    of the label-universe size."""
    indptr = np.asarray(indptr, np.int64)
    cut = int(indptr[warm_end])
    idx = MinHashIndex(**kw).fit(indptr[:warm_end + 1], neigh[:cut])
    q_iptr = indptr[warm_end:] - cut
    q_neigh = neigh[cut:]
    nodes, niptr = idx.query(q_iptr, q_neigh)
    q_of = np.repeat(np.arange(niptr.size - 1, dtype=np.int64),
                     np.diff(niptr))
    lab = np.asarray(labels_side, np.int64)[:warm_end][nodes]
    n_q = q_iptr.size - 1
    if neighbor_cap > 0:
        deg = np.diff(q_iptr)
        take = np.minimum(deg, neighbor_cap)
        offs = np.concatenate([np.zeros(1, np.int64), np.cumsum(take)])
        q2 = np.repeat(np.arange(n_q, dtype=np.int64), take)
        within = np.arange(int(offs[-1]), dtype=np.int64) - offs[q2]
        src = q_iptr[:-1][q2] + within
        lab2 = np.asarray(opp_labels, np.int64)[q_neigh[src]]
        q_of = np.concatenate([q_of, q2])
        lab = np.concatenate([lab, lab2])
    return _csr_unique_pairs(q_of, lab, n_q, n_labels)


def cold_candidate_sets(graph: BipartiteGraph, labels: np.ndarray,
                        n_new_users: int = 0, n_new_items: int = 0,
                        neighbor_cap: int = 32, **kw) -> dict:
    """The ``cand_labels`` dict for ``lp_cold_assign``: per cold node,
    the labels of warm same-side nodes with minhash-similar
    neighborhoods, unioned with up to ``neighbor_cap`` of the node's
    own neighbors' labels. Cold nodes are index suffixes of their sides
    (the stream layer's growth contract); the index is fit over the
    warm prefix only, so a cold node can never nominate another cold
    node's fresh singleton."""
    labels = np.asarray(labels, np.int64)
    nu, n = graph.n_users, graph.n_nodes
    out = {}
    if n_new_users:
        iptr, neigh = graph.user_csr()
        out["user"] = _side_candidates(iptr, neigh, nu - n_new_users,
                                       labels[:nu], labels[nu:], n,
                                       neighbor_cap, **kw)
    if n_new_items:
        iptr, neigh = graph.item_csr()
        out["item"] = _side_candidates(iptr, neigh,
                                       graph.n_items - n_new_items,
                                       labels[nu:], labels[:nu], n,
                                       neighbor_cap, **kw)
    return out


def prune_graph(graph: BipartiteGraph, labels: np.ndarray, **kw):
    """Warm-refresh pruning: drop edges whose candidate label neither
    side's minhash candidate set (nor the own-label edge set) contains,
    so a full refresh sweep scores O(bucket) labels per node.

    Each side is indexed AND queried over itself (self-buckets keep a
    node's own cluster reachable). Returns (pruned_graph, kept_frac);
    the pruned graph is approximate by construction — the engine knob
    keeps exact as default and the bench measures the quality delta.
    """
    labels = np.asarray(labels, np.int64)
    nu, n = graph.n_users, graph.n_nodes
    lab_u, lab_v = labels[:nu], labels[nu:]

    def side_keep(indptr, neigh, labels_side, opp_lab_of_edge, node_of_edge):
        idx = MinHashIndex(**kw).fit(indptr, neigh)
        flat, iptr = idx.candidate_labels(indptr, neigh, labels_side, n)
        m = np.int64(n) + 1
        reps = np.diff(iptr)
        ckeys = np.repeat(np.arange(reps.size, dtype=np.int64),
                          reps) * m + flat
        keys = node_of_edge.astype(np.int64) * m \
            + opp_lab_of_edge.astype(np.int64)
        if ckeys.size == 0:
            return np.zeros(keys.shape, bool)
        pos = np.minimum(np.searchsorted(ckeys, keys), ckeys.size - 1)
        return ckeys[pos] == keys

    u_iptr, u_neigh = graph.user_csr()
    v_iptr, v_neigh = graph.item_csr()
    keep = side_keep(u_iptr, u_neigh, lab_u, lab_v[graph.edge_v],
                     graph.edge_u)
    keep_v = side_keep(v_iptr, v_neigh, lab_v, lab_u[graph.edge_u[
        graph.perm_by_item]], graph.edge_v[graph.perm_by_item])
    inv = np.empty_like(graph.perm_by_item)
    inv[graph.perm_by_item] = np.arange(graph.perm_by_item.size,
                                        dtype=graph.perm_by_item.dtype)
    keep |= keep_v[inv]
    keep |= lab_u[graph.edge_u] == lab_v[graph.edge_v]   # own-cluster edges
    pruned = BipartiteGraph.from_edges(
        graph.n_users, graph.n_items, graph.edge_u[keep],
        graph.edge_v[keep], dedup=False)
    return pruned, float(keep.mean()) if keep.size else 1.0


def candidate_recall(cand: tuple, chosen_labels: np.ndarray,
                     own_labels: np.ndarray) -> float:
    """Fraction of nodes whose exact-assignment choice survives pruning:
    the chosen label is the node's own (kept singleton — always a
    candidate) or is in its candidate set. THE acceptance metric for
    ``candidates="minhash"``."""
    flat, iptr = cand
    chosen = np.asarray(chosen_labels, np.int64)
    own = np.asarray(own_labels, np.int64)
    n_q = iptr.size - 1
    if chosen.size != n_q or own.size != n_q:
        raise ValueError("chosen/own must have one entry per query node")
    hit = chosen == own
    if flat.size:
        m = np.int64(flat.max() if flat.size else 0) + chosen.max() + 2
        reps = np.diff(iptr)
        ckeys = np.repeat(np.arange(n_q, dtype=np.int64), reps) * m + flat
        keys = np.arange(n_q, dtype=np.int64) * m + chosen
        pos = np.minimum(np.searchsorted(ckeys, keys), ckeys.size - 1)
        hit |= ckeys[pos] == keys
    return float(hit.mean()) if n_q else 1.0
