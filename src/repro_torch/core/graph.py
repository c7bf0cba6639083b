"""Bipartite interaction graph: the substrate BACO clusters over.

A copy of ``repro.core.graph`` (numpy only), without the streamed
solver's block planning (``node_aligned_bounds``, ``edge_block_bounds``).
The port keeps its own copy so that it never imports the JAX package;
the same edges give the same arrays in both.

Stored as an edge list sorted by (user, item) with the item-order
permutation precomputed, so the label-propagation solver runs its
gather/segment passes without re-sorting. Derived views are memoized:
the arrays are immutable. ``from_edge_blocks`` (and the stream layer's
``StreamingGraph``) merge sorted key runs instead of re-sorting.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple

import numpy as np

__all__ = ["BipartiteGraph", "pad_rung"]


def pad_rung(n: int, floor: int = 8) -> int:
    """Next power of two >= n (and >= floor): the capacity-ladder rung."""
    n = max(int(n), 1)
    return max(int(floor), 1 << (n - 1).bit_length())


def _block_keys(n_users: int, n_items: int, edge_u, edge_v) -> np.ndarray:
    """Validated, deduped, sorted int64 keys u*n_items+v for one block."""
    eu = np.asarray(edge_u, dtype=np.int64)
    ev = np.asarray(edge_v, dtype=np.int64)
    if eu.shape != ev.shape or eu.ndim != 1:
        raise ValueError("edge_u/edge_v must be 1-D and equal length")
    if eu.size and (eu.min() < 0 or eu.max() >= n_users):
        raise ValueError("user index out of range")
    if ev.size and (ev.min() < 0 or ev.max() >= n_items):
        raise ValueError("item index out of range")
    return np.unique(eu * n_items + ev)


def _fresh_mask(a: np.ndarray, b: np.ndarray,
                ins: np.ndarray) -> np.ndarray:
    """Which entries of sorted-unique ``b`` are absent from sorted-
    unique ``a``, given ``ins = searchsorted(a, b)``."""
    if a.size == 0:
        return np.ones(b.shape, dtype=bool)
    return (ins == a.size) | (a[np.minimum(ins, a.size - 1)] != b)


def _merge_disjoint(a: np.ndarray, b: np.ndarray,
                    ins: np.ndarray) -> np.ndarray:
    """Merge sorted run ``a`` with sorted ``b`` DISJOINT from it, given
    ``ins = searchsorted(a, b)`` — one pass, no re-search."""
    out = np.empty(a.size + b.size, dtype=a.dtype if a.size else b.dtype)
    pos = ins + np.arange(b.size)
    mask = np.zeros(out.size, dtype=bool)
    mask[pos] = True
    out[mask] = b
    out[~mask] = a
    return out


def _merge_unique(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Merge two SORTED UNIQUE int64 runs into one (no full re-sort:
    O(|a| + |b| log |a|) via searchsorted insertion positions)."""
    if a.size == 0:
        return b
    if b.size == 0:
        return a
    ins = np.searchsorted(a, b)
    fresh = _fresh_mask(a, b, ins)
    return _merge_disjoint(a, b[fresh], ins[fresh])


@dataclasses.dataclass(frozen=True)
class BipartiteGraph:
    """User-item interaction graph G = (U ∪ V, E).

    Attributes:
      n_users: |U|
      n_items: |V|
      edge_u:  int32[E] user endpoint of each edge, sorted by (u, v)
      edge_v:  int32[E] item endpoint of each edge, sorted by (u, v)
      perm_by_item: int32[E] permutation such that edge_v[perm_by_item]
        is sorted (CSR of the transposed bi-adjacency).
    """

    n_users: int
    n_items: int
    edge_u: np.ndarray
    edge_v: np.ndarray
    perm_by_item: np.ndarray
    _cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    @staticmethod
    def from_edges(n_users: int, n_items: int, edge_u, edge_v,
                   dedup: bool = True,
                   chunk_size: Optional[int] = None) -> "BipartiteGraph":
        if chunk_size is not None:
            # one block at a time: no int64 copy of the full arrays
            if not dedup:
                raise ValueError("chunked build implies dedup")
            eu = np.asarray(edge_u)
            ev = np.asarray(edge_v)
            if eu.shape != ev.shape or eu.ndim != 1:
                raise ValueError("edge_u/edge_v must be 1-D and equal length")
            blocks = ((eu[i:i + chunk_size], ev[i:i + chunk_size])
                      for i in range(0, max(eu.size, 1), chunk_size))
            return BipartiteGraph.from_edge_blocks(n_users, n_items, blocks)
        edge_u = np.asarray(edge_u, dtype=np.int64)
        edge_v = np.asarray(edge_v, dtype=np.int64)
        if edge_u.shape != edge_v.shape or edge_u.ndim != 1:
            raise ValueError("edge_u/edge_v must be 1-D and equal length")
        if edge_u.size and (edge_u.min() < 0 or edge_u.max() >= n_users):
            raise ValueError("user index out of range")
        if edge_v.size and (edge_v.min() < 0 or edge_v.max() >= n_items):
            raise ValueError("item index out of range")
        key = edge_u * n_items + edge_v
        key = np.unique(key) if dedup else np.sort(key)
        return BipartiteGraph._from_sorted_keys(n_users, n_items, key)

    @staticmethod
    def from_edge_blocks(n_users: int, n_items: int,
                         blocks: Iterable[Tuple[np.ndarray, np.ndarray]],
                         ) -> "BipartiteGraph":
        """Streaming builder: ``blocks`` yields (edge_u, edge_v) chunks,
        each deduped and sorted on its own, then merged into the
        accumulated sorted unique-key run (no full re-sort per block)."""
        acc = np.empty(0, dtype=np.int64)
        for bu, bv in blocks:
            acc = _merge_unique(acc, _block_keys(n_users, n_items, bu, bv))
        return BipartiteGraph._from_sorted_keys(n_users, n_items, acc)

    @staticmethod
    def _from_sorted_keys(n_users: int, n_items: int,
                          key: np.ndarray) -> "BipartiteGraph":
        eu = (key // n_items).astype(np.int32)
        ev = (key % n_items).astype(np.int32)
        perm = np.argsort(ev, kind="stable").astype(np.int32)
        return BipartiteGraph(int(n_users), int(n_items), eu, ev, perm)

    def _memo(self, name: str, fn):
        if name not in self._cache:
            self._cache[name] = fn()
        return self._cache[name]

    @property
    def n_edges(self) -> int:
        return int(self.edge_u.shape[0])

    @property
    def n_nodes(self) -> int:
        return self.n_users + self.n_items

    def user_degrees(self) -> np.ndarray:
        return self._memo("user_deg", lambda: np.bincount(
            self.edge_u, minlength=self.n_users).astype(np.int64))

    def item_degrees(self) -> np.ndarray:
        return self._memo("item_deg", lambda: np.bincount(
            self.edge_v, minlength=self.n_items).astype(np.int64))

    def density(self) -> float:
        return self.n_edges / float(max(1, self.n_users) * max(1, self.n_items))

    # -- adjacency views ---------------------------------------------------
    def user_csr(self):
        """(indptr, item_indices) neighbor lists per user. Memoized."""
        def build():
            indptr = np.zeros(self.n_users + 1, dtype=np.int64)
            np.cumsum(self.user_degrees(), out=indptr[1:])
            return indptr, self.edge_v
        return self._memo("user_csr", build)

    def item_csr(self):
        """(indptr, user_indices) neighbor lists per item. Memoized."""
        def build():
            indptr = np.zeros(self.n_items + 1, dtype=np.int64)
            np.cumsum(self.item_degrees(), out=indptr[1:])
            return indptr, self.edge_u[self.perm_by_item]
        return self._memo("item_csr", build)

    def edges_by_item(self):
        """(edge_v_sorted, edge_u_by_item): both endpoint arrays in the
        by-item ordering (the item half-step's orientation). Memoized."""
        return self._memo("edges_by_item", lambda: (
            self.edge_v[self.perm_by_item], self.edge_u[self.perm_by_item]))
