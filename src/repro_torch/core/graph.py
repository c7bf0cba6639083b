"""Bipartite interaction graph: the substrate BACO clusters over.

A copy of ``repro.core.graph`` (numpy only), cut to what the serving
slice reads. The port keeps its own copy so that it never imports the
JAX package; the same edges give the same arrays in both.

Stored as an edge list sorted by (user, item) with the item-order
permutation precomputed, so the label-propagation solver runs its
gather/segment passes without re-sorting. Derived views are memoized:
the arrays are immutable.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["BipartiteGraph", "pad_rung"]


def pad_rung(n: int, floor: int = 8) -> int:
    """Next power of two >= n (and >= floor): the capacity-ladder rung."""
    n = max(int(n), 1)
    return max(int(floor), 1 << (n - 1).bit_length())


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
                   dedup: bool = True) -> "BipartiteGraph":
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
