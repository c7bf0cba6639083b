"""StreamingGraph: an append-only incremental view over BipartiteGraph
(port of ``repro.stream.graph``; numpy only, as the reference).

The paper's production setting is a live system: new users, items and
interactions arrive continuously (PAPER.md §4.3), but ``BipartiteGraph``
is an immutable snapshot. ``StreamingGraph`` keeps the canonical state
as the sorted-unique int64 key run ``u * n_items + v`` (exactly the
representation ``BipartiteGraph.from_edge_blocks`` accumulates) and
merges each arriving edge block into it with the same searchsorted
run-merge — never a full re-sort.

Memo discipline: appends invalidate only the derived views they touch.
Degrees are maintained *incrementally* (exact int64 bincount adds, so
they are bitwise what a recount would produce) and are seeded into the
rebuilt snapshot's memo cache; CSR views and the by-item permutation
depend on global edge positions, so they rebuild lazily on the next
``graph`` access. The invariant (held against the
reference in tests/test_torch_stream.py) is that ``StreamingGraph`` state after any
sequence of ``grow``/``append`` calls is **bitwise equal** to a one-shot
``BipartiteGraph.from_edges`` over the union of everything appended.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.graph import (BipartiteGraph, _block_keys,
                                    _fresh_mask, _merge_disjoint)

__all__ = ["StreamingGraph", "AppendInfo"]


@dataclasses.dataclass(frozen=True)
class AppendInfo:
    """What one ``append`` actually changed (after dedup)."""

    n_appended: int            # edges offered to append()
    n_new_edges: int           # edges actually new (not already present)
    touched_users: np.ndarray  # sorted unique users with >= 1 new edge
    touched_items: np.ndarray  # sorted unique items with >= 1 new edge


class StreamingGraph:
    """Append-only bipartite interaction graph.

    State: ``n_users`` / ``n_items`` (monotone non-decreasing via
    ``grow``), the sorted-unique key run, and incrementally maintained
    degree arrays. ``graph`` materializes an immutable
    ``BipartiteGraph`` snapshot (cached until the next mutation) with
    the degree memos pre-seeded.
    """

    def __init__(self, n_users: int, n_items: int):
        self.n_users = int(n_users)
        self.n_items = int(n_items)
        self._keys = np.empty(0, dtype=np.int64)
        self._user_deg = np.zeros(self.n_users, dtype=np.int64)
        self._item_deg = np.zeros(self.n_items, dtype=np.int64)
        self._graph: Optional[BipartiteGraph] = None
        self.version = 0

    @classmethod
    def from_graph(cls, graph: BipartiteGraph) -> "StreamingGraph":
        """Wrap an existing snapshot (shares no mutable state with it)."""
        sg = cls(graph.n_users, graph.n_items)
        sg._keys = (graph.edge_u.astype(np.int64) * graph.n_items
                    + graph.edge_v.astype(np.int64))
        sg._user_deg = graph.user_degrees().copy()
        sg._item_deg = graph.item_degrees().copy()
        sg._graph = graph
        return sg

    # -- sizes --------------------------------------------------------------
    @property
    def n_edges(self) -> int:
        return int(self._keys.shape[0])

    @property
    def n_nodes(self) -> int:
        return self.n_users + self.n_items

    def user_degrees(self) -> np.ndarray:
        return self._user_deg

    def item_degrees(self) -> np.ndarray:
        return self._item_deg

    # -- mutation -----------------------------------------------------------
    def grow(self, n_users: Optional[int] = None,
             n_items: Optional[int] = None) -> Tuple[int, int]:
        """Grow the universe to ``n_users`` x ``n_items`` TOTALS.

        Shrinking is not a stream operation (edges never disappear);
        passing a smaller total raises. Growing the item side re-encodes
        the key run (keys are ``u * n_items + v``); the map is monotone
        in (u, v), so the run stays sorted-unique without a re-sort.
        Returns (n_new_users, n_new_items).
        """
        new_nu = self.n_users if n_users is None else int(n_users)
        new_nv = self.n_items if n_items is None else int(n_items)
        if new_nu < self.n_users or new_nv < self.n_items:
            raise ValueError(
                f"grow() cannot shrink: have {self.n_users}x{self.n_items}, "
                f"asked {new_nu}x{new_nv}")
        d_users = new_nu - self.n_users
        d_items = new_nv - self.n_items
        if d_users == 0 and d_items == 0:
            return 0, 0
        if d_items and self._keys.size:
            u = self._keys // self.n_items
            v = self._keys % self.n_items
            self._keys = u * np.int64(new_nv) + v
        self.n_users = new_nu
        self.n_items = new_nv
        if d_users:
            self._user_deg = np.concatenate(
                [self._user_deg, np.zeros(d_users, dtype=np.int64)])
        if d_items:
            self._item_deg = np.concatenate(
                [self._item_deg, np.zeros(d_items, dtype=np.int64)])
        self._graph = None
        self.version += 1
        return d_users, d_items

    def append(self, edge_u, edge_v) -> AppendInfo:
        """Merge one edge block into the graph (validated, deduped both
        against itself and against the existing edge set).

        The fresh sub-run is merged into the accumulated key run with
        the ``from_edge_blocks`` searchsorted run-merge; degrees are
        updated by exact integer bincount adds, so the next snapshot's
        degree memos are pre-seeded rather than recomputed.
        """
        n_offered = int(np.asarray(edge_u).shape[0])
        block = _block_keys(self.n_users, self.n_items, edge_u, edge_v)
        if block.size == 0:
            return AppendInfo(int(n_offered), 0,
                              np.empty(0, np.int64), np.empty(0, np.int64))
        a = self._keys
        ins = np.searchsorted(a, block)
        keep = _fresh_mask(a, block, ins)
        fresh = block[keep]
        if fresh.size == 0:
            return AppendInfo(int(n_offered), 0,
                              np.empty(0, np.int64), np.empty(0, np.int64))
        eu = fresh // self.n_items
        ev = fresh % self.n_items
        self._keys = _merge_disjoint(a, fresh, ins[keep])
        # NOT in-place: snapshots seeded with these arrays stay frozen
        self._user_deg = self._user_deg + np.bincount(
            eu, minlength=self.n_users)
        self._item_deg = self._item_deg + np.bincount(
            ev, minlength=self.n_items)
        self._graph = None
        self.version += 1
        return AppendInfo(int(n_offered), int(fresh.size),
                          np.unique(eu), np.unique(ev))

    # -- snapshot -----------------------------------------------------------
    @property
    def graph(self) -> BipartiteGraph:
        """The current immutable snapshot (cached until the next
        mutation). Degree memos are seeded from the incrementally
        maintained arrays — bitwise what a from-scratch recount gives —
        while positional views (CSR, by-item permutation) rebuild."""
        if self._graph is None:
            g = BipartiteGraph._from_sorted_keys(self.n_users, self.n_items,
                                                 self._keys)
            g._cache["user_deg"] = self._user_deg
            g._cache["item_deg"] = self._item_deg
            self._graph = g
        return self._graph
