"""Host-side hot-user response cache (port of ``repro.frontdoor.cache``).

Recommender traffic is Zipfian: a small set of hot users generates a
disproportionate share of requests, and between model publications their
top-k is CONSTANT (scoring is deterministic in (params, statics, user)).
So the front end can answer repeat requests from host memory and spend
device time only on the cold tail.

Keying rule: entries are keyed (tenant, user_id) and the whole tenant
shard is dropped on that tenant's swap — a new artifact version changes
every user's scores, so per-user invalidation cannot be finer than the
publication itself. Capacity is bounded (LRU): this is a HOT-user cache,
not a materialized scores table.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

__all__ = ["HotUserCache"]


class HotUserCache:
    """Bounded LRU of per-user top-k rows, sharded by tenant."""

    def __init__(self, max_entries: int = 4096):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = int(max_entries)
        self._rows: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._rows)

    def get(self, tenant: str, user_ids: np.ndarray
            ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """All-or-nothing lookup: the stacked (values, items) rows for
        the whole request, or None on any miss. Partial assembly would
        still need a device pass for the misses, so a mixed request is
        simply served whole (and re-cached) by the batcher."""
        with self._lock:
            vals, items = [], []
            for uid in np.asarray(user_ids).tolist():
                row = self._rows.get((tenant, uid))
                if row is None:
                    return None
                vals.append(row[0])
                items.append(row[1])
            for uid in np.asarray(user_ids).tolist():
                self._rows.move_to_end((tenant, uid))
        return np.stack(vals), np.stack(items)

    def put(self, tenant: str, user_ids: np.ndarray,
            values: np.ndarray, items: np.ndarray) -> None:
        """Insert one response's rows (evicting least-recently-used
        entries past capacity)."""
        values = np.asarray(values)
        items = np.asarray(items)
        with self._lock:
            for i, uid in enumerate(np.asarray(user_ids).tolist()):
                self._rows[(tenant, uid)] = (values[i], items[i])
                self._rows.move_to_end((tenant, uid))
            while len(self._rows) > self.max_entries:
                self._rows.popitem(last=False)

    def invalidate(self, tenant: str) -> int:
        """Drop every entry of one tenant (called under the dispatch
        lock on swap, so no batch can re-populate stale rows in the
        gap). Returns the number of entries dropped."""
        with self._lock:
            stale = [k for k in self._rows if k[0] == tenant]
            for k in stale:
                del self._rows[k]
        return len(stale)

    def clear(self) -> None:
        with self._lock:
            self._rows.clear()
