"""Sketch container: the output of every ETC method in this framework.

A copy of ``repro.core.sketch`` (numpy only). A Sketch is the frozen
pre-training compression artifact: integer index arrays mapping each
user/item to codebook rows. Multi-hot sketches (SCU, double hashing)
carry up to ``n_hot`` indices per entity; lookup sums the rows (paper
§4.5 / §3.3).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["Sketch", "compact_labels"]


def compact_labels(labels: np.ndarray, *extra: np.ndarray):
    """Map arbitrary int labels (shared id space) to consecutive ints.

    Returns (K, mapped, *mapped_extra): the joint label universe of
    ``labels`` and every array in ``extra`` is compacted together so
    primary and secondary assignments index one codebook.
    """
    allv = np.concatenate([labels] + list(extra)) if extra else labels
    uniq, inv = np.unique(allv, return_inverse=True)
    out = []
    off = 0
    for arr in [labels] + list(extra):
        out.append(inv[off:off + arr.shape[0]].astype(np.int32))
        off += arr.shape[0]
    return (int(uniq.shape[0]), *out)


@dataclasses.dataclass(frozen=True)
class Sketch:
    """Compression mapping for one user table and one item table.

    user_idx: int32[|U|, H_u]  codebook row(s) per user (H_u-hot)
    item_idx: int32[|V|, H_v]  codebook row(s) per item
    k_users:  number of user codebook rows
    k_items:  number of item codebook rows
    """

    user_idx: np.ndarray
    item_idx: np.ndarray
    k_users: int
    k_items: int
    method: str = "unknown"
    meta: Optional[dict] = None

    def __post_init__(self):
        for name, arr, k in (("user_idx", self.user_idx, self.k_users),
                             ("item_idx", self.item_idx, self.k_items)):
            if arr.ndim != 2:
                raise ValueError(f"{name} must be [N, H]-shaped, got {arr.shape}")
            if arr.size and (arr.min() < 0 or arr.max() >= k):
                raise ValueError(f"{name} out of codebook range [0,{k})")

    @property
    def n_users(self) -> int:
        return int(self.user_idx.shape[0])

    @property
    def n_items(self) -> int:
        return int(self.item_idx.shape[0])

    def n_params(self, d: int) -> int:
        """Trainable embedding parameters under this sketch."""
        return (self.k_users + self.k_items) * d

    def compression_ratio(self, d: int) -> float:
        full = (self.n_users + self.n_items) * d
        return self.n_params(d) / max(full, 1)

    def state_arrays(self) -> dict:
        """The index arrays that define this sketch (deployable state)."""
        return {"user_idx": self.user_idx, "item_idx": self.item_idx}

    def meta_json(self) -> dict:
        """JSON-safe provenance: method + every scalar meta entry."""
        out = {"method": self.method}
        for k, v in (self.meta or {}).items():
            if isinstance(v, (bool, int, float, str)) or v is None:
                out[k] = v
            elif isinstance(v, np.integer):
                out[k] = int(v)
            elif isinstance(v, np.floating):
                out[k] = float(v)
        return out

    @staticmethod
    def from_state(arrays: dict, k_users: int, k_items: int,
                   method: str = "unknown",
                   meta: Optional[dict] = None) -> "Sketch":
        """Rebuild a Sketch from `state_arrays` output (validates ranges)."""
        return Sketch(np.asarray(arrays["user_idx"], np.int32),
                      np.asarray(arrays["item_idx"], np.int32),
                      int(k_users), int(k_items), method=method, meta=meta)

    # -- dense views (tests / small graphs) ---------------------------------
    def dense_Y_user(self) -> np.ndarray:
        y = np.zeros((self.n_users, self.k_users), dtype=np.float32)
        for h in range(self.user_idx.shape[1]):
            y[np.arange(self.n_users), self.user_idx[:, h]] = 1.0
        return y

    def dense_Y_item(self) -> np.ndarray:
        y = np.zeros((self.n_items, self.k_items), dtype=np.float32)
        for h in range(self.item_idx.shape[1]):
            y[np.arange(self.n_items), self.item_idx[:, h]] = 1.0
        return y

    @staticmethod
    def one_hot(user_labels: np.ndarray, item_labels: np.ndarray,
                method: str = "unknown",
                meta: Optional[dict] = None) -> "Sketch":
        """A 1-hot sketch from per-side label arrays (auto-compacted)."""
        ku, ul = compact_labels(np.asarray(user_labels))
        kv, il = compact_labels(np.asarray(item_labels))
        return Sketch(ul[:, None], il[:, None], ku, kv, method=method,
                      meta=meta)
