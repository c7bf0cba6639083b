"""Ranking metrics: Recall@K and NDCG@K (port of ``repro.training.eval``).

Two top-k paths:

* ``topk_from_scores`` — dense host numpy over a materialized
  [n_users, n_items] score matrix (small fixtures, the parity oracle);
  copied from the reference.
* ``topk_streaming`` — on the embeddings' device: items are scored in
  fixed-size blocks against a running top-k, and training interactions
  are set to -inf in each block on the device. Peak memory is
  O(users x block + users x k); the full score matrix never exists.
  ``Trainer.evaluate`` uses this path.

Ties rank as under ``lax.top_k`` (highest value first, the lowest
position among equal values, over the total order of the f32 bits):
``kernels.ref.topk_total_order``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels.ref import topk_total_order

__all__ = ["recall_ndcg_at_k", "topk_from_scores", "topk_streaming"]


def topk_from_scores(scores: np.ndarray, k: int,
                     exclude: Tuple[np.ndarray, np.ndarray] | None = None,
                     ) -> np.ndarray:
    """Row-wise top-k item ids, masking out training interactions.

    ``exclude`` index arrays are forced to int dtype — an empty
    ``np.asarray([])`` is float64, which numpy would otherwise treat as
    an (invalid) fancy float index."""
    s = np.array(scores, dtype=np.float32, copy=True)
    if exclude is not None:
        rows = np.asarray(exclude[0], dtype=np.intp)
        cols = np.asarray(exclude[1], dtype=np.intp)
        if rows.size:
            s[rows, cols] = -np.inf
    idx = np.argpartition(-s, kth=min(k, s.shape[1] - 1), axis=1)[:, :k]
    part = np.take_along_axis(s, idx, axis=1)
    order = np.argsort(-part, axis=1)
    return np.take_along_axis(idx, order, axis=1)


def _exclusion_blocks(exclude, nb: int, block: int, m: int):
    """Bucket (row, item) exclusion pairs per item block, padded to the
    max bucket size with row sentinel ``m`` (a row no score has).
    Returns host int32 (ex_r, ex_c) of shape [nb, E]."""
    if exclude is not None and np.asarray(exclude[0]).size:
        rows = np.asarray(exclude[0], dtype=np.int32)
        cols = np.asarray(exclude[1], dtype=np.int32)
        order = np.argsort(cols, kind="stable")
        rows, cols = rows[order], cols[order]
        bounds = np.searchsorted(cols, np.arange(nb + 1, dtype=np.int64)
                                 * block)
        emax = max(1, int(np.max(np.diff(bounds))))
        ex_r = np.full((nb, emax), m, dtype=np.int32)     # sentinel: row m
        ex_c = np.zeros((nb, emax), dtype=np.int32)
        for b in range(nb):
            lo, hi = int(bounds[b]), int(bounds[b + 1])
            ex_r[b, :hi - lo] = rows[lo:hi]
            ex_c[b, :hi - lo] = cols[lo:hi] - b * block
    else:
        ex_r = np.full((nb, 1), m, dtype=np.int32)
        ex_c = np.zeros((nb, 1), dtype=np.int32)
    return ex_r, ex_c


def _merge_block(vals, idx, u, v_block, er, ec, i0: int, n: int, k: int):
    """One block merge, op for op the reference's: score the block,
    -inf for padding items and for excluded pairs (the sentinel row m
    lands in a scratch row), then the top-k of [block | carry]. Block
    candidates come FIRST, so among equal values the block's real item
    ids beat the carry's placeholders."""
    m, blk = u.shape[0], v_block.shape[0]
    col = i0 + torch.arange(blk, dtype=torch.int32, device=u.device)
    s = torch.empty(m + 1, blk, dtype=torch.float32, device=u.device)
    s[:m] = torch.where(col[None, :] < n, u @ v_block.T, float("-inf"))
    s[er.long(), ec.long()] = float("-inf")
    cand_vals = torch.cat([s[:m], vals], dim=1)
    cand_idx = torch.cat([col[None, :].expand(m, blk), idx], dim=1)
    top_vals, pos = topk_total_order(cand_vals, k)
    return top_vals, torch.gather(cand_idx, 1, pos.long())


def topk_streaming(u_emb, v_emb, k: int, *, block: int = 4096,
                   exclude: Tuple[np.ndarray, np.ndarray] | None = None,
                   backend: str = "block") -> np.ndarray:
    """Row-wise top-k of ``u_emb @ v_emb.T`` without the score matrix.

    ``u_emb`` [m, d] / ``v_emb`` [n, d] are tensors (the scores are
    computed on their device); items are processed in blocks of
    ``block``: each block's [m, block] scores are computed, excluded
    (row, item) pairs falling in the block are set to -inf, and the top-k
    of [block scores | running top-k] becomes the running top-k.
    Exclusion pairs are bucketed per block on the host (indices only)
    and padded with a sentinel row.

    backend (the reference's fill semantics, ``eval.py:157-170``):
      * "block"    (default) the block inputs stacked on the device up
        front, then one merge per block; the same ids as "hostloop".
      * "hostloop" one block's inputs at a time from the host.
      * "fused"    the fused_topk kernel (``repro_torch.embedding.
        fused_topk``) with its own exclusions: no [m, block] score matrix
        either; rows with fewer than k scoreable items fill with the
        lowest-id -inf items, where "block"/"hostloop" fill them with
        block-local ids.

    Within a block ties break toward the lower item id on every backend.
    Returns host int32 [m, k] item ids.
    """
    m = int(u_emb.shape[0])
    n = int(v_emb.shape[0])
    if k > n:
        raise ValueError(f"k={k} exceeds n_items={n}")
    if backend not in ("block", "hostloop", "fused"):
        raise ValueError(f"unknown topk_streaming backend {backend!r}; "
                         f"expected block|hostloop|fused")
    u = torch.as_tensor(u_emb).float()
    v = torch.as_tensor(v_emb, device=u.device).float()
    dev = u.device

    if backend == "fused":
        from repro_torch.embedding import fused_topk
        ex = None
        if exclude is not None and np.asarray(exclude[0]).size:
            ex = tuple(torch.as_tensor(np.asarray(a, np.int64), device=dev)
                       for a in exclude)
        _, idx = fused_topk(u.contiguous(), v.contiguous(), k, exclude=ex,
                            block=block)
        return idx.cpu().numpy().astype(np.int32)

    block = int(min(max(block, k), n))
    nb = -(-n // block)
    ex_r, ex_c = _exclusion_blocks(exclude, nb, block, m)
    pad = nb * block - n
    if pad:
        v = torch.cat([v, torch.zeros(pad, v.shape[1], dtype=v.dtype,
                                      device=dev)])
    vals = torch.full((m, k), float("-inf"), dtype=torch.float32, device=dev)
    idx = torch.zeros((m, k), dtype=torch.int32, device=dev)
    if backend == "block":
        v_blocks = v.reshape(nb, block, -1)
        er_all = torch.as_tensor(ex_r, device=dev)
        ec_all = torch.as_tensor(ex_c, device=dev)
        for b in range(nb):
            vals, idx = _merge_block(vals, idx, u, v_blocks[b], er_all[b],
                                     ec_all[b], b * block, n, k)
    else:
        for b in range(nb):
            vals, idx = _merge_block(
                vals, idx, u, v[b * block:(b + 1) * block],
                torch.as_tensor(ex_r[b], device=dev),
                torch.as_tensor(ex_c[b], device=dev), b * block, n, k)
    return idx.cpu().numpy()


def recall_ndcg_at_k(topk: np.ndarray, test_user: np.ndarray,
                     test_item: np.ndarray, user_ids: np.ndarray,
                     k: int = 20) -> Dict[str, float]:
    """topk [n_eval_users, k] from a top-k path above; metrics averaged
    over users that have at least one test interaction (paper protocol).
    Recall@K = hits / |test items| — the standard LightGCN/GraphHash
    denominator (NOT min(|test|, k), which inflates recall for users
    with more than K held-out items)."""
    from collections import defaultdict
    truth = defaultdict(set)
    for u, i in zip(test_user, test_item):
        truth[int(u)].add(int(i))
    recalls, ndcgs = [], []
    inv_log = 1.0 / np.log2(np.arange(2, k + 2))
    for row, u in zip(topk, user_ids):
        t = truth.get(int(u))
        if not t:
            continue
        hits = np.asarray([int(i) in t for i in row[:k]], dtype=np.float32)
        recalls.append(hits.sum() / len(t))
        dcg = float((hits * inv_log).sum())
        idcg = float(inv_log[:min(len(t), k)].sum())
        ndcgs.append(dcg / idcg if idcg > 0 else 0.0)
    if not recalls:
        return {"recall": 0.0, "ndcg": 0.0, "n_users": 0}
    return {"recall": float(np.mean(recalls)),
            "ndcg": float(np.mean(ndcgs)), "n_users": len(recalls)}
