"""EmbeddingEngine: one dispatch layer for every embedding lookup
(port of ``repro.embedding.engine``).

Three lookup kinds share one ``EmbeddingSpec``-driven API:

  * full      e = T[i]                   (uncompressed table)
  * codebook  e = Σ_h Z[sketch[i, h]]    with the BINARY-Y rule: a
              duplicate sketch index contributes once (paper §3.2)
  * bag       e_b = Σ_{i in bag b} T[i]  (EmbeddingBag; multi-hot fields)

Backends (registry):

  * "gather": plain tensor indexing and an ordered segment sum — any
              device.
  * "onehot": one-hot matmul; no bags (the [nnz, N] one-hot would dwarf
              the table).
  * "cuda":   the hand-written kernels (codebook_lookup, the CSR
              gather-sum) with deterministic kernel gradients, registered
              by ``repro_torch.kernels.ops`` on first use.

Auto-selection: every kind on a CUDA tensor goes to "cuda", on the CPU
to "gather". A weighted bag goes to "gather" (the reference's rule).
Bags may come in any segment order on every backend: the reference's
second rule, which sends an unsorted bag that is not declared sorted
to "gather", exists for its Pallas kernel, which takes only sorted
bags; the CUDA bag kernel's wrapper sorts them.

Fused scorers (registry, same dispatch one level up): "cuda", the
fused_topk kernel with its codebook variant, is the one scorer. ``topk``
is the dense readout's top-k: ``lax.top_k``'s order over the f32 bits
(``ref.topk_total_order``), as the reference's dense scorers use it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.kernels.ref import dedup_keep_mask, segment_sum
from repro_torch.kernels.ref import topk_total_order as topk

__all__ = ["EmbeddingSpec", "EmbeddingEngine", "LookupBackend",
           "register_backend", "get_backend", "available_backends",
           "normalize_backend", "dedup_keep_mask", "embedding_lookup",
           "embedding_block_lookup", "bag_combine", "register_scorer", "get_scorer",
           "available_scorers", "fused_topk", "topk"]


@dataclasses.dataclass(frozen=True)
class EmbeddingSpec:
    """Static description of one (possibly compressed) table."""
    n_rows: int                     # logical vocabulary size
    dim: int
    k_rows: Optional[int] = None    # codebook rows if compressed
    n_hot: int = 1                  # sketch multiplicity (SCU -> 2)
    combine: str = "sum"

    @property
    def compressed(self) -> bool:
        return self.k_rows is not None

    @property
    def table_rows(self) -> int:
        """Rows of the parameter table: the codebook's if compressed."""
        return self.k_rows if self.compressed else self.n_rows


def bag_combine(out, segment_ids, num_segments: int, mode: str):
    """Sum -> mean post-processing shared by the bag backends: empty bags
    keep their zero rows (the count is clamped to 1)."""
    if mode == "mean":
        cnt = torch.bincount(segment_ids.long(), minlength=num_segments)
        out = out / cnt.clamp(min=1).to(out.dtype)[:, None]
    elif mode != "sum":
        raise ValueError(f"unknown mode {mode!r}")
    return out


class LookupBackend:
    """One strategy for the three lookup kinds. Subclass + register.

    Contract (held against the JAX package by tests/test_torch_embedding.py):
      full(table [N,d], ids [...])                     -> [..., d]
      codebook_sum(codebook [K,d], rows_idx [..., H])  -> [..., d]
          sum over h of codebook[rows_idx[..., h]], where a repeated
          index in a row counts once (first occurrence; binary Y).
      bag(table, values [nnz], segment_ids [nnz], num_segments,
          mode, weights)                               -> [num_segments, d]
    Each is differentiable in the table.
    """
    name: str = "?"
    # capability flag consulted by the engine's dispatch
    supports_bag_weights: bool = True     # per-value scaling in bag()

    def supports(self, kind: str) -> bool:
        return True

    def full(self, table, ids):
        raise NotImplementedError

    def codebook_sum(self, codebook, rows_idx):
        raise NotImplementedError

    def bag(self, table, values, segment_ids, num_segments, mode="sum",
            weights=None):
        raise NotImplementedError

    def block(self, table, ids, lo: int):
        """Rows of a row block ``table`` [N, d] (rows [lo, lo + N) of a
        larger table) for global ids [...]: the block's rows, exact zeros
        for ids outside it, in the block's dtype (an int block too);
        differentiable in the block."""
        local = ids.long() - lo
        inr = (local >= 0) & (local < table.shape[0])
        rows = self.full(table, torch.where(inr, local, 0))
        return torch.where(inr[..., None], rows, 0)


_REGISTRY: Dict[str, LookupBackend] = {}


def register_backend(backend: LookupBackend) -> LookupBackend:
    _REGISTRY[backend.name] = backend
    return backend


def _ensure_registered():
    # the "cuda" backend and scorer live with their kernels
    if "cuda" not in _REGISTRY:
        import repro_torch.kernels.ops  # noqa: F401


def get_backend(name: str) -> LookupBackend:
    _ensure_registered()
    if name not in _REGISTRY:
        raise KeyError(f"unknown lookup backend {name!r}; "
                       f"registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available_backends():
    _ensure_registered()
    return tuple(sorted(_REGISTRY))


def normalize_backend(name: Optional[str]) -> Optional[str]:
    """"auto"/None mean auto-selection (None); anything else must name a
    registered backend (KeyError otherwise, listing what exists)."""
    if name is None or name == "auto":
        return None
    get_backend(name)
    return name


_SCORERS: Dict[str, Any] = {}


def register_scorer(name: str, fn) -> None:
    _SCORERS[name] = fn


def get_scorer(name: str):
    _ensure_registered()
    if name not in _SCORERS:
        raise KeyError(f"unknown fused scorer {name!r}; "
                       f"registered: {sorted(_SCORERS)}")
    return _SCORERS[name]


def available_scorers():
    _ensure_registered()
    return tuple(sorted(_SCORERS))


def fused_topk(u, items, k, *, sketch=None, scale=None, mask=None,
               exclude=None, block=None):
    """One-pass (gather ->) score -> top-k over the item axis.

    Returns ``(values [B, k] f32, ids [B, k] int32)`` equal to the top-k
    of ``u @ V.T + mask`` with ``lax.top_k``'s order, where ``V`` is
    ``items`` [N, d], or the codebook expansion Σ_h items[sketch[:, h]]
    (binary-Y dedup) when ``sketch`` int32 [N, H] is given, without the
    [B, N] score matrix or the expanded table (scorer "cuda"). int8
    ``items`` dequantize through the per-row f32 ``scale`` (per codebook
    row with a sketch); ``exclude`` is a (rows, cols) pair scored -inf.
    """
    return get_scorer("cuda")(u, items, k, sketch=sketch, scale=scale,
                              mask=mask, exclude=exclude, block=block)


def _take(table, ids):
    """table[ids] with a backward that adds repeated rows in a fixed
    order on its device: on the CPU ``index_select`` (backward
    ``index_add_``, serial in index order; the backward of ``table[ids]``,
    an accumulating ``index_put_``, adds in no fixed order on a
    multi-threaded CPU), on a GPU ``table[ids]`` (its backward sorts the
    indices; ``index_add_`` there adds with atomics)."""
    if table.device.type != "cpu":
        return table[ids]
    return table.index_select(0, ids.reshape(-1)).reshape(
        *ids.shape, *table.shape[1:])


class GatherBackend(LookupBackend):
    """Plain tensor indexing — the safe default on every device. Bags sum
    each segment in value order (``kernels.ref.segment_sum``), as the
    reference's ``segment_sum`` does on the CPU."""
    name = "gather"

    def full(self, table, ids):
        return _take(table, ids)

    def codebook_sum(self, codebook, rows_idx):
        keep = dedup_keep_mask(rows_idx)
        rows = _take(codebook, rows_idx)                   # [..., H, d]
        return torch.where(keep[..., None], rows, 0.0).sum(dim=-2)

    def bag(self, table, values, segment_ids, num_segments, mode="sum",
            weights=None):
        rows = _take(table, values)
        if weights is not None:
            rows = rows * weights[:, None]
        out = segment_sum(rows, segment_ids, num_segments)
        return bag_combine(out, segment_ids, num_segments, mode)


class OneHotBackend(LookupBackend):
    """One-hot matmul: a GEMM instead of a gather. No bag support — the
    [nnz, N] one-hot would dwarf the table."""
    name = "onehot"

    def supports(self, kind):
        return kind != "bag"

    def full(self, table, ids):
        oh = torch.nn.functional.one_hot(ids.long(), table.shape[0])
        return oh.to(table.dtype) @ table

    def codebook_sum(self, codebook, rows_idx):
        oh = torch.nn.functional.one_hot(rows_idx.long(), codebook.shape[0])
        oh = oh.to(codebook.dtype) * dedup_keep_mask(rows_idx)[..., None]
        return torch.einsum("...hk,kd->...d", oh, codebook)


register_backend(GatherBackend())
register_backend(OneHotBackend())


@dataclasses.dataclass(frozen=True)
class EmbeddingEngine:
    """Routes lookups for one table through the selected backend.

    backend: explicit override ("gather" | "onehot" | "cuda" | None/"auto").
    """
    spec: EmbeddingSpec
    backend: Optional[str] = None

    @property
    def explicit(self) -> bool:
        return self.backend not in (None, "auto")

    def resolve(self, kind: str, device: torch.device) -> LookupBackend:
        """The override (which must support ``kind``), else "cuda" on a
        CUDA device, else "gather"."""
        if self.explicit:
            be = get_backend(self.backend)
            if not be.supports(kind):
                raise ValueError(
                    f"backend {be.name!r} does not support {kind!r} lookups")
            return be
        return get_backend("cuda" if device.type == "cuda" else "gather")

    def full_lookup(self, table, ids):
        """table [N, d], ids int [...] -> [..., d]."""
        return self.resolve("full", table.device).full(table, ids)

    def block_lookup(self, table, ids, lo: int):
        """A row block's lookup: ``table`` [N, d] holds rows [lo, lo + N)
        of a larger table, ids int [...] are global -> [..., d], exact
        zeros where an id lies outside the block (each rank's part of a
        row-sharded lookup: ``models.recsys.row_lookup``, the LMs' token
        embedding over the model axis)."""
        return self.resolve("full", table.device).block(table, ids, lo)

    def codebook_lookup(self, codebook, sketch_idx, ids=None, combine=None):
        """Compressed lookup e = Σ_h Z[sketch[i, h]] (paper §3.2/§4.5).

        codebook [K, d], sketch_idx int [N, H], ids int [...] -> [..., d];
        ``ids=None`` looks up every row, [N, d]. Duplicate sketch indices
        contribute once (binary Y) on every backend. ``combine`` ("sum" or
        "mean", default the spec's) divides by H for "mean".
        """
        combine = combine or self.spec.combine
        if combine not in ("sum", "mean"):
            raise ValueError(f"unknown combine {combine!r}")
        rows_idx = sketch_idx if ids is None else sketch_idx[ids]
        out = self.resolve("codebook", codebook.device).codebook_sum(
            codebook, rows_idx)
        return out / rows_idx.shape[-1] if combine == "mean" else out

    def bag_lookup(self, table, values, segment_ids, num_segments: int,
                   mode: str = "sum", weights=None,
                   indices_sorted: bool = False):
        """EmbeddingBag: table [N, d], values int [nnz], segment_ids int
        [nnz] in any order -> [num_segments, d]. Empty bags produce zero
        rows; each bag adds its values in their order in ``values``.

        Weighted bags go to a backend with per-value scaling ("gather").
        indices_sorted: the reference's declaration that segment_ids are
        sorted, which chooses its backend; accepted for its signature and
        not needed here, since every backend takes bags in any order.
        """
        be = self.resolve("bag", table.device)
        if weights is not None and not be.supports_bag_weights:
            be = get_backend("gather")
        return be.bag(table, values, segment_ids, num_segments,
                      mode=mode, weights=weights)

    def lookup(self, table, ids, sketch=None, combine=None):
        """One entry point for call sites: the codebook path when a sketch
        is given, the full-table path otherwise (a compressed spec needs
        its sketch)."""
        if sketch is not None:
            return self.codebook_lookup(table, sketch, ids, combine=combine)
        if self.spec.compressed:
            raise ValueError("spec is compressed but no sketch was given")
        return self.full_lookup(table, ids)


def embedding_lookup(table, ids, *, backend: Optional[str] = None):
    """Full-table lookup for call sites without a persistent spec."""
    spec = EmbeddingSpec(n_rows=int(table.shape[0]), dim=int(table.shape[-1]))
    return EmbeddingEngine(spec, backend=backend).full_lookup(table, ids)


def embedding_block_lookup(table, ids, lo: int, *,
                           backend: Optional[str] = None):
    """A row block's lookup (:meth:`EmbeddingEngine.block_lookup`) for
    call sites without a persistent spec."""
    spec = EmbeddingSpec(n_rows=int(table.shape[0]), dim=int(table.shape[-1]))
    return EmbeddingEngine(spec, backend=backend).block_lookup(table, ids, lo)
