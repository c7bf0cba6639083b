"""Architecture registry (port of ``repro.configs.registry``).

Each ``configs/<arch>.py`` module of the port registers an ArchSpec with:
  * full_config():   the exact published configuration
  * smoke_config():  reduced same-family config (CPU tests)
  * shapes:          the arch's assigned input-shape set
  * family:          "lm" | "gnn" | "recsys" | "cf" — selects the step
                     builders in launch/steps.py

The port registers every arch of the reference: the recsys family
(DLRM, Wide&Deep, SASRec, BERT4Rec), the paper's own backbone
(``lightgcn-baco``, family "cf"), the LM family (gemma2-9b, gemma3-12b,
qwen1.5-32b and the MoE LMs dbrx-132b and kimi-k2-1t-a32b) and the GNN
(schnet), each on one card and over a mesh. ``UNPORTED_ARCHS`` is
empty; ``not_ported`` makes the error that names the ROADMAP item a
feature still waits for.

Shape kinds: train | prefill | decode | serve | retrieval.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict, Optional, Tuple

__all__ = ["ArchSpec", "ShapeSpec", "register", "get_arch", "list_archs",
           "all_cells", "UNPORTED_ARCHS", "WAITS_FOR", "not_ported"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                 # train | prefill | decode | serve | retrieval
    dims: dict
    skip: Optional[str] = None   # reason, if this cell is skipped


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str
    full_config: Callable[[], object]
    smoke_config: Callable[[], object]
    shapes: Tuple[ShapeSpec, ...]
    notes: str = ""

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.arch_id}: unknown shape {name!r}; have "
                       f"{[s.name for s in self.shapes]}")


_REGISTRY: Dict[str, ArchSpec] = {}

_MODULES = ["gemma3_12b", "gemma2_9b", "qwen15_32b", "kimi_k2", "dbrx",
            "schnet", "dlrm_mlperf", "sasrec", "wide_deep", "bert4rec",
            "lightgcn_baco"]

# the reference's archs the port has not ported yet, with their family,
# and the ROADMAP item each waits for: none
UNPORTED_ARCHS: Dict[str, str] = {}
WAITS_FOR: Dict[str, str] = {}


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error for an arch or feature the port does not have yet,
    naming the ROADMAP item it waits for."""
    return NotImplementedError(f"{what} is not ported yet: this waits for "
                               f"{item}")


def register(spec: ArchSpec):
    _REGISTRY[spec.arch_id] = spec
    return spec


def _load():
    if _REGISTRY:
        return
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


def get_arch(arch_id: str) -> ArchSpec:
    _load()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def list_archs():
    _load()
    return sorted(_REGISTRY)


def all_cells(include_skipped: bool = True, include_variants: bool = False):
    """Every registered (arch, shape) cell. The reference's 40-cell pool
    is its 10 base archs; `-baco` technique variants are extra §Perf
    configs."""
    _load()
    cells = []
    for aid in sorted(_REGISTRY):
        spec = _REGISTRY[aid]
        if aid == "lightgcn-baco":
            continue                      # paper backbone: not a pool cell
        if aid.endswith("-baco") and not include_variants:
            continue
        for s in spec.shapes:
            if include_skipped or s.skip is None:
                cells.append((aid, s.name))
    return cells


# ---------------------------------------------------------------------------
# shared shape sets
# ---------------------------------------------------------------------------
def lm_shapes(*, long_skip: Optional[str]) -> Tuple[ShapeSpec, ...]:
    return (
        ShapeSpec("train_4k", "train",
                  dict(seq_len=4096, global_batch=256)),
        ShapeSpec("prefill_32k", "prefill",
                  dict(seq_len=32768, global_batch=32)),
        ShapeSpec("decode_32k", "decode",
                  dict(seq_len=32768, global_batch=128)),
        ShapeSpec("long_500k", "decode",
                  dict(seq_len=524288, global_batch=1), skip=long_skip),
    )


def gnn_shapes() -> Tuple[ShapeSpec, ...]:
    return (
        ShapeSpec("full_graph_sm", "train",
                  dict(n_nodes=2708, n_edges=10556, d_feat=1433)),
        ShapeSpec("minibatch_lg", "train",
                  dict(batch_nodes=1024, fanout=(15, 10), d_feat=602,
                       n_nodes=1024 + 1024 * 15 + 1024 * 150,
                       n_edges=1024 * 15 + 1024 * 150)),
        ShapeSpec("ogb_products", "train",
                  dict(n_nodes=2449029, n_edges=61859140, d_feat=100)),
        ShapeSpec("molecule", "train",
                  dict(n_nodes=30, n_edges=64, batch=128)),
    )


def recsys_shapes() -> Tuple[ShapeSpec, ...]:
    return (
        ShapeSpec("train_batch", "train", dict(batch=65536)),
        ShapeSpec("serve_p99", "serve", dict(batch=512)),
        ShapeSpec("serve_bulk", "serve", dict(batch=262144)),
        ShapeSpec("retrieval_cand", "retrieval",
                  dict(batch=1, n_candidates=1_000_000)),
    )
