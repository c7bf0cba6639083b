"""repro_torch.configs — the architecture registry (port of
``repro.configs``): the recsys family, the paper's LightGCN backbone, the
LM family (dense and MoE) and the GNN."""
from .registry import (ArchSpec, ShapeSpec, all_cells, get_arch, list_archs,
                       register)

__all__ = ["ArchSpec", "ShapeSpec", "all_cells", "get_arch", "list_archs",
           "register"]
