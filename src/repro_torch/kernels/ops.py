"""The kernels' binding into the embedding layer.

Importing this module registers the "cuda" lookup backend and the
"cuda" fused scorer into ``repro_torch.embedding.engine``
(the engine defers this import until a lookup or scorer is first
asked for). Both launch the hand-written kernels for CUDA tensors and
run the kernels' plain versions for CPU tensors; nothing here falls
back from a CUDA tensor to a plain version.
"""
from __future__ import annotations

from repro_torch.embedding.engine import (LookupBackend, register_backend,
                                          register_scorer)

from .codebook_lookup import codebook_lookup
from .fused_topk import fused_topk

__all__ = ["CudaBackend"]


class CudaBackend(LookupBackend):
    """Codebook lookups through the codebook_lookup kernel, which
    applies the binary-Y first-occurrence rule itself. Forward only: the backward kernel
    arrives with the trainer."""
    name = "cuda"

    def codebook_sum(self, codebook, rows_idx):
        h = rows_idx.shape[-1]
        out = codebook_lookup(codebook, rows_idx.reshape(-1, h).int(),
                              binary=True)
        return out.reshape(*rows_idx.shape[:-1], codebook.shape[-1])


register_backend(CudaBackend())
register_scorer("cuda", fused_topk)
