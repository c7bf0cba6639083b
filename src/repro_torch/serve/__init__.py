"""repro_torch.serve — serving compressed embedding models on the GPU.

  * ``CompressedArtifact`` — the deployment bundle (sketch + codebooks +
    edges + model config), cross-loadable with ``repro.serve``.
  * ``RecsysSession`` — top-k over the codebooks, "dense" or "fused"
    (the fused_topk kernel), fp32 or int8.
  * ``BatchDispatcher`` — a padded bucket ladder in front of a session.

Usage::

    art = CompressedArtifact.load("artifacts/amazonbook")
    disp = BatchDispatcher(art.session(k=20, scorer="fused"))
    disp.warmup()
    values, items = disp(user_ids)

CLI: ``python -m repro_torch.launch.serve [--artifact DIR]``.
"""
from .artifact import ARTIFACT_VERSION, CompressedArtifact
from .dispatch import DEFAULT_BUCKETS, BatchDispatcher, chunk_plan
from .session import RecsysSession, normalize_scorer

__all__ = ["ARTIFACT_VERSION", "CompressedArtifact", "DEFAULT_BUCKETS",
           "BatchDispatcher", "chunk_plan", "RecsysSession",
           "normalize_scorer"]
