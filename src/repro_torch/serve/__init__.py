"""repro_torch.serve — serving compressed embedding models on the GPU.

  * ``CompressedArtifact`` — the deployment bundle (sketch + codebooks +
    edges + model config), cross-loadable with ``repro.serve``.
  * ``RecsysSession`` — top-k over the codebooks, "dense" or "fused"
    (the fused_topk kernel), fp32 or int8.
  * ``BatchDispatcher`` — a padded bucket ladder in front of a session.
  * Streaming: ``ArtifactDelta`` (``artifact.delta(prev)`` /
    ``prev.apply_delta(d)``), capacity-padded sessions
    (``capacity_plan``; ``session.swap(artifact)`` copies into the
    session's device state) and ``StreamTelemetry``.
  * ``ArchSession`` — the recsys architectures' serve and retrieval
    cells (DLRM, Wide&Deep, SASRec, BERT4Rec), smoke or full width.
  * ``FrontdoorTelemetry`` — the counters and latencies of
    ``repro_torch.frontdoor``'s async front end.

Usage::

    art = CompressedArtifact.load("artifacts/amazonbook")
    disp = BatchDispatcher(art.session(k=20, scorer="fused"))
    disp.warmup()
    values, items = disp(user_ids)

CLI: ``python -m repro_torch.launch.serve [--artifact DIR]``.
"""
from .artifact import (ARTIFACT_VERSION, DELTA_VERSION, ArtifactDelta,
                       CompressedArtifact)
from .dispatch import DEFAULT_BUCKETS, BatchDispatcher, chunk_plan
from .session import (ArchSession, RecsysSession, Session, capacity_plan,
                      normalize_scorer)
from .telemetry import FrontdoorTelemetry, StreamTelemetry

__all__ = ["ARTIFACT_VERSION", "DELTA_VERSION", "ArtifactDelta",
           "CompressedArtifact", "DEFAULT_BUCKETS", "BatchDispatcher",
           "chunk_plan", "Session", "RecsysSession", "ArchSession",
           "capacity_plan",
           "normalize_scorer", "StreamTelemetry",
           "FrontdoorTelemetry"]
