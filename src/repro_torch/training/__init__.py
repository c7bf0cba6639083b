"""Training side of the port. Only the bundle I/O exists yet (used by
``repro_torch.serve.CompressedArtifact``); the trainer is not ported."""
from . import checkpoint

__all__ = ["checkpoint"]
