"""RecsysSession: batched user ids -> top-k items over (possibly
compressed) LightGCN tables (port of ``repro.serve.session``, without
capacity padding and hot swap).

The protocol is the reference's: ``warmup(batch)``, ``__call__(ids)``,
``stats()``. Params and statics live on the session's device for its
lifetime. Each request recomputes the propagation from the codebooks
(E0 = Σ_h Z[sketch[i, h]] through the codebook_lookup kernel on CUDA),
then reads out the top-k:

  * "dense": scores every item (``u @ V.T``) and takes the top-k with
    ``lax.top_k``'s order;
  * "fused": the fused_topk kernel; the [B, n_items] score matrix never
    exists.

An int8 params dict dequantizes on the device before the propagation.
PyTorch runs eagerly, so there are no compiled programs to count; front
the session with ``BatchDispatcher`` to serve any batch size from a
fixed ladder of shapes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.embedding import (dequantize_params, fused_topk,
                                   normalize_backend, params_quantized)
from repro_torch.embedding.engine import topk
from repro_torch.models import lightgcn as L
from repro_torch.obs import LatencyRecorder, clock

__all__ = ["RecsysSession", "normalize_scorer"]

_SCORER_CHOICES = ("dense", "fused")


def normalize_scorer(name: Optional[str]) -> str:
    """None/"auto" -> "dense"; "fused" -> the one-pass fused_topk kernel."""
    if name in (None, "auto"):
        return "dense"
    name = str(name)
    if name not in _SCORER_CHOICES:
        raise ValueError(f"unknown scorer {name!r}; expected "
                         f"{'|'.join(_SCORER_CHOICES)} (or auto)")
    return name


def _on(dev, x):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.as_tensor(np.asarray(x), device=dev)


class RecsysSession:
    """Top-k scoring over (possibly compressed) LightGCN tables."""

    def __init__(self, params, statics, mcfg, k: int = 20,
                 backend: Optional[str] = None,
                 scorer: Optional[str] = None, device="cuda"):
        self.device = resolve_device(device)
        if backend is not None:
            mcfg = dataclasses.replace(
                mcfg, lookup_backend=normalize_backend(backend))
        else:
            normalize_backend(mcfg.lookup_backend)   # validate early
        self.k = int(k)
        self.scorer = normalize_scorer(scorer)
        self._lat = LatencyRecorder()
        self.mcfg = mcfg
        self.params = {name: _on(self.device, a) for name, a in params.items()}
        self.statics = {name: _on(self.device, a)
                        for name, a in statics.items()}

    @classmethod
    def from_artifact(cls, artifact, k: int = 20,
                      backend: Optional[str] = None,
                      scorer: Optional[str] = None,
                      device="cuda") -> "RecsysSession":
        """The deploy path: a session over a loaded CompressedArtifact
        (either package's). A quantized artifact serves its int8
        payload."""
        dev = resolve_device(device)
        return cls(artifact.serving_params(), artifact.statics(dev),
                   artifact.mcfg(), k=k, backend=backend, scorer=scorer,
                   device=dev)

    def _score_topk(self, user_ids):
        params = dequantize_params(self.params)
        mask = self.statics.get("item_mask")
        if self.scorer == "fused":
            u, v = L.eval_embeddings(params, self.statics, self.mcfg,
                                     user_ids)
            return fused_topk(u, v, self.k, mask=mask)
        scores = L.score_all_items(params, self.statics, self.mcfg, user_ids)
        if mask is not None:
            scores = scores + mask[None, :]
        return topk(scores, self.k)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self, batch: Optional[int] = None) -> None:
        """Run one request of ``batch`` rows, untimed."""
        ids = torch.zeros(int(batch or 1), dtype=torch.int64,
                          device=self.device)
        self._score_topk(ids)
        self._sync()

    def __call__(self, user_ids):
        """user_ids int [B] -> (values f32 [B,k], item_ids int32 [B,k]),
        tensors on the session's device; the latency recorded is the
        request's, up to the device finishing it."""
        ids = torch.as_tensor(np.asarray(user_ids), dtype=torch.int64,
                              device=self.device)
        t0 = clock.now()
        out = self._score_topk(ids)
        self._sync()
        self._lat.record(clock.ms_between(t0, clock.now()))
        return out

    def stats(self) -> dict:
        return {"kind": "recsys", "k": self.k,
                "backend": self.mcfg.lookup_backend or "auto",
                "scorer": self.scorer, "device": str(self.device),
                "quantized": params_quantized(self.params),
                **self._lat.summary()}
