"""CompressedArtifact: the deployable compression bundle (port of
``repro.serve.artifact``, without deltas).

The frozen sketch index arrays, the codebooks, the normalized training
edges and enough model config to rebuild the scoring function, as host
numpy state. ``save(dir)``/``load(dir)`` use the bundle layout of
``repro_torch.training.checkpoint``, and ``content_id()`` hashes the
arrays and model config exactly as the reference does, so an artifact
saved by either package loads in the other with the same digest.

Layout of ``save(dir)``:

    <dir>/manifest.json   version, model config, provenance (JSON)
    <dir>/arrays.npz      params/*, edges/*, sketch/*, quantized/*
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Optional

import numpy as np

from repro_torch.core.sketch import Sketch
from repro_torch.training.checkpoint import (_flatten_with_paths,
                                             read_bundle, write_bundle)

__all__ = ["CompressedArtifact", "ARTIFACT_VERSION"]

ARTIFACT_VERSION = 1

# the model-config keys an artifact must carry to rebuild a LightGCNConfig
_MODEL_KEYS = ("n_users", "n_items", "dim", "n_layers", "l2",
               "k_users", "k_items", "n_hot_users", "lookup_backend")


@dataclasses.dataclass(frozen=True)
class CompressedArtifact:
    """Everything serving needs, as host numpy state.

    params:     {"user_table","item_table"} codebooks (or full tables)
    edges:      {"edge_u","edge_v","edge_norm"} — propagation runs over
                the training graph at serve time
    sketch:     frozen index arrays (None for uncompressed models)
    model:      LightGCNConfig fields
    provenance: JSON scalars recording how the sketch and params were made
    quantized:  optional int8 payload from ``quantize()``
    """

    params: dict
    edges: dict
    sketch: Optional[Sketch]
    model: dict
    provenance: dict
    quantized: Optional[dict] = None

    # -- construction -------------------------------------------------------
    @classmethod
    def from_parts(cls, params: dict, edges: dict, sketch: Optional[Sketch],
                   model, provenance: Optional[dict] = None
                   ) -> "CompressedArtifact":
        """An artifact from host arrays: ``params`` (numpy, e.g. the JAX
        package's trained tables), ``edges`` (edge_u, edge_v, edge_norm),
        the sketch, and ``model`` as a LightGCNConfig or its dict."""
        if not isinstance(model, dict):
            model = {k: getattr(model, k) for k in _MODEL_KEYS}
        prov = sketch.meta_json() if sketch is not None else {}
        prov.update(provenance or {})
        return cls(
            params={k: np.asarray(v, np.float32) for k, v in params.items()},
            edges={"edge_u": np.asarray(edges["edge_u"], np.int32),
                   "edge_v": np.asarray(edges["edge_v"], np.int32),
                   "edge_norm": np.asarray(edges["edge_norm"], np.float32)},
            sketch=sketch, model=dict(model), provenance=prov)

    # -- int8 quantization --------------------------------------------------
    def quantize(self, keep_fp32: bool = False) -> "CompressedArtifact":
        """int8 symmetric per-row quantized copy (fp32 tables dropped
        unless ``keep_fp32``). Idempotent."""
        if self.quantized is not None:
            return self
        from repro_torch.embedding import quantize_params
        provenance = dict(self.provenance)
        provenance["quantization"] = "int8_symmetric_rowwise"
        return dataclasses.replace(
            self, params=self.params if keep_fp32 else {},
            quantized=quantize_params(self.params), provenance=provenance)

    def serving_params(self) -> dict:
        """The int8 payload when quantized (fp32 dropped), else the fp32
        tables."""
        if self.quantized is not None and not self.params:
            return dict(self.quantized)
        return self.params

    # -- serving glue -------------------------------------------------------
    def mcfg(self):
        """The LightGCN model config this artifact was built under."""
        from repro_torch.models.lightgcn import LightGCNConfig
        return LightGCNConfig(**self.model)

    def statics(self, device="cuda") -> dict:
        """Device-resident statics for the scoring fn (edges + sketch)."""
        import torch

        from repro_torch.models.lightgcn import sorted_edge_statics
        statics = sorted_edge_statics(
            self.edges["edge_u"], self.edges["edge_v"],
            self.edges["edge_norm"], self.model["n_users"],
            self.model["n_items"], device=device)
        if self.sketch is not None:
            dev = statics["edge_u"].device
            statics["sketch_u"] = torch.as_tensor(
                self.sketch.user_idx, dtype=torch.int32, device=dev)
            statics["sketch_v"] = torch.as_tensor(
                self.sketch.item_idx, dtype=torch.int32, device=dev)
        return statics

    def session(self, k: int = 20, backend: Optional[str] = None,
                scorer: str = "dense", device="cuda"):
        """A RecsysSession over this bundle on ``device``."""
        from repro_torch.serve.session import RecsysSession
        return RecsysSession.from_artifact(self, k=k, backend=backend,
                                           scorer=scorer, device=device)

    # -- content addressing -------------------------------------------------
    def _tree(self) -> dict:
        tree = {"params": self.params, "edges": self.edges}
        if self.sketch is not None:
            tree["sketch"] = self.sketch.state_arrays()
        if self.quantized is not None:
            tree["quantized"] = self.quantized
        return tree

    def content_id(self) -> str:
        """Digest of every array (path, dtype, shape, bytes) and the
        model config — the reference's ``content_id``, memoized."""
        cached = self.__dict__.get("_content_id")
        if cached is not None:
            return cached
        h = hashlib.sha256()
        flat = _flatten_with_paths(self._tree())
        for key in sorted(flat):
            arr = np.ascontiguousarray(flat[key])
            h.update(key.encode())
            h.update(str(arr.dtype).encode())
            h.update(str(arr.shape).encode())
            h.update(arr.tobytes())
        h.update(json.dumps(self.model, sort_keys=True).encode())
        digest = h.hexdigest()[:16]
        object.__setattr__(self, "_content_id", digest)
        return digest

    # -- persistence --------------------------------------------------------
    def save(self, directory: str) -> str:
        """Atomically publish the bundle at `directory`."""
        directory = os.path.normpath(directory)
        parent, name = os.path.split(directory)
        manifest = {"artifact_version": ARTIFACT_VERSION,
                    "model": self.model, "provenance": self.provenance}
        return write_bundle(parent or ".", name, self._tree(), manifest)

    @classmethod
    def load(cls, directory: str) -> "CompressedArtifact":
        """Load a published bundle (either package's); clear errors for
        non-artifacts."""
        tree, manifest = read_bundle(directory)
        version = manifest.get("artifact_version")
        if version is None:
            raise ValueError(
                f"{directory!r} is a bundle but not a CompressedArtifact "
                f"(no artifact_version in manifest)")
        if version != ARTIFACT_VERSION:
            raise ValueError(
                f"unsupported artifact version {version} at {directory!r} "
                f"(this build reads version {ARTIFACT_VERSION})")
        model = manifest["model"]
        provenance = manifest.get("provenance", {})
        sketch = None
        if "sketch" in tree:
            sketch = Sketch.from_state(
                tree["sketch"], k_users=model["k_users"],
                k_items=model["k_items"],
                method=provenance.get("method", "unknown"),
                meta=provenance)
        return cls(params=tree.get("params", {}), edges=tree["edges"],
                   sketch=sketch, model=dict(model),
                   provenance=dict(provenance),
                   quantized=tree.get("quantized"))
