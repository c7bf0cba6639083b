"""CompressedArtifact: the deployable compression bundle, and the
deltas a stream publishes (port of ``repro.serve.artifact``).

The frozen sketch index arrays, the codebooks, the normalized training
edges and enough model config to rebuild the scoring function, as host
numpy state. ``save(dir)``/``load(dir)`` use the bundle layout of
``repro_torch.training.checkpoint``, and ``content_id()`` hashes the
arrays and model config exactly as the reference does, so an artifact
saved by either package loads in the other with the same digest.

Layout of ``save(dir)``:

    <dir>/manifest.json   version, model config, provenance (JSON)
    <dir>/arrays.npz      params/*, edges/*, sketch/*, quantized/*

Streaming deployments ship deltas instead of whole bundles:
``new.delta(base)`` carries only the arrays that changed between two
versions, and ``base.apply_delta(d)`` rebuilds ``new`` bit for bit,
checking the base's and the result's ``content_id``. A delta saved by
either package loads in the other (``ArtifactDelta.save``/``load``, the
reference's manifest).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.sketch import Sketch
from repro_torch.training.checkpoint import (_flatten_with_paths,
                                             _unflatten_paths, read_bundle,
                                             write_bundle)

__all__ = ["CompressedArtifact", "ArtifactDelta", "ARTIFACT_VERSION",
           "DELTA_VERSION"]

ARTIFACT_VERSION = 1
DELTA_VERSION = 1

# the model-config keys an artifact must carry to rebuild a LightGCNConfig
_MODEL_KEYS = ("n_users", "n_items", "dim", "n_layers", "l2",
               "k_users", "k_items", "n_hot_users", "lookup_backend")


def _leaves(tree):
    """The arrays of a nest of dicts, lists and tuples (None holds none)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _nbytes(a) -> int:
    if hasattr(a, "element_size"):             # a torch tensor
        return int(a.numel() * a.element_size())
    return int(np.asarray(a).nbytes)


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

    @classmethod
    def from_trainer(cls, trainer) -> "CompressedArtifact":
        """Snapshot a ``repro_torch.training.Trainer`` into a deployable
        artifact (host numpy), with the reference's provenance keys. The
        arrays are copies: a CPU trainer that keeps training leaves the
        artifact as it was exported."""
        params = {k: p.detach().to("cpu", copy=True).numpy()
                  for k, p in trainer.params.items()}
        edges = {k: trainer.statics[k].to("cpu", copy=True).numpy()
                 for k in ("edge_u", "edge_v", "edge_norm")}
        cfg = trainer.mcfg
        return cls.from_parts(params, edges, trainer.sketch, cfg, {
            "lookup_backend": cfg.lookup_backend,
            "train_steps": int(trainer.step),
            "trainer_backend": trainer.backend.name,
            "sampler": trainer.sampler.name,
            "exported_by": "Trainer.export"})

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

    # -- parameter accounting -----------------------------------------------
    @property
    def compressed(self) -> bool:
        return self.sketch is not None

    def n_params(self) -> int:
        """Elements of the fp32 tables and the int8 payload (the
        reference's count over the leaves of (params, quantized))."""
        return sum(int(np.prod(a.shape)) for a in
                   _leaves((self.params, self.quantized)))

    def serving_nbytes(self) -> int:
        """Bytes of the device-resident table payload (the number the
        int8 rung shrinks ~4x)."""
        return sum(_nbytes(a) for a in _leaves(self.serving_params()))

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
                capacity=None, telemetry=None, scorer: str = "dense",
                device="cuda"):
        """A RecsysSession over this bundle on ``device``. ``capacity``
        ("auto" or a maxima dict) pads it to the capacity ladder, so
        ``swap`` reuses its device state."""
        from repro_torch.serve.session import RecsysSession
        return RecsysSession.from_artifact(self, k=k, backend=backend,
                                           capacity=capacity,
                                           telemetry=telemetry,
                                           scorer=scorer, device=device)

    # -- content addressing -------------------------------------------------
    def _tree(self) -> dict:
        tree = {"params": self.params, "edges": self.edges}
        if self.sketch is not None:
            tree["sketch"] = self.sketch.state_arrays()
        if self.quantized is not None:
            tree["quantized"] = self.quantized
        return tree

    def _flat(self) -> dict:
        return _flatten_with_paths(self._tree())

    def content_id(self) -> str:
        """Digest of every array (path, dtype, shape, bytes) and the
        model config — the reference's ``content_id``, memoized."""
        cached = self.__dict__.get("_content_id")
        if cached is not None:
            return cached
        h = hashlib.sha256()
        flat = self._flat()
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

    def delta(self, base: "CompressedArtifact") -> "ArtifactDelta":
        """The delta that turns ``base`` into ``self``: the arrays that
        changed or are new, and the paths that disappeared. Apply with
        ``base.apply_delta(delta)``."""
        old = base._flat()
        new = self._flat()
        changed = {}
        for key, arr in new.items():
            prev = old.get(key)
            if (prev is None or prev.shape != arr.shape
                    or prev.dtype != arr.dtype
                    or not np.array_equal(prev, arr)):
                changed[key] = arr
        removed = tuple(sorted(set(old) - set(new)))
        return ArtifactDelta(base_id=base.content_id(),
                             new_id=self.content_id(), changed=changed,
                             removed=removed, model=dict(self.model),
                             provenance=dict(self.provenance))

    def apply_delta(self, delta: "ArtifactDelta") -> "CompressedArtifact":
        """The delta's target artifact, rebuilt from this base. Checks
        the base digest before and the target digest after, so a delta
        applied to the wrong base, or corrupted, raises."""
        have = self.content_id()
        if delta.base_id != have:
            raise ValueError(
                f"delta expects base {delta.base_id}, artifact is {have} "
                f"(deltas must be applied in publication order)")
        flat = self._flat()
        for key in delta.removed:
            flat.pop(key, None)
        flat.update(delta.changed)
        tree = _unflatten_paths(flat)
        model = dict(delta.model)
        sketch = None
        if "sketch" in tree:
            sketch = Sketch.from_state(
                tree["sketch"], k_users=model["k_users"],
                k_items=model["k_items"],
                method=delta.provenance.get("method", "unknown"),
                meta=dict(delta.provenance))
        out = CompressedArtifact(params=tree.get("params", {}),
                                 edges=tree["edges"], sketch=sketch,
                                 model=model,
                                 provenance=dict(delta.provenance),
                                 quantized=tree.get("quantized"))
        got = out.content_id()
        if got != delta.new_id:
            raise ValueError(f"delta application produced {got}, "
                             f"expected {delta.new_id} (corrupt delta?)")
        return out

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


@dataclasses.dataclass(frozen=True)
class ArtifactDelta:
    """A versioned artifact-to-artifact patch (``CompressedArtifact.
    delta``). ``changed`` maps flattened array paths (``params/
    user_table``, ``sketch/user_idx``, ...) to their new values;
    ``removed`` lists the paths that no longer exist; (base_id, new_id)
    make applying it order-safe and verifiable."""

    base_id: str
    new_id: str
    changed: dict
    removed: Tuple[str, ...]
    model: dict
    provenance: dict

    def nbytes(self) -> int:
        """Payload size: what crosses the wire instead of a bundle."""
        return int(sum(np.asarray(a).nbytes for a in self.changed.values()))

    def save(self, directory: str) -> str:
        """Atomically publish the delta bundle at ``directory``."""
        directory = os.path.normpath(directory)
        parent, name = os.path.split(directory)
        manifest = {"delta_version": DELTA_VERSION,
                    "base_id": self.base_id, "new_id": self.new_id,
                    "removed": list(self.removed), "model": self.model,
                    "provenance": self.provenance}
        return write_bundle(parent or ".", name,
                            _unflatten_paths(dict(self.changed)), manifest)

    @classmethod
    def load(cls, directory: str) -> "ArtifactDelta":
        """Load a delta bundle (either package's)."""
        tree, manifest = read_bundle(directory)
        version = manifest.get("delta_version")
        if version is None:
            raise ValueError(f"{directory!r} is a bundle but not an "
                             f"ArtifactDelta (no delta_version)")
        if version != DELTA_VERSION:
            raise ValueError(f"unsupported delta version {version} at "
                             f"{directory!r} (this build reads "
                             f"{DELTA_VERSION})")
        return cls(base_id=manifest["base_id"], new_id=manifest["new_id"],
                   changed=_flatten_with_paths(tree),
                   removed=tuple(manifest.get("removed", ())),
                   model=dict(manifest["model"]),
                   provenance=dict(manifest.get("provenance", {})))
