"""StreamUpdater: the online co-clustering state machine (port of
``repro.stream.online``).

Ties the three streaming layers together around one invariant — **label
→ codebook-row maps are stable across updates** — which is what makes
hot swaps meaningful: a user who stays in their cluster keeps pointing
at the same trained codebook row through any number of appends and
refreshes, so the serving artifact evolves by *deltas* instead of being
rebuilt.

Per event batch (``apply_events``):
  grow + append into the StreamingGraph, grow the label vector with
  fresh singletons, cold-assign the new nodes (one LP half-step over
  their incident edges), and map any genuinely new cluster to a fresh
  zero-initialized codebook row. A zero row means a cold entity is
  ranked purely by LightGCN propagation from its observed interactions
  until the next fine-tune.

Periodically (``refresh`` + ``tune``):
  budgeted warm-started re-solve over the whole grown graph (label
  churn reported), SCU re-derived for the new partition, then a short
  BPR fine-tune warm-started from the live codebooks (``CapacityTuner``,
  on the device).

``export_artifact`` snapshots the state as a ``CompressedArtifact``;
``artifact.delta(prev)`` + ``RecsysSession.swap`` publish it. Codebook
rows are never reclaimed when a cluster dies; capacity-rung padding on
the serving side absorbs the monotone row count.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import ClusterEngine
from repro_torch.core.sketch import Sketch
from repro_torch.device import resolve_device
from repro_torch.obs.trace import get_tracer

from .assign import ColdStartAssigner, RefreshStats, grow_labels
from .graph import StreamingGraph

__all__ = ["StreamUpdater", "CapacityTuner"]


class CapacityTuner:
    """Fine-tunes codebooks against a GROWING graph on padded device
    buffers.

    Model statics and codebooks are padded to capacity rungs
    (``serve.session.pad_to_capacity``) and kept on the device across
    refreshes in ``serve.session.DeviceState``s, as a serving session
    keeps its state: each ``tune`` copies the grown state into the same
    tensors until a rung is outgrown (then it re-plans and allocates
    once). The triplet batch comes from the host BPR sampler over the
    REAL graph, seeded as the reference seeds it.

    The padding is exact for the real rows. Pad edges lie outside every
    CSR segment, so pad users and items propagate to exactly 0 and no
    real row sees them; pad sketch rows point at codebook row 0, but a
    pad entity is never sampled, so its rows' cotangents are exactly 0
    and add nothing to row 0's gradient. Pad codebook rows get zero
    gradients, and AdamW (no weight decay by default, as the
    reference's) leaves them at zero. Real-row gradients equal an
    unpadded fine-tune's up to the order of the loss's reductions.
    """

    def __init__(self, model: dict, lr: float = 5e-3,
                 batch_size: int = 1024, caps: Optional[dict] = None,
                 device="cuda"):
        from repro_torch.serve.session import DeviceState
        from repro_torch.training import optimizer as opt_lib
        self.model = dict(model)
        self.lr = float(lr)
        self.batch_size = int(batch_size)
        self.device = resolve_device(device)
        self._caps_hint = dict(caps or {})   # expected stream maxima
        self._caps = None
        self._optimizer = opt_lib.adamw(lr=self.lr)
        self._state = (DeviceState(self.device, requires_grad=True),
                       DeviceState(self.device))
        self._params, self._statics = (st.tensors for st in self._state)
        self._opt_state = None
        self._opt_allocations = 0

    @property
    def state_allocations(self) -> int:
        """Tensors allocated for the padded params, statics and optimizer
        state over the tuner's life (flat across refreshes in a rung)."""
        return (sum(st.allocations for st in self._state)
                + self._opt_allocations)

    def _reset_optimizer(self) -> None:
        st = self._opt_state
        if st is None or any(st["m"][k].shape != p.shape
                             for k, p in self._params.items()):
            self._opt_state = self._optimizer.init(self._params)
            self._opt_allocations += 1 + 2 * len(self._params)
            return
        st["step"].zero_()
        for k in self._params:
            st["m"][k].zero_()
            st["v"][k].zero_()

    def tune(self, graph, sketch: Sketch, params: Dict[str, np.ndarray],
             steps: int, seed: int = 0) -> Dict[str, np.ndarray]:
        """Run ``steps`` BPR updates; returns the tuned (real-row)
        codebooks as host numpy. ``params`` is not mutated."""
        from repro_torch.data.sampler import BPRSampler
        from repro_torch.models import lightgcn as L
        from repro_torch.serve.session import capacity_plan, pad_to_capacity
        mcfg = L.from_sketch(graph, sketch, dim=int(self.model["dim"]),
                             n_layers=int(self.model["n_layers"]),
                             l2=float(self.model["l2"]),
                             lookup_backend=self.model.get("lookup_backend"))
        statics = {k: v.numpy()
                   for k, v in L.make_statics(graph, sketch, "cpu").items()}
        if self._caps is None:
            hint = {k: v for k, v in self._caps_hint.items()
                    if k in ("n_users", "n_items", "k_users", "k_items",
                             "n_edges")}
            self._caps = capacity_plan(mcfg, statics, **hint)
        params_p, statics_p, mcfg_pad, self._caps, _ = pad_to_capacity(
            params, statics, mcfg, self._caps)
        # the staging buffers are free again: the last tune ended in a
        # device-to-host copy of its result
        self._state[0].fill(params_p)
        self._state[1].fill(statics_p)
        self._reset_optimizer()
        names = sorted(self._params)
        sampler = BPRSampler(graph, self.batch_size, seed=seed)
        for _ in range(int(steps)):
            u, p, n = sampler.next_batch()
            batch = {"user": torch.as_tensor(u, device=self.device),
                     "pos": torch.as_tensor(p, device=self.device),
                     "neg": torch.as_tensor(n, device=self.device)}
            loss = L.bpr_loss_fn(self._params, self._statics, batch,
                                 mcfg_pad)
            grads = torch.autograd.grad(loss,
                                        [self._params[k] for k in names])
            self._optimizer.update(dict(zip(names, grads)), self._opt_state,
                                   self._params)
        return {"user_table": self._params["user_table"][:sketch.k_users]
                .detach().cpu().numpy(),
                "item_table": self._params["item_table"][:sketch.k_items]
                .detach().cpu().numpy()}


class _RowMap:
    """Stable shared-id-space label -> codebook row map for one side.

    Rows are allocated once, in sorted order of first appearance, and
    never re-used; ``map`` returns the rows for a label array,
    allocating fresh rows for labels it has never seen.
    """

    def __init__(self, space: int):
        self.row_of_label = np.full(int(space), -1, dtype=np.int32)
        self.n_rows = 0

    def seed(self, labels: np.ndarray, rows: np.ndarray) -> None:
        labels = np.asarray(labels).ravel()
        rows = np.asarray(rows, np.int32).ravel()
        self.row_of_label[labels] = rows
        self.n_rows = int(rows.max()) + 1 if rows.size else 0

    def grow_space(self, space: int) -> None:
        if space > self.row_of_label.shape[0]:
            pad = np.full(space - self.row_of_label.shape[0], -1, np.int32)
            self.row_of_label = np.concatenate([self.row_of_label, pad])

    def map(self, labels: np.ndarray) -> np.ndarray:
        labels = np.asarray(labels)
        new = np.unique(labels[self.row_of_label[labels] < 0])
        if new.size:
            self.row_of_label[new] = self.n_rows + np.arange(
                new.size, dtype=np.int32)
            self.n_rows += int(new.size)
        return self.row_of_label[labels].astype(np.int32)


class StreamUpdater:
    """Owns the live co-clustering state for one deployment.

    Construct with ``from_trainer`` (the normal path — the trainer's
    BACO sketch carries the raw joint labels the warm restarts need) or
    directly from (graph, sketch, params). ``device`` runs the cold
    half-steps, refresh solves and fine-tunes (the engine's device when
    an engine is given).
    """

    def __init__(self, graph, sketch: Sketch, params: Dict[str, np.ndarray],
                 model: dict, *, engine: Optional[ClusterEngine] = None,
                 ratio: float = 0.25, capacity: Optional[dict] = None,
                 device="cuda"):
        meta = sketch.meta or {}
        if "joint_labels" not in meta:
            raise ValueError(
                "StreamUpdater needs the sketch's raw joint labels "
                "(sketch.meta['joint_labels']); build the sketch in-process "
                "with ClusterEngine.build — a loaded artifact only carries "
                "compacted rows, which cannot seed a warm re-solve")
        engine = engine or ClusterEngine(device=device)
        self.device = resolve_device(engine.device)
        self.sgraph = (graph if isinstance(graph, StreamingGraph)
                       else StreamingGraph.from_graph(graph))
        self.labels = np.asarray(meta["joint_labels"], np.int32).copy()
        self.n_hot = int(sketch.user_idx.shape[1])
        # capacity maxima (expected end-of-stream sizes): fine-tunes then
        # keep one buffer size for the whole replay
        self.capacity = dict(capacity) if capacity else None
        self.assigner = ColdStartAssigner(
            engine=engine, scheme=str(meta.get("scheme", "hws")),
            gamma=float(meta.get("gamma", 1.0)), caps=self.capacity)
        self.ratio = float(ratio)
        self.model = dict(model)
        self.params = {k: np.array(v) for k, v in params.items()}
        n = self.sgraph.n_nodes
        nu = self.sgraph.n_users
        self.umap = _RowMap(n)
        self.vmap = _RowMap(n)
        if self.n_hot == 2:
            self.su = np.asarray(meta["secondary_labels"], np.int32).copy()
            self.umap.seed(
                np.concatenate([self.labels[:nu], self.su]),
                np.concatenate([sketch.user_idx[:, 0],
                                sketch.user_idx[:, 1]]))
        else:
            self.su = self.labels[:nu].copy()
            self.umap.seed(self.labels[:nu], sketch.user_idx[:, 0])
        self.vmap.seed(self.labels[nu:], sketch.item_idx[:, 0])
        self._tuner: Optional[CapacityTuner] = None
        self.sketch = self._rebuild_sketch()

    @classmethod
    def from_trainer(cls, trainer, *, engine: Optional[ClusterEngine] = None,
                     ratio: float = 0.25,
                     capacity: Optional[dict] = None) -> "StreamUpdater":
        """From a ``repro_torch.training.Trainer``: its graph, BACO
        sketch, codebooks (to host numpy), model config and device."""
        from repro_torch.serve.artifact import _MODEL_KEYS
        params = {k: p.detach().cpu().numpy()
                  for k, p in trainer.params.items()}
        model = {k: getattr(trainer.mcfg, k) for k in _MODEL_KEYS}
        return cls(trainer.graph, trainer.sketch, params, model,
                   engine=engine, ratio=ratio, capacity=capacity,
                   device=trainer.device)

    # -- derived state -------------------------------------------------------
    @property
    def gamma(self) -> float:
        return self.assigner.gamma

    def _rebuild_sketch(self) -> Sketch:
        nu = self.sgraph.n_users
        n = self.sgraph.n_nodes
        self.umap.grow_space(n)
        self.vmap.grow_space(n)
        if self.n_hot == 2:
            ur = self.umap.map(np.stack([self.labels[:nu], self.su], axis=1))
        else:
            ur = self.umap.map(self.labels[:nu][:, None])
        vr = self.vmap.map(self.labels[nu:][:, None])
        self._grow_codebooks()
        self.sketch = Sketch(ur, vr, self.umap.n_rows, self.vmap.n_rows,
                             method="baco(stream)",
                             meta={"gamma": self.assigner.gamma,
                                   "scheme": self.assigner.scheme,
                                   "joint_labels": self.labels.copy(),
                                   "secondary_labels": self.su.copy(),
                                   "stream_version": self.sgraph.version})
        return self.sketch

    def _grow_codebooks(self) -> None:
        """New clusters get fresh ZERO rows: a zero ego embedding ranks
        by propagation only until the next fine-tune."""
        d = int(self.model["dim"])
        for key, n_rows in (("user_table", self.umap.n_rows),
                            ("item_table", self.vmap.n_rows)):
            tab = self.params[key]
            if tab.shape[0] < n_rows:
                pad = np.zeros((n_rows - tab.shape[0], d), tab.dtype)
                self.params[key] = np.concatenate([tab, pad])

    # -- the stream ----------------------------------------------------------
    def apply_events(self, n_new_users: int, n_new_items: int,
                     edge_u, edge_v) -> Dict[str, object]:
        """One event batch: grow, append, cold-assign, re-map."""
        old_nu, old_nv = self.sgraph.n_users, self.sgraph.n_items
        with get_tracer().span("graph_append", n_new_users=int(n_new_users),
                               n_new_items=int(n_new_items)):
            self.sgraph.grow(old_nu + int(n_new_users),
                             old_nv + int(n_new_items))
            info = self.sgraph.append(edge_u, edge_v)
        nu, nv = self.sgraph.n_users, self.sgraph.n_items
        labels = grow_labels(self.labels, old_nu, old_nv, nu, nv)
        su = np.concatenate([self.su, labels[old_nu:nu]])
        self.labels, stats = self.assigner.assign(
            self.sgraph.graph, labels, nu - old_nu, nv - old_nv)
        # new users' secondary starts at their (possibly adopted) primary;
        # the real runner-up is re-derived at the next refresh
        su[old_nu:] = self.labels[old_nu:nu]
        self.su = su
        self._rebuild_sketch()
        return {"append": info, "assign": stats}

    def refresh(self, budget: Optional[int] = None,
                max_iters: int = 8) -> RefreshStats:
        """Budgeted warm re-solve of the whole grown graph + SCU
        re-derivation for every user under the new labels."""
        graph = self.sgraph.graph
        if budget is None:
            d = int(self.model["dim"])
            b = max(2, int(round(self.ratio * graph.n_nodes)))
            budget = (max(2, int((b * d - graph.n_users) // d))
                      if self.n_hot == 2 else b)
        self.labels, stats = self.assigner.refresh(graph, self.labels,
                                                   budget, max_iters)
        self.su = (self.assigner.secondary(graph, self.labels)
                   if self.n_hot == 2 else self.labels[:graph.n_users])
        self._rebuild_sketch()
        return stats

    def tune(self, steps: int, batch_size: int = 1024, lr: float = 5e-3,
             seed: int = 0) -> None:
        """Short BPR fine-tune of the codebooks, warm-started from the
        live values (new rows start at zero and learn their cluster),
        through the CapacityTuner's padded device buffers."""
        if self._tuner is None or self._tuner.lr != float(lr) \
                or self._tuner.batch_size != int(batch_size):
            self._tuner = CapacityTuner(self.model, lr=lr,
                                        batch_size=batch_size,
                                        caps=self.capacity,
                                        device=self.device)
        self.params = self._tuner.tune(
            self.sgraph.graph, self.sketch, self.params, steps,
            seed=int(seed) + self.sgraph.version)

    # -- publication ---------------------------------------------------------
    def export_artifact(self):
        """Snapshot the live state as a deployable CompressedArtifact
        (delta against the previous export to publish cheaply)."""
        from repro_torch.models.lightgcn import edge_norms
        from repro_torch.serve import CompressedArtifact
        graph = self.sgraph.graph
        edges = {"edge_u": graph.edge_u.copy(), "edge_v": graph.edge_v.copy(),
                 "edge_norm": edge_norms(graph).astype(np.float32)}
        model = dict(self.model)
        model.update(n_users=graph.n_users, n_items=graph.n_items,
                     k_users=self.sketch.k_users,
                     k_items=self.sketch.k_items, n_hot_users=self.n_hot)
        provenance = {"method": self.sketch.method,
                      "gamma": float(self.assigner.gamma),
                      "scheme": self.assigner.scheme,
                      "stream_version": int(self.sgraph.version),
                      "n_edges": int(graph.n_edges),
                      "exported_by": "StreamUpdater.export_artifact"}
        return CompressedArtifact(
            params={k: v.copy() for k, v in self.params.items()},
            edges=edges, sketch=self.sketch, model=model,
            provenance=provenance)
