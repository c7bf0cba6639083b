"""CCE-style learned sketching [49], the in-training baseline family
(port of ``repro.training.cce``).

"Clustering the sketch": start from a random sketch, train codebooks,
then re-cluster the EXPANDED embeddings (k-means) and rebuild the sketch
so co-embedded entities share rows. The paper runs CCE/LEGCF with
updates restricted to the first epoch for fairness; this follows that
protocol (one re-clustering after ``warm_steps``).

Training and evaluation run on ``device`` through the port's
``Trainer``; the k-means runs on the host in numpy, as in the reference
(``core.baselines._kmeans``), on the expanded embeddings copied back
once.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.baselines import _kmeans, random_sketch
from repro_torch.core.graph import BipartiteGraph
from repro_torch.core.sketch import Sketch
from repro_torch.models import lightgcn as L
from repro_torch.training.train_loop import TrainConfig, Trainer

__all__ = ["train_cce"]


def _recluster(trainer: Trainer, graph: BipartiteGraph, ku: int, kv: int,
               seed: int = 0) -> Sketch:
    """k-means the current codebook-expanded embeddings per side."""
    with torch.no_grad():
        u, v = L.all_embeddings(trainer.params, trainer.statics,
                                trainer.mcfg)
        u, v = u.float().cpu().numpy(), v.float().cpu().numpy()
    lu = _kmeans(u, ku, seed=seed)
    lv = _kmeans(v, kv, seed=seed + 1)
    return Sketch.one_hot(lu, lv, method="cce")


def train_cce(graph: BipartiteGraph, test_edges, *, budget: int,
              dim: int = 64, steps: int = 400, warm_steps: int = 100,
              batch_size: int = 2048, lr: float = 5e-3, seed: int = 0,
              device="cuda"):
    """Returns (metrics dict, final Sketch, Trainer)."""
    sk0 = random_sketch(graph, budget, seed=seed)
    cfg = TrainConfig(dim=dim, steps=warm_steps, batch_size=batch_size,
                      lr=lr, seed=seed)
    tr = Trainer(graph, sk0, cfg, device=device)
    tr.run(steps=warm_steps, log_every=0)
    # first-epoch re-clustering (paper's fairness protocol), then freeze
    sk1 = _recluster(tr, graph, sk0.k_users, sk0.k_items, seed=seed)
    cfg2 = TrainConfig(dim=dim, steps=steps, batch_size=batch_size, lr=lr,
                       seed=seed + 1)
    tr2 = Trainer(graph, sk1, cfg2, device=device)
    tr2.run(log_every=0)
    m = tr2.evaluate(test_edges)
    m["params"] = tr2.n_params()
    return m, sk1, tr2
