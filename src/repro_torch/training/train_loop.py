"""End-to-end LightGCN trainer (port of ``repro.training.train_loop``).

build sketch -> init codebooks -> BPR steps -> Recall/NDCG@20 -> export,
behind a trainer-backend registry:

* ``host`` — one step per loop iteration, the numpy sampler by default,
  and a blocking ``float(loss)`` every step (the reference's
  ``:128-166``). The parity oracle: ``fused`` is bitwise equal to it
  with ``sampler="device"``, since both run the same step.
* ``fused`` — chunks of ``chunk_size`` steps with the device sampler and
  no host sync inside a chunk (the reference's ``lax.scan`` chunk,
  ``:197-265``, as a Python loop that only enqueues work): each step's
  loss stays on the device, and the chunk's losses are copied to the
  host once. Chunks never straddle a checkpoint multiple, so the save
  points (and bitwise resume) are the host backend's.

* ``fused_sharded`` — ``fused`` data parallel over the ranks of a
  ``torch.distributed`` world (the reference's ``:268-319``): params are
  replicated, every rank draws the identical global batch for
  (seed, step) and takes its contiguous slice, and the gradients of all
  leaves and the loss go through ONE all-reduce a step over one flat
  buffer, divided by the world size, before the same AdamW update. On a
  world of 1 it is bitwise ``fused``. Only rank 0 writes checkpoints.

* ``host_seed`` — the host loop over the frozen seed step
  (``lightgcn.bpr_loss_fn_seed``: ``index_add_`` propagation, six
  readout gathers): the benchmarks' "seed host loop" baseline, which no
  default selects (the reference's ``:170-193``).

Fault tolerance: ``CheckpointManager`` captures (params, optimizer
state, sampler state) in the reference's layout; ``maybe_resume``
continues bitwise (sampling is a pure function of (seed, step)), also
from a checkpoint the reference wrote.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.graph import BipartiteGraph
from repro_torch.core.sketch import Sketch
from repro_torch.data.sampler import make_sampler
from repro_torch.device import resolve_device
from repro_torch.models import lightgcn as L
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.eval import recall_ndcg_at_k, topk_streaming

__all__ = ["TrainConfig", "Trainer", "TrainerBackend",
           "register_trainer_backend", "available_trainer_backends",
           "normalize_trainer_backend"]


@dataclasses.dataclass
class TrainConfig:
    dim: int = 64
    n_layers: int = 3
    lr: float = 1e-3
    l2: float = 1e-4
    batch_size: int = 1024
    steps: int = 600
    seed: int = 0
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    eval_k: int = 20
    # EmbeddingEngine backend for all table lookups (None -> auto)
    lookup_backend: Optional[str] = None
    # trainer backend: host | host_seed | fused | fused_sharded
    # (None/auto -> host)
    backend: Optional[str] = None
    # steps per chunk (fused backends)
    chunk_size: int = 16
    # sampler: numpy | device (None -> the backend's default)
    sampler: Optional[str] = None
    # fused_sharded: the world size it requires (None -> the whole world)
    n_devices: Optional[int] = None
    # streaming evaluation: items scored per block
    eval_item_block: int = 4096


# ---------------------------------------------------------------------------
# trainer backend registry
# ---------------------------------------------------------------------------
class TrainerBackend:
    """One training strategy: drives trainer.(params, opt_state, step)
    forward. Subclass and ``register_trainer_backend`` to add one."""

    name = "?"
    default_sampler = "numpy"
    saves = True          # this process writes the checkpoints

    def setup(self, trainer: "Trainer"):
        """Check what the backend needs of the trainer."""

    def run(self, trainer: "Trainer", steps: int, log_every: int):
        """Advance to `steps` total steps; returns per-step host losses."""
        raise NotImplementedError


_TRAINER_BACKENDS = {}


def register_trainer_backend(cls):
    _TRAINER_BACKENDS[cls.name] = cls
    return cls


def available_trainer_backends():
    return tuple(sorted(_TRAINER_BACKENDS))


def normalize_trainer_backend(name: Optional[str]) -> Optional[str]:
    """None/'auto' -> None (Trainer picks 'host'); validates otherwise."""
    if name is None or name == "auto":
        return None
    if name not in _TRAINER_BACKENDS:
        raise KeyError(f"unknown trainer backend {name!r}: "
                       f"expected one of {available_trainer_backends()}")
    return name


def _make_trainer_backend(name: Optional[str]) -> TrainerBackend:
    return _TRAINER_BACKENDS[normalize_trainer_backend(name) or "host"]()


def _log(losses, step, log_every, t0):
    print(f"  step {step}: loss={np.mean(losses[-log_every:]):.4f} "
          f"({time.time() - t0:.1f}s)")


@register_trainer_backend
class HostBackend(TrainerBackend):
    """One step per iteration and a host sync per step."""

    name = "host"
    default_sampler = "numpy"

    def run(self, trainer, steps, log_every):
        losses = []
        t0 = time.time()
        while trainer.step < steps:
            u, p, n = trainer.sampler.next_batch()
            batch = {"user": trainer._on(u), "pos": trainer._on(p),
                     "neg": trainer._on(n)}
            loss = trainer.train_step(batch)
            trainer.step += 1
            losses.append(float(loss))
            trainer._maybe_checkpoint()
            if log_every and trainer.step % log_every == 0:
                _log(losses, trainer.step, log_every, t0)
        return losses


@register_trainer_backend
class HostSeedBackend(HostBackend):
    """The seed implementation frozen end to end: the host loop driving
    the seed step (scatter-add propagation, six readout gathers).
    Benchmark reference only. Numerically equivalent to ``host``, not
    bitwise (the sums add in another order)."""

    name = "host_seed"
    default_sampler = "numpy"

    def setup(self, trainer):
        trainer._loss_fn = L.bpr_loss_fn_seed


@register_trainer_backend
class FusedBackend(TrainerBackend):
    """Chunks of sample + step with no host sync inside a chunk; one copy
    of the chunk's losses to the host."""

    name = "fused"
    default_sampler = "device"

    def setup(self, trainer):
        if getattr(trainer.sampler, "sample_fn", None) is None:
            raise ValueError(
                f"trainer backend {self.name!r} needs an on-device sampler "
                f"exposing sample_fn (sampler='device'), got "
                f"{type(trainer.sampler).__name__}")

    def _chunk_len(self, trainer, steps) -> int:
        """Next chunk length: chunk_size, clipped so the chunk ends at
        `steps` and never straddles a checkpoint-cadence multiple."""
        n = min(max(1, int(trainer.cfg.chunk_size)), steps - trainer.step)
        if trainer.ckpt is not None and trainer.ckpt.every > 0:
            to_ckpt = trainer.ckpt.every - trainer.step % trainer.ckpt.every
            n = min(n, to_ckpt)
        return n

    def chunk(self, trainer, n: int) -> torch.Tensor:
        """Steps [trainer.step, trainer.step + n): returns the losses as a
        device tensor [n]. Enqueues work only; nothing waits on the
        device."""
        sample = trainer.sampler.sample_fn
        seed = trainer.sampler.seed
        losses = torch.empty(n, dtype=torch.float32, device=trainer.device)
        for i in range(n):
            u, p, neg = sample(seed, trainer.step + i)
            losses[i] = self.step(trainer, {"user": u, "pos": p, "neg": neg})
        trainer.step += n
        trainer.sampler.step = trainer.step
        return losses

    def step(self, trainer, batch: dict) -> torch.Tensor:
        """One step on a global batch; the loss as a 0-d device tensor."""
        return trainer.train_step(batch)

    def run(self, trainer, steps, log_every):
        losses = []
        t0 = time.time()
        while trainer.step < steps:
            prev = trainer.step
            chunk_losses = self.chunk(trainer, self._chunk_len(trainer, steps))
            losses.extend(chunk_losses.tolist())          # 1 copy a chunk
            trainer._maybe_checkpoint(prev_step=prev)
            if log_every and trainer.step // log_every > prev // log_every:
                _log(losses, trainer.step, log_every, t0)
        return losses


@register_trainer_backend
class FusedShardedBackend(FusedBackend):
    """``fused`` data parallel over the ranks of a "data" mesh: each rank
    takes its contiguous slice of the global batch, and one all-reduce a
    step sums the gradients and the loss (mean over equal local means ==
    the global batch mean). The all-reduce is enqueued on the device like
    every other step op, so a chunk still makes no host sync. Needs an
    open world (``distributed.world`` or torchrun); the trainer raises
    outside one."""

    name = "fused_sharded"
    default_sampler = "device"

    def setup(self, trainer):
        from repro_torch.distributed.sharding import data_mesh
        super().setup(trainer)
        mesh = data_mesh(trainer.cfg.n_devices, device=trainer.device)
        n_dev = mesh.size()
        batch = int(trainer.cfg.batch_size)
        if batch % n_dev:
            raise ValueError(f"batch_size {batch} not divisible by the "
                             f"{n_dev}-device data mesh")
        self.local = batch // n_dev
        self.lo = mesh.get_local_rank() * self.local
        self.group = mesh.get_group()
        self.saves = mesh.get_local_rank() == 0
        # a device tensor: dividing by a host scalar on CUDA multiplies
        # by its reciprocal, which is not the reference's division
        self.world = torch.full((), float(n_dev), dtype=torch.float32,
                                device=trainer.device)
        numel = sum(int(p.numel()) for p in trainer.params.values())
        self.allreduce_bytes = 4 * (numel + 1)

    def step(self, trainer, batch):
        local = {k: v[self.lo:self.lo + self.local] for k, v in batch.items()}
        names = sorted(trainer.params)
        loss, grads = trainer.loss_and_grads(local)
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])
        dist.all_reduce(flat, group=self.group)
        flat = flat / self.world
        parts = flat.split([int(g.numel()) for g in grads] + [1])
        trainer.optimizer.update(
            {k: part.view(g.shape) for k, part, g in zip(names, parts, grads)},
            trainer.opt_state, trainer.params)
        return parts[-1][0]


class Trainer:
    """``Trainer(graph, sketch, cfg, device="cuda")``: LightGCN + BPR on
    (codebook) tables with AdamW, the reference's trainer. Params are
    drawn from ``init_params(cfg.seed)`` (numpy; the reference draws from
    a ``jax.random`` key, so two fresh trainers differ: carry a state
    across with a checkpoint)."""

    def __init__(self, graph: BipartiteGraph, sketch: Optional[Sketch],
                 cfg: TrainConfig, device="cuda"):
        self.device = resolve_device(device)
        self.graph = graph
        self.sketch = sketch
        self.cfg = cfg
        self.mcfg = L.from_sketch(graph, sketch, dim=cfg.dim,
                                  n_layers=cfg.n_layers, l2=cfg.l2,
                                  lookup_backend=cfg.lookup_backend)
        self.statics = L.make_statics(graph, sketch, device=self.device)
        self.backend = _make_trainer_backend(cfg.backend)
        self._loss_fn = L.bpr_loss_fn
        self.sampler = make_sampler(cfg.sampler
                                    or self.backend.default_sampler,
                                    graph, cfg.batch_size, seed=cfg.seed,
                                    device=self.device)
        self.optimizer = opt_lib.adamw(lr=cfg.lr)
        self.params = {k: torch.as_tensor(v, device=self.device)
                       .requires_grad_(True)
                       for k, v in L.init_params(cfg.seed, self.mcfg).items()}
        self.opt_state = self.optimizer.init(self.params)
        self.step = 0
        self.ckpt = (CheckpointManager(cfg.ckpt_dir, every=cfg.ckpt_every)
                     if cfg.ckpt_dir else None)
        self.backend.setup(self)

    def _on(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def loss_and_grads(self, batch: dict):
        """The BPR loss (0-d, detached) and the gradients of the params in
        sorted-name order."""
        names = sorted(self.params)
        loss = self._loss_fn(self.params, self.statics, batch, self.mcfg)
        grads = torch.autograd.grad(loss, [self.params[k] for k in names])
        return loss.detach(), grads

    def train_step(self, batch: dict) -> torch.Tensor:
        """One BPR step in place: loss, gradients of both tables, AdamW.
        Returns the loss as a 0-d device tensor."""
        loss, grads = self.loss_and_grads(batch)
        self.optimizer.update(dict(zip(sorted(self.params), grads)),
                              self.opt_state, self.params)
        return loss

    # -- checkpoint glue -----------------------------------------------------
    def _state_tree(self):
        return {"params": self.params, "opt": self.opt_state}

    def _maybe_checkpoint(self, prev_step: Optional[int] = None,
                          force: bool = False):
        if self.ckpt is not None and self.backend.saves:
            self.ckpt.maybe_save(self.step, self._state_tree(),
                                 extra={"sampler":
                                        self.sampler.state_dict()},
                                 force=force, prev_step=prev_step)

    def maybe_resume(self) -> bool:
        if self.ckpt is None:
            return False
        step, tree, extra = self.ckpt.restore_latest(self._state_tree())
        if step is None:
            return False
        self.params = {k: v.requires_grad_(True)
                       for k, v in tree["params"].items()}
        self.opt_state = tree["opt"]
        self.sampler.load_state_dict(extra["sampler"])
        self.step = step
        return True

    # -- training -------------------------------------------------------------
    def run(self, steps: Optional[int] = None, log_every: int = 200):
        steps = steps if steps is not None else self.cfg.steps
        losses = self.backend.run(self, steps, log_every)
        self._maybe_checkpoint(force=True)
        return losses

    # -- evaluation -------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, test_edges, k: Optional[int] = None,
                 max_users: int = 4096, item_block: Optional[int] = None,
                 topk_backend: str = "block"):
        """Streaming Recall/NDCG@k: items are scored in blocks against a
        running top-k on the device, with the eval users' training
        interactions excluded. ``topk_backend``: "block" (the
        reference's default), "hostloop" or "fused" (the fused_topk
        kernel)."""
        k = k or self.cfg.eval_k
        tu, ti = test_edges
        users = np.unique(np.asarray(tu))
        if users.size > max_users:
            users = np.sort(np.random.default_rng(0).choice(
                users, max_users, replace=False))
        u_eval, v_all = L.eval_embeddings(self.params, self.statics,
                                          self.mcfg, self._on(users))
        # training interactions of the eval users, as (row, item) pairs
        eu, ev = self.graph.edge_u, self.graph.edge_v
        keep = np.isin(eu, users)
        rows = np.searchsorted(users, eu[keep]).astype(np.int32)
        topk = topk_streaming(u_eval, v_all, k,
                              block=item_block or self.cfg.eval_item_block,
                              exclude=(rows, ev[keep].astype(np.int32)),
                              backend=topk_backend)
        return recall_ndcg_at_k(topk, tu, ti, users, k=k)

    def n_params(self) -> int:
        return sum(int(p.numel()) for p in self.params.values())

    # -- deployment -----------------------------------------------------------
    def export(self, directory: Optional[str] = None):
        """Snapshot this run into a deployable CompressedArtifact (sketch
        indices + trained codebooks + model config + provenance); saves
        atomically when `directory` is given."""
        from repro_torch.serve import CompressedArtifact
        artifact = CompressedArtifact.from_trainer(self)
        if directory is not None:
            artifact.save(directory)
        return artifact
