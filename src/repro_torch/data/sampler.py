"""BPR triplet samplers with deterministic, checkpointable state (port of
``repro.data.sampler``).

Two registered implementations behind ``make_sampler``:

* ``numpy`` — ``BPRSampler``, the host sampler, copied from the
  reference: each batch is drawn from a fresh generator derived from
  ``np.random.SeedSequence([seed, step])``, so it gives the reference's
  batches for the same seed, bit for bit.
* ``device`` — ``DeviceBPRSampler``, the port's own: the batch is drawn
  by a ``torch.Generator`` on the trainer's device and never leaves it.
  Each step's draw is a pure function of ``(seed, step)``: the generator
  is re-seeded from ``SeedSequence([seed, step])`` (host arithmetic, no
  device sync) before the step's draws. Negatives draw from
  [0, n_items - 1) and shift past the positive (``r + (r >= pos)``):
  uniform over the items other than the positive, in one draw. It does
  not reproduce ``jax.random``'s numbers (no numpy or torch generator
  does), so its batches differ from the reference's device sampler.

Both checkpoint as the same ``{"seed", "step"}`` state dict: restoring it
resumes the exact mini-batch stream.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.graph import BipartiteGraph
from repro_torch.device import resolve_device

__all__ = ["BPRSampler", "DeviceBPRSampler", "make_sampler",
           "available_samplers"]


class BPRSampler:
    name = "numpy"

    def __init__(self, graph: BipartiteGraph, batch_size: int, seed: int = 0,
                 device=None):
        self.n_users = graph.n_users
        self.n_items = graph.n_items
        self.edge_u = graph.edge_u
        self.edge_v = graph.edge_v
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.step = 0

    # -- checkpointable state ------------------------------------------------
    def state_dict(self):
        return {"seed": self.seed, "step": self.step}

    def load_state_dict(self, s):
        self.seed = int(s["seed"])
        self.step = int(s["step"])

    # -- sampling --------------------------------------------------------------
    def next_batch(self):
        """(users, pos_items, neg_items) int32[batch] — deterministic in step."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.step]))
        self.step += 1
        e = rng.integers(0, self.edge_u.shape[0], size=self.batch_size)
        users = self.edge_u[e]
        pos = self.edge_v[e]
        neg = rng.integers(0, self.n_items, size=self.batch_size)
        # reject collisions with the sampled positive (cheap re-draw)
        bad = neg == pos
        while bad.any():
            neg[bad] = rng.integers(0, self.n_items, size=int(bad.sum()))
            bad = neg == pos
        return (users.astype(np.int32), pos.astype(np.int32),
                neg.astype(np.int32))


def _step_seed(seed: int, step: int) -> int:
    """A 63-bit generator seed for step ``step`` of stream ``seed``."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(
        1, np.uint64)
    return int(state[0]) & ((1 << 63) - 1)


class DeviceBPRSampler:
    """BPR sampler on the device: ``sample_fn(seed, step)`` returns
    (users, pos, neg) int32 tensors on ``device``, a pure function of its
    arguments, and waits on nothing; ``next_batch`` draws the current
    step. The fused trainer calls ``sample_fn`` inside its chunks."""

    name = "device"

    def __init__(self, graph: BipartiteGraph, batch_size: int, seed: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.n_users = graph.n_users
        self.n_items = graph.n_items
        self.edge_u = torch.as_tensor(graph.edge_u, dtype=torch.int32,
                                      device=self.device)
        self.edge_v = torch.as_tensor(graph.edge_v, dtype=torch.int32,
                                      device=self.device)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.step = 0
        self._gen = torch.Generator(device=self.device)

    # -- checkpointable state ------------------------------------------------
    def state_dict(self):
        return {"seed": self.seed, "step": self.step}

    def load_state_dict(self, s):
        self.seed = int(s["seed"])
        self.step = int(s["step"])

    # -- sampling --------------------------------------------------------------
    def sample_fn(self, seed: int, step: int):
        """(users, pos, neg) int32 [batch] on the device for (seed, step)."""
        g = self._gen
        g.manual_seed(_step_seed(seed, step))
        n = (self.batch_size,)
        e = torch.randint(0, int(self.edge_u.shape[0]), n, generator=g,
                          device=self.device)
        r = torch.randint(0, max(self.n_items - 1, 1), n, generator=g,
                          device=self.device, dtype=torch.int32)
        users = self.edge_u[e]
        pos = self.edge_v[e]
        neg = r + (r >= pos).to(torch.int32)
        return users, pos, neg

    def next_batch(self):
        out = self.sample_fn(self.seed, self.step)
        self.step += 1
        return out


_SAMPLERS = {"numpy": BPRSampler, "device": DeviceBPRSampler}


def available_samplers():
    return tuple(sorted(_SAMPLERS))


def make_sampler(name: Optional[str], graph: BipartiteGraph,
                 batch_size: int, seed: int = 0, device="cuda"):
    """Registry constructor; name None -> the host numpy sampler.
    ``device`` is where the device sampler draws (the numpy sampler
    ignores it)."""
    key = "numpy" if name is None else str(name)
    if key not in _SAMPLERS:
        raise KeyError(f"unknown sampler {name!r}: "
                       f"expected one of {available_samplers()}")
    return _SAMPLERS[key](graph, batch_size, seed=seed, device=device)
