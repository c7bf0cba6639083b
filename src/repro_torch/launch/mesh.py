"""Production mesh factory (port of ``repro.launch.mesh``).

Functions, not module constants, so importing never touches a process
group. Single pod: (data=16, model=16) = 256 ranks. Multi-pod: a leading
pure data-parallel "pod" axis -> 512 ranks. Each is a
``torch.distributed.device_mesh.DeviceMesh`` over the current world (one
process a device: open it with ``distributed.world`` or ``torchrun``),
which must hold exactly its ranks. :class:`AbstractMesh` is a mesh's
shape and axis names with no devices, for layouts reckoned without a
world (the reference's ``jax.sharding.AbstractMesh``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = ["make_production_mesh", "make_host_mesh", "make_mesh",
           "AbstractMesh"]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis sizes and names (``DeviceMesh``'s ``shape`` and
    ``mesh_dim_names``), with no devices behind them."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def make_mesh(shape, axes, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the current world;
    raises, naming the ranks it needs, when the world holds another
    number of them (or there is no world)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    need = int(np.prod(shape))
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise ValueError(f"a {tuple(shape)} {tuple(axes)} mesh needs a "
                         f"world of {need} ranks; this world has {have}")
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_host_mesh(device="cuda"):
    """1-rank mesh with the same axis names (tests / smoke runs)."""
    return make_mesh((1, 1), ("data", "model"), device)
