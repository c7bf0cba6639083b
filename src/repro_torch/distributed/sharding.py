"""Sharding helpers over ``torch.distributed`` (port of
``repro.distributed.sharding``): the edge partition of the paper
pipeline, and the logical-axis layouts of the model cells.

The reference is one controller over a ``jax`` device mesh; here each
device is one process (a rank), as torch does it. A rank learns its
world from the launcher (``torchrun``'s ``env://`` rendezvous) or, run
alone, makes a world of 1 on a localhost store. A ``cuda`` device means
NCCL and a ``cpu`` device means gloo; there is no fallback from one to
the other.

  * :func:`world` joins or makes the world and tears down what it made;
    :func:`cluster_mesh` / :func:`data_mesh` are 1-D
    ``torch.distributed.device_mesh.DeviceMesh`` objects over it, and
    raise outside one (no call here leaves a process group behind);
    ``launch.mesh`` makes the model cells' 2-D and 3-D meshes;
  * :func:`use_mesh` is the reference's ``with mesh:``; the code under
    it reads the mesh with :func:`current_mesh` and its data-parallel
    axes with :func:`batch_axes` (``training.compress``);
  * :func:`edge_partition` and :func:`pad_to_shards` cut the edge blocks
    and node ranges that ``core.solver_sharded`` splits one LP half-step
    over.

The logical axes. Model code names each tensor dim by a logical axis
("batch", "model", "seq", "data", "vocab" or None);
:func:`logical_to_spec` maps them to mesh axes under the mapping of
:func:`logical_mapping` ("tp", the default, or "dp"), :func:`fit_spec`
drops any partition whose factor does not divide its dim (the
reference's ``launch/steps.py::_fit_spec``), and
:func:`named_sharding` gives the :class:`Layout` of one tensor: the
mesh and its spec, with :meth:`Layout.local_block` (this rank's block
of a full tensor) and :meth:`Layout.gather` (the full tensor, by
all-gathers). A spec is a tuple with one entry a dim: a mesh axis name,
a tuple of names (major first), or None; it stands for the reference's
``PartitionSpec``, whose entries it holds. :func:`tree_layouts` gives a
params tree's layouts from a rule a leaf: :func:`recsys_axes` (the
reference's ``_recsys_param_axes``), :func:`vocab_axes` (the cf tables,
every sketch), :func:`replicated_axes` (``_gnn_param_axes``); it and
:meth:`Layout.local_shape` work on an ``AbstractMesh``, with no world.
The data-axis layouts of the LM cells are the reference's rules on
logical axes: :func:`zero1_axes` (``_zero1_axes``: one more dim of a
leaf over "data", or "vocab" under "dp") and :func:`opt_state_axes`
(``_opt_state_axes``: AdamW's moments, Adafactor's factored moments).

GSPMD has no counterpart here, so nothing takes a sharding constraint:
:func:`shard` is the identity on a rank's local tensor (the model code
keeps the reference's call sites), and where the reference lets GSPMD
insert collectives, the port's model code calls them itself
(``distributed.parallel``). The reference's ``shard_map`` has no
counterpart either: in a one-process-per-rank design every body is
already per-rank, and :meth:`Layout.local_block` and :meth:`Layout.gather`
do what its ``in_specs`` and ``out_specs`` did.
"""
from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = ["world", "entry_world", "cluster_mesh", "data_mesh", "use_mesh",
           "current_mesh", "batch_axes", "edge_partition", "pad_to_shards",
           "logical_mapping", "current_mapping", "logical_to_spec",
           "fit_spec", "named_sharding", "shard", "mesh_shape", "Layout",
           "is_table", "recsys_axes", "vocab_axes", "replicated_axes", "tree_layouts",
           "batch_layout", "ZERO_DATA_SIZE", "zero1_axes", "opt_state_axes"]

# what torchrun's env:// rendezvous sets for every rank
_RENDEZVOUS_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def _launched_by_torchrun() -> bool:
    """Whether the launcher set this process's rank and world."""
    return all(k in os.environ for k in _RENDEZVOUS_ENV)


def _backend(dev: torch.device) -> str:
    if dev.type not in _BACKEND:
        raise ValueError(f"no process-group backend for device {dev}")
    return _BACKEND[dev.type]


def _rank_device(dev: torch.device) -> torch.device:
    """The device this rank runs on: under torchrun a CUDA rank takes the
    card of its ``LOCAL_RANK``."""
    if dev.type != "cuda":
        return dev
    if _launched_by_torchrun():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return torch.device("cuda", torch.cuda.current_device()
                        if dev.index is None else dev.index)


def _check_world(dev: torch.device) -> None:
    got = dist.get_backend()
    if got != _backend(dev):
        raise RuntimeError(f"the process group runs {got!r}, but device "
                           f"{dev} needs {_backend(dev)!r}")


def _init_world(dev: torch.device) -> torch.device:
    dev = _rank_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if _launched_by_torchrun():
        dist.init_process_group(_backend(dev), init_method="env://")
    else:
        # port 0: the OS picks a free port, so two runs never collide
        store = dist.TCPStore("127.0.0.1", 0, 1, True)
        dist.init_process_group(_backend(dev), store=store, rank=0,
                                world_size=1)
    return dev


@contextlib.contextmanager
def world(device="cuda"):
    """Join the launcher's world, or make a world of 1 on a localhost
    store; yields this rank's device. A world this call made is
    destroyed when the block ends, also when it raises; a world that
    was already there is only checked against the device's backend."""
    dev = resolve_device(device)
    if dist.is_initialized():
        _check_world(dev)
        yield _rank_device(dev)
        return
    dev = _init_world(dev)
    try:
        yield dev
    finally:
        dist.destroy_process_group()


def entry_world(device, sharded: bool):
    """The entry points' world: the launcher's under torchrun, a world of
    1 when a sharded solver or trainer was asked for, else none (the
    context then yields the resolved device)."""
    if sharded or _launched_by_torchrun():
        return world(device)
    return contextlib.nullcontext(resolve_device(device))


def cluster_mesh(n_devices: Optional[int] = None, axis: str = "edge",
                 device="cuda"):
    """1-D device mesh over the current world, named ``axis``; raises
    when no process group is initialised (open one with :func:`world`).
    ``n_devices``, when given, must be the world size."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("no torch.distributed world: run under "
                           "repro_torch.distributed.world(device) or "
                           "torchrun")
    dev = resolve_device(device)
    _check_world(dev)
    n = dist.get_world_size()
    if n_devices is not None and int(n_devices) != n:
        raise ValueError(f"a mesh of {n_devices} devices needs a world of "
                         f"{n_devices} ranks, this world has {n}")
    return init_device_mesh(dev.type, (n,), mesh_dim_names=(axis,))


def data_mesh(n_devices: Optional[int] = None, device="cuda"):
    """1-D "data" mesh over the world: the fused_sharded trainer splits
    each BPR batch across it and all-reduces the gradients."""
    return cluster_mesh(n_devices, axis="data", device=device)


_MESH = contextvars.ContextVar("repro_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """The reference's ``with mesh:``: code in the block sees ``mesh`` as
    :func:`current_mesh`."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh():
    """The mesh of the innermost :func:`use_mesh` block, or None."""
    return _MESH.get()


def batch_axes(mesh) -> tuple:
    """Mesh axes implementing the logical batch axis."""
    names = mesh.mesh_dim_names or ()
    return tuple(a for a in ("pod", "data") if a in names)


# ---------------------------------------------------------------------------
# logical axes -> mesh axes
# ---------------------------------------------------------------------------
_MAPPING = contextvars.ContextVar("repro_torch_mapping", default="tp")


@contextlib.contextmanager
def logical_mapping(mode: str):
    """'tp' (the default) or 'dp': under "dp", "batch" goes over every
    mesh axis and "model"/"seq" dims are replicated (pure data
    parallelism)."""
    if mode not in ("tp", "dp"):
        raise ValueError(mode)
    token = _MAPPING.set(mode)
    try:
        yield
    finally:
        _MAPPING.reset(token)


def current_mapping() -> str:
    return _MAPPING.get()


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (or of any object with
    ``mesh_dim_names`` and ``shape``, such as ``launch.mesh.AbstractMesh``)."""
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))


def _one_or_tuple(axes: tuple):
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def logical_to_spec(mesh, axes: Sequence[Optional[str]]) -> tuple:
    """One spec entry for each logical axis (the reference's rule)."""
    names = tuple(mesh.mesh_dim_names)
    dp = current_mapping() == "dp"
    out = []
    for a in axes:
        if a is None:
            out.append(None)
        elif a == "batch":
            ba = batch_axes(mesh)
            if dp and "model" in names:
                ba = ba + ("model",)
            out.append(_one_or_tuple(ba))
        elif a in ("model", "seq"):
            out.append(None if dp or "model" not in names else "model")
        elif a == "data":
            out.append("data" if "data" in names else None)
        elif a == "vocab":
            # giant embedding tables: rows over the whole pod (data x
            # model), replicated across pods
            out.append(_one_or_tuple(tuple(
                x for x in ("data", "model") if x in names)))
        else:
            raise ValueError(f"unknown logical axis {a!r}")
    return tuple(out)


def _entry_axes(part) -> tuple:
    return part if isinstance(part, tuple) else ((part,) if part else ())


def fit_spec(mesh, spec: Sequence, shape) -> tuple:
    """Downgrade any partition whose factor does not divide its dim:
    ('data', 'model') -> 'data' -> 'model' -> replicated, and a mesh axis
    in one dim only (the reference's ``_fit_spec``)."""
    sizes = mesh_shape(mesh)
    out = []
    used = set()
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    for i, part in enumerate(spec):
        if part is None:
            out.append(None)
            continue
        cands = [part] + (list(part) if isinstance(part, tuple) else [])
        cands.append(None)
        chosen = None
        for c in cands:
            axes = _entry_axes(c)
            if any(a in used for a in axes):
                continue
            if shape[i] % int(np.prod([sizes[a] for a in axes])) == 0:
                chosen = c
                break
        used.update(_entry_axes(chosen))
        out.append(chosen)
    return tuple(out)


class Layout:
    """One tensor's layout over a mesh: its spec, fitted to a shape when
    given one (``named_sharding(mesh, *axes, shape=...)``). A dim of
    entry ``(a, b)`` is cut into ``|a| x |b|`` blocks, ``a`` major, as
    ``PartitionSpec`` cuts it."""

    def __init__(self, mesh, spec: tuple):
        self.mesh = mesh
        self.spec = tuple(spec)

    def __repr__(self) -> str:
        return f"Layout({self.spec})"

    @property
    def axes(self) -> tuple:
        """Every mesh axis some dim is split over."""
        return tuple(a for part in self.spec for a in _entry_axes(part))

    def _block(self, dim: int, size: int):
        """(start, length) of this rank's block of ``dim``."""
        sizes = mesh_shape(self.mesh)
        coord = dict(zip(self.mesh.mesh_dim_names,
                         self.mesh.get_coordinate()))
        idx, n = 0, 1
        for a in _entry_axes(self.spec[dim]):
            idx = idx * sizes[a] + coord[a]
            n *= sizes[a]
        if size % n:
            raise ValueError(f"dim {dim} of {size} does not split {n} ways "
                             f"(spec {self.spec}: fit it first)")
        return idx * (size // n), size // n

    def local_shape(self, shape) -> tuple:
        """The shape of every rank's block of a tensor of ``shape`` (no
        rank needed: works on an ``AbstractMesh``)."""
        sizes = mesh_shape(self.mesh)
        return tuple(n // int(np.prod([sizes[a] for a in _entry_axes(part)]))
                     for n, part in zip(shape, self.spec + (None,) * (
                         len(shape) - len(self.spec))))

    def local_block(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full``: a view (the tensor itself when
        no dim is split)."""
        out = full
        for dim, part in enumerate(self.spec):
            if part is not None:
                start, length = self._block(dim, full.shape[dim])
                out = out.narrow(dim, start, length)
        return out

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's block: one all-gather over
        each split axis, minor axis first."""
        from repro_torch.distributed import parallel

        out = block
        for dim, part in enumerate(self.spec):
            for a in reversed(_entry_axes(part)):
                out = parallel.all_gather_cat(out, self.mesh.get_group(a),
                                              dim)
        return out


def named_sharding(mesh, *axes: Optional[str], shape=None) -> Layout:
    """The :class:`Layout` of a tensor whose dims carry ``axes``: its spec
    by :func:`logical_to_spec`, fitted to ``shape`` when given."""
    spec = logical_to_spec(mesh, axes)
    return Layout(mesh, spec if shape is None else
                  fit_spec(mesh, spec, shape))


def is_table(path: str) -> bool:
    """Whether a recsys param (by its flat path) is an embedding table:
    ``emb_*``, ``wide_*`` or ``item_emb``."""
    name = path.split("/")[-1]
    return name.startswith(("emb_", "wide_")) or name == "item_emb"


def recsys_axes(path: str, shape) -> tuple:
    """A recsys param's logical axes (the reference's
    ``_recsys_param_axes``): an embedding table (:func:`is_table`) splits
    its rows over "vocab"; the rest is replicated."""
    if is_table(path):
        return vocab_axes(path, shape)
    return replicated_axes(path, shape)


def vocab_axes(path: str, shape) -> tuple:
    """Rows over "vocab" (the cf tables and codebooks, every sketch)."""
    return ("vocab",) + (None,) * (len(shape) - 1)


def replicated_axes(path: str, shape) -> tuple:
    """Replicated (the reference's ``_gnn_param_axes``: SchNet's params)."""
    return (None,) * len(shape)


def tree_layouts(mesh, tree, axes):
    """The :class:`Layout` of every leaf of ``tree`` (dicts and lists of
    tensors, meta tensors too), mirroring it: ``axes(path, shape)`` gives
    a leaf's logical axes (:func:`recsys_axes`, :func:`vocab_axes`,
    :func:`replicated_axes`), fitted to its shape. Works on an
    ``AbstractMesh``."""
    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, f"{prefix}{i}/") for i, v in enumerate(node)]
        shape = tuple(node.shape)
        return named_sharding(mesh, *axes(prefix[:-1], shape), shape=shape)
    return walk(tree, "")


def batch_layout(mesh, ndim: int, split: bool) -> Layout:
    """A batch leaf's layout: dim 0 over the logical "batch" axes (every
    axis under "dp") when ``split``, else replicated (the port splits a
    cell's batch over all its data axes or none:
    ``parallel.rank_groups``)."""
    ba = logical_to_spec(mesh, ("batch",))[0] if split else None
    return Layout(mesh, (ba,) + (None,) * (ndim - 1))


# the reference's ZeRO-1 rule tests divisibility by a fixed data size of
# 16 (``_zero1_axes(..., data_size=16)``), whatever the mesh; fit_spec
# then drops what the real mesh does not divide
ZERO_DATA_SIZE = 16


def _has_data(axes: tuple) -> bool:
    return any(a in ("data", "vocab") or (isinstance(a, tuple) and "data" in a)
               for a in axes)


def _zero1_leaf(axes: tuple, shape, tag: str, data_size: int) -> tuple:
    if _has_data(axes):
        return axes             # already over the data axis (FSDP, "vocab")
    best, best_dim = None, 0
    for i, a in enumerate(axes):
        if a is None and shape[i] % data_size == 0 and shape[i] > best_dim:
            best, best_dim = i, shape[i]
    if best is None:
        return axes
    return axes[:best] + (tag,) + axes[best + 1:]


def zero1_axes(axes, shapes, tag: str = "data",
               data_size: int = ZERO_DATA_SIZE):
    """The reference's ZeRO-1 rule (``repro/launch/steps.py:121-152``) on a
    tree of logical axes (nested dicts, tuple leaves) and the same tree
    of shapes: a leaf that carries no "data" or "vocab" axis yet takes
    ``tag`` on its largest replicated dim that ``data_size`` divides (the
    first such dim on a tie); the rest keep their axes."""
    if isinstance(axes, dict):
        return {k: zero1_axes(v, shapes[k], tag, data_size)
                for k, v in axes.items()}
    return _zero1_leaf(tuple(axes), tuple(shapes), tag, data_size)


def opt_state_axes(name: str, axes: dict, shapes: Optional[dict] = None,
                   tag: str = "data") -> dict:
    """The reference's ``_opt_state_axes`` (``repro/launch/steps.py:155-174``)
    over flat {key: logical axes}: AdamW's ``m`` and ``v`` mirror the
    params, ZeRO-1'd by :func:`zero1_axes` when ``shapes`` are given;
    Adafactor's factored moments are ``vr`` = ``axes[:-1]`` and ``vc`` =
    ``axes[:-2] + axes[-1:]`` of a param of 2 dims or more, ``v`` = its
    axes for one of 1, one entry a param in sorted-key order (the
    optimizer's ``fac`` list). The step counter is a scalar."""
    if name == "adamw":
        m = axes if shapes is None else zero1_axes(axes, shapes, tag)
        return {"step": (), "m": dict(m), "v": dict(m)}
    if name == "adafactor":
        fac = []
        for k in sorted(axes):
            ax = tuple(axes[k])
            fac.append({"vr": ax[:-1], "vc": ax[:-2] + ax[-1:]}
                       if len(ax) >= 2 else {"v": ax})
        return {"step": (), "fac": fac}
    raise ValueError(name)


def shard(x, *axes: Optional[str]):
    """The identity: a rank's tensor is already its block (the reference
    constrains GSPMD's layout here; the port's layouts and explicit
    collectives place the data)."""
    return x


# ---------------------------------------------------------------------------
# edge-partitioned co-clustering (ClusterEngine "torch_sharded" solver)
#
# The LP half-step updates one side of the bipartite graph from its
# incident edges. Edges arrive sorted by the updating-side node, so a
# contiguous partition of that side's node range induces a contiguous
# edge partition: each rank owns a node range plus exactly the edges
# into it, computes the per-(node, candidate-label) counts locally, and
# only the per-label opposite-side weight totals, one f32[n_labels]
# vector, cross ranks, through one all-reduce.
# ---------------------------------------------------------------------------
def edge_partition(node_of_edge: np.ndarray, opp_of_edge: np.ndarray,
                   n_side: int, n_shards: int, bounds=None):
    """Split edges (sorted by updating-side node) into per-shard blocks.

    Default (bounds=None): nodes are partitioned into ``n_shards``
    contiguous ranges of ``nodes_per_shard``; each shard's edge block is
    the contiguous run of edges into its range, padded to the max block
    length with sentinel edges (local node id == nodes_per_shard) at
    its tail. Returns (node_local int32[S*Emax], opp int32[S*Emax],
    nodes_per_shard), flat, shard s at ``[s*Emax, (s+1)*Emax)``.

    bounds: optional node-aligned EDGE offsets (``node_aligned_bounds``
    / ``graph.edge_block_bounds``) of length ``n_shards + 1``. Shards
    then own edge-balanced blocks, node alignment is validated, and the
    return gains each shard's first owned node: (node_local, opp,
    nodes_per_shard, node_starts int64[S + 1]) with local ids relative
    to ``node_starts[s]``.
    """
    if bounds is None:
        nps = max(1, -(-n_side // n_shards))
        bounds = np.searchsorted(
            node_of_edge, np.arange(n_shards + 1, dtype=np.int64) * nps)
        emax = max(1, int(np.max(np.diff(bounds))))
        node_local = np.full((n_shards, emax), nps, dtype=np.int32)
        opp = np.zeros((n_shards, emax), dtype=np.int32)
        for s in range(n_shards):
            lo, hi = int(bounds[s]), int(bounds[s + 1])
            node_local[s, :hi - lo] = node_of_edge[lo:hi] - s * nps
            opp[s, :hi - lo] = opp_of_edge[lo:hi]
        return node_local.reshape(-1), opp.reshape(-1), nps
    bounds = np.asarray(bounds, np.int64)
    e = int(node_of_edge.shape[0])
    if bounds.size != n_shards + 1 or bounds[0] != 0 or bounds[-1] != e:
        raise ValueError(f"bounds must be {n_shards + 1} offsets covering "
                         f"[0, {e}], got shape {bounds.shape}")
    cuts = bounds[1:-1]
    inner = cuts[(cuts > 0) & (cuts < e)]
    if inner.size and np.any(node_of_edge[inner - 1] == node_of_edge[inner]):
        raise ValueError("bounds are not node-aligned: a node's edge run "
                         "straddles a shard cut")
    node_starts = np.full(n_shards + 1, n_side, np.int64)
    if e:
        node_starts[:-1] = node_of_edge[np.minimum(bounds[:-1], e - 1)]
    else:
        node_starts[:-1] = 0
    nps = max(1, int(np.max(np.diff(node_starts))))
    emax = max(1, int(np.max(np.diff(bounds))))
    node_local = np.full((n_shards, emax), nps, dtype=np.int32)
    opp = np.zeros((n_shards, emax), dtype=np.int32)
    for s in range(n_shards):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        node_local[s, :hi - lo] = node_of_edge[lo:hi] - node_starts[s]
        opp[s, :hi - lo] = opp_of_edge[lo:hi]
    return node_local.reshape(-1), opp.reshape(-1), nps, node_starts


def pad_to_shards(x: np.ndarray, n_shards: int, per_shard: int,
                  fill=0) -> np.ndarray:
    """Pad a per-node host array to n_shards*per_shard (shard s owns
    ``[s*per_shard, (s+1)*per_shard)``)."""
    out = np.full(n_shards * per_shard, fill, dtype=x.dtype)
    out[:x.shape[0]] = x
    return out
