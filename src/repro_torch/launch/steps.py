"""Step builders: (arch x shape) -> a Cell of (step fn, args) (port of
``repro.launch.steps``: the LM, GNN, recsys and cf families).

Every builder returns a ``Cell``:
    fn:      the step (train / serve / retrieval) on tensors
    args:    its arguments, tensors on the cell's device
    donate:  the argnums the reference donates (params/opt-state); the
             port's train step updates them in place instead

``smoke=True`` builds the reference's smoke cell: its smoke config, and
inputs drawn exactly as the reference draws them (``_materialize``, the
statics rules), so the same numpy values reach both packages. Params are
drawn from a torch generator (the reference draws from a jax.random key,
which torch cannot reproduce); tests carry the reference's params over
with ``models.recsys.params_from_numpy``.

``smoke=False`` builds the full published config on the device (the
reference builds ShapeDtypeStructs for a dry run there): params from the
model's init under ``torch.Generator`` seed 0, each compressed field's
sketch a seeded random assignment into its codebook (the reference's
smoke rule, numpy seed 0; the repo holds no Criteo or MovieLens data),
and batches with ids uniform over each field's vocabulary, dense inputs
standard normal, labels in {0, 1}.

The LM family (``_lm_cell``): train, prefill and decode cells of
``models.transformer``, dense and MoE. Smoke draws are one
``default_rng(0)`` over the args in ``jax.tree.map`` order (decode: the
cache's keys sorted, then ``pos``, then ``tokens``). At full width the
params come from ``init_params`` under generator seed 0, tokens uniform
over the vocabulary, and a decode cell's cache is drawn standard normal
in the cache dtype with ``pos = seq_len - 1``, so every step reads a
full cache. ``batch=`` and ``n_layers=`` cut a full-width cell to one card
(``LM_ONE_CARD``; each cut is listed in ``Cell.reduced``); a MoE is cut
by layers and batch only, never by experts (that would change the
routing).

The GNN family (``_gnn_cell``): SchNet's four train cells. Smoke draws
are the reference's ``_materialize``; at full width (``_gnn_batch``) the
inputs are drawn on the host from numpy seed 0 at the published shapes,
node and edge counts padded to the pod width as in the reference
(``pad_rows``; pad nodes are masked out, pad edges lie past the cutoff),
``minibatch_lg``'s batch from the real neighbor sampler. ``n_edges=``
cuts a cell's edges (``GNN_ONE_CARD``: ``ogb_products`` keeps 1/8 of
them on one card).

``mesh=`` (a ``DeviceMesh`` over the world: ``launch.mesh``) runs a cell
over (data, model) ranks, one process a rank: ``Cell.fn`` runs on this
rank's blocks of the args and returns what the unsharded cell returns
(the outputs of the whole batch, the loss over it; the params, statics
and caches stay this rank's blocks, ``Cell.gather`` assembles them from
``Cell.layouts``). Each rank draws the unsharded cell's values and keeps
its blocks, or takes ``args=``, the unsharded cell's args (a fresh
optimizer state), and cuts them (on a world of 1 the blocks are those
tensors). The layouts are the reference's logical axes ->
``logical_to_spec`` -> ``fit_spec``:
  * LM cells (:func:`_lm_layouts`, under the shape's logical mapping,
    "tp" or "dp"): ``models.transformer.param_layouts`` over "model",
    and over "data" (or "vocab", data x model, under "dp") by the
    reference's ZeRO-1 rule where the reference ZeRO's them: a serving
    cell's params, an FSDP train cell's (:func:`lm_fsdp`); a train
    cell's optimizer state by ``sharding.opt_state_axes`` (AdamW's
    moments ZeRO-1'd, Adafactor's factored moments); the batch over the
    data axes; the decode cache by batch and K/V heads. A param stored
    split over data is all-gathered just in time (a block at a time,
    ``parallel.gather_param``) and its gradient reduce-scattered; a
    ZeRO-1'd moment's update runs on the rank's block of the param,
    which is then all-gathered (:class:`_MeshPlan`);
  * recsys cells: every table and sketch by "vocab" rows
    (``sharding.recsys_axes``), the rest replicated; the batch over the
    data axes; every lookup row-sharded (``models.recsys.row_lookup``);
  * the cf cell: tables and sketches by "vocab" rows, the edges over the
    batch axes (their block of the user-sorted edges), the BPR batch
    over the data axes (``models.lightgcn``);
  * GNN cells: params replicated, nodes and edges over the data axes
    (``models.schnet``).
The reference gives the recsys, cf and GNN families no data-axis layout
(their moments mirror their params). A batch splits over all the data
axes or none (the reference's ``fit_spec`` may split it over some of
them: ROADMAP Queue 3 #13). :func:`cell_layouts`, :func:`cell_args` and
:func:`arg_bytes` reckon any cell's layouts and argument bytes a rank at
the full published width on any mesh, an ``AbstractMesh`` too (the dry
run, ``launch.dryrun``); :func:`rank_bytes` a recsys, GNN or cf cell's
params, gradients and AdamW moments a rank.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.registry import ArchSpec, ShapeSpec, get_arch
from repro_torch.data.neighbor_sampler import (random_regular_csr,
                                               sample_subgraph)
from repro_torch.device import resolve_device
from repro_torch.distributed import parallel as par
from repro_torch.distributed import sharding as sh
from repro_torch.models import lightgcn as LG
from repro_torch.models import recsys as R
from repro_torch.models import schnet as S
from repro_torch.models import transformer as T
from repro_torch.training import optimizer as opt_lib

__all__ = ["Cell", "build_cell", "param_shapes", "cell_layouts", "cell_args",
           "arg_bytes", "rank_bytes", "lm_fsdp", "lm_acc_dtype",
           "lm_optimizer_name",
           "LM_ONE_CARD", "GNN_ONE_CARD"]


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    kind: str
    fn: Callable
    args: Tuple[Any, ...]
    donate: Tuple[int, ...] = ()
    notes: str = ""
    reduced: Tuple[str, ...] = ()    # cuts of a full-width cell
    mesh: Any = None                 # the cell's mesh (None: one device)
    layouts: Optional[dict] = None   # {"params": ..., "statics": ...} trees

    def gather(self, name: str, tree):
        """The whole of a tree this rank holds blocks of (``name``: a key
        of ``layouts``: "params", "cache", "statics" or "batch"), by
        all-gathers: every rank of the mesh calls it. Off a mesh, the
        tree itself."""
        if self.mesh is None:
            return tree
        return _map_layouts(lambda lay, t: lay.gather(t),
                            self.layouts[name], tree)

    def next_args(self, args: Tuple[Any, ...], out) -> Tuple[Any, ...]:
        """Thread one request's outputs into the next request's args.

        Decode cells return (logits, cache) and thread the cache (updated
        in place: the same tensors, the port's counterpart of the
        reference's donation); every other kind keeps its args
        (serve/retrieval/prefill cells are stateless between requests;
        the port's train step updates params and optimizer state in
        place)."""
        if self.kind == "decode" and self.donate:
            return (args[0], out[1]) + tuple(args[2:])
        return args


# ---------------------------------------------------------------------------
# inputs: (shape, dtype) specs, drawn as the reference draws them
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class _Spec:
    """The port's stand-in for a ShapeDtypeStruct: a batch leaf to draw.
    ``high`` is the exclusive bound of a full-width id draw, or a tuple of
    one bound per column."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    high: Any = None


def _materialize(batch: dict, device, seed: int = 0, rng=None) -> dict:
    """The reference's smoke draws (``repro/launch/steps.py:177-189``):
    ``np.random.default_rng(seed)`` over the spec leaves in
    ``jax.tree.map``'s order (the batch dict's keys sorted; params,
    optimizer state and statics are concrete and draw nothing): integers
    in {0, 1}, floats standard normal (cast to the spec's dtype). Pass
    ``rng`` to go on drawing from it (args of several spec dicts)."""
    rng = np.random.default_rng(seed) if rng is None else rng
    out = {}
    for key in sorted(batch):
        spec = batch[key]
        if spec.dtype.is_floating_point:
            a = rng.standard_normal(spec.shape).astype(np.float32)
            out[key] = torch.as_tensor(a, device=device).to(spec.dtype)
        else:
            a = np.asarray(rng.integers(0, 2, spec.shape), dtype=np.int32)
            out[key] = torch.as_tensor(a, device=device)
    return {k: out[k] for k in batch}


def _generator(device, seed: int = 0):
    """A seeded generator on ``device``; None on the meta device, where
    nothing is drawn (a reckoning's stand-in for the card)."""
    if torch.device(device).type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


def _full_batch(batch: dict, device, seed: int = 0) -> dict:
    """Full-width batches on the device: ids uniform in [0, high) (a
    field's vocabulary, a sequence's positions), floats standard normal,
    labels in {0, 1}; uninitialized tensors of those shapes and dtypes on
    the meta device."""
    if torch.device(device).type == "meta":
        return {k: torch.empty(spec.shape, device=device,
                               dtype=(torch.float32 if
                                      spec.dtype.is_floating_point
                                      else torch.int32))
                for k, spec in batch.items()}
    g = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for key, spec in batch.items():
        if spec.dtype.is_floating_point:
            out[key] = torch.randn(spec.shape, generator=g, device=device)
        elif isinstance(spec.high, tuple):     # one bound per column
            cols = [torch.randint(0, hi, spec.shape[:1], generator=g,
                                  device=device, dtype=torch.int32)
                    for hi in spec.high]
            out[key] = torch.stack(cols, dim=1)
        else:
            out[key] = torch.randint(0, spec.high, spec.shape, generator=g,
                                     device=device, dtype=torch.int32)
    return out


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------
# one H100's cuts of the full-width cells (80 GB; PERF.md §4), each
# reckoned from count_params (bf16), the cache and the decode's
# transients (an f32 copy of one layer's K, a bf16 copy of its V, gemma's
# tied head cast to f32) against 85% of the card: the batch
# (global_batch 32 / 128 otherwise), and the depth where the params
# alone pass it. qwen1.5-32b: 64 layers are 70.4 GB of params, its fp8
# cache 21.5 GB a row. gemma2-9b's train_4k keeps 8 of its 42 layers
# (four local/global pairs: 2.50e9 params at 16 bytes each with the f32
# accumulator and the two f32 AdamW moments) and 8 of its 256 sequences,
# one a microbatch as in the reference's 8 microbatches. long_500k: gemma3
# uncut (23.5 GB of params, 34.7 GB of cache, 10.5 GB of transients);
# gemma2-9b at 22 of 42 layers (its 21 global layers alone are 90 GB of
# cache). dbrx-132b: 6.52 GB a layer and 2.47 GB of embedding and head;
# decode at 8 layers and B 8 (K/V 134 MB a layer a row), prefill at 6
# (~12 GB of MoE transients at 32,768 tokens), train_4k at 1 layer (4.49e9
# params: params, the bf16 accumulator, one microbatch's gradients and
# the f32 AdamW moments are 62.8 GB). kimi-k2-1t-a32b: 34.06 GB a layer
# and 4.70 GB of embedding and head, so 1 layer; decode at B 64 (K/V
# 117 MB a row and its f32 K copy 117 MB). kimi's train_4k does not fit:
# one layer's params and gradients alone are 77.5 GB.
# gemma3-12b and qwen1.5-32b prefill_32k and train_4k, reckoned on meta
# tensors (``launch.dryrun.reckon``: arguments, outputs and the peak of
# the step's temporaries) against 72.26 GB (85% of the card's 85.02 GB):
# gemma3 prefill B 1 uncut: 23.53 GB of params, 2.48 of cache (8 global
# layers, 40 local windows), 13.89 of temporaries (its f32 residual
# stream, the tied head cast to f32) = 39.91. qwen prefill B 1 at the
# decode's 32 of 64 layers: 36.75 of params, 10.74 of fp8 cache, 20.60 of
# temporaries (a query chunk's 40 x 512 x 32,768 f32 scores) = 68.10; a
# layer more adds 1.72, so 34 would leave 0.72 GB. gemma3 train_4k at 6
# of 48 layers (one block of its 5:1 local:global pattern, the smallest
# cut ``n_blocks`` takes): 2.35e9 params, 1.01e9 of them the tied table,
# 4.70 GB in bf16, so the f32 accumulator: 23.52 of params and AdamW
# moments, 35.67 of temporaries (the accumulator, a microbatch's
# gradients, the table's f32 casts) = 59.18, and 4.03 more where a caller
# keeps the first lookup's table and gradient (chip_smoke); 12 layers
# reckon 84.10. qwen train_4k at 5 of 64 layers: 4.19e9 params, 1.56e9
# of them the untied embedding and head, 8.37 GB in bf16, so the bf16
# accumulator: 41.85 + 20.33 = 62.18 (+3.11 kept); 4 layers with the f32
# one 61.67, 6 layers 70.43 (+3.11). The card's peaks: PERF.md §4.
LM_ONE_CARD = {("gemma2-9b", "train_4k"): {"batch": 8, "n_layers": 8},
               ("gemma2-9b", "prefill_32k"): {"batch": 1},
               ("gemma2-9b", "decode_32k"): {"batch": 4},
               ("gemma2-9b", "long_500k"): {"batch": 1, "n_layers": 22},
               ("gemma3-12b", "train_4k"): {"batch": 8, "n_layers": 6},
               ("gemma3-12b", "prefill_32k"): {"batch": 1},
               ("gemma3-12b", "decode_32k"): {"batch": 8},
               ("gemma3-12b", "long_500k"): {"batch": 1},
               ("qwen1.5-32b", "train_4k"): {"batch": 8, "n_layers": 5},
               ("qwen1.5-32b", "prefill_32k"): {"batch": 1, "n_layers": 32},
               ("qwen1.5-32b", "decode_32k"): {"batch": 2, "n_layers": 32},
               ("dbrx-132b", "train_4k"): {"batch": 8, "n_layers": 1},
               ("dbrx-132b", "prefill_32k"): {"batch": 1, "n_layers": 6},
               ("dbrx-132b", "decode_32k"): {"batch": 8, "n_layers": 8},
               ("kimi-k2-1t-a32b", "prefill_32k"): {"batch": 1,
                                                    "n_layers": 1},
               ("kimi-k2-1t-a32b", "decode_32k"): {"batch": 64,
                                                   "n_layers": 1}}


def lm_fsdp(cfg, mesh=None, mapping: str = "tp") -> bool:
    """The reference's FSDP decision (``repro/launch/steps.py:234-239``):
    the config's bf16 params over the model shards pass 8e9 bytes, the
    model shards being the mesh's "model" size under "tp" and 1 under
    "dp" or with no mesh. An FSDP train cell stores its params split
    over "data" too and accumulates its gradients in bf16 (f32
    otherwise: :func:`lm_acc_dtype`)."""
    shards = (sh.mesh_shape(mesh).get("model", 1)
              if mesh is not None and mapping == "tp" else 1)
    return T.count_params(cfg) * 2 / max(shards, 1) > 8e9


def lm_acc_dtype(fsdp: bool) -> torch.dtype:
    """The gradient accumulator's dtype (``repro/launch/steps.py:266``)."""
    return torch.bfloat16 if fsdp else torch.float32


def lm_optimizer_name(cfg) -> str:
    """The reference's choice (``repro/launch/steps.py:194-198``):
    Adafactor for a MoE of 128 experts or more (kimi-k2's 384: full Adam
    moments would not fit), AdamW otherwise."""
    if cfg.moe is not None and cfg.moe.n_experts >= 128:
        return "adafactor"
    return "adamw"


def _lm_optimizer(cfg, plan=None):
    """(name, optimizer) of :func:`lm_optimizer_name`; on a mesh
    (``plan``, a :class:`_MeshPlan`) AdamW clips by the norm over every
    rank's blocks (:func:`mesh_norm`) and Adafactor's means sum over the
    groups that split their dims."""
    name = lm_optimizer_name(cfg)
    if name == "adafactor":
        return name, opt_lib.adafactor(
            lr=1e-2, reduce=None if plan is None else plan.factor_groups)
    norm = None if plan is None else mesh_norm(plan.mesh,
                                               plan.state_layouts)
    return name, opt_lib.adamw(lr=3e-4, grad_clip=1.0, norm=norm)


@dataclasses.dataclass
class _MeshPlan:
    """How a train step on a mesh reduces each gradient (by flat key) and
    updates each param:
      * ``grad_groups``: the group a gradient is all-reduced over after
        the backward (the batch's axes, less those a param stored split
        over data already summed by its gather's reduce-scatter; None:
        nothing);
      * ``zero1``: a param whose optimizer state is split over data axes
        where the param is not (the reference's ZeRO-1 moments), by the
        moment's ``Layout``, the dim and its group: the step updates the
        rank's block of the param and the gradient, then all-gathers the
        param over that group (reduce-scatter -> sharded update ->
        all-gather, with the reduce-scatter an all-reduce and a slice);
      * ``state_layouts``: the layout of the blocks the optimizer sees
        (its clip norm's);
      * ``factor_groups``: Adafactor's :class:`optimizer.FactorGroups`."""
    mesh: Any
    grad_groups: dict
    zero1: dict
    state_layouts: dict
    factor_groups: dict

    def block(self, key: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of a param or gradient the optimizer
        updates (a view)."""
        if key not in self.zero1:
            return t
        lay, dim, _ = self.zero1[key]
        start, length = lay._block(dim, t.shape[dim])
        return t.narrow(dim, start, length)

    def regather(self, key: str, p: torch.Tensor, block) -> None:
        """The param whole again from every rank's updated block."""
        if key in self.zero1:
            _, dim, group = self.zero1[key]
            if par.group_size(group) > 1:       # else the block is p
                p.copy_(par.all_gather_cat(block, group, dim))


class _LMTrainStep:
    """Loss and grads of every param (summed over ``n_micro`` equal
    microbatches in ``acc_dtype``, then divided), one update in place.
    On a mesh (``groups``, ``plan``) each rank runs its blocks and its
    batch rows: each gradient is summed over the data ranks as the plan
    says before the division (the loss's mean over them already divided
    each), and the optimizer updates the rank's blocks."""

    def __init__(self, cfg, opt, n_micro: int, acc_dtype, groups=None,
                 plan: Optional[_MeshPlan] = None, mapping: str = "tp"):
        self.cfg, self.opt, self.n_micro = cfg, opt, n_micro
        self.acc_dtype, self.groups, self.plan = acc_dtype, groups, plan
        self.mapping = mapping

    def value_and_grad(self, params, b):
        """(loss, {flat key: gradient}) of the step, before the update."""
        flat = R.flat_params(params)
        leaves = list(flat.values())
        for p in leaves:
            p.requires_grad_(True)
        n_micro, cfg = self.n_micro, self.cfg
        with par.use_groups(self.groups), sh.logical_mapping(self.mapping):
            if n_micro == 1:
                loss = T.train_loss(params, b, cfg)
                grads = list(torch.autograd.grad(loss, leaves))
            else:
                grads = [torch.zeros(p.shape, dtype=self.acc_dtype,
                                     device=p.device) for p in leaves]
                loss = torch.zeros((), dtype=torch.float32,
                                   device=leaves[0].device)
                for m in range(n_micro):
                    mb = {k: v.reshape(n_micro, v.shape[0] // n_micro,
                                       *v.shape[1:])[m]
                          for k, v in b.items()}
                    lm = T.train_loss(params, mb, cfg)
                    g = torch.autograd.grad(lm, leaves)
                    for a, x in zip(grads, g):
                        a.add_(x.to(self.acc_dtype))
                    del g
                    loss = loss + lm.detach()
        for p in leaves:
            p.requires_grad_(False)
        if self.plan is not None:
            for k, a in zip(flat, grads):
                par.all_reduce(a, self.plan.grad_groups[k])
        if n_micro > 1:
            grads = [a.div_(n_micro) for a in grads]
            loss = loss / n_micro
        return loss.detach(), dict(zip(flat, grads))

    def __call__(self, params, opt_state, b):
        loss, grads = self.value_and_grad(params, b)
        flat = R.flat_params(params)
        plan = self.plan
        if plan is None or not plan.zero1:
            self.opt.update(grads, opt_state, flat)
            return params, opt_state, loss
        blocks = {k: plan.block(k, p) for k, p in flat.items()}
        self.opt.update({k: plan.block(k, g) for k, g in grads.items()},
                        opt_state, blocks)
        for k, p in flat.items():
            plan.regather(k, p, blocks[k])
        return params, opt_state, loss


def mesh_norm(mesh, layouts: dict) -> Callable:
    """The global gradient norm over a mesh (a clip's): each leaf's sum
    of squares over this rank's block (``layouts``: flat key ->
    ``Layout`` of the block), summed over every mesh axis some leaf is
    split on, a leaf's squares taken once where it is replicated along
    an axis (kept at coordinate 0 only); then summed in sorted-key
    order, as ``optimizer.global_norm`` sums them (on one rank, the same
    value to the bit)."""
    names = tuple(mesh.mesh_dim_names)
    coord = dict(zip(names, mesh.get_coordinate()))
    split = {k: set(lay.axes) for k, lay in layouts.items()}
    axes = [a for a in names if any(a in s for s in split.values())]
    groups = [mesh.get_group(a) for a in axes]

    def norm(grads: dict) -> torch.Tensor:
        keys = sorted(grads)
        sq = torch.stack([torch.sum(grads[k].to(torch.float32, copy=True)
                                    .square_()) for k in keys])
        keep = [all(coord[a] == 0 for a in axes if a not in split[k])
                for k in keys]
        if not all(keep):
            sq = torch.where(torch.tensor(keep, device=sq.device), sq, 0)
        for g in groups:
            par.all_reduce(sq, g)
        return torch.sqrt(sum(sq.unbind()))
    return norm


def _map_layouts(fn, layouts, tree):
    """``fn(layout, leaf)`` over a tree of tensors (dicts and lists) and
    its tree of layouts (leaves without a layout pass through)."""
    if isinstance(tree, dict):
        return {k: _map_layouts(fn, layouts.get(k) if isinstance(
            layouts, dict) else None, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_layouts(fn, layouts[i] if isinstance(layouts, list)
                             else None, v) for i, v in enumerate(tree)]
    return tree if layouts is None else fn(layouts, tree)


def _cut(layouts, tree):
    """This rank's blocks of a tree of whole tensors (the tensors
    themselves where a leaf is whole)."""
    return _map_layouts(lambda lay, t: _own(t, lay.local_block(t)), layouts,
                        tree)


def _batch_layouts(mesh, batch: dict, groups, rows: int,
                   replicated=()) -> dict:
    """Each batch leaf's layout: split over the data axes when the cell's
    batch is (``groups``) and the leaf has the ``rows`` rows of that batch
    (not one of ``replicated``), else whole."""
    split = groups.data_group is not None
    return {k: sh.batch_layout(mesh, v.dim(), split and k not in replicated
                               and v.dim() > 0 and v.shape[0] == rows)
            for k, v in batch.items()}


def _mesh_notes(mesh, groups, what: str) -> tuple:
    return (f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}",
            f"data={groups.n_data}: batch rows", what)


def _own(full: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """A block as a tensor of its own (the tensor itself when whole)."""
    return full if block.shape == full.shape else block.clone()


def _local_rows(x: torch.Tensor, groups, n_micro: int = 1) -> torch.Tensor:
    """This data rank's rows of a batch leaf: of each of the ``n_micro``
    microbatches, its equal share, in order (the rows a data shard of
    the reference's microbatch holds)."""
    if groups is None or groups.data_group is None or x.dim() == 0:
        return x
    b = x.shape[0]
    mb = b // n_micro
    if b % n_micro or mb % groups.n_data:
        raise ValueError(f"a batch of {b} in {n_micro} microbatches does "
                         f"not split over {groups.n_data} data ranks")
    per = mb // groups.n_data
    rows = (torch.arange(n_micro)[:, None] * mb + groups.data_rank * per
            + torch.arange(per)).reshape(-1)
    return x.index_select(0, rows.to(x.device))


def _flat(tree, prefix: str = "") -> dict:
    """{"a/b": leaf} of a nested dict whose leaves may be tuples (logical
    axes, shapes)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _lm_layouts(cfg, mesh, kind: str, b: int, seq: int, mapping: str,
                reference: bool = False) -> dict:
    """An LM cell's layouts on ``mesh`` (an ``AbstractMesh`` too), under
    the logical ``mapping`` (the caller enters it): "params" (ZeRO'd over
    "data", or "vocab" under "dp", for a serving cell or an FSDP train
    cell: ``repro/launch/steps.py:234-254``), a train cell's "opt" (its
    optimizer state: :func:`sharding.opt_state_axes`), "batch", and a
    decode cell's "cache" (the port's head-sharded one,
    ``transformer.cache_layouts``); "info": the FSDP decision, whether
    the params are ZeRO'd, the tag, the optimizer. ``reference``: the
    reference's own layouts, without the port's (wk/wv whole over a model
    axis their K/V heads do not divide; the cache head-sharded) and
    without its check that the model axis divides the heads."""
    tag = "data" if mapping == "tp" else "vocab"
    fsdp = lm_fsdp(cfg, mesh, mapping)
    zero = kind != "train" or fsdp
    out = {"params": T.param_layouts(cfg, mesh, zero, tag, reference),
           "info": {"fsdp": fsdp, "zero": zero, "tag": tag}}
    split = bool(par.data_axes(mesh, b))
    if kind == "train":
        shapes = _flat(T.param_shapes(cfg))
        name = lm_optimizer_name(cfg)
        st = sh.opt_state_axes(name, _flat(T.param_axes(cfg, zero, tag)),
                               shapes, tag)

        def lay(key, axes, shape):
            return T.leaf_layout(cfg, mesh, key.split("/")[-1], axes, shape,
                                 reference)
        step = sh.Layout(mesh, ())
        if name == "adamw":
            m = {k: lay(k, st["m"][k], shapes[k]) for k in shapes}
            out["opt"] = {"step": step, "m": m, "v": dict(m)}
        else:
            fac = []
            for k, f in zip(sorted(shapes), st["fac"]):
                shp = shapes[k]
                fac.append({"vr": lay(k, f["vr"], shp[:-1]),
                            "vc": lay(k, f["vc"], shp[:-2] + shp[-1:])}
                           if len(shp) >= 2 else {"v": lay(k, f["v"], shp)})
            out["opt"] = {"step": step, "fac": fac}
        out["info"]["optimizer"] = name
        out["batch"] = {k: sh.batch_layout(mesh, 2, split)
                        for k in ("tokens", "targets")}
    elif kind == "prefill":
        out["batch"] = {"tokens": sh.batch_layout(mesh, 2, split)}
    else:
        out["batch"] = {"tokens": sh.batch_layout(mesh, 2, split),
                        "pos": sh.Layout(mesh, ())}
        out["cache"] = (T.reference_cache_layouts(cfg, mesh, b, seq)
                        if reference else T.cache_layouts(cfg, mesh, b))
    return out


def _nest(flat: dict) -> dict:
    out = {}
    for key, v in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _split_dim(lay, axes: set) -> Optional[int]:
    """The dim of a layout split over any of ``axes`` (None: none; the
    ZeRO-1 rule tags one dim)."""
    return next((i for i, part in enumerate(lay.spec)
                 if set(sh._entry_axes(part)) & axes), None)


def _ordered(mesh, axes) -> tuple:
    return tuple(a for a in mesh.mesh_dim_names if a in axes)


def _mesh_plan(mesh, layouts: dict, groups, b: int):
    """({flat key: ``parallel.ParamSplit``} of the params stored split
    over data axes, the train step's :class:`_MeshPlan` or None)."""
    model = {"model"} if groups.model_group is not None else set()
    batch = par.data_axes(mesh, b)
    params = R.flat_params(layouts["params"])
    splits, grad_groups = {}, {}
    for k, lay in params.items():
        data = set(lay.axes) - model
        dim = _split_dim(lay, data)
        if dim is None:
            grad_groups[k] = groups.data_group
            continue
        # the batch spans every data axis or none, so a split's axes are
        # all batch axes (its cotangents partial over them) or none are
        gather = tuple(a for a in sh._entry_axes(lay.spec[dim])
                       if a not in model)
        splits[k] = par.ParamSplit(dim, par.axes_group(mesh, gather),
                                   bool(batch))
        grad_groups[k] = par.axes_group(mesh, tuple(
            a for a in batch if a not in gather))
    if "opt" not in layouts:
        return splits, None
    opt = layouts["opt"]
    zero1, factor = {}, {}
    if "m" in opt:
        state = R.flat_params(opt["m"])
        for k, m in state.items():
            # ZeRO-1 tags one dim the param leaves whole
            dim = next((i for i, (a, c) in enumerate(zip(params[k].spec,
                                                         m.spec)) if a != c),
                       None)
            if dim is not None:
                zero1[k] = (m, dim, par.axes_group(
                    mesh, sh._entry_axes(m.spec[dim])))
    else:
        state = params

        def grp(part):
            return par.axes_group(mesh, sh._entry_axes(part))
        for k, lay in params.items():
            spec = lay.spec
            factor[k] = opt_lib.FactorGroups(
                grp(spec[-1]), grp(spec[-2]) if len(spec) >= 2 else None,
                par.axes_group(mesh, _ordered(mesh, lay.axes)))
    return splits, _MeshPlan(mesh, grad_groups, zero1, state, factor)


def _lm_cell(spec: ArchSpec, shape: ShapeSpec, smoke: bool, lookup_backend,
             device, mesh=None, args=None, batch: Optional[int] = None,
             n_layers: Optional[int] = None) -> Cell:
    cfg = spec.smoke_config() if smoke else spec.full_config()
    if lookup_backend is not None:
        cfg = dataclasses.replace(cfg, lookup_backend=lookup_backend)
    dims = shape.dims
    if smoke:
        seq = {"train": 16, "prefill": 16, "decode": 32}.get(shape.kind, 16)
        b = 4
    else:
        seq, b = dims["seq_len"], dims["global_batch"]
    reduced = []
    if batch is not None and batch != b:
        reduced.append(f"global_batch {b} -> {batch}")
        b = batch
    if n_layers is not None and n_layers != cfg.n_layers:
        reduced.append(f"n_layers {cfg.n_layers} -> {n_layers}")
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    mapping = dims.get("mapping", "tp")
    with sh.logical_mapping(mapping):
        return _lm_cell_inner(spec, shape, smoke, device, mesh, args, cfg,
                              seq, b, tuple(reduced), mapping)


def _lm_cell_inner(spec, shape, smoke, device, mesh, args, cfg, seq, b,
                   reduced, mapping) -> Cell:
    dims = shape.dims
    groups = layouts = plan = None
    notes = ()
    fsdp = lm_fsdp(cfg, mesh, mapping)
    if mesh is not None:
        with par.use_groups(None):
            groups = par.rank_groups(mesh, b)
        layouts = _lm_layouts(cfg, mesh, shape.kind, b, seq, mapping)
        info = layouts.pop("info")
        splits, plan = _mesh_plan(mesh, layouts, groups, b)
        groups = dataclasses.replace(groups, params=splits)
        over = "every axis" if mapping == "dp" else "data"
        notes = (f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}",
                 f"mapping={mapping}",
                 f"model={groups.n_model}: heads, d_ff, experts and "
                 f"vocabulary rows", f"data={groups.n_data}: batch rows",
                 (f"params ZeRO'd over {over} (FSDP)" if fsdp else
                  f"params ZeRO'd over {over}" if info["zero"] else
                  f"params replicated over {over}"),
                 f"fsdp={fsdp}", f"data_split={len(splits)}")
    gen = None if args is not None else _generator(device)
    on_meta = {} if gen is not None else {"device": device}
    if args is None and layouts is None:
        params = T.init_params(gen, cfg, **on_meta)
    elif args is None:
        params = T.init_params(gen, cfg, layouts=layouts["params"],
                               **on_meta)
    else:
        params = _cut(layouts["params"], args[0])
    i32 = torch.int32
    tok = lambda shp: _Spec(shp, i32, cfg.vocab_size)  # noqa: E731
    cell = functools.partial(Cell, spec.arch_id, shape.name, shape.kind,
                             reduced=reduced, mesh=mesh, layouts=layouts)

    def local_batch(specs, n_micro=1):
        bt = _draw_batch(specs, smoke, device) if args is None else args[-1]
        return {k: _local_rows(v, groups, n_micro) for k, v in bt.items()}

    if shape.kind == "train":
        # gradient accumulation (the reference's rule), in f32, or bf16
        # where the params are FSDP-sharded (lm_fsdp). The rule reads the
        # config after a depth cut, so the cut moves it: gemma2-9b at 8
        # layers (5.0e9 bytes) accumulates in f32
        n_micro = dims.get("microbatches") or (
            8 if not smoke and shape.name == "train_4k" else 1)
        opt_name, opt = _lm_optimizer(cfg, plan)
        flat = R.flat_params(params)
        opt_state = opt.init(flat if plan is None else
                             {k: plan.block(k, p) for k, p in flat.items()})
        if plan is not None and plan.zero1:
            notes += (f"moments ZeRO-1 over {over}: {len(plan.zero1)} "
                      f"leaves",)
        bt = local_batch({"tokens": tok((b, seq)),
                          "targets": tok((b, seq))}, n_micro)
        acc = lm_acc_dtype(fsdp)
        return cell(_LMTrainStep(cfg, opt, n_micro, acc, groups, plan,
                                 mapping),
                    (params, opt_state, bt), donate=(0, 1),
                    notes=",".join((f"optimizer={opt_name}",
                                    f"microbatches={n_micro}",
                                    "accumulator="
                                    f"{str(acc).split('.')[-1]}") + notes))

    if shape.kind == "prefill":
        bt = local_batch({"tokens": tok((b, seq))})

        @torch.inference_mode()
        def prefill_step(params, b):
            with par.use_groups(groups), sh.logical_mapping(mapping):
                return T.prefill(params, b, cfg, max_seq=seq)

        if layouts is not None:
            layouts["cache"] = T.cache_layouts(cfg, mesh, b)
        return cell(prefill_step, (params, bt), notes=",".join(notes))

    # decode: KV cache as input, one new token at pos
    batch_specs = {"tokens": tok((b, 1)), "pos": _Spec((), i32)}
    if args is not None:
        cache, bt = args[1], args[2]
    elif smoke:
        meta = T.init_cache(cfg, b, seq, device="meta")
        rng = np.random.default_rng(0)
        cache = _materialize({k: _Spec(tuple(v.shape), v.dtype)
                              for k, v in meta.items()}, device, rng=rng)
        bt = _materialize(batch_specs, device, rng=rng)
    else:
        cache = T.init_cache(cfg, b, seq, device=device, generator=gen)
        bt = {"tokens": _full_batch({"tokens": batch_specs["tokens"]},
                                    device)["tokens"],
              "pos": torch.tensor(seq - 1, dtype=i32, device=device)}
    if layouts is not None:
        cache = _cut(layouts["cache"], cache)
        bt = {k: _local_rows(v, groups) for k, v in bt.items()}
        notes += ("KV cache by batch rows and K/V heads (the reference's "
                  "is sequence-sharded over model: the same numbers)",)

    @torch.inference_mode()
    def decode(params, cache, b):
        with par.use_groups(groups), sh.logical_mapping(mapping):
            return T.decode_step(params, cache, b, cfg)

    return cell(decode, (params, cache, bt), donate=(1,),
                notes=",".join(("KV cache updated in place",) + notes))


# ---------------------------------------------------------------------------
# GNN family (schnet)
# ---------------------------------------------------------------------------
# one H100's cut: ogb_products' 61,859,140 edges would need ~370 GB (its
# [E, 300] f32 radial basis alone is 74.2 GB); 1/8 of them fit (PERF.md §4)
GNN_ONE_CARD = {("schnet", "ogb_products"): {"n_edges": 61_859_140 // 8}}
# the minibatch_lg cell's graph, Reddit's size (232,965 nodes, 114.6M
# edges: mean degree 492), sampled from 1,024 seeds at fanout (15, 10)
GNN_SAMPLED_GRAPH = {"n_nodes": 232_965, "avg_deg": 492}
# QM9's elements (H, C, N, O, F) for the molecule cell's atoms
GNN_ELEMENTS = (1, 6, 7, 8, 9)


def _gnn_batch(shape_name: str, dims: dict, n: int, e: int, d_feat: int,
               cfg, device) -> Tuple[dict, Tuple[str, ...]]:
    """A full-width batch, drawn on the host from ``default_rng(0)``:
    ``n`` / ``e`` are the padded node and edge counts. Edge distances are
    uniform in [0, 1.2 x cutoff), so some edges lie past the cutoff and
    carry nothing; pad edges (``e`` past the real count) join node 0 to
    itself at 2 x cutoff. Node features and targets are standard normal;
    ``node_mask`` is 1 on the real nodes (``minibatch_lg``: on the 1,024
    seeds, the nodes the sampled batch trains) and 0 on pad nodes.
    ``molecule``: 128 graphs of 30 atoms of QM9's elements, each graph's
    edges within it. Returns the batch and its notes."""
    rng = np.random.default_rng(0)
    i32, f32 = np.int32, np.float32
    src = np.zeros(e, i32)
    dst = np.zeros(e, i32)
    dist = np.full(e, 2.0 * cfg.cutoff, f32)
    notes = ()
    if shape_name == "molecule":
        g, atoms, per = dims["batch"], dims["n_nodes"], dims["n_edges"]
        base = np.repeat(np.arange(g) * atoms, per)
        src[:g * per] = base + rng.integers(0, atoms, g * per)
        dst[:g * per] = base + rng.integers(0, atoms, g * per)
        dist[:g * per] = rng.uniform(0.0, 1.2 * cfg.cutoff, g * per)
        if n != g * atoms:       # a pad atom would join some graph
            raise ValueError(f"molecule: {g} graphs of {atoms} atoms pad "
                             f"to {n} nodes")
        z = rng.choice(GNN_ELEMENTS, n).astype(i32)
        gid = (np.arange(n) // atoms).astype(i32)
        b = {"edge_src": src, "edge_dst": dst, "edge_dist": dist, "z": z,
             "graph_id": gid,
             "targets": rng.standard_normal(g).astype(f32)}
    else:
        mask = np.zeros(n, f32)
        if shape_name == "minibatch_lg":
            graph = GNN_SAMPLED_GRAPH
            indptr, indices = random_regular_csr(graph["n_nodes"],
                                                 graph["avg_deg"], seed=0)
            seeds = rng.choice(graph["n_nodes"], dims["batch_nodes"],
                               replace=False)
            nodes, s_l, d_l = sample_subgraph(indptr, indices, seeds,
                                              dims["fanout"], seed=0)
            n_real, e_real = len(nodes), len(s_l)
            mask[:len(seeds)] = 1.0
            notes = (f"sampled {n_real} nodes, {e_real} edges from "
                     f"{graph['n_nodes']} nodes at mean degree "
                     f"{graph['avg_deg']}",)
        else:
            n_real, e_real = dims["n_nodes"], min(e, dims["n_edges"])
            s_l = rng.integers(0, n_real, e_real)
            d_l = rng.integers(0, n_real, e_real)
            mask[:n_real] = 1.0
        src[:e_real], dst[:e_real] = s_l, d_l
        dist[:e_real] = rng.uniform(0.0, 1.2 * cfg.cutoff, e_real)
        b = {"edge_src": src, "edge_dst": dst, "edge_dist": dist,
             "feat": rng.standard_normal((n, d_feat), dtype=f32),
             "node_targets": rng.standard_normal(n, dtype=f32),
             "node_mask": mask}
    return {k: torch.as_tensor(v, device=device) for k, v in b.items()}, notes


def _gnn_cfg_dims(spec: ArchSpec, shape: ShapeSpec, smoke: bool,
                  lookup_backend, n_edges: Optional[int] = None):
    """(cfg, dims, n, e, reduced) of a GNN cell: the config with the
    shape's d_feat, the shape's dims (smoke: the reference's smoke scale),
    the node and edge counts (full width: padded to the pod width) and
    the cuts."""
    base = spec.smoke_config() if smoke else spec.full_config()
    if lookup_backend is not None:
        base = dataclasses.replace(base, lookup_backend=lookup_backend)
    dims = dict(shape.dims)
    if smoke:
        scale = {"full_graph_sm": (64, 256), "minibatch_lg": (128, 512),
                 "ogb_products": (128, 512), "molecule": (30, 64)}
        dims["n_nodes"], dims["n_edges"] = scale[shape.name]
        dims["batch"] = 4
        if "d_feat" in dims:
            dims["d_feat"] = 16
    reduced = []
    if n_edges is not None and n_edges != dims["n_edges"]:
        reduced.append(f"n_edges {dims['n_edges']} -> {n_edges}")
        dims["n_edges"] = n_edges

    molecule = shape.name == "molecule"
    d_feat = 0 if molecule else dims["d_feat"]
    cfg = dataclasses.replace(base, d_feat=d_feat)
    if molecule:
        n_graphs = dims["batch"]
        n = dims["n_nodes"] * n_graphs
        e = dims["n_edges"] * n_graphs
    else:
        n, e = dims["n_nodes"], dims["n_edges"]
    if not smoke:
        # the reference pads node and edge counts to the pod width so its
        # row sharding divides; the port keeps the padded shapes (pad
        # nodes masked out, pad edges past the cutoff: zero contribution)
        n = R.pad_rows(n)
        e = R.pad_rows(e)
    return cfg, dims, n, e, tuple(reduced)


def _gnn_specs(shape_name: str, dims: dict, n: int, e: int,
               d_feat: int) -> dict:
    """The batch specs of a GNN cell (the reference's, in its order)."""
    i32, f32 = torch.int32, torch.float32
    specs = {"edge_src": _Spec((e,), i32), "edge_dst": _Spec((e,), i32),
             "edge_dist": _Spec((e,), f32)}
    if shape_name == "molecule":
        specs["z"] = _Spec((n,), i32)
        specs["graph_id"] = _Spec((n,), i32)
        specs["targets"] = _Spec((dims["batch"],), f32)
    else:
        specs["feat"] = _Spec((n, d_feat), f32)
        specs["node_targets"] = _Spec((n,), f32)
        specs["node_mask"] = _Spec((n,), f32)
    return specs


def _gnn_cell(spec: ArchSpec, shape: ShapeSpec, smoke: bool, lookup_backend,
              device, n_edges: Optional[int] = None, mesh=None,
              args=None) -> Cell:
    cfg, dims, n, e, reduced = _gnn_cfg_dims(spec, shape, smoke,
                                             lookup_backend, n_edges)
    molecule = shape.name == "molecule"
    d_feat = cfg.d_feat
    opt = opt_lib.adamw(lr=1e-3)
    specs = _gnn_specs(shape.name, dims, n, e, d_feat)
    loss = S.train_loss if molecule else S.node_train_loss
    notes = ()
    if args is not None:
        params, b = args[0], args[-1]
    else:
        params = S.init_params(
            torch.Generator(device=device).manual_seed(0), cfg)
        if smoke:
            b = _materialize(specs, device)
        else:
            b, notes = _gnn_batch(shape.name, dims, n, e, d_feat, cfg,
                                  device)
            b = {k: b[k] for k in specs}
    groups = layouts = None
    if mesh is not None:
        # nodes, edges and graphs split over the data axes when every
        # count divides them, else every rank holds the whole batch
        groups = par.rank_groups(mesh, math.gcd(*(v.shape[0]
                                                  for v in b.values())))
        split = groups.data_group is not None
        layouts = dict(_family_layouts("gnn", mesh, params),
                       batch={k: sh.batch_layout(mesh, v.dim(), split)
                              for k, v in b.items()})
        params, b = _cut(layouts["params"], params), _cut(layouts["batch"], b)
        notes += _mesh_notes(mesh, groups, "params replicated; nodes and "
                             "edges by data rank")
    opt_state = opt.init(R.flat_params(params))
    step = _adamw_step(lambda p, s, bb: loss(p, bb, cfg), opt,
                       unread=("embed",) if d_feat else (), groups=groups,
                       reduce=tuple(R.flat_params(params)))

    def train_step(params, opt_state, batch):
        return step(params, opt_state, None, batch)

    train_step.value_and_grad = lambda p, bb: step.value_and_grad(p, None, bb)
    return Cell(spec.arch_id, shape.name, "train", train_step,
                (params, opt_state, b), donate=(0, 1),
                notes=",".join(notes), reduced=reduced, mesh=mesh,
                layouts=layouts)


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------
def _recsys_init(cfg):
    if isinstance(cfg, R.SASRecConfig):
        return R.seqrec_init
    if isinstance(cfg, R.DLRMConfig):
        return R.dlrm_init
    return R.widedeep_init


def param_shapes(cfg) -> dict:
    """{path: shape} of a recsys config's params, reckoned on the meta
    device (nothing allocated)."""
    meta = _recsys_init(cfg)(None, cfg, device="meta")
    return {k: tuple(v.shape) for k, v in R.flat_params(meta).items()}


def _recsys_statics(cfg, device):
    """Sketch index arrays of the compressed fields (frozen BACO
    artifacts), drawn as the reference's smoke rule draws them
    (``repro/launch/steps.py:441-452``): one ``np.random.default_rng(0)``
    over the statics in insertion order, each entry uniform over its
    codebook's rows. The port draws them so at full width too."""
    rng = np.random.default_rng(0)
    return {k: torch.as_tensor(rng.integers(0, hi, shape).astype(np.int32),
                               device=device)
            for k, (shape, hi) in _recsys_statics_shapes(cfg).items()}


def _recsys_statics_shapes(cfg) -> dict:
    """{key: (shape, codebook rows)} of a recsys config's sketches."""
    shapes = {}
    if isinstance(cfg, (R.DLRMConfig, R.WideDeepConfig)):
        for f in cfg.compressed_fields():
            shapes[f"sketch_{f}"] = ((R.pad_rows(cfg.vocabs[f]), 1),
                                     cfg.table_rows(f))
    elif getattr(cfg, "etc_ratio", None) is not None:
        shapes["sketch_items"] = ((R.pad_rows(cfg.n_items), 1),
                                  cfg.table_rows)
    return shapes


def _recsys_batch(cfg, shape: ShapeSpec, dims: dict) -> dict:
    """The batch specs of a recsys cell (the reference's ``mk_batch``),
    with each id leaf's full-width bound."""
    batch = dims["batch"]
    i32 = torch.int32
    if isinstance(cfg, R.SASRecConfig):
        seq = _Spec((batch, cfg.seq_len), i32, cfg.n_items)
        nc = (dims.get("n_candidates", 100) if shape.kind == "retrieval"
              else 100)
        if isinstance(cfg, R.BERT4RecConfig):
            if shape.kind == "train":
                return {"seq": seq,
                        "target_pos": _Spec((batch, cfg.n_mask), i32,
                                            cfg.seq_len),
                        "target_ids": _Spec((batch, cfg.n_mask), i32,
                                            cfg.n_items),
                        "neg_ids": _Spec((cfg.n_neg,), i32, cfg.n_items)}
            return {"seq": seq,
                    "target_pos": _Spec((batch,), i32, cfg.seq_len),
                    "candidates": _Spec((batch, nc), i32, cfg.n_items)}
        if shape.kind == "train":
            return {"seq": seq,
                    "neg": _Spec((batch, cfg.seq_len - 1), i32, cfg.n_items)}
        return {"seq": seq,
                "candidates": _Spec((batch, nc), i32, cfg.n_items)}
    b = {}
    if isinstance(cfg, R.DLRMConfig):
        b["dense"] = _Spec((batch, cfg.n_dense), torch.float32)
    b["sparse"] = _Spec((batch, cfg.n_sparse), i32, tuple(cfg.vocabs))
    if shape.kind == "train":
        b["label"] = _Spec((batch,), torch.float32)
    if shape.kind == "retrieval":
        b["candidates"] = _Spec((dims["n_candidates"],), i32, cfg.vocabs[0])
    return b


def _draw_batch(specs: dict, smoke: bool, device) -> dict:
    if smoke:
        return _materialize(specs, device)
    batch = _full_batch(specs, device)
    if "label" in batch:                     # labels in {0, 1}
        batch["label"] = (batch["label"] > 0).float()
    return batch


def _adamw_step(loss_fn, opt, unread: Tuple[str, ...] = (), groups=None,
                reduce: Tuple[str, ...] = ()):
    """The reference's train step: loss and grads of every param, one
    AdamW update (in place on the params and the optimizer state). The
    params named in ``unread`` are ones the loss does not read (SchNet's
    atom embedding under dense features): their gradient is zero, as
    under jax.grad. Any other param the loss does not read raises.

    On a mesh (``groups``) the loss runs under ``par.use_groups``, and
    the gradients of the params named in ``reduce`` (each data rank's
    share of the batch's: the replicated params) are summed over the
    data ranks; the others' (a row-sharded table's) are whole already.
    The step's ``value_and_grad(params, statics, b)`` gives (loss,
    {flat key: gradient}) before the update."""
    def value_and_grad(params, statics, b):
        flat = R.flat_params(params)
        read = [k for k in flat if k not in unread]
        for k in read:
            flat[k].requires_grad_(True)
        with par.use_groups(groups):
            loss = loss_fn(params, statics, b)
        grads = dict(zip(read, torch.autograd.grad(
            loss, [flat[k] for k in read])))
        for k in read:
            flat[k].requires_grad_(False)
        grads = {k: grads[k] if k in grads else torch.zeros_like(p)
                 for k, p in flat.items()}
        if groups is not None and groups.data_group is not None:
            for k in reduce:
                par.all_reduce(grads[k], groups.data_group)
        return loss.detach(), grads

    def train_step(params, opt_state, statics, b):
        loss, grads = value_and_grad(params, statics, b)
        opt.update(grads, opt_state, R.flat_params(params))
        return params, opt_state, loss

    train_step.value_and_grad = value_and_grad
    return train_step


def _recsys_cell(spec: ArchSpec, shape: ShapeSpec, smoke: bool,
                 lookup_backend, device, mesh=None, args=None) -> Cell:
    cfg = spec.smoke_config() if smoke else spec.full_config()
    if lookup_backend is not None:
        cfg = dataclasses.replace(cfg, lookup_backend=lookup_backend)
    dims = dict(shape.dims)
    if smoke:
        dims["batch"] = 1 if shape.kind == "retrieval" else 8
        dims["n_candidates"] = 64
    is_seq = isinstance(cfg, R.SASRecConfig)
    is_bert = isinstance(cfg, R.BERT4RecConfig)
    if args is not None:
        params, statics, batch = args[0], args[-2], args[-1]
    else:
        statics = _recsys_statics(cfg, device)
        params = _recsys_init(cfg)(_generator(device), cfg, device=device)
        batch = _draw_batch(_recsys_batch(cfg, shape, dims), smoke, device)
    groups = layouts = None
    notes = ()
    if mesh is not None:
        # the rows the batch splits into: DLRM's and Wide&Deep's retrieval
        # scores candidates of one context, the rest batches of contexts
        rows = (dims["n_candidates"] if shape.kind == "retrieval"
                and not is_seq else dims["batch"])
        groups = par.rank_groups(mesh, rows)
        layouts = dict(_family_layouts("recsys", mesh, params, statics),
                       batch=_batch_layouts(mesh, batch, groups, rows,
                                            replicated=("neg_ids",)))
        blocks = {k: par.row_block(lay, params[k].shape[0])
                  for k, lay in layouts["params"].items() if sh.is_table(k)}
        blocks.update({k: par.row_block(lay, statics[k].shape[0])
                       for k, lay in layouts["statics"].items()})
        groups = dataclasses.replace(groups, rows=blocks)
        params, statics, batch = (_cut(layouts[k], t) for k, t in (
            ("params", params), ("statics", statics), ("batch", batch)))
        notes = _mesh_notes(mesh, groups, "vocab rows: every table and "
                            "sketch; the MLPs and attention replicated")
    notes = ",".join(notes)
    cell = functools.partial(Cell, spec.arch_id, shape.name, shape.kind,
                             mesh=mesh, layouts=layouts, notes=notes)

    if shape.kind == "train":
        opt = opt_lib.adamw(lr=1e-3)
        opt_state = opt.init(R.flat_params(params))
        if is_bert:
            loss = R.bert4rec_train_loss
        elif is_seq:
            loss = R.sasrec_train_loss
        elif isinstance(cfg, R.DLRMConfig):
            loss = R.dlrm_train_loss
        else:
            loss = R.widedeep_train_loss
        dense = tuple(k for k in R.flat_params(params)
                      if not sh.is_table(k))
        step = _adamw_step(lambda p, s, b: loss(p, s, b, cfg), opt,
                           groups=groups, reduce=dense)
        return cell(step, (params, opt_state, statics, batch), donate=(0, 1))

    # serve / retrieval
    if is_bert:
        fwd = R.bert4rec_score_candidates
    elif is_seq:
        fwd = R.sasrec_score_candidates
    elif isinstance(cfg, R.DLRMConfig):
        fwd = (R.dlrm_retrieval if shape.kind == "retrieval"
               else R.dlrm_forward)
    else:
        fwd = (R.widedeep_retrieval if shape.kind == "retrieval"
               else R.widedeep_forward)

    @torch.no_grad()
    def serve_step(params, statics, b):
        if groups is None:
            return fwd(params, statics, b, cfg)
        with par.use_groups(groups):    # the scores of the whole batch
            return par.gather_over_data(fwd(params, statics, b, cfg), groups)

    return cell(serve_step, (params, statics, batch))


# ---------------------------------------------------------------------------
# CF family (the paper's LightGCN pipeline)
# ---------------------------------------------------------------------------
def _cf_statics(cfg, device) -> dict:
    """The reference's cf statics (``repro/launch/steps.py:615-628``):
    one ``np.random.default_rng(0)`` draws the five statics in insertion
    order (ints in {0, 1}, edge_norm uniform [0, 1)), then redraws the
    sketches within their codebooks and the edges within the graph. The
    port then sorts the edges by user (stably) into its sorted-edge
    statics (``models.lightgcn.sorted_edge_statics``): the propagation
    sums the same edges. Full width draws the same way."""
    nu, nv = cfg.n_users, cfg.n_items
    e = max(4 * (nu + nv), 1024)
    rng = np.random.default_rng(0)
    drawn = {"edge_u": rng.integers(0, 2, (e,)),
             "edge_v": rng.integers(0, 2, (e,)),
             "edge_norm": rng.random((e,)).astype(np.float32)}
    if cfg.k_users is not None:
        drawn["sketch_u"] = rng.integers(0, 2, (nu, cfg.n_hot_users))
        drawn["sketch_v"] = rng.integers(0, 2, (nv, 1))
        drawn["sketch_u"] = rng.integers(0, cfg.k_users,
                                         (nu, cfg.n_hot_users))
        drawn["sketch_v"] = rng.integers(0, cfg.k_items, (nv, 1))
    drawn["edge_u"] = rng.integers(0, nu, e)
    drawn["edge_v"] = rng.integers(0, nv, e)
    order = np.argsort(drawn["edge_u"], kind="stable")
    statics = LG.sorted_edge_statics(
        drawn["edge_u"][order], drawn["edge_v"][order],
        drawn["edge_norm"][order], nu, nv, device=device)
    for k in ("sketch_u", "sketch_v"):
        if k in drawn:
            statics[k] = torch.as_tensor(drawn[k].astype(np.int32),
                                         device=device)
    return statics


_CF_EDGES = ("edge_u", "edge_v", "edge_norm")


def _cf_cut(statics: dict, layouts: dict, cfg) -> dict:
    """This rank's cf statics: its blocks of the sketches, and the
    sorted-edge statics of its block of the (user-sorted) edges, rebuilt
    on the host (the unsharded statics themselves when the block is all
    of them; on the meta device, statics of the block's shapes)."""
    cut = _cut(layouts, {k: statics[k] for k in layouts})
    out = dict(statics)
    out.update({k: cut[k] for k in layouts if k not in _CF_EDGES})
    if cut["edge_u"].shape == statics["edge_u"].shape:
        return out
    if cut["edge_u"].device.type == "meta":       # a reckoning: shapes only
        out.update(LG.edge_statics_like(cut["edge_u"].shape[0], cfg.n_users,
                                        cfg.n_items))
    else:
        edges = [cut[k].cpu().numpy() for k in _CF_EDGES]
        out.update(LG.sorted_edge_statics(*edges, cfg.n_users, cfg.n_items,
                                          device=statics["edge_u"].device))
    return out


def _cf_cell(spec: ArchSpec, shape: ShapeSpec, smoke: bool, lookup_backend,
             device, mesh=None, args=None) -> Cell:
    cfg = spec.smoke_config() if smoke else spec.full_config()
    if lookup_backend is not None:
        cfg = dataclasses.replace(cfg, lookup_backend=lookup_backend)
    batch = 8 if smoke else shape.dims["batch"]
    if args is not None:
        params, statics, b = args[0], args[-2], args[-1]
    else:
        params = {k: torch.as_tensor(v, device=device)
                  for k, v in LG.init_params(0, cfg).items()}
        statics = _cf_statics(cfg, device)
        specs = {"user": _Spec((batch,), torch.int32, cfg.n_users),
                 "pos": _Spec((batch,), torch.int32, cfg.n_items),
                 "neg": _Spec((batch,), torch.int32, cfg.n_items)}
        b = _draw_batch(specs, smoke, device)
    groups = layouts = None
    notes = ()
    if mesh is not None:
        groups = par.rank_groups(mesh, batch)
        layouts = dict(_family_layouts("cf", mesh, params, statics),
                       batch=_batch_layouts(mesh, b, groups, batch))
        blocks = {k: par.row_block(lay, t.shape[0]) for k, lay, t in (
            [(k, layouts["params"][k], params[k]) for k in params]
            + [(k, lay, statics[k]) for k, lay in layouts["statics"].items()
               if k not in _CF_EDGES[1:]])}
        groups = dataclasses.replace(groups, rows=blocks)
        params = _cut(layouts["params"], params)
        statics = _cf_cut(statics, layouts["statics"], cfg)
        b = _cut(layouts["batch"], b)
        notes = _mesh_notes(mesh, groups, "vocab rows: tables and sketches; "
                            "edges by their layout")
    opt = opt_lib.adamw(lr=1e-3)
    opt_state = opt.init(params)
    step = _adamw_step(lambda p, s, bb: LG.bpr_loss_fn(p, s, bb, cfg), opt,
                       groups=groups)
    return Cell(spec.arch_id, shape.name, "train", step,
                (params, opt_state, statics, b), donate=(0, 1),
                notes=",".join(notes), mesh=mesh, layouts=layouts)


# ---------------------------------------------------------------------------
# per-rank bytes
# ---------------------------------------------------------------------------
def _family_layouts(family: str, mesh, params, statics=None) -> dict:
    """{"params": ..., "statics": ...}: the layouts of a recsys, GNN or cf
    cell's params and statics (real or meta tensors) on ``mesh``, the
    reference's logical axes fitted to each leaf (``_recsys_param_axes``,
    ``_gnn_param_axes``, the cf cell's "vocab" tables and its edges over
    "batch"; every sketch by "vocab" rows)."""
    axes = {"recsys": sh.recsys_axes, "gnn": sh.replicated_axes,
            "cf": sh.vocab_axes}[family]
    out = {"params": sh.tree_layouts(mesh, params, axes)}
    if statics is not None:
        out["statics"] = {
            k: (sh.named_sharding(mesh, "batch", shape=tuple(t.shape))
                if k in _CF_EDGES else
                sh.named_sharding(mesh, *sh.vocab_axes(k, t.shape),
                                  shape=tuple(t.shape)))
            for k, t in statics.items()
            if family == "recsys" or k in _CF_EDGES
            or k.startswith("sketch_")}
    return out


def cell_layouts(arch_id: str, shape_name: str, mesh,
                 reference: bool = False) -> dict:
    """A cell's layouts on ``mesh`` (an ``AbstractMesh`` works) at the
    full published config, reckoned on the meta device. A recsys, GNN or
    cf cell: "params", "statics", and its meta params under
    "meta_params" (its meta statics under "meta_statics"). An LM cell:
    the layouts of :func:`_lm_layouts` ("params", a train cell's "opt",
    "batch", a decode cell's "cache", and "info"; ``reference``: the
    reference's own layouts), its meta params under "meta_params"."""
    spec = get_arch(arch_id)
    shape = spec.shape(shape_name)
    cfg = spec.full_config()
    meta = functools.partial(torch.empty, device="meta")
    statics = None
    if spec.family == "lm":
        dims = shape.dims
        mapping = dims.get("mapping", "tp")
        with sh.logical_mapping(mapping):
            out = _lm_layouts(cfg, mesh, shape.kind, dims["global_batch"],
                              dims["seq_len"], mapping, reference)
        out["meta_params"] = T.init_params(None, cfg, device="meta")
        return out
    if spec.family == "recsys":
        params = _recsys_init(cfg)(None, cfg, device="meta")
        statics = {k: meta(shp, dtype=torch.int32) for k, (shp, _) in
                   _recsys_statics_shapes(cfg).items()}
    elif spec.family == "gnn":
        cfg = _gnn_cfg_dims(spec, shape, False, None)[0]
        params = S.init_params(None, cfg, device="meta")
    else:
        params = {"user_table": meta((cfg.k_users or cfg.n_users, cfg.dim)),
                  "item_table": meta((cfg.k_items or cfg.n_items, cfg.dim))}
        e = max(4 * (cfg.n_users + cfg.n_items), 1024)
        statics = {k: meta((e,), dtype=torch.int32) for k in _CF_EDGES[:2]}
        statics["edge_norm"] = meta((e,))
        if cfg.k_users is not None:
            statics["sketch_u"] = meta((cfg.n_users, cfg.n_hot_users),
                                       dtype=torch.int32)
            statics["sketch_v"] = meta((cfg.n_items, 1), dtype=torch.int32)
    return dict(_family_layouts(spec.family, mesh, params, statics),
                meta_params=params, meta_statics=statics)


def _meta_batch(specs: dict) -> dict:
    return {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in specs.items()}


def cell_args(arch_id: str, shape_name: str, mesh,
              reference: bool = False) -> dict:
    """Every argument of a cell at the full published width on ``mesh``
    (an ``AbstractMesh`` works), as the reference's cell takes them:
    {"params" | "opt_state" | "statics" | "cache" | "batch": (tree of
    layouts, tree of meta tensors)}, and "info" (an LM's FSDP decision,
    ZeRO, tag, optimizer). The batch splits over the data axes as
    ``build_cell(mesh=...)`` splits it (all of them or none); the
    optimizer state is AdamW's (``step``, ``m``, ``v``) or Adafactor's
    (``step``, ``fac``) over the flat params."""
    spec = get_arch(arch_id)
    shape = spec.shape(shape_name)
    lay = cell_layouts(arch_id, shape_name, mesh, reference)
    params = lay["meta_params"]
    out = {"params": (lay["params"], params), "info": lay.get("info", {})}
    flat = R.flat_params(params)
    i32 = torch.int32
    if spec.family == "lm":
        cfg = spec.full_config()
        dims = shape.dims
        b, seq = dims["global_batch"], dims["seq_len"]
        if shape.kind == "train":
            opt = (opt_lib.adafactor() if lay["info"]["optimizer"]
                   == "adafactor" else opt_lib.adamw())
            out["opt_state"] = (lay["opt"], opt.init(flat))
            specs = {"tokens": _Spec((b, seq), i32),
                     "targets": _Spec((b, seq), i32)}
        elif shape.kind == "prefill":
            specs = {"tokens": _Spec((b, seq), i32)}
        else:
            specs = {"tokens": _Spec((b, 1), i32), "pos": _Spec((), i32)}
            out["cache"] = (lay["cache"], T.init_cache(cfg, b, seq,
                                                       device="meta"))
        out["batch"] = (lay["batch"], _meta_batch(specs))
        return out
    cfg = spec.full_config()
    dims = dict(shape.dims)
    if spec.family == "gnn":
        cfg, dims, n, e, _ = _gnn_cfg_dims(spec, shape, False, None)
        specs = _gnn_specs(shape.name, dims, n, e, cfg.d_feat)
        rows, replicated = math.gcd(*(v.shape[0] for v in specs.values())), ()
    elif spec.family == "recsys":
        specs = _recsys_batch(cfg, shape, dims)
        rows = (dims["n_candidates"] if shape.kind == "retrieval"
                and not isinstance(cfg, R.SASRecConfig) else dims["batch"])
        replicated = ("neg_ids",)
    else:
        n = dims["batch"]
        specs = {k: _Spec((n,), i32) for k in ("user", "pos", "neg")}
        rows, replicated = n, ()
    split = bool(par.data_axes(mesh, rows))
    out["batch"] = ({k: sh.batch_layout(mesh, len(v.shape), split and
                                        k not in replicated and
                                        len(v.shape) > 0 and
                                        (spec.family == "gnn"
                                         or v.shape[0] == rows))
                     for k, v in specs.items()}, _meta_batch(specs))
    if lay.get("statics"):
        out["statics"] = (lay["statics"], lay["meta_statics"])
    if shape.kind == "train":
        m = R.flat_params(lay["params"])
        out["opt_state"] = ({"step": sh.Layout(mesh, ()), "m": m,
                             "v": dict(m)}, opt_lib.adamw().init(flat))
    return out


def _leaf_bytes(lay, t) -> int:
    return math.prod(lay.local_shape(tuple(t.shape))) * t.element_size()


def arg_bytes(arch_id: str, shape_name: str, mesh,
              reference: bool = False) -> dict:
    """A cell's argument bytes a rank on ``mesh`` (the reference's
    ``launch/dryrun.py::_arg_bytes_per_device``: every argument leaf's
    block), by kind (:func:`cell_args`) and in all ("total"); "info"
    as :func:`cell_args`."""
    args = cell_args(arch_id, shape_name, mesh, reference)
    out = {"info": args.pop("info")}
    for kind, (lay, meta) in args.items():
        out[kind] = sum(R.flat_params(_map_layouts(_leaf_bytes, lay,
                                                   meta)).values())
    out["total"] = sum(v for k, v in out.items() if k != "info")
    return out


def rank_bytes(arch_id: str, shape_name: str, mesh) -> dict:
    """A recsys, GNN or cf cell's bytes a rank on ``mesh`` (a
    ``DeviceMesh`` or an ``AbstractMesh``) at the full published width:
    its params' blocks by :func:`cell_layouts`, and for a train cell as
    many bytes of gradients and the f32 AdamW moments (m and v). Every
    rank holds blocks of one size; statics, batches and activations are
    not counted."""
    lay = cell_layouts(arch_id, shape_name, mesh)
    layouts = R.flat_params(lay["params"])
    params = R.flat_params(lay["meta_params"])
    numel = {k: math.prod(layouts[k].local_shape(tuple(t.shape)))
             for k, t in params.items()}
    out = {"params": sum(n * params[k].element_size()
                         for k, n in numel.items()),
           "grads": 0, "moments": 0}
    if get_arch(arch_id).shape(shape_name).kind == "train":
        out["grads"] = out["params"]
        out["moments"] = 2 * 4 * sum(numel.values())
    out["total"] = out["params"] + out["grads"] + out["moments"]
    return out


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------
_FAMILY = {"lm": _lm_cell, "gnn": _gnn_cell, "recsys": _recsys_cell,
           "cf": _cf_cell}


def build_cell(arch_id: str, shape_name: str, mesh=None, smoke: bool = False,
               lookup_backend: Optional[str] = None,
               device="cuda", args=None, **cuts) -> Cell:
    """The (arch, shape) cell on ``device`` (default the CUDA device;
    raises without one). ``mesh``: the cell over the mesh's ranks
    (module docstring); ``args``, with a mesh: the unsharded cell's args
    (a fresh optimizer state) to cut into this rank's blocks instead of
    drawing them. ``lookup_backend``: explicit EmbeddingEngine backend
    override ("gather" | "onehot" | "cuda"); None auto-selects by
    device. ``cuts`` (LM cells: ``batch``, ``n_layers``; GNN cells:
    ``n_edges``) cut the cell, each cut listed in ``Cell.reduced``
    (``LM_ONE_CARD`` and ``GNN_ONE_CARD`` hold the cuts that fit one
    H100)."""
    spec = get_arch(arch_id)
    shape = spec.shape(shape_name)
    device = resolve_device(device)
    if spec.family not in ("lm", "gnn") and cuts:
        raise TypeError(f"{arch_id} takes no cuts, got {sorted(cuts)}")
    if args is not None and mesh is None:
        raise TypeError("args= cuts the unsharded cell's args for a mesh")
    return _FAMILY[spec.family](spec, shape, smoke, lookup_backend, device,
                                mesh=mesh, args=args, **cuts)
