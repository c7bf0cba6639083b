"""Decoder-only transformer (port of ``repro.models.transformer``).

One config drives gemma2-9b, gemma3-12b, qwen1.5-32b, dbrx-132b and
kimi-k2-1t-a32b:
  * GQA with any (n_heads, n_kv_heads); optional QKV bias (qwen)
  * per-block layer patterns (gemma3 = 5 local + 1 global per block,
    gemma2 = (local, global)); params are stacked
    ``[n_blocks, layers_per_block, ...]`` as in the reference, and the
    reference's ``lax.scan`` over blocks is a Python loop over them
  * sliding-window local attention is BANDED: each query chunk slices
    only its KV span, ``min(skv, window + q_chunk)`` long
  * optional attn/final logit softcap (gemma2), QK-norm (gemma3)
  * MoE FFN with the reference's sort-based capacity dispatch (dbrx,
    kimi-k2; :func:`_mlp_moe`), its token combine on the CSR gather-sum
  * cross-entropy in sequence chunks, so [B, S, vocab] never exists

Dtypes follow JAX's promotion, made explicit (torch's ``bf16 * float``
stays bf16 and ``f32 @ bf16`` raises):
  * gemma's ``x * np.sqrt(d)`` multiplies by a numpy float64, which JAX
    does not treat as weakly typed, so a bf16 residual stream becomes f32
    there and stays f32: every product of an f32 activation with a bf16
    weight upcasts the weight and computes in f32 (``_mm``), the tied
    head too (the table is cast per call: 3.67 GB f32 transient for
    gemma2-9b's 256,000 x 3,584). qwen's stream stays bf16.
  * attention scores are f32 (the reference's ``preferred_element_type``):
    16-bit q and k are upcast, whose products are exact in f32. Prefill
    and training cast the softmax to q's dtype before P·V; decode casts it
    to the config's dtype (so gemma's decode attention output is bf16 and
    its prefill's f32, as in the reference).
  * an fp8 (e4m3fn) KV cache is written through :func:`to_kv`, which
    gives NaN where ml_dtypes does (|x| > 464, ±inf); torch's own cast
    saturates to ±448 there.
  * products sum in f32, as the reference's dots do: :func:`prefill`,
    :func:`decode_step` and :func:`train_loss`'s forward run with TF32
    off and with cuBLAS's reduced-precision bf16 reduction off
    (:func:`_f32_sums`), whatever the process had set.

Serving: prefill fills a layer-stacked cache (local layers keep a ring
buffer of ``window`` slots, position p at slot p % length); decode writes
one slot a layer in place (``index_copy_`` at a device ``pos``: no host
sync a layer) and returns the same cache, the port's counterpart of the
reference's donated buffer. The token embedding is a full lookup through
the EmbeddingEngine: on the card the codebook_lookup kernel at H = 1 (its
16-bit instantiation for a bf16 table).

Training: ``jax.checkpoint`` (a block under ``cfg.remat``, each attention
chunk, each CE chunk) is ``torch.utils.checkpoint`` whenever autograd
records. The reference's ``shard(...)`` calls place nothing in a
one-process-per-rank design and are dropped.

Over a (data, model) mesh (``distributed.parallel.use_groups``; the
cells of ``launch.steps.build_cell(mesh=...)`` enter it) each rank runs
the same functions on its blocks of the params (:func:`param_layouts`)
and of the batch, Megatron-style:
  * "model": attention heads and d_ff column-parallel (wq, wk, wv and
    their biases, w_gate, w_up), wo and w_down row-parallel with one
    all-reduce each; a rank's query heads are whole (``n_heads`` must
    divide the model axis, else the cell raises), and where ``n_kv_heads``
    does not divide it, wk/wv stay replicated and each rank computes the
    K/V heads its query heads read (:func:`local_heads`);
  * the token embedding's and the head's vocabulary rows over "model":
    each rank looks up its own rows (ids outside give zero rows, then one
    all-reduce: adding zeros is exact, so the embedding is the one-card
    one bitwise); the logits stay vocabulary-parallel through the
    cross-entropy (``parallel.vocab_parallel_ce``) and are all-gathered
    only where a cell returns them;
  * the MoE FFN is the reference's ``_mlp_moe_local``: expert-parallel
    over "model", each rank dispatching its local batch's assignments to
    its E / n_model experts with the per-shard capacity (from the local
    token count) and a trash row, the token combine on the CSR
    gather-sum, then one all-reduce. Where the experts do not divide the
    axis the reference falls back to ``_mlp_moe`` on the global tokens,
    and so does the port, with the experts replicated;
  * "batch" over the data axes: the loss is the mean over the data ranks;
  * a param the cell stores split over data axes (the reference's ZeRO'd
    serving params, FSDP, the "dp" mapping: ``RankGroups.params``) is
    all-gathered just in time: a block's weights inside the block (a
    checkpointed block gathers again in its backward), the embedding,
    the head and the final norm once a call (:func:`_top_params`); the
    gather's backward reduce-scatters the gradient into the rank's block.
The decode cache is head-sharded with the attention (the reference's
cache spec shards the sequence over "model", flash-decoding style): the
numbers are the same.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import parallel as par
from repro_torch.distributed.sharding import (Layout, fit_spec,
                                              logical_to_spec, mesh_shape,
                                              zero1_axes)
from repro_torch.embedding import embedding_block_lookup, embedding_lookup
from repro_torch.kernels.embedding_bag import csr_gather_sum

__all__ = ["TransformerConfig", "MoEConfig", "init_params", "count_params",
           "param_logical_axes", "param_shapes", "param_axes",
           "param_layouts", "leaf_layout", "check_model_axis",
           "cache_layouts", "reference_cache_layouts",
           "local_heads", "params_from_numpy", "tensor_from_numpy",
           "rms_norm", "expand_kv", "chunked_attention", "to_kv",
           "train_loss", "init_cache", "prefill", "decode_step", "MoERoute",
           "moe_route", "moe_capacity"]

NEG_INF = -1e30          # masked scores, as in the reference
FP8_NAN_FROM = 464.0     # ml_dtypes' e4m3fn cast gives NaN above this

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float8_e4m3fn": torch.float8_e4m3fn}


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    block_pattern: Tuple[str, ...] = ("global",)   # per-layer attn kinds
    window: int = 1024                      # local attention window
    attn_softcap: Optional[float] = None    # gemma2: 50.0
    final_softcap: Optional[float] = None   # gemma2: 30.0
    qk_norm: bool = False                   # gemma3
    qkv_bias: bool = False                  # qwen1.5
    post_norm: bool = False                 # gemma2/3 sandwich norms
    moe: Optional[MoEConfig] = None
    rope_theta: float = 10_000.0
    embed_scale: bool = False               # gemma: x *= sqrt(d)
    tie_embed: bool = True
    dtype: str = "bfloat16"                 # params + activations
    kv_cache_dtype: Optional[str] = None    # e.g. "float8_e4m3fn" (qwen)
    q_chunk: int = 512                      # attention query chunking
    loss_chunk: int = 512                   # CE seq chunking
    remat: bool = True
    moe_impl: str = "local"                 # the reference's MoE dispatch
    lookup_backend: Optional[str] = None    # EmbeddingEngine override for
                                            # the token-embedding lookup

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def kv_torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.kv_cache_dtype or self.dtype]

    @property
    def layers_per_block(self) -> int:
        return len(self.block_pattern)

    @property
    def n_blocks(self) -> int:
        assert self.n_layers % self.layers_per_block == 0, (
            f"{self.n_layers} layers not divisible by pattern "
            f"{self.block_pattern}")
        return self.n_layers // self.layers_per_block


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
def _param_defs(cfg: TransformerConfig) -> dict:
    """path -> (shape, logical axes, fan_in), nested; blocks get the
    leading stack dims. QKV projections keep heads merged ([d, H*Dh]),
    as the reference."""
    d, f, hq, hk, dh = (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads,
                        cfg.hd)
    nb, lpb = cfg.n_blocks, cfg.layers_per_block
    M, N = "model", None
    defs = {"embed": ((cfg.vocab_size, d), (M, N), d),
            "final_norm": ((d,), (N,), None)}
    if not cfg.tie_embed:
        defs["lm_head"] = ((d, cfg.vocab_size), (N, M), d)
    blk = {
        "attn_norm": ((nb, lpb, d), (N, N, N), None),
        "wq": ((nb, lpb, d, hq * dh), (N, N, N, M), d),
        "wk": ((nb, lpb, d, hk * dh), (N, N, N, M), d),
        "wv": ((nb, lpb, d, hk * dh), (N, N, N, M), d),
        "wo": ((nb, lpb, hq * dh, d), (N, N, M, N), hq * dh),
        "mlp_norm": ((nb, lpb, d), (N, N, N), None),
    }
    if cfg.qkv_bias:
        blk["bq"] = ((nb, lpb, hq * dh), (N, N, M), None)
        blk["bk"] = ((nb, lpb, hk * dh), (N, N, M), None)
        blk["bv"] = ((nb, lpb, hk * dh), (N, N, M), None)
    if cfg.qk_norm:
        blk["q_norm"] = ((nb, lpb, dh), (N, N, N), None)
        blk["k_norm"] = ((nb, lpb, dh), (N, N, N), None)
    if cfg.post_norm:
        blk["attn_post_norm"] = ((nb, lpb, d), (N, N, N), None)
        blk["mlp_post_norm"] = ((nb, lpb, d), (N, N, N), None)
    if cfg.moe is None:
        blk["w_gate"] = ((nb, lpb, d, f), (N, N, N, M), d)
        blk["w_up"] = ((nb, lpb, d, f), (N, N, N, M), d)
        blk["w_down"] = ((nb, lpb, f, d), (N, N, M, N), f)
    else:
        e = cfg.moe.n_experts
        blk["router"] = ((nb, lpb, d, e), (N, N, N, N), d)
        blk["w_gate"] = ((nb, lpb, e, d, f), (N, N, M, N, N), d)
        blk["w_up"] = ((nb, lpb, e, d, f), (N, N, M, N, N), d)
        blk["w_down"] = ((nb, lpb, e, f, d), (N, N, M, N, N), f)
    defs["blocks"] = blk
    return defs


def _walk(defs: dict, prefix=()):
    for k, v in defs.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _fill_normal(out: torch.Tensor, scale: float, generator,
                 cast=None) -> torch.Tensor:
    """Fill ``out`` in place with f32 N(0, 1) * scale cast to its dtype
    (``cast(x, dtype)`` if given), drawn in chunks of 2**26 values so no
    full-size f32 copy of a large leaf exists."""
    flat = out.view(-1)
    step = 1 << 26
    for s in range(0, flat.numel(), step):
        n = min(step, flat.numel() - s)
        x = torch.randn(n, generator=generator, dtype=torch.float32,
                        device=out.device)
        if scale != 1.0:
            x.mul_(scale)
        flat[s:s + n].copy_(cast(x, out.dtype) if cast else x)
    return out


def init_params(generator, cfg: TransformerConfig, device=None,
                layouts=None) -> dict:
    """Nested dict of tensors in the reference's layout: norm scales 1,
    every other leaf N(0, 1) / sqrt(fan_in) drawn in f32 from
    ``generator`` and cast to ``cfg.dtype`` (the reference's rule; its
    jax.random values differ). ``device`` defaults to the generator's;
    on "meta" nothing is allocated. ``layouts`` (:func:`param_layouts`):
    keep each leaf's block for this rank, drawn from the same stream as
    the whole leaf (a leaf at a time is drawn whole, then cut)."""
    if device is None:
        if generator is None:
            raise ValueError("give a generator or a device")
        device = generator.device
    device = torch.device(device)
    dtype = cfg.torch_dtype
    params: dict = {}
    for path, (shape, _, fan) in _walk(_param_defs(cfg)):
        node = params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        if fan is None:
            leaf = torch.ones(shape, dtype=dtype, device=device)
        else:
            leaf = torch.empty(shape, dtype=dtype, device=device)
            if device.type != "meta":
                _fill_normal(leaf, 1.0 / math.sqrt(fan), generator)
        if layouts is not None:
            layout = layouts
            for p in path:
                layout = layout[p]
            block = layout.local_block(leaf)
            leaf = leaf if block.shape == leaf.shape else block.clone()
        node[path[-1]] = leaf
    return params


def count_params(cfg: TransformerConfig) -> int:
    return sum(int(np.prod(shape)) for _, (shape, _, _) in
               _walk(_param_defs(cfg)))


def param_logical_axes(cfg: TransformerConfig) -> dict:
    """The reference's logical axes of every param, nested as the
    params."""
    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else v[1]
                for k, v in node.items()}
    return walk(_param_defs(cfg))


@dataclasses.dataclass(frozen=True)
class LocalHeads:
    """A rank's attention heads: query heads [q_lo, q_lo + hq) and the K/V
    heads they read, [kv_lo, kv_lo + kv). ``kv_sharded``: K/V heads divide
    the model axis, so wk/wv are column blocks; else they are replicated
    and each rank takes its heads' columns. ``kv_of_q``: the local K/V
    head of each local query head where that is not a plain grouping of
    ``hq // kv`` consecutive heads (None where it is)."""
    hq: int
    q_lo: int
    kv: int
    kv_lo: int
    kv_sharded: bool
    kv_of_q: Optional[Tuple[int, ...]]


def local_heads(cfg: TransformerConfig, n_model: int = 1,
                model_rank: int = 0) -> LocalHeads:
    """This rank's heads at ``n_model`` ranks on the model axis; raises
    where the query heads do not divide it (a rank's attention needs
    whole heads)."""
    hq_all, hkv = cfg.n_heads, cfg.n_kv_heads
    if hq_all % n_model:
        raise ValueError(f"{cfg.name}: {hq_all} query heads do not divide "
                         f"a model axis of {n_model} (a rank's attention "
                         f"needs whole heads)")
    hq = hq_all // n_model
    q_lo = model_rank * hq
    grp = hq_all // hkv
    kv_lo = q_lo // grp
    kv = (q_lo + hq - 1) // grp + 1 - kv_lo
    of_q = tuple((q_lo + i) // grp - kv_lo for i in range(hq))
    plain = hq % kv == 0 and of_q == tuple(i // (hq // kv)
                                           for i in range(hq))
    return LocalHeads(hq, q_lo, kv, kv_lo, hkv % n_model == 0,
                      None if plain else of_q)


def _model_size(mesh) -> int:
    """The model axis's size under the current logical mapping (1 where
    there is none, or under "dp")."""
    if logical_to_spec(mesh, ("model",)) != ("model",):
        return 1
    return mesh_shape(mesh)["model"]


def _model_axis(mesh) -> Tuple[int, int]:
    """(size, this rank's coordinate) of the model axis."""
    n = _model_size(mesh)
    return n, (mesh.get_local_rank("model") if n > 1 else 0)


def param_shapes(cfg: TransformerConfig) -> dict:
    """Every param's shape, nested as the params."""
    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else tuple(v[0])
                for k, v in node.items()}
    return walk(_param_defs(cfg))


_KV_LEAVES = ("wk", "wv", "bk", "bv")


def leaf_layout(cfg: TransformerConfig, mesh, name: str, axes, shape,
                reference: bool = False) -> Layout:
    """The ``Layout`` of a param named ``name`` (or of a state leaf
    derived from it) with logical ``axes``: ``logical_to_spec`` and
    ``fit_spec``, then no split over "model" for wk/wv/bk/bv where the
    K/V heads do not divide the model axis (:class:`LocalHeads`; not in
    the ``reference``'s layout)."""
    spec = fit_spec(mesh, logical_to_spec(mesh, axes), shape)
    if (not reference and name in _KV_LEAVES
            and cfg.n_kv_heads % _model_size(mesh)):
        spec = tuple(None if p == "model" else p for p in spec)
    return Layout(mesh, spec)


def check_model_axis(cfg: TransformerConfig, mesh) -> None:
    """Raise, naming the config, where the query heads, a dense d_ff or
    the vocabulary do not divide the model axis (the port's attention
    needs whole heads a rank; the reference's GSPMD splits them)."""
    n = _model_size(mesh)
    local_heads(cfg, n)
    split = {"the vocabulary": cfg.vocab_size}
    if cfg.moe is None:
        split["d_ff"] = cfg.d_ff
    for what, size in split.items():
        if size % n:
            raise ValueError(f"{cfg.name}: {what} ({size}) does not divide "
                             f"a model axis of {n}")


def param_axes(cfg: TransformerConfig, zero: bool = False,
               tag: str = "data") -> dict:
    """The params' logical axes (:func:`param_logical_axes`), each leaf
    one more dim over ``tag`` by the reference's ZeRO-1 rule
    (``sharding.zero1_axes``) when ``zero``: the reference ZeRO's the
    params of a serving cell and of an FSDP train cell."""
    axes = param_logical_axes(cfg)
    return zero1_axes(axes, param_shapes(cfg), tag) if zero else axes


def param_layouts(cfg: TransformerConfig, mesh, zero: bool = False,
                  tag: str = "data", reference: bool = False) -> dict:
    """Each param's ``Layout`` on ``mesh``: the reference's logical axes
    (:func:`param_axes`, ZeRO'd over ``tag`` when ``zero``) through
    :func:`leaf_layout`. Raises where the model axis does not divide the
    heads, a dense d_ff or the vocabulary (:func:`check_model_axis`),
    but for the ``reference``'s layout (the dry run's account of a cell
    the port does not build)."""
    if not reference:
        check_model_axis(cfg, mesh)
    axes = param_axes(cfg, zero, tag)
    shapes = param_shapes(cfg)

    def walk(ax, shp, name=""):
        if isinstance(ax, dict):
            return {k: walk(v, shp[k], k) for k, v in ax.items()}
        return leaf_layout(cfg, mesh, name, ax, shp, reference)
    return walk(axes, shapes)


def cache_layouts(cfg: TransformerConfig, mesh, batch: int) -> dict:
    """The decode cache's layouts: batch over the data axes (replicated
    where they do not divide it), K/V heads as the attention holds them
    (:func:`local_heads`; a head several ranks read is on each)."""
    spec = fit_spec(mesh, logical_to_spec(
        mesh, (None, None, "batch", None, None, None)),
        (1, 1, batch, 1, 1, 1))
    return {f"{kv}_{kind}": _KVLayout(Layout(mesh, spec), cfg)
            for kind in _cache_kinds(cfg) for kv in "kv"}


def reference_cache_layouts(cfg: TransformerConfig, mesh, batch: int,
                            max_seq: int) -> dict:
    """The reference's decode-cache layouts (``repro/launch/steps.py:
    314-328``): the batch over the batch axes and the sequence over
    "model", or at batch 1 the sequence over every axis, fitted."""
    ba = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    if batch == 1:
        spec = (None, None, None, ba + ("model",), None, None)
    else:
        spec = (None, None, ba if len(ba) > 1 else ba[0], "model", None,
                None)
    out = {}
    for kind, per in _cache_kinds(cfg).items():
        shape = (cfg.n_blocks, per, batch, _cache_length(cfg, kind, max_seq),
                 cfg.n_kv_heads, cfg.hd)
        for kv in "kv":
            out[f"{kv}_{kind}"] = Layout(mesh, fit_spec(mesh, spec, shape))
    return out


class _KVLayout:
    """A cache tensor [nb, per, B, L, Hkv, Dh]: B by the ``batch`` layout,
    the K/V heads by :func:`local_heads` at this rank's model
    coordinate."""

    def __init__(self, batch, cfg):
        self.batch, self.cfg = batch, cfg
        self.n_model = _model_size(batch.mesh)

    def _heads(self) -> "LocalHeads":
        rank = (self.batch.mesh.get_local_rank("model") if self.n_model > 1
                else 0)
        return local_heads(self.cfg, self.n_model, rank)

    def local_shape(self, shape) -> tuple:
        """A rank's block of a cache tensor of ``shape`` (the widest
        rank's K/V heads; no rank needed)."""
        out = list(self.batch.local_shape(shape))
        out[4] = max(local_heads(self.cfg, self.n_model, j).kv
                     for j in range(self.n_model))
        return tuple(out)

    def local_block(self, full):
        h = self._heads()
        return self.batch.local_block(full).narrow(4, h.kv_lo, h.kv)

    def gather(self, block):
        """The whole cache: the batch gathered, then every rank's heads
        (padded to the widest rank's count for one all-gather)."""
        out = self.batch.gather(block)
        n = self.n_model
        if n == 1:
            return out
        heads = [local_heads(self.cfg, n, j) for j in range(n)]
        shape = list(out.shape)
        shape[4] = max(h.kv for h in heads)
        pad = out.new_zeros(shape)
        pad.narrow(4, 0, out.shape[4]).copy_(out)
        every = par.all_gather_cat(
            pad[None], self.batch.mesh.get_group("model"), 0)
        shape[4] = self.cfg.n_kv_heads
        full = out.new_empty(shape)
        for j, h in enumerate(heads):
            full.narrow(4, h.kv_lo, h.kv).copy_(every[j].narrow(4, 0, h.kv))
        return full


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """A numpy array (a reference leaf) as a tensor, bf16 and fp8 e4m3fn
    (ml_dtypes, which torch.as_tensor does not take) by their bits."""
    a = np.asarray(a)
    name = a.dtype.name
    if name == "bfloat16":
        return torch.as_tensor(a.view(np.uint16).copy(),
                               device=device).view(torch.bfloat16)
    if name == "float8_e4m3fn":
        return torch.as_tensor(a.view(np.uint8).copy(),
                               device=device).view(torch.float8_e4m3fn)
    return torch.as_tensor(np.array(a), device=device)


def params_from_numpy(tree, device="cuda"):
    """A reference params (or cache) tree (``jax.tree.map(np.asarray,
    ...)``) as the port's tree of tensors on ``device``, same keys."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _f32_sums_ctx():
    mm = torch.backends.cuda.matmul
    saved = (mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction)
    mm.allow_tf32 = False
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction = saved


def _f32_sums(fn):
    """Run ``fn`` with every GEMM summing in f32: no TF32, and no
    reduced-precision reduction of bf16 products (both cuBLAS flags are
    restored after)."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with _f32_sums_ctx():
            return fn(*args, **kwargs)
    return wrapped


def _mm(x, w):
    """x @ w in JAX's promoted dtype (f32 x with a bf16 w computes in
    f32, the weight upcast)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


def rms_norm(x, scale, eps=1e-6):
    """In f32, cast back to x's dtype, then times ``scale`` (promoting),
    in the reference's order."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def _rope(x, positions, theta):
    """x [..., S, H, Dh]; positions [..., S]; rotate-half."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., :, None].float() * freq             # [..., S, half]
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _softcap(x, cap):
    return torch.tanh(x / cap) * cap if cap else x


def expand_kv(k, n_heads: int):
    """[B, S, Hkv, Dh] -> [B, S, n_heads, Dh]: head i*g + j is kv head i."""
    b, s, hkv, dh = k.shape
    g = n_heads // hkv
    if g == 1:
        return k
    return k[:, :, :, None, :].expand(b, s, hkv, g, dh).reshape(
        b, s, hkv * g, dh)


def to_kv(x, dtype: torch.dtype):
    """x cast to the cache's dtype as ``jnp.astype`` casts it: for fp8
    e4m3fn, NaN where |x| > 464 or x is ±inf (ml_dtypes; torch's cast
    saturates to ±448 there), the plain cast elsewhere."""
    if dtype != torch.float8_e4m3fn:
        return x.to(dtype)
    xf = x.float()
    return torch.where(xf.abs() > FP8_NAN_FROM, float("nan"), xf).to(dtype)


def _bits(t):
    """An fp8 tensor as its bytes (for index_copy_), others as they are."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _maybe_checkpoint(fn, *args):
    """``fn(*args)``, recomputed in the backward when autograd records
    (the reference's ``jax.checkpoint(policy=nothing_saveable)``)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _attend_heads(qh, kt, vh, kv_pos, q_pos, window, softcap, causal,
                  p_dtype):
    """qh [B,H,Sq,D], kt [B,H,D,Skv] (f32), vh [B,H,Skv,D] -> [B,H,Sq,D]:
    f32 scores / sqrt(D), softcap, mask to -1e30, softmax cast to
    ``p_dtype``, then P·V in the promoted dtype."""
    dh = qh.shape[-1]
    scores = torch.matmul(qh.float(), kt)
    scores = _softcap(scores / math.sqrt(dh), softcap)
    mask = torch.ones((qh.shape[2], kt.shape[-1]), dtype=torch.bool,
                      device=qh.device)
    if causal:
        mask = mask & (q_pos[:, None] >= kv_pos[None, :])
    if window is not None:
        mask = mask & ((q_pos[:, None] - kv_pos[None, :]) < window)
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(p_dtype)
    dt = torch.promote_types(p.dtype, vh.dtype)
    return torch.matmul(p.to(dt), vh.to(dt))


def _attend(q, k, v, kv_pos, q_pos, window, softcap, causal=True):
    """q/k/v [B,S,H,Dh] with the SAME head count (kv pre-expanded)."""
    out = _attend_heads(q.transpose(1, 2), k.permute(0, 2, 3, 1).float(),
                        v.transpose(1, 2), kv_pos, q_pos, window, softcap,
                        causal, q.dtype)
    return out.transpose(1, 2)


def chunked_attention(q, k, v, *, window=None, softcap=None, causal=True,
                      q_chunk=512, base_pos=0):
    """Banded/causal attention over query chunks. q/k/v [B,S,H,Dh].

    Local layers (``window`` set) slice each chunk's KV band, ``span =
    min(skv, window + qc)`` long, its start clipped to [0, skv - span];
    global layers see the whole KV. A length that ``q_chunk`` does not
    divide goes single-shot, as in the reference."""
    b, s, hq, dh = q.shape
    skv = k.shape[1]
    dev = q.device
    qc = min(q_chunk, s)
    if s % qc != 0:
        return _attend(q, k, v, torch.arange(skv, device=dev),
                       base_pos + torch.arange(s, device=dev), window,
                       softcap, causal)
    span = skv if window is None else min(skv, window + qc)
    qh = q.transpose(1, 2)
    kt = k.permute(0, 2, 3, 1).float()          # [B, H, Dh, Skv], once
    vh = v.transpose(1, 2)
    outs = []
    for i in range(s // qc):
        qs = i * qc
        q_pos = base_pos + qs + torch.arange(qc, device=dev)
        if window is None:
            start, ki, vi = 0, kt, vh
        else:
            start = min(max(base_pos + qs + qc - span, 0), skv - span)
            ki = kt[..., start:start + span]
            vi = vh[:, :, start:start + span]
        kv_pos = start + torch.arange(ki.shape[-1], device=dev)
        outs.append(_maybe_checkpoint(
            _attend_heads, qh[:, :, qs:qs + qc], ki, vi, kv_pos, q_pos,
            window, softcap, causal, q.dtype))
    return torch.cat(outs, dim=2).transpose(1, 2)


# ---------------------------------------------------------------------------
# layer / block bodies
# ---------------------------------------------------------------------------
def _f(x, g):
    """Megatron's *f* on a mesh (``parallel.copy_to_model``), else ``x``."""
    return x if g is None else par.copy_to_model(x, g)


def _g(x, g):
    """Megatron's *g* on a mesh (``parallel.reduce_from_model``), else
    ``x``."""
    return x if g is None else par.reduce_from_model(x, g)


def _heads(cfg, g) -> LocalHeads:
    return local_heads(cfg) if g is None else \
        local_heads(cfg, g.n_model, g.model_rank)


def _proj_qkv(x, lp, li, cfg, g=None):
    """q, k, v [B, S, heads, Dh] of this rank's heads (:func:`local_heads`;
    all of them off a mesh). Replicated K/V weights give the columns of
    this rank's K/V heads."""
    b, s, _ = x.shape
    dh = cfg.hd
    hd = _heads(cfg, g)
    x = _f(x, g)

    def p(name, h, lo=None):
        w = lp[f"w{name}"][li]
        bias = lp[f"b{name}"][li] if cfg.qkv_bias else None
        if lo is not None:
            cols = slice(lo * dh, (lo + h) * dh)
            w = _f(w, g)[:, cols]
            bias = None if bias is None else _f(bias, g)[cols]
        y = _mm(x, w)
        if bias is not None:
            y = y + bias
        return y.reshape(b, s, h, dh)
    kv_lo = None if hd.kv_sharded else hd.kv_lo
    q = p("q", hd.hq)
    k = p("k", hd.kv, kv_lo)
    v = p("v", hd.kv, kv_lo)
    if cfg.qk_norm:
        q = rms_norm(q, _f(lp["q_norm"][li], g))
        k = rms_norm(k, _f(lp["k_norm"][li], g))
    return q, k, v


def _silu(x):
    """``jax.nn.silu`` as JAX lowers it: x * 1 / (1 + exp(-x)), every op
    rounded to x's dtype (in bf16, four roundings where ``F.silu`` and
    ``torch.sigmoid`` round once)."""
    return x * (1 / (1 + torch.exp(-x)))


def _mlp_dense(x, lp, li, g=None):
    """The gated MLP; on a mesh w_gate/w_up are column blocks and w_down
    a row block, summed over the model axis."""
    x = _f(x, g)
    h = _silu(_mm(x, lp["w_gate"][li]))
    h = h * _mm(x, lp["w_up"][li])
    return _g(_mm(h, lp["w_down"][li]), g)


# ---------------------------------------------------------------------------
# MoE FFN: sort-based capacity dispatch
# ---------------------------------------------------------------------------
class _Gather(torch.autograd.Function):
    """``xt[tok]``; dxt[i] = Σ_{j: tok[j] == i} g[j] in j order (the
    reference's VJP, a scatter-add in row order), on the CSR gather-sum
    over the plan (perm, ptr) of ``tok``: no float atomics."""

    @staticmethod
    def forward(ctx, xt, tok, perm, ptr):
        ctx.save_for_backward(perm, ptr)
        return xt.index_select(0, tok)

    @staticmethod
    def backward(ctx, g):
        perm, ptr = ctx.saved_tensors
        return csr_gather_sum(g.contiguous(), perm, ptr), None, None, None


class _Combine(torch.autograd.Function):
    """``jax.ops.segment_sum(rows, tok, num_segments=t)``: out[i] =
    Σ_{j: tok[j] == i} rows[j] in j order, on the CSR gather-sum (16-bit
    rows are summed in f32 and rounded once, where XLA's CPU segment_sum
    rounds every add: ROADMAP Queue 3 #9); drows = g[tok]."""

    @staticmethod
    def forward(ctx, rows, tok, perm, ptr):
        ctx.save_for_backward(tok)
        return csr_gather_sum(rows, perm, ptr)

    @staticmethod
    def backward(ctx, g):
        (tok,) = ctx.saved_tensors
        return g.index_select(0, tok), None, None, None


@dataclasses.dataclass(frozen=True)
class MoERoute:
    """One MoE call's routing and dispatch plan over t tokens x k choices.

    ``idx`` / ``gate`` [t, k]: the routed experts in ``lax.top_k``'s order
    and their renormalised gates (x's dtype). The assignments, flattened
    token-major and stably sorted by local expert (an expert outside this
    rank's range goes to the drop bin, past the last local one): ``order``
    (flat assignment of each sorted slot), ``se`` its local expert, ``tok``
    its token, ``pos`` its place in the expert's queue, ``keep`` = a
    local expert and ``pos < cap``. ``perm`` / ``ptr``: the stable sort of
    ``tok`` and its pointers over the t tokens (k slots each), the plan
    of the combine and of the dispatch gather's gradient."""
    idx: torch.Tensor
    gate: torch.Tensor
    cap: int
    order: torch.Tensor
    se: torch.Tensor
    tok: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    perm: torch.Tensor
    ptr: torch.Tensor


def moe_capacity(t: int, moe: MoEConfig) -> int:
    """Slots an expert takes a call (the reference's rule, on the host
    from shapes only; on a mesh ``t`` is the rank's own tokens)."""
    cap = math.ceil(t * moe.top_k / moe.n_experts * moe.capacity_factor)
    return max(8, min(cap, t))


def moe_route(xt, router, moe: MoEConfig, lo: int = 0,
              n_local: Optional[int] = None) -> MoERoute:
    """xt [t, d]: the router's logits in xt's dtype, an f32 softmax as
    ``jax.nn.softmax`` computes it (exp(x - max) over its sum), the top k
    of each row by a stable descending sort (``torch.topk`` promises no
    tie order: highest first, lowest expert id among equals), the gate
    renormalised and cast to xt's dtype; then the sort-based plan over
    the local experts [lo, lo + n_local) (default: all). No host sync."""
    t = xt.shape[0]
    e, k = moe.n_experts, moe.top_k
    n_loc = e if n_local is None else n_local
    dev = xt.device
    z = torch.matmul(xt, router.to(xt.dtype)).float()
    ex = torch.exp(z - z.amax(-1, keepdim=True).detach())
    probs = ex / ex.sum(-1, keepdim=True)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = vals[:, :k], ids[:, :k]
    gate = (gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
            ).to(xt.dtype)
    cap = moe_capacity(t, moe)
    flat = idx.reshape(-1)
    if n_loc != e:
        flat = torch.where((flat >= lo) & (flat < lo + n_loc), flat - lo,
                           n_loc)
    se, order = torch.sort(flat, stable=True)
    tok = order // k
    starts = torch.searchsorted(se, torch.arange(n_loc + 1, device=dev))
    pos = torch.arange(t * k, device=dev) - starts[se]
    perm = torch.sort(tok, stable=True).indices.int()
    ptr = torch.arange(0, t * k + 1, k, device=dev)
    return MoERoute(idx, gate, cap, order, se, tok, pos,
                    (se < n_loc) & (pos < cap), perm, ptr)


def _mlp_moe(x, lp, li, cfg, g=None):
    """The reference's ``_mlp_moe`` (off a mesh) and ``_mlp_moe_local`` (on
    one): each token's k assignments to this rank's experts go to their
    capacity buffers [e_loc, cap, d] (an assignment past ``cap``, or to
    another rank's expert, is dropped: written to a trash row that is
    sliced off), the three expert GEMMs run batched over the experts,
    and each kept assignment's output, times its gate, is summed back
    into its token (:class:`_Combine`), then over the model axis. Where
    the experts do not divide the model axis, the reference's fallback:
    ``_mlp_moe`` on every data rank's tokens, with the experts
    replicated."""
    b, s, d = x.shape
    e = cfg.moe.n_experts
    n = 1 if g is None else g.n_model
    if e % n:
        y = _mlp_moe(par.gather_over_data(x, g), lp, li, cfg)
        return y.narrow(0, g.data_rank * b if g.data_group else 0, b)
    e_loc = e // n
    lo = 0 if g is None else g.model_rank * e_loc
    x = _f(x, g)
    xt = x.reshape(b * s, d)
    r = moe_route(xt, _f(lp["router"][li], g), cfg.moe, lo, e_loc)
    cap = r.cap
    dest = torch.where(r.keep, r.se * cap + r.pos, e_loc * cap)
    buf = torch.zeros(e_loc * cap + 1, d, dtype=x.dtype, device=x.device)
    buf.index_copy_(0, dest, _Gather.apply(xt, r.tok, r.perm, r.ptr))
    buf = buf[:e_loc * cap].view(e_loc, cap, d)
    h = _silu(_mm(buf, lp["w_gate"][li]))
    h = h * _mm(buf, lp["w_up"][li])
    del buf                           # free each transient once read
    out = _mm(h, lp["w_down"][li])    # [e_loc, cap, d]
    del h
    rows = out.reshape(e_loc * cap, d).index_select(
        0, torch.clamp(r.se, max=e_loc - 1) * cap
        + torch.clamp(r.pos, max=cap - 1))
    del out
    rows = torch.where(r.keep[:, None], rows, 0)
    rows = rows * r.gate.reshape(-1).index_select(0, r.order)[:, None]
    y = _Combine.apply(rows, r.tok, r.perm, r.ptr)
    return _g(y, g).reshape(b, s, d)


def _mlp(cfg, g=None):
    """The layer's FFN, ``fn(h, lp, li)``: the MoE's or the dense one."""
    if cfg.moe:
        return functools.partial(_mlp_moe, cfg=cfg, g=g)
    return functools.partial(_mlp_dense, g=g)


def _residual_out(x, o, m_fn, lp, li, cfg, g=None):
    """The layer's tail shared by every path: attention output ``o`` [B,S,
    H*Dh] through wo (row-parallel on a mesh) and the post norm, the
    residual, the MLP."""
    o = _g(_mm(o, lp["wo"][li]), g)
    if cfg.post_norm:
        o = rms_norm(o, lp["attn_post_norm"][li])
    x = x + o
    h = rms_norm(x, lp["mlp_norm"][li])
    m = m_fn(h, lp, li)
    if cfg.post_norm:
        m = rms_norm(m, lp["mlp_post_norm"][li])
    return x + m


def _layer_qkv(x, lp, li, cfg, positions, g=None):
    h = rms_norm(x, lp["attn_norm"][li])
    q, k, v = _proj_qkv(h, lp, li, cfg, g)
    return (_rope(q, positions, cfg.rope_theta),
            _rope(k, positions, cfg.rope_theta), v)


def _expand_local(k, hd: LocalHeads):
    """[B, S, kv, Dh] -> [B, S, hq, Dh]: each local query head's K/V."""
    if hd.kv_of_q is None:
        return expand_kv(k, hd.hq)
    return k.index_select(2, torch.tensor(hd.kv_of_q, device=k.device))


def _layer_attention(q, k, v, kind, cfg, hd: LocalHeads):
    """Training/prefill attention of one layer -> [B, S, hq*Dh]."""
    win = cfg.window if kind == "local" else None
    o = chunked_attention(q, _expand_local(k, hd), _expand_local(v, hd),
                          window=win, softcap=cfg.attn_softcap,
                          q_chunk=cfg.q_chunk)
    return o.reshape(*o.shape[:2], -1)


def _block(x, blk, cfg, positions, g=None):
    hd = _heads(cfg, g)
    for li, kind in enumerate(cfg.block_pattern):
        q, k, v = _layer_qkv(x, blk, li, cfg, positions, g)
        x = _residual_out(x, _layer_attention(q, k, v, kind, cfg, hd),
                          _mlp(cfg, g), blk, li, cfg, g)
    return x


def _split(g, key: str):
    return None if g is None else g.params.get(key)


def _block_params(params, bi: int, g=None) -> dict:
    """Block ``bi``'s params, each whole over the data axes it is stored
    split over (``parallel.gather_param``: one all-gather a leaf, just in
    time; a leaf split along its block dim is gathered whole, then
    indexed)."""
    out = {}
    for k, v in params["blocks"].items():
        s = _split(g, f"blocks/{k}")
        if s is None:
            out[k] = v[bi]
        elif s.dim == 0:
            out[k] = par.gather_param(v, s)[bi]
        else:
            out[k] = par.gather_param(v[bi], s.at_block())
    return out


def _top_params(params, g=None) -> dict:
    """The embedding, the head and the final norm, each whole over the
    data axes (one all-gather each where it is stored split)."""
    return {k: par.gather_param(v, _split(g, k))
            for k, v in params.items() if k != "blocks"}


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------
def _vocab_split(g) -> bool:
    return g is not None and g.model_group is not None


def _embed(params, tokens, cfg, g=None):
    """The token embedding, in the residual stream's dtype: gemma's
    ``* np.sqrt(d)`` promotes to f32 (a non-weak float64 scalar). On a
    mesh each rank looks up its own vocabulary rows (other ids give
    zero rows) and the ranks' rows are summed. ``params["embed"]`` is
    whole over the data axes (:func:`_top_params`)."""
    table = params["embed"]
    if not _vocab_split(g):
        x = embedding_lookup(table, tokens, backend=cfg.lookup_backend)
    else:
        x = embedding_block_lookup(table, tokens,
                                   g.model_rank * table.shape[0],
                                   backend=cfg.lookup_backend)
        x = par.reduce_from_model(x, g)
    x = x.to(cfg.torch_dtype)
    if cfg.embed_scale:
        x = x.float() * math.sqrt(cfg.d_model)
    return x


def _positions(b: int, s: int, device):
    return torch.arange(s, device=device).expand(b, s)


def _gathered_block(x, params, bi, cfg, positions, g):
    """Block ``bi`` on ``params``' blocks, gathered inside (so a
    checkpointed block gathers again in its backward, not keeping every
    block's weights whole)."""
    return _block(x, _block_params(params, bi, g), cfg, positions, g)


def _backbone(params, tokens, cfg, positions, g=None, top=None):
    """The final-normed hidden states; ``top``: the
    :func:`_top_params` of ``params`` when the caller has them."""
    top = _top_params(params, g) if top is None else top
    x = _embed(top, tokens, cfg, g)
    for bi in range(cfg.n_blocks):
        if cfg.remat:
            x = _maybe_checkpoint(_gathered_block, x, params, bi, cfg,
                                  positions, g)
        else:
            x = _gathered_block(x, params, bi, cfg, positions, g)
    return rms_norm(x, top["final_norm"])


def _logits(params, h, cfg, g=None):
    """[..., d] -> f32 [..., vocab] (on a mesh, this rank's vocabulary
    slice): the tied table (cast per call to h's promoted dtype) or the
    untied head, then the final softcap. ``params``' head is whole over
    the data axes (:func:`_top_params`)."""
    if _vocab_split(g):
        h = par.copy_to_model(h, g)
    if cfg.tie_embed:
        out = _mm(h, params["embed"].T)
    else:
        out = _mm(h, params["lm_head"])
    return _softcap(out.float(), cfg.final_softcap)


def _whole_logits(lg, g):
    """A cell's logits [B, V] from every rank's [B_loc, V_loc]."""
    if _vocab_split(g):
        lg = par.all_gather_cat(lg, g.model_group, -1)
    if g is not None and g.data_group is not None:
        lg = par.all_gather_cat(lg, g.data_group, 0)
    return lg


def _ce_sum(params, hs, ts, cfg, g=None):
    lg = _logits(params, hs, cfg, g)                 # [B, lc, V(_loc)] f32
    if _vocab_split(g):
        return torch.sum(par.vocab_parallel_ce(
            lg, ts, g.model_rank * lg.shape[-1], g))
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, ts[..., None].long())[..., 0]
    return torch.sum(lse - gold)


@_f32_sums
def train_loss(params, batch, cfg: TransformerConfig):
    """Causal LM loss; CE per sequence chunk. ``n_chunks = max(1, s //
    lc)``: tokens past ``n_chunks * lc`` are not summed, and the divisor
    is still ``b * s`` (the reference's, kept). On a mesh
    (``parallel.use_groups``): this rank's batch, then the mean over the
    data ranks."""
    g = par.current_groups()
    tokens, targets = batch["tokens"], batch["targets"]
    b, s = tokens.shape
    top = _top_params(params, g)
    h = _backbone(params, tokens, cfg, _positions(b, s, tokens.device), g,
                  top)
    lc = min(cfg.loss_chunk, s)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(max(1, s // lc)):
        sl = slice(i * lc, (i + 1) * lc)
        total = total + _maybe_checkpoint(_ce_sum, top, h[:, sl],
                                          targets[:, sl], cfg, g)
    loss = total / (b * s)
    return loss if g is None else par.mean_over_data(loss, g)


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------
def _cache_kinds(cfg) -> dict:
    kinds: dict = {}
    for kind in cfg.block_pattern:
        kinds[kind] = kinds.get(kind, 0) + 1
    return kinds


def _cache_length(cfg, kind: str, max_seq: int) -> int:
    return max_seq if kind == "global" else min(cfg.window, max_seq)


def init_cache(cfg: TransformerConfig, batch: int, max_seq: int,
               device="cuda", generator=None,
               kv_heads: Optional[int] = None) -> dict:
    """Layer-stacked KV caches ``{"k_global", "v_global", "k_local",
    ...}``, each [n_blocks, per_block, B, length, Hkv, Dh] in the cache
    dtype (``kv_heads`` K/V heads, default all); local layers get ring
    buffers of ``window`` slots. Zeros, or standard normal drawn from
    ``generator`` (through :func:`to_kv`)."""
    cache = {}
    dt = cfg.kv_torch_dtype
    hkv = cfg.n_kv_heads if kv_heads is None else kv_heads
    for kind, n_per_block in _cache_kinds(cfg).items():
        shp = (cfg.n_blocks, n_per_block, batch,
               _cache_length(cfg, kind, max_seq), hkv, cfg.hd)
        for kv in "kv":
            if generator is None:           # +0.0 is all-zero bytes
                t = torch.zeros(shp, dtype=torch.uint8 if dt.itemsize == 1
                                else dt, device=device).view(dt)
            else:
                t = _fill_normal(torch.empty(shp, dtype=dt, device=device),
                                 1.0, generator, cast=to_kv)
            cache[f"{kv}_{kind}"] = t
    return cache


@_f32_sums
def prefill(params, batch, cfg: TransformerConfig, max_seq: int):
    """Process a full prompt; returns (last-position logits f32 [B, V],
    the filled cache). The cache holds K/V cast to its dtype; attention
    reads the unrounded K/V. On a mesh: this rank's batch rows and K/V
    heads of the cache, the logits of the whole batch."""
    g = par.current_groups()
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = tokens.device
    positions = _positions(b, s, dev)
    top = _top_params(params, g)
    x = _embed(top, tokens, cfg, g)
    hd = _heads(cfg, g)
    cache = init_cache(cfg, b, max_seq, device=dev, kv_heads=hd.kv)
    for bi in range(cfg.n_blocks):
        blk = _block_params(params, bi, g)
        counters = {k: 0 for k in _cache_kinds(cfg)}
        for li, kind in enumerate(cfg.block_pattern):
            ci = counters[kind]
            counters[kind] += 1
            q, k, v = _layer_qkv(x, blk, li, cfg, positions, g)
            x = _residual_out(x, _layer_attention(q, k, v, kind, cfg, hd),
                              _mlp(cfg, g), blk, li, cfg, g)
            # ring layout: position p lives at slot p % length, so the
            # decode step's `pos % length` writes continue seamlessly
            length = _cache_length(cfg, kind, max_seq)
            take = min(length, s)
            slots = torch.as_tensor(np.arange(s - take, s) % length,
                                    device=dev)
            for name, val in (("k", k), ("v", v)):
                _bits(cache[f"{name}_{kind}"][bi, ci]).index_copy_(
                    1, slots, _bits(to_kv(val[:, s - take:],
                                          cfg.kv_torch_dtype)))
    h = rms_norm(x[:, -1:], top["final_norm"])
    return _whole_logits(_logits(top, h, cfg, g)[:, 0], g), cache


@_f32_sums
def decode_step(params, cache, batch, cfg: TransformerConfig):
    """One token for every sequence. batch = {tokens [B, 1], pos int32
    [] (a tensor on the device)}. Writes the new K/V into ``cache`` in
    place and returns (logits f32 [B, V], cache).

    Local layers write slot ``pos % length``, global ones ``pos``
    (clamped into the buffer, as ``dynamic_update_slice`` clamps); every
    slot below ``min(pos + 1, length)`` is attended, with no causal or
    window mask. GQA stays grouped ([Hkv, grp]; q head h*grp + g). On a
    mesh: this rank's batch rows and heads (a rank whose query heads are
    no plain grouping of its K/V heads reads each head's K/V), the
    logits of the whole batch."""
    g = par.current_groups()
    tokens, pos = batch["tokens"], batch["pos"]
    b = tokens.shape[0]
    dev = tokens.device
    pos = torch.as_tensor(pos, device=dev)
    positions = pos.reshape(1, 1).expand(b, 1)
    top = _top_params(params, g)
    x = _embed(top, tokens, cfg, g)
    dt, dh = cfg.torch_dtype, cfg.hd
    hd = _heads(cfg, g)
    kv_of_q = (None if hd.kv_of_q is None else
               torch.tensor(hd.kv_of_q, device=dev))
    hkv = hd.kv if kv_of_q is None else hd.hq
    grp = hd.hq // hkv
    for bi in range(cfg.n_blocks):
        blk = _block_params(params, bi, g)
        counters = {k: 0 for k in _cache_kinds(cfg)}
        for li, kind in enumerate(cfg.block_pattern):
            ci = counters[kind]
            counters[kind] += 1
            q, k, v = _layer_qkv(x, blk, li, cfg, positions, g)
            kc = cache[f"k_{kind}"][bi, ci]           # [B, L, Hkv, Dh] view
            vc = cache[f"v_{kind}"][bi, ci]
            length = kc.shape[1]
            slot = (torch.remainder(pos, length) if kind == "local"
                    else torch.clamp(pos, 0, length - 1)).reshape(1).long()
            _bits(kc).index_copy_(1, slot, _bits(to_kv(k, kc.dtype)))
            _bits(vc).index_copy_(1, slot, _bits(to_kv(v, vc.dtype)))
            if kv_of_q is not None:
                kc, vc = kc.index_select(2, kv_of_q), vc.index_select(2,
                                                                      kv_of_q)
            mask = (torch.arange(length, device=dev)
                    < torch.clamp(pos + 1, max=length))
            qh = q.reshape(b, hkv, grp, dh)
            dense = torch.contiguous_format
            kf = kc.permute(0, 2, 1, 3).to(torch.float32, memory_format=dense)
            scores = torch.matmul(qh.float(), kf.transpose(-1, -2))
            del kf
            scores = _softcap(scores / math.sqrt(dh), cfg.attn_softcap)
            scores = torch.where(mask, scores, NEG_INF)
            p = torch.softmax(scores, dim=-1).to(dt)   # [B, Hkv, grp, L]
            ve = vc.permute(0, 2, 1, 3).to(dt, memory_format=dense)
            o = torch.matmul(p, ve).reshape(b, 1, hd.hq * dh)
            x = _residual_out(x, o, _mlp(cfg, g), blk, li, cfg, g)
    h = rms_norm(x, top["final_norm"])
    return _whole_logits(_logits(top, h, cfg, g)[:, 0], g), cache
