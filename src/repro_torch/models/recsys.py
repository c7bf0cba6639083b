"""RecSys architectures: DLRM (MLPerf), Wide&Deep, SASRec, BERT4Rec
(port of ``repro.models.recsys``).

Common substrate: per-field embedding tables (optionally BACO-compressed
through frozen sketch index arrays in ``statics``), lookups through the
EmbeddingEngine, MLP towers. Params are nested dicts and lists of
tensors with the reference's keys and list order (``params_from_numpy``
carries a reference tree over); every function takes tensors and runs on
their device.

Two of the port's kernels sit on these models' path, each behind a
``torch.autograd.Function`` whose forward is the kernel wrapper and
whose backward is the plain version's VJP by recompute (the JAX package
has no backward for either kernel):

  * DLRM's interaction (the strictly-lower triangle of Z·Zᵀ, the
    reference's einsum and ``np.tril_indices(F, -1)``) is the
    dot_interaction kernel; its backward is one ``bmm``.
  * SASRec's and BERT4Rec's attention is the flash_attention kernel on
    [B, H, L, e]. The reference divides the scores by √e and fills masked
    scores with -1e30; the kernel multiplies by the f32 1/√e and fills
    with the same -1e30. Its backward recomputes the softmax.

On CPU tensors both wrappers run their plain versions (``kernels.ref``).

On a mesh (``distributed.parallel.use_groups``, entered by
``launch.steps.build_cell(mesh=...)``) every table (``emb_*``,
``wide_*``, ``item_emb``) and sketch is this rank's block of "vocab"
rows, the batch leaves are this rank's batch rows, and every lookup is
the row-sharded one (:func:`row_lookup`, bitwise the one-card
lookup); the MLPs, ``pos_emb`` and the attention blocks are replicated
and run on the rank's rows, the kernels unchanged. A loss is the mean
(SASRec: the masked ratio) over the whole batch. The reference's
``shard(...)`` annotations are dropped: the layouts and the collectives
of the lookups place the data. Shapes (assigned): train_batch B=65536 |
serve_p99 B=512 | serve_bulk B=262144 | retrieval_cand B=1, C=1e6.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.distributed import parallel as par
from repro_torch.embedding import (EmbeddingEngine, EmbeddingSpec,
                                   embedding_block_lookup, get_backend)
from repro_torch.kernels import ref
from repro_torch.kernels.dot_interaction import dot_interaction as _dot_kernel
from repro_torch.kernels.flash_attention import (flash_attention as
                                                 _flash_kernel)

__all__ = ["DLRMConfig", "WideDeepConfig", "SASRecConfig", "BERT4RecConfig",
           "MLPERF_CRITEO_VOCABS", "pad_rows", "dlrm_init", "dlrm_forward",
           "dlrm_train_loss", "dlrm_retrieval", "widedeep_init",
           "widedeep_forward", "widedeep_train_loss", "widedeep_retrieval",
           "seqrec_init", "seqrec_encode", "sasrec_train_loss",
           "sasrec_score_candidates", "bert4rec_train_loss",
           "bert4rec_score_candidates", "interaction", "attention",
           "params_from_numpy", "flat_params", "row_lookup"]

# Criteo Terabyte cardinalities (MLPerf DLRM benchmark, day-based split).
MLPERF_CRITEO_VOCABS = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36)


# ---------------------------------------------------------------------------
# params: init, carriage from the reference, flat views
# ---------------------------------------------------------------------------
def _normal(shape, scale: float, generator, device):
    """f32 N(0, 1) * scale of ``shape`` drawn from ``generator`` on
    ``device``; on the "meta" device a shape only (nothing allocated)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device).mul_(scale)


def _init_device(generator, device):
    if device is not None:
        return torch.device(device)
    if generator is None:
        raise ValueError("give a generator or a device")
    return generator.device


def _init_lin(generator, i, o, device):
    return {"w": _normal((i, o), 1.0 / math.sqrt(i), generator, device),
            "b": torch.zeros((o,), dtype=torch.float32, device=device)}


def _init_mlp(generator, dims, device):
    return [_init_lin(generator, i, o, device)
            for i, o in zip(dims[:-1], dims[1:])]


def params_from_numpy(tree, device="cuda"):
    """A reference params tree (``jax.tree.map(np.asarray, params)``:
    nested dicts and lists of arrays) as the port's tree of f32/int
    tensors on ``device``, with the same keys and list order."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return torch.as_tensor(np.array(tree), device=device)


def flat_params(tree, prefix: str = "") -> dict:
    """{"a/0/w": tensor, ...}: the leaves of a params tree keyed by path,
    the same tensor objects (an in-place update of the flat view updates
    the tree)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_params(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat_params(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------
def _lin(p, x):
    return x @ p["w"] + p["b"]


def _mlp(params: Sequence[dict], x, act=torch.relu, last_act=False):
    for i, p in enumerate(params):
        x = _lin(p, x)
        if last_act or i < len(params) - 1:
            x = act(x)
    return x


def pad_rows(n: int, mult: int = 256) -> int:
    """Pad table rows to a multiple of the pod width (the reference's
    vocab padding; pad rows are dead)."""
    return ((n + mult - 1) // mult) * mult


def _table_rows(vocab: int, etc_ratio: Optional[float],
                compress_min: int) -> int:
    if etc_ratio is not None and vocab >= compress_min:
        return max(2, int(round(vocab * etc_ratio)))
    return vocab


def _field_lookup(table, ids, sketch=None, backend=None):
    """[..., d]; sketch int32[vocab, H] when the field is compressed.
    All lookups route through the EmbeddingEngine (backend-dispatched:
    the codebook_lookup kernel on a CUDA device)."""
    if sketch is not None:
        spec = EmbeddingSpec(n_rows=int(sketch.shape[0]),
                             dim=int(table.shape[-1]),
                             k_rows=int(table.shape[0]),
                             n_hot=int(sketch.shape[-1]))
    else:
        spec = EmbeddingSpec(n_rows=int(table.shape[0]),
                             dim=int(table.shape[-1]))
    return EmbeddingEngine(spec, backend=backend).lookup(table, ids.long(),
                                                         sketch=sketch)


def _check_ids(ids: torch.Tensor, n_rows: int) -> None:
    """Ids come from the caller, and a row-sharded lookup would give an
    id outside every block a zero row: raise instead (one host read)."""
    if ids.numel():
        lo, hi = torch.aminmax(ids.reshape(-1))
        if bool((lo < 0) | (hi >= n_rows)):
            raise ValueError(f"ids must lie in [0, {n_rows})")


def row_lookup(table: torch.Tensor, ids: torch.Tensor, rows: par.RowBlock,
               groups: par.RankGroups, sketch: Optional[torch.Tensor] = None,
               sketch_rows: Optional[par.RowBlock] = None,
               split: bool = True,
               backend: Optional[str] = None) -> torch.Tensor:
    """The row-sharded lookup: ``table`` and ``sketch`` are this rank's
    row blocks (``rows``, ``sketch_rows``) of a table and of its frozen
    sketch int32 [vocab, 1] (a compressed field), ``ids`` int [b, ...]
    this rank's batch rows (``split``) or ids the same on every data rank.
    Returns the ids' rows [b, ..., d] as the one-card lookup gives them.

      1. the ids of every data rank are all-gathered (when ``split``);
      2. a compressed field's codebook rows ``sketch[ids]``: each rank
         reads the ids of its sketch rows (a block lookup of the "gather"
         backend, other ids giving 0), and the ints are summed over the
         sketch's group;
      3. each rank looks up the rows of its block through the
         EmbeddingEngine (``block_lookup``: the codebook_lookup kernel on
         the card); ids outside the block give exact zeros;
      4. the ranks' rows are summed over the table's group and each rank
         keeps its batch rows (``parallel.sum_keep_rows``).
    Backward, the reverse: the cotangent of every data rank's rows is
    all-gathered (or, unsplit, summed) over the data ranks, and the
    block's own backward (the CSR gather-sum on the card, ids outside the
    block dropped) sums it into the rank's rows: the table's gradient is
    whole on every rank, with no all-reduce of its own.

    One rank owns each row, and every other rank adds an exact zero to
    it, so the rows looked up are bitwise the one-card lookup's on any
    mesh, and so is each row's gradient where the ids are split (the
    same global cotangents, summed in the same order). The sketch takes
    one codebook row an id (every recsys sketch does)."""
    split = split and groups.data_group is not None
    if split:
        ids = par.all_gather_cat(ids, groups.data_group, 0)
    if sketch is None:
        _check_ids(ids, rows.n_rows)
    else:
        if sketch.shape[-1] != 1:
            raise ValueError(f"the row-sharded lookup takes one codebook "
                             f"row an id, this sketch has {sketch.shape[-1]}")
        _check_ids(ids, sketch_rows.n_rows)
        ids = get_backend("gather").block(sketch, ids, sketch_rows.lo)
        if sketch_rows.group is not None:
            ids = par.all_reduce(ids, sketch_rows.group)
        ids = ids[..., 0]
    x = embedding_block_lookup(table, ids, rows.lo, backend=backend)
    return par.sum_keep_rows(x, rows.group, groups, split)


def _lookup(params, statics, key: str, ids, cfg, sketch_key=None,
            split: bool = True):
    """``params[key]``'s rows of ``ids``, through ``statics[sketch_key]``
    when the field is compressed. On a mesh, the row-sharded lookup
    (``split``: the ids are this rank's batch rows; else every data rank
    holds the same ids)."""
    table = params[key]
    sk = statics.get(sketch_key) if statics and sketch_key else None
    g = par.current_groups()
    if g is None:
        return _field_lookup(table, ids, sk, cfg.lookup_backend)
    return row_lookup(table, ids, g.rows[key], g, sketch=sk,
                      sketch_rows=g.rows.get(sketch_key), split=split,
                      backend=cfg.lookup_backend)


def _batch_mean(loss):
    """A mean over this rank's batch rows as the mean over the whole
    batch (on a mesh, over the data ranks' equal shares)."""
    g = par.current_groups()
    return loss if g is None else par.mean_over_data(loss, g)


def _bce(logits, labels):
    logits = logits.float()
    return _batch_mean(torch.mean(
        torch.clamp(logits, min=0) - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits)))))


# ---------------------------------------------------------------------------
# the two kernels on the path, with their backward by recompute
# ---------------------------------------------------------------------------
class _Interaction(torch.autograd.Function):
    """z [B, F, d] -> [B, F(F-1)/2] by the dot_interaction kernel;
    dz = (G + Gᵀ)·z with G the cotangent scattered into the strictly
    lower triangle."""

    @staticmethod
    def forward(ctx, z):
        ctx.save_for_backward(z)
        return _dot_kernel(z)

    @staticmethod
    def backward(ctx, g):
        (z,) = ctx.saved_tensors
        f = z.shape[1]
        i, j = torch.tril_indices(f, f, -1, device=z.device)
        full = g.new_zeros(z.shape[0], f, f)
        full[:, i, j] = g
        return torch.bmm(full + full.transpose(1, 2), z)


def interaction(z):
    """DLRM's dot interaction: z [B, F, d] -> [B, F(F-1)/2], per example
    the strictly-lower triangle of Z·Zᵀ in ``np.tril_indices(F, -1)``
    order, through the dot_interaction kernel (differentiable)."""
    return _Interaction.apply(z)


class _Attention(torch.autograd.Function):
    """softmax(q·kᵀ·s + fill)·v by the flash_attention kernel; the
    backward recomputes the plain version's softmax P and returns
    dq = dS·k·s, dk = dSᵀ·q·s, dv = Pᵀ·g with dS = P ⊙ (g·vᵀ - rowsum)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return _flash_kernel(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        scale = ref.attention_scale(q.shape[-1])
        s = torch.matmul(q, k.transpose(-1, -2)) * scale
        if ctx.causal:
            s = ref._causal_fill(s)
        p = torch.softmax(s, dim=-1)
        dv = torch.matmul(p.transpose(-1, -2), g)
        dp = torch.matmul(g, v.transpose(-1, -2))
        ds = p * (dp - (dp * p).sum(-1, keepdim=True))
        dq = torch.matmul(ds, k) * scale
        dk = torch.matmul(ds.transpose(-1, -2), q) * scale
        return dq, dk, dv, None


def attention(q, k, v, causal: bool):
    """q/k/v [B, H, L, e] f32 -> [B, H, L, e]: attention with scale
    1/√e, causal fill -1e30, through the flash_attention kernel
    (differentiable)."""
    return _Attention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                            bool(causal))


# ---------------------------------------------------------------------------
# DLRM
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-mlperf"
    n_dense: int = 13
    vocabs: Tuple[int, ...] = MLPERF_CRITEO_VOCABS
    embed_dim: int = 128
    bot_mlp: Tuple[int, ...] = (512, 256, 128)
    top_mlp: Tuple[int, ...] = (1024, 1024, 512, 256, 1)
    etc_ratio: Optional[float] = None       # BACO variant sets e.g. 0.25
    compress_min: int = 100_000
    dtype: str = "float32"
    lookup_backend: Optional[str] = None    # EmbeddingEngine override

    @property
    def n_sparse(self):
        return len(self.vocabs)

    def table_rows(self, f: int) -> int:
        return _table_rows(self.vocabs[f], self.etc_ratio, self.compress_min)

    def compressed_fields(self):
        return tuple(f for f in range(self.n_sparse)
                     if self.table_rows(f) != self.vocabs[f])


def dlrm_init(generator: Optional[torch.Generator], cfg: DLRMConfig,
              device=None):
    """Params on ``device`` (default: the generator's), drawn from
    ``generator`` in the reference's order of parts: bottom MLP, top MLP,
    then the tables (rows padded by ``pad_rows``). ``device="meta"``
    gives the shapes and allocates nothing."""
    dev = _init_device(generator, device)
    params = {"bot": _init_mlp(generator, (cfg.n_dense,) + cfg.bot_mlp, dev)}
    n_int = (cfg.n_sparse + 1) * cfg.n_sparse // 2
    params["top"] = _init_mlp(generator,
                              (cfg.bot_mlp[-1] + n_int,) + cfg.top_mlp, dev)
    for f in range(cfg.n_sparse):
        rows = pad_rows(cfg.table_rows(f))
        params[f"emb_{f}"] = _normal((rows, cfg.embed_dim),
                                     1.0 / math.sqrt(cfg.embed_dim),
                                     generator, dev)
    return params


def _dlrm_interact(x, embs):
    """[x | tril(Z·Zᵀ)] with Z = [x, e_0, ..., e_{F-1}] stacked [B, F+1, d]."""
    z = torch.stack([x] + list(embs), dim=1)
    return torch.cat([x, interaction(z)], dim=-1)


def _dlrm_features(params, statics, dense, sparse, cfg: DLRMConfig):
    x = _mlp(params["bot"], dense, last_act=True)            # [B, d]
    embs = [_lookup(params, statics, f"emb_{f}", sparse[:, f], cfg,
                    f"sketch_{f}") for f in range(cfg.n_sparse)]
    return _dlrm_interact(x, embs)


def dlrm_forward(params, statics, batch, cfg: DLRMConfig):
    feats = _dlrm_features(params, statics, batch["dense"], batch["sparse"],
                           cfg)
    return _mlp(params["top"], feats)[:, 0]


def dlrm_train_loss(params, statics, batch, cfg: DLRMConfig):
    return _bce(dlrm_forward(params, statics, batch, cfg), batch["label"])


def dlrm_retrieval(params, statics, batch, cfg: DLRMConfig):
    """Score C candidates of field 0 for ONE user context.

    batch: dense [1, 13], sparse [1, F], candidates int [C]. The bottom
    MLP and the 25 fixed fields are computed once and broadcast (the
    reference broadcasts the inputs and recomputes them per candidate:
    the same values)."""
    cands = batch["candidates"]
    c = cands.shape[0]
    x = _mlp(params["bot"], batch["dense"], last_act=True).expand(c, -1)
    embs = []
    for f in range(cfg.n_sparse):
        ids = cands if f == 0 else batch["sparse"][:, f]
        e = _lookup(params, statics, f"emb_{f}", ids, cfg, f"sketch_{f}",
                    split=f == 0)
        embs.append(e if f == 0 else e.expand(c, -1))
    return _mlp(params["top"], _dlrm_interact(x, embs))[:, 0]


# ---------------------------------------------------------------------------
# Wide & Deep
# ---------------------------------------------------------------------------
def _widedeep_vocabs(n_fields: int = 40) -> Tuple[int, ...]:
    # deterministic log-spaced cardinalities 1e3 .. 1e6
    return tuple(int(round(10 ** (3 + 3 * i / (n_fields - 1))))
                 for i in range(n_fields))


@dataclasses.dataclass(frozen=True)
class WideDeepConfig:
    name: str = "wide-deep"
    vocabs: Tuple[int, ...] = _widedeep_vocabs()
    embed_dim: int = 32
    mlp: Tuple[int, ...] = (1024, 512, 256)
    etc_ratio: Optional[float] = None
    compress_min: int = 100_000
    dtype: str = "float32"
    lookup_backend: Optional[str] = None

    @property
    def n_sparse(self):
        return len(self.vocabs)

    def table_rows(self, f):
        return _table_rows(self.vocabs[f], self.etc_ratio, self.compress_min)

    def compressed_fields(self):
        return tuple(f for f in range(self.n_sparse)
                     if self.table_rows(f) != self.vocabs[f])


def widedeep_init(generator: Optional[torch.Generator], cfg: WideDeepConfig,
                  device=None):
    """As :func:`dlrm_init`: the deep MLP, then each field's table (the
    wide tables are zeros)."""
    dev = _init_device(generator, device)
    params = {"deep": _init_mlp(
        generator, (cfg.n_sparse * cfg.embed_dim,) + cfg.mlp + (1,), dev),
        "bias": torch.zeros((), dtype=torch.float32, device=dev)}
    for f in range(cfg.n_sparse):
        rows = pad_rows(cfg.table_rows(f))
        params[f"emb_{f}"] = _normal((rows, cfg.embed_dim),
                                     1.0 / math.sqrt(cfg.embed_dim),
                                     generator, dev)
        params[f"wide_{f}"] = torch.zeros((rows, 1), dtype=torch.float32,
                                          device=dev)
    return params


def widedeep_forward(params, statics, batch, cfg: WideDeepConfig):
    sparse = batch["sparse"]
    embs, wide = [], params["bias"]
    for f in range(cfg.n_sparse):
        embs.append(_lookup(params, statics, f"emb_{f}", sparse[:, f], cfg,
                            f"sketch_{f}"))
        wide = wide + _lookup(params, statics, f"wide_{f}", sparse[:, f],
                              cfg, f"sketch_{f}")[:, 0]
    deep = _mlp(params["deep"], torch.cat(embs, dim=-1))[:, 0]
    return wide + deep


def widedeep_train_loss(params, statics, batch, cfg):
    return _bce(widedeep_forward(params, statics, batch, cfg), batch["label"])


def widedeep_retrieval(params, statics, batch, cfg: WideDeepConfig):
    cands = batch["candidates"]
    c = cands.shape[0]
    sparse = batch["sparse"].expand(c, cfg.n_sparse).clone()
    sparse[:, 0] = cands
    return widedeep_forward(params, statics, {"sparse": sparse}, cfg)


# ---------------------------------------------------------------------------
# sequential recommenders: SASRec (causal) and BERT4Rec (bidirectional)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SASRecConfig:
    name: str = "sasrec"
    n_items: int = 1_000_000
    embed_dim: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    seq_len: int = 50
    etc_ratio: Optional[float] = None
    dtype: str = "float32"
    causal: bool = True
    lookup_backend: Optional[str] = None

    @property
    def table_rows(self):
        if self.etc_ratio is None:
            return self.n_items
        return max(2, int(round(self.n_items * self.etc_ratio)))


@dataclasses.dataclass(frozen=True)
class BERT4RecConfig(SASRecConfig):
    name: str = "bert4rec"
    embed_dim: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    seq_len: int = 200
    causal: bool = False
    n_mask: int = 30             # masked positions per sequence
    n_neg: int = 4096            # shared sampled-softmax negatives


def seqrec_init(generator: Optional[torch.Generator], cfg: SASRecConfig,
                device=None):
    """As :func:`dlrm_init`: the item table, the positions, then each
    block's weights."""
    dev = _init_device(generator, device)
    d = cfg.embed_dim
    params = {
        "item_emb": _normal((pad_rows(cfg.table_rows), d), 1.0 / math.sqrt(d),
                            generator, dev),
        "pos_emb": _normal((cfg.seq_len, d), 0.02, generator, dev),
        "blocks": [],
    }
    for _ in range(cfg.n_blocks):
        params["blocks"].append({
            "wqkv": _normal((d, 3 * d), 1.0 / math.sqrt(d), generator, dev),
            "wo": _normal((d, d), 1.0 / math.sqrt(d), generator, dev),
            "ln1": torch.ones((d,), dtype=torch.float32, device=dev),
            "ln2": torch.ones((d,), dtype=torch.float32, device=dev),
            "ff1": _init_lin(generator, d, 4 * d, dev),
            "ff2": _init_lin(generator, 4 * d, d, dev),
        })
    return params


def _ln(x, scale, eps=1e-6):
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + eps) * scale


def _item_lookup(params, statics, ids, cfg, split: bool = True):
    return _lookup(params, statics, "item_emb", ids, cfg, "sketch_items",
                   split)


def seqrec_encode(params, statics, seq_ids, cfg: SASRecConfig):
    """[B, L] item ids -> [B, L, d] contextual states."""
    b, l = seq_ids.shape
    d, h = cfg.embed_dim, cfg.n_heads
    x = _item_lookup(params, statics, seq_ids, cfg) + params["pos_emb"][:l]
    for blk in params["blocks"]:
        hx = _ln(x, blk["ln1"])
        qkv = hx @ blk["wqkv"]
        q, k, v = (t.reshape(b, l, h, d // h).transpose(1, 2)
                   for t in torch.split(qkv, d, dim=-1))
        o = attention(q, k, v, cfg.causal)              # [B, H, L, e]
        x = x + o.transpose(1, 2).reshape(b, l, d) @ blk["wo"]
        hx = _ln(x, blk["ln2"])
        x = x + _lin(blk["ff2"], torch.relu(_lin(blk["ff1"], hx)))
    return x


def sasrec_train_loss(params, statics, batch, cfg: SASRecConfig):
    """Next-item BPR: input seq[:-1] predicts seq[1:], one neg/position."""
    seq = batch["seq"]                       # [B, L]
    neg = batch["neg"]                       # [B, L-1]
    hs = seqrec_encode(params, statics, seq[:, :-1], cfg)  # [B, L-1, d]
    pos_e = _item_lookup(params, statics, seq[:, 1:], cfg)
    neg_e = _item_lookup(params, statics, neg, cfg)
    ps = torch.sum(hs * pos_e, -1)
    ns = torch.sum(hs * neg_e, -1)
    valid = (seq[:, 1:] > 0).float()
    loss = (-torch.nn.functional.logsigmoid(ps - ns) * valid).sum()
    valid = valid.sum()
    g = par.current_groups()
    if g is not None:                 # the ratio of the whole batch's sums
        loss, valid = par.sum_over_data(loss, g), par.sum_over_data(valid, g)
    return loss / torch.clamp(valid, min=1.0)


def sasrec_score_candidates(params, statics, batch, cfg: SASRecConfig):
    """serve: encode sequences, score given candidates [B, C]."""
    hs = seqrec_encode(params, statics, batch["seq"], cfg)[:, -1]   # [B, d]
    cand_e = _item_lookup(params, statics, batch["candidates"], cfg)
    return torch.einsum("bd,bcd->bc", hs, cand_e)


def bert4rec_train_loss(params, statics, batch, cfg: BERT4RecConfig):
    """Masked-item prediction with shared sampled-softmax negatives."""
    hs = seqrec_encode(params, statics, batch["seq"], cfg)   # [B, L, d]
    tgt_pos = batch["target_pos"].long()     # [B, M]
    hm = torch.gather(hs, 1, tgt_pos[..., None].expand(-1, -1, hs.shape[-1]))
    pos_e = _item_lookup(params, statics, batch["target_ids"], cfg)
    neg_e = _item_lookup(params, statics, batch["neg_ids"], cfg,
                         split=False)                           # [N, d]
    pos_logit = torch.sum(hm * pos_e, -1, keepdim=True)       # [B, M, 1]
    neg_logit = torch.einsum("bmd,nd->bmn", hm, neg_e)        # [B, M, N]
    logits = torch.cat([pos_logit, neg_logit], dim=-1)
    lse = torch.logsumexp(logits.float(), dim=-1)
    return _batch_mean(torch.mean(lse - pos_logit[..., 0]))


def bert4rec_score_candidates(params, statics, batch, cfg: BERT4RecConfig):
    """serve: hidden state at the (single) masked slot vs candidates."""
    hs = seqrec_encode(params, statics, batch["seq"], cfg)
    pos = batch["target_pos"].long()[:, None, None].expand(-1, 1,
                                                           hs.shape[-1])
    hm = torch.gather(hs, 1, pos)[:, 0]                      # [B, d]
    cand_e = _item_lookup(params, statics, batch["candidates"], cfg)
    return torch.einsum("bd,bcd->bc", hm, cand_e)
