"""The LM family of the port (``models/transformer.py``, the LM configs,
the LM half of ``launch/steps.py``), dense and MoE, against the JAX
package, on the CPU at the smoke configs, with the reference's params
carried over (``transformer.params_from_numpy``) and the reference's
token lookup on its "gather" backend.

  * Draws: each LM arch's train, prefill and decode smoke cells draw
    bitwise the reference's ``_materialize(cell.args)``.
  * Prefill: logits and cache within rtol 1e-4 / atol 1e-5 (f32).
    Decode: logits and the updated cache, the same. Training: the loss
    and every gradient within rtol 1e-4 / atol 1e-6 of one jitted
    ``jax.value_and_grad``, and the params after one AdamW step within
    rtol 1e-4 / atol 1e-6 of the reference's AdamW on the port's
    gradients (Adam's first step turns any nonzero gradient into about
    lr, so a gradient that is rounding in one package and 0 in the other
    would differ by lr; the update is held on the same gradients).
    Each again with tokens over the whole vocabulary and ``pos`` > 0.
  * bf16: gemma2's residual stream is f32 in both packages (the
    reference's ``x * np.sqrt(d)``), qwen's bf16; prefill logits within
    rtol 2e-2 / atol 2e-2 (a bf16 rounding of the weights' products).
  * The reference's own transformer tests (``tests/test_models.py``),
    on the port: decode == forward for both patterns, banded == masked
    full attention, the fp8 cache round trip, the param count.
  * fp8 at its edges: ``to_kv`` equals ``jnp.astype(float8_e4m3fn)``
    around ±448, ±464 and ±inf (NaN where ml_dtypes gives NaN).
  * codebook_lookup at 16 bits: the plain version at bf16 and f16, H 1
    and 2, binary or not, equals the reference's Pallas kernel in
    interpret mode bitwise.
  * The MoE FFN (dbrx-132b, kimi-k2-1t-a32b) against the reference's
    ``_mlp_moe``: the routed expert ids (planted exact ties among the
    router's logits included) and the kept/dropped mask bitwise, at a
    capacity that drops too; the output within f32 rounding. Its bf16
    token combine sums in f32 and rounds once (ROADMAP Queue 3 #9).
    The optimizer rule: Adafactor for kimi-k2's 384 experts, AdamW for
    dbrx's 16.
  * Entry points: full width without CUDA raises, the serve and train
    CLIs run the smoke cells, the sharded trainer names its ROADMAP
    item.
"""
import dataclasses
import functools
import importlib
import importlib.util
import math
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as ref_registry  # noqa: E402
from repro.kernels.codebook_lookup import codebook_lookup_pallas  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.embedding import embedding_lookup  # noqa: E402
from repro_torch.kernels import codebook_lookup  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import recsys as rs  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

# the reference's registry loads no config module once any has registered
# (another test file may have imported one alone): register them all
for _m in ref_registry._MODULES:
    importlib.import_module(f"repro.configs.{_m}")

ARCHS = ("gemma2-9b", "gemma3-12b", "qwen1.5-32b", "dbrx-132b",
         "kimi-k2-1t-a32b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
TOKENS = ("drawn", "vocab")        # the smoke draws; tokens over the vocab


def _path(keys) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in keys)


def _ref_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path(p): np.asarray(x, dtype=np.float32) for p, x in flat}


@functools.lru_cache(maxsize=None)
def _ref_cell(arch, shape):
    return ref_steps.build_cell(arch, shape, smoke=True,
                                lookup_backend="gather")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _ref_inputs(arch, shape, tokens):
    """The reference cell's (params, batch[, cache]) as numpy, with the
    tokens (and pos) replaced by draws over the whole vocabulary for
    ``tokens == "vocab"``."""
    ref = _ref_cell(arch, shape)
    args = _np(ref.args)
    if tokens == "vocab":
        rng = np.random.default_rng(7)
        vocab = ref_registry.get_arch(arch).smoke_config().vocab_size
        b = dict(args[-1])
        for k in ("tokens", "targets"):
            if k in b:
                b[k] = rng.integers(0, vocab, b[k].shape).astype(np.int32)
        if "pos" in b:
            b["pos"] = np.asarray(21, np.int32)
        args = args[:-1] + (b,)
    return args


def _to_jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _port(tree):
    return T.params_from_numpy(tree, "cpu")


def _cfg(arch):
    return registry.get_arch(arch).smoke_config()


def _close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# registry, draws, full width
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_params_equal_eval_shape(arch):
    """The published configs' param tree (shapes and dtypes) equals
    ``jax.eval_shape`` of the reference's init, reckoned on the meta
    device; the one-card cuts fit an 80 GB H100: a serving cut's bf16
    params and cache, a train cut's bf16 params, its gradient
    accumulator (at the reference's rule on the cut config), one
    microbatch's bf16 gradients and its optimizer's state."""
    cfg = registry.get_arch(arch).full_config()
    want = jax.eval_shape(
        functools.partial(RT.init_params,
                          cfg=ref_registry.get_arch(arch).full_config()),
        jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(want)
    want = {_path(p): (tuple(x.shape), x.dtype.name) for p, x in flat}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in rs.flat_params(
               T.init_params(None, cfg, device="meta")).items()}
    assert got == want
    assert T.count_params(cfg) == RT.count_params(
        ref_registry.get_arch(arch).full_config())
    for (a, shape), cut in steps.LM_ONE_CARD.items():
        if a != arch:
            continue
        c = dataclasses.replace(cfg, n_layers=cut.get("n_layers",
                                                      cfg.n_layers))
        n = T.count_params(c)
        if shape == "train_4k":
            acc = steps.lm_acc_dtype(steps.lm_fsdp(c))
            _, opt = steps._lm_optimizer(c)
            state = opt.init(rs.flat_params(
                T.init_params(None, c, device="meta")))
            nbytes = n * (2 + acc.itemsize + 2) + sum(
                t.numel() * t.element_size() for t in
                jax.tree_util.tree_leaves(state) if torch.is_tensor(t))
        else:
            seq = registry.get_arch(a).shape(shape).dims["seq_len"]
            cache = T.init_cache(c, cut["batch"], seq, device="meta")
            nbytes = n * 2 + sum(t.numel() * t.element_size()
                                 for t in cache.values())
        assert nbytes < 65e9, (a, shape, nbytes)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_draws_equal_the_reference_bitwise(arch, shape):
    cell = steps.build_cell(arch, shape, smoke=True, device="cpu")
    ref = _ref_cell(arch, shape)
    assert cell.kind == ref.kind and cell.donate == ref.donate
    assert cell.reduced == ()
    drawn = [(cell.args[-1], ref.args[-1])]
    if cell.kind == "decode":
        drawn.append((cell.args[1], ref.args[1]))
    for got, want in drawn:
        assert set(got) == set(want)
        for k, v in want.items():
            v = np.asarray(v)
            assert got[k].numpy().dtype == v.dtype, k
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_build_cell_full_width_raises_without_cuda():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA"):
        steps.build_cell("gemma2-9b", "decode_32k")
    with pytest.raises(TypeError, match="no cuts"):
        steps.build_cell("sasrec", "serve_p99", smoke=True, device="cpu",
                         batch=2)


def test_moe_raises_naming_the_roadmap():
    """The MoE FFN is ported: a dense config given a MoE gets the
    reference's expert params and runs prefill and decode, as do the two
    MoE archs' smoke cells; the sharded trainer backend is a registered
    name."""
    from repro_torch.training.train_loop import normalize_trainer_backend

    cfg = dataclasses.replace(_cfg("qwen1.5-32b"), moe=T.MoEConfig(4, 2))
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    n = cfg.n_layers
    assert params["blocks"]["w_gate"].shape == (n, 1, 4, 64, 128)
    assert params["blocks"]["router"].shape == (n, 1, 64, 4)
    tok = torch.zeros((2, 8), dtype=torch.int32)
    logits, cache = T.prefill(params, {"tokens": tok}, cfg, max_seq=9)
    logits2, _ = T.decode_step(params, cache, {"tokens": tok[:, :1],
                                               "pos": torch.tensor(8)}, cfg)
    assert bool(torch.isfinite(logits).all() & torch.isfinite(logits2).all())
    for arch in ("dbrx-132b", "kimi-k2-1t-a32b"):
        cell = steps.build_cell(arch, "decode_32k", smoke=True, device="cpu")
        assert bool(torch.isfinite(cell.fn(*cell.args)[0]).all())
    assert normalize_trainer_backend("fused_sharded") == "fused_sharded"


def test_smoke_cells_cut_and_list_their_cuts():
    cell = steps.build_cell("gemma3-12b", "decode_32k", smoke=True,
                            device="cpu", batch=2, n_layers=12)
    assert cell.reduced == ("global_batch 4 -> 2", "n_layers 6 -> 12")
    assert cell.args[1]["k_local"].shape == (2, 5, 2, 8, 2, 16)
    assert cell.args[2]["tokens"].shape == (2, 1)


# ---------------------------------------------------------------------------
# prefill, decode and training on the reference's params
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _ref_out(arch, shape, tokens):
    ref = _ref_cell(arch, shape)
    return _np(jax.jit(ref.fn)(*_to_jnp(_ref_inputs(arch, shape, tokens))))


@pytest.mark.parametrize("tokens", TOKENS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_equals_the_reference(arch, tokens):
    params, batch = _ref_inputs(arch, "prefill_32k", tokens)
    cell = steps.build_cell(arch, "prefill_32k", smoke=True, device="cpu")
    logits, cache = cell.fn(_port(params), _port(batch))
    want_logits, want_cache = _ref_out(arch, "prefill_32k", tokens)
    assert logits.dtype == torch.float32
    _close(logits, want_logits, 1e-4, 1e-5, "logits")
    assert set(cache) == set(want_cache)
    for k, v in want_cache.items():
        assert tuple(cache[k].shape) == v.shape, k
        _close(cache[k], v, 1e-4, 1e-5, k)


@pytest.mark.parametrize("tokens", TOKENS)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_equals_the_reference(arch, tokens):
    params, cache, batch = _ref_inputs(arch, "decode_32k", tokens)
    cell = steps.build_cell(arch, "decode_32k", smoke=True, device="cpu")
    args = (_port(params), _port(cache), _port(batch))
    logits, new_cache = cell.fn(*args)
    assert new_cache is args[1]                 # updated in place
    assert cell.next_args(args, (logits, new_cache))[1] is new_cache
    want_logits, want_cache = _ref_out(arch, "decode_32k", tokens)
    _close(logits, want_logits, 1e-4, 1e-5, "logits")
    for k, v in want_cache.items():
        _close(new_cache[k], v, 1e-4, 1e-5, k)


@functools.lru_cache(maxsize=None)
def _ref_train(arch, tokens):
    params, _, batch = _to_jnp(_ref_inputs(arch, "train_4k", tokens))
    cfg = ref_registry.get_arch(arch).smoke_config()
    cfg = dataclasses.replace(cfg, lookup_backend="gather")
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: RT.train_loss(p, b, cfg)))(params, batch)
    return float(loss), _ref_flat(grads)


def _ref_adamw_step(arch, tokens, grads: dict) -> dict:
    """The reference's AdamW update (its train cell's optimizer) of its
    params and fresh state on ``grads`` (flat, by path), flat."""
    params, opt_state, _ = _to_jnp(_ref_inputs(arch, "train_4k", tokens))
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    tree = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(grads[_path(p)]) for p, _ in flat])
    _, opt = ref_steps._lm_optimizer(_cfg(arch))
    new_params, _ = opt.update(tree, opt_state, params)
    return _ref_flat(new_params)


@pytest.mark.parametrize("tokens", TOKENS)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_equals_the_reference(arch, tokens):
    params, _, batch = _ref_inputs(arch, "train_4k", tokens)
    cell = steps.build_cell(arch, "train_4k", smoke=True, device="cpu")
    assert cell.notes == ("optimizer=adamw,microbatches=1,"
                          "accumulator=float32")
    p = _port(params)
    b = _port(batch)
    cfg = _cfg(arch)
    want_loss, want_g = _ref_train(arch, tokens)
    flat = rs.flat_params(p)
    leaves = [t.requires_grad_(True) for t in flat.values()]
    loss = T.train_loss(p, b, cfg)
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-4)
    assert set(flat) == set(want_g)
    for k, g in zip(flat, grads):
        _close(g, want_g[k], 1e-4, 1e-6, k)
    want_p = _ref_adamw_step(arch, tokens,
                             {k: g.numpy() for k, g in zip(flat, grads)})
    opt_state = steps._lm_optimizer(cfg)[1].init(flat)
    _, _, step_loss = cell.fn(p, opt_state, b)
    np.testing.assert_allclose(float(step_loss), want_loss, rtol=1e-4)
    for k, t in rs.flat_params(p).items():
        _close(t, want_p[k], 1e-4, 1e-6, k)


def test_train_microbatches_average_the_full_batch():
    """The microbatch rule: the mean of n equal microbatches' losses and
    gradients is the full batch's (the loss divides by b * s)."""
    cfg = _cfg("gemma2-9b")
    cell = steps.build_cell("gemma2-9b", "train_4k", smoke=True,
                            device="cpu")
    p0, _, b = cell.args
    _, opt = steps._lm_optimizer(cfg)
    outs = []
    for n in (1, 2):
        p = {k: (dict((kk, vv.clone()) for kk, vv in v.items())
                 if isinstance(v, dict) else v.clone())
             for k, v in p0.items()}
        state = opt.init(rs.flat_params(p))
        step = steps._LMTrainStep(cfg, opt, n, torch.float32)
        outs.append(step(p, state, b))
    torch.testing.assert_close(outs[1][2], outs[0][2], rtol=1e-5, atol=0)
    for k, v in rs.flat_params(outs[0][0]).items():
        torch.testing.assert_close(rs.flat_params(outs[1][0])[k], v,
                                   rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# bf16: the reference's f32 promotion
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,stream", [("gemma2-9b", "float32"),
                                         ("qwen1.5-32b", "bfloat16")])
def test_bf16_activation_dtypes_and_prefill(arch, stream):
    rcfg = dataclasses.replace(ref_registry.get_arch(arch).smoke_config(),
                               dtype="bfloat16", lookup_backend="gather")
    cfg = dataclasses.replace(_cfg(arch), dtype="bfloat16")
    params = RT.init_params(jax.random.PRNGKey(0), rcfg)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    pos = jnp.broadcast_to(jnp.arange(16), (2, 16))
    h = jax.eval_shape(lambda p, t, ps: RT._backbone(p, t, rcfg, ps),
                       params, jnp.asarray(tokens), pos)
    assert h.dtype.name == stream
    p = _port(_np(params))
    assert p["embed"].dtype == torch.bfloat16
    t = torch.as_tensor(tokens)
    got_h = T._backbone(p, t, cfg, T._positions(2, 16, "cpu"))
    assert str(got_h.dtype) == f"torch.{stream}"
    logits, cache = T.prefill(p, {"tokens": t}, cfg, max_seq=16)
    # the reference's layers op by op (each jnp op rounds to bf16 as the
    # port's torch ops do)
    x = RT.embedding_lookup(params["embed"], jnp.asarray(tokens),
                            backend="gather").astype(rcfg.jdtype)
    if rcfg.embed_scale:
        x = x * np.sqrt(rcfg.d_model)
    for bi in range(rcfg.n_blocks):
        x = RT._block(x, jax.tree.map(lambda a: a[bi], params["blocks"]),
                      rcfg, pos)
    h = RT.rms_norm(x[:, -1:], params["final_norm"])
    _close(logits, RT._logits(params, h, rcfg)[:, 0], 2e-2, 2e-2, "logits")
    # its compiled prefill: inside the scan XLA's f32 dots sum in another
    # order before each bf16 rounding, which moves a logit by up to ~2 bf16
    # ulps at |logit| ~2 (0.016 each): atol 4e-2
    want_logits, want_cache = _np(jax.jit(functools.partial(
        RT.prefill, cfg=rcfg, max_seq=16))(params, {"tokens": tokens}))
    _close(logits, want_logits, 2e-2, 4e-2, "logits")
    for k, v in want_cache.items():
        assert cache[k].dtype == torch.bfloat16 and v.dtype.name == "bfloat16"
        _close(cache[k], v, 2e-2, 4e-2, k)


# ---------------------------------------------------------------------------
# the reference's transformer tests (tests/test_models.py), on the port
# ---------------------------------------------------------------------------
def _tiny(pattern, window, **kw):
    return dict(name="t", n_layers=2 * len(pattern), d_model=32, n_heads=4,
                n_kv_heads=2, d_ff=64, vocab_size=97, block_pattern=pattern,
                window=window, dtype="float32", q_chunk=4, loss_chunk=4,
                remat=False, **kw)


@pytest.mark.parametrize("pattern,window", [(("global",), 64),
                                            (("local", "global"), 8)])
def test_decode_matches_forward(pattern, window):
    """Prefill s tokens then decode token s == the full forward's last
    logits (2e-4), on the port; and both equal the reference's on its
    params."""
    kw = _tiny(pattern, window)
    cfg, rcfg = T.TransformerConfig(**kw), RT.TransformerConfig(**kw)
    rparams = RT.init_params(jax.random.PRNGKey(0), rcfg)
    params = _port(_np(rparams))
    rng = np.random.default_rng(0)
    s = 12
    tokens = torch.as_tensor(rng.integers(0, 97, (2, s + 1)),
                             dtype=torch.int32)
    h = T._backbone(params, tokens, cfg, T._positions(2, s + 1, "cpu"))
    ref_logits = T._logits(params, h[:, -1:], cfg)[:, 0]
    _, cache = T.prefill(params, {"tokens": tokens[:, :s]}, cfg,
                         max_seq=s + 4)
    dec, _ = T.decode_step(params, cache, {"tokens": tokens[:, s:s + 1],
                                           "pos": torch.tensor(s)}, cfg)
    _close(dec, ref_logits.numpy(), 2e-4, 2e-4)
    jt = jnp.asarray(tokens.numpy())
    rh = RT._backbone(rparams, jt, rcfg,
                      jnp.broadcast_to(jnp.arange(s + 1), (2, s + 1)))
    _close(ref_logits, RT._logits(rparams, rh[:, -1:], rcfg)[:, 0],
           1e-4, 1e-5)


def test_banded_local_attention_matches_masked_full():
    rng = np.random.default_rng(1)
    q, k, v = (torch.as_tensor(rng.standard_normal((1, 32, 2, 16)),
                               dtype=torch.float32) for _ in range(3))
    banded = T.chunked_attention(q, k, v, window=8, q_chunk=8)
    full = T.chunked_attention(q, k, v, window=8, q_chunk=32)
    torch.testing.assert_close(banded, full, rtol=1e-5, atol=1e-6)
    want = RT.chunked_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                window=8, q_chunk=8)
    _close(banded, want, 1e-5, 1e-6)


def test_kv_cache_dtype_fp8_roundtrip():
    cfg = T.TransformerConfig(
        name="f8", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2,
        d_ff=32, vocab_size=64, dtype="float32",
        kv_cache_dtype="float8_e4m3fn", q_chunk=4, loss_chunk=4,
        remat=False)
    cache = T.init_cache(cfg, batch=1, max_seq=8, device="cpu")
    assert cache["k_global"].dtype == torch.float8_e4m3fn
    params = T.init_params(torch.Generator().manual_seed(3), cfg)
    logits, cache2 = T.decode_step(
        params, cache, {"tokens": torch.tensor([[5]], dtype=torch.int32),
                        "pos": torch.tensor(0, dtype=torch.int32)}, cfg)
    assert bool(torch.isfinite(logits).all())
    assert cache2["k_global"].dtype == torch.float8_e4m3fn
    assert bool(cache2["k_global"][0, 0, 0, 0].float().abs().sum() > 0)


def test_entries_sum_gemms_in_f32_and_restore_the_flags(monkeypatch):
    """prefill, decode_step and train_loss run with TF32 and cuBLAS's
    reduced-precision bf16 reduction off, and restore both after."""
    mm = torch.backends.cuda.matmul
    cfg = T.TransformerConfig(name="p", n_layers=1, d_model=16, n_heads=2,
                              n_kv_heads=1, d_ff=32, vocab_size=64,
                              dtype="float32", q_chunk=4, loss_chunk=4,
                              remat=False)
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    seen = []
    norm = T.rms_norm

    def spy(*a, **k):
        seen.append((mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction))
        return norm(*a, **k)

    monkeypatch.setattr(T, "rms_norm", spy)
    tok = torch.zeros((1, 4), dtype=torch.int32)
    saved = (mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction)
    mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction = True, True
    try:
        _, cache = T.prefill(params, {"tokens": tok}, cfg, max_seq=8)
        T.decode_step(params, cache, {"tokens": tok[:, :1],
                                      "pos": torch.tensor(4)}, cfg)
        T.train_loss(params, {"tokens": tok, "targets": tok}, cfg)
        after = (mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction)
    finally:
        mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction = saved
    assert seen and set(seen) == {(False, False)}
    assert after == (True, True)


def test_param_count_matches_shapes():
    cfg = T.TransformerConfig(name="c", n_layers=2, d_model=16, n_heads=2,
                              n_kv_heads=1, d_ff=32, vocab_size=64,
                              dtype="float32")
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    total = sum(t.numel() for t in rs.flat_params(params).values())
    assert total == T.count_params(cfg)


@pytest.mark.parametrize("window,q_chunk,s", [(None, 4, 12), (8, 4, 12),
                                              (3, 5, 12), (8, 16, 16)])
def test_chunked_attention_equals_the_reference(window, q_chunk, s):
    """Global, banded, ragged (single-shot) and one-chunk attention with a
    softcap, f32, on the reference's inputs."""
    rng = np.random.default_rng(4)
    qkv = [rng.standard_normal((2, s, 4, 8)).astype(np.float32)
           for _ in range(3)]
    got = T.chunked_attention(*map(torch.as_tensor, qkv), window=window,
                              softcap=5.0, q_chunk=q_chunk)
    want = RT.chunked_attention(*map(jnp.asarray, qkv), window=window,
                                softcap=5.0, q_chunk=q_chunk)
    _close(got, want, 1e-5, 1e-6)


def test_gqa_expand_order_equals_the_reference():
    k = np.random.default_rng(5).standard_normal((2, 3, 2, 4)).astype(
        np.float32)
    np.testing.assert_array_equal(T.expand_kv(torch.as_tensor(k), 6).numpy(),
                                  np.asarray(RT.expand_kv(jnp.asarray(k), 6)))


# ---------------------------------------------------------------------------
# fp8 at its edges; codebook_lookup at 16 bits
# ---------------------------------------------------------------------------
def test_to_kv_fp8_equals_jax_astype_at_the_edges():
    edges = [0.0, -0.0, 0.0019, 1e-4, 1.0, 240.0, 447.0, 448.0, 449.0,
             456.0, 463.0, 463.99, 464.0, 465.0, 470.0, 480.0, 500.0, 1e6,
             math.inf]
    x = np.array(edges + [-e for e in edges] + [math.nan], np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn)).astype(
        np.float32)
    got = T.to_kv(torch.as_tensor(x), torch.float8_e4m3fn)
    assert got.dtype == torch.float8_e4m3fn
    got = got.float().numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[ok].view(np.uint32),
                                  want[ok].view(np.uint32))
    assert got[edges.index(464.0)] == 448 and np.isnan(got[edges.index(465.0)])
    assert got[edges.index(449.0)] == 448
    for dt in (torch.bfloat16, torch.float32):     # other caches: a cast
        assert torch.equal(T.to_kv(torch.as_tensor(x[:5]), dt),
                           torch.as_tensor(x[:5]).to(dt))


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("h", [1, 2])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_codebook_lookup_16bit_equals_the_pallas_kernel(dtype, h, binary):
    rng = np.random.default_rng(11)
    z = jnp.asarray(rng.standard_normal((37, 24)) * 3, dtype)
    idx = rng.integers(0, 37, (50, h)).astype(np.int32)
    if h > 1:
        idx[::4, 1] = idx[::4, 0]                 # duplicates
    want = np.asarray(codebook_lookup_pallas(z, jnp.asarray(idx),
                                             binary=binary, interpret=True))
    zt = T.tensor_from_numpy(np.asarray(z), "cpu")
    got = kref.codebook_lookup(zt, torch.as_tensor(idx), binary=binary)
    assert got.dtype == zt.dtype
    wrapped = codebook_lookup(zt, torch.as_tensor(idx), binary=binary)
    assert torch.equal(wrapped, got)
    bits = np.uint16
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(bits),
                                  want.view(bits))


# ---------------------------------------------------------------------------
# 16-bit training: the CSR gather-sum backward, the accumulator
# ---------------------------------------------------------------------------
def _skewed_ids(n=3000, rows=64, hot=1500, seed=0):
    """``n`` ids over ``rows`` rows, id 0 ``hot`` times (a frequent
    token), the rest uniform over 1..39, and a bf16 cotangent [n, 8]."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 40, n).astype(np.int32)
    ids[rng.permutation(n)[:hot]] = 0
    g = rng.standard_normal((n, 8)).astype(np.float32)
    return ids, np.asarray(jnp.asarray(g, jnp.bfloat16)), rows


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_16bit_lookup_gradient_rounds_once(dtype):
    """The token lookup's gradient at 16 bits, on a skewed draw (one id
    1,500 times). The reference (``jax.ops.segment_sum`` of a bf16 / f16
    cotangent on XLA's CPU) rounds after every add; the port's CSR
    gather-sum sums in f32 in index order and rounds once (ROADMAP
    Queue 3). Held: the port equals that f32 sum rounded once, bitwise;
    it lies within half an ulp of the exact sum (2^-8 relative for bf16,
    2^-11 for f16) plus the f32 sum's n x 2^-24 x max|partial sum|; the
    two packages differ by at most (n_r + 1) x u x max_k |S_k| on a row
    of n_r adds (u the format's unit roundoff, S_k the partial sums in
    index order), and the reference's error on the hot row is the larger.
    Pinned (bf16, row 0, column 0): reference 29.75, port 37.5, exact
    37.50198..."""
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    u = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}[dtype]
    ids, g16, rows = _skewed_ids()
    g = np.asarray(jnp.asarray(g16, jdt)).astype(np.float64)
    want = np.asarray(jax.jit(lambda x, i: jax.ops.segment_sum(
        x, i, num_segments=rows))(jnp.asarray(g, jdt), jnp.asarray(ids))
        .astype(jnp.float32), np.float64)
    table = torch.zeros(rows, 8, dtype=tdt, requires_grad=True)
    embedding_lookup(table, torch.as_tensor(ids), backend="cuda").backward(
        torch.as_tensor(g.astype(np.float32)).to(tdt))
    got = table.grad
    assert got.dtype == tdt
    once = np.zeros((rows, 8), np.float32)
    np.add.at(once, ids, g.astype(np.float32))            # index order
    assert torch.equal(got, torch.as_tensor(once).to(tdt))
    got = got.double().numpy()
    exact = np.zeros((rows, 8))
    np.add.at(exact, ids, g)
    peak = np.zeros((rows, 8))                 # max_k |S_k| over each row
    part = np.zeros((rows, 8))
    for i, row in zip(ids, g):
        part[i] += row
        peak[i] = np.maximum(peak[i], np.abs(part[i]))
    n_r = np.bincount(ids, minlength=rows)[:, None]
    assert bool((np.abs(got - exact)
                 <= u * np.abs(exact) + n_r * 2.0 ** -24 * peak * 1.01).all())
    assert bool((np.abs(want - got) <= (n_r + 1) * u * peak).all())
    assert np.abs(want[0] - exact[0]).max() > np.abs(got[0] - exact[0]).max()
    if dtype == "bfloat16":
        assert (want[0, 0], got[0, 0]) == (29.75, 37.5)
        assert abs(exact[0, 0] - 37.50198) < 1e-5


@pytest.mark.parametrize("arch", ["gemma2-9b", "gemma3-12b", "qwen1.5-32b",
                                  "dbrx-132b", "kimi-k2-1t-a32b"])
def test_bf16_train_step_equals_jax_value_and_grad(arch):
    """A bf16 smoke train step (the token lookup's backward on the CSR
    gather-sum's plain version) against one jitted ``jax.value_and_grad``
    of the reference's loss on the same params and tokens: the loss
    within rtol 1e-2, the embedding's gradient and the blocks' first
    norm scale within 8 bf16 ulps of max|g| (bf16 GEMMs and roundings in
    another order, compounded through qwen's bf16 residual stream, where
    ~5 ulps were seen; the lookup's part sums in f32 once where the
    reference rounds each add). For the MoE LMs the router's and the
    expert weights' gradients too (the bf16 combine and the dispatch
    gather's gradient sum in f32 once: ROADMAP Queue 3 #9)."""
    rcfg = dataclasses.replace(ref_registry.get_arch(arch).smoke_config(),
                               dtype="bfloat16", lookup_backend="gather")
    cfg = dataclasses.replace(_cfg(arch), dtype="bfloat16",
                              lookup_backend="cuda")
    params = RT.init_params(jax.random.PRNGKey(0), rcfg)
    rng = np.random.default_rng(5)
    b = {k: rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
         for k in ("tokens", "targets")}
    want_loss, want_g = jax.jit(jax.value_and_grad(
        functools.partial(RT.train_loss, cfg=rcfg)))(params, _to_jnp(b))
    want_g = _ref_flat(want_g)
    p = _port(_np(params))
    flat = rs.flat_params(p)
    leaves = [t.requires_grad_(True) for t in flat.values()]
    loss = T.train_loss(p, {k: torch.as_tensor(v) for k, v in b.items()},
                        cfg)
    grads = dict(zip(flat, torch.autograd.grad(loss, leaves)))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-2)
    assert grads["embed"].dtype == torch.bfloat16
    held = ["embed", sorted(k for k in flat if k.startswith("blocks/"))[0]]
    if cfg.qk_norm:
        held += ["blocks/q_norm", "blocks/k_norm"]
    if cfg.post_norm:
        held += ["blocks/attn_post_norm", "blocks/mlp_post_norm"]
    if cfg.moe is not None:
        held += ["blocks/router", "blocks/w_gate", "blocks/w_down"]
    for k in held:
        scale = float(np.abs(want_g[k]).max())
        _close(grads[k], want_g[k], 0, 8 * 2.0 ** -8 * scale, k)


# the dense LMs' one-card train_4k cuts (steps.LM_ONE_CARD), by depth, and
# the accumulator the reference's rule gives each
ONE_CARD_TRAIN = {("gemma2-9b", 8): torch.float32,
                  ("gemma3-12b", 6): torch.float32,
                  ("qwen1.5-32b", 5): torch.bfloat16}


@pytest.mark.parametrize("arch,n_layers", [("gemma2-9b", 8),
                                           ("gemma2-9b", None),
                                           ("gemma3-12b", 6),
                                           ("gemma3-12b", None),
                                           ("qwen1.5-32b", 5),
                                           ("qwen1.5-32b", 32)])
def test_accumulator_dtype_follows_the_reference_rule(arch, n_layers,
                                                      monkeypatch):
    """The gradient accumulator of a full-width train cell: the
    reference's rule (``repro/launch/steps.py:234-239`` with no mesh: bf16
    above 8e9 bytes of bf16 params, else f32; ``steps.lm_fsdp``, which
    also takes the mesh, ``tests/test_torch_dryrun.py``) on the cut
    config, so the depth cut moves it (gemma2-9b at 8 layers and
    gemma3-12b at 6: f32; qwen1.5-32b at 5: bf16); the cell's notes name
    it and its reduced lists the cuts; each one-card cut is
    ``LM_ONE_CARD``'s. The cell is built with its params on the meta
    device: no full-width tensor exists."""
    rcfg = ref_registry.get_arch(arch).full_config()
    cfg = registry.get_arch(arch).full_config()
    cuts = {"batch": 8}
    if n_layers is not None:
        rcfg = dataclasses.replace(rcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        cuts["n_layers"] = n_layers
    want = jnp.bfloat16 if RT.count_params(rcfg) * 2 > 8e9 else jnp.float32
    got = steps.lm_acc_dtype(steps.lm_fsdp(cfg))
    assert str(got) == f"torch.{jnp.dtype(want).name}"
    orig = T.init_params
    monkeypatch.setattr(T, "init_params",
                        lambda gen, c: orig(None, c, device="meta"))
    cell = steps.build_cell(arch, "train_4k", device="cpu", **cuts)
    assert f"accumulator={jnp.dtype(want).name}" in cell.notes
    assert "microbatches=8" in cell.notes
    assert cell.args[0]["embed"].device.type == "meta"
    assert "global_batch 256 -> 8" in cell.reduced
    if (arch, n_layers) in ONE_CARD_TRAIN:
        assert steps.LM_ONE_CARD[(arch, "train_4k")] == cuts
        assert got == ONE_CARD_TRAIN[(arch, n_layers)]
        full = registry.get_arch(arch).full_config().n_layers
        assert f"n_layers {full} -> {n_layers}" in cell.reduced


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_lm_cell_runs_on_the_card_or_is_recorded_as_not_run():
    """Every LM cell of the port's registry that is not skipped either
    has a one-card cut (``steps.LM_ONE_CARD``) that ``chip_smoke.py``'s
    lm phase runs once (``LM_CELLS``, ``LM_TRAIN_CELLS``,
    ``LM_MOE_TRAIN_CELL``), or is the cell it records as not run with its
    reckoning (``LM_NOT_RUN``); the dense LMs' train cuts are
    ``ONE_CARD_TRAIN``'s."""
    cs = _chip_smoke()
    cells = {(a, s) for a, s in registry.all_cells(include_skipped=False)
             if registry.get_arch(a).family == "lm"}
    run = [(a, s) for a, s, _ in
           cs.LM_CELLS + cs.LM_TRAIN_CELLS + (cs.LM_MOE_TRAIN_CELL,)]
    assert len(run) == len(set(run))
    assert set(run) == set(steps.LM_ONE_CARD)
    assert cs.LM_NOT_RUN not in steps.LM_ONE_CARD
    assert cells == set(steps.LM_ONE_CARD) | {cs.LM_NOT_RUN}
    dense = {(a, cut["n_layers"]) for (a, s), cut in steps.LM_ONE_CARD.items()
             if s == "train_4k"
             and registry.get_arch(a).full_config().moe is None}
    assert dense == set(ONE_CARD_TRAIN)


# ---------------------------------------------------------------------------
# the MoE FFN: routing, drops, the combine; the optimizer rule
# ---------------------------------------------------------------------------
def _moe_case(case, e=8, k=2, b=2, s=24, d=16, f=24):
    """A one-layer MoE FFN's input and params. ``ties``: integer-valued x
    and router, so every logit is an exact integer in both packages and
    many rows tie at the k-th choice; otherwise standard normal."""
    rng = np.random.default_rng(3)
    if case == "ties":
        x = rng.integers(-1, 2, (b, s, d)).astype(np.float32)
        router = rng.integers(-1, 2, (d, e)).astype(np.float32)
    else:
        x = rng.standard_normal((b, s, d)).astype(np.float32)
        router = rng.standard_normal((d, e)).astype(np.float32)
    lp = {"router": router[None],
          "w_gate": rng.standard_normal((1, e, d, f)).astype(np.float32) / 4,
          "w_up": rng.standard_normal((1, e, d, f)).astype(np.float32) / 4,
          "w_down": rng.standard_normal((1, e, f, d)).astype(np.float32) / 5}
    kw = dict(name="moe", n_layers=1, d_model=d, n_heads=2, n_kv_heads=1,
              d_ff=f, vocab_size=64, dtype="float32")
    cf = 0.5 if case == "drops" else 1.25
    return (x, lp, T.TransformerConfig(moe=T.MoEConfig(e, k, cf), **kw),
            RT.TransformerConfig(moe=RT.MoEConfig(e, k, cf), **kw))


def _ref_mlp_moe(x, lp, rcfg, monkeypatch):
    """The reference's ``_mlp_moe`` run op by op, with its routed expert
    ids (``lax.top_k``'s) and its kept mask (the condition of its first
    ``jnp.where``, ``pos < cap`` over the expert-sorted assignments)
    recorded on the way."""
    t = x.shape[0] * x.shape[1]
    tk = t * rcfg.moe.top_k
    seen = {}
    top_k, where = jax.lax.top_k, jnp.where

    def spy_top_k(a, k):
        out = top_k(a, k)
        seen.setdefault("idx", np.asarray(out[1]))
        return out

    def spy_where(c, *a, **kw):
        c_np = np.asarray(c)
        if c_np.dtype == bool and c_np.shape == (tk,):
            seen.setdefault("keep", c_np)
        return where(c, *a, **kw)

    with monkeypatch.context() as m:
        m.setattr(jax.lax, "top_k", spy_top_k)
        m.setattr(jnp, "where", spy_where)
        y = RT._mlp_moe(jnp.asarray(x), _to_jnp(lp), 0, rcfg)
    return np.asarray(y), seen["idx"], seen["keep"]


@pytest.mark.parametrize("case", ["ties", "drops", "random"])
def test_moe_routing_equals_the_reference_bitwise(case, monkeypatch):
    """``moe_route`` / ``_mlp_moe`` against ``repro.models.transformer.
    _mlp_moe`` (never against ``_mlp_moe_local`` on a mesh: ROADMAP Queue
    3 #4) on the same inputs: the routed expert ids in ``lax.top_k``'s
    order bitwise (``ties``: a third of the rows tie at the k-th choice,
    and the lowest expert id must win), the kept/dropped mask bitwise
    (``drops``: capacity factor 0.5, cap 8 against a mean load of 6
    tokens an expert), the output within rtol 1e-5 / atol 1e-6."""
    x, lp, cfg, rcfg = _moe_case(case)
    t, k = x.shape[0] * x.shape[1], cfg.moe.top_k
    want, want_idx, want_keep = _ref_mlp_moe(x, lp, rcfg, monkeypatch)
    plp = _port(lp)
    r = T.moe_route(torch.as_tensor(x).reshape(t, -1), plp["router"][0],
                    cfg.moe)
    assert r.cap == T.moe_capacity(t, cfg.moe)
    assert r.cap == max(8, min(int(np.ceil(t * k / 8 * rcfg.moe
                                           .capacity_factor)), t))
    np.testing.assert_array_equal(r.idx.numpy(), want_idx)
    np.testing.assert_array_equal(r.keep.numpy(), want_keep)
    logits = x.reshape(t, -1) @ lp["router"][0]
    top = -np.sort(-logits, axis=1)
    if case == "ties":
        assert (top[:, k - 1] == top[:, k]).sum() >= t // 4
    if case == "drops":
        assert int((~r.keep).sum()) >= t * k // 4
    got = T._mlp_moe(torch.as_tensor(x), plp, 0, cfg)
    _close(got, want, 1e-5, 1e-6, "moe output")


def test_bf16_moe_combine_rounds_once():
    """The token combine at bf16 (512 tokens, k 8 rows each, d 64, rows
    in a random expert-sorted order). The reference's
    ``jax.ops.segment_sum`` of bf16 rows on XLA's CPU rounds after every
    add; the port's CSR gather-sum sums in f32 in row order and rounds
    once (ROADMAP Queue 3 #9). Held: the port equals that f32 sum
    rounded once, bitwise, and lies within one bf16 ulp of the exact sum
    (half an ulp of the result plus the f32 sum's rounding); the
    reference within (k + 1) ulps of the largest partial sum. Pinned on
    this draw: 17,151 of 32,768 elements differ; at (5, 25) the port
    gives -6.75, the reference -6.8125, the exact sum -6.75293."""
    rng = np.random.default_rng(0)
    t, k, d = 512, 8, 64
    tok = (rng.permutation(t * k) // k).astype(np.int32)
    rows = np.asarray(jnp.asarray(
        rng.standard_normal((t * k, d)).astype(np.float32), jnp.bfloat16))
    want = np.asarray(jax.jit(lambda x, i: jax.ops.segment_sum(
        x, i, num_segments=t))(jnp.asarray(rows), jnp.asarray(tok))
        .astype(jnp.float32))
    tt = torch.as_tensor(tok).long()
    got = T._Combine.apply(T.tensor_from_numpy(rows, "cpu"), tt,
                           torch.sort(tt, stable=True).indices.int(),
                           torch.arange(0, t * k + 1, k))
    assert got.dtype == torch.bfloat16
    once = np.zeros((t, d), np.float32)
    np.add.at(once, tok, rows.astype(np.float32))          # row order
    assert torch.equal(got, torch.as_tensor(once).to(torch.bfloat16))
    got = got.float().numpy()
    exact = np.zeros((t, d))
    np.add.at(exact, tok, rows.astype(np.float64))
    peak = np.zeros((t, d))
    part = np.zeros((t, d))
    for i, row in zip(tok, rows.astype(np.float64)):
        part[i] += row
        peak[i] = np.maximum(peak[i], np.abs(part[i]))
    u = 2.0 ** -8
    assert (np.abs(got - exact) <= u * np.abs(exact)
            + k * 2.0 ** -24 * peak * 1.01).all()
    assert (np.abs(want - exact) <= (k + 1) * u * peak).all()
    assert int((got != want).sum()) == 17151
    assert (got[5, 25], want[5, 25]) == (-6.75, -6.8125)
    assert abs(exact[5, 25] + 6.75293) < 1e-5
    assert np.abs(got - exact).mean() < np.abs(want - exact).mean()


@pytest.mark.parametrize("arch", ARCHS)
def test_optimizer_rule_equals_the_reference(arch, monkeypatch):
    """``_lm_optimizer``: Adafactor at lr 1e-2 for a MoE of 128 experts or
    more (kimi-k2's 384), AdamW otherwise (dbrx's 16, the dense LMs), as
    the reference chooses on the full config; a full-width train cell
    names it (built with its params on the meta device)."""
    full = registry.get_arch(arch).full_config()
    name, opt = steps._lm_optimizer(full)
    want, _ = ref_steps._lm_optimizer(ref_registry.get_arch(arch)
                                      .full_config())
    assert name == want
    assert name == ("adafactor" if arch == "kimi-k2-1t-a32b" else "adamw")
    orig = T.init_params
    monkeypatch.setattr(T, "init_params",
                        lambda gen, c: orig(None, c, device="meta"))
    cell = steps.build_cell(arch, "train_4k", device="cpu", batch=8,
                            n_layers=full.layers_per_block)
    assert cell.notes.startswith(f"optimizer={name},")
    state = cell.args[1]
    assert ("fac" in state) == (name == "adafactor")


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------
def test_serve_cli_lm_cells_on_the_cpu(capsys):
    from repro_torch.launch import serve
    for shape in ("prefill_32k", "decode_32k"):
        assert serve.main(["--arch", "gemma3-12b", "--shape", shape,
                           "--device", "cpu", "--n-requests", "3"]) == 0
        out = capsys.readouterr().out
        assert f"gemma3-12b:{shape} smoke on cpu" in out
        assert "3 requests" in out and "tokens/s" in out


@pytest.mark.parametrize("arch", ["dbrx-132b", "kimi-k2-1t-a32b"])
def test_serve_cli_moe_cells_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve
    for shape in ("prefill_32k", "decode_32k"):
        assert serve.main(["--arch", arch, "--shape", shape, "--device",
                           "cpu", "--n-requests", "2"]) == 0
        out = capsys.readouterr().out
        assert f"{arch}:{shape} smoke on cpu" in out and "tokens/s" in out


def test_train_cli_lm_on_the_cpu(capsys):
    from repro_torch.launch import train
    assert train.main(["--arch", "qwen1.5-32b", "--shape", "train_4k",
                       "--device", "cpu", "--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "qwen1.5-32b:train_4k x2 smoke steps on cpu" in out
