"""The port's dot_interaction and flash_attention against the JAX package.

The same numpy inputs go through the reference's ``repro.kernels.ops``
(Pallas kernels in interpret mode, as the JAX package's own tests run
them on the CPU) and its jnp oracles, and through the port's
``repro_torch.kernels.ops`` on CPU tensors, which run the plain versions
the CUDA kernels are held against on the card. bf16 inputs are the f32
arrays rounded once to bf16 by each framework (round to nearest even,
the same values). Tolerances, as the reference's own tests
(``tests/test_kernels.py``): dot_interaction f32 rtol/atol 1e-4, bf16
rtol 5e-2 / atol 5e-1 (one bf16 rounding of sums up to ~50); attention
f32 rtol 2e-4 / atol 2e-5 (an online softmax against a one-pass one),
bf16 2e-2. The tensor-core route's rounding, emulated in plain torch, is
held at one rounding step of the type (rtol 1.5 x eps, atol 1e-4).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.transformer import chunked_attention

from repro_torch.kernels import dot_interaction as dot_kernel
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.kernels import ops, platform, ref
from repro_torch.kernels.flash_attention import route
from repro_torch.launch import kernel_bench

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _both(a: np.ndarray, dtype: str):
    """The same array as a JAX array and a torch CPU tensor."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.as_tensor(a).to(td)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _attn_tol(dtype: str) -> dict:
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bf16" \
        else dict(rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# dot_interaction
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,f,d,bt", [(8, 27, 128, 4), (16, 27, 128, 16),
                                      (4, 8, 32, 2), (8, 41, 16, 8)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dot_interaction_matches_reference(b, f, d, bt, dtype):
    x = np.random.default_rng(b * f + d).standard_normal((b, f, d))
    xj, xt = _both(x.astype(np.float32), dtype)
    got = ops.dot_interaction(xt, block_b=bt)
    assert got.shape == (b, f * (f - 1) // 2)
    assert got.dtype == DTYPES[dtype][1]
    tol = dict(rtol=5e-2, atol=5e-1) if dtype == "bf16" \
        else dict(rtol=1e-4, atol=1e-4)
    for want in (jops.dot_interaction(xj, block_b=bt, interpret=True),
                 jref.dot_interaction(xj)):
        np.testing.assert_allclose(_f32(got), _f32(want), **tol)


def test_dot_interaction_lane_order_and_exactness():
    """Integer inputs: every sum is exact, so the port equals the Pallas
    kernel bit for bit, lane by lane in np.tril_indices order."""
    x = np.random.default_rng(7).integers(-3, 4, (6, 13, 24))
    x = x.astype(np.float32)
    got = ops.dot_interaction(torch.as_tensor(x), block_b=3).numpy()
    want = np.asarray(jops.dot_interaction(jnp.asarray(x), block_b=3,
                                           interpret=True))
    np.testing.assert_array_equal(got, want)
    i, j = np.tril_indices(13, -1)
    np.testing.assert_array_equal(got, np.einsum("bfd,bgd->bfg", x, x)[:, i, j])


# ---------------------------------------------------------------------------
# flash_attention and mha
# ---------------------------------------------------------------------------
def _qkv(seed, b, h, sq, skv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32)
            for s in (sq, skv, skv)]


@pytest.mark.parametrize("b,h,s,d,bq,bk", [
    (1, 1, 128, 64, 64, 64), (2, 2, 256, 64, 64, 128),
    (1, 2, 256, 128, 128, 64), (2, 1, 512, 32, 128, 128),
    # the paths' attention at B 2: SASRec (S 49, d 50, one Pallas block)
    # and BERT4Rec (2 heads, S 200, d 32)
    (2, 1, 49, 50, 128, 128), (2, 2, 200, 32, 40, 40)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_matches_reference(b, h, s, d, bq, bk, causal,
                                           dtype):
    arrays = _qkv(s + d, b, h, s, s, d)
    (qj, qt), (kj, kt), (vj, vt) = [_both(a, dtype) for a in arrays]
    got = ops.flash_attention(qt, kt, vt, causal=causal, block_q=bq,
                              block_k=bk)
    assert got.shape == (b, h, s, d) and got.dtype == DTYPES[dtype][1]
    want = jops.flash_attention(qj, kj, vj, causal=causal, block_q=bq,
                                block_k=bk, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), **_attn_tol(dtype))
    # the bench's oracle, port against reference
    np.testing.assert_allclose(_f32(ref.mha(qt, kt, vt, causal=causal)),
                               _f32(jref.mha(qj, kj, vj, causal=causal)),
                               **_attn_tol(dtype))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_fewer_queries_than_keys(causal):
    """Sq 128, Skv 256: the causal mask is top-left aligned (query i sees
    keys 0..i), in the kernel and in both oracles."""
    arrays = _qkv(11, 1, 2, 128, 256, 64)
    (qj, qt), (kj, kt), (vj, vt) = [_both(a, "f32") for a in arrays]
    got = _f32(ops.flash_attention(qt, kt, vt, causal=causal, block_q=64,
                                   block_k=128))
    want = jops.flash_attention(qj, kj, vj, causal=causal, block_q=64,
                                block_k=128, interpret=True)
    np.testing.assert_allclose(got, _f32(want), **_attn_tol("f32"))
    np.testing.assert_allclose(got, _f32(jref.mha(qj, kj, vj, causal)),
                               **_attn_tol("f32"))
    if causal:   # row 0 attends to key 0 alone
        np.testing.assert_allclose(got[:, :, 0], arrays[2][:, :, 0],
                                   rtol=1e-6)


def test_flash_attention_matches_model_path():
    """Transposed [B, S, H, d] views, as the reference's model-path test
    passes them, against the model's chunked_attention."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 128, 4, 32)).astype(np.float32)
               for _ in range(3))                      # [B, S, H, D]
    model = chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              q_chunk=64)
    qt, kt, vt = (torch.as_tensor(a).transpose(1, 2) for a in (q, k, v))
    assert not qt.is_contiguous()
    got = ops.flash_attention(qt, kt, vt, causal=True, block_q=64,
                              block_k=64)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(),
                               np.asarray(model), rtol=2e-4, atol=2e-5)


def _tensor_core_emulation(q, k, v, causal, split=True):
    """What the tensor-core route computes, in plain torch on the CPU: f32
    scores of the 16-bit inputs over 64-key tiles with the online rescale
    (running max from -1e30, the -1e30 causal fill, keys past Skv at
    weight 0), P split into hi = T(P) and lo = T(P - hi) in the input type
    T, P·V as f32 sums of exact products, the denominator clamped at
    1e-30, one rounding at the store. ``split=False`` rounds P once to T
    instead (the route the kernel did not take)."""
    dt = q.dtype
    qf, kf, vf = q.float(), k.float(), v.float()
    sq, skv = q.shape[2], k.shape[2]
    scale = ref.attention_scale(q.shape[-1])
    m = torch.full((*q.shape[:3], 1), ref.NEG_INF)
    l = torch.zeros((*q.shape[:3], 1))
    acc = torch.zeros(qf.shape)
    qpos = torch.arange(sq)[:, None]
    for k0 in range(0, skv, 64):
        kt, vt = kf[:, :, k0:k0 + 64], vf[:, :, k0:k0 + 64]
        s = (qf @ kt.transpose(-1, -2)) * scale
        if causal:
            kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
            s = torch.where(kpos > qpos, torch.tensor(ref.NEG_INF), s)
        m_cur = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_cur)
        p = torch.exp(s - m_cur)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.to(dt).float()
        acc = acc * alpha + hi @ vt
        if split:
            acc = acc + (p - hi).to(dt).float() @ vt
        m = m_cur
    return (acc / l.clamp_min(1e-30)).to(dt)


@pytest.mark.parametrize("dtype", ["bf16", "f16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,s,blk", [(128, 256, 128), (50, 192, 64)])
def test_flash_attention_tensor_core_rounding(dtype, causal, d, s, blk):
    """The tensor-core route's rounding (emulated) against the Pallas
    kernel in interpret mode, at the unchanged 16-bit tolerance."""
    jd, td = {"bf16": (jnp.bfloat16, torch.bfloat16),
              "f16": (jnp.float16, torch.float16)}[dtype]
    arrays = _qkv(d + s + causal, 1, 3, s, s, d)
    qt, kt, vt = (torch.as_tensor(a).to(td) for a in arrays)
    qj, kj, vj = (jnp.asarray(a, jd) for a in arrays)
    assert route(td, d) == "tc"
    got = _tensor_core_emulation(qt, kt, vt, causal)
    want = jops.flash_attention(qj, kj, vj, causal=causal, block_q=blk,
                                block_k=blk, interpret=True)
    eps = float(torch.finfo(td).eps)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1.5 * eps,
                               atol=1e-4)
    np.testing.assert_allclose(
        _f32(got), _f32(ref.flash_attention(qt, kt, vt, causal=causal)),
        rtol=1.5 * eps, atol=1e-4)


@pytest.mark.parametrize("dtype", ["bf16", "f16"])
@pytest.mark.parametrize("d,s,blk", [(128, 256, 128), (50, 192, 64),
                                     (128, 1024, 128), (128, 2048, 128)])
def test_flash_attention_single_rounding_of_p_misses_the_tolerance(
        dtype, d, s, blk):
    """Why the tensor-core route splits P: rounding P once to the input
    type (``ref.mha``'s rounding) misses one rounding step of the type
    against both the Pallas kernel (interpret mode) and the f32 plain
    version at causal shapes, where the split holds it. Prints the max
    |err| of each (``pytest -s``)."""
    jd, td = {"bf16": (jnp.bfloat16, torch.bfloat16),
              "f16": (jnp.float16, torch.float16)}[dtype]
    arrays = _qkv(d + s, 1, 2, s, s, d)
    qt, kt, vt = (torch.as_tensor(a).to(td) for a in arrays)
    qj, kj, vj = (jnp.asarray(a, jd) for a in arrays)
    wants = {"pallas": torch.as_tensor(_f32(jops.flash_attention(
                 qj, kj, vj, causal=True, block_q=blk, block_k=blk,
                 interpret=True))),
             "plain": ref.flash_attention(qt, kt, vt, causal=True).float()}
    tol = {"rtol": 1.5 * float(torch.finfo(td).eps), "atol": 1e-4}
    for split in (True, False):
        got = _tensor_core_emulation(qt, kt, vt, True, split=split).float()
        for name, want in wants.items():
            err = float((got - want).abs().max())
            print(f"{dtype} d={d} S={s} causal split={split} vs {name}: "
                  f"max |err| {err:.3e}")
            assert torch.allclose(got, want, **tol) == split, (split, name)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 128, "tc"), (torch.float16, 64, "tc"),
    (torch.bfloat16, 32, "tc"), (torch.float32, 128, "cc"),
    (torch.bfloat16, 129, "cc"), (torch.float16, 256, "cc")])
def test_flash_attention_route_from_dtype_and_width(dtype, d, want):
    assert route(dtype, d) == want


# ---------------------------------------------------------------------------
# the reference's shape contract
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["dot_batch", "flash_sq", "flash_skv"])
def test_shape_errors_where_the_reference_asserts(case):
    rng = np.random.default_rng(0)
    if case == "dot_batch":
        x = rng.standard_normal((6, 5, 8)).astype(np.float32)
        with pytest.raises(AssertionError):
            jops.dot_interaction(jnp.asarray(x), block_b=4, interpret=True)
        with pytest.raises(ValueError, match="divisible"):
            ops.dot_interaction(torch.as_tensor(x), block_b=4)
        ops.dot_interaction(torch.as_tensor(x), block_b=6)
        return
    sq, skv = (192, 128) if case == "flash_sq" else (128, 192)
    q, k, v = _qkv(1, 1, 1, sq, skv, 16)
    with pytest.raises(AssertionError):
        jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             block_q=128, block_k=128, interpret=True)
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    with pytest.raises(ValueError, match="divisible"):
        ops.flash_attention(tq, tk, tv, block_q=128, block_k=128)
    ops.flash_attention(tq, tk, tv, block_q=64, block_k=64)


@pytest.mark.parametrize("kernel", ["dot_interaction", "flash_attention"])
def test_wrappers_take_the_plain_version_only_for_cpu_tensors(monkeypatch,
                                                              kernel):
    def refuse(name):
        raise AssertionError(f"kernel {name} loaded for a CPU tensor")

    monkeypatch.setattr(platform, "load", refuse)
    if kernel == "dot_interaction":
        fn, args = dot_kernel, (torch.randn(4, 5, 8),)
    else:
        fn, args = flash_kernel, tuple(torch.randn(1, 2, 16, 8)
                                       for _ in range(3))
    before = fn.launches
    want = fn(*args)
    assert fn.launches == before
    # meta tensors (a reckoning's, launch.op_analysis) get the output's
    # shape: neither a launch nor the plain version
    monkeypatch.setattr(ref, kernel, refuse)
    got = fn(*(a.to("meta") for a in args))
    assert got.device.type == "meta" and got.shape == want.shape
    assert fn.launches == before
    if kernel == "flash_attention":
        # tensors on two devices never fall back to the plain version
        with pytest.raises(ValueError):
            fn(args[0].to("meta"), *args[1:])


# ---------------------------------------------------------------------------
# the slice as a whole: the kernel bench
# ---------------------------------------------------------------------------
BENCH_ROWS = {"kernel/codebook_lookup": {"gb_moved",
                                         "intensity_flops_per_byte"},
              "kernel/embedding_bag": {"gb_moved"},
              "kernel/dot_interaction": {"gflops"},
              "kernel/flash_attention": {"gflops"},
              "kernel/flash_attention_maxerr": {"max_abs_err"}}


def test_kernel_bench_prints_the_reference_rows(capsys):
    assert kernel_bench.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rows = {}
    for line in lines:
        name, us, derived = line.split(",")
        rows[name] = (float(us), dict(kv.split("=") for kv in
                                      derived.split(";")))
    assert list(rows) == list(BENCH_ROWS)
    for name, keys in BENCH_ROWS.items():
        assert set(rows[name][1]) == keys
        assert rows[name][0] >= 0.0
    assert float(rows["kernel/flash_attention_maxerr"][1]["max_abs_err"]) \
        < 1e-4
    # the derived numbers are the reference's formulas at the fast shapes
    assert float(rows["kernel/dot_interaction"][1]["gflops"]) == \
        pytest.approx(2 * 256 * 27 * 27 * 128 / 1e9, abs=1e-4)
    assert float(rows["kernel/flash_attention"][1]["gflops"]) == \
        pytest.approx(2 * 2 * 1 * 2 * 512 * 512 * 64 / 2 / 1e9, abs=1e-4)


def test_kernel_bench_ops_match_reference_at_the_fast_shapes():
    """The bench's four ops on its own seeded inputs (numpy, seed 0, drawn
    in the reference bench's order) against the reference's ops."""
    from repro_torch.kernels import codebook_lookup, embedding_bag
    rng = np.random.default_rng(0)
    cb = rng.standard_normal((8192, 64)).astype(np.float32)
    idx = rng.integers(0, 8192, (1024, 2)).astype(np.int32)
    table = rng.standard_normal((20000, 128)).astype(np.float32)
    vals = rng.integers(0, 20000, 4096).astype(np.int32)
    segs = np.sort(rng.integers(0, 512, 4096)).astype(np.int32)
    x = rng.standard_normal((256, 27, 128)).astype(np.float32)
    q, k, v = (rng.standard_normal((1, 2, 512, 64)).astype(np.float32)
               for _ in range(3))
    t = torch.as_tensor
    np.testing.assert_array_equal(
        codebook_lookup(t(cb), t(idx)).numpy(),
        np.asarray(jops.codebook_lookup(jnp.asarray(cb), jnp.asarray(idx),
                                        interpret=True)))
    np.testing.assert_allclose(
        embedding_bag(t(table), t(vals), t(segs), 512).numpy(),
        np.asarray(jops.embedding_bag(jnp.asarray(table), jnp.asarray(vals),
                                      jnp.asarray(segs), 512,
                                      interpret=True)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        ops.dot_interaction(t(x), block_b=128).numpy(),
        np.asarray(jops.dot_interaction(jnp.asarray(x), block_b=128,
                                        interpret=True)), rtol=1e-4,
        atol=1e-4)
    np.testing.assert_allclose(
        ops.flash_attention(t(q), t(k), t(v), causal=True).numpy(),
        np.asarray(jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=True,
                                        interpret=True)),
        rtol=2e-4, atol=2e-5)


def test_kernel_bench_json_record(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(kernel_bench, "SWEEP_SHAPES", [(16, 64, 8, 2)])
    monkeypatch.setattr(kernel_bench, "FUSED_SHAPES", [(4, 300, 8, 5),
                                                       (4, 300, 8, 40)])
    monkeypatch.setattr(kernel_bench, "FUSED_CB_SHAPE", (4, 200, 8, 5, 30, 2))
    assert kernel_bench.main(["--json", "--device", "cpu", "--store",
                              str(tmp_path / "store")]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["platform"] == "cpu" and rec["bench"] == "kernel"
    assert {r["backend"] for r in rec["codebook_lookup"]} == \
        {"cuda", "gather", "onehot"}
    variants = [r["variant"] for r in rec["fused"]]
    assert variants == ["dense", "fused", "fused_int8"] * 2 + \
        ["dense_cb", "fused_cb", "fused_cb_int8"]
    assert all("us_per_call" in r for r in rec["fused"])
    assert rec["metrics"]["fused_records"]["value"] == 9
    assert rec["metrics"]["lookup_errors"]["value"] == 0
