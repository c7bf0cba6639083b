"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip without an NVIDIA GPU (run them there with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``).
Exact on integer-valued inputs (every sum exact, so any order agrees);
the codebook lookup and the bag sums are bitwise on any input (same
additions, same order), also at widths read by scalar, float2 and
float4 lanes, from tables 4 bytes off 16-byte alignment, on skewed bags
(4,000 values beside 300-600-value, 0-3-value and empty bags), with no
values and no rows, and two calls repeat bitwise; NaN scores rank first, lowest id first, in both
the kernel and the plain version; the lookups' kernel gradients are
bitwise equal across runs and within 1e-5 of the gather backend's. The
weighted CSR gather-sum (the LightGCN propagation) is bitwise its plain
version on skewed bags with zero, -0.0 and negative weights, one row of
100,000 values, all rows empty and no rows; ``_Propagate``'s forward and
backward are bitwise equal across two runs and within 1e-6 of the CPU's
(the same fold, in the same order); the fused trainer is bitwise the host trainer
with the device sampler, and a warm chunk runs under sync-debug "error".
A capacity-padded fused session (fp32 and int8) serves bitwise what an
unpadded one serves, a swap within the rungs allocates no device
state and then serves what a fresh session serves, and the
CapacityTuner's fine-tune on the card equals the CPU's. The frontdoor
swaps a tenant from a thread other than its batcher's while three
client threads load it: every response is wholly v1 or wholly v2 and
equals a direct session call bitwise, and the swap allocates no device
state (every state tensor keeps its ``data_ptr``).
dot_interaction is bitwise on integer inputs and within 2e-4 / 2e-5 (f32;
2e-2 in bf16 and f16, one rounding of sums in another order) elsewhere,
over F (every F mod 4, one tile per lane and lanes looping) and d (scalar
tails, 16-byte staging); an input not 16-byte aligned gives the aligned
copy's results bitwise; its shared-memory cap comes from the build;
flash_attention (an online softmax against the one-pass plain version)
within 2e-4 / 2e-5 in f32 and 2e-2 in bf16 and f16, and its tensor-core
route at a long causal sequence within one rounding step of the type
(rtol 1.5 x eps, atol 1e-4). The fused top-k redesign is held bitwise
(values and ids) on integer-valued inputs over k, row counts either side
of its 64-row block, ragged item counts and several widths; on items in
ascending score order (every score beats the running threshold); on
all-equal scores; and two calls repeat bitwise. Its chunk plan takes the
tiling and occupancy the build reports. An empty batch launches nothing.
The streamed LP solve gives the in-memory solve's labels on the card (and
the CPU's) at the 10k rung, with a lower peak of device memory, and the
solver's ordered W(k) sum (a stable sort and one CSR gather-sum) is
bitwise its plain version and the CPU's.
"""
import importlib.util
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.embedding import (EmbeddingEngine, EmbeddingSpec,
                                   embed_lookup)
from repro_torch.embedding import embedding_bag as te_embedding_bag
from repro_torch.kernels import (codebook_lookup, csr_gather_sum,
                                 dot_interaction, embedding_bag,
                                 flash_attention, fused_topk,
                                 fused_topk_codebook, ref)
from repro_torch.kernels.flash_attention import route

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("h", [1, 2, 3, 5])
@pytest.mark.parametrize("d", [1, 3, 50, 64, 129, 256])
@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("aligned", [True, False])
def test_codebook_lookup_kernel_bitwise(dev, h, d, binary, aligned):
    # scalar, float2 and float4 lanes; a codebook 4 bytes off 16-byte
    # alignment; B not a multiple of a warp's strip; B = 0
    g = torch.Generator().manual_seed(h * 1000 + d)
    flat = torch.randn(501 * d + 1, generator=g).to(dev)
    z = flat[:501 * d] if aligned else flat[1:]
    z = z.view(501, d)
    idx = torch.randint(0, 501, (4099, h), generator=g, dtype=torch.int32)
    if h > 1:
        idx[::2, -1] = idx[::2, 0]
    idx = idx.to(dev)
    before = codebook_lookup.launches
    got = codebook_lookup(z, idx, binary=binary)
    assert codebook_lookup.launches == before + 1
    assert torch.equal(got, ref.codebook_lookup(z, idx, binary=binary))
    assert torch.equal(got, codebook_lookup(z, idx, binary=binary))
    empty = codebook_lookup(z, idx[:0], binary=binary)
    assert empty.shape == (0, d)


@pytest.mark.parametrize("case", ["ties", "mask", "exclude", "int8", "block"])
def test_fused_topk_kernel_exact(dev, case):
    g = torch.Generator().manual_seed(3)
    u = torch.randint(-2, 3, (37, 64), generator=g).float().to(dev)
    v = torch.randint(-2, 3, (3001, 64), generator=g).float().to(dev)
    kw = {}
    if case == "mask":
        kw["mask"] = torch.full((3001,), float("-inf"), device=dev)
        kw["mask"][torch.arange(0, 3001, 500, device=dev)] = 0.0
    if case == "exclude":
        r = torch.randint(0, 37, (400,), generator=g)
        c = torch.randint(0, 3001, (400,), generator=g)
        kw["exclude"] = (r.to(dev), c.to(dev))
    if case == "int8":
        v = torch.randint(-127, 128, (3001, 64), generator=g,
                          dtype=torch.int8).to(dev)
        kw["scale"] = (2.0 ** torch.randint(-3, 2, (3001,),
                                            generator=g)).float().to(dev)
    block = 61 if case == "block" else 1024
    before = fused_topk.launches
    got = fused_topk(u, v, 20, block=block, **kw)
    assert fused_topk.launches == before + 1
    want = ref.fused_topk(u, v, 20, **kw)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


def test_fused_topk_kernel_random_floats(dev):
    g = torch.Generator().manual_seed(4)
    u = torch.randn(64, 64, generator=g).to(dev)
    v = torch.randn(20000, 64, generator=g).to(dev)
    gv, gi = fused_topk(u, v, 20)
    wv, wi = ref.fused_topk(u, v, 20)
    torch.testing.assert_close(gv, wv, rtol=1e-5, atol=1e-5)
    diff = (gi != wi).cpu().numpy()
    assert diff.mean() < 0.01
    np.testing.assert_allclose(gv.cpu().numpy()[diff],
                               wv.cpu().numpy()[diff], rtol=1e-5)


def test_fused_topk_kernel_refuses_bad_input(dev):
    u = torch.randn(2, 8, device=dev)
    v = torch.randn(40, 8, device=dev)
    with pytest.raises(ValueError):
        fused_topk(u, v, 33)                      # above the k cap
    with pytest.raises(TypeError):
        fused_topk(u, v.double(), 4)
    with pytest.raises(ValueError):
        fused_topk(u, v.cpu(), 4)                 # devices differ
    sk = torch.tensor([[0, 1], [40, 2], [3, 3], [5, 6]], dtype=torch.int32,
                      device=dev)
    with pytest.raises(ValueError, match="sketch"):
        fused_topk_codebook(u, v, sk, 4)          # row 40 of 40
    with pytest.raises(TypeError):
        fused_topk_codebook(u, v, sk.long(), 4)


def _sketch(n, k, h, g):
    sk = torch.randint(0, k, (n, h), generator=g, dtype=torch.int32)
    if h > 1:
        sk[::3, 1] = sk[::3, 0]                   # SCU duplicates
    return sk


@pytest.mark.parametrize("case", ["f32", "int8", "mask", "exclude", "block",
                                  "h1"])
def test_fused_topk_codebook_kernel_exact(dev, case):
    g = torch.Generator().manual_seed(5)
    h = 1 if case == "h1" else 2
    sk = _sketch(3001, 211, h, g).to(dev)
    u = torch.randint(-2, 3, (37, 64), generator=g).float().to(dev)
    z = torch.randint(-2, 3, (211, 64), generator=g).float().to(dev)
    kw = {}
    if case == "int8":
        z = torch.randint(-127, 128, (211, 64), generator=g,
                          dtype=torch.int8).to(dev)
        kw["scale"] = (2.0 ** torch.randint(-3, 2, (211,),
                                            generator=g)).float().to(dev)
    if case == "mask":
        kw["mask"] = torch.full((3001,), float("-inf"), device=dev)
        kw["mask"][torch.arange(0, 3001, 500, device=dev)] = 0.0
    if case == "exclude":
        r = torch.randint(0, 37, (400,), generator=g)
        c = torch.randint(0, 3001, (400,), generator=g)
        kw["exclude"] = (r.to(dev), c.to(dev))
    block = 61 if case == "block" else 1024
    before = (fused_topk.launches, fused_topk_codebook.launches)
    got = fused_topk(u, z, 20, sketch=sk, block=block, **kw)
    assert (fused_topk.launches, fused_topk_codebook.launches) == \
        (before[0], before[1] + 1)
    want = ref.fused_topk(u, z, 20, sketch=sk, **kw)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("variant", ["dense", "codebook"])
def test_fused_topk_kernel_nan_first(dev, variant):
    g = torch.Generator().manual_seed(6)
    u = torch.randint(-2, 3, (9, 16), generator=g).float()
    u[3] = float("nan")                           # a row of NaN scores
    z = torch.randint(-2, 3, (500, 16), generator=g).float()
    z[[7, 123, 499]] = float("nan")               # NaN items in every row
    kw = {}
    if variant == "codebook":
        kw["sketch"] = _sketch(900, 500, 2, g).to(dev)
    got = fused_topk(u.to(dev), z.to(dev), 12, block=64, **kw)
    want = ref.fused_topk(u.to(dev), z.to(dev), 12, **kw)
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0,
                               equal_nan=True)
    assert torch.isnan(got[0][:, 0]).all()


def _skewed_csr(rows, n_src, g):
    """``chip_smoke.skewed_csr``: 4,000 values in the first and the last
    bag, 200 bags of 300-600 values, the rest 0-3 values."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.skewed_csr(rows, n_src, g, "cpu")


@pytest.mark.parametrize("case", ["random", "skewed", "all_empty",
                                  "no_values", "no_rows"])
@pytest.mark.parametrize("d", [1, 3, 50, 64, 128, 129, 256])
@pytest.mark.parametrize("aligned", [True, False])
def test_embedding_bag_kernel_bitwise(dev, case, d, aligned):
    g = torch.Generator().manual_seed(7 + d)
    flat = torch.randn(5003 * d + 1, generator=g).to(dev)
    table = (flat[:5003 * d] if aligned else flat[1:]).view(5003, d)
    if case == "random":
        nnz, nseg = 40000, 4099
        values = torch.randint(0, 5003, (nnz,), generator=g,
                               dtype=torch.int32).to(dev)
        segs = torch.sort(torch.randint(0, nseg, (nnz,), generator=g)).values
        segs[(segs % 97) == 5] = 4                # empty bags
        segs = torch.sort(segs).values.to(dev)
        before = csr_gather_sum.launches
        got = embedding_bag(table, values, segs, nseg)
        assert csr_gather_sum.launches == before + 1
        assert torch.equal(got, ref.embedding_bag(table, values, segs, nseg))
        assert not got[(torch.bincount(segs, minlength=nseg) == 0)].any()
        # unsorted bags: sorted stably in the wrapper, then the same kernel
        perm = torch.randperm(nnz, generator=g).to(dev)
        got = embedding_bag(table, values[perm], segs[perm], nseg)
        assert csr_gather_sum.launches == before + 2
        assert torch.equal(got, ref.embedding_bag(table, values[perm],
                                                  segs[perm], nseg))
        return
    if case == "skewed":
        idx, ptr = _skewed_csr(3000, 5003, g)
    else:
        rows = {"all_empty": 700, "no_values": 1, "no_rows": 0}[case]
        idx = torch.zeros(0, dtype=torch.int32)
        ptr = torch.zeros(rows + 1, dtype=torch.int64)
    idx, ptr = idx.to(dev), ptr.to(dev)
    before = csr_gather_sum.launches
    got = csr_gather_sum(table, idx, ptr)
    assert csr_gather_sum.launches == before + 1
    assert got.shape == (ptr.numel() - 1, d)
    assert torch.equal(got, ref.csr_gather_sum(table, idx, ptr))
    assert torch.equal(got, csr_gather_sum(table, idx, ptr))
    assert csr_gather_sum.launches == before + 2


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_unsorted_undeclared_bag_launches_the_kernel(dev, mode):
    g = torch.Generator().manual_seed(9)
    table = torch.randn(900, 64, generator=g).to(dev)
    values = torch.randint(0, 900, (7000,), generator=g).to(dev)
    segs = torch.randint(0, 1000, (7000,), generator=g).to(dev)
    before = csr_gather_sum.launches
    got = te_embedding_bag(table, values, segs, 1000, mode=mode)
    assert csr_gather_sum.launches == before + 1
    want = te_embedding_bag(table, values, segs, 1000, mode=mode,
                            via="gather")
    assert torch.equal(got, want)


def test_lookups_refuse_indices_out_of_range(dev):
    table = torch.randn(40, 8, device=dev)
    for bad in (-1, 40, 2 ** 31):
        ids = torch.tensor([0, bad, 3], device=dev)
        with pytest.raises(ValueError, match="lie in"):
            embed_lookup(table, ids)
    # a sketch is checked on first use and again after an in-place write
    u = torch.randn(2, 8, device=dev)
    sk = torch.tensor([[0, 1], [39, 2], [3, 3], [5, 6]], dtype=torch.int32,
                      device=dev)
    fused_topk_codebook(u, table, sk, 4)
    sk[1, 0] = 40
    with pytest.raises(ValueError, match="sketch"):
        fused_topk_codebook(u, table, sk, 4)


@pytest.mark.parametrize("kind", ["codebook", "bag", "full"])
def test_kernel_gradients_deterministic(dev, kind):
    g = torch.Generator().manual_seed(8)
    w = torch.randn(3000, 32, generator=g).to(dev)
    table = torch.randn(700, 32, generator=g).to(dev)
    sk = _sketch(3000, 700, 2, g).to(dev)
    values = torch.randint(0, 700, (3000,), generator=g).to(dev)
    segs = torch.sort(torch.randint(0, 3000, (3000,), generator=g)).values
    segs = segs.to(dev)

    def grad(backend):
        t = table.clone().requires_grad_(True)
        eng = EmbeddingEngine(EmbeddingSpec(3000, 32, k_rows=700, n_hot=2),
                              backend=backend)
        if kind == "codebook":
            out = eng.codebook_lookup(t, sk)
        elif kind == "bag":
            out = eng.bag_lookup(t, values, segs, 3000, mode="mean")
        else:
            out = eng.full_lookup(t, values)
        (d,) = torch.autograd.grad((out * w).sum(), t)
        return d

    before = csr_gather_sum.launches
    a, b = grad("cuda"), grad("cuda")
    assert csr_gather_sum.launches >= before + 2
    assert torch.equal(a, b)
    torch.testing.assert_close(a, grad("gather"), rtol=1e-5, atol=1e-5)


FLOATS = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}


def _close(got, want, dtype):
    tol = (dict(rtol=2e-4, atol=2e-5) if dtype == "f32"
           else dict(rtol=2e-2, atol=2e-2))
    assert got.dtype == want.dtype
    torch.testing.assert_close(got.float(), want.float(), **tol)


# every F mod 4, one tile per lane (F <= 28) and lanes looping over tiles
# (F > 28); the scalar tails of d and the 16-byte staging path; B = 37 is
# not a multiple of a block's 4 examples
DOT_FS = [2, 3, 4, 5, 8, 27, 28, 29, 33, 41, 100]
DOT_DS = [1, 3, 50, 128, 129, 256]
DOT_CASES = ([(1000, 27, 128), (37, 41, 16), (9, 2, 50), (300, 100, 256)]
             + [(37, f, d) for f in DOT_FS for d in DOT_DS])


@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("b,f,d", DOT_CASES)
def test_dot_interaction_kernel(dev, dtype, b, f, d):
    g = torch.Generator().manual_seed(b + f + d)
    x = (torch.randn(b, f, d, generator=g) / d ** 0.5).to(FLOATS[dtype])
    x = x.to(dev)
    before = dot_interaction.launches
    got = dot_interaction(x)
    assert dot_interaction.launches == before + 1
    assert got.shape == (b, f * (f - 1) // 2)
    _close(got, ref.dot_interaction(x), dtype)
    # integer-valued inputs: every sum is exact, one rounding at the store
    xi = torch.randint(-3, 4, (b, f, d), generator=g).to(FLOATS[dtype])
    xi = xi.to(dev)
    assert torch.equal(dot_interaction(xi), ref.dot_interaction(xi))


def test_dot_interaction_kernel_strided_input_and_tile_cap(dev):
    g = torch.Generator().manual_seed(0)
    x = torch.randint(-3, 4, (27, 513, 64), generator=g).float().to(dev)
    xt = x.transpose(0, 1)                       # [B, F, d], not contiguous
    assert not xt.is_contiguous()
    assert torch.equal(dot_interaction(xt), ref.dot_interaction(xt))
    with pytest.raises(ValueError, match="shared memory"):
        dot_interaction(torch.zeros(2, 500, 128, device=dev))


@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("b,f,d", [(6, 5, 3), (9, 27, 128), (5, 33, 64)])
def test_dot_interaction_kernel_unaligned_input(dev, dtype, b, f, d):
    """A view whose data pointer is not 16-byte aligned takes the 4-byte
    (f32) or register (16-bit) staging path: the same results, bitwise,
    as an aligned copy (each output is the same fmaf chain), and the
    plain version's. ``x[1:]`` at F 5, d 3 starts 60 bytes in."""
    g = torch.Generator().manual_seed(f * d)
    full = torch.randn(b + 1, f, d, generator=g).to(FLOATS[dtype]).to(dev)
    x = full[1:]
    if x.data_ptr() % 16 == 0:           # shift by one element instead
        flat = torch.empty(full.numel() + 1, dtype=full.dtype, device=dev)
        flat[1:].copy_(full.reshape(-1))
        x = flat[1:1 + x.numel()].view(b, f, d)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    got = dot_interaction(x)
    assert torch.equal(got, dot_interaction(x.clone()))
    _close(got, ref.dot_interaction(x), dtype)
    xi = torch.randint(-3, 4, (b + 1, f, d), generator=g).to(
        FLOATS[dtype]).to(dev)[1:]
    assert torch.equal(dot_interaction(xi), ref.dot_interaction(xi))


def test_dot_interaction_smem_cap_from_the_build(dev):
    """The wrapper's refusal comes from the build's plan and cap: the
    dlrm-mlperf plan (4 warps, one 27 x 132-float slot each) leaves room
    for four blocks per SM; (300, 100, 256) runs on a smaller plan;
    (2, 500, 128) does not fit one example's rows."""
    from repro_torch.kernels.dot_interaction import max_smem, smem_bytes
    cap = max_smem()
    assert cap == 232448
    for dt in FLOATS.values():
        assert smem_bytes(27, 128, dt) == 4 * 27 * 132 * 4
        assert 4 * (smem_bytes(27, 128, dt) + 1024) <= 233472
        assert smem_bytes(100, 256, dt) <= cap
        assert smem_bytes(500, 128, dt) > cap
    x = torch.randint(-3, 4, (300, 100, 256)).float().to(dev)
    assert torch.equal(dot_interaction(x), ref.dot_interaction(x))
    with pytest.raises(ValueError, match="shared memory"):
        dot_interaction(torch.zeros(2, 500, 128, device=dev))


@pytest.mark.parametrize("variant", ["dense", "codebook"])
def test_fused_topk_empty_batch_launches_nothing(dev, variant):
    g = torch.Generator().manual_seed(2)
    items = torch.randn(300, 64, generator=g).to(dev)
    kw = {}
    if variant == "codebook":
        kw["sketch"] = _sketch(500, 300, 2, g).to(dev)
    fn = fused_topk_codebook if variant == "codebook" else fused_topk
    before = fn.launches
    vals, ids = fused_topk(torch.zeros(0, 64, device=dev), items, 20, **kw)
    assert fn.launches == before
    assert vals.shape == ids.shape == (0, 20)
    assert vals.dtype == torch.float32 and ids.dtype == torch.int32
    assert vals.device == ids.device == items.device


@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("d", [32, 50, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv", [(200, 328), (256, 256), (64, 1)])
def test_flash_attention_kernel(dev, dtype, d, causal, sq, skv):
    g = torch.Generator().manual_seed(d + sq + skv)
    q, k, v = (torch.randn(2, 3, s, d, generator=g).to(FLOATS[dtype]).to(dev)
               for s in (sq, skv, skv))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    assert got.shape == q.shape
    _close(got, ref.flash_attention(q, k, v, causal=causal), dtype)


def test_flash_attention_kernel_strided_inputs_and_refusals(dev):
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 130, 4, 64, generator=g).to(dev)
               for _ in range(3))                # [B, S, H, d]
    args = [a.transpose(1, 2) for a in (q, k, v)]
    assert not args[0].is_contiguous()
    _close(flash_attention(*args), ref.flash_attention(*args), "f32")
    with pytest.raises(ValueError, match="d=300"):
        flash_attention(*(torch.zeros(1, 1, 8, 300, device=dev)
                          for _ in range(3)))
    with pytest.raises(TypeError):
        flash_attention(args[0].half(), *args[1:])


@pytest.mark.parametrize("dtype,d,want", [
    ("bf16", 128, "tc"), ("f16", 128, "tc"), ("bf16", 50, "tc"),
    ("f16", 64, "tc"), ("f32", 128, "cc"), ("f32", 50, "cc"),
    ("bf16", 256, "cc"), ("f16", 200, "cc")])
def test_flash_attention_route_counts(dev, dtype, d, want):
    g = torch.Generator().manual_seed(d)
    q, k, v = (torch.randn(1, 2, 96, d, generator=g).to(FLOATS[dtype])
               .to(dev) for _ in range(3))
    assert route(q.dtype, d) == want
    before = (flash_attention.launches, flash_attention.launches_tc,
              flash_attention.launches_cc)
    got = flash_attention(q, k, v)
    after = (flash_attention.launches, flash_attention.launches_tc,
             flash_attention.launches_cc)
    assert after == (before[0] + 1, before[1] + (want == "tc"),
                     before[2] + (want == "cc"))
    _close(got, ref.flash_attention(q, k, v), dtype)


@pytest.mark.parametrize("dtype", ["bf16", "f16"])
def test_flash_attention_tensor_cores_long_causal(dev, dtype):
    g = torch.Generator().manual_seed(11)
    q, k, v = (torch.randn(1, 6, 1024, 128, generator=g).to(FLOATS[dtype])
               .to(dev) for _ in range(3))
    before = flash_attention.launches_tc
    got = flash_attention(q, k, v, causal=True)
    assert flash_attention.launches_tc == before + 1
    want = ref.flash_attention(q, k, v, causal=True)
    eps = torch.finfo(FLOATS[dtype]).eps
    torch.testing.assert_close(got.float(), want.float(), rtol=1.5 * eps,
                               atol=1e-4)


def _topk_case(variant, rows, n, d, g):
    """(u, items, kwargs) with integer-valued inputs, so every score is
    exact and the plain version is the exact answer."""
    u = torch.randint(-2, 3, (rows, d), generator=g).float()
    kw = {}
    if variant == "int8":
        items = torch.randint(-127, 128, (n, d), generator=g,
                              dtype=torch.int8)
        kw["scale"] = 2.0 ** torch.randint(-3, 2, (n,), generator=g).float()
    elif variant == "codebook":
        items = torch.randint(-2, 3, (211, d), generator=g).float()
        kw["sketch"] = _sketch(n, 211, 2, g)
    else:
        items = torch.randint(-2, 3, (n, d), generator=g).float()
    return u, items, kw


@pytest.mark.parametrize("variant", ["dense", "int8", "codebook"])
@pytest.mark.parametrize("k", [1, 20, 32])
@pytest.mark.parametrize("rows", [1, 63, 65, 513])
@pytest.mark.parametrize("d", [50, 64, 256])
def test_fused_topk_redesign_exact(dev, variant, k, rows, d):
    g = torch.Generator().manual_seed(rows * 7 + k + d)
    u, items, kw = _topk_case(variant, rows, 3001, d, g)
    u, items = u.to(dev), items.to(dev)
    kw = {key: val.to(dev) for key, val in kw.items()}
    got = fused_topk(u, items, k, **kw)
    want = ref.fused_topk(u, items, k, **kw)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])
    again = fused_topk(u, items, k, **kw)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


@pytest.mark.parametrize("codebook", [False, True])
@pytest.mark.parametrize("quantized", [False, True])
def test_fused_topk_tiling_from_the_build(dev, codebook, quantized):
    """The chunk plan's inputs come from the build: 64-row blocks of
    64-item tiles, two blocks per SM at d 64 and one at d 256 (its
    shared memory, ~148 KB, leaves room for one)."""
    from repro_torch.kernels.fused_topk import _tiling
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert _tiling(dev, 64, codebook, quantized) == (64, 64, 2 * sms)
    assert _tiling(dev, 256, codebook, quantized) == (64, 64, sms)


@pytest.mark.parametrize("variant", ["dense", "codebook"])
@pytest.mark.parametrize("block", [None, 61, 1024])
def test_fused_topk_ascending_scores(dev, variant, block):
    """Item i scores i (exact): each new score beats every kept one, so
    every candidate passes the threshold filter."""
    n, d = 5003, 64
    u = torch.zeros(70, d)
    u[:, 0] = 1.0
    u[1::2, 0] = -1.0                     # odd rows: descending scores
    table = torch.zeros(n, d)
    table[:, 0] = torch.arange(n, dtype=torch.float32)
    kw = {}
    if variant == "codebook":
        kw["sketch"] = torch.arange(n, dtype=torch.int32)[:, None].to(dev)
    u, table = u.to(dev), table.to(dev)
    got = fused_topk(u, table, 32, block=block, **kw)
    want = ref.fused_topk(u, table, 32, **kw)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert torch.equal(got[1][0].cpu(), torch.arange(n - 1, n - 33, -1,
                                                     dtype=torch.int32))


@pytest.mark.parametrize("variant", ["dense", "int8", "codebook"])
@pytest.mark.parametrize("k", [1, 20, 32])
def test_fused_topk_all_equal_scores(dev, variant, k):
    """Every score 0: ties everywhere, the lowest ids win, in order."""
    g = torch.Generator().manual_seed(k)
    u, items, kw = _topk_case(variant, 130, 4099, 64, g)
    u = torch.zeros_like(u).to(dev)
    items = items.to(dev)
    kw = {key: val.to(dev) for key, val in kw.items()}
    got = fused_topk(u, items, k, **kw)
    want = ref.fused_topk(u, items, k, **kw)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert torch.equal(got[1].cpu(), torch.arange(k, dtype=torch.int32)
                       .expand(130, k))


# ---------------------------------------------------------------------------
# the weighted CSR gather-sum (the LightGCN propagation) and training
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["skewed", "zeros", "negative", "long_row",
                                  "all_empty", "no_rows"])
@pytest.mark.parametrize("d", [1, 3, 50, 64, 129, 600])
@pytest.mark.parametrize("aligned", [True, False])
def test_weighted_csr_gather_sum_kernel_bitwise(dev, case, d, aligned):
    # empty rows, w = 0 and -0.0, negative weights, rows of more than 32
    # values (the long-row blocks), one row of 100,000 values, all rows
    # empty, no rows; scalar, float2 and float4 lanes and a column tile
    g = torch.Generator().manual_seed(11 + d)
    flat = torch.randn(2000 * d + 1, generator=g).to(dev)
    table = (flat[:2000 * d] if aligned else flat[1:]).view(2000, d)
    if case == "long_row":
        idx = torch.randint(0, 2000, (100_000,), generator=g,
                            dtype=torch.int32)
        ptr = torch.tensor([0, 0, 100_000, 100_000])
    elif case in ("all_empty", "no_rows"):
        idx = torch.zeros(0, dtype=torch.int32)
        ptr = torch.zeros(700 if case == "all_empty" else 1,
                          dtype=torch.int64)
    else:
        idx, ptr = _skewed_csr(3000, 2000, g)
    w = torch.randn(idx.numel(), generator=g)
    if case == "zeros":
        w[::2] = 0.0
        w[1::2] = -0.0
    elif case == "negative":
        w = -w.abs()
    idx, ptr, w = idx.to(dev), ptr.to(dev), w.to(dev)
    before = (csr_gather_sum.launches, csr_gather_sum.launches_weighted)
    got = csr_gather_sum(table, idx, ptr, w)
    assert (csr_gather_sum.launches, csr_gather_sum.launches_weighted) == (
        before[0] + 1, before[1] + 1)
    assert got.shape == (ptr.numel() - 1, d)
    assert torch.equal(got, ref.csr_gather_sum(table, idx, ptr, w))
    assert torch.equal(got, csr_gather_sum(table, idx, ptr, w))
    if case == "zeros":
        assert not got.any() and not got.signbit().any()


def test_weighted_csr_gather_sum_refuses_bad_weights(dev):
    table = torch.randn(10, 8, device=dev)
    idx = torch.zeros(4, dtype=torch.int32, device=dev)
    ptr = torch.tensor([0, 4], device=dev)
    with pytest.raises(TypeError):
        csr_gather_sum(table, idx, ptr, torch.ones(4, device=dev).double())
    with pytest.raises(ValueError):
        csr_gather_sum(table, idx, ptr, torch.ones(4))
    with pytest.raises(ValueError):
        csr_gather_sum(table, idx, ptr, torch.ones(5, device=dev))


def _small_training_setup():
    from repro_torch.core import ClusterEngine
    from repro_torch.data import planted_coclusters
    g, _, _ = planted_coclusters(600, 500, 8, 12, seed=3)
    sk = ClusterEngine(device="cpu").build(g, d=32, ratio=0.3)
    return g, sk


def test_propagate_backward_on_the_card(dev):
    from repro_torch.models import lightgcn as L
    g, _ = _small_training_setup()
    gen = torch.Generator().manual_seed(5)
    cu = torch.randn(g.n_users, 32, generator=gen)
    cv = torch.randn(g.n_items, 32, generator=gen)
    gu = torch.randn(g.n_users, 32, generator=gen)
    gv = torch.randn(g.n_items, 32, generator=gen)

    def grads(device):
        st = L.make_statics(g, None, device=device)
        a = cu.to(device).requires_grad_(True)
        b = cv.to(device).requires_grad_(True)
        nu, nv = L._Propagate.apply(a, b, st)
        loss = (nu * gu.to(device)).sum() + (nv * gv.to(device)).sum()
        return [x.cpu() for x in (nu, nv, *torch.autograd.grad(loss, [a, b]))]

    one, two, cpu = grads(dev), grads(dev), grads("cpu")
    for x, y, z in zip(one, two, cpu):
        assert torch.equal(x, y)
        torch.testing.assert_close(x, z, rtol=1e-6, atol=1e-6)


def test_fused_trainer_equals_host_on_the_card(dev, tmp_path):
    from repro_torch.training import TrainConfig, Trainer
    g, sk = _small_training_setup()
    cfg = TrainConfig(dim=32, steps=24, batch_size=256, lr=5e-3,
                      chunk_size=8, sampler="device")
    out = {}
    for backend in ("host", "fused"):
        tr = Trainer(g, sk, TrainConfig(**{**cfg.__dict__,
                                           "backend": backend}), device=dev)
        out[backend] = (tr.run(log_every=0),
                        {k: v.detach().clone() for k, v in tr.params.items()})
    assert out["host"][0] == out["fused"][0]
    for k, v in out["host"][1].items():
        assert torch.equal(out["fused"][1][k], v)
    # a warm chunk enqueues work only
    tr = Trainer(g, sk, TrainConfig(**{**cfg.__dict__, "backend": "fused"}),
                 device=dev)
    tr.run(steps=8, log_every=0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = tr.backend.chunk(tr, 8)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(losses).all()


def _stream_artifacts(dev):
    """Two exports of a short stream replayed on the card (3 tune steps
    at the refresh), and the launcher's caps."""
    from repro_torch.core import ClusterEngine
    from repro_torch.data import drifting_coclusters
    from repro_torch.models import lightgcn as L
    from repro_torch.stream import ReplayConfig, StreamUpdater, replay
    stream = drifting_coclusters(600, 480, k_true=12, avg_deg=10, T=2)
    engine = ClusterEngine(device=dev)
    sk = engine.build(stream.base, d=32, ratio=0.25)
    caps = {"n_users": 600, "n_items": 480, "k_users": 300, "k_items": 240,
            "n_edges": stream.base.n_edges
            + sum(s.edge_u.size for s in stream.steps)}
    up = StreamUpdater(stream.base, sk,
                       L.init_params(0, L.from_sketch(stream.base, sk,
                                                      dim=32)),
                       {"dim": 32, "n_layers": 3, "l2": 1e-4,
                        "lookup_backend": None},
                       engine=engine, capacity=caps)
    first = up.export_artifact()
    report = replay(up, stream.steps, None,
                    ReplayConfig(refresh_every=2, tune_steps=3))
    return first, report["final_artifact"], caps


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_padded_fused_session_equals_unpadded_on_the_card(dev, quantized):
    _, art, caps = _stream_artifacts(dev)
    if quantized:
        art = art.quantize()
    ids = np.arange(0, art.model["n_users"], 3)
    exact = art.session(k=20, scorer="fused", device=dev)(ids)
    padded = art.session(k=20, scorer="fused", capacity=caps, device=dev)
    got = padded(ids)
    assert torch.equal(got[0], exact[0]) and torch.equal(got[1], exact[1])
    assert int(got[1].max()) < art.model["n_items"]


def test_swap_allocates_nothing_on_the_card(dev):
    first, final, caps = _stream_artifacts(dev)
    session = first.session(k=20, scorer="fused", capacity=caps, device=dev)
    session.warmup(64)
    ids = np.arange(0, first.model["n_users"], 5)
    session(ids)                                  # enqueued before the swap
    n_alloc = session.state_allocations
    ptrs = {k: v.data_ptr() for k, v in {**session.params,
                                         **session.statics}.items()}
    sw = session.swap(final)
    assert sw["state_allocations"] == 0 and not sw["capacity_bumped"]
    assert session.state_allocations == n_alloc
    assert ptrs == {k: v.data_ptr() for k, v in {**session.params,
                                                 **session.statics}.items()}
    ids = np.arange(0, final.model["n_users"], 5)
    got = session(ids)
    want = final.session(k=20, scorer="fused", device=dev)(ids)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_capacity_tuner_on_the_card_matches_cpu(dev):
    """10 tuning steps on capacity-padded state: the card's codebooks
    equal the CPU's (the plain versions) to rtol 1e-4 / atol 2e-5, the
    tolerance the CPU run is held to against the reference; the pad
    codebook rows stay exactly zero on the card."""
    from repro_torch.core import ClusterEngine
    from repro_torch.data import drifting_coclusters
    from repro_torch.models import lightgcn as L
    from repro_torch.stream import CapacityTuner
    stream = drifting_coclusters(600, 480, k_true=12, avg_deg=10, T=2)
    g = stream.base
    sk = ClusterEngine(device="cpu").build(g, d=32, ratio=0.25)
    caps = {"n_users": 600, "n_items": 480, "k_users": 300, "k_items": 240,
            "n_edges": g.n_edges + sum(s.edge_u.size for s in stream.steps)}
    params = L.init_params(0, L.from_sketch(g, sk, dim=32))
    model = {"dim": 32, "n_layers": 3, "l2": 1e-4, "lookup_backend": None}
    out = {}
    for device in (dev, "cpu"):
        tuner = CapacityTuner(model, lr=5e-3, batch_size=256, caps=caps,
                              device=device)
        out[device] = tuner.tune(g, sk, params, 10, seed=3)
        if device == dev:
            assert not tuner._params["user_table"][sk.k_users:].any()
            assert not tuner._params["item_table"][sk.k_items:].any()
    for k in ("user_table", "item_table"):
        assert not np.array_equal(out[dev][k], params[k])
        np.testing.assert_allclose(out[dev][k], out["cpu"][k], rtol=1e-4,
                                   atol=2e-5)


@pytest.fixture(scope="module")
def frontdoor_versions():
    """A base export and its delta-shipped v2, trained on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import ClusterEngine
    from repro_torch.data import planted_coclusters
    from repro_torch.launch.load_bench import ship_v2
    from repro_torch.training import TrainConfig, Trainer
    g, _, _ = planted_coclusters(2000, 1500, 20, 10, seed=0)
    sk = ClusterEngine(device="cuda").build(g, d=32, ratio=0.25)
    tr = Trainer(g, sk, TrainConfig(dim=32, steps=20, batch_size=512,
                                    lr=5e-3, backend="fused"),
                 device="cuda")
    tr.run(log_every=0)
    base = tr.export()
    return base, ship_v2(tr, base, 10)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_frontdoor_swap_from_another_thread_on_the_card(
        dev, frontdoor_versions, quantized):
    import threading

    from repro_torch.frontdoor import Frontdoor, FrontdoorConfig
    from repro_torch.serve import BatchDispatcher
    base, v2 = frontdoor_versions
    if quantized:
        base, v2 = base.quantize(), v2.quantize()
    buckets = (1, 8, 64)
    fd = Frontdoor(FrontdoorConfig(k=20, buckets=buckets, scorer="fused",
                                   cache_entries=0, flush_ms=1.0,
                                   device=dev))
    fd.attach("web", base, capacity="auto")
    sess = fd.registry.session("web")
    warm = fd.state_allocations
    ptrs = {k: v.data_ptr() for k, v in {**sess.params,
                                         **sess.statics}.items()}
    got, errors, swapped = [], [], {}
    n_users = base.model["n_users"]

    def client(cid):
        rng = np.random.default_rng(cid)
        try:
            for _ in range(40):
                ids = rng.integers(0, n_users, int(rng.choice([1, 3, 8,
                                                               40])))
                got.append((ids, *fd(ids, tenant="web")))
        except Exception as e:                  # surface across threads
            errors.append(e)

    def swapper():
        time.sleep(0.05)
        swapped["out"] = fd.swap("web", v2)

    with fd:
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(3)] + [threading.Thread(target=swapper)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
    assert not errors, errors[0]
    assert swapped["out"]["mode"] == "swapped"
    assert swapped["out"]["session"]["state_allocations"] == 0
    assert fd.state_allocations == warm
    assert ptrs == {k: v.data_ptr() for k, v in {**sess.params,
                                                 **sess.statics}.items()}
    direct = [BatchDispatcher(a.session(k=20, scorer="fused", device=dev),
                              buckets) for a in (base, v2)]
    seen = set()
    for ids, vals, items in got:
        match = [v for v, d in enumerate(direct)
                 if all(np.array_equal(x, y)
                        for x, y in zip(d(ids), (vals, items)))]
        assert match, "a response is neither wholly v1 nor wholly v2"
        seen.update(match)
    assert seen == {0, 1}


# ---------------------------------------------------------------------------
# the streamed solve and the ordered W(k) sums on the card
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def rung_10k():
    from repro_torch.core import make_weights
    from repro_torch.launch import cluster_scale
    g, _ = cluster_scale.build_rung("10k")
    return g, make_weights(g, "hws")


@pytest.mark.parametrize("block_edges", [1 << 8, 1 << 20])
def test_streamed_equals_inmem_on_the_card(dev, rung_10k, block_edges):
    from repro_torch.launch import cluster_scale
    g, (wu, wv) = rung_10k
    lab, it, stats, _ = cluster_scale.solve_streamed(g, wu, wv, block_edges,
                                                     "cuda")
    ref, it_ref, _, _ = cluster_scale.solve_inmem(g, wu, wv, "cuda")
    cpu, it_cpu, _, _ = cluster_scale.solve_inmem(g, wu, wv, "cpu")
    np.testing.assert_array_equal(lab, ref)
    np.testing.assert_array_equal(lab, cpu)
    assert it == it_ref == it_cpu
    assert stats["peak_bytes_source"] == "max_memory_allocated"
    assert not any(isinstance(k, tuple) and k[0] == "torch_edges"
                   for k in g._cache)


def test_streamed_peak_below_inmem_on_the_card(dev, rung_10k):
    from repro_torch.core import ClusterEngine
    from repro_torch.launch import cluster_scale
    g, (wu, wv) = rung_10k
    ClusterEngine.drop_device_edges(g)
    _, _, stats, _ = cluster_scale.solve_streamed(g, wu, wv, 1 << 8, "cuda")
    _, _, _, peak = cluster_scale.solve_inmem(g, wu, wv, "cuda")
    assert 0 < stats["peak_device_bytes"] < peak


@pytest.mark.parametrize("case", ["random", "one_segment", "singletons",
                                  "empty"])
def test_ordered_segment_sum_is_its_plain_version_on_the_card(dev, case):
    from repro_torch.core import solver_torch
    g = torch.Generator().manual_seed(3)
    n = 5000
    m = {"empty": 0, "singletons": n}.get(case, 40_000)
    vals = torch.rand(m, generator=g) * 3.0 + 1e-3
    seg = {"random": torch.randint(0, 37, (m,), generator=g) * 97,
           "one_segment": torch.full((m,), 11),
           "singletons": torch.randperm(n, generator=g),
           "empty": torch.zeros(0, dtype=torch.int64)}[case]
    got = solver_torch.segment_sum_ordered(vals.to(dev), seg.to(dev), n)
    want = ref.segment_sum(vals.to(dev), seg.to(dev), n)
    cpu = solver_torch.segment_sum_ordered(vals, seg, n)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), cpu)
