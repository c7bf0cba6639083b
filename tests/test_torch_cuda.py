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
with the device sampler, and a warm chunk runs under sync-debug "error";
on an NCCL world of 1 the torch_sharded sketch and the fused_sharded
trainer are bitwise their unsharded twins.
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
within 2e-4 / 2e-5 in f32 and 2e-2 in bf16 and f16, also where a block
walks several short sequences (B 4,099) and at the paths' S 49, 50 and
200, and its tensor-core
route at a long causal sequence within one rounding step of the type
(rtol 1.5 x eps, atol 1e-4). The fused top-k redesign is held bitwise
(values and ids) on integer-valued inputs over k, row counts either side
of its 64-row block, ragged item counts and several widths; on items in
ascending score order (every score beats the running threshold); on
all-equal scores; and two calls repeat bitwise. Its chunk plan takes the
tiling and occupancy the build reports. An empty batch launches nothing.
Above one key a lane (k 33, 64, 100, 128: lists of 64 and 128 keys), both
variants, f32 and int8, are bitwise the plain version's order with masks,
exclusions, ±0 ties, NaN rows and all -inf rows, equal torch.topk's values
on finite scores, and never reach torch.topk; k 129 is refused. Each
recsys arch's smoke cell (DLRM, Wide&Deep, SASRec, BERT4Rec: serve,
retrieval, one AdamW step) on the card launches its kernels and equals
the CPU's plain path within rtol 1e-4 / atol 1e-5. The 16-bit
codebook_lookup (bf16, f16: 8, 4, 2 or 1 elements a lane, unaligned
tables) is bitwise its plain version, also at gemma2-9b's token
embedding (256,000 x 3,584, 4 and 32,768 rows), and a 16-bit lookup
that needs a gradient raises; each LM's smoke cells (train, prefill,
decode; the MoE LMs too) equal the CPU's within rtol 1e-4 / atol 1e-5,
and a bf16 prefill within rtol 2e-2 / atol 4e-2. The MoE's token
combine and dispatch-gather gradient (the 16-bit CSR gather-sum, k rows
a token, d 6,144 and 7,168) are bitwise their plain version at the MoE
LMs' shapes, as are few f32 rows wider than one column tile, and the
MoE FFN makes no host sync. The sliced AdamW update
and the per-leaf clip are bitwise the update before them on CUDA leaves.
The streamed LP solve gives the in-memory solve's labels on the card (and
the CPU's) at the 10k rung, with a lower peak of device memory, and the
solver's ordered W(k) sum (a stable sort and one CSR gather-sum) is
bitwise its plain version and the CPU's.
The measurement layer: ``host_seed`` (the seed step's ``index_add_``
propagation) trains on the card within 1e-4 of the CPU's losses;
``BenchRun.profile`` on a CUDA run exports a Chrome trace with device
events, the codebook_lookup and CSR gather-sum kernels among them; the
card's fingerprint carries its ``power_limit_w``. The paper's Figure 4
counts the same labels at each iteration on the card as on the CPU.
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
from repro_torch.embedding import embedding_lookup
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
        fused_topk(u, torch.randn(400, 8, device=dev), 129)  # above the
                                                  # k cap (128)
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


@pytest.mark.parametrize("case", ["skewed", "repeats", "no_values",
                                  "no_rows"])
@pytest.mark.parametrize("d", [1, 3, 64, 129, 3584])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_csr_gather_sum_16bit_kernel_bitwise(dev, dtype, case, d, aligned):
    """The 16-bit instantiation (f32 sums rounded once to the dtype)
    bitwise its plain version: skewed bags (4,000-value rows, empty
    rows), one row of 1,000 repeats of one id between two empty rows (a
    frequent token), no values, no rows; at d 3,584 (the LM token
    table), odd widths, and a table 2 bytes off alignment."""
    g = torch.Generator().manual_seed(11 + d)
    n_src = 1000
    flat = (torch.randn(n_src * d + 1, generator=g) * 3).to(dtype).to(dev)
    src = (flat[:n_src * d] if aligned else flat[1:]).view(n_src, d)
    if case == "skewed":
        idx, ptr = _skewed_csr(600, n_src, g)
    elif case == "repeats":
        idx = torch.full((1000,), 7, dtype=torch.int32)
        ptr = torch.tensor([0, 0, 1000, 1000], dtype=torch.int64)
    else:
        rows = {"no_values": 5, "no_rows": 0}[case]
        idx = torch.zeros(0, dtype=torch.int32)
        ptr = torch.zeros(rows + 1, dtype=torch.int64)
    idx, ptr = idx.to(dev), ptr.to(dev)
    before = (csr_gather_sum.launches, csr_gather_sum.launches_16)
    got = csr_gather_sum(src, idx, ptr)
    assert (csr_gather_sum.launches, csr_gather_sum.launches_16) == (
        before[0] + 1, before[1] + 1)
    assert got.dtype == dtype and got.shape == (ptr.numel() - 1, d)
    assert torch.equal(got, ref.csr_gather_sum(src, idx, ptr))
    if case == "repeats":
        want = src[7].float() * 1000          # exact: 1,000 x one value
        assert torch.equal(got[1], want.to(dtype))
        assert not got[0].any() and not got[2].any()
    with pytest.raises(TypeError, match="f32 src"):
        csr_gather_sum(src, idx, ptr, torch.ones(idx.shape, device=dev))


def test_bf16_lookup_gradient_runs_the_16bit_kernel(dev):
    """A bf16 token lookup's gradient on the card (the "cuda" backend):
    the 16-bit CSR gather-sum, once, bitwise the CPU's plain path."""
    g = torch.Generator().manual_seed(3)
    table = torch.randn(5000, 256, generator=g).to(torch.bfloat16)
    ids = torch.randint(0, 5000, (4, 512), generator=g)
    ids[:, ::3] = 11                                  # a frequent token
    cot = torch.randn(4, 512, 256, generator=g).to(torch.bfloat16)
    grads = []
    for device in ("cpu", dev):
        t = table.to(device).detach().requires_grad_(True)
        out = embedding_lookup(t, ids.to(device), backend="cuda")
        before = csr_gather_sum.launches_16
        out.backward(cot.to(device))
        grads.append(t.grad.cpu())
    assert csr_gather_sum.launches_16 == before + 1
    assert grads[1].dtype == torch.bfloat16
    assert torch.equal(grads[0], grads[1])


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
@pytest.mark.parametrize("sq,skv", [(200, 328), (256, 256), (64, 1),
                                    (49, 49), (50, 50), (200, 200)])
def test_flash_attention_kernel(dev, dtype, d, causal, sq, skv):
    g = torch.Generator().manual_seed(d + sq + skv)
    q, k, v = (torch.randn(2, 3, s, d, generator=g).to(FLOATS[dtype]).to(dev)
               for s in (sq, skv, skv))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    assert got.shape == q.shape
    _close(got, ref.flash_attention(q, k, v, causal=causal), dtype)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,sq,skv,d", [(4099, 49, 49, 50), (4099, 50, 50, 32),
                                        (300, 20, 49, 50), (300, 49, 20, 50),
                                        (300, 49, 20, 32), (300, 1, 1, 50)])
def test_flash_attention_kernel_many_short_sequences(dev, causal, b, sq, skv,
                                                     d):
    """Short sequences (Skv within one key tile): each block walks several
    (b, h) sequences, the next one's copies in flight; B 4,099 is not a
    multiple of any grid. Sq != Skv keeps the top-left causal mask."""
    g = torch.Generator().manual_seed(b + sq + skv + d)
    q, k, v = (torch.randn(b, 1, s, d, generator=g).to(dev)
               for s in (sq, skv, skv))
    before = flash_attention.launches_cc
    got = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches_cc == before + 1
    _close(got, ref.flash_attention(q, k, v, causal=causal), "f32")


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
    assert _tiling(dev, 64, codebook, quantized, 20) == (64, 64, 2 * sms)
    assert _tiling(dev, 256, codebook, quantized, 20) == (64, 64, sms)
    # a list of 64 keys a row (k 33..64) in 64-row blocks, and of 128 keys
    # (k 65..128) in 48-row blocks, with 88 candidate slots a row: two
    # blocks per SM at d 64 (~115 KB each), one at d 256
    for k, rows in ((64, 64), (100, 48)):
        assert _tiling(dev, 64, codebook, quantized, k) == (rows, 64, 2 * sms)
        assert _tiling(dev, 256, codebook, quantized, k) == (rows, 64, sms)


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


def _large_k_case(variant, case, rows, n, d, g):
    """An integer-valued top-k case with the edge the name asks for:
    "mask" (-inf on all but 150 items), "exclude" (400 random pairs and
    each row's 10 best items), "zeros" (items of all-zero rows beside
    -0.0 scores: ±0 ties), "nan" (a NaN query row and NaN items), "ninf"
    (a row of -inf scores: every item masked)."""
    u, items, kw = _topk_case(variant, rows, n, d, g)
    if case == "mask":
        kw["mask"] = torch.full((n,), float("-inf"))
        kw["mask"][torch.randperm(n, generator=g)[:150]] = 0.0
    elif case == "exclude":
        _, top = ref.fused_topk(u, items, 10, **kw)
        r = torch.cat([torch.arange(rows).repeat_interleave(10),
                       torch.randint(0, rows, (400,), generator=g)])
        c = torch.cat([top.reshape(-1).long(),
                       torch.randint(0, n, (400,), generator=g)])
        kw["exclude"] = (r, c)
    elif case == "zeros":
        u[::2] = -u[::2]
        u[1::3] = 0.0
        u[2::3, 0] = -1.0
        u[2::3, 1:] = 0.0                 # rows scoring -0.0 on zero items
        zero = torch.arange(0, n if variant != "codebook" else 211, 7)
        items[zero] = 0
    elif case == "nan":
        u[3] = float("nan")
        items = items.float() if variant != "int8" else items
        if variant == "int8":
            kw["scale"][[7, 123, n - 1]] = float("nan")
        else:
            items[[7, 123, items.shape[0] - 1]] = float("nan")
    elif case == "ninf":
        kw["mask"] = torch.zeros(n)
        kw["exclude"] = (torch.full((n,), 5), torch.arange(n))
    return u, items, kw


@pytest.mark.parametrize("variant", ["dense", "int8", "codebook"])
@pytest.mark.parametrize("k", [33, 64, 100, 128])
@pytest.mark.parametrize("case", ["plain", "mask", "exclude", "zeros", "nan",
                                  "ninf"])
def test_fused_topk_large_k_exact(dev, variant, k, case):
    """k above one key a lane (lists of 64 and 128 keys): bitwise the
    plain version's order (NaN first, value descending, the lower id; -0.0
    ties +0.0), which on finite scores is torch.topk's values; both
    kernel variants launch, and two calls repeat bitwise."""
    g = torch.Generator().manual_seed(k * 13 + len(case))
    u, items, kw = _large_k_case(variant, case, 97, 4099, 64, g)
    u, items = u.to(dev), items.to(dev)
    kw = {key: (tuple(t.to(dev) for t in val) if key == "exclude"
                else val.to(dev)) for key, val in kw.items()}
    counter = fused_topk_codebook if variant == "codebook" else fused_topk
    before = counter.launches
    got = fused_topk(u, items, k, **kw)
    assert counter.launches == before + 1
    want = ref.fused_topk(u, items, k, **kw)
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0,
                               equal_nan=True)
    if case != "nan":
        scores = u @ ref.expand_items(items, kw.get("scale"),
                                      kw.get("sketch")).T
        if "mask" in kw:
            scores = scores + kw["mask"]
        if case in ("exclude", "ninf"):
            r, c = kw["exclude"]
            scores[r.long(), c.long()] = float("-inf")
        assert torch.equal(got[0], torch.topk(scores, k).values)
    if case == "nan":
        assert torch.isnan(got[0][3]).all()
    if case == "ninf":
        assert torch.equal(got[1][5].cpu(), torch.arange(k, dtype=torch.int32))
    again = fused_topk(u, items, k, **kw)
    assert torch.equal(again[0].nan_to_num(), got[0].nan_to_num())
    assert torch.equal(again[1], got[1])


@pytest.mark.parametrize("variant", ["dense", "codebook"])
@pytest.mark.parametrize("block", [None, 61])
def test_fused_topk_large_k_ascending_and_equal_scores(dev, variant, block):
    """k 100 and 128 on items in ascending score order (every score beats
    the running threshold: each tile pushes all its items) and on all-equal
    scores (the lowest ids win, in order)."""
    n, d = 5003, 64
    u = torch.zeros(70, d)
    u[:, 0] = 1.0
    u[1::2, 0] = -1.0
    table = torch.zeros(n, d)
    table[:, 0] = torch.arange(n, dtype=torch.float32)
    kw = {}
    if variant == "codebook":
        kw["sketch"] = torch.arange(n, dtype=torch.int32)[:, None].to(dev)
    u, table = u.to(dev), table.to(dev)
    for k in (100, 128):
        got = fused_topk(u, table, k, block=block, **kw)
        want = ref.fused_topk(u, table, k, **kw)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
        assert torch.equal(got[1][0].cpu(), torch.arange(
            n - 1, n - 1 - k, -1, dtype=torch.int32))
        flat = fused_topk(torch.zeros_like(u), table, k, block=block, **kw)
        assert torch.equal(flat[1].cpu(), torch.arange(
            k, dtype=torch.int32).expand(70, k))


def test_fused_topk_large_k_never_calls_torch_topk(dev, monkeypatch):
    """k above 32 launches the kernel: no torch.topk (nor torch.sort)
    anywhere on the call."""
    g = torch.Generator().manual_seed(9)
    u, items, _ = _topk_case("dense", 33, 3001, 64, g)
    u, items = u.to(dev), items.to(dev)
    want = ref.fused_topk(u, items, 100)

    def refuse(*a, **k):
        raise AssertionError("torch.topk/torch.sort reached")

    monkeypatch.setattr(torch, "topk", refuse)
    monkeypatch.setattr(torch, "sort", refuse)
    before = fused_topk.launches
    got = fused_topk(u, items, 100)
    assert fused_topk.launches == before + 1
    monkeypatch.undo()
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.parametrize("variant", ["dense", "int8", "codebook"])
@pytest.mark.parametrize("k", [33, 64, 100, 128])
@pytest.mark.parametrize("rows", [1, 8, 130])
@pytest.mark.parametrize("block", [None, 37, 300])
def test_fused_topk_long_lists_many_chunks_exact(dev, variant, k, rows,
                                                 block):
    """Lists of 64 and 128 keys over many chunks (37- and 300-item chunks:
    136 and 17 a row) and the plan's own: bitwise the plain version on
    integer inputs, with the rows' shared bounds (where rows x keys a lane
    reach 256: 130 rows) and without (1 and 8 rows), over 48-row groups at k
    above 64 (130 rows: three groups, the last of 34 rows); with fewer
    than k finite scores and with exclusions of each row's best items."""
    g = torch.Generator().manual_seed(k * 7 + rows + (block or 0))
    u, items, kw = _topk_case(variant, rows, 4999, 64, g)
    n = 4999
    cases = [{}]
    mask = torch.full((n,), float("-inf"))
    mask[torch.randperm(n, generator=g)[:k // 2]] = 0.0   # < k finite
    cases.append({"mask": mask})
    _, top = ref.fused_topk(u, items, 8, **kw)
    cases.append({"exclude": (torch.arange(rows).repeat_interleave(8),
                              top.reshape(-1).long())})
    u, items = u.to(dev), items.to(dev)
    kw = {key: val.to(dev) for key, val in kw.items()}
    for extra in cases:
        extra = {key: (tuple(t.to(dev) for t in val) if key == "exclude"
                       else val.to(dev)) for key, val in extra.items()}
        got = fused_topk(u, items, k, block=block, **kw, **extra)
        want = ref.fused_topk(u, items, k, **kw, **extra)
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("variant", ["dense", "codebook"])
@pytest.mark.parametrize("k", [33, 64, 100, 128])
@pytest.mark.parametrize("block", [None, 61])
def test_fused_topk_long_lists_ties_at_the_bound(dev, variant, k, block):
    """130 rows (the shared bounds on at every long list): ascending item
    scores (every item beats every chunk's list, so each published key is
    overtaken), descending ones, and all-equal scores, where the bound's
    key ties the k-th key by value and only the id orders them."""
    n, d = 5003, 64
    u = torch.zeros(130, d)
    u[:, 0] = 1.0
    u[1::2, 0] = -1.0
    table = torch.zeros(n, d)
    table[:, 0] = torch.arange(n, dtype=torch.float32)
    kw = {}
    if variant == "codebook":
        kw["sketch"] = torch.arange(n, dtype=torch.int32)[:, None].to(dev)
    u, table = u.to(dev), table.to(dev)
    got = fused_topk(u, table, k, block=block, **kw)
    want = ref.fused_topk(u, table, k, **kw)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert torch.equal(got[1][0].cpu(), torch.arange(
        n - 1, n - 1 - k, -1, dtype=torch.int32))
    assert torch.equal(got[1][1].cpu(), torch.arange(k, dtype=torch.int32))
    flat = fused_topk(torch.zeros_like(u), table, k, block=block, **kw)
    assert torch.equal(flat[1].cpu(), torch.arange(
        k, dtype=torch.int32).expand(130, k))
    assert torch.equal(flat[0], torch.zeros(130, k, device=dev))


@pytest.mark.parametrize("k", [33, 64, 100, 128])
@pytest.mark.parametrize("rows", [8, 64])
def test_fused_topk_shared_bounds_on_and_off(dev, monkeypatch, k, rows):
    """At the serving shape (N 91,599, d 64) in 704-item chunks (131 a
    row), with the rows' shared bounds forced on and off
    (``_SHARE_WORK``), ten calls each: integer inputs bitwise the plain
    version, seeded float rows bitwise alike across all twenty calls."""
    mod = importlib.import_module("repro_torch.kernels.fused_topk")
    g = torch.Generator().manual_seed(k + rows)
    u, items, _ = _topk_case("dense", rows, 91599, 64, g)
    u, items = u.to(dev), items.to(dev)
    want = ref.fused_topk(u, items, k)
    gf = torch.Generator(device=dev).manual_seed(k)
    uf = torch.randn(rows, 64, generator=gf, device=dev)
    vf = torch.randn(91599, 64, generator=gf, device=dev)
    first = None
    for work in (0, 1 << 62):
        monkeypatch.setattr(mod, "_SHARE_WORK", work)
        for _ in range(10):
            got = fused_topk(u, items, k, block=704)
            assert torch.equal(got[1], want[1])
            assert torch.equal(got[0], want[0])
            f = fused_topk(uf, vf, k, block=704)
            first = f if first is None else first
            assert torch.equal(f[1], first[1]) and torch.equal(f[0], first[0])


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev, copy=True)


@pytest.mark.parametrize("arch", ["dlrm-mlperf-baco", "wide-deep-baco",
                                  "sasrec-baco", "bert4rec-baco"])
@pytest.mark.parametrize("shape", ["serve_p99", "retrieval_cand",
                                   "train_batch"])
def test_arch_cell_kernels_on_the_card(dev, arch, shape):
    """Each recsys arch's smoke cell on the card (lookups through
    codebook_lookup, DLRM's interaction through dot_interaction, the
    attention through flash_attention's CUDA-core route, the train
    cells' backward through the CSR gather-sum) against the same cell on
    the CPU's plain versions with the same params: scores, and one AdamW
    step's loss and params, within rtol 1e-4 / atol 1e-5."""
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import recsys as rs
    from repro_torch.training.optimizer import adamw

    cpu = build_cell(arch, shape, smoke=True, device="cpu")
    gpu = build_cell(arch, shape, smoke=True, device=dev)
    params = _to_device(cpu.args[0], dev)
    args = (params,) + tuple(gpu.args[1:])
    if cpu.kind == "train":
        args = (params, adamw(lr=1e-3).init(rs.flat_params(params)),
                gpu.args[2], gpu.args[3])
    kernels = [codebook_lookup, dot_interaction, flash_attention,
               csr_gather_sum]
    before = [k.launches for k in kernels]
    cc = flash_attention.launches_cc
    got, want = gpu.fn(*args), cpu.fn(*cpu.args)
    ran = [k.launches - b for k, b in zip(kernels, before)]
    assert ran[0] > 0
    assert (ran[1] > 0) == arch.startswith("dlrm")
    seq = arch.startswith(("sasrec", "bert4rec"))
    assert (ran[2] > 0) == seq and (flash_attention.launches_cc - cc) == ran[2]
    assert (ran[3] > 0) == (cpu.kind == "train")
    if cpu.kind == "train":
        pairs = [(got[2], want[2])] + [
            (rs.flat_params(got[0])[k], v)
            for k, v in rs.flat_params(want[0]).items()]
    else:
        pairs = [(got, want)]
    for g, w in pairs:
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-5)


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


def test_sharded_world_of_one_on_the_card(dev):
    """An NCCL world of 1: the torch_sharded sketch and the fused_sharded
    trainer (its all-reduce on the card, a warm chunk free of host syncs)
    bitwise their unsharded twins; the world ends with the block."""
    import torch.distributed as dist

    from repro_torch.core import ClusterEngine
    from repro_torch.distributed import world
    from repro_torch.training import TrainConfig, Trainer
    g, sk = _small_training_setup()
    cfg = TrainConfig(dim=32, steps=24, batch_size=256, lr=5e-3,
                      chunk_size=8)
    with world("cuda") as d:
        assert dist.get_backend() == "nccl"
        a = ClusterEngine(device=str(d)).build(g, d=32, ratio=0.3)
        b = ClusterEngine(solver="torch_sharded", device=str(d)).build(
            g, d=32, ratio=0.3)
        assert np.array_equal(a.user_idx, b.user_idx)
        assert np.array_equal(a.item_idx, b.item_idx)
        assert a.meta["gamma"] == b.meta["gamma"]
        out = {}
        for backend in ("fused", "fused_sharded"):
            tr = Trainer(g, sk, TrainConfig(**{**cfg.__dict__,
                                               "backend": backend}), device=d)
            out[backend] = (tr.run(log_every=0), tr)
        assert out["fused"][0] == out["fused_sharded"][0]
        for k, v in out["fused"][1].params.items():
            assert torch.equal(out["fused_sharded"][1].params[k], v)
        tr = out["fused_sharded"][1]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            losses = tr.backend.chunk(tr, 8)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert torch.isfinite(losses).all()
    assert not dist.is_initialized()


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


# ---------------------------------------------------------------------------
# the measurement layer on the card
# ---------------------------------------------------------------------------
def test_host_seed_trains_on_the_card(dev):
    from repro_torch.core import ClusterEngine
    from repro_torch.data import planted_coclusters
    from repro_torch.training import TrainConfig, Trainer
    g, _, _ = planted_coclusters(300, 240, 10, 8, seed=2)
    sk = ClusterEngine(device="cpu").build(g, d=16, ratio=0.3)
    cfg = TrainConfig(dim=16, steps=8, batch_size=128, lr=5e-3, seed=0,
                      backend="host_seed", sampler="numpy")
    losses = {d: Trainer(g, sk, cfg, device=d).run(log_every=0)
              for d in ("cuda", "cpu")}
    # index_add_ on the card adds in no fixed order: a tolerance, not bits
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


def test_benchrun_profile_records_device_events(dev, tmp_path):
    import json

    from repro_torch.kernels import csr_gather_sum
    from repro_torch.results import BenchRun
    run = BenchRun("kernel")
    run.parse(["--profile", "--profile-dir", str(tmp_path),
               "--store", str(tmp_path / "store")])
    assert run.device.type == "cuda"
    cb = torch.randn(64, 16, device=dev)
    idx = torch.randint(0, 64, (256, 2), device=dev, dtype=torch.int32)
    ptr = torch.arange(0, 257, device=dev, dtype=torch.int64)
    with run.profile("kernels"):
        codebook_lookup(cb, idx)
        csr_gather_sum(cb, idx[:, 0].contiguous(), ptr)
        torch.cuda.synchronize()
    (n,) = run.device_events
    assert n >= 2
    trace = json.load(open(tmp_path / "kernel" / "kernels" / "trace.json"))
    kernels = [e["name"] for e in trace["traceEvents"]
               if e.get("cat") == "kernel"]
    assert any("codebook_lookup" in k for k in kernels)
    assert any("csr_gather_sum" in k for k in kernels)


def test_fingerprint_carries_the_power_limit(dev):
    from repro_torch.results import fingerprint, fingerprint_key
    fp = fingerprint("cuda")
    assert fp["platform"] == "gpu"
    assert fp["device_kind"] == torch.cuda.get_device_name(0)
    assert fp["power_limit_w"] > 0
    assert fingerprint_key(fp).endswith(f":{fp['power_limit_w']:g}W")


# ---------------------------------------------------------------------------
# 16-bit codebook_lookup (the LM token embedding) and the dense LM cells
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("h", [1, 2, 3])
@pytest.mark.parametrize("d", [1, 3, 50, 64, 130, 256, 3584])
@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_codebook_lookup_kernel_16bit_bitwise(dev, dtype, h, d, binary,
                                              aligned):
    # 8, 4, 2 and 1 elements a lane; a codebook 2 bytes off alignment;
    # B not a multiple of a strip; B = 0; the output in the codebook's type
    g = torch.Generator().manual_seed(h * 1000 + d)
    flat = (torch.randn(301 * d + 1, generator=g) * 4).to(dtype).to(dev)
    z = (flat[:301 * d] if aligned else flat[1:]).view(301, d)
    idx = torch.randint(0, 301, (1037, h), generator=g, dtype=torch.int32)
    if h > 1:
        idx[::2, -1] = idx[::2, 0]
    idx = idx.to(dev)
    before = codebook_lookup.launches
    got = codebook_lookup(z, idx, binary=binary)
    assert codebook_lookup.launches == before + 1 and got.dtype == dtype
    assert torch.equal(got, ref.codebook_lookup(z, idx, binary=binary))
    assert codebook_lookup(z, idx[:0], binary=binary).shape == (0, d)


@pytest.mark.parametrize("rows", [4, 32768])
def test_codebook_lookup_16bit_at_the_lm_shapes(dev, rows):
    """gemma2-9b's token embedding (256,000 x 3,584 bf16): decode's B
    rows and the prefill's 32,768, bitwise the plain version; a lookup
    that needs a gradient runs the 16-bit CSR gather-sum backward,
    bitwise its plain version."""
    g = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn(256000, 3584, generator=g, device=dev).to(
        torch.bfloat16)
    ids = torch.randint(0, 256000, (1, rows), generator=g, device=dev)
    eng = EmbeddingEngine(EmbeddingSpec(n_rows=256000, dim=3584))
    before = codebook_lookup.launches
    with torch.inference_mode():
        out = eng.full_lookup(table, ids)
    assert codebook_lookup.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == (1, rows, 3584)
    assert torch.equal(out[0], ref.codebook_lookup(table, ids.reshape(-1, 1)
                                                   .int()))
    table.requires_grad_(True)
    out = eng.full_lookup(table, ids)
    cot = torch.randn(out.shape, generator=g, device=dev).to(torch.bfloat16)
    before = csr_gather_sum.launches_16
    out.backward(cot)
    assert csr_gather_sum.launches_16 == before + 1
    flat = ids.reshape(-1)
    order = torch.sort(flat, stable=True)
    want = ref.csr_gather_sum(cot.reshape(-1, 3584), order.indices.int(),
                              torch.searchsorted(order.values, torch.arange(
                                  256001, device=dev)))
    assert torch.equal(table.grad, want)


@pytest.mark.parametrize("rows", [1, 2, 4, 8, 64, 4096, 32768])
@pytest.mark.parametrize("d", [3584, 5120, 7168])
def test_codebook_lookup_16bit_schedules_bitwise(dev, rows, d):
    """The 16-bit lookup at the LM widths, from decode's few rows (a unit
    a thread) to the prefill's 32,768 (four units a thread): bitwise the
    plain version, word for word, on a table holding a -0.0 row (+0
    comes out) and a NaN row (the canonical NaN comes out) among the
    looked-up rows."""
    g = torch.Generator(device=dev).manual_seed(rows + d)
    table = torch.randn(4096, d, generator=g, device=dev).to(torch.bfloat16)
    ids = torch.randint(0, 4096, (rows, 1), generator=g, device=dev,
                        dtype=torch.int32)
    table[ids[0, 0]] = -0.0
    table[ids[-1, 0]] = float("nan")
    got = codebook_lookup(table, ids)
    want = ref.codebook_lookup(table, ids)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    if rows > 1:
        assert torch.equal(got[-1].view(torch.int16),
                           want[-1].view(torch.int16))
        assert bool(torch.isnan(got[-1]).all())
    if ids[0, 0] != ids[-1, 0]:
        assert not bool(torch.signbit(got[0].float()).any())


@pytest.mark.parametrize("h", [1, 2, 3])
@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_codebook_lookup_16bit_wide_schedule_multi_hot(dev, dtype, h, binary,
                                                       aligned):
    """Four units a thread (4,099 rows x 3,584 / 8 words: more than the
    card holds at once) with H 1-3, duplicates under binary, and a table
    2 bytes off alignment (one element a word): bitwise the plain
    version."""
    g = torch.Generator().manual_seed(h * 10 + binary)
    d = 3584
    flat = (torch.randn(97 * d + 1, generator=g) * 4).to(dtype).to(dev)
    z = (flat[:97 * d] if aligned else flat[1:]).view(97, d)
    idx = torch.randint(0, 97, (4099, h), generator=g, dtype=torch.int32)
    if h > 1:
        idx[::3, -1] = idx[::3, 0]
    idx = idx.to(dev)
    got = codebook_lookup(z, idx, binary=binary)
    want = ref.codebook_lookup(z, idx, binary=binary)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["gemma2-9b", "gemma3-12b", "qwen1.5-32b",
                                  "dbrx-132b", "kimi-k2-1t-a32b"])
def test_lm_smoke_cells_on_the_card(dev, arch, shape):
    """Each LM's smoke cell on the card (the token lookup through
    codebook_lookup; a MoE's token combine and dispatch gradient through
    the CSR gather-sum) equals the CPU's plain path on the same params:
    logits and cache, or one AdamW step's loss and params, within rtol
    1e-4 / atol 1e-5 (f32 GEMMs sum in another order)."""
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import recsys as rs

    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = build_cell(arch, shape, smoke=True, device="cpu")
    gpu = build_cell(arch, shape, smoke=True, device=dev)
    args = (_to_device(cpu.args[0], dev),) + tuple(
        _to_device(a, dev) for a in cpu.args[1:])
    before = codebook_lookup.launches
    before_eb = csr_gather_sum.launches
    got, want = gpu.fn(*args), cpu.fn(*cpu.args)
    assert codebook_lookup.launches > before
    # the token gradient once a train step; a MoE's combine once a layer
    # (2 layers), in training also its recompute and the dispatch gradient
    train = cpu.kind == "train"
    moe_layers = 2 if arch in ("dbrx-132b", "kimi-k2-1t-a32b") else 0
    assert csr_gather_sum.launches == before_eb + int(train) + moe_layers * (
        3 if train else 1)
    if cpu.kind == "train":
        pairs = [(got[2], want[2])] + [
            (rs.flat_params(got[0])[k], v)
            for k, v in rs.flat_params(want[0]).items()]
    else:
        pairs = [(got[0], want[0])] + [(got[1][k], v)
                                       for k, v in want[1].items()]
    for a, b in pairs:
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ["gemma2-9b", "qwen1.5-32b"])
def test_lm_bf16_prefill_on_the_card(dev, arch):
    """A bf16 variant of the smoke config: the card's prefill (bf16 token
    lookup through the kernel) equals the CPU's within rtol 2e-2 / atol
    4e-2 (bf16 roundings after sums in another order), and the residual
    stream has the reference's dtype (f32 for gemma2, bf16 for qwen)."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(registry.get_arch(arch).smoke_config(),
                              dtype="bfloat16")
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    want = T.prefill(params, {"tokens": tokens}, cfg, max_seq=16)
    got = T.prefill(_to_device(params, dev), {"tokens": tokens.to(dev)},
                    cfg, max_seq=16)
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=2e-2, atol=4e-2)
    for k, v in want[1].items():
        torch.testing.assert_close(got[1][k].cpu(), v, rtol=2e-2, atol=4e-2)


@pytest.mark.parametrize("t,k,d", [(8, 4, 6144), (64, 8, 7168),
                                   (4096, 4, 6144), (32768, 4, 6144),
                                   (32768, 8, 7168)])
def test_csr_gather_sum_16bit_at_the_moe_shapes(dev, t, k, d):
    """The MoE's token combine and its dispatch gather's gradient at the
    MoE LMs' shapes (dbrx's decode, kimi-k2's decode, dbrx's train
    microbatch, dbrx's and kimi-k2's prefill: t tokens of k rows each,
    bf16 rows of d 6,144 or 7,168 walked in column tiles, the rows in a
    random expert-sorted order): ``transformer._Combine`` forward and
    ``transformer._Gather`` backward each launch the 16-bit kernel once,
    bitwise its plain version (f32 sums in row order, one rounding); the
    combine's backward and the gather's forward are ``index_select``."""
    from repro_torch.models import transformer as T

    g = torch.Generator(device=dev).manual_seed(0)
    tok = torch.randperm(t * k, generator=g, device=dev) // k
    perm = torch.sort(tok, stable=True).indices.int()
    ptr = torch.arange(0, t * k + 1, k, device=dev)
    rows = torch.randn(t * k, d, generator=g, device=dev).to(torch.bfloat16)
    want = ref.csr_gather_sum(rows, perm, ptr)
    xt = torch.randn(t, d, generator=g, device=dev).to(torch.bfloat16)
    for fn, x in ((T._Combine, rows), (T._Gather, xt)):
        x = x.clone().requires_grad_(True)
        before = csr_gather_sum.launches_16
        out = fn.apply(x, tok, perm, ptr)
        if fn is T._Combine:
            assert csr_gather_sum.launches_16 == before + 1
            assert out.shape == (t, d) and torch.equal(out, want)
            cot = torch.randn(t, d, generator=g, device=dev).to(x.dtype)
        else:
            assert torch.equal(out, xt[tok])
            cot = rows
        before = csr_gather_sum.launches_16
        out.backward(cot)
        if fn is T._Combine:
            assert torch.equal(x.grad, cot[tok])
        else:
            assert csr_gather_sum.launches_16 == before + 1
            assert torch.equal(x.grad, want)


@pytest.mark.parametrize("rows,d", [(1, 6144), (8, 1000), (8, 4100),
                                    (64, 7168)])
def test_csr_gather_sum_f32_few_wide_rows(dev, rows, d):
    """f32 rows wider than one column tile (d > 128) in few strips: the
    column tiles of a strip are dealt to several warps, each the same
    fold, so the result is bitwise the plain version's; one launch a
    call. 0-40 values a row, one of 40 (a long row); d 1,000 and 4,100
    are not a multiple of 32 lane words."""
    g = torch.Generator().manual_seed(rows + d)
    lens = torch.randint(0, 41, (rows,), generator=g)
    lens[rows // 2] = 40
    ptr = torch.cat([torch.zeros(1, dtype=torch.int64),
                     torch.cumsum(lens, 0)]).to(dev)
    idx = torch.randint(0, 300, (int(lens.sum()),), generator=g,
                        dtype=torch.int32).to(dev)
    src = torch.randn(300, d, generator=g).to(dev)
    before = csr_gather_sum.launches
    got = csr_gather_sum(src, idx, ptr)
    assert csr_gather_sum.launches == before + 1
    assert torch.equal(got, ref.csr_gather_sum(src, idx, ptr))


def test_moe_ffn_makes_no_host_sync(dev):
    """The MoE FFN (routing, the sort-based plan, the dispatch with its
    trash row, the expert GEMMs, the combine) runs under
    ``torch.cuda.set_sync_debug_mode("error")``: decode stays free of
    syncs."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(registry.get_arch("kimi-k2-1t-a32b")
                              .smoke_config(), dtype="bfloat16")
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    lp = {k: v[0] for k, v in params["blocks"].items()}
    x = torch.randn(8, 1, cfg.d_model, device=dev).to(torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            y = T._mlp_moe(x, lp, 0, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_update_bitwise_the_unsliced_one_on_the_card(dev, name,
                                                               monkeypatch):
    """The AdamW update over flat slices (``optimizer._SLICE`` set to
    4,096, so the 3 x 5,000-element leaf spans four) and the clip applied
    a leaf at a time, on CUDA leaves (f32, bf16, 0-dim, strided), against
    the update as it was (``tests/torch_optimizer_before.py``): params
    and state bitwise after 3 updates; Adafactor too."""
    import torch_optimizer_before as before

    from repro_torch.training import optimizer

    monkeypatch.setattr(optimizer, "_SLICE", 4096)
    g = torch.Generator().manual_seed(0)
    params, grads = before.random_leaves(g, dev)
    params["w"] = torch.randn(3, 5000, generator=g).to(torch.bfloat16).to(dev)
    grads["w"] = torch.randn(3, 5000, generator=g).to(torch.bfloat16).to(dev)
    old_params = {k: v.clone() for k, v in params.items()}
    kw = {"grad_clip": 1.0}
    opt = getattr(optimizer, name)(**kw)
    state, old_state = opt.init(params), opt.init(old_params)
    old_update = {"adamw": before.adamw_update,
                  "adafactor": before.adafactor_update}[name]
    for _ in range(3):
        opt.update(grads, state, params)
        old_update(grads, old_state, old_params, **kw)
    for k in params:
        assert torch.equal(params[k], old_params[k]), k
    leaves = (lambda st: [v for k in ("m", "v") for _, v in
                          sorted(st[k].items())]) if name == "adamw" else (
        lambda st: [v for f in st["fac"] for _, v in sorted(f.items())])
    for a, b in zip(leaves(state), leaves(old_state)):
        assert torch.equal(a, b)


def test_fig4_label_counts_on_the_card_equal_the_cpu(dev):
    """The paper's Figure 4 (``launch.paper.fig4_convergence``) on
    gowalla_s: the label count after each of the 8 capped solves on the
    card equals the CPU port's."""
    from repro_torch.launch.paper import fig4_convergence
    (ds,) = fig4_convergence.datasets(fast=True)
    _, _, _, train, _ = fig4_convergence.get_dataset(ds)
    card = [k for _, _, k in fig4_convergence.label_counts(train, "cuda")]
    cpu = [k for _, _, k in fig4_convergence.label_counts(train, "cpu")]
    assert len(card) == 8 and card == cpu
