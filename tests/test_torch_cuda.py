"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip without an NVIDIA GPU (run them there with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``).
Exact on integer-valued inputs (every sum exact, so any order agrees);
the codebook lookup and the bag sums are bitwise on any input (same
additions, same order); NaN scores rank first, lowest id first, in both
the kernel and the plain version; the lookups' kernel gradients are
bitwise equal across runs and within 1e-5 of the gather backend's.
"""
import numpy as np
import pytest
import torch

from repro_torch.embedding import (EmbeddingEngine, EmbeddingSpec,
                                   embed_lookup)
from repro_torch.embedding import embedding_bag as te_embedding_bag
from repro_torch.kernels import (codebook_lookup, csr_gather_sum,
                                 embedding_bag, fused_topk,
                                 fused_topk_codebook, ref)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("h", [1, 2, 3])
@pytest.mark.parametrize("binary", [False, True])
def test_codebook_lookup_kernel_bitwise(dev, h, binary):
    g = torch.Generator().manual_seed(h)
    z = torch.randn(501, 64, generator=g).to(dev)
    idx = torch.randint(0, 501, (4099, h), generator=g, dtype=torch.int32)
    if h > 1:
        idx[::2, -1] = idx[::2, 0]
    idx = idx.to(dev)
    before = codebook_lookup.launches
    got = codebook_lookup(z, idx, binary=binary)
    assert codebook_lookup.launches == before + 1
    assert torch.equal(got, ref.codebook_lookup(z, idx, binary=binary))


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


def test_embedding_bag_kernel_bitwise(dev):
    g = torch.Generator().manual_seed(7)
    table = torch.randn(5003, 64, generator=g).to(dev)
    nnz, nseg = 40000, 4099
    values = torch.randint(0, 5003, (nnz,), generator=g,
                           dtype=torch.int32).to(dev)
    segs = torch.sort(torch.randint(0, nseg, (nnz,), generator=g)).values
    segs[(segs % 97) == 5] = 4                    # empty bags
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
