"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip without an NVIDIA GPU (run them there with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``).
Exact on integer-valued inputs (every sum exact, so any order agrees);
the codebook lookup is bitwise on any input (same additions, same order).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import codebook_lookup, fused_topk, ref

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
