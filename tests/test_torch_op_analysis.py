"""``launch.op_analysis`` (the port's counterpart of
``benchmarks/hlo_analysis.py``) and ``kernels.cost``, in this process.

* ``a @ b`` counts 2·64·32·16 dot FLOPs, as ``tests/test_hlo_analysis.py``
  holds the reference; a loop of 8 matmuls counts 8 of them (an eager
  loop runs, and counts, every trip); a checkpointed matmul counts its
  recomputation.
* Views, ``empty`` and metadata ops count no bytes.
* Each kernel wrapper counts one call at its ``kernels.cost`` cost, the
  same on CPU tensors (its plain version runs) and on meta tensors (its
  shape branch runs), and nothing of what runs inside it.
* Host reads: a meta tensor's range check is answered as passing, the
  bag sort's read takes the branch that sorts (and says so), and a read
  the mode does not know raises, naming the op and the line.
* Collectives on a fake world: operand bytes by kind, and by link
  (inside one node of 8 consecutive ranks or not).
* The four one-card steps of ``chip_smoke.py``'s op-analysis phase, at
  smoke width: the count of a CPU run through the kernels' plain versions
  equals the reckoning on meta tensors (dot FLOPs by dtype, bytes, kernel
  calls, temporaries), as the smoke holds the card's count against it.
"""
import pytest
import torch
import torch.distributed as dist

from repro_torch.kernels import (codebook_lookup, cost, csr_gather_sum,
                                 dot_interaction, flash_attention,
                                 fused_topk, fused_topk_codebook)
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.launch import dryrun, steps
from repro_torch.launch.op_analysis import OpAnalysis, count


def _count(fn, *args):
    return count(fn, *args)[1]


def test_matmul_counts_two_m_n_k():
    a, b = torch.randn(64, 32), torch.randn(32, 16)
    m = _count(lambda a, b: a @ b, a, b)
    assert m["dot_flops"] == m["dot_flops/f32"] == 2 * 64 * 32 * 16
    assert m["hbm_bytes"] == 4 * (64 * 32 + 32 * 16 + 64 * 16)
    m16 = _count(lambda a, b: a @ b, a.bfloat16(), b.bfloat16())
    assert m16["dot_flops/bf16"] == 2 * 64 * 32 * 16


def test_a_loop_of_matmuls_counts_every_trip():
    def step(x, ws):
        for w in ws:
            x = torch.tanh(x @ w)
        return x.sum()
    x, ws = torch.randn(128, 128), torch.randn(8, 128, 128)
    assert _count(step, x, ws)["dot_flops"] == 8 * 2 * 128 ** 3
    m = _count(step, x.to("meta"), ws.to("meta"))
    assert m["dot_flops"] == 8 * 2 * 128 ** 3


def test_checkpoint_recomputation_counts_as_it_runs():
    from torch.utils.checkpoint import checkpoint

    w = torch.randn(32, 32, requires_grad=True)
    x = torch.randn(16, 32)

    def plain(x, w):
        return torch.autograd.grad(torch.tanh(x @ w).sum(), w)[0]

    def remat(x, w):
        y = checkpoint(lambda x, w: torch.tanh(x @ w), x, w,
                       use_reentrant=False)
        return torch.autograd.grad(y.sum(), w)[0]
    one = 2 * 16 * 32 * 32
    # forward, and the weight's gradient (the input needs none)
    assert _count(plain, x, w)["dot_flops"] == 2 * one
    assert _count(remat, x, w)["dot_flops"] == 3 * one


def test_views_and_allocations_count_no_bytes():
    x = torch.randn(8, 16)

    def views(x):
        return (x.view(16, 8), x.t(), x[2:], x.reshape(4, 32),
                x.expand(2, 8, 16), x.detach(), x.unsqueeze(0),
                torch.empty(1000), torch.empty_like(x))
    m = _count(views, x)
    assert m["hbm_bytes"] == 0 and m["dot_flops"] == 0
    assert _count(lambda x: x + 1, x)["hbm_bytes"] == 2 * 8 * 16 * 4


def _kernel_calls(dev):
    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype).to(dev)

    def i(high, *shape, dtype=torch.int32):
        return torch.randint(0, high, shape, generator=g,
                             dtype=dtype).to(dev)
    z, idx = r(40, 8), i(40, 12, 3)
    ptr = torch.tensor([0, 3, 3, 9, 20], dtype=torch.int64).to(dev)
    u, items, sk = r(5, 8), r(30, 8), i(40, 30, 2)
    return {
        "codebook_lookup": (codebook_lookup, (z, idx), {},
                            cost.codebook_lookup(z, idx)),
        "embedding_bag": (csr_gather_sum, (z, i(40, 20), ptr, r(20)), {},
                          cost.csr_gather_sum(z, i(40, 20), ptr, r(20))),
        "dot_interaction": (dot_interaction, (r(6, 5, 8),), {},
                            cost.dot_interaction(r(6, 5, 8))),
        "flash_attention": (flash_attention, (r(2, 3, 16, 8),) * 3,
                            {"causal": True}, cost.flash_attention(
                                *(r(2, 3, 16, 8),) * 3, causal=True)),
        "fused_topk": (fused_topk, (u, items, 4), {"mask": r(30)},
                       cost.fused_topk(u, items, 4, mask=r(30))),
        "fused_topk_codebook": (fused_topk_codebook, (u, z, sk, 4), {},
                                cost.fused_topk_codebook(u, z, sk, 4)),
    }


@pytest.mark.parametrize("name", ["codebook_lookup", "embedding_bag",
                                  "dot_interaction", "flash_attention",
                                  "fused_topk", "fused_topk_codebook"])
def test_each_kernel_counts_its_cost_on_cpu_and_meta(name):
    got = {}
    for dev in ("cpu", "meta"):
        fn, args, kw, c = _kernel_calls(dev)[name]
        oa = OpAnalysis().arguments(args)
        with oa:
            out = fn(*args, **kw)
        outs = out if isinstance(out, tuple) else (out,)
        want = fn(*args, **kw)
        want = want if isinstance(want, tuple) else (want,)
        assert [o.shape for o in outs] == [w.shape for w in want]
        assert all(o.device.type == dev for o in outs)
        m = oa.metrics()
        assert m["kernels"] == {name: 1}
        assert m["hbm_bytes"] == c.bytes and m["dot_flops"] == 0
        assert (m["kernel_ops/f32"], m["kernel_ops/16"]) == (c.ops, c.ops16)
        got[dev] = (m, oa.memory())
    assert got["cpu"] == got["meta"]
    assert cost.observer is None


def test_cost_bound_and_attention_ops():
    assert cost.attention_ops(1, 1, 4, 4, 2, True) == 4.0 * (1 + 2 + 3 + 4) * 2
    assert cost.attention_ops(1, 1, 6, 4, 2, True) == 4.0 * (10 + 8) * 2
    assert cost.attention_ops(2, 3, 5, 7, 4, False) == 4.0 * 2 * 3 * 35 * 4
    ms, by = cost.bound(cost.Cost(3.35e12, 0.0))
    assert (ms, by) == (1e3, "bytes")
    ms, by = cost.bound(cost.Cost(0.0, 67e12, 989e12))
    assert (ms, by) == (2e3, "operations")
    x = torch.empty(4, 5, 8, dtype=torch.bfloat16, device="meta")
    c = cost.dot_interaction(x)
    assert (c.ops, c.ops16, c.bytes) == (0.0, 2.0 * 4 * 10 * 8,
                                         2 * (4 * 5 * 8 + 4 * 10))


def test_host_reads_on_meta():
    from repro_torch.kernels.ops import CudaBackend

    table = torch.empty(50, 4, device="meta")
    ids = torch.empty(7, dtype=torch.int64, device="meta")
    oa = OpAnalysis()
    with oa:
        out = CudaBackend().full(table, ids)
        bag = embedding_bag(table, ids, ids, 3)
    assert out.shape == (7, 4) and bag.shape == (3, 4)
    m = oa.metrics()
    assert m["host_reads"] == 2
    assert m["kernels"] == {"codebook_lookup": 1, "embedding_bag": 1}
    assert m["branches"] == ["kernels/embedding_bag.py:embedding_bag: "
                             "branch: unsorted bags are sorted"]

    def unknown(t):
        return int(t.sum())
    with pytest.raises(RuntimeError, match="reads a meta tensor"):
        with OpAnalysis():
            unknown(ids)
    # a CPU tensor's read is no host read
    _, m, _ = count(lambda t: bool(t.sum() > 0), torch.ones(3))
    assert m["host_reads"] == 0


def test_collectives_by_kind_and_link_on_a_fake_world():
    from repro_torch.distributed import parallel as par

    with dryrun.fake_world(16, 0):
        node = dist.new_group([0, 1, 2, 3])
        wide = dist.new_group([0, 4, 8, 12])
        apart = dist.new_group([0, 9])
        x = torch.empty(10, 6, device="meta")
        oa = OpAnalysis()
        with oa:
            par.all_reduce(x, node)
            par.all_gather_cat(x, wide, 0)
            par.reduce_scatter_cat(torch.empty(8, 6, device="meta"), apart, 0)
        m = oa.metrics()
        with pytest.raises(RuntimeError, match="already open"):
            with dryrun.fake_world(4):
                pass
    assert not dist.is_initialized()
    assert m["coll_bytes/all-reduce"] == 240
    assert m["coll_bytes/all-gather"] == 240
    assert m["coll_bytes/reduce-scatter"] == 8 * 6 * 4
    assert m["coll_bytes_total"] == 240 + 240 + 192
    assert m["coll_bytes/nvlink"] == 240
    assert m["coll_bytes/network"] == 240 + 192


ONE_CARD = (("lightgcn-baco", "bpr_train"), ("dlrm-mlperf-baco", "serve_p99"),
            ("dbrx-132b", "train_4k"), ("gemma2-9b", "decode_32k"))


@pytest.fixture
def one_thread():
    """One intra-op thread: the plain versions' many tiny ops spin on a
    multi-threaded CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch,shape", ONE_CARD)
def test_one_card_step_counts_equal_the_meta_reckoning(arch, shape,
                                                       one_thread):
    got = {}
    for dev in ("cpu", "meta"):
        cell = steps.build_cell(arch, shape, smoke=True, device=dev,
                                lookup_backend="cuda")
        _, m, mem = count(cell.fn, *cell.args)
        got[dev] = (m, mem)
    (m_cpu, mem_cpu), (m_meta, mem_meta) = got["cpu"], got["meta"]
    m_cpu.pop("host_reads")          # a CPU tensor's read is no host read
    m_meta.pop("host_reads")
    m_meta.pop("branches", None)
    assert m_cpu == m_meta
    assert mem_cpu == mem_meta
    assert m_cpu["kernels"] and m_cpu["hbm_bytes"] > 0
    assert m_cpu["dot_flops"] > 0 or arch == "lightgcn-baco"

