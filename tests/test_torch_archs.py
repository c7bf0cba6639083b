"""The port's sequential recommenders (SASRec, BERT4Rec) against the JAX
package at smoke width on the CPU, and the architectures' entry points.

  * SASRec and BERT4Rec cells: draws bitwise, serve/retrieval outputs,
    gradients, loss and one AdamW step, at the tolerances of
    tests/test_torch_recsys.py (whose checks these call).
  * The models reach the kernel wrappers: DLRM's interaction at [B, F+1,
    d], SASRec's causal attention and BERT4Rec's full one at [B, H, L, e]
    (on CUDA tensors the wrappers launch the kernels).
  * DLRM's retrieval, which looks the fixed fields up once, equals
    scoring every candidate as a serve batch.
  * ``ArchSession``: its stats carry the reference's keys, compiles is
    0, and with no device given it raises where there is no CUDA.
  * The CLIs: ``launch.train --arch sasrec-baco --shape train_batch
    --device cpu`` and ``launch.serve --arch dlrm-mlperf-baco --device
    cpu`` in subprocesses; a MoE LM arch raises NotImplementedError naming
    ROADMAP Queue 1 #7c.
"""
import os
import subprocess
import sys

import pytest
import torch

pytest.importorskip("jax")

import test_torch_recsys as base  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import recsys as rs  # noqa: E402

ROOT = base.ROOT


@pytest.mark.parametrize("arch,shape", [c for c in base.CELLS
                                        if base.is_seq(c)])
def test_seqrec_draws_equal_the_reference_bitwise(arch, shape):
    base.check_draws(arch, shape)


@pytest.mark.parametrize("arch,shape", [c for c in base.SERVE
                                        if base.is_seq(c)])
def test_seqrec_serve_cells_equal_the_reference(arch, shape):
    base.check_serve(arch, shape)


@pytest.mark.parametrize("arch,shape", [c for c in base.TRAIN
                                        if base.is_seq(c)])
def test_seqrec_train_cells_equal_the_reference(arch, shape):
    base.check_train(arch, shape)


@pytest.mark.parametrize("arch,kernel", [("dlrm-mlperf-baco", "_dot_kernel"),
                                         ("sasrec-baco", "_flash_kernel"),
                                         ("bert4rec-baco", "_flash_kernel")])
def test_models_reach_the_kernel_wrappers(monkeypatch, arch, kernel):
    """The interaction and the attention go through the kernel wrappers
    (which launch the kernels for CUDA tensors): DLRM's at [B, F+1, d],
    SASRec's causal and BERT4Rec's not, at [B, H, L, e]."""
    seen = []
    wrapped = getattr(rs, kernel)

    def spy(*a, **kw):
        seen.append((tuple(a[0].shape), kw.get("causal")))
        return wrapped(*a, **kw)

    monkeypatch.setattr(rs, kernel, spy)
    cell = steps.build_cell(arch, "serve_p99", smoke=True, device="cpu")
    cell.fn(*cell.args)
    cfg = registry.get_arch(arch).smoke_config()
    if kernel == "_dot_kernel":
        assert seen == [((8, cfg.n_sparse + 1, cfg.embed_dim), None)]
    else:
        e = cfg.embed_dim // cfg.n_heads
        assert seen == [((8, cfg.n_heads, cfg.seq_len, e), cfg.causal)] \
            * cfg.n_blocks


def test_dlrm_retrieval_equals_scoring_each_candidate():
    """The retrieval cell broadcasts the fixed fields' lookups; scoring
    the candidates as a serve batch gives the same values."""
    cell = steps.build_cell("dlrm-mlperf-baco", "retrieval_cand", smoke=True,
                            device="cpu")
    params, statics, b = cell.args
    c = b["candidates"].shape[0]
    sparse = b["sparse"].expand(c, -1).clone()
    sparse[:, 0] = b["candidates"]
    cfg = registry.get_arch("dlrm-mlperf-baco").smoke_config()
    want = rs.dlrm_forward(params, statics, {"dense": b["dense"].expand(
        c, -1), "sparse": sparse}, cfg)
    torch.testing.assert_close(cell.fn(*cell.args), want, rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# sessions and CLIs
# ---------------------------------------------------------------------------
def test_arch_session_stats_and_device():
    from repro.serve import ArchSession as RefArchSession
    from repro_torch.serve import ArchSession
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ArchSession("sasrec-baco")
    s = ArchSession("sasrec-baco", device="cpu")
    s.warmup()
    for _ in range(3):
        out = s()
    st = s.stats()
    ref = RefArchSession("sasrec-baco")
    ref.warmup()
    ref()
    assert set(st) == set(ref.stats())
    assert st["requests"] == 3 and st["compiles"] == 0
    assert not s.donates_cache and tuple(out.shape) == (8, 100)


def _run(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


def test_train_cli_arch_on_the_cpu():
    r = _run("repro_torch.launch.train", "--arch", "sasrec-baco", "--shape",
             "train_batch", "--device", "cpu", "--steps", "3")
    assert r.returncode == 0, r.stderr
    assert "sasrec-baco:train_batch x3 smoke steps on cpu" in r.stdout
    assert "loss=" in r.stdout


def test_serve_cli_arch_on_the_cpu():
    r = _run("repro_torch.launch.serve", "--arch", "dlrm-mlperf-baco",
             "--device", "cpu", "--n-requests", "3")
    assert r.returncode == 0, r.stderr
    assert "dlrm-mlperf-baco:serve_p99 smoke on cpu" in r.stdout
    assert "3 requests" in r.stdout


@pytest.mark.parametrize("arch", ["dbrx-132b", "kimi-k2-1t-a32b"])
def test_train_cli_lm_arch_raises_naming_the_roadmap(arch, capsys):
    """The MoE LMs train (no longer raise): an LM's shape defaults to
    train_4k, as in the reference's CLI; the sharded trainer backend
    trains one step on a world of 1 on the CPU, which it tears down."""
    import torch.distributed as dist

    from repro_torch.launch import train
    assert train.main(["--arch", arch, "--device", "cpu", "--steps",
                       "1"]) == 0
    out = capsys.readouterr().out
    assert f"{arch}:train_4k x1 smoke steps on cpu" in out and "loss=" in out
    n = torch.get_num_threads()
    torch.set_num_threads(1)     # tiny ops: extra threads only add barriers
    try:
        assert train.main(["--device", "cpu", "--dataset", "synth_xs",
                           "--steps", "1", "--batch-size", "256",
                           "--trainer-backend", "fused_sharded"]) == 0
    finally:
        torch.set_num_threads(n)
    out = capsys.readouterr().out
    assert "backend=fused_sharded" in out and "rank=0/1" in out
    assert "recall@20=" in out and not dist.is_initialized()
