"""The port's training half against the JAX package's, on the CPU.

Same numpy inputs through ``repro`` and ``repro_torch``: a planted graph
of 300 users and 240 items, d = 16, 3 layers, BACO-compressed and full.

Tolerances, and why:
  * ``bpr_loss_fn``: loss rtol 1e-5 / atol 1e-6; gradients of both
    tables rtol 1e-4 / atol 1e-6 x max|grad|. The port folds each
    propagation segment in edge order; the reference takes a tree prefix
    scan and a boundary difference, and sums gradients in its own order.
  * The weighted CSR gather-sum against a float64 segment sum: rtol 1e-5
    / atol 1e-5 (f32 folds of at most 60 O(1) products). Against the
    unweighted sum of pre-multiplied rows: bitwise (the contract).
  * ``_Propagate``'s backward: ``gradcheck`` in float64 (atol 1e-6), so
    the backward is the forward's exact adjoint.
  * Optimizers against the reference's ``sgd`` / ``adamw`` /
    ``adafactor`` (with and without clip), 3 updates: rtol 1e-5 / atol
    1e-7 (f32 math in both; pow and rsqrt may round an ulp apart). The
    sliced AdamW update and the per-leaf clip against the port's update
    before them: bitwise.
  * A 200-step ``Trainer(host, sampler="numpy")`` against the
    reference's, from one state carried through a reference checkpoint:
    every loss rtol 1e-4; Recall@20 and NDCG@20 within 0.005.
  * Samplers: numpy batches identical to the reference's; kill and
    resume, and ``fused`` against ``host`` with the device sampler:
    bitwise; the "gather" backend's backward bitwise across runs with
    four intra-op threads.
The module runs with one intra-op thread (``one_thread``).
"""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Sketch as JaxSketch
from repro.data import planted_coclusters as jax_planted
from repro.data.sampler import BPRSampler as JaxBPRSampler
from repro.models import lightgcn as JL
from repro.serve import CompressedArtifact as JaxArtifact
from repro.training import TrainConfig as JaxTrainConfig
from repro.training import Trainer as JaxTrainer
from repro.training import checkpoint as jax_ckpt
from repro.training import optimizer as jax_opt

from repro_torch.core import ClusterEngine
from repro_torch.data import (BPRSampler, DeviceBPRSampler, make_sampler,
                              planted_coclusters)
from repro_torch.kernels import csr_gather_sum, ref
from repro_torch.launch import train as train_cli
from repro_torch.models import lightgcn as L
from repro_torch.serve import CompressedArtifact
from repro_torch.training import (TrainConfig, Trainer,
                                  available_trainer_backends, checkpoint,
                                  optimizer)

D = 16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tests run thousands of tiny ops, and
    several test processes share the machine; idle OpenMP threads
    spinning between ops would slow every process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    gj, _, _ = jax_planted(300, 240, 10, 8, seed=2)
    gt, _, _ = planted_coclusters(300, 240, 10, 8, seed=2)
    sk = ClusterEngine(device="cpu").build(gt, d=D, ratio=0.3)
    sk_j = JaxSketch(sk.user_idx, sk.item_idx, sk.k_users, sk.k_items,
                     method=sk.method, meta=sk.meta)
    test = (np.arange(0, 300, 3), (np.arange(0, 300, 3) * 7) % 240)
    return gj, gt, sk, sk_j, test


def _params(cfg, seed=7):
    return L.init_params(seed, cfg)


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("compressed", [False, True], ids=["full", "sketch"])
def test_bpr_loss_and_grads_match_jax(setup, compressed):
    gj, gt, sk, sk_j, _ = setup
    cfg = L.from_sketch(gt, sk if compressed else None, dim=D, n_layers=3)
    cfg_j = JL.from_sketch(gj, sk_j if compressed else None, dim=D,
                           n_layers=3)
    params = _params(cfg)
    u, p, n = BPRSampler(gt, 128, seed=3).next_batch()
    js = JL.make_statics(gj, sk_j if compressed else None)
    jb = {"user": jnp.asarray(u), "pos": jnp.asarray(p), "neg": jnp.asarray(n)}
    want, want_g = jax.jit(jax.value_and_grad(
        lambda q: JL.bpr_loss_fn(q, js, jb, cfg_j)))(
        {k: jnp.asarray(v) for k, v in params.items()})
    tp = {k: torch.as_tensor(v).requires_grad_(True)
          for k, v in params.items()}
    ts = L.make_statics(gt, sk if compressed else None, device="cpu")
    tb = {"user": torch.as_tensor(u), "pos": torch.as_tensor(p),
          "neg": torch.as_tensor(n)}
    loss = L.bpr_loss_fn(tp, ts, tb, cfg)
    np.testing.assert_allclose(float(loss.detach()), float(want),
                               rtol=1e-5, atol=1e-6)
    names = sorted(tp)
    grads = torch.autograd.grad(loss, [tp[k] for k in names])
    for name, g in zip(names, grads):
        w = np.asarray(want_g[name])
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-6 * np.abs(w).max())


def test_propagate_backward_is_the_adjoint():
    gt, _, _ = planted_coclusters(30, 24, 3, 4, seed=1)
    statics = L.make_statics(gt, None, device="cpu")
    g = torch.Generator().manual_seed(0)
    cu = torch.randn(gt.n_users, 3, generator=g, dtype=torch.float64,
                     requires_grad=True)
    cv = torch.randn(gt.n_items, 3, generator=g, dtype=torch.float64,
                     requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, b: L._Propagate.apply(a, b, statics), (cu, cv), atol=1e-6)


def _csr(rng, rows=50, n_src=40, d=5):
    lens = rng.integers(0, 8, rows)
    lens[[3, 17]] = 0
    lens[10] = 60                       # a row longer than 32 values
    ptr = np.zeros(rows + 1, np.int64)
    ptr[1:] = np.cumsum(lens)
    nnz = int(ptr[-1])
    idx = rng.integers(0, n_src, nnz).astype(np.int32)
    w = rng.standard_normal(nnz).astype(np.float32)
    w[::7] = 0.0
    w[::11] = -0.0
    src = rng.standard_normal((n_src, d)).astype(np.float32)
    return src, idx, w, ptr


def test_weighted_csr_gather_sum_matches_float64():
    src, idx, w, ptr = _csr(np.random.default_rng(0))
    want = np.zeros((ptr.size - 1, src.shape[1]))
    for s in range(ptr.size - 1):
        for j in range(ptr[s], ptr[s + 1]):
            want[s] += np.float64(w[j]) * src[idx[j]].astype(np.float64)
    t = [torch.as_tensor(a) for a in (src, idx, ptr, w)]
    got = csr_gather_sum(t[0], t[1], t[2], t[3])
    assert torch.equal(got, ref.csr_gather_sum(t[0], t[1], t[2], t[3]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the contract: each product rounded on its own, then folded
    pre = t[0][t[1].long()] * t[3][:, None]
    assert torch.equal(got, csr_gather_sum(
        pre, torch.arange(len(idx), dtype=torch.int32), t[2]))
    # -0.0 weights add into +0.0; empty rows are +0.0
    neg0 = torch.full_like(t[3], -0.0)
    out = csr_gather_sum(t[0], t[1], t[2], neg0)
    assert not out.signbit().any() and not out.any()


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------
def test_numpy_sampler_draws_the_reference_batches(setup):
    gj, gt, *_ = setup
    a, b = BPRSampler(gt, 97, seed=5), JaxBPRSampler(gj, 97, seed=5)
    for _ in range(4):
        for x, y in zip(a.next_batch(), b.next_batch()):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == np.int32
    assert a.state_dict() == b.state_dict() == {"seed": 5, "step": 4}


def test_device_sampler_is_a_function_of_seed_and_step(setup):
    _, gt, *_ = setup
    s = DeviceBPRSampler(gt, 64, seed=3, device="cpu")
    seq = [s.next_batch() for _ in range(3)]
    for step, batch in enumerate(seq):
        again = s.sample_fn(3, step)
        assert all(torch.equal(x, y) for x, y in zip(batch, again))
    assert not torch.equal(seq[0][0], seq[1][0])
    u, p, n = seq[0]
    assert u.dtype == p.dtype == n.dtype == torch.int32
    assert bool((n != p).all()) and int(n.min()) >= 0
    assert int(n.max()) < gt.n_items
    other = DeviceBPRSampler(gt, 64, seed=3, device="cpu")
    other.load_state_dict(s.state_dict())
    assert all(torch.equal(x, y) for x, y in zip(other.next_batch(),
                                                 s.sample_fn(3, 3)))
    with pytest.raises(KeyError):
        make_sampler("nope", gt, 8)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,kw", [
    ("sgd", {"lr": 0.1}), ("adamw", {"lr": 1e-2}),
    ("adamw", {"lr": 1e-2, "weight_decay": 0.1, "grad_clip": 0.5}),
    ("adafactor", {}), ("adafactor", {"grad_clip": 0.5})],
    ids=["sgd", "adamw", "adamw-clip", "adafactor", "adafactor-clip"])
def test_optimizer_updates_match_reference(name, kw):
    rng = np.random.default_rng(1)
    params = {"a": rng.standard_normal((6, 4)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    jo = getattr(jax_opt, name)(**kw)
    to = getattr(optimizer, name)(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jo.init(jp)
    tp = {k: torch.as_tensor(v.copy()) for k, v in params.items()}
    ts = to.init(tp)
    for g in grads:
        jp, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp, ts = to.update({k: torch.as_tensor(v) for k, v in g.items()},
                           ts, tp)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-7)
    flat_t = checkpoint._flatten_with_paths(ts)
    flat_j, _ = jax_ckpt._flatten_with_paths(js)
    assert set(flat_t) == set(flat_j)
    for k in flat_j:
        assert flat_t[k].dtype == flat_j[k].dtype, k
        np.testing.assert_allclose(flat_t[k], flat_j[k], rtol=1e-5, atol=1e-7)


def _bits(t):
    """A float tensor's bits (so -0.0 and NaN payloads compare too)."""
    return t.contiguous().view({2: torch.int16, 4: torch.int32}[
        t.element_size()])


@pytest.mark.parametrize("slice_elems", [None, 64])
@pytest.mark.parametrize("name,kw", [
    ("adamw", {"lr": 1e-2}),
    ("adamw", {"lr": 1e-2, "weight_decay": 0.1, "grad_clip": 1.0}),
    ("adafactor", {}), ("adafactor", {"grad_clip": 1.0})],
    ids=["adamw", "adamw-clip", "adafactor", "adafactor-clip"])
def test_update_is_bitwise_the_update_before_slicing(name, kw, slice_elems,
                                                     monkeypatch):
    """AdamW's update over flat slices (``optimizer._SLICE`` elements;
    also at 64, so every leaf here spans several) and the clip applied
    one leaf at a time, against the update as it was (every gradient
    clipped into a new dict, each leaf updated whole:
    ``tests/torch_optimizer_before.py``): params and state equal to the
    bit after 3 updates, on f32 and bf16 leaves of 0 to 4 dims, one of
    them strided, with the clip binding."""
    import torch_optimizer_before as before

    if slice_elems is not None:
        monkeypatch.setattr(optimizer, "_SLICE", slice_elems)
    g = torch.Generator().manual_seed(0)
    params, grads = before.random_leaves(g)
    old_params = {k: v.clone() for k, v in params.items()}
    opt = getattr(optimizer, name)(**kw)
    state, old_state = opt.init(params), opt.init(old_params)
    old_update = {"adamw": before.adamw_update,
                  "adafactor": before.adafactor_update}[name]
    if kw.get("grad_clip"):
        assert float(optimizer.global_norm(grads)) > 10 * kw["grad_clip"]
    for _ in range(3):
        opt.update(grads, state, params)
        old_update(grads, old_state, old_params, **kw)
    for k in params:
        assert torch.equal(_bits(params[k]), _bits(old_params[k])), k
    flat = checkpoint._flatten_with_paths(state)
    old_flat = checkpoint._flatten_with_paths(old_state)
    assert set(flat) == set(old_flat)
    for k in flat:
        np.testing.assert_array_equal(flat[k], old_flat[k], err_msg=k)


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------
def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"item_table": rng.standard_normal((7, 4), np.float32),
                       "user_table": rng.standard_normal((5, 4), np.float32)},
            "opt": {"step": np.int32(3),
                    "m": {"item_table": rng.standard_normal((7, 4),
                                                            np.float32),
                          "user_table": np.zeros((5, 4), np.float32)},
                    "v": {"item_table": np.ones((7, 4), np.float32),
                          "user_table": np.ones((5, 4), np.float32)}}}


def test_checkpoints_cross_between_packages(tmp_path):
    state = _state()
    like = jax.tree.map(lambda a: torch.zeros(np.shape(a),
                                              dtype=torch.from_numpy(
                                                  np.asarray(a)).dtype),
                        state)
    jm = jax_ckpt.CheckpointManager(str(tmp_path / "j"), every=1)
    jm.maybe_save(4, jax.tree.map(jnp.asarray, state),
                  extra={"sampler": {"seed": 1, "step": 4}})
    step, tree, extra = checkpoint.CheckpointManager(
        str(tmp_path / "j")).restore_latest(like)
    assert step == 4 and extra == {"sampler": {"seed": 1, "step": 4}}
    jax.tree.map(lambda t, a: np.testing.assert_array_equal(t.numpy(), a),
                 tree, state)
    assert tree["opt"]["step"].dtype == torch.int32
    # and back: a port checkpoint restores in the reference
    pm = checkpoint.CheckpointManager(str(tmp_path / "p"), every=2, keep=1)
    pm.maybe_save(2, tree, extra=extra)
    pm.maybe_save(3, tree, extra=extra, prev_step=2)     # not due
    pm.maybe_save(4, tree, extra=extra)
    assert checkpoint.latest_step(str(tmp_path / "p")) == 4
    assert sorted(os.listdir(tmp_path / "p")) == ["step_0000000004"]
    back, extra_j = jax_ckpt.restore_checkpoint(str(tmp_path / "p"), 4,
                                                state)
    assert extra_j == extra
    jax.tree.map(np.testing.assert_array_equal, back, state)
    with pytest.raises(ValueError):
        bad = dict(like, params={"item_table": torch.zeros(3, 4),
                                 "user_table": like["params"]["user_table"]})
        checkpoint.restore_checkpoint(str(tmp_path / "p"), 4, bad)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------
def _cfg(**kw):
    base = dict(dim=D, n_layers=3, lr=5e-3, batch_size=128, steps=200,
                seed=0, ckpt_every=1000)
    base.update(kw)
    return base


@pytest.mark.parametrize("compressed", [True, False], ids=["sketch", "full"])
def test_trainer_matches_reference_200_steps(setup, tmp_path, compressed):
    gj, gt, sk, sk_j, test = setup
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jt = JaxTrainer(gj, sk_j if compressed else None, JaxTrainConfig(
        **_cfg(backend="host", sampler="numpy", ckpt_dir=jdir)))
    jt._maybe_checkpoint(force=True)                 # the shared state
    shutil.copytree(jdir, pdir)
    pt = Trainer(gt, sk if compressed else None, TrainConfig(
        **_cfg(backend="host", sampler="numpy", ckpt_dir=pdir)),
        device="cpu")
    assert pt.maybe_resume() and pt.step == 0
    for k in pt.params:
        np.testing.assert_array_equal(pt.params[k].detach().numpy(),
                                      np.asarray(jt.params[k]))
    want = jt.run(log_every=0)
    got = pt.run(log_every=0)
    assert len(got) == len(want) == 200
    np.testing.assert_allclose(got, want, rtol=1e-4)
    mj = jt.evaluate(test, max_users=64)
    mp = pt.evaluate(test, max_users=64)
    assert mp["n_users"] == mj["n_users"] > 0
    assert abs(mp["recall"] - mj["recall"]) <= 0.005
    assert abs(mp["ndcg"] - mj["ndcg"]) <= 0.005
    assert pt.n_params() == jt.n_params()


def _tables(tr):
    return {k: v.detach().clone() for k, v in tr.params.items()}


@pytest.mark.parametrize("backend", ["host", "fused"])
def test_kill_and_resume_is_bitwise(setup, tmp_path, backend):
    _, gt, sk, _, _ = setup
    cfg = TrainConfig(**_cfg(backend=backend, steps=64, chunk_size=16,
                             batch_size=64))
    whole = Trainer(gt, sk, cfg, device="cpu")
    losses = whole.run(log_every=0)
    ck = dataclasses.replace(cfg, ckpt_dir=str(tmp_path), ckpt_every=32)
    killed = Trainer(gt, sk, ck, device="cpu")
    first = killed.run(steps=32, log_every=0)
    resumed = Trainer(gt, sk, ck, device="cpu")
    assert resumed.maybe_resume() and resumed.step == 32
    assert resumed.sampler.step == 32
    rest = resumed.run(log_every=0)
    assert first + rest == losses
    for k, v in _tables(whole).items():
        assert torch.equal(resumed.params[k], v), k


def test_fused_equals_host_with_the_device_sampler(setup):
    _, gt, sk, _, _ = setup
    out = {}
    for backend in ("host", "fused"):
        tr = Trainer(gt, sk, TrainConfig(**_cfg(
            backend=backend, sampler="device", steps=32, chunk_size=8)),
            device="cpu")
        out[backend] = (tr.run(log_every=0), _tables(tr))
    assert out["host"][0] == out["fused"][0]
    for k, v in out["host"][1].items():
        assert torch.equal(out["fused"][1][k], v), k


def test_gather_backend_backward_is_deterministic_across_threads():
    """The "gather" lookups' backward adds repeated rows in a fixed order
    with several intra-op threads too (bitwise resume on the CPU rests on
    it)."""
    from repro_torch.embedding import EmbeddingEngine, EmbeddingSpec
    g = torch.Generator().manual_seed(2)
    z = torch.randn(137, 16, generator=g, requires_grad=True)
    sketch = torch.randint(0, 137, (5000, 2), generator=g)
    cot = torch.randn(5000, 16, generator=g)
    eng = EmbeddingEngine(EmbeddingSpec(5000, 16, k_rows=137, n_hot=2),
                          backend="gather")
    torch.set_num_threads(4)
    try:
        grads = [torch.autograd.grad(
            (eng.codebook_lookup(z, sketch) * cot).sum(), z)[0]
            for _ in range(5)]
    finally:
        torch.set_num_threads(1)
    assert all(torch.equal(grads[0], x) for x in grads[1:])


def test_backend_registry(setup):
    _, gt, sk, _, _ = setup
    assert available_trainer_backends() == ("fused", "fused_sharded",
                                            "host", "host_seed")
    with pytest.raises(KeyError):
        Trainer(gt, sk, TrainConfig(**_cfg(backend="nope")), device="cpu")
    for name in ("fused", "fused_sharded"):
        with pytest.raises(ValueError):
            Trainer(gt, sk, TrainConfig(**_cfg(backend=name,
                                               sampler="numpy")),
                    device="cpu")


def test_export_loads_in_both_packages(setup, tmp_path):
    gj, gt, sk, sk_j, _ = setup
    tr = Trainer(gt, sk, TrainConfig(**_cfg(steps=3)), device="cpu")
    tr.run(log_every=0)
    art = tr.export(str(tmp_path / "art"))
    jt = JaxTrainer(gj, sk_j, JaxTrainConfig(**_cfg(steps=3)))
    want_keys = set(JaxArtifact.from_trainer(jt).provenance)
    assert set(art.provenance) == want_keys
    assert art.provenance["train_steps"] == 3
    assert art.provenance["exported_by"] == "Trainer.export"
    for loaded in (JaxArtifact.load(str(tmp_path / "art")),
                   CompressedArtifact.load(str(tmp_path / "art"))):
        assert loaded.content_id() == art.content_id()
        for k, v in tr.params.items():
            np.testing.assert_array_equal(np.asarray(loaded.params[k]),
                                          v.detach().numpy())


def test_train_cli_on_the_cpu(tmp_path, capsys):
    rc = train_cli.main(["--device", "cpu", "--dataset", "synth_xs",
                         "--steps", "20", "--batch-size", "64", "--dim", "8",
                         "--trainer-backend", "fused", "--chunk-size", "8",
                         "--ckpt-dir", str(tmp_path / "ck"),
                         "--ckpt-every", "10",
                         "--export", str(tmp_path / "art")])
    out = capsys.readouterr().out
    assert rc == 0 and "recall@20=" in out and "backend=fused" in out
    assert checkpoint.latest_step(str(tmp_path / "ck")) == 20
    assert CompressedArtifact.load(str(tmp_path / "art")).provenance[
        "train_steps"] == 20
    rc = train_cli.main(["--device", "cpu", "--dataset", "synth_xs",
                         "--steps", "30", "--batch-size", "64", "--dim", "8",
                         "--ckpt-dir", str(tmp_path / "ck"), "--resume"])
    assert rc == 0 and "resumed at step 20" in capsys.readouterr().out
    # the recsys archs train (tests/test_torch_archs.py holds them), and
    # so do the MoE LMs (their shape defaults to train_4k)
    assert train_cli.main(["--device", "cpu", "--arch", "sasrec",
                           "--steps", "2"]) == 0
    assert train_cli.main(["--device", "cpu", "--arch", "dbrx-132b",
                           "--steps", "1"]) == 0
    # every ETC method is ported (tests/test_torch_baselines.py trains
    # one); a name outside the registry stops at argument parsing
    with pytest.raises(SystemExit):
        train_cli.main(["--device", "cpu", "--method", "nope"])
