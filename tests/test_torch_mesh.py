"""The LM cells over a (data, model) mesh (``launch/mesh.py``, the
logical-axis half of ``distributed/sharding.py``, ``distributed/
parallel.py``, ``build_cell(mesh=...)``, ``launch/pipeline.py``) against
the JAX package, on the CPU.

* In this process: ``logical_to_spec`` and ``fit_spec`` equal the
  reference's on ``AbstractMesh`` (16, 16), (2, 16, 16), (2, 2) and
  (1, 4), for every logical axis under "tp" and "dp" and every leaf of
  the five LM full configs; the production mesh on a world of 1 raises
  naming the 256 (512) ranks it needs; the production cells' routes
  (whole query heads, replicated K/V where they do not divide 16); what
  still raises on a mesh (kimi-k2's Adafactor over a model axis, the
  "dp" mapping) names ROADMAP Queue 1 #7c-ii-c; on a
  world of 1, every smoke cell under ``make_host_mesh`` is bitwise its
  one-card twin, and the GPipe step with one stage equals the
  microbatched one-card step (f32: loss rtol 1e-6, params within 2e-7 but
  for 0.1% of them, all within ``PP_ATOL``: the same per-microbatch
  forward, the gradients summed in another order;
  bf16: loss rtol 1e-5, at most 1% of the params different, each by at
  most 2 lr + 2^-7 |p|).
* The oracle (``tests/torch_mesh_oracle.py``, one subprocess a mesh:
  ``jax.sharding.Mesh`` with Auto axes on 4 host devices) and 4 gloo
  ranks (``tests/torch_mesh_worker.py``), started together once for the
  module on the same inputs:
    - the token embedding on the mesh bitwise the one-card lookup;
    - gemma2-9b, qwen1.5-32b, dbrx-132b: prefill and decode logits and
      caches, the train loss and gradients equal the oracle's within
      the tolerances of ``tests/test_torch_lm.py``'s one-card parity
      (logits rtol 1e-4 / atol 1e-5, loss rtol 1e-4, gradients rtol
      1e-4 / atol 1e-6), dbrx at the mesh's own value (its per-shard
      capacity: the (2, 2) loss is not the plain one);
    - all five archs against the port's one-card cells run on each data
      rank's rows (the mesh's value by its definition: the mean over the
      data shards, each with its own MoE capacity) within f32 rtol 1e-5
      / atol 1e-5 (logits, caches; the loss rtol 1e-5) and rtol 1e-4 /
      atol 1e-6 (gradients): the all-reduces sum partial products in
      another order, and a GEMM over a vocabulary slice sums in another
      blocking; the params
      after one step within rtol 1e-4 / atol 1e-6 of the reference's
      AdamW on the gathered gradients;
    - GPipe on (1, 4) and (2, 2): the loss within rtol 1e-5 of the
      oracle's, the params after the step within atol 2e-7 but for at
      most 0.1% of a leaf's elements (the key bias excepted: its exact
      gradient is 0), all within ``PP_ATOL``;
    - bf16 qwen prefill on (2, 2) within rtol 2e-2 / atol 4e-2 of the
      oracle's (the bound of ``test_torch_lm``'s bf16 prefill: a bf16
      rounding of each partial sum);
    - a MoE whose experts do not divide the model axis (the reference's
      fallback to ``_mlp_moe`` on the global tokens) equals its one-card
      loss (rtol 1e-5) and gradients (rtol 1e-4 / atol 1e-6);
    - the compressed gradient mean (``training.compress``) over the batch
      axes of a (2, 2) and a (1, 2, 2) mesh: over those axes' 2 ranks.
"""
import dataclasses
import importlib
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as ref_registry  # noqa: E402
from repro.distributed import sharding as ref_sharding  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed import world  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import (AbstractMesh, make_host_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.launch.pipeline import build_pp_train_cell  # noqa: E402
from repro_torch.models import recsys as rs  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

import torch_mesh_oracle as oracle  # noqa: E402
import torch_mesh_worker as worker  # noqa: E402

for _m in ref_registry._MODULES:
    importlib.import_module(f"repro.configs.{_m}")

REPO = Path(__file__).resolve().parents[1]
N_RANKS = 4
ARCHS = worker.ARCHS
MESHES = ("2x2", "1x4")
SPEC_MESHES = ((16, 16), (2, 16, 16), (2, 2), (1, 4))
LOGICAL = (None, "batch", "model", "seq", "data", "vocab")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _names(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def _ref_spec(shape, axes, mapping, fit_shape=None):
    mesh = jax.sharding.AbstractMesh(shape, _names(shape))
    with ref_sharding.logical_mapping(mapping):
        spec = ref_sharding.logical_to_spec(mesh, axes)
    if fit_shape is not None:
        spec = ref_steps._fit_spec(mesh, spec, fit_shape)
    return tuple(spec) + (None,) * (len(axes) - len(tuple(spec)))


def _port_spec(shape, axes, mapping, fit_shape=None):
    mesh = AbstractMesh(shape, _names(shape))
    with sharding.logical_mapping(mapping):
        spec = sharding.logical_to_spec(mesh, axes)
    return spec if fit_shape is None else sharding.fit_spec(mesh, spec,
                                                            fit_shape)


# ---------------------------------------------------------------------------
# specs, meshes, routes (no ranks)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mapping", ["tp", "dp"])
@pytest.mark.parametrize("shape", SPEC_MESHES)
def test_logical_to_spec_equals_the_reference(shape, mapping):
    for a in LOGICAL:
        assert _port_spec(shape, (a,), mapping) == _ref_spec(
            shape, (a,), mapping), a
    with pytest.raises(ValueError):
        _port_spec(shape, ("nope",), mapping)
    # fit_spec on every combined partition the mapping makes
    for axes, dims in ((("vocab", None), (1000, 8)),
                       (("vocab", None), (1024, 8)),
                       (("batch", "model"), (6, 16)),
                       (("batch", None, "model"), (512, 2, 40)),
                       (("model", "batch"), (32, 48))):
        assert _port_spec(shape, axes, mapping, dims) == _ref_spec(
            shape, axes, mapping, dims), (axes, dims)


@pytest.mark.parametrize("shape", SPEC_MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, shape):
    """Every leaf of the full config: the logical axes, and the fitted
    spec, equal the reference's."""
    cfg = registry.get_arch(arch).full_config()
    rcfg = ref_registry.get_arch(arch).full_config()
    want = RT.param_logical_axes(rcfg)
    got = T.param_logical_axes(cfg)
    assert got == want
    shapes = {k: tuple(v.shape) for k, v in rs.flat_params(
        T.init_params(None, cfg, device="meta")).items()}
    axes = {f"{k}/{kk}" if isinstance(v, dict) else k: vv
            for k, v in got.items()
            for kk, vv in (v.items() if isinstance(v, dict) else [(k, v)])}
    assert set(axes) == set(shapes)
    for k, ax in axes.items():
        assert _port_spec(shape, ax, "tp", shapes[k]) == _ref_spec(
            shape, ax, "tp", shapes[k]), k


def test_production_mesh_needs_its_world():
    with world("cpu"):
        with pytest.raises(ValueError, match="world of 256 ranks"):
            make_production_mesh(device="cpu")
        with pytest.raises(ValueError, match="world of 512 ranks"):
            make_production_mesh(multi_pod=True, device="cpu")
        mesh = make_host_mesh(device="cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="this world has 0"):
        make_host_mesh(device="cpu")


# query heads, K/V heads, and whether wk/wv are column blocks, of model
# rank 0 on the production mesh's 16-way model axis
PRODUCTION_ROUTES = {"gemma2-9b": (1, 1, False), "gemma3-12b": (1, 1, False),
                     "dbrx-132b": (3, 1, False),
                     "kimi-k2-1t-a32b": (4, 1, False)}


@pytest.mark.parametrize("arch", ARCHS)
def test_production_routes(arch):
    """On the (16, 16) mesh: whole query heads a rank, each rank's K/V
    heads from replicated wk/wv where 8 K/V heads do not divide 16;
    qwen1.5-32b's 40 heads do not divide 16 and its cells raise."""
    cfg = registry.get_arch(arch).full_config()
    mesh = AbstractMesh((16, 16), ("data", "model"))
    if arch not in PRODUCTION_ROUTES:
        with pytest.raises(ValueError, match="40 query heads"):
            T.param_layouts(cfg, mesh)
        return
    lay = T.param_layouts(cfg, mesh)
    h = T.local_heads(cfg, 16, 0)
    assert (h.hq, h.kv, h.kv_sharded) == PRODUCTION_ROUTES[arch]
    assert lay["blocks"]["wk"].spec == (None,) * 4
    assert lay["blocks"]["wq"].spec == (None, None, None, "model")
    assert lay["embed"].spec == ("model", None)
    for j in range(16):
        hj = T.local_heads(cfg, 16, j)
        assert hj.kv_of_q is None
        assert hj.q_lo // (cfg.n_heads // cfg.n_kv_heads) == hj.kv_lo


def test_other_families_on_a_mesh_raise_naming_the_roadmap():
    """What raised ``not_ported`` before the data-axis layouts now builds:
    kimi-k2's train_4k with Adafactor over a model axis (its full
    config's layouts on (16, 16): experts over "model", FSDP over
    "data", the factored moments by ``opt_state_axes``) and an LM shape
    under the "dp" mapping; the recsys, GNN and cf cells' notes claim no
    data-axis layout (the reference gives those families none), and no
    ``SHARDED_ITEM`` is left."""
    kimi = registry.get_arch("kimi-k2-1t-a32b").full_config()
    mesh16 = AbstractMesh((16, 16), ("data", "model"))
    lay = steps._lm_layouts(kimi, mesh16, "train", 256, 4096, "tp")
    assert lay["info"] == {"fsdp": True, "zero": True, "tag": "data",
                           "optimizer": "adafactor"}
    assert lay["params"]["blocks"]["w_gate"].spec == (
        None, None, "model", "data", None)
    fac = lay["opt"]["fac"]
    assert len(fac) == len(rs.flat_params(lay["params"]))
    dp = registry.ShapeSpec("train_dp", "train", dict(
        seq_len=16, global_batch=4, mapping="dp"))
    with world("cpu"):
        mesh = make_host_mesh(device="cpu")
        cell = steps._lm_cell(registry.get_arch("gemma2-9b"), dp, True, None,
                              torch.device("cpu"), mesh=mesh)
        assert "mapping=dp" in cell.notes
        cell = steps.build_cell("kimi-k2-1t-a32b", "train_4k", mesh=mesh,
                                smoke=True, device="cpu")
        assert cell.notes.startswith("optimizer=adamw,")
        for arch, shape in (("sasrec", "serve_p99"), ("schnet", "molecule"),
                            ("lightgcn-baco", "bpr_train")):
            cell = steps.build_cell(arch, shape, mesh=mesh, smoke=True,
                                    device="cpu")
            assert cell.mesh is mesh and "ZeRO" not in cell.notes
            assert "FSDP" not in cell.notes
    assert not hasattr(registry, "SHARDED_ITEM")


# ---------------------------------------------------------------------------
# a world of 1: bitwise the one-card cells
# ---------------------------------------------------------------------------
def _clone(a):
    if isinstance(a, dict):
        return {k: _clone(v) for k, v in a.items()}
    return a.clone() if torch.is_tensor(a) else a


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "train_4k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_world_of_one_is_bitwise_the_one_card_cell(arch, shape):
    one = steps.build_cell(arch, shape, smoke=True, device="cpu")
    want = one.fn(*tuple(map(_clone, one.args)))
    with world("cpu"):
        mesh = make_host_mesh(device="cpu")
        cell = steps.build_cell(arch, shape, mesh=mesh, smoke=True,
                                device="cpu")
        got = cell.fn(*cell.args)
        if shape == "train_4k":
            assert torch.equal(got[2], want[2])
            flat = rs.flat_params(want[0])
            for k, v in rs.flat_params(got[0]).items():
                assert torch.equal(v, flat[k]), k
        else:
            assert torch.equal(got[0], want[0])
            for k, v in want[1].items():
                assert torch.equal(got[1][k], v), k
            assert cell.gather("cache", got[1])["k_global"].shape == \
                want[1]["k_global"].shape


# GPipe on one stage against the microbatched one-card step: in bf16 the
# pipeline sums each param's gradient over the microbatches in bf16 (the
# reference's scan transpose does too) and the one-card step in f32, so
# Adam's first step (about +-lr an element) flips where the two sums'
# signs differ: at most 1% of the elements, each by at most 2 lr plus
# two bf16 roundings of |p| (``chip_smoke.py``'s bound at full width)
LR = 3e-4
# GPipe's params after one AdamW step against another summation order's:
# Adam's first step moves a param by lr * g / (|g| + 1e-8), so where a
# gradient lies within ~1e-7 of 0 (qwen's key bias: a shift of every key
# of a query leaves its softmax alone, so its exact gradient is 0) the
# step follows g's rounding; elsewhere the two agree within 2e-7
PP_ATOL = 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_world_of_one_gpipe_equals_the_microbatched_step(dtype):
    cfg = dataclasses.replace(registry.get_arch("qwen1.5-32b").smoke_config(),
                              n_layers=4, dtype=dtype)
    with world("cpu"):
        cell = build_pp_train_cell(cfg, global_batch=8, seq=32,
                                   mesh=make_host_mesh(device="cpu"),
                                   n_micro=8, device="cpu")
        p0 = _clone(cell.args[0])
        _, _, loss = cell.fn(*cell.args)
    _, opt = steps._lm_optimizer(cfg)
    step = steps._LMTrainStep(cfg, opt, 8, torch.float32)
    _, _, want = step(p0, opt.init(rs.flat_params(p0)), cell.args[2])
    np.testing.assert_allclose(float(loss), float(want),
                               rtol=1e-6 if dtype == "float32" else 1e-5)
    flat = rs.flat_params(p0)
    n_diff = n_far = n_all = 0
    for k, v in rs.flat_params(cell.args[0]).items():
        w = flat[k].float()
        d = (v.float() - w).abs()
        if dtype == "float32":
            assert float(d.max()) <= PP_ATOL, k
        assert bool((d <= 2 * LR + w.abs() * 2.0 ** -7).all()), k
        n_diff += int((d > 0).sum())
        n_far += int((d > 2e-7).sum())
        n_all += d.numel()
    assert n_diff <= 0.01 * n_all
    assert dtype != "float32" or n_far <= 1e-3 * n_all


def test_gpipe_raises_outside_its_scope():
    kimi = registry.get_arch("kimi-k2-1t-a32b").smoke_config()
    dense = dataclasses.replace(kimi, moe=None, n_layers=3)
    with world("cpu"):
        mesh = make_host_mesh(device="cpu")
        with pytest.raises(ValueError, match="dense LMs"):
            build_pp_train_cell(kimi, global_batch=4, seq=8, mesh=mesh,
                                n_micro=2, device="cpu")
        with pytest.raises(ValueError, match="microbatches"):
            build_pp_train_cell(dense, global_batch=6, seq=8, mesh=mesh,
                                n_micro=4, device="cpu")


def _route_cells(route: str, mesh):
    """(one-card twin, mesh cell) of a data-axis route: gemma2-9b train
    under "dp", dbrx-132b train with FSDP forced, kimi-k2's smoke config
    at 128 experts (Adafactor)."""
    cpu = torch.device("cpu")
    if route == "dp":
        spec, shape = registry.get_arch("gemma2-9b"), worker.dp_shape("train")
    elif route == "adafactor":
        spec = worker.adafactor_spec()
        shape = spec.shape("train_4k")
    else:
        spec = registry.get_arch("dbrx-132b")
        shape = spec.shape("train_4k")
    one = steps._lm_cell(spec, shape, True, None, cpu)
    cell = steps._lm_cell(spec, shape, True, None, cpu, mesh=mesh)
    return one, cell


@pytest.mark.parametrize("route", ["dp", "fsdp", "adafactor"])
def test_world_of_one_data_axis_routes_are_bitwise(route, monkeypatch):
    """On a world of 1 each data-axis route's train step (the "dp"
    mapping, FSDP forced at smoke width, Adafactor over the model axis)
    is bitwise its one-card twin: loss and every updated param."""
    with world("cpu"):
        mesh = make_host_mesh(device="cpu")
        if route == "fsdp":
            with monkeypatch.context() as m:
                m.setattr(steps, "lm_fsdp", lambda *a, **k: True)
                one, cell = _route_cells(route, mesh)
            assert "fsdp=True" in cell.notes and "FSDP" in cell.notes
            assert cell.fn.groups.params
        else:
            one, cell = _route_cells(route, mesh)
        if route == "adafactor":
            assert cell.notes.startswith("optimizer=adafactor,")
        want = one.fn(_clone(one.args[0]), one.args[1], one.args[2])
        got = cell.fn(*cell.args)
    assert torch.equal(got[2], want[2])
    flat = rs.flat_params(want[0])
    for k, v in rs.flat_params(got[0]).items():
        assert torch.equal(v, flat[k]), k


# ---------------------------------------------------------------------------
# 4 gloo ranks and the oracle
# ---------------------------------------------------------------------------
def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat_into(tree, prefix: str, out: dict) -> None:
    for k, v in rs.flat_params(tree).items():
        out[f"{prefix}/{k}"] = np.asarray(v)


def write_inputs(path) -> None:
    """The reference's smoke-cell inputs of every arch, GPipe's, and the
    bf16 case's, as one ``.npz`` for the ranks."""
    out = {}
    for arch in ARCHS:
        for kind, shape in worker.SHAPES.items():
            args = _np(ref_steps.build_cell(arch, shape, smoke=True,
                                            lookup_backend="gather").args)
            if kind == "prefill":
                _flat_into(args[0], f"{arch}/params", out)
            if kind == "decode":
                _flat_into(args[1], f"{arch}/decode/cache", out)
            _flat_into(args[-1], f"{arch}/{kind}/batch", out)
    params, batch = oracle.pp_inputs(oracle.pp_config())
    _flat_into(_np(params), "pp/params", out)
    _flat_into(batch, "pp/batch", out)
    cfg = dataclasses.replace(
        ref_registry.get_arch("qwen1.5-32b").smoke_config(), dtype="bfloat16")
    _flat_into(jax.tree.map(lambda a: np.asarray(a, np.float32),
                            RT.init_params(jax.random.PRNGKey(0), cfg)),
               "bf16/params", out)
    out["bf16/tokens"] = oracle.bf16_tokens()
    np.savez(path, **out)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 4 ranks' results (rank 0's, gathered whole), the oracle's
    arrays and the inputs, all made once."""
    tmp = tmp_path_factory.mktemp("mesh")
    inputs = tmp / "inputs.npz"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    env.pop("XLA_FLAGS", None)
    # the oracle draws its own inputs (the same values): start it first
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_mesh_oracle.py"),
         str(tmp / f"oracle_{m}.npz"), m], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for m in MESHES]
    errs = []
    try:
        write_inputs(inputs)
        procs += [subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "torch_mesh_worker.py"),
             str(r), str(N_RANKS), str(tmp / "store"), str(tmp),
             str(inputs)], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(N_RANKS)]
        deadline = time.monotonic() + 300     # one limit for all of them
        for p in procs:
            try:
                _, err = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                _, err = p.communicate()
            errs.append((p.returncode, err[-3000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(rc == 0 for rc, _ in errs), errs
    with open(tmp / "rank0.pkl", "rb") as f:
        got = pickle.load(f)
    want = {}
    for m in MESHES:
        z = np.load(tmp / f"oracle_{m}.npz")
        want.update({k: z[k] for k in z.files})
    return got, want, worker.load_inputs(str(inputs))


def _close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


def _one_card(arch, kind, inp, n_data):
    """The port's one-card cell on each of ``n_data`` data ranks' rows of
    the inputs: logits and caches concatenated, losses and gradients
    averaged (the mesh's value by its definition)."""
    shape = worker.SHAPES[kind]
    cell = steps.build_cell(arch, shape, smoke=True, device="cpu",
                            lookup_backend="gather")
    batch = inp[kind]["batch"]
    b = batch["tokens"].shape[0]
    outs = []
    for r in range(n_data):
        sl = slice(r * b // n_data, (r + 1) * b // n_data)
        bt = {k: v[sl] if v.dim() else v for k, v in batch.items()}
        params = worker.clone(inp["params"])
        if kind == "train":
            flat = rs.flat_params(params)
            leaves = [t.requires_grad_(True) for t in flat.values()]
            loss = T.train_loss(params, bt, cell.fn.cfg)
            grads = torch.autograd.grad(loss, leaves)
            outs.append((loss.detach(), dict(zip(flat, grads))))
        elif kind == "decode":
            cache = {k: v[:, :, sl].clone() for k, v in
                     inp["decode"]["cache"].items()}
            outs.append(cell.fn(params, cache, bt))
        else:
            outs.append(cell.fn(params, bt))
    if kind == "train":
        return (sum(o[0] for o in outs) / n_data,
                {k: sum(o[1][k] for o in outs) / n_data for k in outs[0][1]})
    return (torch.cat([o[0] for o in outs]),
            {k: torch.cat([o[1][k] for o in outs], dim=2)
             for k in outs[0][1]})


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_cells_equal_the_one_card_cells(ranks, arch, mesh):
    got, _, inputs = ranks
    g = got[mesh][arch]
    n_data = int(mesh.split("x")[0])
    assert g["embed_bitwise"]
    for kind in ("prefill", "decode"):
        logits, cache = _one_card(arch, kind, inputs[arch], n_data)
        _close(g[kind]["logits"], logits, 1e-5, 1e-5, f"{kind} logits")
        for k, v in cache.items():
            _close(g[kind]["cache"][k], v, 1e-5, 1e-5, f"{kind} {k}")
    loss, grads = _one_card(arch, "train", inputs[arch], n_data)
    _close(g["train"]["loss"], loss, 1e-5, 0, "loss")
    _close(g["train"]["step_loss"], loss, 1e-5, 0, "step loss")
    for k, v in grads.items():
        _close(g["train"]["grads"][k], v, 1e-4, 1e-6, k)
    assert "data=" in g["train"]["notes"] and "ZeRO-1" in g["train"]["notes"]
    assert "sequence-sharded" in g["decode"]["notes"]


def _ref_adamw(params: dict, grads: dict) -> dict:
    """The reference's AdamW step (lr 3e-4, clip 1.0) of flat params on
    flat gradients, flat."""
    from repro.training import optimizer as ref_opt
    opt = ref_opt.adamw(lr=3e-4, grad_clip=1.0)
    p = {k: jnp.asarray(np.asarray(v, np.float32)) for k, v in params.items()}
    new, _ = opt.update({k: jnp.asarray(v) for k, v in grads.items()},
                        opt.init(p), p)
    return {k: np.asarray(v) for k, v in new.items()}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", oracle.MESH_ARCHS)
def test_mesh_cells_equal_the_reference_mesh(ranks, arch, mesh):
    got, want, inputs = ranks
    g = got[mesh][arch]
    pre = f"{mesh}/{arch}"
    for kind in ("prefill", "decode"):
        _close(g[kind]["logits"], want[f"{pre}/{kind}/logits"], 1e-4, 1e-5,
               f"{kind} logits")
        for k, v in g[kind]["cache"].items():
            _close(v, want[f"{pre}/{kind}/cache/{k}"], 1e-4, 1e-5, k)
    _close(g["train"]["loss"], want[f"{pre}/train/loss"], 1e-4, 0, "loss")
    for k, v in g["train"]["grads"].items():
        _close(v, want[f"{pre}/train/grads/{k}"], 1e-4, 1e-6, k)
    new = _ref_adamw(rs.flat_params(inputs[arch]["params"]),
                     g["train"]["grads"])
    for k, v in g["train"]["params"].items():
        _close(v, new[k], 1e-4, 1e-6, k)


def test_expert_parallel_loss_is_the_meshs_own(ranks):
    """dbrx's per-shard capacity: on (2, 2) each data rank routes 32
    tokens, not 64, so its loss is the mesh's, not the plain one
    ((1, 4) has one data rank: the plain loss)."""
    got, want, _ = ranks
    mesh_loss = float(want["2x2/dbrx-132b/train/loss"])
    plain = float(want["1x4/dbrx-132b/train/loss"])
    assert abs(mesh_loss - plain) > 1e-3
    np.testing.assert_allclose(float(got["2x2"]["dbrx-132b"]["train"]["loss"]),
                               mesh_loss, rtol=1e-5)
    np.testing.assert_allclose(float(got["1x4"]["dbrx-132b"]["train"]["loss"]),
                               plain, rtol=1e-5)


@pytest.mark.parametrize("mesh", MESHES)
def test_gpipe_equals_the_reference(ranks, mesh):
    got, want, _ = ranks
    pp = got[mesh]["pp"]
    np.testing.assert_allclose(float(pp["loss"]), float(want[f"{mesh}/pp/loss"]),
                               rtol=1e-5)
    for k, v in pp["params"].items():
        w = want[f"{mesh}/pp/params/{k}"]
        _close(v, w, 0, PP_ATOL, k)
        if k != "blocks/bk":        # its every step is rounding
            assert np.mean(np.abs(v - w) > 2e-7) <= 1e-3, k


def test_bf16_prefill_on_the_mesh(ranks):
    got, want, _ = ranks
    _close(got["2x2"]["bf16"]["logits"], want["2x2/bf16/prefill/logits"],
           2e-2, 4e-2, "bf16 logits")


def test_moe_fallback_equals_one_card(ranks):
    got, _, _ = ranks
    fb = got["2x2"]["fallback"]
    np.testing.assert_allclose(float(fb["mesh"]["loss"]),
                               float(fb["one"]["loss"]), rtol=1e-5)
    for k, v in fb["one"]["grads"].items():
        _close(fb["mesh"]["grads"][k], v, 1e-4, 1e-6, k)


@pytest.mark.parametrize("mesh", ["2x2", "1x2x2"])
def test_compressed_mean_over_the_batch_axes(ranks, mesh):
    """Over the data axis of a (2, 2) mesh, and over pod x data of a
    (1, 2, 2) one, rank 0 averages with rank 2 alone: int8 by the
    reference's formula (codes summed, times rank 0's scale, over 2),
    bf16 within two bf16 roundings of the f32 mean."""
    got, _, _ = ranks
    out = got["compress"][mesh]
    g0, g2 = worker_grads(0), worker_grads(2)
    for k in g0:
        s0 = np.float32(np.max(np.abs(g0[k]))) / np.float32(127) \
            + np.float32(1e-12)
        s2 = np.float32(np.max(np.abs(g2[k]))) / np.float32(127) \
            + np.float32(1e-12)
        codes = (np.round(g0[k] / s0).astype(np.int32)
                 + np.round(g2[k] / s2).astype(np.int32))
        np.testing.assert_array_equal(
            out["int8"][k], (codes.astype(np.float32) * s0
                             / np.float32(2)).astype(np.float32))
        mean = (g0[k].astype(np.float64) + g2[k]) / 2
        bound = 2 * 2.0 ** -8 * (np.abs(g0[k]) + np.abs(g2[k])) / 2
        assert np.all(np.abs(out["bf16"][k] - mean) <= bound + 1e-30), k


def worker_grads(rank: int) -> dict:
    import torch_sharded_worker
    return torch_sharded_worker.compress_grads(rank)


@pytest.mark.parametrize("mesh", MESHES)
def test_dp_mapping_equals_the_reference_mesh(ranks, mesh):
    """gemma2-9b's cells under "dp" (the batch over every rank, the
    params ZeRO'd over (data, model) to serve, the moments ZeRO-1'd so)
    equal the reference's run under ``logical_mapping("dp")`` within the
    tolerances of the "tp" cells; the params after one step, the
    reference's AdamW on the gathered gradients."""
    got, want, inputs = ranks
    g = got[mesh]["dp"]
    pre = f"{mesh}/dp"
    for kind in ("prefill", "decode"):
        assert "mapping=dp" in g[kind]["notes"]
        _close(g[kind]["logits"], want[f"{pre}/{kind}/logits"], 1e-4, 1e-5,
               f"{kind} logits")
        for k, v in g[kind]["cache"].items():
            _close(v, want[f"{pre}/{kind}/cache/{k}"], 1e-4, 1e-5, k)
    _close(g["train"]["loss"], want[f"{pre}/train/loss"], 1e-4, 0, "loss")
    _close(g["train"]["step_loss"], g["train"]["loss"], 0, 0, "step loss")
    for k, v in g["train"]["grads"].items():
        _close(v, want[f"{pre}/train/grads/{k}"], 1e-4, 1e-6, k)
    new = _ref_adamw(rs.flat_params(inputs["gemma2-9b"]["params"]),
                     g["train"]["grads"])
    for k, v in g["train"]["params"].items():
        _close(v, new[k], 1e-4, 1e-6, k)
    assert "moments ZeRO-1 over every axis" in g["train"]["notes"]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", worker.FSDP_ARCHS)
def test_fsdp_equals_the_replicated_params(ranks, arch, mesh):
    """FSDP forced at smoke width (params stored split over "data",
    all-gathered a block at a time, gradients reduce-scattered): the
    loss, gradients and updated params equal the same cell with its
    params replicated over "data" within rtol 1e-5 / atol 1e-5."""
    got, _, _ = ranks
    f, p = got[mesh]["fsdp"][arch]["fsdp"], got[mesh]["fsdp"][arch]["plain"]
    assert ("FSDP" in f["notes"]) and ("FSDP" not in p["notes"])
    assert p["split"] == [] and "blocks/wq" in f["split"]
    _close(f["loss"], p["loss"], 1e-5, 1e-5, "loss")
    _close(f["step_loss"], p["step_loss"], 1e-5, 1e-5, "step loss")
    for k, v in p["grads"].items():
        _close(f["grads"][k], v, 1e-5, 1e-5, k)
    for k, v in p["params"].items():
        _close(f["params"][k], v, 1e-5, 1e-5, k)


@pytest.mark.parametrize("mesh", MESHES)
def test_adafactor_over_the_model_axis_equals_the_reference(ranks, mesh):
    """kimi-k2's smoke config at 128 experts (the reference's Adafactor
    route; its experts over "model"): the params after one step equal
    the reference's ``adafactor`` applied to the gathered params and
    gradients, within rtol 1e-4 / atol 1e-6."""
    from repro.training import optimizer as ref_opt

    got, _, _ = ranks
    a = got[mesh]["adafactor"]
    assert a["notes"].startswith("optimizer=adafactor,")
    _close(a["step_loss"], a["loss"], 0, 0, "step loss")
    opt = ref_opt.adafactor(lr=1e-2)
    p = {k: jnp.asarray(v) for k, v in a["params0"].items()}
    new, _ = opt.update({k: jnp.asarray(v) for k, v in a["grads"].items()},
                        opt.init(p), p)
    for k, v in a["params"].items():
        _close(v, np.asarray(new[k]), 1e-4, 1e-6, k)
