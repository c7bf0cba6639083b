"""The recsys architectures of the port (``repro_torch.configs``,
``models/recsys.py``, ``launch/steps.py``) against the JAX package, on
the CPU at smoke width.

  * Registry: the port's archs are the reference's, all of them (the
    MoE LMs too); the shapes and every config (full and smoke, the LMs'
    and SchNet's too) are equal field by field.
  * Full width: each full config's param shapes and bytes equal
    ``jax.eval_shape`` of the reference's init, reckoned on the meta
    device (nothing allocated).
  * Draws: every (arch, shape) cell's batch and statics equal the
    reference's smoke cell bitwise (the cf edges after the port's stable
    sort by user).
  * Parity on the reference's params (``params_from_numpy``): every
    serve/retrieval cell's output within rtol 1e-5 / atol 1e-5 of
    ``jax.jit(ref_cell.fn)``; every train cell's loss within rtol 1e-5
    and its gradients within rtol 1e-4 / atol 1e-6 of the jitted
    ``jax.value_and_grad`` of the reference's loss, and its params after
    one AdamW step within rtol 1e-4 / atol 4e-6 (4e-3 x lr, ROADMAP
    Queue 3 #3's rule) of the reference's AdamW update, from the
    reference's params and optimizer state, on the port's gradients.
    (Those gradients, not the reference's: where a dead ReLU unit's
    gradient is rounding, XLA's is 4.6e-11 for one of SASRec's FFN bias
    elements where the port's is 0, both inside the gradient tolerance,
    and Adam's first step scales any nonzero gradient to about lr, so
    that element's update is 4.6e-6 against 0.) Archs whose smoke cells
    are identical (``X`` and ``X-baco``; ``serve_p99`` and
    ``serve_bulk``) share one reference computation.
  * The kernel stand-ins: the dot-interaction and attention
    ``autograd.Function``s equal torch.autograd through their plain
    versions (forward and gradients, within 1e-5).

The DLRM, Wide&Deep and LightGCN cells run here; SASRec's and
BERT4Rec's, the sessions and the CLIs in tests/test_torch_archs.py,
through ``check_draws``, ``check_serve`` and ``check_train``.
"""
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import registry as ref_registry  # noqa: E402
from repro.embedding import EmbeddingSpec as RefSpec  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import lightgcn as ref_lg  # noqa: E402
from repro.models import recsys as ref_rs  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.embedding import EmbeddingSpec  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import lightgcn as lg  # noqa: E402
from repro_torch.models import recsys as rs  # noqa: E402
from repro_torch.training.optimizer import adamw  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the recsys and cf cells (the dense LM cells: tests/test_torch_lm.py;
# SchNet's: tests/test_torch_gnn.py)
CELLS = [(a, s.name) for a in registry.list_archs()
         if registry.get_arch(a).family in ("recsys", "cf")
         for s in registry.get_arch(a).shapes]
TRAIN = [c for c in CELLS
         if registry.get_arch(c[0]).shape(c[1]).kind == "train"]
SERVE = [c for c in CELLS if c not in TRAIN]


def is_seq(cell) -> bool:
    """SASRec and BERT4Rec cells (their parity runs in
    tests/test_torch_archs.py, to spread the reference's cost)."""
    return cell[0].startswith(("sasrec", "bert4rec"))


def _path(keys) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in keys)


def _ref_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path(p): np.asarray(x) for p, x in flat}


def _ref_key(arch, shape):
    """Archs and shapes with one smoke cell share a key: the smoke config
    and the shape's kind (smoke overrides the batch sizes)."""
    spec = ref_registry.get_arch(arch)
    return repr(spec.smoke_config()), spec.shape(shape).kind


@functools.lru_cache(maxsize=None)
def _ref_cell_by_key(key):
    return ref_steps.build_cell(*_REF_CELL_OF[key], smoke=True)


_REF_CELL_OF = {}
for _a, _s in CELLS:
    _REF_CELL_OF.setdefault(_ref_key(_a, _s), (_a, _s))


def _ref_cell(arch, shape):
    return _ref_cell_by_key(_ref_key(arch, shape))


@functools.lru_cache(maxsize=None)
def _ref_serve(key):
    ref = _ref_cell_by_key(key)
    return np.asarray(jax.jit(ref.fn)(*ref.args))


@functools.lru_cache(maxsize=None)
def _ref_train(key):
    """(the reference loss, its flat gradients), by one jitted
    ``jax.value_and_grad``."""
    ref = _ref_cell_by_key(key)
    _, ref_loss_fn = _losses(_REF_CELL_OF[key][0])
    loss, grads = jax.jit(jax.value_and_grad(ref_loss_fn))(
        ref.args[0], ref.args[2], ref.args[3])
    return float(loss), _ref_flat(grads)


@functools.lru_cache(maxsize=None)
def _ref_adamw_update():
    from repro.training.optimizer import adamw as ref_adamw
    return jax.jit(lambda g, o, p: ref_adamw(lr=1e-3).update(g, o, p)[0])


def _ref_step(key, grads: dict) -> dict:
    """The reference's AdamW update of its params and optimizer state on
    ``grads`` (flat, by path), flat."""
    ref = _ref_cell_by_key(key)
    flat, treedef = jax.tree_util.tree_flatten_with_path(ref.args[0])
    tree = jax.tree_util.tree_unflatten(
        treedef, [grads[_path(p)] for p, _ in flat])
    return _ref_flat(_ref_adamw_update()(tree, ref.args[1], ref.args[0]))


def _port_cell(arch, shape):
    """The port's smoke cell on the CPU with the reference's params."""
    cell = steps.build_cell(arch, shape, smoke=True, device="cpu")
    ref = _ref_cell(arch, shape)
    params = rs.params_from_numpy(jax.tree.map(np.asarray, ref.args[0]),
                                  "cpu")
    if cell.kind == "train":
        opt_state = adamw(lr=1e-3).init(rs.flat_params(params))
        args = (params, opt_state) + tuple(cell.args[2:])
    else:
        args = (params,) + tuple(cell.args[1:])
    return dataclasses.replace(cell, args=args)


# ---------------------------------------------------------------------------
# registry and configs
# ---------------------------------------------------------------------------
def test_registry_equals_the_reference_less_lm_and_gnn():
    """The reference's whole registry: every arch is ported (the MoE LMs
    last), so nothing is left unported."""
    import importlib
    for m in ref_registry._MODULES:   # all of them, whatever loaded first
        importlib.import_module(f"repro.configs.{m}")
    assert registry.UNPORTED_ARCHS == {} and registry.WAITS_FOR == {}
    assert registry.list_archs() == ref_registry.list_archs()
    assert (registry.all_cells(include_variants=True)
            == ref_registry.all_cells(include_variants=True))
    assert (registry.all_cells(include_skipped=False)
            == ref_registry.all_cells(include_skipped=False))


@pytest.mark.parametrize("arch", registry.list_archs())
def test_specs_and_configs_equal_the_reference(arch):
    spec, want = registry.get_arch(arch), ref_registry.get_arch(arch)
    assert spec.family == want.family
    assert ([dataclasses.asdict(s) for s in spec.shapes]
            == [dataclasses.asdict(s) for s in want.shapes])
    for which in ("full_config", "smoke_config"):
        got, exp = getattr(spec, which)(), getattr(want, which)()
        assert type(got).__name__ == type(exp).__name__
        assert dataclasses.asdict(got) == dataclasses.asdict(exp)
        if hasattr(got, "compressed_fields"):
            assert got.compressed_fields() == exp.compressed_fields()
            assert ([got.table_rows(f) for f in range(got.n_sparse)]
                    == [exp.table_rows(f) for f in range(exp.n_sparse)])
        elif hasattr(got, "seq_len"):
            assert got.table_rows == exp.table_rows


@pytest.mark.parametrize("arch", ["dbrx-132b", "kimi-k2-1t-a32b"])
def test_unported_archs_raise_naming_the_roadmap(arch):
    """The two archs that waited for ROADMAP Queue 1 #7c are ported: their
    specs and configs equal the reference's; an unknown arch raises
    KeyError, and ``not_ported`` names the item it is given (the sharded
    path waits for nothing: ``SHARDED_ITEM`` is gone)."""
    spec, want = registry.get_arch(arch), ref_registry.get_arch(arch)
    assert spec.family == want.family == "lm"
    assert (dataclasses.asdict(spec.full_config())
            == dataclasses.asdict(want.full_config()))
    assert spec.full_config().moe is not None
    with pytest.raises(KeyError):
        registry.get_arch("no-such-arch")
    err = registry.not_ported("a feature", "ROADMAP Queue 1 #3")
    assert isinstance(err, NotImplementedError)
    assert "ROADMAP Queue 1 #3" in str(err)
    assert not hasattr(registry, "SHARDED_ITEM")


def test_embedding_spec_table_rows():
    for kw in ({"n_rows": 1000, "dim": 8}, {"n_rows": 1000, "dim": 8,
                                            "k_rows": 250, "n_hot": 2}):
        assert EmbeddingSpec(**kw).table_rows == RefSpec(**kw).table_rows


@pytest.mark.parametrize("arch", [a for a in registry.list_archs()
                                  if registry.get_arch(a).family
                                  == "recsys"])
def test_full_width_param_shapes_equal_eval_shape(arch):
    """The published configs' params (dlrm-mlperf: 187.8M rows x 128,
    96.1 GB; -baco 24.1 GB) reckoned without allocating."""
    cfg = registry.get_arch(arch).full_config()
    rcfg = ref_registry.get_arch(arch).full_config()
    init = {"DLRMConfig": ref_rs.dlrm_init, "WideDeepConfig":
            ref_rs.widedeep_init}.get(type(rcfg).__name__, ref_rs.seqrec_init)
    shapes = jax.eval_shape(functools.partial(init, cfg=rcfg),
                            jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    want = {_path(p): tuple(x.shape) for p, x in flat}
    assert steps.param_shapes(cfg) == want
    meta = rs.flat_params(steps._recsys_init(cfg)(None, cfg, device="meta"))
    nbytes = sum(t.numel() * t.element_size() for t in meta.values())
    assert nbytes == sum(x.size * x.dtype.itemsize for _, x in flat)
    if arch == "dlrm-mlperf-baco":
        assert nbytes > 24.0e9


# ---------------------------------------------------------------------------
# draws
# ---------------------------------------------------------------------------
def check_draws(arch, shape):
    """The cell's batch and statics equal the reference's bitwise."""
    cell = steps.build_cell(arch, shape, smoke=True, device="cpu")
    ref = _ref_cell(arch, shape)
    assert cell.kind == ref.kind and cell.donate == ref.donate
    batch, statics = cell.args[-1], cell.args[-2]
    want_batch = {k: np.asarray(v) for k, v in ref.args[-1].items()}
    assert set(batch) == set(want_batch)
    for k, v in want_batch.items():
        assert batch[k].numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(batch[k].numpy(), v, err_msg=k)
    want = {k: np.asarray(v) for k, v in ref.args[-2].items()}
    if registry.get_arch(arch).family == "cf":
        order = np.argsort(want["edge_u"], kind="stable")
        for k in ("edge_u", "edge_v", "edge_norm"):
            np.testing.assert_array_equal(statics[k].numpy(),
                                          want[k][order], err_msg=k)
        want = {k: want[k] for k in ("sketch_u", "sketch_v")}
    else:
        assert set(statics) == set(want)
    for k, v in want.items():
        assert statics[k].numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(statics[k].numpy(), v, err_msg=k)


# ---------------------------------------------------------------------------
# parity on the reference's params
# ---------------------------------------------------------------------------
def check_serve(arch, shape):
    """The serve/retrieval cell on the reference's params equals
    ``jax.jit(ref_cell.fn)``."""
    cell = _port_cell(arch, shape)
    got = cell.fn(*cell.args)
    want = _ref_serve(_ref_key(arch, shape))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _losses(arch):
    """(port loss fn, reference loss fn) of an arch's train cell, each
    (params, statics, batch) -> scalar."""
    spec, rspec = registry.get_arch(arch), ref_registry.get_arch(arch)
    cfg, rcfg = spec.smoke_config(), rspec.smoke_config()
    if spec.family == "cf":
        return (lambda p, s, b: lg.bpr_loss_fn(p, s, b, cfg),
                lambda p, s, b: ref_lg.bpr_loss_fn(p, s, b, rcfg))
    name = {"DLRMConfig": "dlrm", "WideDeepConfig": "widedeep",
            "SASRecConfig": "sasrec",
            "BERT4RecConfig": "bert4rec"}[type(cfg).__name__]
    fn, rfn = (getattr(m, f"{name}_train_loss") for m in (rs, ref_rs))
    return (lambda p, s, b: fn(p, s, b, cfg),
            lambda p, s, b: rfn(p, s, b, rcfg))


def check_train(arch, shape):
    """Gradients, loss and one AdamW step of the train cell on the
    reference's params."""
    cell = _port_cell(arch, shape)
    params, _, statics, batch = cell.args
    loss_fn, _ = _losses(arch)
    key = _ref_key(arch, shape)
    want_loss, want_g = _ref_train(key)
    # gradients
    flat = rs.flat_params(params)
    leaves = [p.requires_grad_(True) for p in flat.values()]
    grads = torch.autograd.grad(loss_fn(params, statics, batch), leaves)
    for p in leaves:
        p.requires_grad_(False)
    assert set(flat) == set(want_g)
    for (k, _), g in zip(flat.items(), grads):
        np.testing.assert_allclose(g.numpy(), want_g[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    want_p = _ref_step(key, {k: g.numpy() for k, g in zip(flat, grads)})
    # one AdamW step: the loss, then the params
    _, _, loss = cell.fn(*cell.args)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    for k, p in rs.flat_params(params).items():
        np.testing.assert_allclose(p.numpy(), want_p[k], rtol=1e-4,
                                   atol=4e-6, err_msg=k)


@pytest.mark.parametrize("arch,shape", [c for c in CELLS if not is_seq(c)])
def test_smoke_draws_equal_the_reference_bitwise(arch, shape):
    check_draws(arch, shape)


@pytest.mark.parametrize("arch,shape", [c for c in SERVE if not is_seq(c)])
def test_serve_cells_equal_the_reference(arch, shape):
    check_serve(arch, shape)


@pytest.mark.parametrize("arch,shape", [c for c in TRAIN if not is_seq(c)])
def test_train_cells_equal_the_reference(arch, shape):
    check_train(arch, shape)


# ---------------------------------------------------------------------------
# the kernels' autograd stand-ins
# ---------------------------------------------------------------------------
def _grads(fn, *xs):
    xs = [x.clone().requires_grad_(True) for x in xs]
    out = fn(*xs)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(1),
                    dtype=out.dtype)
    return out.detach(), torch.autograd.grad(out, xs, g)


@pytest.mark.parametrize("b,f,d", [(5, 27, 16), (3, 6, 8), (1, 2, 4)])
def test_interaction_function_equals_autograd_of_plain(b, f, d):
    z = torch.randn(b, f, d, generator=torch.Generator().manual_seed(b),
                    dtype=torch.float64).float()
    got, (gz,) = _grads(rs.interaction, z)
    want, (wz,) = _grads(kref.dot_interaction, z)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gz, wz, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,l,e", [(3, 1, 12, 16), (2, 2, 16, 8),
                                     (1, 2, 7, 5)])
def test_attention_function_equals_autograd_of_plain(causal, b, h, l, e):
    g = torch.Generator().manual_seed(l + e)
    q, k, v = (torch.randn(b, h, l, e, generator=g) for _ in range(3))
    got, gg = _grads(lambda *x: rs.attention(*x, causal), q, k, v)
    want, wg = _grads(lambda *x: kref.flash_attention(*x, causal=causal),
                      q, k, v)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for a, w in zip(gg, wg):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
