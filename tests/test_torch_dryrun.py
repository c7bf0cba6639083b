"""The data-axis layouts of the LM cells and the dry run
(``launch/dryrun.py``) against the JAX package, in this process, with no
world and no device.

* Every leaf's spec of every LM full config's cells (params, optimizer
  state: AdamW ``m``/``v``, Adafactor ``vr``/``vc``/``v``; the batch) on
  ``AbstractMesh`` (16, 16), (2, 16, 16), (2, 2) and (1, 4) under "tp",
  and under "dp" for gemma2-9b and dbrx-132b, equals the spec of the
  reference's ``build_cell(..., mesh=jax.sharding.AbstractMesh(...))``
  args; the port's own layouts differ only where the model axis does not
  divide the K/V heads (wk/wv/bk/bv whole over "model": ROADMAP Queue 3
  #14) and where the batch does not divide all the data axes (whole on
  every rank where the reference's ``_fit_spec`` splits it over some of
  them: Queue 3 #13; only under "dp" here), and qwen1.5-32b's 40 query
  heads on a model axis of 16 raise (the reference's layouts are its
  account there).
* The FSDP rule and the accumulator dtype (``steps.lm_fsdp``) equal the
  reference's for every LM full config with no mesh and on (2, 2),
  (1, 4), (16, 16), (2, 16, 16), under "tp" and "dp": the reference's
  train cell's params carry "data" exactly when it is FSDP, and its
  ``acc_dtype`` is bf16 exactly then.
* The dry run: every non-skipped cell's ``reference_layout_bytes`` on
  both production meshes equals the reference's ``_arg_bytes_per_device``
  byte for byte; the port's own ``arg_bytes_per_device`` equals it but
  for the decode cache (head-sharded: Queue 3 #12) and the K/V
  projections (Queue 3 #14), each pinned (``PINNED``); kimi-k2's
  train_4k reads 8.199 GB on the reference's layouts.
* The CLI's summary line and exit code.
"""
import importlib
import inspect
import os

import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as ref_registry  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.models import recsys as rs  # noqa: E402

for _m in ref_registry._MODULES:
    importlib.import_module(f"repro.configs.{_m}")

# the reference's dry run sets XLA_FLAGS (512 host devices) at import;
# only its byte count is used here, so the flag is put back at once
_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as ref_dryrun  # noqa: E402
if _FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS

LMS = ("gemma2-9b", "gemma3-12b", "qwen1.5-32b", "dbrx-132b",
       "kimi-k2-1t-a32b")
SPEC_MESHES = ((16, 16), (2, 16, 16), (2, 2), (1, 4))
FSDP_MESHES = (None, (2, 2), (1, 4), (16, 16), (2, 16, 16))
DP_ARCHS = ("gemma2-9b", "dbrx-132b")
KV = ("wk", "wv", "bk", "bv")

# (mesh, arch, shape): the port's own argument bytes a rank, the bytes
# its K/V projections add (whole over a model axis of 16, with their
# optimizer state: Queue 3 #14), its decode cache's bytes and the
# reference's (Queue 3 #12); qwen1.5-32b does not build on a model axis
# of 16, so its account is the reference's
PINNED = {
    ("16x16", "dbrx-132b", "train_4k"): (5438521092, 294912000, 0, 0),
    ("16x16", "dbrx-132b", "prefill_32k"): (1087861504, 58982400, 0, 0),
    ("16x16", "dbrx-132b", "decode_32k"): (6456308516, 58982400, 5368709120,
                                           2684354560),
    ("16x16", "gemma2-9b", "train_4k"): (2891029252, 1445068800, 0, 0),
    ("16x16", "gemma2-9b", "prefill_32k"): (144787392, 72253440, 0, 0),
    ("16x16", "gemma2-9b", "decode_32k"): (6486312932, 72253440, 6341787648,
                                           3170893824),
    ("16x16", "gemma2-9b", "long_500k"): (11506894792, 72253440, 11362369536,
                                          355074048),
    ("16x16", "gemma3-12b", "train_4k"): (3610195332, 1769472000, 0, 0),
    ("16x16", "gemma3-12b", "prefill_32k"): (180745696, 88473600, 0, 0),
    ("16x16", "gemma3-12b", "decode_32k"): (2663511556, 88473600, 2483027968,
                                            1241513984),
    ("16x16", "gemma3-12b", "long_500k"): (4517393896, 88473600, 4336910336,
                                           135528448),
    ("16x16", "kimi-k2-1t-a32b", "train_4k"): (8291695212, 92232000, 0, 0),
    ("16x16", "kimi-k2-1t-a32b", "prefill_32k"): (8245980800, 91822080, 0, 0),
    ("16x16", "kimi-k2-1t-a32b", "decode_32k"): (15409589924, 91822080,
                                                 7163871232, 3581935616),
    ("16x16", "qwen1.5-32b", "train_4k"): (5501618692, 0, 0, 0),
    ("16x16", "qwen1.5-32b", "prefill_32k"): (275316864, 0, 0, 0),
    ("16x16", "qwen1.5-32b", "decode_32k"): (11012472996, 0, 10737418240,
                                             10737418240),
    ("2x16x16", "dbrx-132b", "train_4k"): (5438258948, 294912000, 0, 0),
    ("2x16x16", "dbrx-132b", "prefill_32k"): (1087730432, 58982400, 0, 0),
    ("2x16x16", "dbrx-132b", "decode_32k"): (3771953940, 58982400,
                                             2684354560, 1342177280),
    ("2x16x16", "gemma2-9b", "train_4k"): (2890767108, 1445068800, 0, 0),
    ("2x16x16", "gemma2-9b", "prefill_32k"): (144656320, 72253440, 0, 0),
    ("2x16x16", "gemma2-9b", "decode_32k"): (3315419092, 72253440,
                                             3170893824, 1585446912),
    ("2x16x16", "gemma2-9b", "long_500k"): (11506894792, 72253440,
                                            11362369536, 177537024),
    ("2x16x16", "gemma3-12b", "train_4k"): (3609933188, 1769472000, 0, 0),
    ("2x16x16", "gemma3-12b", "prefill_32k"): (180614624, 88473600, 0, 0),
    ("2x16x16", "gemma3-12b", "decode_32k"): (1421997556, 88473600,
                                              1241513984, 620756992),
    ("2x16x16", "gemma3-12b", "long_500k"): (4517393896, 88473600,
                                             4336910336, 67764224),
    ("2x16x16", "kimi-k2-1t-a32b", "train_4k"): (8291433068, 92232000, 0, 0),
    ("2x16x16", "kimi-k2-1t-a32b", "prefill_32k"): (8245849728, 91822080, 0,
                                                    0),
    ("2x16x16", "kimi-k2-1t-a32b", "decode_32k"): (11827654292, 91822080,
                                                   3581935616, 1790967808),
    ("2x16x16", "qwen1.5-32b", "train_4k"): (5501356548, 0, 0, 0),
    ("2x16x16", "qwen1.5-32b", "prefill_32k"): (275185792, 0, 0, 0),
    ("2x16x16", "qwen1.5-32b", "decode_32k"): (5643763860, 0, 5368709120,
                                               5368709120),
}


def _names(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def _path(keys) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in keys)


def _norm(spec, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(tuple(spec)))


def _dp_shape(kind: str, dims: dict):
    return registry.ShapeSpec(f"{kind}_dp", kind, dict(dims, mapping="dp"))


def _ref_cell(arch: str, shape: str, mesh_shape, mapping: str = "tp"):
    mesh = jax.sharding.AbstractMesh(mesh_shape, _names(mesh_shape))
    spec = ref_registry.get_arch(arch)
    s = spec.shape(shape)
    if mapping == "dp":
        s = ref_registry.ShapeSpec(f"{s.kind}_dp", s.kind,
                                   dict(s.dims, mapping="dp"))
    return ref_steps._lm_cell(spec, s, mesh, smoke=False)


def _ref_specs(cell) -> dict:
    """{"params/...", "opt/...", "batch/...": spec} of a reference cell's
    args (the decode cache left out)."""
    names = {"train": ("params", "opt", "batch"),
             "prefill": ("params", "batch"),
             "decode": ("params", None, "batch")}[cell.kind]
    out = {}
    for name, tree in zip(names, cell.args):
        if name is None:
            continue
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        for p, leaf in flat:
            out[f"{name}/{_path(p)}"] = _norm(leaf.sharding.spec,
                                               len(leaf.shape))
    return out


def _port_specs(arch: str, shape: str, mesh_shape, mapping: str = "tp",
                reference: bool = False) -> dict:
    spec = registry.get_arch(arch)
    s = spec.shape(shape)
    if mapping == "dp":
        s = _dp_shape(s.kind, s.dims)
    mesh = AbstractMesh(mesh_shape, _names(mesh_shape))
    cfg = spec.full_config()
    with sharding.logical_mapping(mapping):
        lay = steps._lm_layouts(cfg, mesh, s.kind, s.dims["global_batch"],
                                s.dims["seq_len"], mapping, reference)
    out = {}
    for name, key in (("params", "params"), ("opt", "opt"),
                      ("batch", "batch")):
        if key in lay:
            for k, v in rs.flat_params(lay[key]).items():
                out[f"{name}/{k}"] = v.spec
    return out, lay.get("cache")


def _lm_shapes(arch):
    return [s.name for s in registry.get_arch(arch).shapes if s.skip is None]


def _check_specs(arch, mesh_shape, mapping):
    n_model = 1 if mapping == "dp" else mesh_shape[-1]
    cfg = registry.get_arch(arch).full_config()
    for shape in _lm_shapes(arch):
        ref = _ref_cell(arch, shape, mesh_shape, mapping)
        want = _ref_specs(ref)
        if cfg.n_heads % n_model:
            with pytest.raises(ValueError, match="query heads"):
                _port_specs(arch, shape, mesh_shape, mapping)
            got, _ = _port_specs(arch, shape, mesh_shape, mapping, True)
            assert got == {k: want[k] for k in got} and set(got) == set(want)
            continue
        got, _ = _port_specs(arch, shape, mesh_shape, mapping)
        assert set(got) == set(want), (shape, set(got) ^ set(want))
        kv_split = cfg.n_kv_heads % n_model == 0
        with sharding.logical_mapping(mapping):
            whole = not steps.par.data_axes(
                AbstractMesh(mesh_shape, _names(mesh_shape)),
                registry.get_arch(arch).shape(shape).dims["global_batch"])
        keys = sorted(rs.flat_params(ref.args[0]))
        for k, w in want.items():
            if k.startswith("opt/fac/"):     # vr/vc/v: by the param's name
                leaf = keys[int(k.split("/")[2])].split("/")[-1]
            else:
                leaf = k.split("/")[-1]
            if leaf in KV and not kv_split:
                w = tuple(None if p == "model" else p for p in w)
            if k.startswith("batch/") and got[k][:1] == (None,) and whole:
                w = (None,) + w[1:]         # all the data axes or none
            assert got[k] == w, (shape, k, got[k], w)
        ref_got, _ = _port_specs(arch, shape, mesh_shape, mapping, True)
        assert {k: v for k, v in ref_got.items() if k.startswith(
            ("params/", "opt/"))} == {k: v for k, v in want.items()
                                      if k.startswith(("params/", "opt/"))}


@pytest.mark.parametrize("mesh_shape", SPEC_MESHES)
@pytest.mark.parametrize("arch", LMS)
def test_lm_leaf_specs_equal_the_reference(arch, mesh_shape):
    """Params (ZeRO'd for serving and FSDP), optimizer state and batch:
    every leaf's spec the reference's (module docstring)."""
    _check_specs(arch, mesh_shape, "tp")


@pytest.mark.parametrize("mesh_shape", SPEC_MESHES)
@pytest.mark.parametrize("arch", DP_ARCHS)
def test_lm_leaf_specs_under_dp_equal_the_reference(arch, mesh_shape):
    """Under "dp" ZeRO tags "vocab" (data x model), the batch spans every
    axis and nothing splits over "model" for tensor parallelism."""
    _check_specs(arch, mesh_shape, "dp")


def _ref_fsdp(arch: str, mesh_shape, mapping: str) -> tuple:
    """The reference's FSDP decision and accumulator dtype, from its
    train cell on an AbstractMesh (no mesh: a mesh of "data" alone, whose
    model shards are 1 as with none)."""
    shape = (16,) if mesh_shape is None else mesh_shape
    names = ("data",) if mesh_shape is None else _names(mesh_shape)
    mesh = jax.sharding.AbstractMesh(shape, names)
    spec = ref_registry.get_arch(arch)
    s = spec.shape("train_4k")
    if mapping == "dp":
        s = ref_registry.ShapeSpec("train_dp", "train",
                                   dict(s.dims, mapping="dp"))
    cell = ref_steps._lm_cell(spec, s, mesh, smoke=False)
    fsdp = any("data" in (p if isinstance(p, tuple) else (p,))
               for leaf in jax.tree.leaves(cell.args[0])
               for p in leaf.sharding.spec)
    fn = getattr(cell.fn, "__wrapped__", cell.fn)
    acc = inspect.getclosurevars(fn).nonlocals["acc_dtype"]
    return fsdp, jnp.dtype(acc).name


@pytest.mark.parametrize("mapping", ["tp", "dp"])
@pytest.mark.parametrize("arch", LMS)
def test_fsdp_and_accumulator_follow_the_reference(arch, mapping):
    cfg = registry.get_arch(arch).full_config()
    for mesh_shape in FSDP_MESHES:
        want_fsdp, want_acc = _ref_fsdp(arch, mesh_shape, mapping)
        mesh = (None if mesh_shape is None
                else AbstractMesh(mesh_shape, _names(mesh_shape)))
        got = steps.lm_fsdp(cfg, mesh, mapping)
        assert got == want_fsdp, mesh_shape
        assert str(steps.lm_acc_dtype(got)) == f"torch.{want_acc}"
    if arch == "gemma2-9b" and mapping == "tp":
        mesh = AbstractMesh((16, 16), ("data", "model"))
        assert not steps.lm_fsdp(cfg, mesh)        # f32 on the production
        assert steps.lm_fsdp(cfg)                  # mesh, bf16 with none


@pytest.fixture(scope="module")
def dry():
    cells = ref_registry.all_cells(include_skipped=True,
                                   include_variants=True)
    return cells, dryrun.run(cells, [False, True], verbose=False)


def test_dry_run_bytes_equal_the_reference(dry):
    cells, results = dry
    assert len(results) == 2 * len(cells)
    n_ok, n_skip, n_fail = dryrun.summary(results)
    assert n_fail == 0 and n_skip == 2 * sum(
        ref_registry.get_arch(a).shape(s).skip is not None for a, s in cells)
    for rec in results:
        if rec["ok"] == "skipped":
            assert rec["skip"]
            continue
        mesh_shape = (2, 16, 16) if rec["mesh"] == "2x16x16" else (16, 16)
        mesh = jax.sharding.AbstractMesh(mesh_shape, _names(mesh_shape))
        ref = ref_steps.build_cell(rec["arch"], rec["shape"], mesh=mesh)
        want = ref_dryrun._arg_bytes_per_device(ref.args)
        key = (rec["mesh"], rec["arch"], rec["shape"])
        assert rec["reference_layout_bytes"] == want, key
        assert rec["arg_bytes_per_device"] == sum(rec["bytes"].values())
        if key not in PINNED:
            assert rec["arg_bytes_per_device"] == want, key
            assert rec["builds"] and rec["fits"]
            continue
        total, kv, cache, ref_cache = PINNED[key]
        assert (rec["arg_bytes_per_device"], rec["bytes"].get("cache", 0),
                rec.get("reference_cache_bytes", 0)) == (total, cache,
                                                         ref_cache), key
        assert total - want == kv + cache - ref_cache, key
        assert rec["builds"] == (rec["arch"] != "qwen1.5-32b"), key
    assert set(PINNED) == {(r["mesh"], r["arch"], r["shape"]) for r in results
                           if r["ok"] is True and registry.get_arch(
                               r["arch"]).family == "lm"}
    kimi = next(r for r in results if r["mesh"] == "16x16" and
                (r["arch"], r["shape"]) == ("kimi-k2-1t-a32b", "train_4k"))
    assert round(kimi["reference_layout_bytes"] / 1e9, 3) == 8.199
    assert (kimi["optimizer"], kimi["fsdp"]) == ("adafactor", True)
    gemma = next(r for r in results if r["mesh"] == "16x16" and
                 (r["arch"], r["shape"]) == ("gemma2-9b", "train_4k"))
    assert gemma["fsdp"] is False and "fsdp=False" in gemma["notes"]


def test_dry_run_cli_summary_and_exit_code(capsys, tmp_path, monkeypatch):
    out = tmp_path / "dry.json"
    assert dryrun.main(["--arch", "gemma2-9b", "--shape", "train_4k",
                        "--out", str(out)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == "[dryrun] 1 ok / 0 skipped / 0 failed of 1"
    assert lines[-1] == f"[dryrun] wrote {out}"
    assert dryrun.main(["--arch", "qwen1.5-32b", "--shape", "long_500k",
                        "--multi-pod"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == \
        "[dryrun] 0 ok / 1 skipped / 0 failed of 1"

    def broken(arch, shape, mesh, reference=False):
        raise RuntimeError("no account")
    monkeypatch.setattr(steps, "arg_bytes", broken)
    assert dryrun.main(["--arch", "sasrec", "--shape", "serve_p99",
                        "--both-meshes"]) == 1
    text = capsys.readouterr().out
    assert text.strip().splitlines()[-1] == \
        "[dryrun] 0 ok / 0 skipped / 2 failed of 2"
    assert "FAILED: RuntimeError: no account" in text
    with pytest.raises(SystemExit):
        dryrun.main([])
