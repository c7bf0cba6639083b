"""One gloo rank of ``tests/test_torch_mesh_cells.py``'s 4-rank world.

    python tests/torch_mesh_cells_worker.py RANK WORLD STORE_FILE OUT_DIR INPUTS

Every rank joins the world through a file store and, on each of the
(2, 2) and (1, 4) ("data", "model") meshes, builds the recsys, cf and
GNN smoke cells of ``CELLS`` through ``build_cell(mesh=..., args=...)``
on the JAX package's inputs (``INPUTS``, an ``.npz`` the test writes: each
cell's params, statics and batch as the reference holds them): a serve
cell's output, a train cell's loss and gradients (``Cell.fn.
value_and_grad``, gathered whole) and its params after one step
(``Cell.gather``). It also holds the row-sharded lookup of every field of
the DLRM smoke config (compressed and plain) against the one-card lookup,
bitwise: the rows, and the table's gradient of a seeded cotangent. Rank
0 pickles what it saw to ``OUT_DIR/rank0.pkl``. Imports nothing of JAX.
"""
import pickle
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

MESHES = ((2, 2), (1, 4))
# tests/torch_mesh_oracle.py's CELLS
CELLS = (("dlrm-mlperf", "serve_p99"), ("dlrm-mlperf", "train_batch"),
         ("dlrm-mlperf-baco", "train_batch"),
         ("wide-deep-baco", "train_batch"), ("sasrec-baco", "train_batch"),
         ("bert4rec-baco", "train_batch"), ("lightgcn-baco", "bpr_train"),
         ("schnet", "full_graph_sm"), ("schnet", "molecule"))


def nested(flat: dict):
    """A tree of dicts, and lists where every key of a level is a digit
    (the reference's params: ``bot/0/w``)."""
    out = {}
    for key, v in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(out)


def load_inputs(path: str) -> dict:
    """{"arch:shape": {"params", "statics", "batch"}}: float arrays as
    float32 tensors, int arrays as int32."""
    z = np.load(path)
    flat = {}
    for k in z.files:
        a = np.array(z[k])
        t = torch.from_numpy(a.astype(np.int32) if a.dtype.kind in "iu"
                             else a)
        cell, rest = k.split("/", 1)
        flat.setdefault(cell, {})[rest] = t
    return {cell: nested(v) for cell, v in flat.items()}


def clone(tree):
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone(v) for v in tree]
    return tree.clone()


def port_args(arch: str, shape: str, inp: dict) -> tuple:
    """The unsharded cell's args in the port's form (the cf edges sorted
    by user into the port's sorted-edge statics; a fresh optimizer
    state, None)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import lightgcn as LG

    spec = get_arch(arch)
    params, batch = clone(inp["params"]), clone(inp["batch"])
    statics = clone(inp.get("statics", {}))
    if spec.family == "cf":
        cfg = spec.smoke_config()
        eu, ev, en = (statics[k].numpy() for k in ("edge_u", "edge_v",
                                                   "edge_norm"))
        order = np.argsort(eu, kind="stable")
        sk = {k: statics[k] for k in ("sketch_u", "sketch_v")}
        statics = LG.sorted_edge_statics(eu[order], ev[order], en[order],
                                         cfg.n_users, cfg.n_items,
                                         device="cpu")
        statics.update(sk)
    if spec.family == "gnn":
        return (params, None, batch)
    kind = spec.shape(shape).kind
    return (params, None, statics, batch) if kind == "train" else \
        (params, statics, batch)


def mesh_cell(mesh, arch: str, shape: str, inp: dict) -> dict:
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import recsys as R

    cell = build_cell(arch, shape, mesh=mesh, smoke=True, device="cpu",
                      lookup_backend="gather",
                      args=port_args(arch, shape, inp))
    out = {"notes": cell.notes}
    if cell.kind != "train":
        out["out"] = cell.fn(*cell.args)
        return out
    params, b = cell.args[0], cell.args[-1]
    statics = cell.args[2] if len(cell.args) == 4 else None
    if statics is None:
        loss, grads = cell.fn.value_and_grad(params, b)
    else:
        loss, grads = cell.fn.value_and_grad(params, statics, b)
    layouts = R.flat_params(cell.layouts["params"])
    out["loss"] = loss
    out["grads"] = {k: layouts[k].gather(g) for k, g in grads.items()}
    out["step_loss"] = cell.fn(*cell.args)[-1]
    out["params"] = R.flat_params(cell.gather("params", cell.args[0]))
    return out


def lookups_bitwise(mesh, inp: dict) -> dict:
    """Every field of the DLRM smoke config through the row-sharded lookup
    on the mesh against the one-card lookup on the whole tables: the rows
    (gathered over the data ranks) and each table's gradient of a seeded
    cotangent [B, d] (this rank's rows of it), equal as ``torch.equal``
    holds them."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.distributed import parallel as par
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import recsys as R

    cfg = get_arch("dlrm-mlperf").smoke_config()
    params, statics = inp["params"], inp["statics"]
    sparse = inp["batch"]["sparse"]
    b = sparse.shape[0]
    groups = par.rank_groups(mesh, b)
    out = {}
    for f in range(cfg.n_sparse):
        key, skey = f"emb_{f}", f"sketch_{f}"
        table = params[key]
        sketch = statics.get(skey)
        cot = torch.randn((b, table.shape[1]),
                          generator=torch.Generator().manual_seed(f))
        full = table.clone().requires_grad_(True)
        want = R._field_lookup(full, sparse[:, f], sketch, "gather")
        (want_g,) = torch.autograd.grad(want, full, cot)
        lay = sh.named_sharding(mesh, "vocab", None, shape=tuple(table.shape))
        block = lay.local_block(table).clone().requires_grad_(True)
        rows = {key: par.row_block(lay, table.shape[0])}
        sk_block = None
        if sketch is not None:
            sk_lay = sh.named_sharding(mesh, "vocab", None,
                                       shape=tuple(sketch.shape))
            rows[skey] = par.row_block(sk_lay, sketch.shape[0])
            sk_block = sk_lay.local_block(sketch)
        n, r = groups.n_data, groups.data_rank
        mine = slice(r * b // n, (r + 1) * b // n)
        got = R.row_lookup(block, sparse[mine, f], rows[key], groups,
                           sketch=sk_block, sketch_rows=rows.get(skey),
                           backend="gather")
        (got_g,) = torch.autograd.grad(got, block, cot[mine])
        out[f] = {"rows": bool(torch.equal(
            par.all_gather_cat(got.detach(), groups.data_group, 0), want)),
            "grad": bool(torch.equal(lay.gather(got_g), want_g)),
            "compressed": sketch is not None,
            "split": rows[key].group is not None}
    return out


def run(inputs: dict) -> dict:
    from torch.distributed.device_mesh import init_device_mesh

    out = {"seconds": {}}
    for shape in MESHES:
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        tag = f"{shape[0]}x{shape[1]}"
        res = {"lookups": lookups_bitwise(mesh,
                                          inputs["dlrm-mlperf:train_batch"])}
        for arch, sh in CELLS:
            t0 = time.perf_counter()
            res[f"{arch}:{sh}"] = mesh_cell(mesh, arch, sh,
                                            inputs[f"{arch}:{sh}"])
            out["seconds"][f"{tag}/{arch}:{sh}"] = time.perf_counter() - t0
        out[tag] = res
    return out


def np_tree_any(x):
    """Tensors as float32 numpy arrays, through dicts; the rest as is."""
    if isinstance(x, dict):
        return {k: np_tree_any(v) for k, v in x.items()}
    if torch.is_tensor(x):
        return x.detach().float().numpy().copy()
    return x


def main(argv) -> int:
    rank, world = int(argv[1]), int(argv[2])
    store, out_dir, inputs = argv[3], argv[4], argv[5]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        out = run(load_inputs(inputs))
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(f"{out_dir}/rank0.pkl", "wb") as f:
            pickle.dump(np_tree_any(out), f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
