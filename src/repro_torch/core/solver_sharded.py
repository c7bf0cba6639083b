"""Edge-partitioned co-clustering over several ranks ("torch_sharded";
port of ``repro.core.solver_sharded``).

The math is ``solver_torch``'s (its ``_half_step`` and ``solve_loop``),
over the edge blocks of ``repro_torch.distributed.sharding``: each rank owns a
contiguous range of the updating side's nodes plus exactly the edges
into that range (blocks cut on the host once and memoized on the graph;
each rank uploads only its own), runs the sort/scan half-step over them,
and combines only the per-label opposite-side weight totals (one
f32[n_nodes] vector) with an all-reduce. The new labels are all-gathered,
so every rank holds all of them and takes the same convergence and
budget decisions in lockstep.

On a world of 1 this is the single-device solve bit for bit: the
reference pads the opposite side with label 0 and weight 0.0, which
adds ``+0.0`` terms to label 0's ordered fold and changes no bit. On N
ranks the all-reduce reassociates the f32 weight sums, so a score that
ties the single-device value to the last ulp could in principle resolve
differently; the tests pin labels and sweep counts on 4 gloo ranks to
the reference's, as the reference pins its mesh of 4.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (cluster_mesh, edge_partition,
                                              pad_to_shards)

from .graph import BipartiteGraph
from .solver_torch import (_bump, _half_step, _init_labels,
                           segment_sum_ordered, solve_loop)

__all__ = ["lp_solve_sharded"]


def _pad_dev(x: torch.Tensor, m: int) -> torch.Tensor:
    """Zero-pad a 1-D device tensor to length m."""
    if x.shape[0] == m:
        return x
    return torch.cat([x, x.new_zeros(m - x.shape[0])])


def _partitions(graph: BipartiteGraph, n_shards: int):
    """Per-shard edge blocks of both sides, memoized on the graph."""
    def build():
        u_node, u_opp, nps_u = edge_partition(graph.edge_u, graph.edge_v,
                                              graph.n_users, n_shards)
        ev_byv = graph.edge_v[graph.perm_by_item]
        eu_byv = graph.edge_u[graph.perm_by_item]
        v_node, v_opp, nps_v = edge_partition(ev_byv, eu_byv,
                                              graph.n_items, n_shards)
        return u_node, u_opp, nps_u, v_node, v_opp, nps_v
    return graph._memo(("edge_partition", n_shards), build)


def _rank_blocks(graph: BipartiteGraph, n_shards: int, rank: int, dev):
    """This rank's (user node, user opp, item node, item opp) blocks as
    int64 on ``dev``, the sentinel tail cut off (sentinels sort after
    every real local id and only ever feed dropped groups), memoized on
    the graph under the device edge lists' key, so
    ``drop_device_edges`` forgets them too."""
    u_node, u_opp, nps_u, v_node, v_opp, nps_v = _partitions(graph, n_shards)

    def block(node, opp, nps):
        emax = node.shape[0] // n_shards
        node = node[rank * emax:(rank + 1) * emax]
        real = int(np.searchsorted(node, nps))
        return (torch.as_tensor(node[:real], dtype=torch.int64, device=dev),
                torch.as_tensor(opp[rank * emax:rank * emax + real],
                                dtype=torch.int64, device=dev))

    def upload():
        return (*block(u_node, u_opp, nps_u), *block(v_node, v_opp, nps_v))

    return graph._memo(("torch_edges", f"edge_partition/{n_shards}/{rank}",
                        str(dev)), upload)


def lp_solve_sharded(graph: BipartiteGraph, w_users, w_items, gamma: float,
                     budget: Optional[int] = None, max_iters: int = 8,
                     init_labels=None, *, mesh=None, device="cuda",
                     stats: Optional[dict] = None
                     ) -> Tuple[np.ndarray, int]:
    """``solver_torch.lp_solve`` over the ranks of a 1-D mesh (default:
    :func:`cluster_mesh` over the current world, which raises outside
    one: open it with ``distributed.world``). Every rank of the mesh
    calls it with the same arguments and gets the same (labels int32
    [n_nodes], iters_run)."""
    dev = resolve_device(device)
    if mesh is None:
        mesh = cluster_mesh(device=dev)
    s = mesh.size()
    rank = mesh.get_local_rank()
    nu, ni = graph.n_users, graph.n_items
    n = nu + ni
    parts = _partitions(graph, s)
    nps_u, nps_v = parts[2], parts[5]
    ub_node, ub_opp, vb_node, vb_opp = _rank_blocks(graph, s, rank, dev)
    wu_pad = torch.as_tensor(pad_to_shards(np.asarray(w_users, np.float32),
                                           s, nps_u), device=dev)
    wv_pad = torch.as_tensor(pad_to_shards(np.asarray(w_items, np.float32),
                                           s, nps_v), device=dev)
    ul = slice(rank * nps_u, (rank + 1) * nps_u)
    vl = slice(rank * nps_v, (rank + 1) * nps_v)
    group = mesh.get_group(mesh.mesh_dim_names[0])
    g = torch.tensor(float(gamma), dtype=torch.float32, device=dev)

    def half(node, opp, own, w_self, lab_o, w_o, lab_o_full, nps):
        """One half-step on this rank's block: its partial per-label
        weight totals of the opposite side (the ordered segment sum, on
        CUDA one CSR gather-sum launch; bitwise the single-device sums
        on a world of 1), one all-reduce (SUM, the reference's psum),
        the local half-step, and every rank's new labels all-gathered
        ([s*nps])."""
        w_by_label = segment_sum_ordered(w_o, lab_o, n, stats)
        dist.all_reduce(w_by_label, group=group)
        new = _half_step(node, lab_o_full[opp], w_self, w_by_label, own, g,
                         nps, n)
        out = new.new_empty(s * nps)
        dist.all_gather(list(out.chunk(s)), new, group=group)
        return out

    def step(labels):
        item_lab = labels[nu:]
        lab_v_pad = _pad_dev(item_lab, s * nps_v)
        new_u = half(ub_node, ub_opp, _pad_dev(labels[:nu], s * nps_u)[ul],
                     wu_pad[ul], lab_v_pad[vl], wv_pad[vl], item_lab,
                     nps_u)[:nu]
        new_v = half(vb_node, vb_opp, lab_v_pad[vl], wv_pad[vl],
                     _pad_dev(new_u, s * nps_u)[ul], wu_pad[ul], new_u,
                     nps_v)[:ni]
        return torch.cat([new_u, new_v])

    labels, it = solve_loop(step, _init_labels(graph, init_labels, dev),
                            0 if budget is None else int(budget),
                            int(max_iters), n_users=nu, n_items=ni,
                            stats=stats)
    out = labels.to(torch.int32).cpu().numpy()
    _bump(stats, "host_syncs")
    return out, it
