"""Table 6 analogue: secondary-cluster ablation — BACO w/o SCU, w/ SCU,
w/ SCI (secondary ITEM clusters), w/ both (port of
``benchmarks/table6_scu.py``). The reference builds its engine when the
module is imported; here :func:`run` builds it on the run's device, so
importing the module touches no device."""
from __future__ import annotations

import sys

import numpy as np

from repro_torch.core import (ClusterEngine, Sketch, compact_labels,
                              make_weights)
from repro_torch.core.graph import BipartiteGraph
from repro_torch.launch.paper.common import Row, get_dataset, main, train_eval

VARIANTS = [("wo_scu", False, False), ("w_scu", True, False),
            ("w_sci", False, True), ("w_scu_sci", True, True)]


def _transposed(graph):
    perm = graph.perm_by_item
    return BipartiteGraph(graph.n_items, graph.n_users,
                          graph.edge_v[perm], graph.edge_u[perm],
                          np.argsort(graph.edge_u[perm],
                                     kind="stable").astype(np.int32))


def _secondary_item_labels(engine, graph, labels, wu, wv, gamma):
    """SCI: runner-up clusters for ITEMS via the transposed graph."""
    gt = _transposed(graph)
    lt = np.concatenate([labels[graph.n_users:], labels[:graph.n_users]])
    return engine.secondary_user_labels(gt, lt, wv, wu, gamma)


def _variant(engine, train, scu: bool, sci: bool, d=64, ratio=0.25):
    wu, wv = make_weights(train, "hws")
    budget = int(ratio * train.n_nodes)
    eff = budget
    if scu:
        eff = max(2, int((budget * d - train.n_users) // d))
    if sci:
        eff = max(2, int((eff * d - train.n_items) // d))
    gamma, labels, _ = engine.fit_gamma(train, wu, wv, eff)
    pu, pv = labels[:train.n_users], labels[train.n_users:]
    if scu:
        su = engine.secondary_user_labels(train, labels, wu, wv, gamma)
        ku, pu_c, su_c = compact_labels(pu, su)
        user_idx = np.stack([pu_c, su_c], axis=1)
    else:
        ku, pu_c = compact_labels(pu)
        user_idx = pu_c[:, None]
    if sci:
        si = _secondary_item_labels(engine, train, labels, wu, wv, gamma)
        kv, pv_c, si_c = compact_labels(pv, si)
        item_idx = np.stack([pv_c, si_c], axis=1)
    else:
        kv, pv_c = compact_labels(pv)
        item_idx = pv_c[:, None]
    return Sketch(user_idx, item_idx, ku, kv,
                  method=f"baco[scu={scu},sci={sci}]")


def run(fast: bool = True, device="cuda"):
    rows = Row()
    engine = ClusterEngine(device=device)
    ds = "gowalla_s"
    _, _, _, train, test = get_dataset(ds)
    steps = 400 if fast else 800
    for name, scu, sci in VARIANTS:
        sk = _variant(engine, train, scu, sci)
        res, _ = train_eval(train, sk, test, steps=steps, device=device)
        rows.add(f"table6/{ds}/baco_{name}", res["train_s"] / steps * 1e6,
                 recall20=res["recall"], ndcg20=res["ndcg"],
                 params=res["params"])
    return rows.emit()


if __name__ == "__main__":
    sys.exit(main(run, doc=__doc__))
