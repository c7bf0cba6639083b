"""Table 5 analogue: weighting-scheme ablation inside the unified
framework — HWS vs modularity vs CPM vs reverse-HWS, for both the LP
solver (BACO) and Louvain (port of ``benchmarks/table5_weighting.py``;
the Louvain rows, HWS and CPM, run at full size only)."""
from __future__ import annotations

import sys

from repro_torch.core import (ClusterEngine, Sketch, compact_labels,
                              make_weights)
from repro_torch.core.baselines import _louvain_family, louvain_cpm_sketch
from repro_torch.launch.paper.common import Row, get_dataset, main, train_eval

SCHEMES = ["hws", "modularity", "cpm", "reverse_hws"]


def _lp_sketch(train, scheme, budget, device="cuda"):
    wu, wv = make_weights(train, scheme)
    gamma, labels, _ = ClusterEngine(device=device).fit_gamma(train, wu, wv,
                                                              budget)
    ku, ul = compact_labels(labels[:train.n_users])
    kv, il = compact_labels(labels[train.n_users:])
    return Sketch(ul[:, None], il[:, None], ku, kv,
                  method=f"lp[{scheme}]")


def _louvain_sketch(train, scheme, budget):
    """A Louvain row's sketch: HWS at gamma 1, CPM at ``louvain_cpm``'s
    edge-density gamma. (The reference hands ``_louvain_family`` a gamma
    of None for CPM, which raises: ROADMAP Queue 3 #17.)"""
    if scheme == "cpm":
        return louvain_cpm_sketch(train, budget)
    return _louvain_family(train, budget, scheme, 1.0)


def run(fast: bool = True, device="cuda"):
    rows = Row()
    datasets = ["gowalla_s"] if fast else ["gowalla_s", "yelp2018_s"]
    steps = 400 if fast else 800
    for ds in datasets:
        _, _, _, train, test = get_dataset(ds)
        budget = int(0.25 * train.n_nodes)
        for sch in SCHEMES:
            sk = _lp_sketch(train, sch, budget, device)
            res, _ = train_eval(train, sk, test, steps=steps, device=device)
            rows.add(f"table5/{ds}/lp+{sch}", res["train_s"] / steps * 1e6,
                     recall20=res["recall"], ndcg20=res["ndcg"])
        if not fast:
            for sch in ["hws", "cpm"]:
                sk = _louvain_sketch(train, sch, budget)
                res, _ = train_eval(train, sk, test, steps=steps,
                                    device=device)
                rows.add(f"table5/{ds}/louvain+{sch}",
                         res["train_s"] / steps * 1e6,
                         recall20=res["recall"], ndcg20=res["ndcg"])
    return rows.emit()


if __name__ == "__main__":
    sys.exit(main(run, doc=__doc__))
