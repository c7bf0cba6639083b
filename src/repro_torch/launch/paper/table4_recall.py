"""Table 4 analogue: Recall@20 / NDCG@20 of ETC methods vs the full model
on synthetic paper-scale datasets (LightGCN + BPR, identical protocol;
port of ``benchmarks/table4_recall.py``). CCE trains through the port's
``training/cce.py::train_cce``."""
from __future__ import annotations

import sys

from repro_torch.launch.paper.common import (Row, get_dataset, main,
                                             sketch_for, train_eval)

FAST_METHODS = ["full", "random", "frequency", "lp", "louvain_modularity",
                "scc", "baco_no_scu", "baco"]
FULL_METHODS = FAST_METHODS + ["double", "hybrid", "lsh", "lpab",
                               "louvain_cpm", "double_graphhash", "leiden",
                               "sbc", "itcc"]


def run(fast: bool = True, device="cuda"):
    from repro_torch.training.cce import train_cce
    rows = Row()
    datasets = ["gowalla_s"] if fast else ["beauty_s", "gowalla_s",
                                           "yelp2018_s", "amazon_s"]
    methods = FAST_METHODS if fast else FULL_METHODS
    steps = 400 if fast else 800
    for ds in datasets:
        _, _, _, train, test = get_dataset(ds)
        for m in methods:
            sk = sketch_for(m, train, device=device)
            res, _ = train_eval(train, sk, test, steps=steps, device=device)
            rows.add(f"table4/{ds}/{m}",
                     res["train_s"] / steps * 1e6,
                     recall20=res["recall"], ndcg20=res["ndcg"],
                     params=res["params"])
        # CCE (learned sketching) couples to the training loop
        res, _, _ = train_cce(train, test,
                              budget=int(0.25 * train.n_nodes),
                              steps=steps, warm_steps=max(steps // 4, 50),
                              device=device)
        rows.add(f"table4/{ds}/cce", 0.0, recall20=res["recall"],
                 ndcg20=res["ndcg"], params=res["params"])
    return rows.emit()


if __name__ == "__main__":
    sys.exit(main(run, doc=__doc__))
