"""Figure 1 analogue: cross-cluster links (ACCL) + Gini coefficients per
method — the empirical study motivating BACO's two objectives (port of
``benchmarks/fig1_balance_study.py``)."""
from __future__ import annotations

import sys

from repro_torch.launch.paper.common import (Row, cluster_metrics,
                                             get_dataset, main, now,
                                             sketch_for)

METHODS = ["random", "frequency", "lp", "louvain_modularity", "scc", "sbc",
           "baco_no_scu", "baco"]


def run(fast: bool = True, device="cuda"):
    rows = Row()
    ds = "gowalla_s" if fast else "gowalla"
    _, _, _, train, _ = get_dataset(ds)
    for m in METHODS:
        t0 = now()
        sk = sketch_for(m, train, device=device)
        dt = now() - t0
        cm = cluster_metrics(train, sk)
        rows.add(f"fig1/{ds}/{m}", dt * 1e6, **cm)
    return rows.emit()


if __name__ == "__main__":
    sys.exit(main(run, doc=__doc__))
