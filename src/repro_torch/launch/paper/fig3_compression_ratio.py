"""Figure 3 analogue: Recall@20 when varying the compression ratio
(1/2 .. 1/6) for BACO vs random hashing (port of
``benchmarks/fig3_compression_ratio.py``)."""
from __future__ import annotations

import sys

from repro_torch.launch.paper.common import (Row, get_dataset, main,
                                             sketch_for, train_eval)


def run(fast: bool = True, device="cuda"):
    rows = Row()
    ds = "gowalla_s"
    _, _, _, train, test = get_dataset(ds)
    ratios = [1 / 2, 1 / 4, 1 / 6] if fast else [1 / 2, 1 / 3, 1 / 4,
                                                 1 / 5, 1 / 6]
    steps = 400 if fast else 800
    for r in ratios:
        for m in ["baco", "random"]:
            sk = sketch_for(m, train, ratio=r, device=device)
            res, _ = train_eval(train, sk, test, steps=steps, device=device)
            rows.add(f"fig3/{ds}/{m}@1:{round(1/r)}",
                     res["train_s"] / steps * 1e6,
                     ratio=r, recall20=res["recall"], ndcg20=res["ndcg"],
                     params=res["params"])
    return rows.emit()


if __name__ == "__main__":
    sys.exit(main(run, doc=__doc__))
