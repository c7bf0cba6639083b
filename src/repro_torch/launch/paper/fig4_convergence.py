"""Figure 4 analogue: label-count (embedding-parameter ratio) vs LP
iteration — the paper reports convergence to ~20% within ~5 iterations
(port of ``benchmarks/fig4_convergence.py``; the in-memory "torch"
solver on ``device``)."""
from __future__ import annotations

import sys

import numpy as np

from repro_torch.core import ClusterEngine, make_weights
from repro_torch.launch.paper.common import Row, get_dataset, main, now

GAMMA = 8.0
ITERS = range(1, 9)


def datasets(fast: bool):
    return ["gowalla_s"] if fast else ["beauty_s", "gowalla_s",
                                       "yelp2018_s", "amazon_s"]


def label_counts(train, device="cuda"):
    """[(max_iters, seconds, k)] of one solve capped at each of ``ITERS``
    iterations, gamma ``GAMMA``, HWS weights."""
    engine = ClusterEngine(solver="torch", device=device)
    wu, wv = make_weights(train, "hws")
    out = []
    for t in ITERS:
        t0 = now()
        labels, _ = engine.solve(train, wu, wv, GAMMA, max_iters=t)
        dt = now() - t0
        out.append((t, dt, int(np.unique(labels).size)))
    return out


def run(fast: bool = True, device="cuda"):
    rows = Row()
    for ds in datasets(fast):
        _, _, _, train, _ = get_dataset(ds)
        for t, dt, k in label_counts(train, device):
            rows.add(f"fig4/{ds}/iter{t}", dt * 1e6,
                     ratio=k / train.n_nodes, k=k)
    return rows.emit()


if __name__ == "__main__":
    sys.exit(main(run, doc=__doc__))
