"""Table 9 analogue: average L2 distance between FULL-model embeddings
and the codebook-expanded embeddings of each compressed model — SCU
should pull the user side closer to the full model (port of
``benchmarks/table9_distance.py``; the propagated embeddings come from
``models/lightgcn.all_embeddings`` on the trainer's device)."""
from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch.launch.paper.common import (Row, get_dataset, main,
                                             sketch_for, train_eval)
from repro_torch.models import lightgcn as L


def embeddings(tr):
    """The trainer's propagated (U, V) embeddings as host arrays."""
    with torch.no_grad():
        u, v = L.all_embeddings(tr.params, tr.statics, tr.mcfg)
    return u.cpu().numpy(), v.cpu().numpy()


def distances(u, v, u_full, v_full) -> dict:
    """Mean L2 distance a user, an item, and over all nodes."""
    du = float(np.linalg.norm(u - u_full, axis=1).mean())
    dv = float(np.linalg.norm(v - v_full, axis=1).mean())
    nu, nv = u.shape[0], v.shape[0]
    return {"dist_user": du, "dist_item": dv,
            "dist_all": (du * nu + dv * nv) / (nu + nv)}


def run(fast: bool = True, device="cuda"):
    rows = Row()
    ds = "gowalla_s"
    _, _, _, train, test = get_dataset(ds)
    steps = 400 if fast else 800
    # reference: the full model's propagated embeddings
    _, tr_full = train_eval(train, None, test, steps=steps, device=device)
    u_full, v_full = embeddings(tr_full)
    for m in (["louvain_modularity", "scc", "baco_no_scu", "baco"]
              if fast else ["louvain_modularity", "lp", "scc",
                            "baco_no_scu", "baco"]):
        sk = sketch_for(m, train, device=device)
        _, tr = train_eval(train, sk, test, steps=steps, device=device)
        rows.add(f"table9/{ds}/{m}", 0.0,
                 **distances(*embeddings(tr), u_full, v_full))
    return rows.emit()


if __name__ == "__main__":
    sys.exit(main(run, doc=__doc__))
