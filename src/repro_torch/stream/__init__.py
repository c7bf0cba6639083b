"""repro_torch.stream — online co-clustering and hot-swap serving on the
GPU (port of ``repro.stream``).

Everything before this package clusters once and serves a frozen
codebook; the paper's production setting is a live system where users,
items and interactions keep arriving, and BACO's cheap LP solver is
exactly what makes periodic re-grouping affordable (PAPER.md §4.3).
Three layers:

  * ``StreamingGraph`` — append-only incremental graph (host numpy):
    edge blocks are merged into the sorted key run with the
    ``from_edge_blocks`` merge path; state is bitwise-equal to a from-scratch rebuild, and degree
    memos survive appends via exact incremental updates.
  * ``ColdStartAssigner`` / ``StreamUpdater`` — incremental membership:
    brand-new nodes are placed with one LP half-step on the device over
    only their incident edges (volume-balance term kept);
    ``refresh()`` runs a budgeted warm-started full re-solve and
    reports label churn; label -> codebook-row maps stay stable so the
    trained codebooks survive every update.
  * hot-swap serving — ``CompressedArtifact.delta``/``apply_delta``
    ship versioned state patches, and ``RecsysSession.swap`` copies the
    new state into the session's device tensors between requests,
    allocating nothing while it fits the capacity ladder
    (``repro_torch.serve.capacity_plan``).

Drive it end to end::

    from repro_torch.data import drifting_coclusters
    from repro_torch.stream import StreamUpdater, ReplayConfig, replay

    stream = drifting_coclusters(2000, 1600, k_true=24, avg_deg=10, T=6)
    ...                       # cluster + train the warm prefix
    updater = StreamUpdater.from_trainer(trainer)
    session = trainer.export().session(capacity="auto", scorer="fused")
    replay(updater, stream.steps, session, ReplayConfig())

CLI: ``python -m repro_torch.launch.stream`` (``--device cpu`` to run
on the CPU); ``chip_smoke.py`` replays a stream at full amazonbook width.
"""
from .assign import AssignStats, ColdStartAssigner, RefreshStats, \
    grow_labels
from .graph import AppendInfo, StreamingGraph
from .online import CapacityTuner, StreamUpdater
from .replay import ReplayConfig, replay

__all__ = ["AppendInfo", "AssignStats", "CapacityTuner",
           "ColdStartAssigner", "RefreshStats", "StreamingGraph",
           "StreamUpdater", "ReplayConfig", "grow_labels", "replay"]
