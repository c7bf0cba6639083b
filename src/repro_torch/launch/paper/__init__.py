"""The paper's experiments on the port (port of ``benchmarks/``' table
and figure modules): one module per table or figure, each with the
reference's name and a ``run(fast=True, device="cuda")`` that returns
``name,us_per_call,derived`` rows, and the suite that records them
(:mod:`repro_torch.launch.paper.run`)::

    python -m repro_torch.launch.paper.run [--fast|--full] [--only NAME]
        [--device cuda|cpu] [--store DIR]
    python -m repro_torch.launch.paper.table4_recall [--full] [--device cpu]

``common`` holds the shared helpers (datasets, sketches, train + eval,
cluster metrics, the row accumulator and a clock that synchronizes the
device before every read).
"""
