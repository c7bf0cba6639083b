"""repro_torch — the PyTorch/CUDA port of the BACO reproduction.

A package beside ``repro`` (the JAX reference) with the same subpackage
layout. It imports ``torch`` and never ``jax`` or ``repro``. Entry
points run on the CUDA device unless the caller passes ``device="cpu"``;
the hand-written CUDA kernels live in ``repro_torch.kernels``.
"""
