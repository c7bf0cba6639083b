# Ensures the repo root (for `import benchmarks`) is importable when
# pytest runs with only PYTHONPATH=src.
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running integration test (subprocess compiles on a "
        "512-device host mesh); deselect with -m 'not slow'")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the port's CUDA kernels); skips "
        "without one")
