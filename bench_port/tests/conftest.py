"""The benchmark's own tests: run from the repository root with
``python -m pytest bench_port/tests -q``.  They import neither JAX nor the
JAX package.  Tests marked ``card`` need a CUDA device and skip without
one (decided inside each test)."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [os.path.dirname(BENCH), BENCH]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")
