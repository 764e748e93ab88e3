"""Device time a call (ms) of every operation that is not one of the
port's kernels (PyTorch elementwise operations, copies, reductions), from
the trace."""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "bench_metric_kernels", Path(__file__).with_name("_kernels.py"))
_k = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_k)


def read(run):
    split = _k.split_ms(run)
    return None if split is None or split[1] <= 0 else split[1]
