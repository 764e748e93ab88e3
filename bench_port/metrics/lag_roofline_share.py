"""The CSS lag route's share of its bandwidth roofline: the least time
its launches' bytes take at 3.35 TB/s (``_lag_bytes.py`` over the
``work.css_lag_*`` counters a span call, ``benchlib.spans``) over the lag
kernels' device time a traced call (``lag_kernel_ms``)."""
import importlib.util
from pathlib import Path

from benchlib import spans


def _load(name):
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name, Path(__file__).with_name(f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_bytes = _load("_lag_bytes")
_ms = _load("lag_kernel_ms")


def read(run):
    ms = _ms.read(run)
    got = spans.collect(run) if ms is not None else None
    if got is None:
        return None
    work = {k: v / got["calls"]["calls"]
            for k, v in got["calls"]["work"].items()}
    floor = _bytes.floor_ms(work)
    return None if floor is None else floor / ms
