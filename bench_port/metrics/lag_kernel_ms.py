"""Device time of the CSS lag route's kernels (``css_fwd_lag*`` and
``css_bwd_lag*`` of ``csrc/css.cu``) a call (ms), from the trace."""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "bench_metric_kernels", Path(__file__).with_name("_kernels.py"))
_k = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_k)

LAG_KERNELS = ("css_fwd_lag", "css_bwd_lag")


def read(run):
    tr = run.trace
    if not tr or not tr.get("calls") or not tr.get("device_ops"):
        return None
    s = sum(v for n, v in tr["device_ops"].items()
            if _k.is_port_kernel(n, LAG_KERNELS))
    return 1e3 * s / tr["calls"] if s > 0 else None
