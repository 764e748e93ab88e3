"""Device time launched inside the fits' ``fit.prep`` spans, in ms a call
of the traced set (``benchlib.spans``): the alignment probe, the
differencing, the layout copy into the kernels' layout and the start."""
from benchlib import spans


def read(run):
    got = spans.collect(run)
    tr = got["trace"] if got is not None else None
    if tr is None or "fit.prep" not in tr["span_device_s"]:
        return None
    return 1e3 * tr["span_device_s"]["fit.prep"] / tr["calls"]
