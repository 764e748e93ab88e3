"""Device time launched inside the ``transforms.*`` spans (the fill chain
and the autocorrelations), in ms a call of the traced set
(``benchlib.spans``); ``transforms_ms.vol`` is the benchmark's own,
synchronized span around the same stages."""
from benchlib import spans


def read(run):
    got = spans.collect(run)
    tr = got["trace"] if got is not None else None
    if tr is None:
        return None
    s = [v for k, v in tr["span_device_s"].items()
         if k.startswith("transforms.")]
    return 1e3 * sum(s) / tr["calls"] if s else None
