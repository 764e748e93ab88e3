"""The host's wait in the optimizer's counted device reads, in ms a call:
the ``optim.host_read`` spans' wall summed over the span calls
(``benchlib.spans``), over the calls."""
from benchlib import spans


def read(run):
    got = spans.collect(run)
    if got is None or "optim.host_read" not in got["calls"]["span_s"]:
        return None
    c = got["calls"]
    return 1e3 * c["span_s"]["optim.host_read"] / c["calls"]
