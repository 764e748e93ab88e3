"""The optimizer's host time that is not a wait on the device, in ms a
call: the ``optim.minimize`` spans' wall less the ``optim.host_read``
spans' wall, over the span calls (``benchlib.spans``): the host issuing
work, in Python and launches."""
from benchlib import spans


def read(run):
    got = spans.collect(run)
    if got is None or "optim.minimize" not in got["calls"]["span_s"]:
        return None
    c = got["calls"]
    s = c["span_s"]
    return 1e3 * (s["optim.minimize"] - s.get("optim.host_read", 0.0)) \
        / c["calls"]
