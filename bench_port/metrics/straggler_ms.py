"""The optimizer's straggler stage, in ms a call: the ``optim.compact``
and ``optim.stragglers`` spans' wall over the span calls
(``benchlib.spans``); 0 where the program's optimizer ran and never
compacted."""
from benchlib import spans


def read(run):
    got = spans.collect(run)
    if got is None or "optim.minimize" not in got["calls"]["span_s"]:
        return None
    c = got["calls"]
    s = c["span_s"]
    return 1e3 * (s.get("optim.compact", 0.0)
                  + s.get("optim.stragglers", 0.0)) / c["calls"]
