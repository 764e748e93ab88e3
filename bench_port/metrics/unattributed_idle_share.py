"""Share of the device's idle time inside the traced set's calls
(``benchlib.spans``) that falls under no span below the entry span: under
none of ``fit.prep``, ``fit.finalize``, ``optim.*``, ``transforms.*``,
each idle stretch put down to the innermost span open at its midpoint."""
from benchlib import spans


def read(run):
    got = spans.collect(run)
    tr = got["trace"] if got is not None else None
    if tr is None or tr["idle_s"] <= 0:
        return None
    return tr["unattributed_s"] / tr["idle_s"]
