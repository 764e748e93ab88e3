"""The seasonal fit's expansion of its polynomials into lag coefficients,
in ms a call: the ``fit.expand`` spans' wall over the span calls
(``benchlib.spans``)."""
from benchlib import spans


def read(run):
    got = spans.collect(run)
    if got is None or "fit.expand" not in got["calls"]["span_s"]:
        return None
    c = got["calls"]
    return 1e3 * c["span_s"]["fit.expand"] / c["calls"]
