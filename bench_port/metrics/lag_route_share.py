"""Share of the CSS kernels' launches that took ``csrc/css.cu``'s lag
route: ``work.css_lag_launches`` over ``work.css_launches`` in the span
calls (``benchlib.spans``)."""
from benchlib import spans


def read(run):
    got = spans.collect(run)
    work = got["calls"]["work"] if got is not None else {}
    if not work.get("work.css_launches"):
        return None
    return work.get("work.css_lag_launches", 0) / work["work.css_launches"]
