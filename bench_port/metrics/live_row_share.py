"""Share of the rows of every objective evaluation that were live (not yet
converged or failed) when their iteration began: ``work.live_row_evals``
over ``work.row_evals`` in the span calls (``benchlib.spans``)."""
from benchlib import spans


def read(run):
    got = spans.collect(run)
    work = got["calls"]["work"] if got is not None else {}
    if not work.get("work.row_evals"):
        return None
    return work.get("work.live_row_evals", 0) / work["work.row_evals"]
