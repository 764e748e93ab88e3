"""Rows x time steps the objective's sweeps covered, forward and adjoint,
a call: ``work.objective_row_steps`` over the span calls
(``benchlib.spans``), the work a whole-fit roofline share divides by."""
from benchlib import spans


def read(run):
    got = spans.collect(run)
    work = got["calls"]["work"] if got is not None else {}
    if not work.get("work.objective_row_steps"):
        return None
    return work["work.objective_row_steps"] / got["calls"]["calls"]
