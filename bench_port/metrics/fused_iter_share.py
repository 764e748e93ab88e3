"""Share of the optimizer's iterations that took its kernel route:
``work.optim_fused_iters`` over ``work.optim_iters`` in the span calls
(``benchlib.spans``); nothing where the program counts no iterations."""
from benchlib import spans


def read(run):
    got = spans.collect(run)
    work = got["calls"]["work"] if got is not None else {}
    if not work.get("work.optim_iters"):
        return None
    return work.get("work.optim_fused_iters", 0) / work["work.optim_iters"]
