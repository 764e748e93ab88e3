"""Mean over rows of a fit's per-row L-BFGS iterations, averaged over the
window's calls (``FitResult.iters``)."""


def read(run):
    vals = [c["iters_mean"] for c in run.calls
            if c.get("iters_mean") is not None]
    return sum(vals) / len(vals) if vals else None
