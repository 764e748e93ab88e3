"""Launches of the port's kernels a call: the difference of
``ops.cuda_kernels.LAUNCHES`` around each call of the window."""


def read(run):
    if not run.calls:
        return None
    n = sum(c["launches"] for c in run.calls) / len(run.calls)
    return n if n > 0 else None
