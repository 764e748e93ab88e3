"""The optimizer's device-to-host reads a call: the difference of
``utils.optim.host_reads.count`` around each call of the window."""


def read(run):
    if not run.calls:
        return None
    n = sum(c["host_reads"] for c in run.calls) / len(run.calls)
    return n if n > 0 else None
