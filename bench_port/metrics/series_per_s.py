"""Series of every call completed in the window over the window's elapsed
seconds."""


def read(run):
    if not run.calls or run.elapsed <= 0:
        return None
    return len(run.calls) * run.rows / run.elapsed
