"""Share of the window's fitted series whose status is OK."""


def read(run):
    rows = sum(c.get("fit_rows", 0) for c in run.calls)
    if not rows:
        return None
    return sum(c.get("ok_rows", 0) for c in run.calls) / rows
