"""Wall (ms) a call of the stages that the mix puts in the ``transforms``
span (fill + difference and the autocorrelations), each end synchronized;
traced runs only."""


def read(run):
    vals = [c["spans"]["transforms"] for c in run.calls
            if c.get("spans") and "transforms" in c["spans"]]
    return 1e3 * sum(vals) / len(vals) if vals else None
