"""1 - device busy time a call over the median wall of a call that the
profiler did not slow.  The busy time comes from the ``torch.profiler``
trace of the recorded calls; the wall from the same run's calls outside
the profiler, since the profiler's host cost lengthens the calls it
records (``busy_s`` / ``window_s`` in the line's ``device`` keep that
traced wall).  Without such calls, the traced wall is used."""

import statistics


def read(run):
    tr = run.trace
    if not tr or not tr.get("busy_s") or not tr.get("calls"):
        return None
    walls = [c["wall"] for c in run.calls if not c.get("profiled")]
    if not walls:
        return 1.0 - tr["busy_s"] / tr["window_s"] if tr.get("window_s") \
            else None
    return 1.0 - tr["busy_s"] / tr["calls"] / statistics.median(walls)
