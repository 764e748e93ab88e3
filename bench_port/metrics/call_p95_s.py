"""95th percentile of the wall of every call in the window
(``statistics.quantiles``, inclusive)."""
import statistics


def read(run):
    walls = [c["wall"] for c in run.calls]
    if not walls:
        return None
    if len(walls) < 2:
        return walls[0]
    return statistics.quantiles(walls, n=20, method="inclusive")[18]
