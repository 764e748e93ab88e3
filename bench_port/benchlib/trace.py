"""Read the device timeline of the traced calls from ``torch.profiler``.

The device's busy time is the union of its operations' intervals; idle
gaps are the stretches between them, each put down to the innermost host
operation running at its midpoint (``python`` where none is).  The
per-event device time follows ``chip_smoke.py``'s ``_device_us`` (either
attribute name the installed PyTorch has).
"""

import bisect

import torch


def start(active: int = 1, warmup: int = 0):
    """A running profiler that records ``active`` steps after ``warmup``
    steps that it runs without recording (``prof.step()`` after each
    call): the profiler's own start-up stays out of what it records."""
    from torch.profiler import ProfilerActivity, profile, schedule
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=warmup, active=active,
                                     repeat=1))
    prof.__enter__()
    return prof


def stop(prof) -> None:
    prof.__exit__(None, None, None)


def device_us(evt) -> float:
    return (getattr(evt, "device_time_total", None)
            or getattr(evt, "cuda_time_total", 0) or 0)


def _is_device(evt) -> bool:
    """A device operation: not a range the profiler or the program marks
    on the device's timeline (``ProfilerStep*``, ``record_function``)."""
    return (evt.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(evt, "is_user_annotation", False)
            and not evt.name.startswith("ProfilerStep"))


def summarize(prof, window_s: float, calls: int) -> dict:
    """``{busy_s, window_s, calls, device_ops: {name: s}, idle_gaps:
    {host op: s}}`` over the traced window."""
    events = list(prof.events())
    cuda = torch.autograd.DeviceType.CUDA
    dev = [e for e in events if _is_device(e)]
    host = [e for e in events if e.device_type != cuda
            and not e.name.startswith("ProfilerStep")]
    ops = {}
    spans = []
    for e in dev:
        a, b = e.time_range.start, e.time_range.end
        ops[e.name] = ops.get(e.name, 0.0) + (b - a) / 1e6
        spans.append((a, b))
    if not spans:  # no per-event device intervals: sum by kernel instead
        busy = sum(device_us(e) for e in prof.key_averages()
                   if _is_device(e)) / 1e6
        return {"busy_s": busy, "window_s": window_s, "calls": calls,
                "device_ops": {e.key: device_us(e) / 1e6
                               for e in prof.key_averages() if _is_device(e)},
                "idle_gaps": {}}
    spans.sort()
    merged = [list(spans[0])]
    for a, b in spans[1:]:
        if a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) / 1e6
    # host operations sorted by start, to find those under a gap's midpoint
    host.sort(key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    gaps = {}
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = 0.5 * (a + b)
        # the latest-started op still running at the midpoint is the
        # innermost one there
        name = "python"
        i = bisect.bisect_right(starts, mid)
        for e in reversed(host[max(0, i - 2000):i]):
            if e.time_range.end >= mid:
                name = e.name
                break
        gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6
    return {"busy_s": busy, "window_s": window_s, "calls": calls,
            "device_ops": ops, "idle_gaps": gaps}


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
