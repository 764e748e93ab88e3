"""The program's own spans and ``work.*`` counters, read after the window.

The per-layer metrics that read what the program measures inside itself
(PERF.md §3) take two readings, both after the measured window and only in
a traced run, so that the window and its profiler trace run as they do
without them:

- **span calls**: ``SPAN_CALLS`` calls that go round the panels as the
  window's calls do, with the ``obs`` plane on (ring only,
  ``profile=False``) and no profiler.  The registry's snapshots give the
  host-side metrics: the ``span.<name>`` wall sums and the ``work.*``
  counters, each over a call.  Each call's wall over the median wall of
  the window's unprofiled calls on the same panel, minus 1, gives the
  plane's on-cost (``on_cost``: the median of those).  Beside each span
  call runs a call with the plane off on the same panel, in turn before
  and after it, for an on-cost measured in the same state of the process
  (``on_cost_paired``): the window ran before the trace was read.
- **a traced set**: the profiler's warm-up call and ``drive.TRACE_CALLS``
  recorded calls, each inside a ``bench.call`` range, with the plane on
  and ``profile=True``, so that every span is a ``record_function`` range
  on the profiler's clock.  A device operation counts for every span open
  on the host when it was launched (its launching host event, found by
  correlation id): a span's device-side annotation covers only the
  operations launched in the span itself, not in the spans it holds.  Each
  stretch of a ``bench.call`` in which the device is idle is put down to
  the innermost span open on the host at its midpoint, or to
  ``(no span)`` (``idle_spans``).

The program's spans are told apart by the name prefixes in
``metrics/span_names/*.txt``.  A program without spans yields nothing to
read, and each reader then returns ``None``.  Both readings are made once a
run and kept on the ``Run``; what the result line has no key for (the
``idle_spans`` and ``spans`` summaries, the unexplained idle by host
operation) is printed to standard error.
"""

import collections
import gc
import statistics
import sys
import time
from pathlib import Path

import torch

from . import drive
from . import trace as tracemod

SPAN_CALLS = 4
CALL = "bench.call"
NO_SPAN = "(no span)"
# spans below the entry span: idle under none of them is unexplained
LAYER_SPANS = ("fit.prep", "fit.finalize")
LAYER_PREFIXES = ("optim.", "transforms.")
NAMES = Path(__file__).resolve().parent.parent / "metrics" / "span_names"

Event = collections.namedtuple(
    "Event", "name device annotation start end corr linked")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def prefixes() -> tuple:
    """Name prefixes of the program's spans, from ``span_names/*.txt``."""
    out = []
    for path in sorted(NAMES.glob("*.txt")):
        for line in path.read_text().splitlines():
            line = line.split("#", 1)[0].strip()
            if line:
                out.append(line)
    return tuple(out)


def is_layer(name) -> bool:
    """A span below the entry span (``fit.<model>``): the preparation, the
    finalization, the optimizer's and the transforms' spans."""
    return name is not None and (name in LAYER_SPANS
                                 or name.startswith(LAYER_PREFIXES))


# -- the trace ----------------------------------------------------------------


def raw_events(prof) -> list:
    """The profiler's events without building its event tree, or ``None``
    where the installed PyTorch does not give them so."""
    cuda = torch.autograd.DeviceType.CUDA
    try:
        out = []
        for e in prof.profiler.kineto_results.events():
            start = e.start_ns()
            out.append(Event(e.name(), e.device_type() == cuda,
                             bool(e.is_user_annotation()), start,
                             start + e.duration_ns(), e.correlation_id(),
                             e.linked_correlation_id()))
        return out
    except AttributeError:
        return None


def _open_at(points: list, ranges: list) -> list:
    """For each of ``points`` (sorted), the ``ranges`` (``Event``s sorted
    by start) open at it."""
    out, active, j = [], [], 0
    for p in points:
        while j < len(ranges) and ranges[j].start <= p:
            active.append(ranges[j])
            j += 1
        active = [r for r in active if r.end >= p]
        out.append(tuple(active))
    return out


def _innermost(open_ranges):
    """The latest-started of the open ranges (the deeper one of two that
    start together)."""
    if not open_ranges:
        return None
    return max(open_ranges, key=lambda r: (r.start, -r.end))


def merged(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_in(calls: list, busy: list) -> list:
    """The stretches of each ``(start, end)`` of ``calls`` that no interval
    of ``busy`` (merged, sorted) covers."""
    gaps = []
    for c0, c1 in calls:
        cur = c0
        for a, b in busy:
            if b <= cur:
                continue
            if a >= c1:
                break
            if a > cur:
                gaps.append((cur, a))
            cur = max(cur, b)
        if cur < c1:
            gaps.append((cur, c1))
    return gaps


def host_gaps(gaps: list, host_ops: list) -> dict:
    """``{host operation: idle s}``: each gap put down to the innermost host
    operation running at its midpoint (``python`` where none is), as
    ``benchlib.trace.summarize`` puts its idle gaps; ``host_ops`` hold no
    program span and no ``bench.call``."""
    ops = sorted(host_ops, key=lambda e: e.start)
    out = {}
    mids = sorted(((a + b) / 2, b - a) for a, b in gaps)
    for (_, width), open_ops in zip(mids, _open_at([m for m, _ in mids],
                                                  ops)):
        op = max(open_ops, key=lambda e: e.start) if open_ops else None
        name = op.name if op is not None else "python"
        out[name] = out.get(name, 0.0) + width / 1e9
    return out


def read_trace(events: list, program: tuple) -> dict:
    """The traced set's readings (times in s, over every recorded call), or
    ``None`` without a ``bench.call``, a program span or a device
    operation: ``calls``, ``span_device_s`` (device time launched inside
    each span name), ``idle_s`` (device idle inside the calls),
    ``idle_spans``, ``unattributed_s`` and ``unattributed_ops`` (the idle
    under no span below the entry span, by host operation)."""
    host = [e for e in events if not e.device]
    calls = sorted((e.start, e.end) for e in host if e.name == CALL)
    spans = sorted((e for e in host if e.annotation and e.name != CALL
                    and e.name.startswith(program)),
                   key=lambda e: (e.start, -e.end))
    ops = [e for e in events if e.device and not e.annotation
           and not e.name.startswith("ProfilerStep")]
    if not calls or not spans or not ops:
        return None
    # device time: each operation counts for every span open at its launch
    by_corr = {e.corr: e for e in host}
    launched = sorted((by_corr[d.linked].start, d.end - d.start)
                      for d in ops if d.linked in by_corr)
    span_device = {}
    for (_, dur), open_spans in zip(launched, _open_at(
            [t for t, _ in launched], spans)):
        for name in {s.name for s in open_spans}:
            span_device[name] = span_device.get(name, 0.0) + dur / 1e9
    # idle inside the calls, by the innermost span at each gap's midpoint
    gaps = idle_in(calls, merged([(d.start, d.end) for d in ops]))
    mids = sorted(((a + b) / 2, (a, b)) for a, b in gaps)
    idle_spans, unexplained = {}, []
    for (_, gap), open_spans in zip(mids, _open_at([m for m, _ in mids],
                                                   spans)):
        inner = _innermost(open_spans)
        name = inner.name if inner is not None else NO_SPAN
        idle_spans[name] = idle_spans.get(name, 0.0) + (gap[1] - gap[0]) / 1e9
        if not is_layer(None if inner is None else inner.name):
            unexplained.append(gap)
    host_ops = [e for e in host if e.name != CALL
                and not e.name.startswith("ProfilerStep")
                and not (e.annotation and e.name.startswith(program))]
    return {"calls": len(calls), "span_device_s": span_device,
            "idle_s": sum(idle_spans.values()), "idle_spans": idle_spans,
            "unattributed_s": sum(b - a for a, b in unexplained) / 1e9,
            "unattributed_ops": host_gaps(unexplained, host_ops)}


# -- the registry --------------------------------------------------------------


def read_registry(snapshot: dict, calls: int) -> dict:
    """The span calls' registry: ``span_s`` (each span's wall sum),
    ``span_count`` and ``work`` (the ``work.*`` counters), over ``calls``
    calls."""
    hist = snapshot.get("histograms", {})
    return {"calls": calls,
            "span_s": {k[len("span."):]: v.get("sum", 0.0)
                       for k, v in hist.items() if k.startswith("span.")},
            "span_count": {k[len("span."):]: v.get("count", 0)
                           for k, v in hist.items() if k.startswith("span.")},
            "work": {k: v for k, v in snapshot.get("counters", {}).items()
                     if k.startswith("work.")}}


def on_cost(walls: list, panels: list, window_calls: list):
    """Median over the span calls of each call's wall over the median wall
    of the window's unprofiled calls on its panel, minus 1."""
    ratios = []
    for wall, p in zip(walls, panels):
        ref = [c["wall"] for c in window_calls
               if c["panel"] == p and not c.get("profiled")]
        if ref:
            ratios.append(wall / statistics.median(ref) - 1.0)
    return statistics.median(ratios) if ratios else None


# -- the calls -----------------------------------------------------------------


def _timed_call(window, i: int) -> tuple:
    t0 = time.perf_counter()
    _, p = drive.call_once(window.cell, window.panels, i, window.device, {})
    drive.sync(window.device)
    return time.perf_counter() - t0, p


def _plane_on_call(window, i: int) -> tuple:
    """Call ``i`` with the plane on -> ``(wall, panel, registry
    snapshot)``."""
    from spark_timeseries_tpu_torch import obs
    obs.enable(profile=False)
    try:
        wall, p = _timed_call(window, i)
        return wall, p, obs.snapshot()
    finally:
        obs.disable()


def span_calls(window, n: int = SPAN_CALLS) -> dict:
    """``n`` calls with the plane on, no profiler, each beside a call with
    the plane off on its panel -> the registry's readings summed over the
    plane-on calls, their walls and panels, and the plane-off walls."""
    walls, panels, off = [], [], []
    total = {"calls": n, "span_s": {}, "span_count": {}, "work": {}}
    for i in range(n):
        if i % 2:
            wall, p, snap = _plane_on_call(window, i)
            off.append(_timed_call(window, i)[0])
        else:
            off.append(_timed_call(window, i)[0])
            wall, p, snap = _plane_on_call(window, i)
        walls.append(wall)
        panels.append(p)
        for key, vals in read_registry(snap, 1).items():
            if key != "calls":
                for k, v in vals.items():
                    total[key][k] = total[key].get(k, 0) + v
    total.update(walls=walls, panels=panels, off_walls=off)
    return total


def traced_set(window, calls: int = drive.TRACE_CALLS):
    """The profiler's warm-up call and ``calls`` recorded calls, each in a
    ``bench.call`` range, with the plane on and mirrored into the
    profiler -> the profiler's events (``raw_events``)."""
    from torch.profiler import record_function

    from spark_timeseries_tpu_torch import obs
    obs.enable(profile=True)
    try:
        prof = tracemod.start(active=calls, warmup=1)
        try:
            for i in range(calls + 1):
                with record_function(CALL):
                    drive.call_once(window.cell, window.panels, i,
                                    window.device, {})
                    drive.sync(window.device)
                prof.step()
        finally:
            tracemod.stop(prof)
    finally:
        obs.disable()
    return raw_events(prof)


def _find_window(run):
    """The window of the run being read: a local of the caller that built
    ``run`` (``runner.run_cell``)."""
    f = sys._getframe(1)
    while f is not None:
        window = f.f_locals.get("window")
        if f.f_locals.get("run") is run and isinstance(window, drive.Window):
            return window
        f = f.f_back
    return None


def collect(run, window=None) -> dict:
    """Both readings of ``run`` (made on the first call, then kept):
    ``{"calls": span calls' readings, "trace": traced set's readings or
    None}``, or ``None`` where the run's window cannot be found."""
    got = getattr(run, "_program_spans", False)
    if got is not False:
        return got
    window = window if window is not None else _find_window(run)
    if window is None:
        run._program_spans = None
        return None
    t0 = time.perf_counter()
    gc.collect()  # the trace's events, read before: not the calls' garbage
    calls = span_calls(window)
    events = traced_set(window)
    tr = read_trace(events, prefixes()) if events else None
    run._program_spans = {"calls": calls, "trace": tr}
    _report(run._program_spans, run.calls, time.perf_counter() - t0)
    return run._program_spans


def _top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def _report(got: dict, window_calls: list, spent: float) -> None:
    c = got["calls"]
    paired = [on / off - 1.0 for on, off in zip(c["walls"], c["off_walls"])]
    log("spans = " + repr({
        "calls": c["calls"], "median_wall_s": statistics.median(c["walls"]),
        "on_cost": on_cost(c["walls"], c["panels"], window_calls),
        "on_cost_paired": statistics.median(paired)}))
    log(f"span calls' walls (s): {c['walls']}; panels {c['panels']}; "
        f"beside them with the plane off: {c['off_walls']}")
    log(f"span calls' span sums (s): {c['span_s']}")
    log(f"span calls' span counts: {c['span_count']}")
    log(f"span calls' work counters: {c['work']}")
    tr = got["trace"]
    if tr is not None:
        log(f"traced set: {tr['calls']} calls, device idle {tr['idle_s']} s, "
            f"unexplained {tr['unattributed_s']} s")
        log(f"idle_spans = {_top(tr['idle_spans'])}")
        log(f"unexplained idle by host operation = "
            f"{_top(tr['unattributed_ops'])}")
        log(f"span device time (s) = {_top(tr['span_device_s'], 40)}")
    log(f"span readings took {spent:.3f} s")
