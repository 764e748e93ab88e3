"""One run of one cell: set-up, the measured window, the judgement of the
sampled outputs against the plain reference, and the metrics."""

import math
import sys
import time

import torch

from . import drive
from . import trace as tracemod

FORBIDDEN = ("jax", "jaxlib", "flax", "spark_timeseries_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that the run must not load,
    compared whole (``spark_timeseries_tpu_torch`` is not
    ``spark_timeseries_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Run:
    """What the metric readers read: the window's calls (``wall``,
    ``launches``, ``host_reads``, ``ok_rows``, ``fit_rows``, ``profiled``
    and, traced, ``spans`` and ``iters_mean``), its elapsed seconds, the
    rows a call, the set-up seconds, the program's memory peak in the
    window (``program_peak``) and, traced, the trace summary
    (``benchlib.trace.summarize``)."""

    def __init__(self, calls, elapsed, rows, setup_s, program_peak, trace):
        self.calls, self.elapsed, self.rows = calls, elapsed, rows
        self.setup_s, self.program_peak = setup_s, program_peak
        self.trace = trace


def warm(cell, panels, device) -> None:
    """One call on each panel: every shape and kernel the window uses."""
    for i in range(len(panels)):
        drive.call_once(cell, panels, i, device)
    drive.sync(device)


def judge(cell, window) -> dict:
    """Every sampled call's outputs against the reference; each number is
    the worst over the sample."""
    fn = cell.reference_fn("judge")
    worst = {}
    for _, p, outs in window.sample:
        for k, v in fn(cell.config, window.panels[p], outs).items():
            v = float(v)
            if math.isnan(v):
                v = math.inf
            worst[k] = max(worst.get(k, -math.inf), v)
    return worst


def decide(numbers: dict, limits: dict) -> tuple:
    """-> (correct, {name: {"value", "limit"}}): each number at or under
    its limit, and every limit read."""
    checks = {}
    ok = bool(limits)
    for name, limit in limits.items():
        v = numbers.get(name, math.inf)
        checks[name] = {"value": v, "limit": limit}
        ok = ok and v <= limit
    for name, v in numbers.items():
        if name not in checks:
            checks[name] = {"value": v, "limit": None}
    return ok, checks


def metrics(cell, run: Run, trace: bool) -> dict:
    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cell.metric_reader(m["name"]).read(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def device_info(device, peak_bytes: int, summary=None) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1, "memory_peak_bytes": int(peak_bytes)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": int(peak_bytes)}
    if summary is not None:
        info["busy_s"] = summary["busy_s"]
        info["window_s"] = summary["window_s"]
    return info


def free_memory(device) -> None:
    import gc
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_process: float) -> dict:
    """The whole run after the card check -> the result object (without
    the forbidden-module check, which the caller makes last)."""
    dev = torch.device(device)
    t0 = time.perf_counter()
    panels = cell.make_panels(seed, dev)
    drive.sync(dev)
    t1 = time.perf_counter()
    warm(cell, panels, dev)
    log(f"panels {t1 - t0:.3f} s, warm calls {time.perf_counter() - t1:.3f} s")
    if trace:  # the profiler's first start-up stays out of the window
        prof = tracemod.start()
        drive.call_once(cell, panels, 0, dev)
        drive.sync(dev)
        prof.step()
        tracemod.stop(prof)
        del prof
    counters = drive.Counters()
    window = drive.Window(cell, panels, dev, seconds, seed, trace)
    setup_s = time.perf_counter() - t_process
    log(f"set-up {setup_s:.3f} s (panels {len(panels)}, warm calls done)")
    window.run(counters)
    log(f"window {window.elapsed:.3f} s, {len(window.calls)} calls")
    walls = sorted(c["wall"] for c in window.calls)
    log("call walls (s): min {:.4f} median {:.4f} max {:.4f}; by panel "
        "{}".format(walls[0], walls[len(walls) // 2], walls[-1], [
            round(sorted(c["wall"] for c in window.calls
                         if c["panel"] == k)[0], 4)
            for k in range(len(panels)) if any(
                c["panel"] == k for c in window.calls)]))
    if trace:
        log("traced calls' walls (s): " + ", ".join(
            f"{c['wall']:.4f}" for c in window.calls[:window.traced_calls + 1]))
    # the device's peak, and the program's: without the sampled answers
    # that the benchmark held on the device during the call
    peak = max(c["peak"] for c in window.calls)
    program_peak = max(c["peak"] - c["held"] for c in window.calls)
    log(f"memory peak {peak} bytes, the program's {program_peak} (the "
        f"sample held: up to {max(c['held'] for c in window.calls)})")
    summary = None
    if trace:
        t0 = time.perf_counter()
        summary = tracemod.summarize(window.prof, window.trace_window_s,
                                     window.traced_calls)
        window.prof = None
        log(f"trace of {window.traced_calls} calls read in "
            f"{time.perf_counter() - t0:.3f} s")
    run = Run(window.calls, window.elapsed, int(cell.config["rows"]),
              setup_s, program_peak, summary)
    result_metrics = metrics(cell, run, trace)
    free_memory(dev)
    t0 = time.perf_counter()
    numbers = judge(cell, window)
    log(f"judged {len(window.sample)} sampled calls in "
        f"{time.perf_counter() - t0:.3f} s")
    correct, checks = decide(numbers, cell.limits)
    out = {"correct": correct, "attempted": len(window.calls), "failed": 0,
           "metrics": result_metrics,
           "device": device_info(dev, peak, summary)}
    if summary is not None:
        out["breakdown"] = {"device_ops": tracemod.top(summary["device_ops"]),
                            "idle_gaps": tracemod.top(summary["idle_gaps"])}
    out["checks"] = checks
    return out
