"""Drive the program as a traffic mix says.

A mix's ``stages`` are calls into the program (or ``torch``), each named by
its dotted path below ``spark_timeseries_tpu_torch`` (or ``torch.``), or by
``"entry"``: an entry of the configuration's ``entries``.  Arguments that
start with ``@`` are looked up: ``@panel``, ``@device``, ``@config.<key>``
or an earlier stage's ``out``.  ``apply`` calls the result again with
those arguments; ``pick`` takes one item of it.  A stage with a ``span``
is timed, with a synchronize at each end, when spans are asked for.
"""

import importlib
import random
import time

import torch

PROGRAM = "spark_timeseries_tpu_torch"
SAMPLE_CALLS = 2  # calls of a window whose answers are judged
TRACE_CALLS = 4  # calls the profiler records, after one warm-up call


def resolve_call(dotted: str):
    if dotted.startswith("torch."):
        obj = torch
        for part in dotted.split(".")[1:]:
            obj = getattr(obj, part)
        return obj
    parts = dotted.split(".")
    for cut in range(len(parts) - 1, 0, -1):
        try:
            obj = importlib.import_module(
                ".".join([PROGRAM] + parts[:cut]))
        except ModuleNotFoundError:
            continue
        for part in parts[cut:]:
            obj = getattr(obj, part)
        return obj
    raise ValueError(f"cannot resolve {dotted!r}")


def value(x, env: dict):
    if isinstance(x, str) and x.startswith("@"):
        key = x[1:]
        if key.startswith("config."):
            return env["config"][key[len("config."):]]
        return env[key]
    if isinstance(x, list):
        return [value(v, env) for v in x]
    if isinstance(x, dict):
        return {k: value(v, env) for k, v in x.items()}
    return x


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_stages(stages: list, env: dict, spans=None) -> dict:
    """Run every stage into ``env``; with a ``spans`` dict, add the wall
    of each stage that names a span to it."""
    device = env["device"]
    for st in stages:
        if "entry" in st:
            ent = env["config"]["entries"][st["entry"]]
            fn = resolve_call(ent["call"])
            args = value(st.get("args", []), env) + list(ent.get("args", []))
            kwargs = {**ent.get("kwargs", {}),
                      **value(st.get("kwargs", {}), env)}
        else:
            fn = resolve_call(st["call"])
            args = value(st.get("args", []), env)
            kwargs = value(st.get("kwargs", {}), env)
        timed = spans is not None and "span" in st
        if timed:
            sync(device)
            t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if "apply" in st:
            out = out(*value(st["apply"], env))
        if "pick" in st:
            out = out[st["pick"]]
        if timed:
            sync(device)
            spans[st["span"]] = spans.get(st["span"], 0.0) + (
                time.perf_counter() - t0)
        env[st["out"]] = out
    return env


class Counters:
    """The program's own counters, read around each call."""

    def __init__(self):
        from spark_timeseries_tpu_torch.ops import cuda_kernels
        from spark_timeseries_tpu_torch.utils import optim
        self._ck, self._optim = cuda_kernels, optim

    def read(self) -> tuple:
        return sum(self._ck.LAUNCHES.values()), self._optim.host_reads.count


def call_once(cell, panels, i: int, device, spans=None) -> tuple:
    """Call ``i`` of the mix on panel ``i mod panels`` -> ``(kept outputs,
    panel index)``; the caller times it."""
    p = i % len(panels)
    env = {"panel": panels[p], "device": device, "config": cell.config}
    run_stages(cell.traffic["stages"], env, spans)
    return {k: env[k] for k in cell.traffic["keep"]}, p


def _status_counts(outs: dict) -> tuple:
    """(rows reported OK, rows) over the outputs that carry a status."""
    ok = rows = 0
    for o in outs.values():
        st = getattr(o, "status", None)
        if st is not None:
            ok += int((st == 0).sum())
            rows += st.numel()
    return ok, rows


def device_bytes(obj) -> int:
    """Bytes of the distinct CUDA storages that ``obj`` (tensors, and
    tuples, lists or dicts of them) holds."""
    seen = {}

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                st = x.untyped_storage()
                seen[st.data_ptr()] = st.nbytes()
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)

    walk(obj)
    return sum(seen.values())


def _iters_mean(outs: dict):
    vals = [float(o.iters.double().mean()) for o in outs.values()
            if hasattr(o, "iters")]
    return sum(vals) / len(vals) if vals else None


class Window:
    """The measured window: closed-loop calls until ``seconds`` have
    passed, each call's wall, counters, status counts and device memory
    peak (reset before the call; ``held``: the bytes of the sample that
    the benchmark holds meanwhile), and a reservoir of ``SAMPLE_CALLS``
    calls drawn from the seed whose outputs are judged after the
    window.  Traced, the profiler runs over the first ``TRACE_CALLS`` + 1
    calls (``profiled``) and records all but the first."""

    def __init__(self, cell, panels, device, seconds: float, seed: int,
                 trace: bool = False):
        self.cell, self.panels, self.device = cell, panels, device
        self.seconds, self.trace = float(seconds), trace
        self.rng = random.Random(f"sample:{int(seed)}")
        self.k = SAMPLE_CALLS
        self.sample = []  # [(call index, panel index, outputs)]
        self.calls = []
        self.elapsed = 0.0
        self.trace_calls = TRACE_CALLS
        self.prof = None
        self.traced = False
        self.traced_calls = 0
        self.trace_window_s = None

    def _keep(self, i: int, p: int, outs: dict) -> None:
        if len(self.sample) < self.k:
            self.sample.append((i, p, outs))
            return
        j = self.rng.randrange(i + 1)
        if j < self.k:
            self.sample[j] = (i, p, outs)

    def run(self, counters) -> None:
        from . import trace as tracemod
        i = 0
        t_start = time.perf_counter()
        if self.trace:  # call 0 warms the profiler up; it records 1..N
            self.prof = tracemod.start(active=self.trace_calls, warmup=1)
        cuda = torch.device(self.device).type == "cuda"
        held = 0
        while True:
            spans = {} if self.trace else None
            launches0, reads0 = counters.read()
            if cuda:
                torch.cuda.reset_peak_memory_stats(self.device)
            t0 = time.perf_counter()
            outs, p = call_once(self.cell, self.panels, i, self.device, spans)
            sync(self.device)
            t1 = time.perf_counter()
            launches1, reads1 = counters.read()
            ok_rows, fit_rows = _status_counts(outs)
            rec = {"wall": t1 - t0, "launches": launches1 - launches0,
                   "host_reads": reads1 - reads0, "panel": p,
                   "ok_rows": ok_rows, "fit_rows": fit_rows,
                   "peak": (torch.cuda.max_memory_allocated(self.device)
                            if cuda else 0), "held": held,
                   "profiled": self.trace and not self.traced}
            if self.trace:
                rec["spans"] = spans
                rec["iters_mean"] = _iters_mean(outs)
            self.calls.append(rec)
            self._keep(i, p, outs)
            del outs
            if cuda:
                held = device_bytes([o for _, _, o in self.sample])
            i += 1
            done = t1 - t_start >= self.seconds
            if self.trace and not self.traced:
                if i == self.trace_calls + 1 or (done and i > 1):
                    sync(self.device)
                    self.trace_window_s = time.perf_counter() - t_trace
                    self.traced_calls = i - 1
                    self.traced = True
                self.prof.step()
                if i == 1:  # the warm-up step is over: recording starts
                    t_trace = time.perf_counter()
                if self.traced:
                    tracemod.stop(self.prof)
                elif done:  # the window closed in the warm-up step
                    tracemod.stop(self.prof)
                    self.trace_window_s, self.traced = 0.0, True
            if done:
                self.elapsed = t1 - t_start
                return
