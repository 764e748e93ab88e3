"""The readers of the program's own spans and counters (``benchlib.spans``
and the metrics that read it): each reader on a synthetic ``Run``, the
trace readers on synthetic profiler events, the span calls on a small
CPU window, and a run without the trace that never turns the plane on."""

import collections
import statistics
import time

import pytest
import torch

import _tiny
from benchlib import drive, runner, spans, spec
from benchlib import trace as tracemod

CELL = spec.Cell("arima111_daily_1m.fit")
GARCH = spec.Cell("garch11_vol_100k.pipeline")
NEW = ("host_read_wait_ms", "optimizer_host_ms", "straggler_ms",
       "live_row_share", "objective_row_steps", "prep_device_ms",
       "unattributed_idle_share")


def _read(name, run, cell=CELL):
    return cell.metric_reader(name).read(run)


def _run(got=False):
    run = runner.Run([{"wall": 0.5, "panel": 0}], 1.0, 100, 1.0, 1, None)
    if got is not False:
        run._program_spans = got
    return run


READINGS = {
    "calls": {"calls": 4, "walls": [0.5] * 4, "panels": [0, 1, 0, 1],
              "span_s": {"optim.minimize": 1.6, "optim.host_read": 0.4,
                         "optim.compact": 0.04, "optim.stragglers": 0.76,
                         "fit.garch": 2.0},
              "span_count": {},
              "work": {"work.row_evals": 1000, "work.live_row_evals": 250,
                       "work.objective_row_steps": 8e9}},
    "trace": {"calls": 4, "idle_s": 0.8, "unattributed_s": 0.02,
              "span_device_s": {"fit.prep": 0.12, "transforms.autocorr":
                                0.004, "transforms.fill_chain": 0.008},
              "idle_spans": {}, "unattributed_ops": {}},
}


def test_readers_read_the_readings():
    run = _run(READINGS)
    assert _read("host_read_wait_ms", run) == pytest.approx(100.0)
    assert _read("optimizer_host_ms", run) == pytest.approx(300.0)
    assert _read("straggler_ms", run) == pytest.approx(200.0)
    assert _read("live_row_share", run) == pytest.approx(0.25)
    assert _read("objective_row_steps", run) == pytest.approx(2e9)
    assert _read("prep_device_ms", run) == pytest.approx(30.0)
    assert _read("unattributed_idle_share", run) == pytest.approx(0.025)
    assert _read("transforms_device_ms.vol", run, GARCH) == \
        pytest.approx(3.0)
    # the .vol entries read with the same files
    assert _read("straggler_ms.vol", run, GARCH) == pytest.approx(200.0)


def test_no_straggler_stage_reads_zero():
    got = {"calls": dict(READINGS["calls"], span_s={"optim.minimize": 1.0}),
           "trace": None}
    assert _read("straggler_ms", _run(got)) == 0.0
    assert _read("host_read_wait_ms", _run(got)) is None


@pytest.mark.parametrize("name", NEW + ("transforms_device_ms.vol",))
def test_readers_return_none_without_their_data(name):
    # no window found, and a program without spans or counters
    assert _read(name, _run(None), GARCH) is None
    bare = {"calls": {"calls": 4, "walls": [], "panels": [], "span_s": {},
                      "span_count": {}, "work": {}}, "trace": None}
    assert _read(name, _run(bare), GARCH) is None


E = spans.Event


def _events(program=True):
    """One call of 0..100 (ns) on the host: the entry span over 0..95,
    ``fit.prep`` 5..30 (an op launching a 10..20 kernel), the optimizer
    40..90 with a read 60..80 inside (an op launching a 62..70 kernel);
    without ``program`` only the call, the ops and the kernels."""
    ev = [E("ProfilerStep#1", False, True, 0, 100, 1, 0),
          E(spans.CALL, False, True, 0, 100, 2, 0),
          E("aten::mul", False, False, 6, 9, 5, 0),
          E("mul_kernel", True, False, 10, 20, 900, 5),
          E("aten::item", False, False, 61, 79, 7, 0),
          E("reduce_kernel", True, False, 62, 70, 901, 7),
          E("cudaStreamSynchronize", False, False, 71, 79, 8, 0),
          E("fit.prep", True, True, 10, 20, 4, 0)]  # device-side copy
    if program:
        ev += [E("fit.garch", False, True, 1, 95, 3, 0),
               E("fit.prep", False, True, 5, 30, 4, 0),
               E("optim.minimize", False, True, 40, 90, 6, 0),
               E("optim.host_read", False, True, 60, 80, 9, 0)]
    return ev


def test_read_trace_on_synthetic_events():
    got = spans.read_trace(_events(), ("fit.", "optim."))
    assert got["calls"] == 1
    assert got["span_device_s"] == pytest.approx(
        {"fit.garch": 18e-9, "fit.prep": 10e-9, "optim.minimize": 8e-9,
         "optim.host_read": 8e-9})
    # idle: 0..10 (mid 5: fit.prep opens at 5), 20..62 (mid 41: the
    # optimizer), 70..100 (mid 85: the optimizer)
    assert got["idle_spans"] == pytest.approx(
        {"fit.prep": 10e-9, "optim.minimize": 72e-9})
    assert got["idle_s"] == pytest.approx(82e-9)
    assert got["unattributed_s"] == 0.0
    # a program without spans: nothing to read
    assert spans.read_trace(_events(False), ("fit.", "optim.")) is None


def test_unexplained_idle_and_its_host_operations():
    ev = [e for e in _events() if e.name != "optim.minimize"]
    got = spans.read_trace(ev, ("fit.", "optim."))
    # 20..62 and 70..100 fall under the entry span alone
    assert got["idle_spans"] == pytest.approx(
        {"fit.prep": 10e-9, "fit.garch": 72e-9})
    assert got["unattributed_s"] == pytest.approx(72e-9)
    # mid 41: no host operation; mid 85: none (the sync ended at 79)
    assert got["unattributed_ops"] == pytest.approx({"python": 72e-9})
    ev = [e._replace(end=90) if e.name == "cudaStreamSynchronize" else e
          for e in ev]
    got = spans.read_trace(ev, ("fit.", "optim."))
    assert got["unattributed_ops"] == pytest.approx(
        {"python": 42e-9, "cudaStreamSynchronize": 30e-9})


class _FunctionEvent:
    """The parts of a ``torch.profiler`` event ``trace.summarize`` reads."""

    def __init__(self, e):
        self.name = e.name
        self.device_type = (torch.autograd.DeviceType.CUDA if e.device
                            else torch.autograd.DeviceType.CPU)
        self.is_user_annotation = e.annotation
        self.time_range = collections.namedtuple("R", "start end")(
            e.start / 1e3, e.end / 1e3)


class _Prof:
    def __init__(self, events):
        self._events = [_FunctionEvent(e) for e in events]

    def events(self):
        return self._events


def test_host_gaps_read_as_idle_gaps_do_with_program_ranges_present():
    without = [e for e in _events(False) if e.name != spans.CALL]
    parent = tracemod.summarize(_Prof(without), 1.0, 1)["idle_gaps"]
    busy = spans.merged([(e.start, e.end) for e in without
                         if e.device and not e.annotation])
    between = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    host = [e for e in _events() if not e.device and e.name != spans.CALL
            and not e.name.startswith("ProfilerStep")
            and not e.name.startswith(spans.prefixes())]
    got = spans.host_gaps(between, host)
    assert got.keys() == parent.keys()
    for k in got:
        assert got[k] == pytest.approx(parent[k])


def test_span_names_file():
    assert set(spans.prefixes()) >= {"fit.", "optim.", "transforms."}
    assert spans.is_layer("optim.host_read") and spans.is_layer("fit.prep")
    assert not spans.is_layer("fit.garch") and not spans.is_layer(None)


def test_on_cost_compares_panel_by_panel():
    window = [{"wall": 1.0, "panel": 0}, {"wall": 3.0, "panel": 1},
              {"wall": 9.0, "panel": 1, "profiled": True}]
    got = spans.on_cost([1.01, 3.06, 1.02], [0, 1, 0], window)
    assert got == pytest.approx(statistics.median([0.01, 0.02, 0.02]))
    assert spans.on_cost([1.0], [2], window) is None


def _small(name="arima111_daily_1m.fit"):
    c = _tiny.cell(name)
    c.config["rows"], c.config["time"] = 48, 200
    return c


def test_span_calls_on_a_cpu_window():
    from spark_timeseries_tpu_torch import obs
    cell = _small()
    panels = cell.make_panels(2 ** 31 + 5, _tiny.cpu())
    window = drive.Window(cell, panels, _tiny.cpu(), 0.05, 2 ** 31 + 5)
    window.run(drive.Counters())
    run = runner.Run(window.calls, window.elapsed, 48, 1.0, 0, None)
    got = spans.collect(run, window)
    assert not obs.enabled()
    c = got["calls"]
    assert c["calls"] == spans.SPAN_CALLS and c["panels"] == [0, 1, 0, 1]
    assert c["span_count"]["fit.arima"] == spans.SPAN_CALLS
    assert c["work"]["work.row_evals"] >= c["work"]["work.live_row_evals"]
    assert got["trace"] is None  # no device operations on the CPU
    assert spans.collect(run) is got  # read once a run
    assert _read("live_row_share", run) is not None


def test_untraced_run_turns_nothing_on(monkeypatch):
    from spark_timeseries_tpu_torch import obs

    def refuse(*a, **k):
        raise AssertionError("a run without the trace made span calls")

    monkeypatch.setattr(spans, "span_calls", refuse)
    monkeypatch.setattr(spans, "traced_set", refuse)
    out = runner.run_cell(_small(), 2 ** 31 + 6, 0.05, False, _tiny.cpu(),
                          time.perf_counter())
    assert not obs.enabled()
    assert not set(out["metrics"]) & set(NEW)
