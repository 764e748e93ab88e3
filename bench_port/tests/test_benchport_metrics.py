"""The metric arithmetic: the rate over the whole window, the 95th
percentile over every call, the idle share, the port's kernels by name,
and how the numbers decide ``correct``."""

import math
import statistics

import pytest

from benchlib import runner, spec

CELL = spec.Cell("arima111_daily_1m.fit")


def _read(name, run):
    return CELL.metric_reader(name).read(run)


def _run(walls, elapsed, trace=None, profiled=0, **extra):
    calls = [dict({"wall": w, "launches": 30, "host_reads": 12,
                   "ok_rows": 90, "fit_rows": 100, "profiled": i < profiled},
                  **extra) for i, w in enumerate(walls)]
    return runner.Run(calls, elapsed, 1000, 12.5, 3 * 2 ** 30, trace)


def test_rate_is_over_the_whole_window():
    run = _run([0.1, 0.2, 0.3], elapsed=0.75)
    assert _read("series_per_s", run) == pytest.approx(3 * 1000 / 0.75)


def test_p95_is_over_every_call():
    walls = [0.1 + 0.001 * i for i in range(100)] + [5.0]
    run = _run(walls, elapsed=sum(walls))
    want = statistics.quantiles(walls, n=20, method="inclusive")[18]
    assert _read("call_p95_s", run) == pytest.approx(want)
    assert _read("call_p95_s", _run([0.4], 0.4)) == 0.4


def test_counters_shares_and_memory():
    run = _run([0.1, 0.1], 0.2)
    assert _read("launches_per_call", run) == 30
    assert _read("host_reads_per_call", run) == 12
    assert _read("converged_share", run) == pytest.approx(0.9)
    assert _read("peak_device_gib", run) == pytest.approx(3.0)
    assert _read("setup_s", run) == 12.5


def test_idle_share_and_kernel_split():
    trace = {"busy_s": 0.3, "window_s": 0.4, "calls": 2, "device_ops": {
        "void (anonymous namespace)::css_fwd_reg<1, 1>(float const*, int)":
            0.05,
        "hr_moments_k(float const*)": 0.01,
        "_ZN12_GLOBAL__N_111css_bwd_regILi1ELi1EEEvPKf": 0.02,
        "void at::native::vectorized_elementwise_kernel<4, "
        "at::native::FillFunctor<float>>(int)": 0.2,
        "Memcpy DtoH (Device -> Pinned)": 0.02}}
    # two profiled calls (slowed to 0.2 s) and untraced calls of 0.16 s
    # median: the busy 0.15 s a call is held against 0.16 s
    run = _run([0.2, 0.2, 0.15, 0.16, 0.5], 0.4, trace, profiled=2)
    assert _read("device_idle_share", run) == pytest.approx(1 - 0.15 / 0.16)
    assert _read("objective_kernel_ms", run) == pytest.approx(40.0)
    assert _read("glue_device_ms", run) == pytest.approx(110.0)
    # a window that the profiler covered whole: the traced wall
    run = _run([0.2, 0.2], 0.4, trace, profiled=2)
    assert _read("device_idle_share", run) == pytest.approx(0.25)


def test_untraced_run_reads_nothing_from_the_trace():
    run = _run([0.1], 0.1)
    for name in ("device_idle_share", "objective_kernel_ms",
                 "glue_device_ms", "lbfgs_iters_mean"):
        assert _read(name, run) is None
    run = _run([0.1, 0.3], 0.4, spans={"transforms": 0.01}, iters_mean=7.0)
    assert _read("lbfgs_iters_mean", run) == 7.0
    reader = spec.Cell("garch11_vol_100k.pipeline").metric_reader
    assert reader("transforms_ms.vol").read(run) == pytest.approx(10.0)


def test_decide():
    ok, checks = runner.decide({"a": 1e-6, "b": 0.0}, {"a": 1e-4, "b": 0})
    assert ok and checks["a"] == {"value": 1e-6, "limit": 1e-4}
    assert not runner.decide({"a": 1e-3, "b": 0.0}, {"a": 1e-4, "b": 0})[0]
    assert not runner.decide({"a": math.inf}, {"a": 1e-4})[0]
    assert not runner.decide({}, {"a": 1e-4})[0]
    assert not runner.decide({"a": 0.0}, {})[0]


@pytest.mark.card
def test_device_bytes_counts_storages_once():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from benchlib import drive
    a = torch.zeros(256, 1024, device="cuda")
    b = torch.zeros(1024, device="cuda")
    outs = {"x": (a, a[:10]), "y": [b], "z": torch.zeros(3)}
    assert drive.device_bytes(outs) == a.nbytes + b.nbytes
