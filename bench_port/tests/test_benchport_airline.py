"""The airline cell (``airline_hourly_1m.fit``): its plain reference
against a scalar loop, its generator, the readers of the CSS lag route
and the seasonal expansion, and whole runs of the cell cut to a size a
CPU test holds (a sound run is correct; faults planted in the program and
the bfloat16 control are not).  Its short run on the card is marked
``card``."""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

import calibrate
from benchlib import drive, runner, spec
from reference import sarima

NAME = "airline_hourly_1m.fit"
CELL = spec.Cell(NAME)
F64 = torch.float64
BENCH = Path(__file__).resolve().parent.parent


def _tiny():
    c = spec.Cell(NAME)
    c.config["rows"], c.config["time"] = 64, 240
    return c


# -- the reference ------------------------------------------------------------


def test_sarima_css_matches_loop():
    # the airline model at s = 4 on a row with a NaN head, by hand
    s, lead = 4, 3
    g = torch.Generator().manual_seed(4)
    y = torch.randn(40, generator=g, dtype=F64).cumsum(0)
    y[:lead] = float("nan")
    th, sth = -0.4, -0.56
    x = [float(v) for v in y[lead:]]
    d = [x[t + 1] - x[t] for t in range(len(x) - 1)]
    w = [d[t + s] - d[t] for t in range(len(d) - s)]
    e, css = [], 0.0
    for t, v in enumerate(w):
        lag = lambda j: e[t - j] if t - j >= 0 else 0.0  # noqa: E731
        e.append(v - th * lag(1) - sth * lag(s) - th * sth * lag(s + 1))
        css += e[-1] ** 2
    n = len(w)
    want = 0.5 * n * (math.log(2 * math.pi * css / n) + 1)
    prep = sarima.Prepared(y[None], F64, F64, s)
    assert bool(prep.eligible[0]) and int(prep.n[0]) == n == 40 - lead - 5
    f = prep.objective(prep.eligible)
    got = f(torch.tensor([[[th, sth]]], dtype=F64))[0, 0]
    assert math.isclose(float(got), want, rel_tol=1e-12)
    # at the gate, and one observation short of it
    at = y[None, :lead + sarima.min_diffs(s) + s + 1]
    assert bool(sarima.Prepared(at, F64, F64, s).eligible[0])
    assert not bool(sarima.Prepared(at[:, :-1], F64, F64, s).eligible[0])


# -- the generator ------------------------------------------------------------


def test_generator_is_seeded_and_shaped():
    cfg = dict(CELL.config, rows=2000)
    seed = 2 ** 31 + 7
    a = CELL.generator.make(cfg, seed, torch.device("cpu"))
    b = CELL.generator.make(cfg, seed, torch.device("cpu"))
    c = CELL.generator.make(cfg, seed + 1, torch.device("cpu"))
    assert a.shape == (2000, cfg["time"]) and a.dtype == torch.float32
    assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
    assert not torch.equal(torch.nan_to_num(a), torch.nan_to_num(c))
    share = float(torch.isnan(a).float().mean())
    assert math.isclose(share, cfg["nan_share"], abs_tol=0.012), share
    # the same lengths every seed, dealt in another order
    na, nc = (~torch.isnan(a)).sum(1), (~torch.isnan(c)).sum(1)
    assert torch.equal(na.sort().values, nc.sort().values)
    assert not torch.equal(na, nc)
    # NaN heads only: each row valid from its first observation on
    first = cfg["time"] - na
    t = torch.arange(cfg["time"])
    assert torch.equal(~torch.isnan(a), t[None] >= first[:, None])


def test_generator_draws_the_airline_process():
    # the airline differencing of the last 700 hours leaves the expanded
    # MA(25): variance (1 + theta^2)(1 + Theta^2) sigma^2, and the
    # autocorrelations theta / (1 + theta^2) at lag 1 and
    # Theta / (1 + Theta^2) at lag 24
    cfg = dict(CELL.config, rows=500)
    g = cfg["generating"]
    th, sth = g["theta"], g["Theta"]
    y = CELL.generator.make(cfg, 1, torch.device("cpu"))[:, -700:].double()
    d = y[:, 1:] - y[:, :-1]
    w = d[:, 24:] - d[:, :-24]
    var = (1 + th ** 2) * (1 + sth ** 2) * g["sigma"] ** 2
    assert math.isclose(float(w.var()), var, rel_tol=0.02)
    for lag, want in ((1, th / (1 + th ** 2)), (24, sth / (1 + sth ** 2))):
        r = float((w[:, lag:] * w[:, :-lag]).mean() / w.var())
        assert math.isclose(r, want, abs_tol=0.01), lag


# -- the readers -------------------------------------------------------------

LAG_BYTES = spec.load_module(BENCH / "metrics" / "_lag_bytes.py",
                             "t_lag_bytes")
T_AIR, B_AIR = 935, 1_000_000  # the doubly differenced hourly panel
LAG_READERS = ("lag_kernel_ms", "lag_roofline_share", "lag_route_share",
               "seasonal_expand_ms")


def _read(name, run):
    return CELL.metric_reader(name).read(run)


def _run(calls, trace=None, readings=None):
    run = runner.Run([{"wall": 0.5, "panel": i % 2, "launches": 30,
                       "host_reads": 12, "ok_rows": 9, "fit_rows": 10,
                       "profiled": trace is not None}
                      for i in range(calls)], 0.5 * calls, 1000, 10.0, 1,
                     trace)
    if readings is not None:  # as benchlib.spans.collect keeps them
        run._program_spans = readings
    return run


def _readings(work: dict, span_s: dict, calls: int = 4) -> dict:
    return {"calls": {"calls": calls, "span_s": span_s, "span_count": {},
                      "work": work}, "trace": None}


def _lag_work(kind: str, launches: int = 1) -> dict:
    """The counters of ``launches`` lag-route launches of ``kind`` at
    [935, 1M] with the airline support (MA lags 1, 24, 25, no AR lag), as
    ``ops.cuda_kernels`` counts them."""
    n = launches * T_AIR * B_AIR
    steps = {"bwd": n, "bwd_e": n} if kind == "bwd" else {kind: n}
    work = {"work.css_launches": launches, "work.css_lag_launches": launches,
            "work.css_lag_row_floats": 2 * launches * B_AIR,
            "work.css_lag_coef_floats":
                (8 if kind == "bwd" else 4) * launches * B_AIR}
    work.update({"work.css_lag_row_steps." + k: v for k, v in steps.items()})
    return work


def test_lag_bytes_at_the_airline_shape():
    # PERF.md's kernel table, rows 1-2: the lag route's bounds at 3.35 TB/s
    for kind, ms in (("sum", 1.124), ("both", 2.240), ("bwd", 1.128)):
        assert round(LAG_BYTES.floor_ms(_lag_work(kind)), 3) == ms
    assert LAG_BYTES.floor_ms({"work.css_launches": 3}) is None


def test_lag_readers_return_none_without_their_data():
    ops = {"void (anonymous namespace)::css_fwd_reg<1, 1>(float const*)": 0.1}
    trace = {"busy_s": 0.3, "window_s": 0.4, "calls": 2, "device_ops": ops}
    # a program without the counters or the span (the parent's): spans,
    # counters of other layers, the register route's kernels only
    parent = _run(2, trace, _readings(
        {"work.objective_row_steps": 10, "work.row_evals": 5},
        {"fit.arima": 1.0, "optim.minimize": 0.5}))
    bare = _run(1)  # no trace, and no window to read spans from
    for name in LAG_READERS:
        assert _read(name, parent) is None, name
        assert _read(name, bare) is None, name


def test_lag_readers_and_the_share_at_the_bound():
    # four calls, each with one forward sum, one forward both and one
    # adjoint on the lag route and one register-route launch, whose lag
    # kernels take exactly the bound's time: the share reads 1
    calls = 4
    work = {}
    for kind in ("sum", "both", "bwd"):
        for k, v in _lag_work(kind, calls).items():
            work[k] = work.get(k, 0) + v
    work["work.css_launches"] += calls
    fwd_s = (LAG_BYTES.floor_ms(_lag_work("sum"))
             + LAG_BYTES.floor_ms(_lag_work("both"))) / 1e3
    bwd_s = LAG_BYTES.floor_ms(_lag_work("bwd")) / 1e3
    ops = {"void (anonymous namespace)::css_fwd_lag_k<0, 3>(float const*)":
           calls * fwd_s,
           "_ZN12_GLOBAL__N_113css_bwd_lag_kILi0ELi3ELb1EEEvPKf":
           calls * bwd_s,
           "void (anonymous namespace)::css_fwd_reg<1, 1>(float const*)": 1.0}
    trace = {"busy_s": 2.0, "window_s": 2.5, "calls": calls,
             "device_ops": ops}
    run = _run(calls, trace, _readings(work, {"fit.expand": 0.02}, calls))
    assert _read("lag_kernel_ms", run) == pytest.approx(
        1.124 + 2.240 + 1.128, abs=2e-3)
    share = _read("lag_roofline_share", run)
    assert share == pytest.approx(1.0) and share <= 1.0 + 1e-12
    assert _read("lag_route_share", run) == pytest.approx(0.75)
    assert _read("seasonal_expand_ms", run) == pytest.approx(5.0)
    # twice the time: half the share
    trace["device_ops"] = {k: 2 * v for k, v in ops.items()}
    assert _read("lag_roofline_share", run) == pytest.approx(0.5)


# -- whole runs on the CPU ----------------------------------------------------


def _whole(cell, seed=2 ** 31 + 3):
    return runner.run_cell(cell, seed, 0.5, False, torch.device("cpu"),
                           time.perf_counter())


def test_sound_run_judges():
    out = _whole(_tiny())
    assert list(out)[-1] == "checks"
    assert out["correct"], out["checks"]


def _swap_fit(cell, monkeypatch, fn):
    """Route the cell's fit entry to ``fn(real_fit)``."""
    real = drive.resolve_call(cell.config["entries"]["fit"]["call"])
    cell.config["entries"]["fit"] = dict(cell.config["entries"]["fit"],
                                         call="_fault.fit")
    resolve = drive.resolve_call
    monkeypatch.setattr(drive, "resolve_call", lambda dotted: fn(real)
                        if dotted == "_fault.fit" else resolve(dotted))


def _half(real):
    def fit(y, *args, **kwargs):
        n = y.shape[0] // 2
        res = real(y[:n], *args, **kwargs)

        def fill(x):
            rest = x.double().nanmean(0) if x.is_floating_point() else x[0]
            return torch.cat([x, rest.to(x.dtype).expand_as(
                x[:y.shape[0] - n])])

        return type(res)(*(fill(f) for f in res))
    return fit


def _swapped(real):
    def fit(y, *args, **kwargs):
        res = real(y, *args, **kwargs)
        p = res.params.clone()
        row = int(torch.isfinite(p).all(1).nonzero()[-1])
        p[row] = p[row].flip(0)  # theta and Theta swapped
        return res._replace(params=p)
    return fit


@pytest.mark.parametrize("fault", [_half, _swapped],
                         ids=["half the batch left out", "answer altered"])
def test_fault_in_the_program_is_not_correct(fault, monkeypatch):
    cell = _tiny()
    _swap_fit(cell, monkeypatch, fault)
    assert not _whole(cell)["correct"]


def test_bfloat16_control_fails_and_the_program_passes():
    cell = _tiny()
    nums = calibrate.control_numbers(cell, 2 ** 31 + 101, torch.device("cpu"))
    correct, checks = runner.decide(nums, cell.limits)
    assert not correct, checks
    nums, walls = calibrate.program_numbers(cell, 2 ** 31 + 102,
                                            torch.device("cpu"))
    assert len(walls) == cell.traffic["panels"]
    assert runner.decide(nums, cell.limits)[0], nums


# -- the card ----------------------------------------------------------------


@pytest.mark.card
def test_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", NAME,
         "--seed", str(2 ** 31 + 77), "--seconds", "3", "--trace", "0"],
        cwd=BENCH.parent, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["device"]["platform"] == "gpu"
    assert line["correct"], line["checks"]
