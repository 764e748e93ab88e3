"""The airline model, SARIMA(0,1,1)(0,1,1)_s without a constant, against
the benchmark's plain reference (``bench_port/reference/sarima.py``,
loaded by path).

At a small size on the CPU, on seeded random data and parameters, with
dense rows, rows with NaN heads, a row with a NaN tail, an empty row and
rows at either side of the eligibility gate, at s = 4 and s = 24: the
objective through ``arima.sarima_neg_loglik`` and through the eager fit's
reported value agree with the reference's to 1e-10 in float64 (both sum
the same few hundred squares; only the order of the additions differs);
the gradient agrees with central differences of the reference; the
statuses are the reference's eligibility exactly.  Then the cell's own
judge, at its limits, passes a sound fit and fails each of three faults
planted in the program: the theta Theta cross term dropped, the seasonal
differencing at lag s - 1, and the conditioning one step late.
"""

import importlib
import importlib.util
import json
import sys
from pathlib import Path

import pytest
import torch

from spark_timeseries_tpu_torch.models import arima
from spark_timeseries_tpu_torch.models.base import (align_mode_on_host,
                                                    maybe_align)

BENCH = Path(__file__).resolve().parent.parent / "bench_port"
F64 = torch.float64
ORDER = (0, 1, 1)
CELL = "airline_hourly_1m.fit"
EXCLUDED = 5


def _reference():
    """``bench_port/reference/`` as the package ``bench_reference``, by
    path (its modules import each other relatively)."""
    if "bench_reference" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "bench_reference", BENCH / "reference" / "__init__.py",
            submodule_search_locations=[str(BENCH / "reference")])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules["bench_reference"] = pkg
        spec.loader.exec_module(pkg)
    return importlib.import_module("bench_reference.sarima")


sarima = _reference()


def _panel(s: int, seed: int, rows: int = 24):
    """Random walks ``[rows, T]`` in float64: dense rows, NaN heads, one
    NaN tail, one empty row, and rows one short of the gate and at it."""
    T = 3 * s + 70
    g = torch.Generator().manual_seed(seed)
    y = torch.randn(rows, T, generator=g, dtype=F64).cumsum(1)
    y += 0.5 * torch.sin(torch.arange(T, dtype=F64) * 6.283 / s)
    need = sarima.min_diffs(s) + s + 1  # observations at the gate
    heads = torch.randint(0, T - need, (rows,), generator=g)
    heads[:6] = 0  # dense
    heads[6], heads[7] = T - need + 1, T - need  # one short; at the gate
    for r in range(rows):
        y[r, :int(heads[r])] = float("nan")
    y[8, -3:] = float("nan")  # a tail: the stretch ends early
    y[9] = float("nan")  # never observed
    return y


def _port_objective(y, params, s):
    """``arima.sarima_neg_loglik`` on the panel prepared as the fit
    prepares it."""
    ya, nv0 = maybe_align(y, align_mode_on_host(y))
    yd = arima._difference_seasonal(arima._difference(ya, 1), 1, s)
    return arima.sarima_neg_loglik(params, yd, ORDER, (0, 1, 1, s), False,
                                   nv0 - (s + 1))


def _ref_objective(y, params, s):
    prep = sarima.Prepared(y, F64, F64, s)
    el = prep.eligible
    return prep.objective(el)(params[el][None])[0], el


def _params(rows, seed):
    g = torch.Generator().manual_seed(seed)
    return 1.6 * torch.rand(rows, 2, generator=g, dtype=F64) - 0.8


@pytest.mark.parametrize("s", [4, 24])
def test_objective_matches_the_reference(s):
    y = _panel(s, seed=s)
    params = _params(y.shape[0], seed=s + 1)
    want, el = _ref_objective(y, params, s)
    assert el[:6].all() and not el[6] and el[7] and el[8] and not el[9]
    got = _port_objective(y, params, s)[el]
    assert torch.allclose(got, want, rtol=1e-10, atol=0.0)


@pytest.mark.parametrize("s", [4, 24])
def test_gradient_matches_differences_of_the_reference(s):
    y = _panel(s, seed=10 + s)
    params = _params(y.shape[0], seed=11 + s)
    prep = sarima.Prepared(y, F64, F64, s)
    el = prep.eligible
    p = params.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(_port_objective(y, p, s)[el].sum(), p)
    f = prep.objective(el)
    h = 1e-6
    fd = torch.stack([(f((params[el] + h * e)[None])[0]
                       - f((params[el] - h * e)[None])[0]) / (2 * h)
                      for e in torch.eye(2, dtype=F64)], -1)
    scale = fd.abs().clamp(min=1.0)
    assert float(((grad[el] - fd).abs() / scale).max()) < 1e-6


@pytest.mark.parametrize("s", [4, 24])
def test_eager_fit_reports_the_reference_objective(s):
    y = _panel(s, seed=20 + s)
    res = arima.fit(y, list(ORDER), seasonal=[0, 1, 1, s],
                    include_intercept=False, backend="eager", device="cpu")
    prep = sarima.Prepared(y, F64, F64, s)
    el = prep.eligible
    assert torch.equal(res.status == EXCLUDED, ~el)
    assert bool((res.status[el] == 0).all())  # every eligible row OK
    assert bool(torch.isnan(res.params[~el]).all())
    want = prep.objective(el)(res.params[el][None])[0]
    assert torch.allclose(res.neg_log_likelihood[el], want, rtol=1e-10,
                          atol=0.0)


# -- the cell's judge at its limits ------------------------------------------


def _cell_panel(rows=64, time=240):
    cfg = json.loads((BENCH / "configs" / "airline_hourly_1m.json")
                     .read_text())
    cfg.update(rows=rows, time=time)
    spec = importlib.util.spec_from_file_location(
        "bench_gen_airline", BENCH / "gen" / "airline_hourly_1m.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return cfg, gen.make(cfg, 2 ** 31 + 17, torch.device("cpu"))


def _judged(cfg, y):
    """The cell's fit entry on the panel, judged; -> the numbers over
    their limits."""
    fit = cfg["entries"]["fit"]
    res = arima.fit(y, *fit["args"], **fit["kwargs"], device="cpu")
    nums = sarima.judge_fit(cfg, y, {"fit": res})
    limits = json.loads((BENCH / "limits" / f"{CELL}.json")
                        .read_text())["limits"]
    return {k: v for k, v in nums.items() if v > limits[k]}


def _cross_dropped(real):
    return lambda vals, svals, s, cross: real(vals, svals, s, 0.0)


def _lag_short(real):
    return lambda y, D, s: real(y, D, s - 1)


def _late_start(real):
    return lambda *args, **kwargs: real(*args, **kwargs, condition_lags=1)


FAULTS = {"cross term dropped": ("_expand_seasonal_poly", _cross_dropped),
          "seasonal lag s - 1": ("_difference_seasonal", _lag_short),
          "conditioned a step late": ("_css_errors_poly", _late_start)}


def test_sound_fit_passes_the_cell_judge():
    cfg, y = _cell_panel()
    assert _judged(cfg, y) == {}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_fails_the_cell_judge(fault, monkeypatch):
    name, plant = FAULTS[fault]
    monkeypatch.setattr(arima, name, plant(getattr(arima, name)))
    cfg, y = _cell_panel()
    assert _judged(cfg, y), fault
