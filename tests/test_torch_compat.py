"""The port's ``compat.sparkts`` and ``plot`` against the reference's.

``TimeSeriesRDD``'s methods and constructors, every ``fit_model`` against
the reference's (the port's fit-test bars), the model methods on fixed
parameters, ``forecast_panel``, model files loaded across packages, the
``map_series`` modes with their warning, and the three plot functions on
the Agg backend (the plotted line data equal to the reference's).  The
reference's own ``test_compat_plot.py::TestSparktsCompat::
test_other_models`` can lose its worker to a crash in JAX's compile cache
under xdist, so these compare port output with reference output directly.
Values are float64 unless a test says otherwise (``tests/conftest.py``
enables x64).
"""

import functools
import warnings

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax.numpy as jnp  # noqa: E402

import spark_timeseries_tpu as ref  # noqa: E402
from spark_timeseries_tpu import plot as rplot  # noqa: E402
from spark_timeseries_tpu.compat import sparkts as rsk  # noqa: E402
import spark_timeseries_tpu_torch as port  # noqa: E402
from spark_timeseries_tpu_torch import forecasting, plot  # noqa: E402
from spark_timeseries_tpu_torch import reliability  # noqa: E402
from spark_timeseries_tpu_torch.compat import sparkts as sk  # noqa: E402
from spark_timeseries_tpu_torch.models import arima, ewma  # noqa: E402

CPU = "cpu"
PARAM_TOL = 4e-3  # tests/test_torch_chunked.py's ARIMA walk bar


def _obs_frame():
    idx = ref.uniform("2020-01-01", 30, ref.DayFrequency())
    rng = np.random.default_rng(7)
    rows = []
    for k in ["GOOG", "AAPL", "MSFT"]:
        for i, dt in enumerate(idx.datetimes()):
            if (i * 7 + len(k)) % 11 == 3:
                continue  # a gap
            rows.append((dt, k, float(rng.normal() + i)))
    return pd.DataFrame(rows, columns=["timestamp", "symbol", "price"])


@pytest.fixture(scope="module")
def rdds():
    df = _obs_frame()
    p = sk.time_series_rdd_from_observations(
        sk.uniform("2020-01-01", 30, sk.DayFrequency()), df, "timestamp",
        "symbol", "price", device=CPU)
    r = rsk.time_series_rdd_from_observations(
        rsk.uniform("2020-01-01", 30, rsk.DayFrequency()), df, "timestamp",
        "symbol", "price")
    return p, r


def _same_rdd(p, r):
    assert p.keys() == r.keys()
    assert p.index.to_string() == r.index.to_string()
    got, want = dict(p.collect()), dict(r.collect())
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# TimeSeriesRDD
# ---------------------------------------------------------------------------


def test_rdd_basics_match(rdds):
    p, r = rdds
    assert p.count() == r.count() == len(p) == 3
    _same_rdd(p, r)
    np.testing.assert_array_equal(p.find_series("AAPL"),
                                  r.find_series("AAPL"))
    assert isinstance(p.find_series("AAPL"), np.ndarray)


@pytest.mark.parametrize("what", [
    "fill", "differences", "quotients", "return_rates", "slice",
    "with_index", "remove_instants_with_nans", "filter", "map_device"])
def test_rdd_transforms_match(rdds, what):
    p, r = rdds
    ops = {
        "fill": lambda x, m: x.fill("linear"),
        "differences": lambda x, m: x.differences(2),
        "quotients": lambda x, m: x.quotients(1),
        "return_rates": lambda x, m: x.return_rates(),
        "slice": lambda x, m: x.slice("2020-01-05", "2020-01-10"),
        "with_index": lambda x, m: x.with_index(
            m.uniform("2019-12-28", 40, m.DayFrequency())),
        "remove_instants_with_nans": lambda x, m: (
            x.remove_instants_with_nans()),
        "filter": lambda x, m: x.filter(lambda k: k != "MSFT"),
        "map_device": lambda x, m: x.map_series(lambda v: v * 2.0 + 1.0,
                                                mode="device"),
    }
    got, want = ops[what](p, sk), ops[what](r, rsk)
    assert got.keys() == want.keys()
    for k, v in dict(want.collect()).items():
        np.testing.assert_allclose(dict(got.collect())[k], v, rtol=1e-12,
                                   equal_nan=True)


def test_rdd_exits_match(rdds):
    p, r = rdds
    pi, ri = p.to_instants(), r.to_instants()
    assert len(pi) == len(ri) == 30
    for (pd_, pv), (rd_, rv) in zip(pi, ri):
        assert pd_ == rd_
        np.testing.assert_array_equal(pv, rv)
    np.testing.assert_array_equal(p.to_row_matrix(), r.to_row_matrix())
    for (pl, pv), (rl, rv) in zip(p.to_indexed_row_matrix(),
                                  r.to_indexed_row_matrix()):
        assert pl == rl
        np.testing.assert_array_equal(pv, rv)
    pd.testing.assert_frame_equal(p.to_instants_dataframe(),
                                  r.to_instants_dataframe())
    pd.testing.assert_frame_equal(p.to_pandas(), r.to_pandas())
    pd.testing.assert_frame_equal(
        p.to_observations_dataframe("timestamp", "symbol", "price"),
        r.to_observations_dataframe("timestamp", "symbol", "price"))
    ps, rs = p.series_stats(), r.series_stats()  # float32 panels
    for k in rs:
        np.testing.assert_allclose(ps[k].numpy(), np.asarray(rs[k]),
                                   rtol=1e-6)


def test_rdd_files_read_across_packages(rdds, tmp_path):
    p, r = rdds
    p.save_as_csv(str(tmp_path / "p.csv"))
    r.save_as_csv(str(tmp_path / "r.csv"))
    assert (tmp_path / "p.csv").read_text() == (tmp_path / "r.csv").read_text()
    p.save_as_parquet_data_frame(str(tmp_path / "p.parquet"))
    _same_rdd(sk.time_series_rdd_from_parquet(str(tmp_path / "p.parquet"),
                                              device=CPU),
              rsk.time_series_rdd_from_parquet(str(tmp_path / "p.parquet")))
    r.save_as_parquet_data_frame(str(tmp_path / "r.parquet"))
    _same_rdd(sk.time_series_rdd_from_parquet(str(tmp_path / "r.parquet"),
                                              device=CPU), r)


def test_rdd_from_a_wide_frame(rdds):
    _, r = rdds
    wide = r.to_instants_dataframe()
    _same_rdd(sk.time_series_rdd_from_pandas_dataframe(
        sk.uniform("2020-01-01", 30, sk.DayFrequency()), wide, device=CPU),
        rsk.time_series_rdd_from_pandas_dataframe(
            rsk.uniform("2020-01-01", 30, rsk.DayFrequency()), wide))


# ---------------------------------------------------------------------------
# map_series modes
# ---------------------------------------------------------------------------


def _small():
    vals = np.arange(16.0).reshape(2, 8)
    return (sk.TimeSeriesRDD(port.TimeSeriesPanel(
                sk.uniform("2020-01-01", 8, sk.DayFrequency()), ["a", "b"],
                torch.as_tensor(vals))),
            rsk.TimeSeriesRDD(ref.TimeSeriesPanel(
                rsk.uniform("2020-01-01", 8, rsk.DayFrequency()),
                ["a", "b"], jnp.asarray(vals))))


def test_host_mode_runs_a_pandas_lambda():
    p, r = _small()
    fn = lambda s: s.rolling(2, min_periods=1).mean()  # noqa: E731
    _same_rdd(p.map_series(fn, mode="host"), r.map_series(fn, mode="host"))


@pytest.mark.parametrize("fn", [
    lambda s: s.fillna(0.0) * 2.0,  # AttributeError on a tensor
    lambda s: s * 2.0 if float(s.sum()) > 0 else s,  # .item() under vmap
    lambda s: s * 2.0 if (s.sum() > 0) else s,  # data-dependent if
    lambda s: pd.Series(np.asarray(s) * 2.0),  # a host conversion
], ids=["attribute", "item", "control_flow", "host_conversion"])
def test_auto_mode_falls_back_with_a_warning(fn):
    p, r = _small()
    with pytest.warns(UserWarning, match="host"):
        got = p.map_series(fn)
    with pytest.warns(UserWarning, match="host"):
        want = r.map_series(fn)
    _same_rdd(got, want)
    with pytest.raises(Exception):
        p.map_series(fn, mode="device")


def _raise_runtime(s):
    raise RuntimeError("CUDA error: an illegal memory access was encountered")


def test_auto_mode_does_not_catch_other_errors():
    p, _ = _small()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(RuntimeError, match="illegal memory"):
            p.map_series(_raise_runtime)
        with pytest.raises(ValueError, match="index size"):
            p.map_series(lambda v: v[1:])  # a traceable fn, wrong length


def test_mode_is_checked():
    p, r = _small()
    for x in (p, r):
        with pytest.raises(ValueError, match="mode"):
            x.map_series(lambda v: v, mode="gpu")


# ---------------------------------------------------------------------------
# fit_model against the reference
# ---------------------------------------------------------------------------


def _arima_series(n=500, seed=0):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=n)
    y = np.zeros(n)
    for t in range(1, n):
        y[t] = 0.5 * y[t - 1] + e[t] + 0.3 * e[t - 1]
    return np.cumsum(y)


def _close(pm, rm, tol=PARAM_TOL):
    assert type(pm).__name__ == type(rm).__name__
    np.testing.assert_allclose(pm.coefficients, rm.coefficients, rtol=tol,
                               atol=tol)


def test_arima_fit_model_and_methods_match():
    y = _arima_series()
    pm = sk.ARIMA.fit_model(1, 1, 1, y, device=CPU)
    rm = rsk.ARIMA.fit_model(1, 1, 1, y)
    _close(pm, rm)
    assert pm.order == rm.order == (1, 1, 1)
    # the methods on the SAME parameters
    fixed = sk.ARIMAModel(1, 1, 1, rm.coefficients.copy(), device=CPU)
    np.testing.assert_allclose(fixed.forecast(y, 5), rm.forecast(y, 5),
                               rtol=1e-9)
    np.testing.assert_allclose(fixed.log_likelihood_css(y),
                               rm.log_likelihood_css(y), rtol=1e-9)
    np.testing.assert_allclose(fixed.approx_aic(y), rm.approx_aic(y),
                               rtol=1e-9)
    for m in ("add_time_dependent_effects", "remove_time_dependent_effects"):
        np.testing.assert_allclose(getattr(fixed, m)(y), getattr(rm, m)(y),
                                   rtol=1e-9, atol=1e-9)
    assert fixed.is_stationary() == rm.is_stationary() is True
    assert fixed.is_invertible() == rm.is_invertible() is True
    s = fixed.sample(50, seed=3)
    assert s.shape == (50,) and np.isfinite(s).all()
    np.testing.assert_array_equal(s, fixed.sample(50, seed=3))


def test_arima_fit_model_is_arima_fit_and_fit_chunked(tmp_path):
    y = np.stack([_arima_series(120, s) for s in range(4)])
    yt = torch.as_tensor(y)
    pm = sk.ARIMA.fit_model(1, 1, 1, yt)
    direct = arima.fit(yt, (1, 1, 1), method="css-cgd", device=CPU)
    assert torch.equal(pm.params, direct.params)
    pj = sk.ARIMA.fit_model(1, 1, 1, yt, checkpoint_dir=str(tmp_path / "a"),
                            chunk_rows=2)
    walk = reliability.fit_chunked(
        functools.partial(arima.fit, order=(1, 1, 1), include_intercept=True,
                          method="css-cgd", init_params=None),
        yt, chunk_rows=2, resilient=False, device=CPU,
        checkpoint_dir=str(tmp_path / "b"))
    np.testing.assert_array_equal(pj.coefficients, walk.params)
    with pytest.raises(TypeError, match="checkpoint_dir"):
        sk.ARIMA.fit_model(1, 1, 1, yt, chunk_rows=2)


def test_other_fit_models_match():
    rng = np.random.default_rng(5)
    y = rng.normal(size=300).cumsum() + 50
    _close(sk.EWMA.fit_model(y, device=CPU), rsk.EWMA.fit_model(y))
    ar_p = sk.Autoregression.fit_model(y, max_lag=2, device=CPU)
    ar_r = rsk.Autoregression.fit_model(y, max_lag=2)
    _close(ar_p, ar_r, 1e-8)
    assert ar_p.coefficients.shape == (3,)
    r = rng.normal(size=400) * np.concatenate([np.ones(200),
                                               2 * np.ones(200)])
    _close(sk.GARCH.fit_model(r, device=CPU), rsk.GARCH.fit_model(r), 1e-3)
    seas = np.tile(np.sin(np.arange(12) / 12 * 2 * np.pi), 10)
    yhw = seas * 3 + np.arange(120) * 0.05 + rng.normal(size=120) * 0.1 + 10
    hw_p = sk.HoltWinters.fit_model(yhw, 12, device=CPU)
    hw_r = rsk.HoltWinters.fit_model(yhw, 12)
    _close(hw_p, hw_r, 1e-2)
    assert hw_p.forecast(yhw, 6).shape == (6,)
    with pytest.raises(ValueError, match="unknown method"):
        sk.HoltWinters.fit_model(yhw, 12, method="nelder", device=CPU)


def test_argarch_and_regression_fit_models_match():
    import jax

    from spark_timeseries_tpu.models import garch as rgarch

    y = np.asarray(rgarch.argarch_sample(
        jnp.asarray([0.2, 0.5, 0.05, 0.1, 0.85]), jax.random.key(0), 400))
    _close(sk.ARGARCH.fit_model(y, device=CPU), rsk.ARGARCH.fit_model(y),
           2e-3)
    rng = np.random.default_rng(1)
    X = rng.normal(size=(200, 2))
    e = np.zeros(200)
    for t in range(1, 200):
        e[t] = 0.5 * e[t - 1] + rng.normal()
    yr = 1.0 + X @ np.array([2.0, -0.5]) + e
    pm = sk.RegressionARIMA.fit_model(yr, X, device=CPU)
    rm = rsk.RegressionARIMA.fit_model(yr, X)
    _close(pm, rm, 1e-6)
    np.testing.assert_allclose(pm.predict(X), rm.predict(X), rtol=1e-6)


def test_model_methods_on_fixed_params_match():
    rng = np.random.default_rng(2)
    y = rng.normal(size=64).cumsum() + 20.0
    r = rng.normal(size=64)
    cases = [
        (sk.ARModel([0.5, 0.3, 0.1], max_lag=2, device=CPU),
         rsk.ARModel([0.5, 0.3, 0.1], max_lag=2), y,
         ("forecast", "add_time_dependent_effects",
          "remove_time_dependent_effects")),
        (sk.EWMAModel([0.35], device=CPU), rsk.EWMAModel([0.35]), y,
         ("forecast", "add_time_dependent_effects",
          "remove_time_dependent_effects")),
        (sk.GARCHModel([0.1, 0.2, 0.6], device=CPU),
         rsk.GARCHModel([0.1, 0.2, 0.6]), r,
         ("forecast", "variances", "log_likelihood",
          "add_time_dependent_effects", "remove_time_dependent_effects")),
        (sk.HoltWintersModel([0.3, 0.1, 0.2], period=12,
                             model_type="multiplicative", device=CPU),
         rsk.HoltWintersModel([0.3, 0.1, 0.2], period=12,
                              model_type="multiplicative"), y,
         ("forecast", "sse")),
    ]
    for pm, rm, x, methods in cases:
        for m in methods:
            args = (x, 4) if m == "forecast" else (x,)
            np.testing.assert_allclose(getattr(pm, m)(*args),
                                       getattr(rm, m)(*args), rtol=1e-9,
                                       atol=1e-12, err_msg=m)
    assert sk.ARModel([0.5, 0.3, 0.1], 2, device=CPU).c == 0.5
    g = sk.GARCHModel([0.1, 0.2, 0.6], device=CPU)
    assert (g.omega, g.alpha, g.beta) == (0.1, 0.2, 0.6)
    assert sk.EWMAModel([0.35], device=CPU).smoothing == 0.35
    for model in (g, sk.ARGARCHModel([0.05, 0.3, 0.1, 0.2, 0.6],
                                     device=CPU)):
        s = model.sample(40, seed=9)
        assert s.shape[-1] == 40 and np.isfinite(s).all()
        np.testing.assert_array_equal(s, model.sample(40, seed=9))


def test_seasonal_model_refuses_forecasts_and_scores_like_the_reference():
    params = [0.01, 0.3, 0.2, -0.4]
    pm = sk.SeasonalARIMAModel((1, 1, 1), (0, 1, 1, 4), params, device=CPU)
    rm = rsk.SeasonalARIMAModel((1, 1, 1), (0, 1, 1, 4), params)
    y = _arima_series(80, 4)
    np.testing.assert_allclose(pm.log_likelihood_css(y),
                               rm.log_likelihood_css(y), rtol=1e-9)
    for m in ("forecast", "sample"):
        with pytest.raises(NotImplementedError, match="seasonal"):
            getattr(pm, m)(y if m == "forecast" else 10, 3)


def test_arima_auto_fit_matches():
    y = np.stack([_arima_series(100, s) for s in range(3)])
    orders = [(1, 1, 0), (1, 1, 1)]
    got = sk.ARIMA.auto_fit(torch.as_tensor(y), orders, max_iters=25)
    want = rsk.ARIMA.auto_fit(jnp.asarray(y), orders, max_iters=25)
    for g, w in zip(got, want):
        assert g.order == w.order and type(g).__name__ == type(w).__name__
        _close(g, w)
    one = sk.ARIMA.auto_fit(y[0], orders, max_iters=25, device=CPU)
    assert one.order == got[0].order


# ---------------------------------------------------------------------------
# forecast_panel and model files
# ---------------------------------------------------------------------------


def test_forecast_panel_is_forecast_chunked():
    y = np.stack([_arima_series(90, s) for s in range(5)])
    m = sk.ARIMAModel(1, 1, 1, [0.05, 0.4, 0.2], device=CPU)
    got = m.forecast_panel(y, 6, chunk_rows=2)
    direct = forecasting.forecast_chunked(
        "arima", np.repeat([[0.05, 0.4, 0.2]], 5, axis=0), torch.as_tensor(y),
        6, model_kwargs={"order": (1, 1, 1), "include_intercept": True},
        chunk_rows=2, device=CPU)
    np.testing.assert_array_equal(got.forecast, direct.forecast)
    want = rsk.ARIMAModel(1, 1, 1, [0.05, 0.4, 0.2]).forecast_panel(
        jnp.asarray(y), 6, chunk_rows=2)
    np.testing.assert_allclose(got.forecast, np.asarray(want.forecast),
                               rtol=1e-8)
    e = sk.EWMAModel([0.35], device=CPU).forecast_panel(y, 3)
    assert e.forecast.shape == (5, 3)
    with pytest.raises(NotImplementedError, match="no panel forecast"):
        sk.ARGARCHModel([0.05, 0.3, 0.1, 0.2, 0.6],
                        device=CPU).forecast_panel(y, 3)


def _models(mod):
    kw = dict(device=CPU) if mod is sk else {}
    return {
        "arima": mod.ARIMAModel(1, 1, 1, [0.1, 0.4, 0.2], has_intercept=True,
                                **kw),
        "sarima": mod.SeasonalARIMAModel((1, 1, 1), (0, 1, 1, 4),
                                         [0.01, 0.3, 0.2, -0.4], **kw),
        "ar": mod.ARModel([0.5, 0.3, 0.1], max_lag=2, **kw),
        "ewma": mod.EWMAModel([0.35], **kw),
        "garch": mod.GARCHModel([0.1, 0.2, 0.6], **kw),
        "argarch": mod.ARGARCHModel([0.05, 0.3, 0.1, 0.2, 0.6], **kw),
        "hw": mod.HoltWintersModel([0.3, 0.1, 0.2], period=12,
                                   model_type="multiplicative", **kw),
        "regarima": mod.RegressionARIMAModel([1.0, 2.0, -0.5], **kw),
    }


@pytest.mark.parametrize("name", ["arima", "sarima", "ar", "ewma", "garch",
                                  "argarch", "hw", "regarima"])
def test_model_files_load_across_packages(tmp_path, name):
    pm, rm = _models(sk)[name], _models(rsk)[name]
    pm.save(str(tmp_path / "port"))  # np.savez appends ".npz"
    rm.save(str(tmp_path / "ref.npz"))
    with np.load(tmp_path / "port.npz") as zp, \
            np.load(tmp_path / "ref.npz") as zr:
        assert sorted(zp.files) == sorted(zr.files)
        for k in zp.files:
            np.testing.assert_array_equal(zp[k], zr[k])
    back = sk.load_model(str(tmp_path / "ref.npz"), device=CPU)
    assert type(back) is type(pm)
    np.testing.assert_array_equal(back.coefficients, pm.coefficients)
    assert vars(back).keys() == vars(pm).keys()
    for k, v in vars(pm).items():
        if k != "params":
            assert getattr(back, k) == v, k
    assert type(rsk.load_model(str(tmp_path / "port.npz"))) is type(rm)
    again = type(pm).load(str(tmp_path / "port"), device=CPU)
    np.testing.assert_array_equal(again.coefficients, pm.coefficients)
    other = "ewma" if name != "ewma" else "garch"
    with pytest.raises(ValueError, match="not a"):
        _models(sk)[other].load(str(tmp_path / "port"), device=CPU)


def test_stat_tests_are_exposed():
    x = np.random.default_rng(2).normal(size=300)
    stat, p = sk.adftest(x.cumsum(), 2, device=CPU)
    rstat, rp = rsk.adftest(jnp.asarray(x.cumsum()), 2)
    np.testing.assert_allclose(float(stat), float(rstat), rtol=1e-6)
    assert float(p) > 0.05
    assert 1.0 < float(sk.dwtest(x, device=CPU)) < 3.0
    for name in ("bgtest", "bptest", "lbtest", "kpsstest"):
        assert callable(getattr(sk, name))


# ---------------------------------------------------------------------------
# plots
# ---------------------------------------------------------------------------


def _line_data(ax):
    return [ln.get_xydata() for ln in ax.lines]


def test_plots_draw_the_references_lines():
    rng = np.random.default_rng(0)
    x = np.zeros(200)
    for t in range(1, 200):
        x[t] = 0.7 * x[t - 1] + rng.normal()
    try:
        for fn in ("acf_plot", "pacf_plot"):
            got = getattr(plot, fn)(x, 10, device=CPU)
            want = getattr(rplot, fn)(x, 10)
            assert got.get_title() == want.get_title()
            for a, b in zip(_line_data(got), _line_data(want)):
                np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12)
            np.testing.assert_allclose(
                got.collections[0].get_segments(),
                want.collections[0].get_segments(), rtol=1e-10, atol=1e-12)
            via_tensor = getattr(plot, fn)(torch.as_tensor(x), 10)
            for a, b in zip(_line_data(via_tensor), _line_data(got)):
                np.testing.assert_array_equal(a, b)
        idx = ref.uniform("2020-01-01", 200, ref.DayFrequency())
        pidx = sk.uniform("2020-01-01", 200, sk.DayFrequency())
        got = plot.ezplot(torch.as_tensor(np.stack([x, -x])), index=pidx,
                          labels=["up", "down"])
        want = rplot.ezplot(np.stack([x, -x]), index=idx,
                            labels=["up", "down"])
        assert [ln.get_label() for ln in got.lines] == ["up", "down"]
        for a, b in zip(got.lines, want.lines):
            np.testing.assert_array_equal(a.get_ydata(), b.get_ydata())
            np.testing.assert_array_equal(a.get_xdata(), b.get_xdata())
        one = plot.ezplot(x)
        np.testing.assert_array_equal(one.lines[0].get_xdata(),
                                      np.arange(200))
    finally:
        plt.close("all")


def test_compat_fits_and_ewma_module_agree():
    y = np.random.default_rng(3).normal(size=(3, 80)).cumsum(axis=1)
    m = sk.EWMA.fit_model(torch.as_tensor(y))
    assert torch.equal(m.params, ewma.fit(torch.as_tensor(y),
                                          device=CPU).params)
