"""The port's forecast walk (``forecasting/kernels.py``, ``walk.py``,
``params.py``) against the reference.

Point and simulation functions per model family and the chunked forecast
walk, with and without intervals, agree with the reference within 1e-5
relative to the panel's scale (the bands are quantiles of simulated
paths, so an error near a zero crossing is measured against the band's
scale, not the crossing value); the walk's base seed, derived from the
augmented panel's journal fingerprint, is the reference's exactly.  The
walk's own contracts hold bitwise: chunked against unchunked, resumed
against uninterrupted, forecast-from-journal against forecast-from-memory.
The band quantile is computed from a sort in row blocks
(``torch.quantile`` refuses a whole-tensor reduction over more than 2^24
values) and is held against ``numpy.quantile`` above that size.
Journals read by ``load_fit_result`` / ``load_auto_members`` are written
by the port's own walks.  Panels are float32 on both sides
(``tests/conftest.py`` enables x64).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spark_timeseries_tpu.forecasting import kernels as ref_kernels
from spark_timeseries_tpu.forecasting import walk as ref_walk
from spark_timeseries_tpu_torch.forecasting import _prng, kernels, params
from spark_timeseries_tpu_torch.forecasting import walk
from spark_timeseries_tpu_torch.models import arima, auto
from spark_timeseries_tpu_torch.parallel import mesh as meshlib
from spark_timeseries_tpu_torch.reliability import faultinject as fi
from spark_timeseries_tpu_torch.reliability import fit_chunked
from spark_timeseries_tpu_torch.reliability.status import FitStatus

B, T, H, S = 24, 96, 8, 64
TOL = 1e-5


def _panel(seed=0, ragged=True):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(B, T)).astype(np.float32)
    y = np.zeros_like(e)
    for t in range(T):
        y[:, t] = (0.6 * y[:, t - 1] if t else 0.0) + e[:, t]
    y = np.cumsum(y, axis=1).astype(np.float32) * 0.3
    if ragged:
        y[0, :7] = np.nan
        y[1, -3:] = np.nan
        y[2, 20:24] = np.nan
    return y


def _seasonal_panel(seed=1):
    rng = np.random.default_rng(seed)
    t = np.arange(T)
    y = (50.0 + 0.05 * t + 5.0 * np.sin(2 * np.pi * t / 12)
         + rng.normal(0.0, 0.5, (B, T)))
    return y.astype(np.float32)


def _returns(seed=2):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.normal(size=(B, T))).astype(np.float32)


def _params(k, center, scale=0.05, seed=3):
    rng = np.random.default_rng(seed)
    p = np.asarray(center, np.float32) + scale * rng.normal(
        size=(B, k)).astype(np.float32)
    return p.astype(np.float32)


# (model, model_kwargs, panel maker, params centre)
CASES = {
    "arima111": ("arima", {"order": (1, 1, 1)}, _panel, [0.02, 0.5, 0.2]),
    "arima201": ("arima", {"order": (2, 0, 1), "include_intercept": False},
                 _panel, [0.5, 0.2, 0.3]),
    "ar2": ("autoregression", {"max_lag": 2}, _panel, [0.01, 0.5, 0.2]),
    "ewma": ("ewma", {}, _seasonal_panel, [0.3]),
    "hw_add": ("holtwinters", {"period": 12}, _seasonal_panel,
               [0.2, 0.02, 0.3]),
    "hw_mult": ("holtwinters", {"period": 12,
                                "model_type": "multiplicative"},
                _seasonal_panel, [0.2, 0.02, 0.3]),
    "garch": ("garch", {}, _returns, [0.001, 0.08, 0.9]),
}


def _case(name):
    model, mk, make, centre = CASES[name]
    cfg = dict(kernels.normalize_model_kwargs(model, mk))
    y = make()
    k = kernels.param_width(model, cfg)
    p = _params(k, centre, scale=0.02 if model != "garch" else 0.0)
    return model, mk, cfg, y, p


def _assert_scaled_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    scale = np.abs(want[fin]).max()
    np.testing.assert_allclose(got[fin], want[fin], rtol=TOL,
                               atol=TOL * scale)


def _ref_keys(seed, rows):
    k0 = jax.random.PRNGKey(seed)
    return jax.vmap(lambda r: jax.random.fold_in(k0, r))(
        jnp.asarray(rows, jnp.int32))


@pytest.mark.parametrize("name", sorted(CASES))
def test_point_fn_matches_reference(name):
    model, _, cfg, y, p = _case(name)
    want = jax.jit(ref_kernels.point_fn(model, cfg, H))(
        jnp.asarray(p), jnp.asarray(y))
    with torch.no_grad():
        got = kernels.point_fn(model, cfg, H)(torch.as_tensor(p),
                                              torch.as_tensor(y))
    _assert_scaled_close(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sim_fn_matches_reference(name):
    model, _, cfg, y, p = _case(name)
    rows = np.arange(B) + 1000
    want = jax.jit(ref_kernels.sim_fn(model, cfg, H, S))(
        jnp.asarray(p), jnp.asarray(y), _ref_keys(11, rows))
    keys = _prng.fold_in(_prng.PRNGKey(11), torch.as_tensor(rows))
    with torch.no_grad():
        got = kernels.sim_fn(model, cfg, H, S)(
            torch.as_tensor(p), torch.as_tensor(y), keys)
    assert got.shape == (B, H, S)
    _assert_scaled_close(got.numpy(), np.swapaxes(np.asarray(want), 1, 2))


@pytest.mark.parametrize("name", ["arima111", "ewma", "hw_add", "garch"])
@pytest.mark.parametrize("intervals", [False, True])
def test_forecast_chunked_matches_reference(name, intervals):
    model, mk, _, y, p = _case(name)
    kw = dict(model_kwargs=mk, intervals=intervals, n_samples=S,
              chunk_rows=10)
    want = ref_walk.forecast_chunked(model, p, jnp.asarray(y), H, **kw)
    got = walk.forecast_chunked(model, p, torch.as_tensor(y), H,
                                device="cpu", **kw)
    _assert_scaled_close(got.forecast, want.forecast)
    np.testing.assert_array_equal(got.status, np.asarray(want.status))
    if intervals:
        assert got.meta["forecast"]["base_seed"] == \
            want.meta["forecast"]["base_seed"]
        _assert_scaled_close(got.lo, want.lo)
        _assert_scaled_close(got.hi, want.hi)
        assert (got.lo <= got.hi).all()
    else:
        assert got.lo is None and got.hi is None


def test_unusable_rows_forecast_nan_and_keep_status():
    model, mk, _, y, p = _case("arima111")
    p[3] = np.nan
    status = np.zeros(B, np.int8)
    status[5] = int(FitStatus.DIVERGED)
    got = walk.forecast_chunked(model, p, torch.as_tensor(y), H,
                                model_kwargs=mk, status=status,
                                intervals=True, n_samples=16,
                                device="cpu")
    assert np.isnan(got.forecast[[3, 5]]).all()
    assert np.isnan(got.lo[[3, 5]]).all()
    assert got.status[5] == int(FitStatus.DIVERGED)
    assert np.isfinite(got.forecast[6:]).all()


@pytest.mark.parametrize("intervals", [False, True])
def test_chunked_equals_unchunked_bitwise(intervals):
    model, mk, _, y, p = _case("arima111")
    kw = dict(model_kwargs=mk, intervals=intervals, n_samples=S, seed=5,
              device="cpu")
    whole = walk.forecast_chunked(model, p, torch.as_tensor(y), H, **kw)
    chunked = walk.forecast_chunked(model, p, torch.as_tensor(y), H,
                                    chunk_rows=7, **kw)
    for f in ("forecast", "lo", "hi", "status"):
        a, b = getattr(whole, f), getattr(chunked, f)
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


def test_resume_after_crash_is_bitwise(tmp_path):
    model, mk, _, y, p = _case("hw_add")
    kw = dict(model_kwargs=mk, intervals=True, n_samples=S, chunk_rows=8,
              device="cpu")
    clean = walk.forecast_chunked(model, p, torch.as_tensor(y), H, **kw)
    root = str(tmp_path / "fc")
    with pytest.raises(fi.SimulatedCrash):
        walk.forecast_chunked(model, p, torch.as_tensor(y), H,
                              checkpoint_dir=root,
                              _journal_commit_hook=fi.crash_after_commits(1),
                              **kw)
    res = walk.forecast_chunked(model, p, torch.as_tensor(y), H,
                                checkpoint_dir=root, **kw)
    assert res.meta["journal"]["chunks_resumed"] == 1
    for f in ("forecast", "lo", "hi", "status"):
        np.testing.assert_array_equal(getattr(res, f), getattr(clean, f),
                                      err_msg=f)


def test_quantile_above_2_24_against_numpy():
    # one chunk's paths hold far more than the 2^24 values torch.quantile
    # takes in one whole-tensor reduction; the sort-based quantile works
    # in row blocks at any size
    b, h, s = 65_600, 1, 256
    assert b * h * s > 1 << 24
    gen = torch.Generator().manual_seed(0)
    paths = torch.randn(b, h, s, generator=gen, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="too large"):
        torch.quantile(paths, 0.05)
    paths[7, 0, 3] = torch.nan  # a NaN slice gives NaN
    lo, hi = walk._band_quantiles(paths, (0.05, 0.95))
    ref = paths.double().numpy()
    for got, q in ((lo, 0.05), (hi, 0.95)):
        want = np.quantile(ref, q, axis=-1, method="linear")
        np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got.numpy()[fin], want[fin], rtol=1e-6,
                                   atol=1e-7)
    assert torch.isnan(lo[7, 0]) and torch.isnan(hi[7, 0])


def test_load_fit_result_is_the_walk_output(tmp_path):
    y = _panel(ragged=False)
    fit_fn = arima.fit
    root = str(tmp_path / "fit")
    res = fit_chunked(fit_fn, torch.as_tensor(y), chunk_rows=10,
                      resilient=False, order=(1, 1, 1), max_iters=25,
                      device="cpu", checkpoint_dir=root)
    loaded = params.load_fit_result(root)
    for f in ("params", "neg_log_likelihood", "converged", "iters",
              "status"):
        np.testing.assert_array_equal(getattr(loaded, f), getattr(res, f),
                                      err_msg=f)
    assert loaded.meta["journal"]["rows_missing"] == 0
    # forecast once from the journal, once from memory: the same bits
    kw = dict(model_kwargs={"order": (1, 1, 1)}, intervals=True,
              n_samples=16, device="cpu")
    a = walk.forecast_chunked("arima", root, torch.as_tensor(y), H, **kw)
    b = walk.forecast_chunked("arima", res, torch.as_tensor(y), H, **kw)
    for f in ("forecast", "lo", "hi", "status"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_load_auto_members_reselects_the_search(tmp_path):
    y = _panel(ragged=False)
    orders = [(1, 0, 0), (0, 0, 1), (1, 1, 0)]
    root = str(tmp_path / "search")
    res = auto.auto_fit(torch.as_tensor(y), orders, max_iters=20,
                        chunk_rows=10, checkpoint_dir=root, device="cpu")
    specs, ii, members, meta = params.load_auto_members(root)
    assert specs == res.orders and ii is True
    assert meta["fusion_groups"] == res.meta["auto_fit"]["fusion_groups"]
    sel = auto.select_orders(specs, members, auto.panel_n_valid(y))
    np.testing.assert_array_equal(sel["order_index"], res.order_index)
    np.testing.assert_array_equal(sel["params"], res.params)
    np.testing.assert_array_equal(sel["criterion"], res.criterion)
    # an auto-fit selection mixes layouts per row: a single-order
    # forecast of it is refused
    with pytest.raises(ValueError, match="ensemble_forecast"):
        walk.forecast_chunked("arima", res, torch.as_tensor(y), H,
                              model_kwargs={"order": (1, 0, 0)},
                              device="cpu")


def test_argument_errors_match_reference():
    y = torch.as_tensor(_panel())
    p = _params(3, [0.0, 0.5, 0.2])
    for bad in (dict(horizon=0), dict(model_kwargs={"order": (1, 1)}),
                dict(model_kwargs={"order": (1, 0, 0, (1, 0, 0, 4))}),
                dict(model_kwargs={"order": (1, 1, 1), "bogus": 1})):
        kw = {"horizon": H, "model_kwargs": {"order": (1, 1, 1)}, **bad}
        with pytest.raises(ValueError):
            walk.forecast_chunked("arima", p, y, device="cpu", **kw)
    with pytest.raises(ValueError, match="unknown forecast model"):
        walk.forecast_chunked("prophet", p, y, H, device="cpu")
    # shard=/mesh= run the multi-lane walk: bit for bit the single-lane
    # walk on the same chunk grid, and the reference's sharded walk's
    # forecasts within the fit-parity bar
    mesh = meshlib.default_mesh(devices=[torch.device("cpu")] * 3)
    rows = -(-y.shape[0] // 3)
    kw = dict(model_kwargs={"order": (1, 1, 1)}, device="cpu")
    one = walk.forecast_chunked("arima", p, y, H, chunk_rows=rows, **kw)
    lanes = walk.forecast_chunked("arima", p, y, H, mesh=mesh, **kw)
    np.testing.assert_array_equal(lanes.forecast, one.forecast)
    np.testing.assert_array_equal(lanes.status, one.status)
    assert lanes.meta["shards"]["n_shards"] == 3
    ref = ref_walk.forecast_chunked("arima", np.asarray(p), y.numpy(), H,
                                    model_kwargs={"order": (1, 1, 1)},
                                    shard=True)
    np.testing.assert_array_equal(lanes.status, np.asarray(ref.status))
    np.testing.assert_allclose(lanes.forecast, np.asarray(ref.forecast),
                               rtol=1e-4, atol=1e-4)
