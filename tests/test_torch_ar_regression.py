"""The port's AR(p) (``models.autoregression``), Cochrane-Orcutt
regression (``models.regression_arima``) and the ARIMA leftovers (the
single-series Hannan-Rissanen init, ``sample``, the effects transforms,
``utils.optim.minimize_lbfgs``) against the JAX package.

Closed-form results are held at 1e-10 relative in float64 and 1e-4 in
float32 (normal equations accumulated in another order than the
reference's matrix products).  ``sample`` draws from a torch generator
where the reference draws from a JAX key, so it is held at the
distribution level: a long AR(1) sample's lag-1 autocorrelation within
0.03 of phi, and an AR fit of the samples within 0.05 of the generating
parameters.  The effects transforms round-trip within 1e-10 (float64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu.models import arima as jarima
from spark_timeseries_tpu.models import autoregression as jar
from spark_timeseries_tpu.models import regression_arima as jreg
from spark_timeseries_tpu.utils import optim as joptim
from spark_timeseries_tpu_torch.models import arima as tarima
from spark_timeseries_tpu_torch.models import autoregression as tar
from spark_timeseries_tpu_torch.models import regression_arima as treg
from spark_timeseries_tpu_torch.utils import optim as toptim

TOL = {np.float64: 1e-10, np.float32: 1e-4}
DTYPES = [np.float64, np.float32]


def _close(got, ref, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=tol, atol=tol)


def _ar_panel(b, t, phis, seed, dtype):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(b, t))
    y = np.zeros_like(e)
    for i in range(t):
        y[:, i] = 0.3 + e[:, i]
        for j, ph in enumerate(phis):
            if i > j:
                y[:, i] += ph * y[:, i - 1 - j]
    y[0, :9] = np.nan  # ragged start
    y[1, -4:] = np.nan  # trailing NaNs
    y[2, 3:] = np.nan  # too short for any lag order: excluded
    return y.astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("max_lag", [1, 3])
@pytest.mark.parametrize("no_intercept", [False, True])
def test_ar_fit_matches_reference(dtype, max_lag, no_intercept):
    y = _ar_panel(6, 90, (0.5, -0.2, 0.1)[:max_lag], seed=max_lag,
                  dtype=dtype)
    ref = jar.fit(jnp.asarray(y), max_lag, no_intercept)
    got = tar.fit(y, max_lag, no_intercept, device="cpu")
    _close(got.params, ref.params, TOL[dtype])
    _close(got.neg_log_likelihood, ref.neg_log_likelihood, TOL[dtype])
    for a, b in ((got.converged, ref.converged), (got.status, ref.status),
                 (got.iters, ref.iters)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    one = tar.fit(y[3], max_lag, no_intercept, device="cpu")
    _close(one.params, ref.params[3], TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_ar_forecast_and_effects_match_reference(dtype):
    y = _ar_panel(4, 60, (0.5, -0.2), seed=8, dtype=dtype)[3:]
    pr = np.array([0.3, 0.5, -0.2], dtype)
    _close(tar.forecast(pr, y[0], 2, 7, device="cpu"),
           jar.forecast(jnp.asarray(pr), jnp.asarray(y[0]), 2, 7),
           TOL[dtype])
    e_ref = jar.remove_time_dependent_effects(jnp.asarray(pr),
                                              jnp.asarray(y[0]), 2)
    e = tar.remove_time_dependent_effects(pr, y[0], 2, device="cpu")
    _close(e, e_ref, TOL[dtype])
    _close(tar.add_time_dependent_effects(pr, e, 2, device="cpu"),
           jar.add_time_dependent_effects(jnp.asarray(pr), e_ref, 2),
           TOL[dtype])


@pytest.mark.parametrize("order", [(1, 0, 0), (1, 1, 1), (2, 2, 1),
                                   (0, 1, 2)])
def test_arima_effects_match_reference_and_round_trip(order):
    rng = np.random.default_rng(sum(order))
    y = np.cumsum(rng.normal(size=(3, 50)), axis=1)
    k = tarima._n_params(order, True)
    pr = 0.3 * rng.uniform(-1, 1, size=(3, k))
    ref = jax.vmap(lambda a, v: jarima.remove_time_dependent_effects(
        a, v, order))(jnp.asarray(pr), jnp.asarray(y))
    e = tarima.remove_time_dependent_effects(pr, y, order, device="cpu")
    _close(e, ref, 1e-10)
    back = tarima.add_time_dependent_effects(pr, e, order, device="cpu")
    _close(back, y, 1e-10)
    _close(back, jax.vmap(lambda a, v: jarima.add_time_dependent_effects(
        a, v, order))(jnp.asarray(pr), ref), 1e-10)
    # one parameter row broadcasts over the panel
    e1 = tarima.remove_time_dependent_effects(pr[0], y, order, device="cpu")
    _close(e1[2], jarima.remove_time_dependent_effects(
        jnp.asarray(pr[0]), jnp.asarray(y[2]), order), 1e-10)


def test_arima_sample_distribution():
    pr = np.array([0.0, 0.6])
    y = tarima.sample(pr, 11, 40_000, (1, 0, 0), device="cpu")
    assert tuple(y.shape) == (40_000,)
    x = y.numpy() - y.numpy().mean()
    r1 = float((x[1:] * x[:-1]).sum() / (x * x).sum())
    assert abs(r1 - 0.6) < 0.03
    # same seed, same draws; a generator is taken as given
    g = torch.Generator().manual_seed(11)
    np.testing.assert_array_equal(
        tarima.sample(pr, g, 40_000, (1, 0, 0), device="cpu").numpy(),
        y.numpy())
    # integrated: the first differences follow the ARMA part
    yi = tarima.sample(np.array([0.0, 0.6, 0.3]), 3, 500, (1, 1, 1),
                       sigma=2.0, device="cpu")
    assert tuple(yi.shape) == (500,) and torch.isfinite(yi).all()
    ref = jarima.sample(jnp.asarray([0.0, 0.6, 0.3]), jax.random.PRNGKey(3),
                        500, (1, 1, 1), sigma=2.0)
    assert ref.shape == tuple(yi.shape)


def test_ar_sample_fits_back():
    pr = np.array([0.2, 0.5, -0.3])
    y = tar.sample(pr, 5, 20_000, 2, device="cpu")
    got = tar.fit(y, 2, device="cpu").params.numpy()
    np.testing.assert_allclose(got, pr, atol=0.05)


@pytest.mark.parametrize("order", [(1, 0, 1), (2, 0, 1), (0, 0, 2)])
@pytest.mark.parametrize("icpt", [True, False])
def test_single_series_hannan_rissanen_matches_reference(order, icpt):
    rng = np.random.default_rng(3)
    yd = rng.normal(size=80).cumsum() * 0.1 + rng.normal(size=80)
    ref = jarima.hannan_rissanen(jnp.asarray(yd), order, icpt)
    _close(tarima.hannan_rissanen(torch.as_tensor(yd), order, icpt), ref,
           1e-10)
    yz = yd.copy()
    yz[:11] = 0.0  # a right-aligned series with 69 valid steps
    ref = jarima.hannan_rissanen(jnp.asarray(yz), order, icpt, 69)
    _close(tarima.hannan_rissanen(torch.as_tensor(yz), order, icpt, 69),
           ref, 1e-10)


@pytest.mark.parametrize("x0", [(-1.2, 1.0), (2.0, -1.5), (0.5, 0.5)])
def test_minimize_lbfgs_matches_reference(x0):
    def rosen(x, m):
        return 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2

    ref = joptim.minimize_lbfgs(lambda x: rosen(x, jnp), jnp.asarray(x0),
                                max_iters=200, tol=1e-10)
    got = toptim.minimize_lbfgs(lambda x: rosen(x, torch),
                                torch.tensor(x0, dtype=torch.float64),
                                max_iters=200, tol=1e-10)
    assert bool(got.converged) == bool(ref.converged)
    assert int(got.iters) == int(ref.iters)
    _close(got.x, ref.x, 1e-8)
    _close(got.f, ref.f, 1e-8)
    np.testing.assert_allclose(got.x.numpy(), [1.0, 1.0], atol=1e-5)


def _co_inputs(b, n, seed, dtype, rho=0.6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(b, n, 2))
    e = rng.normal(size=(b, n))
    u = np.zeros_like(e)
    for t in range(n):
        u[:, t] = e[:, t] + (rho * u[:, t - 1] if t else 0.0)
    y = 1.0 + X @ np.array([2.0, -1.0]) + u
    return y.astype(dtype), X.astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("max_iter", [1, 10])
def test_cochrane_orcutt_matches_reference(dtype, max_iter):
    y, X = _co_inputs(5, 120, seed=max_iter, dtype=dtype)
    ref = jreg.fit_cochrane_orcutt(jnp.asarray(y), jnp.asarray(X),
                                   max_iter=max_iter)
    got = treg.fit_cochrane_orcutt(y, X, max_iter=max_iter, device="cpu")
    _close(got.params, ref.params, TOL[dtype])
    _close(got.neg_log_likelihood, ref.neg_log_likelihood, TOL[dtype])
    for a, b in ((got.converged, ref.converged), (got.status, ref.status),
                 (got.iters, ref.iters)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    one = treg.fit(y[2], X[2], max_iter=max_iter, device="cpu")
    _close(one.params, ref.params[2], TOL[dtype])
    _close(treg.predict(got.params, X, device="cpu"),
           jreg.predict(ref.params, jnp.asarray(X)), TOL[dtype])
    _close(treg.predict(one.params, X[2], device="cpu"),
           jreg.predict(ref.params[2], jnp.asarray(X[2])), TOL[dtype])


def test_cochrane_orcutt_recovers_beta_and_rho():
    y, X = _co_inputs(64, 400, seed=4, dtype=np.float64)
    p = treg.fit(y, X, device="cpu").params.numpy()
    med = np.median(p, axis=0)
    np.testing.assert_allclose(med, [1.0, 2.0, -1.0, 0.6], atol=0.05)


@pytest.mark.parametrize("kwargs", [dict(method="ols"),
                                    dict(align_mode="sideways")])
def test_regression_refusals_match_reference(kwargs):
    y, X = _co_inputs(2, 30, seed=1, dtype=np.float64)
    with pytest.raises(ValueError):
        jreg.fit(jnp.asarray(y), jnp.asarray(X), **kwargs)
    with pytest.raises(ValueError):
        treg.fit(y, X, device="cpu", **kwargs)


def test_new_entry_points_run_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this check is for a host without a CUDA device")
    y, X = _co_inputs(2, 30, seed=1, dtype=np.float32)
    for call in (lambda: tar.fit(y, 1),
                 lambda: treg.fit(y, X),
                 lambda: tarima.sample(np.zeros(2), 0, 10, (1, 0, 0)),
                 lambda: tarima.fit_grid(y, (((1, 0, 0), None),)),
                 lambda: tarima.fit(y, (0, 1, 1), seasonal=(0, 1, 1, 4))):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
