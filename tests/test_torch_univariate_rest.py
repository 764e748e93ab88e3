"""The port's remaining per-series transforms against the JAX package:
the trims, the partial autocorrelation, the cross-correlation, the
resampling functions and the natural-spline fill.

None of them runs a kernel in either package.  Each runs on the same numpy
inputs in both, in float64 (1e-10 relative) and float32 (1e-5 relative);
the spline fill is also held against scipy's natural cubic spline, the
reference's own oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu.ops import univariate as juv
from spark_timeseries_tpu_torch.ops import univariate as tuv

TOL = {np.float64: 1e-10, np.float32: 1e-5}
DTYPES = [np.float64, np.float32]


def _close(got, ref, dtype):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    tol = TOL[dtype]
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def _gappy(b, t, seed, dtype, gap=0.2):
    """Random walks with interior NaN gaps, a leading and a trailing NaN
    run on the first two rows."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t)).cumsum(axis=1)
    x[rng.random(size=(b, t)) < gap] = np.nan
    x[0, :4] = np.nan
    x[1, -3:] = np.nan
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_trims_match_reference(dtype):
    x = np.array([np.nan, np.nan, 1.0, np.nan, 2.0, np.nan], dtype)
    for fn in ("trim_leading", "trim_trailing"):
        ref = getattr(juv, fn)(x)
        _close(getattr(tuv, fn)(x), ref, dtype)
        _close(getattr(tuv, fn)(torch.as_tensor(x)), ref, dtype)
    assert isinstance(tuv.trim_leading(torch.as_tensor(x)), torch.Tensor)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("num_lags", [1, 5, 12])
def test_pacf_matches_reference(dtype, num_lags):
    x = _gappy(6, 80, seed=num_lags, dtype=dtype)
    ref = jax.jit(jax.vmap(lambda v: juv.pacf(v, num_lags)))(jnp.asarray(x))
    _close(tuv.pacf(torch.as_tensor(x), num_lags), ref, dtype)
    # one series, as the reference takes it
    _close(tuv.pacf(torch.as_tensor(x[2]), num_lags), ref[2], dtype)


def test_pacf_of_an_ar1_cuts_off_after_lag_one():
    rng = np.random.default_rng(3)
    e = rng.normal(size=4000)
    y = np.zeros_like(e)
    for t in range(1, e.size):
        y[t] = 0.7 * y[t - 1] + e[t]
    got = tuv.pacf(torch.as_tensor(y), 5).numpy()
    assert abs(got[0] - 0.7) < 0.05 and np.all(np.abs(got[1:]) < 0.05)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("num_lags", [0, 3, 10])
def test_cross_corr_matches_reference(dtype, num_lags):
    x = _gappy(4, 50, seed=10 + num_lags, dtype=dtype)
    y = _gappy(4, 50, seed=20 + num_lags, dtype=dtype)
    ref = jax.vmap(lambda a, b: juv.cross_corr(a, b, num_lags))(
        jnp.asarray(x), jnp.asarray(y))
    _close(tuv.cross_corr(torch.as_tensor(x), torch.as_tensor(y), num_lags),
           ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,offset", [(1, 0), (3, 0), (3, 2), (4, 1)])
def test_down_and_upsample_match_reference(dtype, n, offset):
    x = _gappy(2, 23, seed=n, dtype=dtype)[0]
    _close(tuv.downsample(torch.as_tensor(x), n, offset),
           juv.downsample(jnp.asarray(x), n, offset), dtype)
    for use_nan in (True, False):
        _close(tuv.upsample(torch.as_tensor(x), n, offset, use_nan),
               juv.upsample(jnp.asarray(x), n, offset, use_nan), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ratio", [1, 4, 7])
def test_resample_matches_reference(dtype, ratio):
    x = _gappy(3, 30, seed=ratio, dtype=dtype)
    _close(tuv.resample(torch.as_tensor(x[0]), ratio),
           juv.resample(jnp.asarray(x[0]), ratio), dtype)
    _close(tuv.resample(torch.as_tensor(x[1]), ratio, torch.nansum),
           juv.resample(jnp.asarray(x[1]), ratio, jnp.nansum), dtype)
    # a panel: windows along the last axis of every row
    ref = jax.vmap(lambda v: juv.resample(v, ratio, jnp.nanmax))(
        jnp.asarray(x))
    got = tuv.resample(torch.as_tensor(x), ratio,
                       lambda w, dim: torch.nan_to_num(
                           w, nan=-np.inf).amax(dim))
    _close(torch.where(torch.isinf(got), np.nan, got), ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("gap", [0.1, 0.4])
def test_fill_spline_matches_reference(dtype, gap):
    x = _gappy(7, 60, seed=int(gap * 10), dtype=dtype, gap=gap)
    x[2, :] = np.nan  # no knot
    x[3, :] = np.nan
    x[3, 30] = 1.5  # one knot
    x[4, 10:] = np.nan
    x[4, 20] = 2.0  # two knots, one gap between them
    ref = jax.jit(jax.vmap(juv.fill_spline))(jnp.asarray(x))
    _close(tuv.fill_spline(torch.as_tensor(x)), ref, dtype)
    _close(tuv.fill_spline(torch.as_tensor(x[5])), ref[5], dtype)


def test_fill_spline_matches_scipy_natural_spline():
    from scipy.interpolate import CubicSpline

    rng = np.random.default_rng(0)
    x = rng.normal(size=40)
    miss = [0, 3, 4, 10, 17, 18, 19, 30, 38, 39]  # edges stay NaN
    xm = x.copy()
    xm[miss] = np.nan
    got = tuv.fill_spline(torch.as_tensor(xm)).numpy()
    valid = ~np.isnan(xm)
    cs = CubicSpline(np.where(valid)[0], xm[valid], bc_type="natural")
    inner = [m for m in miss if 0 < m < 38]
    exp = xm.copy()
    exp[inner] = cs(np.array(inner, dtype=float))
    np.testing.assert_allclose(got, exp, rtol=1e-10, atol=1e-10)
    assert np.isnan(got[[0, 38, 39]]).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_fillts_and_batch_fill_spline_match_reference(dtype):
    x = _gappy(5, 40, seed=9, dtype=dtype)
    ref = jax.jit(jax.vmap(lambda v: juv.fillts(v, "spline")))(
        jnp.asarray(x))
    _close(tuv.fillts(torch.as_tensor(x), "spline"), ref, dtype)
    _close(tuv.batch_fill("spline")(torch.as_tensor(x)), ref, dtype)


def test_exports_match_reference():
    for name in ("pacf", "cross_corr", "fill_spline", "trim_leading",
                 "trim_trailing", "downsample", "upsample", "resample"):
        assert name in tuv.__all__ and name in juv.__all__ + ["pacf"]
    assert set(juv.__all__) <= set(tuv.__all__)
