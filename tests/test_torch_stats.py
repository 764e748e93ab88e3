"""The port's statistical tests (``stats.tests``) against the JAX package.

Every test and every ``batch_*`` wrapper runs on the same numpy inputs in
both packages (the reference's single-series tests under ``jax.vmap`` for a
panel): 1e-10 relative in float64; in float32 1e-4 relative on the
statistics (the auxiliary regressions sum a few hundred products in
another order than the reference's matrix products) and 1e-4 absolute on
the p-values that follow from them.  Ragged rows (leading and trailing
NaNs, interior gaps) give the statistics of their trimmed series, as the
reference's tests require, and the quantile tables are the reference's,
equal entry for entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu.stats import _tables as jtables
from spark_timeseries_tpu.stats import tests as jst
from spark_timeseries_tpu_torch.stats import _tables as ttables
from spark_timeseries_tpu_torch.stats import tests as tst

DTYPES = [np.float64, np.float32]
STAT_TOL = {np.float64: 1e-10, np.float32: 1e-4}
P_TOL = {np.float64: 1e-10, np.float32: 1e-4}


def _close(got, ref, rtol, atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref, np.float64), rtol=rtol,
                               atol=atol)


def _pair(got, ref, dtype):
    _close(got[0], ref[0], STAT_TOL[dtype], STAT_TOL[dtype])
    _close(got[1], ref[1], P_TOL[dtype], P_TOL[dtype])


def _walks(b, t, seed, dtype, ragged=True):
    """Random walks (rows 0-2) and AR(1) rows; row 0 starts late, row 1
    ends early, row 3 has interior gaps."""
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(b, t))
    y = np.cumsum(e, axis=1)
    for i in range(3, b):
        for j in range(1, t):
            y[i, j] = 0.5 * y[i, j - 1] + e[i, j]
    if ragged:
        y[0, :17] = np.nan
        y[1, -9:] = np.nan
        y[3, [20, 21, 40]] = np.nan
    return y.astype(dtype)


def test_tables_equal_the_reference():
    names = [n for n in vars(jtables) if n.isupper()]
    assert names == [n for n in vars(ttables) if n.isupper()]
    for n in names:
        a, b = getattr(ttables, n), getattr(jtables, n)
        if isinstance(b, dict):
            assert a.keys() == b.keys()
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(a, b)


def test_chi2_sf_matches_reference():
    x = np.array([0.0, 0.1, 1.0, 3.84, 10.0, 50.0])
    for df in (1.0, 2.0, 5.0, 10.0):
        _close(tst.chi2_sf(torch.as_tensor(x), df),
               jst.chi2_sf(jnp.asarray(x), df), 1e-10, 1e-14)


@pytest.mark.parametrize("table,upper", [("DF_TAU", False),
                                         ("KPSS_ETA", True)])
def test_table_pvalue_matches_reference(table, upper):
    rng = np.random.default_rng(1)
    for kind, rows in getattr(jtables, table).items():
        stat = np.r_[rng.uniform(rows.min() - 1, rows.max() + 1, 40),
                     rows.min() - 5, rows.max() + 5]
        n_eff = np.r_[rng.uniform(5, 5000, 40), 3.0, 1e5]
        ref = jax.vmap(lambda s_, n_: jst._table_pvalue(s_, n_, rows,
                                                        upper))(
            jnp.asarray(stat), jnp.asarray(n_eff))
        got = tst._table_pvalue(torch.as_tensor(stat),
                                torch.as_tensor(n_eff), rows, upper)
        _close(got, ref, 1e-10, 1e-12)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("max_lag", [0, 1, 3])
@pytest.mark.parametrize("regression", ["nc", "c", "ct"])
def test_adf_matches_reference(dtype, max_lag, regression):
    y = _walks(6, 150, seed=max_lag, dtype=dtype)
    ref = jax.vmap(lambda v: jst.adftest(v, max_lag, regression))(
        jnp.asarray(y))
    _pair(tst.batch_adftest(y, max_lag, regression, device="cpu"), ref,
          dtype)
    _pair(tst.adftest(y[4], max_lag, regression, device="cpu"),
          (ref[0][4], ref[1][4]), dtype)
    _pair(jst.batch_adftest(jnp.asarray(y), max_lag, regression), ref,
          dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_dw_and_lb_match_reference(dtype):
    e = _walks(6, 120, seed=5, dtype=dtype)
    e = np.diff(e, axis=1)
    _close(tst.batch_dwtest(e, device="cpu"),
           jst.batch_dwtest(jnp.asarray(e)), STAT_TOL[dtype])
    _close(tst.dwtest(e[2], device="cpu"), jst.dwtest(jnp.asarray(e[2])),
           STAT_TOL[dtype])
    for lag in (1, 5, 10):
        _pair(tst.batch_lbtest(e, lag, device="cpu"),
              jst.batch_lbtest(jnp.asarray(e), lag), dtype)
        _pair(tst.lbtest(e[3], lag, device="cpu"),
              jst.lbtest(jnp.asarray(e[3]), lag), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("regression", ["c", "ct"])
@pytest.mark.parametrize("lags", [None, 4])
def test_kpss_matches_reference(dtype, regression, lags):
    y = _walks(6, 160, seed=7, dtype=dtype)
    _pair(tst.batch_kpsstest(y, regression, lags, device="cpu"),
          jst.batch_kpsstest(jnp.asarray(y), regression, lags), dtype)
    _pair(tst.kpsstest(y[5], regression, lags, device="cpu"),
          jst.kpsstest(jnp.asarray(y[5]), regression, lags), dtype)


def _regression_inputs(b, n, k, seed, dtype):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(b, n, k))
    u = rng.normal(size=(b, n))
    e = u.copy()
    e[:, 1:] += 0.5 * u[:, :-1]  # serially correlated
    e *= 1.0 + 0.5 * np.abs(X[..., 0])  # heteroskedastic
    e[0, :12] = np.nan
    X[1, -5:, 0] = np.nan
    return e.astype(dtype), X.astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("max_lag", [1, 3])
def test_bg_and_bp_match_reference(dtype, k, max_lag):
    e, X = _regression_inputs(5, 140, k, seed=k + max_lag, dtype=dtype)
    # per-series factors
    _pair(tst.batch_bgtest(e, X, max_lag, device="cpu"),
          jst.batch_bgtest(jnp.asarray(e), jnp.asarray(X), max_lag), dtype)
    _pair(tst.batch_bptest(e, X, device="cpu"),
          jst.batch_bptest(jnp.asarray(e), jnp.asarray(X)), dtype)
    # factors shared by every row
    _pair(tst.batch_bgtest(e, X[2], max_lag, device="cpu"),
          jst.batch_bgtest(jnp.asarray(e), jnp.asarray(X[2]), max_lag),
          dtype)
    _pair(tst.batch_bptest(e, X[2], device="cpu"),
          jst.batch_bptest(jnp.asarray(e), jnp.asarray(X[2])), dtype)
    # one series, with one factor as a vector
    _pair(tst.bgtest(e[0], X[0, :, 0], max_lag, device="cpu"),
          jst.bgtest(jnp.asarray(e[0]), jnp.asarray(X[0, :, 0]), max_lag),
          dtype)
    _pair(tst.bptest(e[1], X[1], device="cpu"),
          jst.bptest(jnp.asarray(e[1]), jnp.asarray(X[1])), dtype)


class TestRaggedMatchesTrimmed:
    """A ragged row gives its trimmed series' statistics (the reference's
    own bars, ``tests/test_stats.py``), batched as one by one."""

    def _walk(self, n, seed=0):
        return np.cumsum(np.random.default_rng(seed).normal(size=n))

    def test_adf(self):
        y = self._walk(240, seed=1)
        ypad = np.full(300, np.nan)
        ypad[40:280] = y
        panel = np.stack([ypad, np.r_[y, [np.nan] * 60]])
        tau_t, p_t = tst.adftest(y, device="cpu")
        taus, ps = tst.batch_adftest(panel, device="cpu")
        _close(taus, [float(tau_t)] * 2, 1e-5)
        _close(ps, [float(p_t)] * 2, 1e-4, 1e-4)

    def test_adf_ct(self):
        y = self._walk(200, seed=2)
        ypad = np.concatenate([[np.nan] * 30, y, [np.nan] * 10])
        tau_t, _ = tst.adftest(y, regression="ct", device="cpu")
        tau_p, _ = tst.adftest(ypad, regression="ct", device="cpu")
        _close(tau_p, float(tau_t), 1e-3)

    def test_dw_lb_kpss(self):
        e = np.random.default_rng(3).normal(size=150)
        epad = np.concatenate([[np.nan] * 20, e, [np.nan] * 5])
        panel = np.stack([epad, np.r_[e, [np.nan] * 25]])
        _close(tst.batch_dwtest(panel, device="cpu"),
               [float(tst.dwtest(e, device="cpu"))] * 2, 1e-6)
        q_t, p_t = tst.lbtest(e, 5, device="cpu")
        qs, ps = tst.batch_lbtest(panel, 5, device="cpu")
        _close(qs, [float(q_t)] * 2, 1e-6)
        _close(ps, [float(p_t)] * 2, 1e-5)
        lags = tst.np_trunc_bandwidth(150)
        assert lags == jst.np_trunc_bandwidth(150)
        eta_t, p_t = tst.kpsstest(e, lags=lags, device="cpu")
        etas, ps = tst.batch_kpsstest(panel, lags=lags, device="cpu")
        _close(etas, [float(eta_t)] * 2, 1e-6)
        _close(ps, [float(p_t)] * 2, 1e-4, 1e-3)

    def test_bg_bp(self):
        rng = np.random.default_rng(6)
        n = 160
        x = rng.normal(size=n)
        e = 0.6 * np.concatenate([[0], x[:-1]]) + rng.normal(size=n)
        epad = np.concatenate([[np.nan] * 12, e])
        xpad = np.concatenate([[np.nan] * 12, x])
        s_t, _ = tst.bgtest(e, x, 2, device="cpu")
        s_p, _ = tst.bgtest(epad, xpad, 2, device="cpu")
        _close(s_p, float(s_t), 1e-5)
        s_t, _ = tst.bptest(e, x, device="cpu")
        s_p, _ = tst.bptest(epad, xpad, device="cpu")
        _close(s_p, float(s_t), 1e-5)

    def test_batch_adf_ragged_no_nans_out(self):
        rng = np.random.default_rng(7)
        panel = np.cumsum(rng.normal(size=(5, 120)), axis=1)
        panel[0, :20] = np.nan
        panel[2, 100:] = np.nan
        taus, ps = tst.batch_adftest(panel, device="cpu")
        assert torch.isfinite(taus).all() and torch.isfinite(ps).all()


def test_argument_errors_match_reference():
    y = np.zeros(50)
    for bad in (lambda m: m.adftest(y, regression="x"),
                lambda m: m.kpsstest(y, regression="nc")):
        with pytest.raises(ValueError):
            bad(jst)
        with pytest.raises(ValueError):
            bad(tst)


def test_tests_run_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this check is for a host without a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        tst.adftest(np.zeros(50))
    with pytest.raises(RuntimeError, match="cuda"):
        tst.batch_lbtest(np.zeros((2, 50)))
