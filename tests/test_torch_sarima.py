"""The port's seasonal ARIMA against the JAX package.

The expansion of the seasonal polynomials, ``seasonal_lag_span`` and the
concentrated likelihood ``sarima_neg_loglik`` (value and gradient) are held
against the reference at s = 4, 12 and 24, the airline model
(0,1,1)(0,1,1,s) and (1,0,1)(1,1,1,s) among them: 1e-10 relative in
float64, 1e-5 in float32.  The cuda backend's objective (expanded rows
through the CSS kernels' wrappers, which run their plain versions on CPU
tensors) is held against the eager objective at 1e-5.  Fits of 128 rows
drawn from the fitted model are held at the reference's distribution bar
(converged shares within 0.02, median parameter difference under 1e-2,
statuses equal row for row), and the reference's refusals raise the same
errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu.models import arima as jarima
from spark_timeseries_tpu_torch.models import arima as tarima
from spark_timeseries_tpu_torch.models import base as tbase
from spark_timeseries_tpu_torch.ops import cuda_kernels as ck
from spark_timeseries_tpu_torch.ops import layout

TOL = {np.float64: 1e-10, np.float32: 1e-5}
DTYPES = [np.float64, np.float32]
SPECS = [((0, 1, 1), (0, 1, 1)), ((1, 0, 1), (1, 1, 1)),
         ((2, 0, 0), (1, 0, 0)), ((0, 0, 2), (0, 0, 2))]


def _close(got, ref, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [4, 12, 24])
@pytest.mark.parametrize("p,P", [(0, 1), (1, 1), (2, 2), (3, 0), (0, 0)])
def test_expand_seasonal_poly_matches_reference(dtype, s, p, P):
    rng = np.random.default_rng(s * 10 + p + P)
    vals = rng.normal(size=(5, p)).astype(dtype)
    svals = rng.normal(size=(5, P)).astype(dtype)
    for cross in (-1.0, 1.0):
        ref = jax.vmap(lambda a, b: jarima._expand_seasonal_poly(
            a, b, s, cross))(jnp.asarray(vals), jnp.asarray(svals))
        got = tarima._expand_seasonal_poly(torch.as_tensor(vals),
                                           torch.as_tensor(svals), s, cross)
        assert got.shape == ref.shape
        _close(got, ref, TOL[dtype])


@pytest.mark.parametrize("order,seasonal", [
    ((1, 1, 1), None), ((0, 1, 1), (0, 1, 1, 24)), ((1, 0, 1), (1, 1, 1, 12)),
    ((2, 1, 0), (2, 2, 1, 4))])
def test_seasonal_lag_span_and_splits_match_reference(order, seasonal):
    assert tarima.seasonal_lag_span(order, seasonal) == \
        jarima.seasonal_lag_span(order, seasonal)
    if seasonal is None:
        return
    for icpt in (True, False):
        k = jarima._n_params_seasonal(order, seasonal, icpt)
        assert tarima._n_params_seasonal(order, seasonal, icpt) == k
        pr = np.arange(k, dtype=np.float64)
        for a, b in zip(tarima._split_params_seasonal(
                torch.as_tensor(pr), order, seasonal, icpt),
                jarima._split_params_seasonal(jnp.asarray(pr), order,
                                              seasonal, icpt)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("bad", [(1, 0, 0), (1, 0, 0, 1), (-1, 0, 1, 4),
                                 "abc"])
def test_validate_seasonal_matches_reference(bad):
    with pytest.raises(ValueError):
        jarima._validate_seasonal(bad)
    with pytest.raises(ValueError):
        tarima._validate_seasonal(bad)
    assert tarima._validate_seasonal((0, 0, 0, 12)) is None
    assert tarima._validate_seasonal([1, 1, 1, 12]) == (1, 1, 1, 12)


def _panel(b, t, seed, dtype):
    rng = np.random.default_rng(seed)
    yd = rng.normal(size=(b, t)).astype(dtype)
    nv = np.full(b, t, np.int32)
    nv[1] = t - 13  # a right-aligned series: its prefix is masked
    return yd, nv


def _params(order, seasonal, b, seed, dtype):
    k = jarima._n_params_seasonal(order, seasonal, True)
    rng = np.random.default_rng(seed)
    return (0.3 * rng.uniform(-1, 1, size=(b, k))).astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [4, 12, 24])
@pytest.mark.parametrize("order,sea", SPECS[:2])
def test_sarima_neg_loglik_value_and_grad_match_reference(dtype, s, order,
                                                          sea):
    seasonal = (sea[0], sea[1], sea[2], s)
    t = 3 * s + 40
    yd, nv = _panel(4, t, seed=s, dtype=dtype)
    pr = _params(order, seasonal, 4, seed=s + 1, dtype=dtype)
    ref_v, ref_g = jax.vmap(jax.value_and_grad(
        lambda a, v, n: jarima.sarima_neg_loglik(a, v, order, seasonal, True,
                                                 n)))(
        jnp.asarray(pr), jnp.asarray(yd), jnp.asarray(nv))
    pt = torch.as_tensor(pr).requires_grad_(True)
    got = tarima.sarima_neg_loglik(pt, torch.as_tensor(yd), order, seasonal,
                                   True, torch.as_tensor(nv))
    (g,) = torch.autograd.grad(got.sum(), pt)
    _close(got, ref_v, TOL[dtype])
    _close(g, ref_g, TOL[dtype])


@pytest.mark.parametrize("s", [4, 12, 24])
@pytest.mark.parametrize("order,sea", SPECS)
def test_kernel_route_objective_matches_eager(s, order, sea):
    # the cuda backend's objective through the kernels' plain versions
    seasonal = (sea[0], sea[1], sea[2], s)
    p_full, q_full, _ = tarima.seasonal_lag_span(order, seasonal)
    t = 2 * s + 60
    yd, nv = _panel(6, t, seed=s + 7, dtype=np.float32)
    yd, nv = torch.as_tensor(yd), torch.as_tensor(nv)
    pr = torch.as_tensor(_params(order, seasonal, 6, s + 8, np.float32))
    yt, zb = layout.css_prefold(yd, (p_full, 0, q_full), nv)
    pk = pr.clone().requires_grad_(True)
    kp = tarima._sarima_kernel_params(pk, order, seasonal, True)
    got = ck.css_neg_loglik_folded(kp, yt, zb, t, (p_full, 0, q_full), True,
                                   nv)
    (g_k,) = torch.autograd.grad(got.sum(), pk)
    pe = pr.clone().requires_grad_(True)
    ref = tarima.sarima_neg_loglik(pe, yd, order, seasonal, True, nv)
    (g_e,) = torch.autograd.grad(ref.sum(), pe)
    _close(got, ref.detach(), 1e-5)
    _close(g_k, g_e, 1e-5)


def _sarima_panel(b, t, order, seasonal, seed):
    """Series drawn from the model itself: ARMA on the expanded lag
    polynomials (phi 0.5, theta 0.4, PHI 0.3, THETA 0.5), integrated D
    times at lag s and d times at lag 1."""
    p, d, q = order
    P, D, Q, s = seasonal
    ar = np.convolve(np.r_[1.0, -0.5 * np.ones(p)],
                     np.r_[1.0, np.zeros(max(P * s, 1) - 1),
                           -0.3 * np.ones(P)] if P else [1.0])
    ma = np.convolve(np.r_[1.0, 0.4 * np.ones(q)],
                     np.r_[1.0, np.zeros(max(Q * s, 1) - 1),
                           0.5 * np.ones(Q)] if Q else [1.0])
    rng = np.random.default_rng(seed)
    burn = 50
    e = rng.normal(size=(b, t + burn))
    x = np.zeros_like(e)
    for i in range(t + burn):
        acc = e[:, i].copy()
        for j in range(1, len(ar)):
            if i >= j:
                acc -= ar[j] * x[:, i - j]
        for j in range(1, len(ma)):
            if i >= j:
                acc += ma[j] * e[:, i - j]
        x[:, i] = acc
    y = x[:, burn:]
    for _ in range(D):
        for i in range(s, t):
            y[:, i] += y[:, i - s]
    for _ in range(d):
        y = np.cumsum(y, axis=1)
    return y.astype(np.float32)


def _dist_parity(ref, got, conv_floor=0.8):
    conv_r = np.asarray(ref.converged)
    conv_g = got.converged.numpy()
    assert abs(conv_r.mean() - conv_g.mean()) <= 0.02
    both = conv_r & conv_g
    assert both.mean() > conv_floor
    med = float(np.median(np.abs(np.asarray(ref.params)[both]
                                 - got.params.numpy()[both])))
    assert med < 1e-2
    nll_r = np.asarray(ref.neg_log_likelihood)[both]
    nll_g = got.neg_log_likelihood.numpy()[both]
    assert float(np.percentile(np.abs(nll_r - nll_g)
                               / np.maximum(np.abs(nll_r), 1e-6), 99)) < 1e-2


FIT_CASES = [((1, 0, 0), (0, 1, 1, 4)), ((0, 1, 1), (0, 1, 1, 4)),
             ((1, 0, 1), (1, 1, 0, 4))]


@pytest.fixture(scope="module")
def panels():
    out = {}
    for i, (order, seasonal) in enumerate(FIT_CASES):
        y = _sarima_panel(128, 120, order, seasonal, seed=3 + i)
        y[0, :9] = np.nan  # ragged start
        y[5, 110:] = np.nan  # trailing NaNs
        out[(order, seasonal)] = y
    return out


@pytest.fixture(scope="module")
def jax_seasonal_fits(panels):
    return {case: jarima.fit(jnp.asarray(y), case[0], seasonal=case[1])
            for case, y in panels.items()}


@pytest.mark.parametrize("case", FIT_CASES)
@pytest.mark.parametrize("path", ["eager", "kernel"])
def test_seasonal_fit_matches_reference(panels, jax_seasonal_fits, case,
                                        path):
    order, seasonal = case
    y = panels[case]
    ref = jax_seasonal_fits[case]
    if path == "eager":
        got = tarima.fit(y, order, seasonal=seasonal, device="cpu")
    else:
        yb = torch.as_tensor(y)
        with torch.no_grad():
            got = tarima._fit_sarima(yb, order, seasonal, True, "cuda", 60,
                                     1e-4, None,
                                     tbase.align_mode_on_host(yb), True)
    k = jarima._n_params_seasonal(order, seasonal, True)
    assert tuple(got.params.shape) == (128, k)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    _dist_parity(ref, got)


def test_seasonal_fit_with_compaction_matches_without(monkeypatch):
    y = _sarima_panel(1024, 60, (1, 0, 0), (0, 1, 1, 4), seed=9)
    run = lambda: tarima.fit(y, (1, 0, 0), seasonal=(0, 1, 1, 4),  # noqa
                             max_iters=25, device="cpu")
    ref = run()
    monkeypatch.setattr(tarima, "_COMPACT_MIN_BATCH", 1024)
    monkeypatch.setattr(tarima.optim, "compaction_cap", lambda b: 256)
    got = run()
    np.testing.assert_array_equal(got.status.numpy(), ref.status.numpy())
    both = (ref.converged & got.converged).numpy()
    assert both.mean() > 0.9
    assert float(np.median(np.abs(ref.params.numpy()[both]
                                  - got.params.numpy()[both]))) < 1e-3


def test_seasonal_fit_single_series_and_init_params(panels):
    order, seasonal = FIT_CASES[0]
    y = panels[FIT_CASES[0]][:4]
    rb = tarima.fit(y, order, seasonal=seasonal, device="cpu")
    r1 = tarima.fit(y[2], order, seasonal=seasonal, device="cpu")
    assert tuple(r1.params.shape) == (3,)  # [c, phi, THETA]
    np.testing.assert_allclose(r1.params.numpy(), rb.params[2].numpy(),
                               rtol=1e-3, atol=1e-3)
    init = rb.params[2].numpy()
    ref = jarima.fit(jnp.asarray(y), order, seasonal=seasonal,
                     init_params=jnp.asarray(init))
    got = tarima.fit(y, order, seasonal=seasonal, init_params=init,
                     device="cpu")
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    np.testing.assert_allclose(got.params.numpy(), np.asarray(ref.params),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("kwargs", [dict(method="hannan-rissanen"),
                                    dict(count_evals=True)])
def test_seasonal_refusals_match_reference(kwargs):
    y = _sarima_panel(2, 60, (1, 0, 0), (0, 1, 1, 4), seed=1)
    with pytest.raises(ValueError):
        jarima.fit(jnp.asarray(y), (1, 0, 0), seasonal=(0, 1, 1, 4),
                   **kwargs)
    with pytest.raises(ValueError):
        tarima.fit(y, (1, 0, 0), seasonal=(0, 1, 1, 4), device="cpu",
                   **kwargs)


def test_too_short_series_is_refused_as_in_the_reference():
    y = _sarima_panel(2, 27, (1, 0, 0), (0, 1, 1, 4), seed=2)
    with pytest.raises(ValueError, match="too short"):
        jarima.fit(jnp.asarray(y), (1, 0, 1), seasonal=(1, 1, 1, 12))
    with pytest.raises(ValueError, match="too short"):
        tarima.fit(y, (1, 0, 1), seasonal=(1, 1, 1, 12), device="cpu")


def test_all_zero_seasonal_is_the_plain_fit(panels):
    y = panels[FIT_CASES[1]][:8]
    a = tarima.fit(y, (1, 1, 1), seasonal=(0, 0, 0, 12), max_iters=20,
                   device="cpu")
    b = tarima.fit(y, (1, 1, 1), max_iters=20, device="cpu")
    np.testing.assert_array_equal(a.params.numpy(), b.params.numpy())
