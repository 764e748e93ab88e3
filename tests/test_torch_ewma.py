"""The PyTorch port's EWMA (simple exponential smoothing, ``models.ewma``)
against the JAX package.

The public entry points run with ``device="cpu"`` (the ``eager`` backend).
The ``cuda`` backend's driver (time-major layout, the one-step SSE as an
autograd function over the forward and adjoint kernels) also runs on the
CPU through ``ewma._fit_ewma`` / ``ewma._forecast``, where each kernel
wrapper uses its plain version; ``chip_smoke.py`` runs the same driver on
the card.  Inputs are float32 numpy arrays handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu.models import ewma as jewma
from spark_timeseries_tpu_torch.convert import from_jax_params
from spark_timeseries_tpu_torch.models import base as tbase
from spark_timeseries_tpu_torch.models import ewma as tewma
from spark_timeseries_tpu_torch.reliability import FitStatus


def _panel(b, t, seed):
    """Random-walk level plus noise (an interior optimal alpha), ragged:
    row 1 starts late, row 2 ends early, row 3 has 2 valid steps (too short
    to fit), row 4 is all NaN."""
    rng = np.random.default_rng(seed)
    level = np.cumsum(rng.normal(scale=0.3, size=(b, t)), axis=1)
    x = (level + rng.normal(size=(b, t))).astype(np.float32)
    x[1, :13] = np.nan
    x[2, t - 9:] = np.nan
    x[3, :t - 2] = np.nan
    x[4] = np.nan
    return x


def _kernel_fit(y, max_iters=40):
    """The fit driver's cuda backend on a CPU tensor (plain kernels)."""
    yb = torch.as_tensor(y)
    with torch.no_grad():
        return tewma._fit_ewma(yb, max_iters, 1e-4, "cuda",
                               tbase.align_mode_on_host(yb))


@pytest.fixture(scope="module")
def panel():
    return _panel(10, 90, seed=22)


@pytest.fixture(scope="module")
def jax_fit(panel):
    return jewma.fit(jnp.asarray(panel), backend="scan")


@pytest.mark.parametrize("ragged", [False, True])
def test_smooth_and_sse_match_reference(ragged):
    rng = np.random.default_rng(1)
    b, t = 5, 61
    x = rng.normal(size=(b, t)).astype(np.float32)
    alpha = rng.uniform(0.1, 0.9, b).astype(np.float32)
    nv = np.array([t, t - 6, t, t - 11, t - 1], np.int32) if ragged else None
    if ragged:
        x = np.where(np.arange(t)[None, :] >= (t - nv)[:, None], x,
                     0.0).astype(np.float32)
        ref_s = np.stack([np.asarray(jewma.smooth(alpha[i], jnp.asarray(x[i]),
                                                  nv[i])) for i in range(b)])
        ref_e = np.array([float(jewma.sse(alpha[i], jnp.asarray(x[i]),
                                          nv[i])) for i in range(b)])
    else:
        ref_s = np.stack([np.asarray(jewma.smooth(alpha[i], jnp.asarray(x[i])))
                          for i in range(b)])
        ref_e = np.array([float(jewma.sse(alpha[i], jnp.asarray(x[i])))
                          for i in range(b)])
    tnv = None if nv is None else torch.as_tensor(nv)
    s = tewma.smooth(torch.as_tensor(alpha), torch.as_tensor(x), tnv)
    e = tewma.sse(torch.as_tensor(alpha), torch.as_tensor(x), tnv)
    np.testing.assert_allclose(s.numpy(), ref_s, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(e.numpy(), ref_e, rtol=2e-5, atol=2e-5)


def test_unsmooth_roundtrip_and_alpha_zero_guard():
    x = np.array([1.0, 3.0, 2.0, 5.0, 4.5], np.float32)
    s = tewma.smooth(0.4, torch.as_tensor(x))
    np.testing.assert_allclose(s.numpy(), np.asarray(
        jewma.smooth(0.4, jnp.asarray(x))), rtol=1e-6)
    np.testing.assert_allclose(tewma.unsmooth(0.4, s).numpy(), x, atol=1e-5)
    out = tewma.unsmooth(0.0, torch.ones(4)).numpy()
    ref = np.asarray(jewma.unsmooth(0.0, jnp.ones(4, jnp.float32)))
    assert out[0] == 1.0 and np.isnan(out[1:]).all()
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))


@pytest.mark.parametrize("path", ["eager", "kernel"])
def test_fit_matches_reference(panel, jax_fit, path):
    got = (tewma.fit(panel, device="cpu") if path == "eager"
           else _kernel_fit(panel))
    ref = jax_fit
    assert got.params.shape == (10, 1)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    assert got.status[3] == FitStatus.EXCLUDED  # 2 valid steps
    assert got.status[4] == FitStatus.EXCLUDED  # all NaN
    assert np.isnan(got.params[3].numpy()).all()
    ok = np.asarray(ref.status) == FitStatus.OK
    # the reference's own bar between its kernel and scan backends
    np.testing.assert_allclose(got.params.numpy()[ok],
                               np.asarray(ref.params)[ok], rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(got.neg_log_likelihood.numpy()[ok],
                               np.asarray(ref.neg_log_likelihood)[ok],
                               rtol=1e-4)


def test_fitted_alpha_minimizes_sse():
    x = _panel(5, 400, seed=6)[0]
    res = tewma.fit(x, device="cpu")
    a_star = float(res.params[0])
    assert 0.0 < a_star < 1.0
    xt = torch.as_tensor(x)
    sse_star = float(tewma.sse(a_star, xt))
    for a in (0.05, 0.2, 0.5, 0.8, 0.95):
        assert sse_star <= float(tewma.sse(a, xt)) + 1e-3


@pytest.mark.parametrize("path", ["eager", "kernel"])
def test_forecast_matches_reference_with_nan_gates(panel, jax_fit, path):
    params = np.array(jax_fit.params)
    params[5] = np.nan  # a failed fit forecasts NaN
    ref = np.asarray(jewma.forecast(jnp.asarray(params), jnp.asarray(panel),
                                    7))
    if path == "eager":
        got = tewma.forecast(params, panel, 7, device="cpu").numpy()
    else:
        got = tewma._forecast(torch.as_tensor(params), torch.as_tensor(panel),
                              7, "cuda").numpy()
    assert got.shape == (10, 7)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    assert not np.isfinite(got[[4, 5]]).any()  # empty span, NaN params
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert (got[:, 0][np.isfinite(got[:, 0])]
            == got[:, -1][np.isfinite(got[:, -1])]).all()


def test_single_series_fit_and_forecast():
    x = _panel(5, 120, seed=8)[0]
    got = tewma.fit(x, device="cpu")
    ref = jewma.fit(jnp.asarray(x), backend="scan")
    assert got.params.shape == (1,)
    np.testing.assert_allclose(got.params.numpy(), np.asarray(ref.params),
                               rtol=1e-3, atol=1e-3)
    fc = tewma.forecast(got.params, x, 5, device="cpu")
    assert fc.shape == (5,)
    np.testing.assert_allclose(fc.numpy(), np.asarray(jewma.forecast(
        jnp.asarray(got.params.numpy()), jnp.asarray(x), 5)), rtol=1e-5)


def test_time_dependent_effects_match_reference():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(3, 50)).astype(np.float32)
    params = np.array([[0.3], [0.7], [0.05]], np.float32)
    ref_s = np.asarray(jewma.add_time_dependent_effects(jnp.asarray(params),
                                                        jnp.asarray(x)))
    s = tewma.add_time_dependent_effects(params, x, device="cpu")
    np.testing.assert_allclose(s.numpy(), ref_s, rtol=1e-5, atol=1e-6)
    back = tewma.remove_time_dependent_effects(params, s, device="cpu")
    np.testing.assert_allclose(back.numpy(), np.asarray(
        jewma.remove_time_dependent_effects(jnp.asarray(params),
                                            jnp.asarray(ref_s))),
        rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-3, atol=1e-4)
    one = tewma.add_time_dependent_effects(params[0], x[0], device="cpu")
    np.testing.assert_allclose(one.numpy(), ref_s[0], rtol=1e-5, atol=1e-6)


def test_from_jax_params_forecasts_like_the_reference(panel, jax_fit):
    carried = from_jax_params(np.asarray(jax_fit.params), device="cpu",
                              status=np.asarray(jax_fit.status))
    assert carried.params.shape == (10, 1)
    ref = np.asarray(jewma.forecast(jax_fit.params, jnp.asarray(panel), 4))
    got = tewma.forecast(carried.params, panel, 4, device="cpu").numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_fit_rejects_bad_arguments():
    x = np.zeros((2, 30), np.float32)
    with pytest.raises(ValueError, match="unknown backend"):
        tewma.fit(x, backend="scan", device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tewma.fit(x, backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="align_mode"):
        tewma.fit(x, align_mode="bogus", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tewma.fit(x)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tewma.forecast(np.zeros((2, 1), np.float32), x, 3)
