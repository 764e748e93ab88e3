"""The PyTorch port's volatility slice (``models.garch``) against the JAX
package, and the volatility pipeline as a whole.

The public entry points run with ``device="cpu"`` (the ``eager`` backend).
The ``cuda`` backend's driver (time-major layout, GARCH likelihood as an
autograd function over the forward and adjoint kernels, column gather for
stragglers) also runs on the CPU through ``garch._fit_garch`` /
``_fit_argarch`` / ``_forecast``, where each kernel wrapper uses its plain
version; ``chip_smoke.py`` runs the same driver on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu.models import garch as jgarch
from spark_timeseries_tpu.ops import univariate as juv
from spark_timeseries_tpu_torch import entry as tentry
from spark_timeseries_tpu_torch.convert import from_jax_params
from spark_timeseries_tpu_torch.models import base as tbase
from spark_timeseries_tpu_torch.models import garch as tgarch
from spark_timeseries_tpu_torch.ops import univariate as tuv
from spark_timeseries_tpu_torch.reliability import FitStatus
from spark_timeseries_tpu_torch.utils import optim as toptim


def _garch_panel(b, t, seed, params=(0.05, 0.1, 0.8)):
    """Ragged GARCH(1,1) returns drawn by the reference's own sampler:
    row 0 starts late, row 1 ends early, row 2 has 5 valid steps (too
    short to fit), row 3 is all NaN, row 4 has an interior gap."""
    pars = jnp.asarray(np.tile([params], (b, 1)), jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed), b)
    r = np.array(jax.vmap(lambda pr, k: jgarch.sample(pr, k, t))(pars, keys),
                 np.float32)
    r[0, :40] = np.nan
    r[1, t - 50:] = np.nan
    r[2, :t - 5] = np.nan
    r[3, :] = np.nan
    r[4, 100:104] = np.nan
    return r


def _kernel_fit(fit_fn, y, max_iters, compact=True):
    """A fit driver's cuda backend on a CPU tensor (plain kernels)."""
    yb = torch.as_tensor(y)
    with torch.no_grad():
        return fit_fn(yb, max_iters, 1e-4, "cuda",
                      tbase.align_mode_on_host(yb), compact)


def _dist_parity(ref, got, med_tol=1e-2):
    """Slice 1's distribution-level bar: converged shares within 0.02 and
    the median parameter difference over rows both converged under 1e-2."""
    conv_r = np.asarray(ref.converged)
    conv_g = got.converged.numpy()
    assert abs(conv_r.mean() - conv_g.mean()) < 0.02
    both = conv_r & conv_g
    assert both.mean() > 0.5
    diff = np.abs(np.asarray(ref.params)[both] - got.params.numpy()[both])
    assert float(np.median(diff)) < med_tol


@pytest.fixture(scope="module")
def panel():
    return _garch_panel(24, 300, seed=3)


@pytest.fixture(scope="module")
def jax_fits(panel):
    y = jnp.asarray(panel)
    return {
        "garch": jgarch.fit(y, backend="pallas-interpret", max_iters=60),
        "argarch": jgarch.fit_argarch(y, backend="pallas-interpret",
                                      max_iters=60),
    }


@pytest.mark.parametrize("path", ["eager", "kernel"])
def test_garch_fit_matches_reference(panel, jax_fits, path):
    ref = jax_fits["garch"]
    if path == "eager":
        got = tgarch.fit(panel, max_iters=60, device="cpu")
    else:
        got = _kernel_fit(tgarch._fit_garch, panel, 60)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    assert got.status[2] == FitStatus.EXCLUDED  # 5 valid steps
    assert got.status[3] == FitStatus.EXCLUDED  # all NaN
    assert np.isnan(got.params[2].numpy()).all()
    _dist_parity(ref, got)
    ok = np.asarray(ref.converged) & got.converged.numpy()
    np.testing.assert_allclose(got.neg_log_likelihood.numpy()[ok],
                               np.asarray(ref.neg_log_likelihood)[ok],
                               rtol=1e-4)


@pytest.mark.parametrize("path", ["eager", "kernel"])
def test_argarch_fit_matches_reference(panel, jax_fits, path):
    ref = jax_fits["argarch"]
    if path == "eager":
        got = tgarch.fit_argarch(panel, max_iters=60, device="cpu")
    else:
        got = _kernel_fit(tgarch._fit_argarch, panel, 60)
    assert got.params.shape == (24, 5)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    _dist_parity(ref, got)


def test_fit_single_series_and_short_gate():
    r = _garch_panel(5, 120, seed=4)[4]
    got = tgarch.fit(r, max_iters=40, device="cpu")
    ref = jgarch.fit(jnp.asarray(r), backend="scan", max_iters=40)
    assert got.params.shape == (3,)
    np.testing.assert_allclose(got.params.numpy(), np.asarray(ref.params),
                               rtol=1e-2, atol=1e-3)
    # 9 valid observations: GARCH's gate is 10, ARGARCH's 12
    short = np.full(30, np.nan, np.float32)
    short[-9:] = r[:9]
    assert tgarch.fit(short, device="cpu").status == FitStatus.EXCLUDED
    assert tgarch.fit_argarch(short, device="cpu").status \
        == FitStatus.EXCLUDED


@pytest.mark.parametrize("path", ["eager", "kernel"])
def test_forecast_matches_reference_with_nan_gates(panel, jax_fits, path):
    params = np.array(jax_fits["garch"].params)
    params[5] = np.nan  # a failed fit forecasts NaN
    r = panel.copy()
    r[6, :-1] = np.nan  # one valid observation: below the gate of 2
    ref = np.asarray(jgarch.forecast(jnp.asarray(params), jnp.asarray(r), 9))
    if path == "eager":
        got = tgarch.forecast(params, r, 9, device="cpu").numpy()
    else:
        got = tgarch._forecast(torch.as_tensor(params), torch.as_tensor(r), 9,
                               "cuda").numpy()
    assert np.array_equal(np.isfinite(got), np.isfinite(ref))
    assert not np.isfinite(got[[2, 3, 5, 6]]).any()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_forecast_decays_to_unconditional_variance():
    r = _garch_panel(5, 200, seed=5)[4]
    pr = np.array([0.05, 0.1, 0.8], np.float32)
    fc = tgarch.forecast(pr, r, 400, device="cpu").numpy()
    assert fc.shape == (400,)
    np.testing.assert_allclose(fc[-1], 0.05 / (1 - 0.9), rtol=1e-5)


def test_from_jax_params_forecasts_like_the_reference(panel, jax_fits):
    ref_fit = jax_fits["garch"]
    carried = from_jax_params(np.asarray(ref_fit.params), device="cpu",
                              status=np.asarray(ref_fit.status),
                              converged=np.asarray(ref_fit.converged))
    assert carried.params.shape == (24, 3)
    ref = np.asarray(jgarch.forecast(ref_fit.params, jnp.asarray(panel), 6))
    got = tgarch.forecast(carried.params, panel, 6, device="cpu").numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    # an ARGARCH row layout [c, phi, omega, alpha, beta] carries as it is
    arg = np.asarray(jax_fits["argarch"].params)
    np.testing.assert_array_equal(
        from_jax_params(arg, device="cpu").params.numpy(), arg)


def test_time_dependent_effects_match_reference():
    rng = np.random.default_rng(6)
    eps = rng.normal(size=(3, 80)).astype(np.float32)
    params = np.array([[0.05, 0.1, 0.8], [0.2, 0.05, 0.9],
                       [0.01, 0.3, 0.6]], np.float32)
    ref_r = np.asarray(jgarch.add_time_dependent_effects(
        jnp.asarray(params), jnp.asarray(eps)))
    r = tgarch.add_time_dependent_effects(params, eps, device="cpu")
    np.testing.assert_allclose(r.numpy(), ref_r, rtol=1e-5, atol=1e-6)
    back = tgarch.remove_time_dependent_effects(params, r, device="cpu")
    np.testing.assert_allclose(back.numpy(), np.asarray(
        jgarch.remove_time_dependent_effects(jnp.asarray(params),
                                             jnp.asarray(ref_r))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(back.numpy(), eps, rtol=1e-4, atol=1e-5)
    one = tgarch.add_time_dependent_effects(params[0], eps[0], device="cpu")
    np.testing.assert_allclose(one.numpy(), ref_r[0], rtol=1e-5, atol=1e-6)


def test_sample_distribution_matches_reference():
    # torch.Generator draws cannot match JAX keys: hold the distribution
    pr = np.array([0.05, 0.1, 0.8], np.float32)
    n = 40_000
    got = tgarch.sample(pr, 7, n, device="cpu").numpy()
    ref = np.asarray(jgarch.sample(jnp.asarray(pr), jax.random.PRNGKey(7), n))
    uncond = 0.05 / (1 - 0.9)
    for x in (got, ref):
        assert abs(x.var() / uncond - 1.0) < 0.1
        assert abs(x.mean()) < 0.03
    # volatility clustering: the squares are autocorrelated in both
    acf_got = tuv.autocorr(torch.as_tensor(got ** 2), 3).numpy()
    acf_ref = np.asarray(juv.autocorr(jnp.asarray(ref ** 2), 3))
    np.testing.assert_allclose(acf_got, acf_ref, atol=0.06)
    assert (acf_got > 0.05).all()
    # a generator and an integer seed give the same draws
    g = torch.Generator().manual_seed(7)
    np.testing.assert_array_equal(
        tgarch.sample(pr, g, 100, device="cpu").numpy(),
        tgarch.sample(pr, 7, 100, device="cpu").numpy())
    y = tgarch.argarch_sample(np.array([0.05, 0.4, 0.05, 0.1, 0.8]), 8,
                              20_000, device="cpu").numpy()
    assert abs(y.mean() - 0.05 / 0.6) < 0.05


def test_log_likelihood_matches_reference():
    r = _garch_panel(5, 150, seed=9)[[0, 4]]
    ta, tnv = tbase.align_right(torch.as_tensor(r))
    pr = np.array([[0.05, 0.1, 0.8], [0.1, 0.2, 0.6]], np.float32)
    ref = jax.vmap(lambda p, v, n: jgarch.log_likelihood(p, v, n))(
        jnp.asarray(pr), jnp.asarray(ta.numpy()), jnp.asarray(tnv.numpy()))
    got = tgarch.log_likelihood(torch.as_tensor(pr), ta, tnv)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
    dense = np.nan_to_num(r[1])
    np.testing.assert_allclose(
        tgarch.neg_log_likelihood(torch.as_tensor(pr[0]),
                                  torch.as_tensor(dense)).numpy(),
        np.asarray(jgarch.neg_log_likelihood(jnp.asarray(pr[0]),
                                             jnp.asarray(dense))),
        rtol=1e-5)


@pytest.mark.parametrize("path", ["eager", "kernel"])
def test_straggler_compaction_parity(monkeypatch, path):
    r = _garch_panel(2048, 60, seed=10)
    if path == "eager":
        def run(compact):
            return tgarch.fit(r, max_iters=25, compact=compact, device="cpu")
    else:
        def run(compact):
            return _kernel_fit(tgarch._fit_garch, r, 25, compact=compact)
    ref = run(False)
    monkeypatch.setattr(tgarch, "_COMPACT_MIN_BATCH", 2048)
    engaged = []
    real = toptim._run

    def spy(fb, state, k, max_iters, stop_at, knobs):
        engaged.append(int(state.x.shape[0]))
        return real(fb, state, k, max_iters, stop_at, knobs)

    monkeypatch.setattr(toptim, "_run", spy)
    got = run(True)
    assert engaged == [2048, toptim.compaction_cap(2048)]
    _dist_parity(ref, got)


def test_fit_rejects_bad_arguments():
    r = np.zeros((2, 30), np.float32)
    with pytest.raises(ValueError, match="unknown backend"):
        tgarch.fit(r, backend="scan", device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tgarch.fit(r, backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="align_mode"):
        tgarch.fit_argarch(r, align_mode="bogus", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tgarch.fit(r)


def test_pipeline_matches_reference():
    """The volatility pipeline end to end at a small size: ragged log
    prices -> fill chain (returns) -> autocorrelation of the returns and of
    their squares -> GARCH fit -> forecast, the port on the CPU against the
    JAX package on the same prices."""
    prices = tentry.gen_garch_prices(40, 400, seed=11, device="cpu")
    y = 100.0 * prices
    assert torch.isnan(prices).any() and prices.dtype == torch.float32
    (ret,) = tuv.batch_fill_linear_chain(y, outputs=("diff",))
    jy = jnp.asarray(y.numpy())
    (jret,) = juv.batch_fill_linear_chain(jy, outputs=("diff",))
    # the returns are differences of prices near 460: the absolute bound is
    # a few float32 ulps of the prices
    np.testing.assert_allclose(ret.numpy(), np.asarray(jret), rtol=1e-5,
                               atol=1e-4)
    for x, jx in ((ret, jret), (ret ** 2, jret ** 2)):
        np.testing.assert_allclose(
            tuv.batch_autocorr(20)(x).numpy(),
            np.asarray(juv.batch_autocorr(20)(jx)), rtol=1e-5, atol=1e-5)
    got = tgarch.fit(ret, max_iters=60, device="cpu")
    ref = jgarch.fit(jret, max_iters=60)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    _dist_parity(ref, got)
    fc = tgarch.forecast(got.params, ret, 30, device="cpu").numpy()
    fc_ref = np.asarray(jgarch.forecast(jnp.asarray(got.params.numpy()),
                                        jret, 30))
    np.testing.assert_allclose(fc, fc_ref, rtol=1e-5, atol=1e-6)
    kern = _kernel_fit(tgarch._fit_garch, ret, 60)
    _dist_parity(ref, kern)
