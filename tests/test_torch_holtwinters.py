"""The PyTorch port's Holt-Winters (``models.holtwinters``) against the JAX
package, and the hourly path (EWMA and Holt-Winters fit + forecast of a
ragged hourly panel) as a whole.

The public entry points run with ``device="cpu"`` (the ``eager`` backend).
The ``cuda`` backend's driver (seeds once per fit, time-major panel, the
one-step SSE as an autograd function over the forward and adjoint kernels,
column gathers for stragglers) also runs on the CPU through
``holtwinters._fit_hw``, where each kernel wrapper uses its plain version;
``chip_smoke.py`` runs the same driver on the card.  Inputs are float32
numpy arrays handed to both packages; the reference runs its scan backend,
and its tolerances between its kernel and scan backends are the bar.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu.models import ewma as jewma
from spark_timeseries_tpu.models import holtwinters as jhw
from spark_timeseries_tpu.utils import optim as joptim
from spark_timeseries_tpu_torch import entry as tentry
from spark_timeseries_tpu_torch.convert import from_jax_params
from spark_timeseries_tpu_torch.models import base as tbase
from spark_timeseries_tpu_torch.models import ewma as tewma
from spark_timeseries_tpu_torch.models import holtwinters as thw
from spark_timeseries_tpu_torch.reliability import FitStatus
from spark_timeseries_tpu_torch.utils import optim as toptim

M = 8  # the period of the small panels


def _panel(b, t, m=M, seed=33, level=35.0):
    """A positive seasonal panel, ragged: row 1 starts late, row 2 ends
    early, row 3 has fewer than two seasons of data (EXCLUDED, clamped seed
    windows), row 4 is all NaN."""
    rng = np.random.default_rng(seed)
    tt = np.arange(t)
    y = (level + 0.05 * tt[None, :] + 2.0 * np.sin(2 * np.pi * tt / m)
         + rng.normal(scale=0.3, size=(b, t))).astype(np.float32)
    y[1, :13] = np.nan
    y[2, t - 9:] = np.nan
    y[3, :t - (2 * m - 3)] = np.nan
    y[4] = np.nan
    return y


def _kernel_fit(y, model_type, m=M, max_iters=40, compact=True,
                n_starts=None):
    """The fit driver's cuda backend on a CPU tensor (plain kernels)."""
    mult = model_type == "multiplicative"
    yb = torch.as_tensor(y)
    with torch.no_grad():
        return thw._fit_hw(yb, m, mult, max_iters, 1e-4, "cuda",
                           tbase.align_mode_on_host(yb), compact,
                           n_starts or (3 if mult else 1))


@pytest.fixture(scope="module")
def panel():
    return _panel(10, 96)


@pytest.fixture(scope="module")
def jax_fits(panel):
    y = jnp.asarray(panel)
    return {mt: jhw.fit(y, M, mt, backend="scan", max_iters=40)
            for mt in ("additive", "multiplicative")}


@pytest.mark.parametrize("model_type", ["additive", "multiplicative"])
@pytest.mark.parametrize("path", ["eager", "kernel"])
def test_fit_matches_reference(panel, jax_fits, model_type, path):
    ref = jax_fits[model_type]
    if path == "eager":
        got = thw.fit(panel, M, model_type, max_iters=40, device="cpu")
    else:
        got = _kernel_fit(panel, model_type)
    assert got.params.shape == (10, 3)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    assert got.status[3] == FitStatus.EXCLUDED  # 2m - 3 valid steps
    assert got.status[4] == FitStatus.EXCLUDED  # all NaN
    assert np.isnan(got.params[3].numpy()).all()
    both = np.asarray(ref.converged) & got.converged.numpy()
    assert both.mean() > 0.5
    # the reference's bars between its kernel and scan backends
    tol = 2e-2 if model_type == "additive" else 5e-2
    np.testing.assert_allclose(got.params.numpy()[both],
                               np.asarray(ref.params)[both], rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("model_type", ["additive", "multiplicative"])
def test_forecast_matches_reference_with_nan_gates(panel, jax_fits,
                                                   model_type):
    params = np.array(jax_fits[model_type].params)
    params[5] = np.nan  # a failed fit forecasts NaN
    ref = np.asarray(jhw.forecast(jnp.asarray(params), jnp.asarray(panel), M,
                                  19, model_type))
    got = thw.forecast(params, panel, M, 19, model_type, device="cpu").numpy()
    assert got.shape == (10, 19)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    assert not np.isfinite(got[[3, 4, 5]]).any()  # short, empty, NaN params
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("model_type", ["additive", "multiplicative"])
def test_fitted_and_sse_match_reference(model_type):
    mult = model_type == "multiplicative"
    y = _panel(5, 60, seed=3)[0]
    params = np.array([[0.4, 0.1, 0.3], [0.1, 0.02, 0.6]], np.float32)
    yy = np.stack([y, y])
    ref = np.asarray(jhw.fitted(jnp.asarray(params), jnp.asarray(yy), M,
                                model_type))
    got = thw.fitted(params, yy, M, model_type, device="cpu").numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    one = thw.fitted(params[0], y, M, model_type, device="cpu")
    assert one.shape == (60,)
    # the SSE, dense and with a right-aligned span
    nv = 47
    ya = np.where(np.arange(60) >= 60 - nv, y, 0.0).astype(np.float32)
    for n, v in ((None, y), (nv, ya)):
        r = float(jhw.sse(jnp.asarray(params[1]), jnp.asarray(v), M, mult,
                          None if n is None else jnp.asarray(n)))
        g = float(thw.sse(torch.as_tensor(params[1]), torch.as_tensor(v), M,
                          mult, n))
        np.testing.assert_allclose(g, r, rtol=2e-5)


def test_init_state_clamps_like_dynamic_slice():
    # starts past T - 2m: both seed windows clamp into [0, T - m], as the
    # reference's lax.dynamic_slice clamps them
    rng = np.random.default_rng(4)
    t = 40
    y = (20.0 + rng.normal(size=t)).astype(np.float32)
    for start in (0, 5, t - 2 * M, t - 2 * M + 3, t - M, t - 2):
        for mult in (False, True):
            ref = jhw._init_state(jnp.asarray(y), M, mult, start)
            got = thw._init_state(torch.as_tensor(y)[None], M, mult,
                                  torch.tensor([start]))
            for a, r in zip(got, ref):
                np.testing.assert_allclose(a[0].numpy(), np.asarray(r),
                                           rtol=1e-6, atol=1e-6)


def test_select_best_start_matches_reference():
    # crafted per-start results: near ties inside 0.1 % (the smoother
    # start wins), a far better unconverged start (converged ones win), a
    # row where no start converged (best objective among all), NaN
    # objectives (never chosen), an exact tie (the earlier start)
    x = np.array([
        [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [-2.0, -2.0, -2.0],
         [0.5, 0.5, 0.5], [0.1, 0.1, 0.1]],
        [[-1.0, -1.0, -1.0], [0.0, 0.0, 0.0], [1.0, 1.0, 1.0],
         [-0.5, -0.5, -0.5], [0.1, 0.1, 0.1]],
        [[2.0, 2.0, 2.0], [-3.0, -3.0, -3.0], [0.0, 0.0, 0.0],
         [0.0, 0.0, 0.0], [0.1, 0.1, 0.1]],
    ], np.float32)
    f = np.array([[10.0, 5.0, 3.0, np.nan, 2.0],
                  [10.005, 1.0, 2.5, 4.0, 2.0],
                  [10.001, 8.0, 2.9, 3.0, 2.0]], np.float32)
    conv = np.array([[True, True, False, False, True],
                     [True, False, False, True, True],
                     [True, True, False, True, True]])
    iters = np.arange(15, dtype=np.int32).reshape(3, 5)
    gn = np.linspace(0.1, 1.5, 15, dtype=np.float32).reshape(3, 5)
    ref = jhw._select_best_start([joptim.LBFGSResult(
        jnp.asarray(x[s]), jnp.asarray(f[s]), jnp.asarray(conv[s]),
        jnp.asarray(iters[s]), jnp.asarray(gn[s])) for s in range(3)])
    got = thw._select_best_start([toptim.LBFGSResult(
        torch.as_tensor(x[s]), torch.as_tensor(f[s]), torch.as_tensor(conv[s]),
        torch.as_tensor(iters[s]), torch.as_tensor(gn[s])) for s in range(3)])
    for name in ("x", "f", "converged", "iters", "grad_norm"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    # the selections this table was built for
    np.testing.assert_array_equal(got.iters.numpy(), [5, 1, 7, 13, 4])
    assert thw._select_best_start([got]) is got


@pytest.mark.parametrize("path", ["eager", "kernel"])
def test_straggler_compaction_parity(monkeypatch, path):
    # the reference's compaction test: 2,048 daily-seasonal rows, a
    # 13-iteration budget, the gate lowered to the batch
    rng = np.random.default_rng(32)
    tt = np.arange(96, dtype=np.float32)
    w = (10 + 0.02 * tt[None, :] + 2 * np.sin(2 * np.pi * tt[None, :] / 24)
         + 0.3 * rng.normal(size=(2048, 96))).astype(np.float32)
    if path == "eager":
        def run(compact):
            return thw.fit(w, 24, max_iters=13, compact=compact, device="cpu")
    else:
        def run(compact):
            return _kernel_fit(w, "additive", m=24, max_iters=13,
                               compact=compact)
    ref = run(False)
    monkeypatch.setattr(thw, "_COMPACT_MIN_BATCH", 2048)
    engaged = []
    real = toptim._run

    def spy(fb, state, k, max_iters, stop_at, knobs):
        engaged.append(int(state.x.shape[0]))
        return real(fb, state, k, max_iters, stop_at, knobs)

    monkeypatch.setattr(toptim, "_run", spy)
    got = run(True)
    assert engaged == [2048, toptim.compaction_cap(2048)]
    assert abs(float(ref.converged.float().mean())
               - float(got.converged.float().mean())) < 0.02
    both = ref.converged & got.converged
    assert float(both.float().mean()) > 0.5
    diff = (ref.params[both] - got.params[both]).abs()
    assert float(diff.median()) < 1e-2


def test_multiplicative_starts(panel, jax_fits):
    # n_starts=1 runs the first seeded init only; the default (3) keeps
    # each row's best basin, never a worse objective than one start
    one = thw.fit(panel, M, "multiplicative", n_starts=1, max_iters=40,
                  device="cpu")
    ref_one = jhw.fit(jnp.asarray(panel), M, "multiplicative", n_starts=1,
                      backend="scan", max_iters=40)
    np.testing.assert_array_equal(one.status.numpy(),
                                  np.asarray(ref_one.status))
    three = thw.fit(panel, M, "multiplicative", max_iters=40, device="cpu")
    ok = (three.status == FitStatus.OK) & (one.status == FitStatus.OK)
    assert bool(ok.any())
    assert bool((three.neg_log_likelihood[ok]
                 <= one.neg_log_likelihood[ok] * (1 + 1e-3) + 1e-6).all())


def test_fit_rejects_bad_arguments():
    y = np.full((2, 60), 10.0, np.float32)
    with pytest.raises(ValueError, match="model_type"):
        thw.fit(y, M, "bogus", device="cpu")
    for n in (0, 4):
        with pytest.raises(ValueError, match="n_starts"):
            thw.fit(y, M, n_starts=n, device="cpu")
    with pytest.raises(ValueError, match="two seasons"):
        thw.fit(y[:, :2 * M - 1], M, device="cpu")
    with pytest.raises(ValueError, match="1024"):
        thw.fit(np.full((1, 2200), 10.0, np.float32), 1100, backend="cuda",
                device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        thw.fit(y, M, backend="scan", device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        thw.fit(y, M, backend="cuda", device="cpu")
    # a period past the kernels' bound resolves "auto" to the eager path
    assert thw.fit(np.full((1, 2200), 10.0, np.float32), 1100,
                   max_iters=1, device="cpu").params.shape == (1, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            thw.fit(y, M)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            thw.forecast(np.zeros((2, 3), np.float32), y, M, 4)


def test_from_jax_params_forecasts_like_the_reference(panel, jax_fits):
    fit = jax_fits["additive"]
    carried = from_jax_params(np.asarray(fit.params), device="cpu",
                              status=np.asarray(fit.status),
                              converged=np.asarray(fit.converged))
    assert carried.params.shape == (10, 3)
    ref = np.asarray(jhw.forecast(fit.params, jnp.asarray(panel), M, 12))
    got = thw.forecast(carried.params, panel, M, 12, device="cpu").numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)


def test_hourly_path_matches_reference():
    """The hourly path end to end at a small size: a ragged hourly panel
    from ``entry.gen_hourly_panel`` -> EWMA fit + 48-step forecast ->
    additive Holt-Winters fit (period 24) + 48-step forecast, the port on
    the CPU against the JAX package on the same panel."""
    m, h = tentry.HW_PERIOD, 48
    y = tentry.gen_hourly_panel(12, 200, seed=5, device="cpu")
    assert y.dtype == torch.float32 and bool(torch.isnan(y).any())
    assert bool((y[~torch.isnan(y)] > 0).all())
    jy = jnp.asarray(y.numpy())
    es = tewma.fit(y, device="cpu")
    es_ref = jewma.fit(jy, backend="scan")
    np.testing.assert_array_equal(es.status.numpy(), np.asarray(es_ref.status))
    np.testing.assert_allclose(es.params.numpy(), np.asarray(es_ref.params),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(
        tewma.forecast(es.params, y, h, device="cpu").numpy(),
        np.asarray(jewma.forecast(jnp.asarray(es.params.numpy()), jy, h)),
        rtol=1e-5, atol=1e-4)
    hs = thw.fit(y, m, device="cpu")
    hs_ref = jhw.fit(jy, m, backend="scan")
    np.testing.assert_array_equal(hs.status.numpy(), np.asarray(hs_ref.status))
    both = hs.converged.numpy() & np.asarray(hs_ref.converged)
    assert both.mean() > 0.5
    np.testing.assert_allclose(hs.params.numpy()[both],
                               np.asarray(hs_ref.params)[both], rtol=2e-2,
                               atol=2e-2)
    fc = thw.forecast(hs.params, y, m, h, device="cpu").numpy()
    fc_ref = np.asarray(jhw.forecast(jnp.asarray(hs.params.numpy()), jy, m,
                                     h))
    np.testing.assert_allclose(fc, fc_ref, rtol=1e-4, atol=1e-2)
    kern = _kernel_fit(y.numpy(), "additive", m=m, max_iters=60)
    np.testing.assert_array_equal(kern.status.numpy(),
                                  np.asarray(hs_ref.status))
    both = kern.converged.numpy() & np.asarray(hs_ref.converged)
    np.testing.assert_allclose(kern.params.numpy()[both],
                               np.asarray(hs_ref.params)[both], rtol=2e-2,
                               atol=2e-2)


def test_gen_hourly_panel_shape_and_raggedness():
    y = tentry.gen_hourly_panel(64, 960, seed=1, device="cpu")
    assert tuple(y.shape) == (64, 960)
    valid = ~torch.isnan(y)
    nv = valid.sum(1)
    assert int(nv.min()) >= 700 and int(nv.max()) <= 960
    # NaN only as a leading run, and every value positive
    first = valid.to(torch.int8).argmax(1)
    assert torch.equal(first, 960 - nv)
    assert bool((y[valid] > 0).all())
    np.testing.assert_array_equal(  # the seed fixes the panel
        y.numpy(), tentry.gen_hourly_panel(64, 960, seed=1,
                                           device="cpu").numpy())
