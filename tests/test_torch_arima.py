"""The PyTorch port's ARIMA fit + forecast slice against the JAX package.

The public entry points run with ``device="cpu"`` (the ``eager`` backend).
The ``cuda`` backend's driver (time-major layout, moment-kernel init,
CSS objective as an autograd function, column gather for stragglers) is
also run on the CPU through ``arima._fit_css`` / ``arima._forecast``, where
each kernel wrapper uses its plain version; ``chip_smoke.py`` runs the same
driver on the card with the kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu.models import arima as jarima
from spark_timeseries_tpu.reliability import status as jstatus
from spark_timeseries_tpu.utils import optim as joptim
from spark_timeseries_tpu_torch import entry as tentry
from spark_timeseries_tpu_torch.convert import from_jax_params
from spark_timeseries_tpu_torch.models import arima as tarima
from spark_timeseries_tpu_torch.models import base as tbase
from spark_timeseries_tpu_torch.reliability import status as tstatus
from spark_timeseries_tpu_torch.utils import optim as toptim


def _arma_panel(b, t, phi=0.6, theta=0.3, d_int=False, seed=0):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(b, t)).astype(np.float32)
    y = np.zeros_like(e)
    y[:, 0] = e[:, 0]
    for i in range(1, t):
        y[:, i] = phi * y[:, i - 1] + e[:, i] + theta * e[:, i - 1]
    if d_int:
        y = np.cumsum(y, axis=1)
    return y


def _fit_kernel_path(y, order, max_iters, include_intercept=True,
                     compact=True):
    """The cuda backend's fit driver on a CPU tensor (plain kernels)."""
    yb = torch.as_tensor(y)
    mode = tbase.align_mode_on_host(yb)
    with torch.no_grad():
        return tarima._fit_css(yb, order, include_intercept, "css-lbfgs",
                               "cuda", max_iters, 1e-4, None, mode, compact)


@pytest.fixture(scope="module")
def integrated_panel():
    return _arma_panel(8, 120, d_int=True, seed=5)


@pytest.fixture(scope="module")
def jax_fits(integrated_panel):
    y = jnp.asarray(integrated_panel)
    return {
        "scan": jarima.fit(y, (1, 1, 1), backend="scan", max_iters=30),
        "pallas": jarima.fit(y, (1, 1, 1), backend="pallas-interpret",
                             max_iters=30),
    }


@pytest.mark.parametrize("path", ["eager", "kernel"])
def test_fit_matches_reference(integrated_panel, jax_fits, path):
    if path == "eager":
        r = tarima.fit(integrated_panel, (1, 1, 1), max_iters=30,
                       device="cpu")
    else:
        r = _fit_kernel_path(integrated_panel, (1, 1, 1), 30)
    got = r.params.numpy()
    # same optimizer as the reference's pallas backend: 1e-3; the scan
    # backend's init construction differs, so its bar is the reference's
    # own 4e-3 (tests/test_pallas.py)
    np.testing.assert_allclose(got, np.asarray(jax_fits["pallas"].params),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got, np.asarray(jax_fits["scan"].params),
                               rtol=4e-3, atol=4e-3)
    np.testing.assert_array_equal(r.status.numpy(),
                                  np.asarray(jax_fits["pallas"].status))
    np.testing.assert_array_equal(r.converged.numpy(),
                                  np.asarray(jax_fits["pallas"].converged))
    np.testing.assert_allclose(
        r.neg_log_likelihood.numpy(),
        np.asarray(jax_fits["pallas"].neg_log_likelihood), rtol=1e-4)


@pytest.mark.parametrize("path", ["eager", "kernel"])
def test_fit_ragged_matches_reference(path):
    y = _arma_panel(4, 90, d_int=True, seed=6)
    y[0, :17] = np.nan  # leading NaNs (ragged start)
    y[2, 80:] = np.nan  # trailing NaNs
    ref = jarima.fit(jnp.asarray(y), (1, 1, 1), backend="scan", max_iters=30)
    if path == "eager":
        r = tarima.fit(y, (1, 1, 1), max_iters=30, device="cpu")
    else:
        r = _fit_kernel_path(y, (1, 1, 1), 30)
    np.testing.assert_allclose(r.params.numpy(), np.asarray(ref.params),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(r.status.numpy(), np.asarray(ref.status))


def test_hannan_rissanen_method_matches_reference(integrated_panel):
    ref = jarima.fit(jnp.asarray(integrated_panel), (1, 1, 1),
                     method="hannan-rissanen", backend="scan")
    r = tarima.fit(integrated_panel, (1, 1, 1), method="hannan-rissanen",
                   device="cpu")
    np.testing.assert_allclose(r.params.numpy(), np.asarray(ref.params),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(r.neg_log_likelihood.numpy(),
                               np.asarray(ref.neg_log_likelihood), rtol=1e-4)
    np.testing.assert_array_equal(r.status.numpy(), np.asarray(ref.status))


@pytest.mark.parametrize("order,intercept", [((1, 1, 1), True),
                                             ((2, 0, 0), True),
                                             ((1, 1, 1), False),
                                             ((0, 1, 2), True)])
@pytest.mark.parametrize("path", ["eager", "kernel"])
def test_forecast_from_jax_fit_matches_reference(order, intercept, path):
    y = _arma_panel(6, 140, d_int=order[1] > 0, seed=11)
    y[1, :25] = np.nan  # ragged start
    y[4, :60] = np.nan
    r = jarima.fit(jnp.asarray(y), order, include_intercept=intercept,
                   backend="scan", max_iters=30)
    ref = np.asarray(jarima.forecast(r.params, jnp.asarray(y), order, 8,
                                     include_intercept=intercept,
                                     backend="scan"))
    carried = from_jax_params(np.asarray(r.params), device="cpu",
                              status=np.asarray(r.status))
    assert carried.params.dtype == torch.float32
    if path == "eager":
        got = tarima.forecast(carried.params, y, order, 8,
                              include_intercept=intercept, device="cpu")
    else:
        yb = torch.as_tensor(y)
        got = tarima._forecast(order, 8, intercept, "cuda",
                               tbase.align_mode_on_host(yb), carried.params,
                               yb)
    got = got.numpy()
    finite = np.isfinite(ref).all(axis=1)
    assert finite.sum() >= 4
    np.testing.assert_allclose(got[finite], ref[finite], rtol=2e-4, atol=2e-4)
    assert np.array_equal(np.isfinite(got), np.isfinite(ref))


def _dist_parity(ref, got, conv_floor=0.45):
    # the reference's distribution-level bar (tests/test_pallas.py)
    conv_ref = ref.converged.numpy()
    conv_got = got.converged.numpy()
    assert abs(conv_ref.mean() - conv_got.mean()) < 0.02
    both = conv_ref & conv_got
    assert both.mean() > conv_floor
    nll_r = ref.neg_log_likelihood.numpy()[both]
    nll_g = got.neg_log_likelihood.numpy()[both]
    rel = np.abs(nll_r - nll_g) / np.maximum(np.abs(nll_r), 1e-6)
    assert float(np.percentile(rel, 99)) < 1e-2
    med = float(np.nanmedian(np.abs(ref.params.numpy()[both]
                                    - got.params.numpy()[both])))
    assert med < 1e-2


@pytest.mark.parametrize("path", ["eager", "kernel"])
def test_straggler_compaction_parity(monkeypatch, path):
    b, t = 2048, 64
    y = _arma_panel(b, t, seed=78)
    if path == "eager":
        def run(compact):
            return tarima.fit(y, (1, 1, 1), max_iters=15, compact=compact,
                              device="cpu")
    else:
        def run(compact):
            return _fit_kernel_path(y, (1, 1, 1), 15, compact=compact)
    ref = run(False)
    monkeypatch.setattr(tarima, "_COMPACT_MIN_BATCH", 2048)
    engaged = []
    real = toptim._run

    def spy(fb, state, k, max_iters, stop_at, knobs):
        engaged.append(int(state.x.shape[0]))
        return real(fb, state, k, max_iters, stop_at, knobs)

    monkeypatch.setattr(toptim, "_run", spy)
    got = run(True)
    assert engaged == [b, toptim.compaction_cap(b)]  # stage 2 ran on the cap
    _dist_parity(ref, got)


def test_host_reads_are_bounded_by_the_loop_trips(integrated_panel):
    toptim.host_reads.count = 0
    r = tarima.fit(integrated_panel, (1, 1, 1), max_iters=30, device="cpu")
    iters = int(r.iters.max())
    # one read per outer iteration (+ the final exit test) and at most one
    # per line-search trial
    assert iters + 1 <= toptim.host_reads.count <= (iters + 1) * 21


@pytest.mark.parametrize("n", [1, 7, 8, 9, 1000])
def test_compaction_sizes_match_reference(n):
    assert toptim.compaction_cap(n * 100) == joptim.compaction_cap(n * 100)
    assert toptim.retry_cap(n) == joptim.retry_cap(n)
    np.testing.assert_array_equal(
        toptim.gather_pad_indices(np.arange(n), n + 3),
        joptim.gather_pad_indices(np.arange(n), n + 3))
    assert toptim.COMPACT_MIN_BATCH == joptim.COMPACT_MIN_BATCH


def test_status_codes_match_reference():
    assert {m.name: m.value for m in tstatus.FitStatus} == \
        {m.name: m.value for m in jstatus.FitStatus}
    assert tstatus.STATUS_DTYPE == jstatus.STATUS_DTYPE
    s = np.array([0, 4, 5, 5, 0], np.int8)
    assert tstatus.status_counts(s) == jstatus.status_counts(s)
    np.testing.assert_array_equal(tstatus.merge_status(s, s[::-1]),
                                  jstatus.merge_status(s, s[::-1]))


@pytest.mark.parametrize("mode", [None, "general"])
def test_align_right_matches_reference(mode):
    from spark_timeseries_tpu.models import base as jbase

    y = _arma_panel(5, 30, seed=30)
    y[0, :4] = np.nan
    y[1, 25:] = np.nan
    y[2, 10] = np.nan  # interior NaN
    y[3, :] = np.nan  # all-NaN row
    ya, nv = tbase.maybe_align(torch.as_tensor(y),
                               mode or tbase.align_mode_on_host(
                                   torch.as_tensor(y)))
    ja, jnv = jbase.maybe_align(jnp.asarray(y), "general")
    np.testing.assert_array_equal(ya.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(nv.numpy(), np.asarray(jnv))


def test_align_hints_flag_rows_instead_of_corrupting_them():
    y = _arma_panel(4, 60, d_int=True, seed=31)
    y[1, :10] = np.nan
    y[2, -3:] = np.nan
    with pytest.raises(ValueError):
        tarima.fit(y, (1, 1, 1), align_mode="sideways", device="cpu")
    dense = tarima.fit(y, (1, 1, 1), max_iters=10, align_mode="dense",
                       device="cpu")
    assert dense.status[1] == tstatus.FitStatus.DIVERGED
    assert dense.status[2] == tstatus.FitStatus.DIVERGED
    nt = tarima.fit(y, (1, 1, 1), max_iters=10, align_mode="no-trailing",
                    device="cpu")
    assert nt.status[2] == tstatus.FitStatus.EXCLUDED
    assert torch.isnan(nt.params[2]).all()


def test_entry_points_run_on_the_card_unless_asked():
    y = _arma_panel(3, 40, d_int=True)
    if torch.cuda.is_available():
        pytest.skip("this check is for a host without a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        tarima.fit(y, (1, 1, 1))
    with pytest.raises(RuntimeError, match="cuda"):
        tarima.forecast(np.zeros((3, 3), np.float32), y, (1, 1, 1), 4)
    with pytest.raises(RuntimeError, match="cuda"):
        tentry.entry()
    with pytest.raises(ValueError, match="float32 tensor on a CUDA"):
        tarima.fit(y, (1, 1, 1), backend="cuda", device="cpu")


def test_entry_step_on_cpu():
    fn, (y,) = tentry.entry(device="cpu")
    r = fn(y)
    assert r.params.shape == (64, 3)
    assert bool(torch.isfinite(r.neg_log_likelihood).all())


def test_seasonal_and_unknown_method_raise():
    y = _arma_panel(2, 50, d_int=True)
    # seasonal orders are ported; the reference's refusals raise as there
    for kwargs in (dict(method="hannan-rissanen"), dict(count_evals=True),
                   dict(seasonal=(1, 0, 0, 1))):
        kw = {"seasonal": (1, 0, 0, 4), **kwargs}
        with pytest.raises(ValueError):
            jarima.fit(jnp.asarray(y), (1, 1, 1), **kw)
        with pytest.raises(ValueError):
            tarima.fit(y, (1, 1, 1), device="cpu", **kw)
    with pytest.raises(ValueError):
        tarima.fit(y, (1, 1, 1), method="newton", device="cpu")


def test_single_series_and_diagnostics(integrated_panel):
    r1 = tarima.fit(integrated_panel[3], (1, 1, 1), max_iters=30,
                    device="cpu")
    rb = tarima.fit(integrated_panel, (1, 1, 1), max_iters=30, device="cpu")
    assert r1.params.shape == (3,)
    np.testing.assert_allclose(r1.params.numpy(), rb.params[3].numpy(),
                               rtol=1e-3, atol=1e-3)
    for pr in rb.params.numpy():
        assert tarima.is_stationary(pr, (1, 1, 1)) == \
            jarima.is_stationary(pr, (1, 1, 1))
        assert tarima.is_invertible(pr, (1, 1, 1)) == \
            jarima.is_invertible(pr, (1, 1, 1))
    f = tarima.forecast(r1.params, integrated_panel[3], (1, 1, 1), 5,
                        device="cpu")
    assert f.shape == (5,)


def test_transforms_and_batched_minimize_match_reference():
    u = np.linspace(-3.0, 3.0, 7)
    x = np.linspace(-0.9, 1.9, 7)
    np.testing.assert_allclose(
        toptim.sigmoid_to_interval(torch.tensor(u), -1.0, 2.0).numpy(),
        np.asarray(joptim.sigmoid_to_interval(jnp.asarray(u), -1.0, 2.0)),
        rtol=1e-12)
    np.testing.assert_allclose(
        toptim.interval_to_sigmoid(torch.tensor(x), -1.0, 2.0).numpy(),
        np.asarray(joptim.interval_to_sigmoid(jnp.asarray(x), -1.0, 2.0)),
        rtol=1e-12)
    np.testing.assert_allclose(
        toptim.softplus_inverse(torch.tensor(u + 3.5)).numpy(),
        np.asarray(joptim.softplus_inverse(jnp.asarray(u + 3.5))),
        rtol=1e-12)
    # an ill-conditioned bowl per row: both optimizers reach its centre
    centers = np.random.default_rng(40).normal(size=(6, 3))
    scale = np.array([1.0, 10.0, 100.0])
    got = toptim.batched_minimize(
        lambda X, c: (torch.as_tensor(scale) * (X - c) ** 2).sum(-1),
        torch.zeros(6, 3, dtype=torch.float64), torch.as_tensor(centers),
        max_iters=40, tol=1e-9)
    ref = joptim.batched_minimize(
        lambda xr, c: jnp.sum(jnp.asarray(scale) * (xr - c) ** 2),
        jnp.zeros((6, 3)), jnp.asarray(centers), max_iters=40, tol=1e-9)
    assert bool(got.converged.all()) and bool(np.asarray(ref.converged).all())
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), atol=1e-6)


def test_approx_aic_matches_reference():
    y = _arma_panel(5, 70, seed=41)
    params = (np.random.default_rng(42).normal(size=(5, 3)) * 0.3
              ).astype(np.float32)
    ref = jax.vmap(lambda pr, v: jarima.approx_aic(pr, v, (1, 0, 1), True))(
        jnp.asarray(params), jnp.asarray(y))
    got = tarima.approx_aic(torch.as_tensor(params), torch.as_tensor(y),
                            (1, 0, 1), True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5)
