"""The port's time-sharded functions (``ops/seqparallel.py``) against the
reference's on its ``(4, 2)`` CPU mesh.

The port's mesh is the CPU device listed eight times (virtual shards:
torch cannot force devices), so every halo, carry and shard-order sum of
the port runs as it would across cards.  Each transform and objective is
held against the reference's ``sp_*`` under ``shard_map`` on the same
``(8, 64)`` / ``(8, 256)`` panels as ``test_seqparallel.py``, at the
reference's own bars (objectives rtol 1e-6; the doubling scan associates
differently from ``lax.associative_scan``).  The fits are held against the
reference's sharded fits (params atol 5e-3 ARIMA, 1e-3 GARCH, 2e-3
ARGARCH, on rows both converge, at least 70 % of rows converging on both)
and against the port's own unsharded fits; then the too-short gates and a
lag reach wider than a shard.  Each test compiles at most one reference
program.  Values are float64 on both sides (``tests/conftest.py`` enables
x64).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as RP

from spark_timeseries_tpu.models import garch as ref_garch
from spark_timeseries_tpu.ops import seqparallel as rsp
from spark_timeseries_tpu.parallel import mesh as rmesh
from spark_timeseries_tpu_torch.models import arima, ewma, garch
from spark_timeseries_tpu_torch.ops import seqparallel as sp
from spark_timeseries_tpu_torch.ops import univariate as uv
from spark_timeseries_tpu_torch.parallel import mesh as meshlib
from spark_timeseries_tpu_torch.parallel.mesh import PartitionSpec as P

from _synth import gen_arma22_panel, gen_arma_panel

S, T = meshlib.SERIES_AXIS, meshlib.TIME_AXIS
CPU = torch.device("cpu")


def _meshes(time_shards):
    return (meshlib.default_mesh(devices=[CPU] * 8, time_shards=time_shards),
            rmesh.default_mesh(time_shards=time_shards))


@pytest.fixture(scope="module")
def mesh2d(cpu_devices):
    return _meshes(2)


@pytest.fixture(scope="module")
def values():
    rng = np.random.default_rng(11)
    return rng.normal(size=(8, 64)).cumsum(axis=1)


def _put(rm, x, spec=None):
    sharding = (rmesh.series_sharding(rm) if spec is None
                else NamedSharding(rm, spec))
    return jax.device_put(jnp.asarray(x), sharding)


def _t(x):
    return torch.as_tensor(np.array(x, dtype=np.float64))


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------


def test_moments_match_the_reference(mesh2d, values):
    pm, rm = mesh2d
    got = sp.sp_moments_sharded(pm, _t(values))
    want = rsp.sp_moments_sharded(rm, _put(rm, values))
    np.testing.assert_array_equal(got["count"].numpy(), 64)
    for k in ("mean", "var"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-12)
    np.testing.assert_allclose(got["var"].numpy(),
                               values.var(axis=1, ddof=1), rtol=1e-12)


def test_autocorr_matches_the_reference_and_unsharded(mesh2d, values):
    pm, rm = mesh2d
    got = sp.sp_autocorr_sharded(pm, _t(values), 5).numpy()
    want = np.asarray(rsp.sp_autocorr_sharded(rm, _put(rm, values), 5))
    np.testing.assert_allclose(got, want, rtol=1e-10)
    np.testing.assert_allclose(got, uv.autocorr(_t(values), 5).numpy(),
                               rtol=1e-10)
    cov = sp.cell_map(functools.partial(sp.sp_autocov, max_lag=5), mesh=pm,
                      in_specs=(P(S, T),), out_specs=P(S, None))(_t(values))
    d = values - values.mean(axis=1, keepdims=True)
    np.testing.assert_allclose(
        cov.numpy()[:, 2], (d[:, 3:] * d[:, :-3]).sum(axis=1), rtol=1e-10)


def test_cumsum_matches_the_reference(mesh2d, values):
    pm, rm = mesh2d
    got = sp.sp_cumsum_sharded(pm, _t(values)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(rsp.sp_cumsum_sharded(rm, _put(rm, values))),
        rtol=1e-12)
    np.testing.assert_allclose(got, np.cumsum(values, axis=1), rtol=1e-12)


@pytest.mark.parametrize("k", [1, 3])
def test_differences_match_the_reference(mesh2d, values, k):
    pm, rm = mesh2d
    got = sp.sp_differences_sharded(pm, _t(values), k).numpy()
    want = np.asarray(rsp.sp_differences_sharded(rm, _put(rm, values), k))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, uv.differences_at_lag(_t(values), k).numpy())


def _gappy(seed, share):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(8, 64)).cumsum(axis=1).astype(np.float32)
    v[rng.random((8, 64)) < share] = np.nan  # gaps across shard boundaries
    return v


def test_fill_matches_the_reference(mesh2d):
    pm, rm = mesh2d
    v = _gappy(21, 0.3)
    v[0, :5] = np.nan  # leading edge
    v[1, -6:] = np.nan  # trailing edge
    v[2, 20:50] = np.nan  # one gap over a whole middle shard span
    v[3, :] = np.nan  # all NaN
    got = sp.sp_fill_linear_sharded(pm, torch.as_tensor(v)).numpy()
    want = np.asarray(rsp.sp_fill_linear_sharded(rm, _put(rm, v)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, uv.fill_linear(torch.as_tensor(v)).numpy(),
                               rtol=1e-6, atol=1e-6)
    assert np.array_equal(np.isnan(got), np.isnan(want))


def test_fill_chain_matches_the_reference(mesh2d):
    pm, rm = mesh2d
    v = _gappy(22, 0.25)
    got = sp.sp_fill_linear_chain_sharded(pm, torch.as_tensor(v))
    want = rsp.sp_fill_linear_chain_sharded(rm, _put(rm, v))
    flat = uv.batch_fill_linear_chain(torch.as_tensor(v), backend="eager")
    for g, w, f, atol in zip(got, want, flat, (1e-6, 1e-5, 1e-6)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=atol)
        np.testing.assert_allclose(g.numpy(), f.numpy(), rtol=1e-6,
                                   atol=atol)


@pytest.mark.parametrize("time_shards,alpha,rtol,atol", [
    (4, None, 1e-6, 1e-9),
    (8, [0.999, 0.5, 0.05, 0.0001] * 2, 1e-5, 1e-8),
])
def test_ewma_smooth_matches_the_reference(cpu_devices, time_shards, alpha,
                                           rtol, atol):
    pm, rm = _meshes(time_shards)
    rng = np.random.default_rng(time_shards)
    t = 64 if alpha is None else 96
    x = np.cumsum(rng.normal(size=(8, t)), axis=1)
    a = rng.uniform(0.1, 0.9, 8) if alpha is None else np.asarray(alpha)
    got = sp.sp_ewma_smooth_sharded(pm, _t(x), _t(a)).numpy()
    want = np.asarray(rsp.sp_ewma_smooth_sharded(rm, _put(rm, x),
                                                 jnp.asarray(a)))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    flat = ewma.smooth(_t(a), _t(x)).numpy()
    np.testing.assert_allclose(got, flat, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# objectives (rtol 1e-6)
# ---------------------------------------------------------------------------


def test_ewma_sse_matches_the_reference(mesh2d, values):
    pm, rm = mesh2d
    alpha = np.random.default_rng(21).uniform(0.2, 0.8, 8)
    fn = jax.jit(rsp.shard_map(
        rsp.sp_ewma_sse, mesh=rm, in_specs=(RP(S, T), RP(S)),
        out_specs=RP(S)))
    want = np.asarray(fn(_put(rm, values), _put(rm, alpha, RP(S))))
    got = sp.cell_map(sp.sp_ewma_sse, mesh=pm, in_specs=(P(S, T), P(S)),
                      out_specs=P(S))(_t(values), _t(alpha)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(
        got, ewma.sse(_t(alpha), _t(values)).numpy(), rtol=1e-6)


@pytest.mark.parametrize("order", [(1, 0, 1), (2, 0, 2), (0, 0, 2),
                                   (2, 0, 0), (0, 0, 0)])
def test_css_objective_matches_the_reference(mesh2d, values, order):
    pm, rm = mesh2d
    p, _, q = order
    params = np.random.default_rng(27).normal(size=(8, 1 + p + q)) * 0.3
    yd = np.diff(values, axis=1)
    grid = np.concatenate([np.zeros((8, 1)), yd], axis=1)
    fn = jax.jit(rsp.shard_map(
        functools.partial(rsp.sp_css_neg_loglik, d_dead=1, p=p, q=q),
        mesh=rm, in_specs=(RP(S, None), RP(S, T)), out_specs=RP(S)))
    want = np.asarray(fn(_put(rm, params, RP(S, None)), _put(rm, grid)))
    got = sp.cell_map(
        functools.partial(sp.sp_css_neg_loglik, d_dead=1, p=p, q=q),
        mesh=pm, in_specs=(P(S, None), P(S, T)), out_specs=P(S))(
            _t(params), _t(grid)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    flat = arima.css_neg_loglik(_t(params), _t(yd), order, True).numpy()
    np.testing.assert_allclose(got, flat, rtol=1e-6)


def test_hannan_rissanen_matches_the_reference(mesh2d):
    pm, rm = mesh2d
    y = gen_arma22_panel(8, 256, seed=28).astype(np.float64)
    yd = np.diff(y, axis=1)
    grid = np.concatenate([np.zeros((8, 1)), yd], axis=1)
    fn = jax.jit(rsp.shard_map(
        functools.partial(rsp.sp_hannan_rissanen, d_dead=1, p=2, q=2, n=256),
        mesh=rm, in_specs=(RP(S, T),), out_specs=RP(S, None)))
    want = np.asarray(fn(_put(rm, grid)))
    got = sp.cell_map(
        functools.partial(sp.sp_hannan_rissanen, d_dead=1, p=2, q=2, n=256),
        mesh=pm, in_specs=(P(S, T),), out_specs=P(S, None))(_t(grid)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-10)
    flat = arima.hannan_rissanen_batched(
        _t(yd), (2, 0, 2), True, torch.full((8,), 255, dtype=torch.int32))
    np.testing.assert_allclose(got, flat.numpy(), rtol=1e-6, atol=1e-10)


def _garch_returns():
    return np.stack([np.asarray(ref_garch.sample(
        jnp.asarray([0.1, 0.15, 0.75]), jax.random.key(i), 256))
        for i in range(8)])


def test_garch_objective_matches_the_reference(mesh2d):
    pm, rm = mesh2d
    r = _garch_returns()
    params = np.tile([0.08, 0.12, 0.8], (8, 1))
    h0 = r.var(axis=1)
    fn = jax.jit(rsp.shard_map(
        rsp.sp_garch_neg_loglik, mesh=rm,
        in_specs=(RP(S, None), RP(S, T), RP(S)), out_specs=RP(S)))
    want = np.asarray(fn(_put(rm, params, RP(S, None)), _put(rm, r),
                         _put(rm, h0, RP(S))))
    got = sp.cell_map(sp.sp_garch_neg_loglik, mesh=pm,
                      in_specs=(P(S, None), P(S, T), P(S)),
                      out_specs=P(S))(_t(params), _t(r), _t(h0)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(
        got, garch.neg_log_likelihood(_t(params), _t(r)).numpy(), rtol=1e-6)


# ---------------------------------------------------------------------------
# fits
# ---------------------------------------------------------------------------


def _hold(got, want, *, params_atol, nll_rtol=None, share=0.7):
    both = got.converged.numpy() & np.asarray(want.converged)
    assert both.mean() >= share
    np.testing.assert_allclose(got.params.numpy()[both],
                               np.asarray(want.params)[both],
                               atol=params_atol)
    if nll_rtol is not None:
        np.testing.assert_allclose(
            got.neg_log_likelihood.numpy()[both],
            np.asarray(want.neg_log_likelihood)[both], rtol=nll_rtol)


def test_ewma_fit_matches_the_reference_and_unsharded(mesh2d):
    pm, rm = mesh2d
    rng = np.random.default_rng(24)
    level = np.cumsum(0.2 * rng.normal(size=(8, 64)), axis=1)
    y = level + rng.normal(size=(8, 64))  # an interior optimum
    got = sp.sp_ewma_fit(pm, _t(y))
    assert bool(got.converged.all()) and float(got.params.max()) < 0.9
    _hold(got, rsp.sp_ewma_fit(rm, _put(rm, y)), params_atol=1e-4)
    _hold(got, ewma.fit(_t(y), backend="eager", device="cpu"),
          params_atol=1e-4, share=1.0)


def test_garch_fit_matches_the_reference_and_unsharded(mesh2d):
    pm, rm = mesh2d
    r = _garch_returns()
    got = sp.sp_garch_fit(pm, _t(r))
    _hold(got, rsp.sp_garch_fit(rm, _put(rm, r)), params_atol=1e-3)
    _hold(got, garch.fit(_t(r), backend="eager", device="cpu"),
          params_atol=1e-3)


def test_argarch_fit_matches_the_reference_and_unsharded(mesh2d):
    pm, rm = mesh2d
    y = np.stack([np.asarray(ref_garch.argarch_sample(
        jnp.asarray([0.2, 0.5, 0.05, 0.1, 0.85]), jax.random.key(i), 256))
        for i in range(8)])
    got = sp.sp_argarch_fit(pm, _t(y))
    _hold(got, rsp.sp_argarch_fit(rm, _put(rm, y)), params_atol=2e-3,
          nll_rtol=1e-5)
    _hold(got, garch.fit_argarch(_t(y), backend="eager", device="cpu"),
          params_atol=2e-3, nll_rtol=1e-5)


def test_arima_fit_matches_the_reference_and_unsharded(mesh2d):
    pm, rm = mesh2d
    y = gen_arma_panel(8, 256, seed=23).astype(np.float64)
    got = sp.sp_arima_fit(pm, _t(y), (1, 1, 1))
    _hold(got, rsp.sp_arima_fit(rm, _put(rm, y), (1, 1, 1)),
          params_atol=5e-3, nll_rtol=1e-5)
    _hold(got, arima.fit(_t(y), (1, 1, 1), backend="eager", device="cpu"),
          params_atol=5e-3, nll_rtol=1e-5)


def test_general_order_arima_fit_matches_unsharded(mesh2d):
    pm, _ = mesh2d
    y = gen_arma22_panel(8, 256, seed=29).astype(np.float64)
    got = sp.sp_arima_fit(pm, _t(y), (2, 1, 2))
    _hold(got, arima.fit(_t(y), (2, 1, 2), backend="eager", device="cpu"),
          params_atol=5e-3, nll_rtol=1e-5, share=0.6)


def test_float32_fit_on_a_one_dimensional_mesh():
    pm = meshlib.default_mesh(devices=[CPU] * 4)  # time unsplit
    y = gen_arma_panel(8, 128, seed=5).astype(np.float32)
    got = sp.sp_arima_fit(pm, torch.as_tensor(y), (1, 1, 1))
    assert got.params.dtype == torch.float32
    _hold(got, arima.fit(torch.as_tensor(y), (1, 1, 1), backend="eager",
                         device="cpu"), params_atol=5e-3)


@pytest.mark.parametrize("fit,t,k", [
    (lambda m, v: sp.sp_arima_fit(m, v, (1, 1, 1)), 8, 3),
    (sp.sp_garch_fit, 8, 3),
    (sp.sp_argarch_fit, 10, 5),
])
def test_too_short_panels_come_back_nan(fit, t, k):
    pm = meshlib.default_mesh(devices=[CPU] * 8, time_shards=2)
    y = torch.as_tensor(np.random.default_rng(31).normal(size=(8, t)))
    r = fit(pm, y)
    assert r.params.shape == (8, k)
    assert bool(torch.isnan(r.params).all())
    assert bool(torch.isnan(r.neg_log_likelihood).all())
    assert not bool(r.converged.any()) and not bool(r.iters.any())


def test_too_short_gate_matches_the_reference(mesh2d):
    pm, rm = mesh2d
    y = np.random.default_rng(31).normal(size=(8, 8))
    want = rsp.sp_arima_fit(rm, _put(rm, y), (1, 1, 1))
    got = sp.sp_arima_fit(pm, _t(y), (1, 1, 1))
    assert bool(np.isnan(np.asarray(want.params)).all())
    np.testing.assert_array_equal(got.params.numpy(), np.asarray(want.params))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))


def test_lag_reach_wider_than_a_shard_raises(cpu_devices):
    pm, rm = _meshes(8)
    y = np.random.default_rng(33).normal(size=(1, 32))
    with pytest.raises(ValueError, match="lag reach"):
        rsp.sp_arima_fit(rm, _put(rm, y), (2, 1, 2))
    with pytest.raises(ValueError, match="lag reach"):
        sp.sp_arima_fit(pm, _t(y), (2, 1, 2))
    with pytest.raises(ValueError, match="lag reach"):  # any halo
        sp.sp_autocorr_sharded(pm, _t(np.zeros((8, 32))), 5)


def test_cell_map_checks_the_split():
    pm = meshlib.default_mesh(devices=[CPU] * 8, time_shards=2)
    with pytest.raises(ValueError, match="series shards"):
        sp.sp_moments_sharded(pm, torch.zeros(6, 8))
    with pytest.raises(ValueError, match="time shards"):
        sp.sp_moments_sharded(pm, torch.zeros(8, 9))
