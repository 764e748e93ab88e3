"""The port's fused order grid (``arima.fit_grid``) against the JAX package.

Two groups: a plain one, (1,1,0), (0,1,1), (1,1,1) and (2,1,2), and a
seasonal one, (0,1,1)(0,1,1,4), (1,1,0)(1,1,0,4) and (1,1,1)(1,1,1,4).
The helpers (pack width, differencing signatures, coefficient maps) must
equal the reference's exactly, and the pack must match the reference's
layout column for column.  In float64 both take the same optimizer steps:
the eligibility, status and converged columns are equal, the parameters
and nll within 1e-6.  In float32 the eligibility columns are equal and the
rest is held at the distribution level, per order (each status's share
within 0.1, median parameter difference under 1e-2 and 90 % of the nll
within 1e-2 relative where both converged): the over-parametrized
(2,1,2) order sits on a ridge where float32 rounding of the recursion's
sums sends single rows to different points.  (The reference's own float32
and float64 fits of the plain group differ in the status of 17 of its 96
rows on that order.)  The cuda backend's driver
runs on the CPU through the kernels' plain versions.  Straggler compaction
is forced on (the gate patched) and held against the uncompacted fit, the
compacted cell objective against the per-order one (1e-5, value and
gradient), and at the cell level a narrower order's pad columns stay
exactly 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu.models import arima as jarima
from spark_timeseries_tpu_torch.models import arima as tarima
from spark_timeseries_tpu_torch.models import base as tbase
from spark_timeseries_tpu_torch.utils import optim as toptim

PLAIN = (((1, 1, 0), None), ((0, 1, 1), None), ((1, 1, 1), None),
         ((2, 1, 2), None))
SEASONAL = (((0, 1, 1), (0, 1, 1, 4)), ((1, 1, 0), (1, 1, 0, 4)),
            ((1, 1, 1), (1, 1, 1, 4)))
MIXED = (((1, 1, 0), None), ((0, 1, 1), (0, 1, 1, 4)),
         ((1, 1, 1), (1, 0, 0, 12)), ((0, 1, 0), (0, 1, 0, 12)))
GROUPS = {"plain": PLAIN, "seasonal": SEASONAL}


def _panel(b, t, seasonal, seed):
    """ARIMA(1,1,1) rows (phi 0.6, theta 0.3); with ``seasonal`` an added
    period-4 profile and a seasonal MA term.  Row 0 starts late, row 1
    ends early."""
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(b, t))
    x = np.zeros_like(e)
    for i in range(1, t):
        x[:, i] = 0.6 * x[:, i - 1] + e[:, i] + 0.3 * e[:, i - 1]
        if seasonal and i >= 4:
            x[:, i] += 0.4 * e[:, i - 4]
    y = np.cumsum(x, axis=1)
    if seasonal:
        y += 3.0 * np.sin(np.arange(t) * np.pi / 2)[None, :]
    y[0, :11] = np.nan
    y[1, -7:] = np.nan
    return y


def _fit_kernel_path(y, specs, max_iters):
    """The cuda backend's grid driver on a CPU float32 tensor."""
    yb = torch.as_tensor(y)
    infos = [tarima._grid_spec_info(o, s, True) for o, s in specs]
    with torch.no_grad():
        return tarima._fit_grid(yb, infos, True, "cuda", max_iters, 1e-4,
                                tbase.align_mode_on_host(yb))


@pytest.mark.parametrize("specs", [PLAIN, SEASONAL, MIXED],
                         ids=["plain", "seasonal", "mixed"])
@pytest.mark.parametrize("intercept", [True, False])
def test_grid_helpers_match_reference(specs, intercept):
    assert tarima.grid_pack_width(specs, intercept) == \
        jarima.grid_pack_width(specs, intercept)
    assert tarima.grid_diff_cache_keys(specs) == \
        jarima.grid_diff_cache_keys(specs)
    assert tarima.GRID_PACK_COLS == jarima.GRID_PACK_COLS
    infos = [tarima._grid_spec_info(o, s, intercept) for o, s in specs]
    rinfos = [jarima._grid_spec_info(o, s, intercept) for o, s in specs]
    assert infos == rinfos
    dims = (max(i["k"] for i in infos), max(i["p_full"] for i in infos),
            max(i["q_full"] for i in infos))
    for a, b in zip(tarima._grid_coef_maps(infos, intercept, *dims),
                    jarima._grid_coef_maps(rinfos, intercept, *dims)):
        np.testing.assert_array_equal(a, b)


def _blocks(pack, specs, intercept=True):
    """Per order: (params [B, k_max], nll, eligible, converged, iters,
    status) columns of a pack."""
    infos = [tarima._grid_spec_info(o, s, intercept) for o, s in specs]
    k_max = max(i["k"] for i in infos)
    w = k_max + tarima.GRID_PACK_COLS
    pack = np.asarray(pack)
    return [(pack[:, g * w:g * w + k_max],) + tuple(
        pack[:, g * w + k_max + j] for j in range(5))
        for g in range(len(infos))]


def _hold_pack(got, ref, specs, tol=None):
    """The pack against the reference's.  ``tol`` (float64): statuses and
    converged columns equal, parameters and nll within ``tol``.  ``None``
    (float32): the distribution bar of the plain fit's tests, per order."""
    assert got.params.shape == ref.params.shape
    assert np.isfinite(got.params.numpy()).all()
    for (gp, gn, ge, gc, gi, gs), (rp, rn, re_, rc, ri, rs) in zip(
            _blocks(got.params, specs), _blocks(ref.params, specs)):
        np.testing.assert_array_equal(ge, re_)  # eligibility
        both = (gc > 0) & (rc > 0)
        if tol is not None:
            np.testing.assert_array_equal(gs, rs)  # status
            np.testing.assert_array_equal(gc, rc)  # converged
            np.testing.assert_allclose(gp[both], rp[both], rtol=tol, atol=tol)
            np.testing.assert_allclose(gn[both], rn[both], rtol=tol)
            continue
        for code in np.unique(np.r_[gs, rs]):
            assert abs((gs == code).mean() - (rs == code).mean()) <= 0.1
        assert both.mean() > 0.7
        assert float(np.median(np.abs(gp[both] - rp[both]))) < 1e-2
        rel = np.abs(gn[both] - rn[both]) / np.maximum(np.abs(rn[both]), 1e-6)
        assert (rel > 1e-2).mean() <= 0.1
    if tol is not None:
        np.testing.assert_array_equal(got.status.numpy(),
                                      np.asarray(ref.status))


@pytest.fixture(scope="module")
def panels():
    return {name: _panel(96, 100, name == "seasonal", seed=i)
            for i, name in enumerate(GROUPS)}


@pytest.fixture(scope="module")
def jax_grids(panels):
    out = {}
    for name, specs in GROUPS.items():
        y = panels[name]
        out[name, "f32"] = jarima.fit_grid(jnp.asarray(y, jnp.float32), specs)
        out[name, "f64"] = jarima.fit_grid(jnp.asarray(y), specs,
                                           max_iters=40)
    return out


@pytest.mark.parametrize("group", list(GROUPS))
@pytest.mark.parametrize("path", ["eager", "kernel"])
def test_fit_grid_matches_reference_float32(panels, jax_grids, group, path):
    specs = GROUPS[group]
    y = panels[group].astype(np.float32)
    if path == "eager":
        got = tarima.fit_grid(y, specs, device="cpu")
    else:
        got = _fit_kernel_path(y, specs, 60)
    _hold_pack(got, jax_grids[group, "f32"], specs)


@pytest.mark.parametrize("group", list(GROUPS))
def test_fit_grid_matches_reference_float64(panels, jax_grids, group):
    specs = GROUPS[group]
    got = tarima.fit_grid(panels[group], specs, max_iters=40, device="cpu")
    _hold_pack(got, jax_grids[group, "f64"], specs, 1e-6)


def test_mixed_signatures_match_reference():
    y = _panel(40, 90, True, seed=7)
    ref = jarima.fit_grid(jnp.asarray(y), MIXED, max_iters=30)
    got = tarima.fit_grid(y, MIXED, max_iters=30, device="cpu")
    _hold_pack(got, ref, MIXED, 1e-6)


def _spy_optimizer(monkeypatch):
    """Record each lockstep loop's batch width and the final result."""
    seen = {"widths": [], "res": None}
    real_run, real_min = toptim._run, toptim.minimize_lbfgs_batched

    def run(fb, state, k, max_iters, stop_at, knobs):
        seen["widths"].append(int(state.x.shape[0]))
        return real_run(fb, state, k, max_iters, stop_at, knobs)

    def minimize(*a, **kw):
        seen["res"] = real_min(*a, **kw)
        return seen["res"]

    monkeypatch.setattr(toptim, "_run", run)
    monkeypatch.setattr(tarima.optim, "minimize_lbfgs_batched", minimize)
    return seen


@pytest.mark.parametrize("group", list(GROUPS))
@pytest.mark.parametrize("path", ["eager", "kernel"])
def test_compaction_matches_no_compaction(monkeypatch, panels, group, path):
    specs = GROUPS[group]
    y = panels[group].astype(np.float32)

    def run():
        if path == "eager":
            return tarima.fit_grid(y, specs, max_iters=40, device="cpu")
        return _fit_kernel_path(y, specs, 40)

    monkeypatch.setattr(tarima, "_GRID_COMPACT_MIN_CELLS", 10 ** 9)
    ref = run()
    monkeypatch.setattr(tarima, "_GRID_COMPACT_MIN_CELLS", 64)
    seen = _spy_optimizer(monkeypatch)
    got = run()
    cells = len(specs) * y.shape[0]
    cap = -(-max(128, cells // 4) // 128) * 128
    assert seen["widths"] == [cells, cap]  # the stragglers ran on the cap
    for (gp, _, ge, gc, _, gs), (rp, _, re_, rc, _, rs) in zip(
            _blocks(got.params, specs), _blocks(ref.params, specs)):
        np.testing.assert_array_equal(ge, re_)
        assert abs(gc.mean() - rc.mean()) <= 0.02
        both = (gc > 0) & (rc > 0)
        assert float(np.median(np.abs(gp[both] - rp[both]))) < 1e-3
    # at the cell level: every narrower order's pad slots never moved
    infos = [tarima._grid_spec_info(o, s, True) for o, s in specs]
    k_max = max(i["k"] for i in infos)
    xk = seen["res"].x.reshape(len(infos), y.shape[0], k_max)
    for g, info in enumerate(infos):
        assert torch.equal(xk[g, :, info["k"]:],
                           torch.zeros_like(xk[g, :, info["k"]:]))


@pytest.mark.parametrize("path", ["eager", "kernel"])
def test_cell_objective_from_maps_matches_the_per_order_objective(path):
    # the compacted objective at the grid's depth against the main one, on
    # every cell, value and gradient (1e-5 in float32)
    specs = SEASONAL
    b = 48  # 144 cells: above the 128-cell least cap, so a gather exists
    y = torch.as_tensor(_panel(b, 80, True, seed=4).astype(np.float32))
    infos = [tarima._grid_spec_info(o, s, True) for o, s in specs]
    k_max = max(i["k"] for i in infos)
    rng = np.random.default_rng(5)
    x0 = torch.as_tensor((0.2 * rng.uniform(-1, 1, size=(
        len(infos) * b, k_max))).astype(np.float32))
    for g, info in enumerate(infos):  # pad slots at 0, as the fit has them
        x0[g * b:(g + 1) * b, info["k"]:] = 0.0
    captured = {}
    real = toptim.minimize_lbfgs_batched

    def spy(fb, x, **kw):
        captured["fb"], captured["sf"] = fb, kw["straggler_fun"]
        return real(fb, x, max_iters=0)

    mp = pytest.MonkeyPatch()
    mp.setattr(tarima, "_GRID_COMPACT_MIN_CELLS", 1)
    mp.setattr(tarima.optim, "minimize_lbfgs_batched", spy)
    try:
        with torch.no_grad():
            tarima._fit_grid(y, infos, True,
                             "cuda" if path == "kernel" else "eager", 5,
                             1e-4, tbase.align_mode_on_host(y))
    finally:
        mp.undo()
    idx = torch.arange(x0.shape[0])
    f_main, g_main = toptim._value_and_grad(captured["fb"], x0)
    f_cell, g_cell = toptim._value_and_grad(captured["sf"](idx), x0)
    np.testing.assert_allclose(f_cell.numpy(), f_main.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(g_cell.numpy(), g_main.numpy(), rtol=1e-5,
                               atol=1e-5)
    for g, info in enumerate(infos):
        assert not g_cell[g * b:(g + 1) * b, info["k"]:].any()


@pytest.mark.parametrize("bad", [
    dict(specs=(((1, 0, 0), None), ((1, 1, 0), None))),  # mixed d
    dict(specs=()),
    dict(specs=(((1, 0, 0), None),), method="hannan-rissanen")])
def test_fit_grid_refusals_match_reference(bad):
    y = _panel(3, 40, False, seed=1)
    kw = dict(bad)
    specs = kw.pop("specs")
    with pytest.raises(ValueError):
        jarima.fit_grid(jnp.asarray(y), specs, **kw)
    with pytest.raises(ValueError):
        tarima.fit_grid(y, specs, device="cpu", **kw)


def test_single_series_pack(panels):
    y = panels["plain"].astype(np.float32)
    rb = tarima.fit_grid(y[:3], PLAIN, max_iters=30, device="cpu")
    r1 = tarima.fit_grid(y[2], PLAIN, max_iters=30, device="cpu")
    assert tuple(r1.params.shape) == (tarima.grid_pack_width(PLAIN),)
    np.testing.assert_allclose(r1.params.numpy(), rb.params[2].numpy(),
                               rtol=1e-3, atol=1e-3)
