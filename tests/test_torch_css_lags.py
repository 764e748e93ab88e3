"""The CSS kernels' structural lags (``lags=``) on the CPU, against the JAX
package.

A seasonal expansion makes only a few lag coefficients non-zero (the
airline model (0,1,1)(0,1,1,24): MA lags 1, 24 and 25 of 25), and the
port's kernels walk only the lags listed.  Held here, through the
wrappers (which run their plain versions on CPU tensors):

(a) on expanded rows, the plain versions with the support equal the dense
    plain versions exactly (``torch.equal``: the dense ones only add
    products with zero coefficients) in every forward mode and on the
    listed gradient columns, and the unlisted gradient columns are 0;
(b) ``arima._lag_support`` covers every slot the reference's
    ``_expand_seasonal_poly`` makes non-zero at random parameters and
    lists no slot whose Jacobian is zero there;
(c) the seasonal objective through ``css_sse_folded(..., lags=...)`` (as
    the seasonal fit runs it) matches the reference's
    ``sarima_neg_loglik``, value and gradient, within 1e-5 in float32;
(d) the fused grid's compacted objective, with the union of the orders'
    supports, matches the per-order objective cell by cell.
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
from spark_timeseries_tpu_torch.utils import optim as toptim

SEASONAL = [((0, 0, 1), (0, 0, 1, 24)), ((1, 0, 1), (1, 0, 1, 24)),
            ((2, 0, 2), (2, 0, 2, 4)), ((1, 0, 0), (2, 0, 0, 7)),
            ((0, 0, 2), (0, 0, 2, 12)), ((3, 0, 1), (1, 0, 2, 5)),
            ((1, 0, 1), (1, 0, 1, 52))]


def _ids(cases):
    return [f"{o}{s}" for o, s in cases]


def _rows(b, order, seasonal, seed):
    """Expanded kernel rows of random parameters in (-0.3, 0.3) (numpy
    draws), with the order's (p_full, q_full) and support."""
    k = tarima._n_params_seasonal(order, seasonal, True)
    rng = np.random.default_rng(seed)
    pr = torch.as_tensor((0.3 * rng.uniform(-1, 1, size=(b, k)))
                         .astype(np.float32))
    p, q, _ = tarima.seasonal_lag_span(order, seasonal)
    return (tarima._sarima_kernel_params(pr, order, seasonal, True), p, q,
            tarima._lag_support(order, seasonal))


def _panel(b, t, p, seed):
    rng = np.random.default_rng(seed)
    yd = torch.as_tensor(rng.normal(size=(b, t)).astype(np.float32))
    nv = torch.as_tensor(rng.integers(t // 2, t + 1, size=b)
                         .astype(np.int32))
    yt, zb = layout.css_prefold(yd, (p, 0, 0), nv)
    return yd, nv, yt, zb


# (a) ---------------------------------------------------------------------


@pytest.mark.parametrize("order,seasonal", SEASONAL, ids=_ids(SEASONAL))
def test_support_equals_every_lag_on_expanded_rows(order, seasonal):
    b = 12
    params, p, q, lags = _rows(b, order, seasonal, seed=sum(order) + 3)
    t = max(p, q) + 40
    _, _, yt, zb = _panel(b, t, p, seed=t)
    for mode in ("e", "sum", "tail"):
        dense = ck.css_fwd(yt, params, zb, p, q, mode)
        sparse = ck.css_fwd(yt, params, zb, p, q, mode, lags=lags)
        assert torch.equal(sparse, dense), mode
    e, sse = ck.css_fwd(yt, params, zb, p, q, "both", lags=lags)
    assert torch.equal(sse, ck.css_fwd(yt, params, zb, p, q, "sum",
                                       lags=lags))
    listed = [0, *lags[0], *(p + j for j in lags[1])]
    unlisted = [c for c in range(1 + p + q) if c not in listed]
    rng = np.random.default_rng(t)
    for cot in (torch.as_tensor(rng.uniform(size=b).astype(np.float32)),
                torch.as_tensor(rng.normal(size=(t, b)).astype(np.float32))):
        gd, gyd = ck.css_bwd(yt, e, params, zb, cot, p, q, True)
        gs, gys = ck.css_bwd(yt, e, params, zb, cot, p, q, True, lags=lags)
        assert torch.equal(gs[:, listed], gd[:, listed])
        assert torch.equal(gs[:, unlisted],
                           torch.zeros(b, len(unlisted)))
        assert torch.equal(gys, gyd)


def test_lags_reads_only_the_listed_coefficients():
    # an unlisted coefficient is read as 0 whatever the row holds
    b, p, q = 6, 5, 4
    _, _, yt, zb = _panel(b, 40, p, seed=1)
    rng = np.random.default_rng(2)
    params = torch.as_tensor((0.2 * rng.normal(size=(b, 1 + p + q)))
                             .astype(np.float32))
    lags = ((1, 4), (2,))
    masked = params.clone()
    masked[:, [2, 3, 5, p + 1, p + 3, p + 4]] = 0.0
    for mode in ("e", "sum", "tail"):
        assert torch.equal(ck.css_fwd(yt, params, zb, p, q, mode, lags=lags),
                           ck.css_fwd(yt, masked, zb, p, q, mode))


@pytest.mark.parametrize("p,q,lags,norm", [
    (2, 1, ((1, 2), (1,)), None), (2, 1, ((2, 1, 2), [1]), None),
    (0, 0, ((), ()), None), (25, 25, ((1, 24, 25), (25, 1, 24)),
                             ((1, 24, 25), (1, 24, 25))),
    (3, 0, ((3,), ()), ((3,), ()))])
def test_lags_normalize(p, q, lags, norm):
    assert ck._css_lags(p, q, lags) == norm


@pytest.mark.parametrize("lags", [((0,), ()), ((4,), ()), ((), (3,)),
                                  ((1,), (-1,))])
def test_lags_outside_the_order_raise(lags):
    yt = torch.zeros(10, 2)
    with pytest.raises(ValueError, match="outside"):
        ck.css_fwd(yt, torch.zeros(2, 6), torch.zeros(2), 3, 2, "sum",
                   lags=lags)


# (b) ---------------------------------------------------------------------

SUPPORT_CASES = [((p, 0, q), (P, 0, Q, s)) for s in (4, 7, 12, 24)
                 for p, q, P, Q in ((0, 1, 0, 1), (1, 1, 1, 1), (2, 2, 2, 2),
                                    (3, 0, 1, 0), (0, 0, 2, 1),
                                    (1, 2, 0, 2))] + [((2, 0, 1), None)]


@pytest.mark.parametrize("order,seasonal", SUPPORT_CASES,
                         ids=_ids(SUPPORT_CASES))
def test_support_matches_the_reference_expansion(order, seasonal):
    p, _, q = order
    P, _, Q, s = seasonal if seasonal is not None else (0, 0, 0, 1)
    rng = np.random.default_rng(p + 3 * q + 7 * P + 11 * Q + s)
    ar, ma = tarima._lag_support(order, seasonal)
    for n, N, cross, lags in ((p, P, -1.0, ar), (q, Q, 1.0, ma)):
        v = jnp.asarray(rng.uniform(-0.9, 0.9, size=n))
        w = jnp.asarray(rng.uniform(-0.9, 0.9, size=N))
        full = np.asarray(jarima._expand_seasonal_poly(v, w, s, cross))
        assert set(np.flatnonzero(full) + 1) <= set(lags)
        if n + N == 0:
            assert lags == ()
            continue
        jac = np.concatenate([np.asarray(j).reshape(len(full), -1) for j in
                              jax.jacfwd(lambda a, b: jarima
                                         ._expand_seasonal_poly(a, b, s,
                                                                cross),
                                         argnums=(0, 1))(v, w)], axis=1)
        nonzero = set(np.flatnonzero(np.abs(jac).sum(1)) + 1)
        assert nonzero == set(lags)
        assert list(lags) == sorted(lags)


# (c) ---------------------------------------------------------------------

OBJ_SPECS = [((0, 1, 1), (0, 1, 1)), ((1, 0, 1), (1, 1, 1)),
             ((2, 0, 0), (1, 0, 0)), ((0, 0, 2), (0, 0, 2))]


@pytest.mark.parametrize("s", [4, 12, 24])
@pytest.mark.parametrize("order,sea", OBJ_SPECS)
def test_objective_with_support_matches_reference(s, order, sea):
    seasonal = (sea[0], sea[1], sea[2], s)
    p_full, q_full, _ = tarima.seasonal_lag_span(order, seasonal)
    t = 2 * s + 60
    rng = np.random.default_rng(s + 17)
    yd = rng.normal(size=(5, t)).astype(np.float32)
    nv = np.full(5, t, np.int32)
    nv[1] = t - 13
    k = jarima._n_params_seasonal(order, seasonal, True)
    pr = (0.3 * rng.uniform(-1, 1, size=(5, k))).astype(np.float32)
    ref_v, ref_g = jax.vmap(jax.value_and_grad(
        lambda a, v, n: jarima.sarima_neg_loglik(a, v, order, seasonal, True,
                                                 n)))(
        jnp.asarray(pr), jnp.asarray(yd), jnp.asarray(nv))
    yt, zb = layout.css_prefold(torch.as_tensor(yd), (p_full, 0, q_full),
                                torch.as_tensor(nv))
    pt = torch.as_tensor(pr).requires_grad_(True)
    css = ck.css_sse_folded(
        tarima._sarima_kernel_params(pt, order, seasonal, True), yt, zb,
        p_full, q_full, lags=tarima._lag_support(order, seasonal))
    got = tarima._concentrated(css, torch.as_tensor(nv).float() - p_full)
    (g,) = torch.autograd.grad(got.sum(), pt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref_v),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), rtol=1e-5,
                               atol=1e-5)


def _spy_sse(monkeypatch):
    """Record the ``lags`` of every ``css_sse_folded`` call."""
    seen = []
    real = ck.css_sse_folded

    def spy(*args, lags=None, **kw):
        seen.append(lags)
        return real(*args, lags=lags, **kw)

    monkeypatch.setattr(ck, "css_sse_folded", spy)
    return seen


@pytest.mark.parametrize("order,seasonal", [((0, 1, 1), (0, 1, 1, 12)),
                                            ((1, 0, 0), (1, 1, 0, 4))])
def test_seasonal_fit_passes_its_support(monkeypatch, order, seasonal):
    # the cuda backend's seasonal fit (on the CPU, through the plain
    # versions) evaluates its objective with the order's support only, and
    # lands where the eager fit does
    rng = np.random.default_rng(3)
    y = torch.as_tensor(rng.normal(size=(8, 90)).cumsum(1)
                        .astype(np.float32))
    seen = _spy_sse(monkeypatch)
    with torch.no_grad():
        got = tarima._fit_sarima(y, order, seasonal, True, "cuda", 30, 1e-4,
                                 None, tbase.align_mode_on_host(y), True)
    assert seen and set(seen) == {tarima._lag_support(order, seasonal)}
    ref = tarima.fit(y, order, seasonal=seasonal, max_iters=30,
                     backend="eager", device="cpu")
    both = got.converged & ref.converged
    assert both.float().mean() > 0.5
    np.testing.assert_allclose(got.params[both].numpy(),
                               ref.params[both].numpy(), atol=1e-3)


# (d) ---------------------------------------------------------------------

GRIDS = {
    "seasonal 12": (((0, 1, 1), (0, 1, 1, 12)), ((1, 1, 0), (1, 1, 0, 12)),
                    ((1, 1, 1), (1, 1, 1, 12))),
    "mixed 7": (((2, 1, 0), (1, 1, 0, 7)), ((0, 1, 2), (0, 1, 1, 7)),
                ((1, 1, 1), (1, 1, 0, 7))),
}


def test_grid_union_is_the_union_of_the_supports():
    for specs in GRIDS.values():
        infos = [tarima._grid_spec_info(o, s, True) for o, s in specs]
        k_max = max(i["k"] for i in infos)
        p_max = max(i["p_full"] for i in infos)
        q_max = max(i["q_full"] for i in infos)
        maps = tarima._grid_coef_maps(infos, True, k_max, p_max, q_max)
        ar, ma = zip(*(tarima._lag_support(o, s) for o, s in specs))
        assert tarima._grid_lag_union(maps, p_max, q_max) == (
            tuple(sorted(set().union(*ar))), tuple(sorted(set().union(*ma))))


@pytest.mark.parametrize("grid", GRIDS)
def test_compacted_grid_objective_with_the_union_matches_per_order(
        monkeypatch, grid):
    specs = GRIDS[grid]
    b = 48  # 144 cells: above the 128-cell least cap, so a gather exists
    rng = np.random.default_rng(9)
    y = torch.as_tensor(rng.normal(size=(b, 70)).cumsum(1)
                        .astype(np.float32))
    infos = [tarima._grid_spec_info(o, s, True) for o, s in specs]
    k_max = max(i["k"] for i in infos)
    p_max = max(i["p_full"] for i in infos)
    q_max = max(i["q_full"] for i in infos)
    x0 = torch.as_tensor((0.2 * rng.uniform(-1, 1, size=(
        len(infos) * b, k_max))).astype(np.float32))
    for g, info in enumerate(infos):  # pad slots at 0, as the fit has them
        x0[g * b:(g + 1) * b, info["k"]:] = 0.0
    captured = {}
    real = toptim.minimize_lbfgs_batched

    def spy(fb, x, **kw):
        captured["fb"], captured["sf"] = fb, kw["straggler_fun"]
        return real(fb, x, max_iters=0)

    monkeypatch.setattr(tarima, "_GRID_COMPACT_MIN_CELLS", 1)
    monkeypatch.setattr(tarima.optim, "minimize_lbfgs_batched", spy)
    seen = _spy_sse(monkeypatch)
    with torch.no_grad():
        tarima._fit_grid(y, infos, True, "cuda", 5, 1e-4,
                         tbase.align_mode_on_host(y))
    idx = torch.arange(x0.shape[0])
    seen.clear()
    f_main, g_main = toptim._value_and_grad(captured["fb"], x0)
    assert seen == [tarima._lag_support(o, s) for o, s in specs]
    seen.clear()
    f_cell, g_cell = toptim._value_and_grad(captured["sf"](idx), x0)
    maps = tarima._grid_coef_maps(infos, True, k_max, p_max, q_max)
    assert seen == [tarima._grid_lag_union(maps, p_max, q_max)]
    assert ck.css_route(p_max, q_max, seen[0]) == "lag"
    np.testing.assert_allclose(f_cell.numpy(), f_main.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(g_cell.numpy(), g_main.numpy(), rtol=1e-5,
                               atol=1e-5)
    for g, info in enumerate(infos):
        assert not g_cell[g * b:(g + 1) * b, info["k"]:].any()
