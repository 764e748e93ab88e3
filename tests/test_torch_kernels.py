"""The PyTorch port's kernel module against the JAX package (the CSS,
Hannan-Rissanen, GARCH, EWMA and Holt-Winters kernels; the transforms'
kernels are in ``test_torch_transforms.py``).

On the CPU each wrapper of ``spark_timeseries_tpu_torch.ops.cuda_kernels``
runs its kernel's plain PyTorch version (same arithmetic, same summation
order as the CUDA kernel); here it is held against the reference's Pallas
kernels in interpret mode and against its portable scan implementations,
on the same numpy inputs.  The CUDA kernels themselves are held against
these plain versions on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu.models import arima as jarima
from spark_timeseries_tpu.models import ewma as jewma
from spark_timeseries_tpu.models import garch as jgarch
from spark_timeseries_tpu.models import holtwinters as jhw
from spark_timeseries_tpu.ops import pallas_kernels as pk
from spark_timeseries_tpu.utils import linalg as jlinalg
from spark_timeseries_tpu_torch.models import arima as tarima
from spark_timeseries_tpu_torch.models import garch as tgarch
from spark_timeseries_tpu_torch.ops import cuda_kernels as ck
from spark_timeseries_tpu_torch.ops import layout
from spark_timeseries_tpu_torch.utils import linalg as tlinalg


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


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x)).to(dtype)


ORDERS = [(1, 0, 1), (2, 0, 1), (1, 0, 0), (0, 0, 2)]


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("intercept", [True, False])
def test_css_neg_loglik_matches_reference(order, intercept):
    p, _, q = order
    b, t = 6, 53
    y = _arma_panel(b, t)
    k = int(intercept) + p + q
    params = (np.random.default_rng(1).normal(size=(b, k)) * 0.3
              ).astype(np.float32)
    nv = np.array([t, t - 4, t - 9, t, t - 1, t - 2], np.int32)

    ref_pallas = pk.css_neg_loglik(jnp.asarray(params), jnp.asarray(y), order,
                                   intercept, jnp.asarray(nv), interpret=True)
    ref_scan = jax.vmap(
        lambda pr, v, n: jarima.css_neg_loglik(pr, v, order, intercept, n)
    )(jnp.asarray(params), jnp.asarray(y), jnp.asarray(nv))
    got = ck.css_neg_loglik(_t(params), _t(y), order, intercept,
                            _t(nv, torch.int32))
    got_eager = tarima.css_neg_loglik(_t(params), _t(y), order, intercept,
                                      _t(nv, torch.int32))
    for ref in (ref_pallas, ref_scan):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got_eager.numpy(), np.asarray(ref),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("order", [(1, 0, 1), (2, 0, 2)])
def test_css_param_gradient_matches_jax_grad(order):
    p, _, q = order
    b, t = 5, 41
    y = _arma_panel(b, t, seed=3)
    params = (np.random.default_rng(2).normal(size=(b, 1 + p + q)) * 0.25
              ).astype(np.float32)
    nv = np.array([t, t - 3, t, t - 6, t], np.int32)

    def loss_scan(P):
        return jnp.sum(jax.vmap(
            lambda pr, v, n: jarima.css_neg_loglik(pr, v, order, True, n))(
            P, jnp.asarray(y), jnp.asarray(nv)))

    g_ref = jax.grad(loss_scan)(jnp.asarray(params))
    P = _t(params).requires_grad_(True)
    ck.css_neg_loglik(P, _t(y), order, True, _t(nv, torch.int32)).sum(
    ).backward()
    np.testing.assert_allclose(P.grad.numpy(), np.asarray(g_ref),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("order", [(1, 0, 1), (2, 0, 2), (0, 0, 1)])
def test_css_data_gradient_matches_jax_grad(order):
    p, _, q = order
    b, t = 4, 41
    y = _arma_panel(b, t, seed=7)
    params = (np.random.default_rng(8).normal(size=(b, 1 + p + q)) * 0.25
              ).astype(np.float32)
    nv = np.array([t, t - 3, t - 6, t - t // 3], np.int32)

    def loss_scan(v):
        return jnp.sum(jax.vmap(
            lambda pr, row, n: jarima.css_neg_loglik(pr, row, order, True, n)
        )(jnp.asarray(params), v, jnp.asarray(nv)))

    g_ref = jax.grad(loss_scan)(jnp.asarray(y))
    Y = _t(y).requires_grad_(True)
    ck.css_neg_loglik(_t(params), Y, order, True, _t(nv, torch.int32)).sum(
    ).backward()
    np.testing.assert_allclose(Y.grad.numpy(), np.asarray(g_ref),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("order", [(1, 0, 1), (2, 0, 2)])
def test_css_errors_vjp_matches_reference(order):
    # the general [T, B] cotangent entry of the adjoint (css_errors)
    p, _, q = order
    b, t = 4, 37
    y = _arma_panel(b, t, seed=12)
    rng = np.random.default_rng(13)
    params = (rng.normal(size=(b, 1 + p + q)) * 0.25).astype(np.float32)
    zb = np.array([p, p + 3, p + 5, p], np.float32)
    w = rng.normal(size=(b, t)).astype(np.float32)

    def err_pal(P, v):
        return jnp.sum(jnp.asarray(w) * pk.css_errors(p, q, True, P, v,
                                                      jnp.asarray(zb)))

    e_ref = pk.css_errors(p, q, True, jnp.asarray(params), jnp.asarray(y),
                          jnp.asarray(zb))
    gp_ref, gy_ref = jax.grad(err_pal, argnums=(0, 1))(jnp.asarray(params),
                                                      jnp.asarray(y))
    P, Y = _t(params).requires_grad_(True), _t(y).requires_grad_(True)
    e = ck.css_errors(p, q, P, Y, _t(zb))
    np.testing.assert_allclose(e.detach().numpy(), np.asarray(e_ref),
                               rtol=2e-5, atol=2e-5)
    (_t(w) * e).sum().backward()
    np.testing.assert_allclose(P.grad.numpy(), np.asarray(gp_ref),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(Y.grad.numpy(), np.asarray(gy_ref),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("order", [(1, 0, 1), (0, 0, 2), (2, 0, 3)])
def test_css_last_errors_matches_reference_tail(order):
    p, _, q = order
    b, t = 5, 48
    y = _arma_panel(b, t, seed=14)
    start = np.array([0, 4, 11, 0, 2], np.float32)
    y[np.arange(t)[None, :] < start[:, None]] = 0.0
    params = (np.random.default_rng(15).normal(size=(b, 1 + p + q)) * 0.3
              ).astype(np.float32)
    ref = pk.css_last_errors(p, q, True, jnp.asarray(params), jnp.asarray(y),
                             jnp.asarray(start))
    got = ck.css_last_errors(p, q, _t(params), _t(y), _t(start))
    assert got.shape == (b, q)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("p,q", [(1, 1), (2, 0), (0, 1), (9, 2)])
def test_css_sum_and_both_bitwise(p, q):
    # the optimizer compares f across the value-only and residual-saving
    # passes, so they must agree bit for bit (9 lags: the deep-ring orders)
    b, t = 7, 60
    yt = _t(_arma_panel(b, t, seed=16).T.copy())
    params = _t(np.random.default_rng(17).normal(size=(b, 1 + p + q)) * 0.2)
    zb = _t(np.full(b, p, np.float32))
    s = ck.css_fwd(yt, params, zb, p, q, "sum")
    e, s2 = ck.css_fwd(yt, params, zb, p, q, "both")
    assert torch.equal(s, s2)
    assert torch.equal(e, ck.css_fwd(yt, params, zb, p, q, "e"))


@pytest.mark.parametrize("order", [(1, 0, 1), (2, 0, 2), (1, 0, 0), (0, 0, 1)])
@pytest.mark.parametrize("intercept", [True, False])
def test_hr_init_matches_reference(order, intercept):
    b, t = 6, 80
    y = _arma_panel(b, t, seed=18)
    nv = np.array([t, t - 5, t - 17, t, t - 1, t - 30], np.int32)
    start = t - nv
    y[np.arange(t)[None, :] < start[:, None]] = 0.0  # invalid prefix zeroed
    ref_pallas = pk.hr_init(jnp.asarray(y), order, intercept, jnp.asarray(nv),
                            interpret=True)
    ref_scan = jarima.hannan_rissanen_batched(jnp.asarray(y), order,
                                              intercept, jnp.asarray(nv))
    got = ck.hr_init(_t(y), order, intercept, _t(nv, torch.int32))
    got_eager = tarima.hannan_rissanen_batched(_t(y), order, intercept,
                                               _t(nv, torch.int32))
    for ref in (ref_pallas, ref_scan):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(got_eager.numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("order", [(1, 0, 1), (2, 0, 2), (3, 0, 0)])
def test_hannan_rissanen_float64_matches_reference(order):
    b, t = 5, 90
    y = _arma_panel(b, t, seed=19).astype(np.float64)
    nv = np.array([t, t - 7, t, t - 20, t - 2], np.int32)
    y[np.arange(t)[None, :] < (t - nv)[:, None]] = 0.0
    ref = jarima.hannan_rissanen_batched(jnp.asarray(y, jnp.float64), order,
                                         True, jnp.asarray(nv))
    got = tarima.hannan_rissanen_batched(_t(y, torch.float64), order, True,
                                         _t(nv, torch.int32))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-9,
                               atol=1e-9)


def test_hr_moments_stage_two_matches_rebuilt_residuals():
    # stage 2 rebuilds the AR(m) residual on the fly; check it against the
    # moments of an explicitly materialised residual panel
    b, t, m, p, q = 5, 70, 3, 1, 1
    y = _arma_panel(b, t, seed=20)
    zb = np.array([0, 3, 9, 0, 1], np.float32)
    y[np.arange(t)[None, :] < zb[:, None]] = 0.0
    beta = (np.random.default_rng(21).normal(size=(b, m + 1)) * 0.3
            ).astype(np.float32)
    got = ck.hr_moments(_t(y.T.copy()), _t(zb), p, q, True, m + q, m, _t(beta))
    lag = lambda x, k: np.pad(x, ((0, 0), (k, 0)))[:, :t]  # noqa: E731
    ti = np.arange(t)[None, :]
    pred = beta[:, :1] + sum(beta[:, i:i + 1] * lag(y, i)
                             for i in range(1, m + 1))
    eh = (ti >= zb[:, None] + m) * (y - pred)
    w = (ti >= zb[:, None] + m + q).astype(np.float64)
    cols = [np.ones_like(y), lag(y, 1), lag(eh, 1)]
    ref = [np.sum(w * cols[a] * cols[c], 1) for a in range(3)
           for c in range(a, 3)] + [np.sum(w * cols[a] * y, 1)
                                    for a in range(3)]
    np.testing.assert_allclose(got.numpy(), np.stack(ref, 1), rtol=1e-4,
                               atol=1e-4)


def test_ridge_solve_indefinite_rows_take_the_lu_path():
    rng = np.random.default_rng(22)
    k, b = 3, 6
    X = rng.normal(size=(b, 20, k))
    XtX = np.einsum("bnk,bnl->bkl", X, X).astype(np.float32)
    # rows 1 and 4 indefinite: the unpivoted Cholesky hits a negative pivot
    XtX[1] = np.diag([1.0, -2.0, 3.0]).astype(np.float32)
    XtX[4] = np.array([[1.0, 2.0, 0.0], [2.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
                      np.float32)
    Xty = rng.normal(size=(b, k)).astype(np.float32)
    A = XtX + 1e-8 * np.maximum(np.trace(XtX, axis1=1, axis2=2) / k, 1.0
                                )[:, None, None] * np.eye(k, dtype=np.float32)
    _, bad = tlinalg._chol_solve_unrolled(_t(A), _t(Xty))
    assert bad.tolist() == [False, True, False, False, True, False]
    got = tlinalg.ridge_solve(_t(XtX), _t(Xty))
    ref = jlinalg.ridge_solve(jnp.asarray(XtX), jnp.asarray(Xty))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got.numpy(),
                               np.linalg.solve(A, Xty[..., None])[..., 0],
                               rtol=1e-4, atol=1e-4)


def test_css_prefold_zeroes_prefix_and_sets_zb():
    b, t = 4, 12
    y = _arma_panel(b, t, seed=23) + 5.0
    nv = np.array([12, 9, 5, 12], np.int32)
    yt, zb = layout.css_prefold(_t(y), (2, 0, 1), _t(nv, torch.int32))
    assert yt.shape == (t, b) and yt.is_contiguous()
    start = t - nv
    mask = np.arange(t)[:, None] >= start[None, :]
    np.testing.assert_array_equal(yt.numpy(), np.where(mask, y.T, 0.0))
    np.testing.assert_array_equal(zb.numpy(), start + 2)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contig"])
def test_wrappers_reject_bad_arguments(bad):
    b, t = 4, 10
    yt = torch.zeros(t, b)
    params = torch.zeros(b, 3)
    zb = torch.zeros(b)
    if bad == "dtype":
        yt = yt.double()
    elif bad == "shape":
        params = torch.zeros(b, 4)
    else:
        yt = torch.zeros(b, t).t()
    with pytest.raises((TypeError, ValueError)):
        ck.css_fwd(yt, params, zb, 1, 1, "sum")
    with pytest.raises((TypeError, ValueError)):
        ck.garch_fwd(yt, params, zb, zb, "sum")
    with pytest.raises((TypeError, ValueError)):
        ck.garch_bwd(yt, params, zb, zb, torch.zeros(t, b), zb)
    if bad != "shape":
        with pytest.raises((TypeError, ValueError)):
            ck.fill_chain(yt)
        with pytest.raises((TypeError, ValueError)):
            ck.autocorr(yt, 2)


def test_new_wrappers_reject_bad_modes_and_shapes():
    yt = torch.zeros(10, 4)
    with pytest.raises(ValueError):
        ck.garch_fwd(yt, torch.zeros(4, 3), torch.zeros(4), torch.zeros(4),
                     "tail")
    with pytest.raises(ValueError):
        ck.fill_chain(yt, (False, False, False))
    with pytest.raises(ValueError):
        ck.fill_chain(torch.zeros(10))
    with pytest.raises(ValueError):
        ck.autocorr(yt, 10)
    with pytest.raises(ValueError):  # a [T, B] cotangent of the wrong shape
        ck.garch_bwd(yt, torch.zeros(4, 3), torch.zeros(4), torch.zeros(4),
                     yt, torch.zeros(9, 4))


def test_launch_counts_only_move_on_the_card():
    # on the CPU the wrappers run the plain versions: no launch is counted
    ck.reset_launch_counts()
    yt = torch.randn(20, 3)
    ck.css_fwd(yt, torch.zeros(3, 3), torch.ones(3), 1, 1, "sum")
    ck.hr_moments(yt, torch.zeros(3), 2, 0, True, 2)
    ck.fill_chain(yt)
    ck.autocorr(yt, 3)
    par = torch.tensor([[0.1, 0.1, 0.8]] * 3)
    h, _ = ck.garch_fwd(yt, par, torch.ones(3), torch.zeros(3), "both")
    ck.garch_bwd(yt, par, torch.ones(3), torch.zeros(3), h, torch.ones(3),
                 True)
    zb = torch.zeros(3)
    s, _ = ck.ewma_fwd(yt, torch.full((3,), 0.5), zb, "both")
    ck.ewma_bwd(yt, s, torch.full((3,), 0.5), zb, torch.ones(3), True)
    out = ck.hw_fwd(yt, par, zb, zb, torch.zeros(3, 4), zb, 4, False, True)
    ck.hw_bwd(yt, par, zb, zb, zb, *out[1:4], out[0], torch.ones(3), 4, False)
    assert ck.LAUNCHES == {"css_fwd": 0, "css_bwd": 0, "hr_moments": 0,
                           "fill_chain": 0, "autocorr": 0, "garch_fwd": 0,
                           "garch_bwd": 0, "ewma_fwd": 0, "ewma_bwd": 0,
                           "hw_fwd": 0, "hw_bwd": 0}


# -- GARCH(1,1) kernels -------------------------------------------------------


def _returns(b, t, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(scale=0.5, size=(b, t)).astype(np.float32)


def _garch_params(b, seed):
    rng = np.random.default_rng(seed)
    return np.column_stack([rng.uniform(0.01, 0.2, b),
                            rng.uniform(0.05, 0.2, b),
                            rng.uniform(0.5, 0.8, b)]).astype(np.float32)


def _prefix_zeroed(r, nv):
    t = r.shape[1]
    return np.where(np.arange(t)[None, :] >= (t - nv)[:, None], r, 0.0
                    ).astype(np.float32)


def _jax_nll_scan(P, rz, nv):
    return jax.vmap(lambda pr, rv, n: jgarch.neg_log_likelihood(pr, rv, n))(
        P, rz, nv)


@pytest.mark.parametrize("t", [47, 2100])
def test_garch_neg_loglik_matches_reference(t):
    b = 5
    nv = np.array([t, t - 4, t, t - 9, t - 1], np.int32)
    if t > 1024:
        nv[1] = t - 1200  # the start sits past the first 1024-step chunk
    rz = _prefix_zeroed(_returns(b, t, 11), nv)
    params = _garch_params(b, 12)
    ref = _jax_nll_scan(jnp.asarray(params), jnp.asarray(rz), jnp.asarray(nv))
    got = ck.garch_neg_loglik(_t(params), _t(rz), _t(nv, torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
    if t < 1024:  # the Pallas kernel in interpret mode, at a short length
        ref_pallas = pk.garch_neg_loglik(jnp.asarray(params), jnp.asarray(rz),
                                         jnp.asarray(nv), interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref_pallas),
                                   rtol=1e-5)


@pytest.mark.parametrize("t", [37, 2100])
def test_garch_variances_match_reference(t):
    b = 4
    nv = np.array([t, t - 5, t, t - 2], np.int32)
    r = _returns(b, t, 7)
    params = np.tile([[0.1, 0.15, 0.7]], (b, 1)).astype(np.float32)
    start = (t - nv).astype(np.float32)
    rz = _prefix_zeroed(r, nv)
    h0 = np.asarray(jax.vmap(jgarch._masked_var)(jnp.asarray(r),
                                                 jnp.asarray(nv)))
    ref = jax.vmap(lambda pr, rv, n: jgarch.variances(pr, rv, n))(
        jnp.asarray(params), jnp.asarray(r), jnp.asarray(nv))
    got = ck.garch_variances(_t(params), _t(rz), _t(h0), _t(start))
    mask = np.arange(t)[None, :] >= start[:, None]
    np.testing.assert_allclose(np.where(mask, got.numpy(), 0.0),
                               np.where(mask, np.asarray(ref), 0.0),
                               rtol=1e-5, atol=1e-6)
    if t < 1024:
        ref_pallas = pk.garch_variances(jnp.asarray(params), jnp.asarray(rz),
                                        jnp.asarray(h0), jnp.asarray(start),
                                        interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref_pallas),
                                   rtol=1e-5, atol=1e-6)


def test_garch_sum_and_both_bitwise():
    # the optimizer compares f across the value-only and variance-saving
    # passes, so they must agree bit for bit
    b, t = 6, 300
    rt = _t(_returns(b, t, 3).T.copy())
    zb = _t(np.array([0, 5, 0, 40, 299, 301], np.float32))
    rt[torch.arange(t)[:, None] < zb[None, :]] = 0.0
    params = _t(_garch_params(b, 4))
    h0 = _t(np.full(b, 0.3, np.float32))
    s = ck.garch_fwd(rt, params, h0, zb, "sum")
    h, s2 = ck.garch_fwd(rt, params, h0, zb, "both")
    assert torch.equal(s, s2)
    assert torch.equal(h, ck.garch_fwd(rt, params, h0, zb, "e"))
    assert torch.equal(h[-1], ck.garch_fwd(rt, params, h0, zb, "last"))


@pytest.mark.parametrize("t", [39, 2100])
def test_garch_param_gradient_matches_jax_grad(t):
    b = 4
    nv = np.array([t, t - 5, t - 2, t], np.int32)
    rz = _prefix_zeroed(_returns(b, t, 13), nv)
    params = _garch_params(b, 14)
    g_ref = jax.grad(lambda P: jnp.sum(_jax_nll_scan(
        P, jnp.asarray(rz), jnp.asarray(nv))))(jnp.asarray(params))
    P = _t(params).requires_grad_(True)
    ck.garch_neg_loglik(P, _t(rz), _t(nv, torch.int32)).sum().backward()
    np.testing.assert_allclose(P.grad.numpy(), np.asarray(g_ref), rtol=1e-4,
                               atol=1e-4)


def test_garch_variances_vjp_matches_reference_kernel():
    # the [T, B] cotangent entry of the adjoint, with gradients to the
    # parameters, the returns and the start variance
    b, t = 4, 33
    nv = np.array([t, t - 6, t, t - 1], np.int32)
    rz = _prefix_zeroed(_returns(b, t, 21), nv)
    params = _garch_params(b, 22)
    h0 = np.random.default_rng(23).uniform(0.2, 0.4, b).astype(np.float32)
    start = (t - nv).astype(np.float32)
    w = np.random.default_rng(24).normal(size=(b, t)).astype(np.float32)

    def loss(P, R, H0):
        return jnp.sum(jnp.asarray(w) * pk.garch_variances(
            P, R, H0, jnp.asarray(start), interpret=True))

    refs = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(params), jnp.asarray(rz), jnp.asarray(h0))
    P, R, H0 = (_t(a).requires_grad_(True) for a in (params, rz, h0))
    (_t(w) * ck.garch_variances(P, R, H0, _t(start))).sum().backward()
    for got, ref in zip((P.grad, R.grad, H0.grad), refs):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("t", [45, 2100])
def test_argarch_objective_gradient_matches_jax_grad(t):
    """The returns and h0 cotangents of the adjoint: the AR(1) mean reaches
    the variance recursion through the residuals and the variance seed."""
    b = 4
    pars_nat = np.tile([[0.05, 0.4, 0.02, 0.1, 0.7]], (b, 1))
    y = np.asarray(jax.vmap(lambda pr, k: jgarch.argarch_sample(pr, k, t))(
        jnp.asarray(pars_nat, jnp.float32),
        jax.random.split(jax.random.PRNGKey(0), b))).astype(np.float32)
    nv = np.array([t, t - 3, t, t - 7], np.int32)
    start = (t - nv)[:, None]
    ti = np.arange(t)[None, :]
    ya = np.where(ti >= start, y, 0.0).astype(np.float32)
    u = (np.random.default_rng(15).normal(scale=0.3, size=(b, 5))
         ).astype(np.float32)

    def loss_scan(U):
        nat = jax.vmap(jgarch._argarch_to_natural)(U)
        return jnp.sum(jax.vmap(
            lambda pr, yv, n: jgarch.argarch_neg_log_likelihood(pr, yv, n))(
            nat, jnp.asarray(ya), jnp.asarray(nv)))

    def loss_port(U):
        nat = tgarch._argarch_to_natural(U)
        Y = _t(ya)
        prev = torch.cat([Y[:, :1], Y[:, :-1]], dim=1)
        r = Y - nat[:, 0:1] - nat[:, 1:2] * prev
        r = torch.where(_t(ti <= start, torch.bool), 0.0, r)
        return ck.garch_neg_loglik(nat[:, 2:].contiguous(), r,
                                   _t(nv - 1, torch.int32)).sum()

    U = _t(u).requires_grad_(True)
    val = loss_port(U)
    np.testing.assert_allclose(float(val.detach()),
                               float(loss_scan(jnp.asarray(u))),
                               rtol=1e-5)
    val.backward()
    g_ref = jax.grad(loss_scan)(jnp.asarray(u))
    np.testing.assert_allclose(U.grad.numpy(), np.asarray(g_ref), rtol=1e-4,
                               atol=1e-4)


# -- EWMA kernels ---------------------------------------------------------------


def _ewma_panel(b, t, nv, seed):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.normal(size=(b, t)), axis=1).astype(np.float32)
    return (_prefix_zeroed(x, nv),
            rng.uniform(0.1, 0.9, b).astype(np.float32))


@pytest.mark.parametrize("t", [61, 2100])
def test_ewma_sse_and_alpha_gradient_match_reference(t):
    b = 5
    nv = np.array([t, t - 6, t, t - 11, t - 1], np.int32)
    if t > 1024:
        nv[1] = t - 1100  # the start sits past the first 1024-step chunk
    xz, alpha = _ewma_panel(b, t, nv, 21)
    jx, jnv = jnp.asarray(xz), jnp.asarray(nv)

    def ref_sse(a):
        return pk.ewma_sse(a, jx, jnv, interpret=True)

    A = _t(alpha).requires_grad_(True)
    got = ck.ewma_sse(A, _t(xz), _t(nv, torch.int32))
    ref_scan = jax.vmap(lambda a, v, n: jewma.sse(a, v, n))(
        jnp.asarray(alpha), jx, jnv)
    for ref in (ref_sse(jnp.asarray(alpha)), ref_scan):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=3e-5, atol=2e-5)
    got.sum().backward()
    g_ref = jax.grad(lambda a: jnp.sum(ref_sse(a)))(jnp.asarray(alpha))
    np.testing.assert_allclose(A.grad.numpy(), np.asarray(g_ref), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("want_gx", [False, True])
def test_ewma_data_gradient_matches_reference(monkeypatch, want_gx):
    """The data cotangent, of the SSE and of the smoothed series, and that
    the adjoint kernel is asked for it only when the data needs one."""
    b, t = 4, 61
    nv = np.array([t, t - 7, t - 1, 41], np.int32)
    xz, alpha = _ewma_panel(b, t, nv, 23)
    start = (t - nv).astype(np.float32)
    w = np.random.default_rng(24).normal(size=(b, t)).astype(np.float32)
    asked = []
    real = ck.ewma_bwd

    def spy(xt, st, a, zb, g, want=False):
        asked.append(want)
        return real(xt, st, a, zb, g, want)

    monkeypatch.setattr(ck, "ewma_bwd", spy)
    losses = {
        "sse": (lambda a, x: jnp.sum(pk.ewma_sse(a, x, jnp.asarray(nv),
                                                 interpret=True)),
                lambda a, x: ck.ewma_sse(a, x, _t(nv, torch.int32)).sum()),
        "smooth": (lambda a, x: jnp.sum(jnp.asarray(w) * pk.ewma_smooth(
            a, x, jnp.asarray(start), interpret=True)),
                   lambda a, x: (_t(w) * ck.ewma_smooth(a, x, _t(start))
                                 ).sum()),
    }
    for name, (ref_loss, port_loss) in losses.items():
        ga, gx = jax.grad(ref_loss, argnums=(0, 1))(jnp.asarray(alpha),
                                                    jnp.asarray(xz))
        A = _t(alpha).requires_grad_(True)
        X = _t(xz).requires_grad_(want_gx)
        port_loss(A, X).backward()
        np.testing.assert_allclose(A.grad.numpy(), np.asarray(ga), rtol=1e-4,
                                   atol=1e-4)
        if want_gx:
            np.testing.assert_allclose(X.grad.numpy(), np.asarray(gx),
                                       rtol=1e-4, atol=1e-4)
        else:
            assert X.grad is None
    assert asked == [want_gx, want_gx]


def test_ewma_sum_and_both_bitwise():
    b, t = 6, 300
    xt = _t(np.cumsum(_returns(b, t, 5), axis=1).T.copy())
    zb = _t(np.array([0, 5, 0, 40, 299, 301], np.float32))
    xt[torch.arange(t)[:, None] < zb[None, :]] = 0.0
    alpha = _t(np.linspace(0.05, 0.95, b, dtype=np.float32))
    sse = ck.ewma_fwd(xt, alpha, zb, "sum")
    s, sse2 = ck.ewma_fwd(xt, alpha, zb, "both")
    assert torch.equal(sse, sse2)
    assert torch.equal(s, ck.ewma_fwd(xt, alpha, zb, "e"))
    assert float(sse[5]) == 0.0 and not s[:, 5].any()  # never live


# -- Holt-Winters kernels -------------------------------------------------------


def _seasonal(b, t, m, seed, level=10.0):
    rng = np.random.default_rng(seed)
    tt = np.arange(t)
    return (level + 0.05 * tt[None, :] + 2.0 * np.sin(2 * np.pi * tt / m)
            + rng.normal(scale=0.3, size=(b, t))).astype(np.float32)


def _hw_params(b, seed):
    return np.random.default_rng(seed).uniform(0.05, 0.9, (b, 3)).astype(
        np.float32)


@pytest.mark.parametrize("mult", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
def test_hw_sse_and_gradient_match_reference(mult, ragged):
    b, t, m = 5, 80, 6
    y = _seasonal(b, t, m, 37, level=25.0 if mult else 10.0)
    nv = None
    if ragged:  # the last row is shorter than two seasons: clamped seeds
        nv = np.array([t, t - 11, t - 29, t - 3, 2 * m - 2], np.int32)
        y = _prefix_zeroed(y, nv)
    params = _hw_params(b, 38)
    jy = jnp.asarray(y)
    jnv = None if nv is None else jnp.asarray(nv)

    def ref_sse(P):
        return pk.hw_sse(P, jy, m, mult, jnv, interpret=True)

    P = _t(params).requires_grad_(True)
    got = ck.hw_sse(P, _t(y), m, mult,
                    None if nv is None else _t(nv, torch.int32))
    if nv is None:
        ref_scan = jax.vmap(lambda pr, v: jhw.sse(pr, v, m, mult))(
            jnp.asarray(params), jy)
    else:
        ref_scan = jax.vmap(lambda pr, v, n: jhw.sse(pr, v, m, mult, n))(
            jnp.asarray(params), jy, jnv)
    # the reference's own bars between its kernel and scan backends
    for ref in (ref_sse(jnp.asarray(params)), ref_scan):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=2e-4, atol=1e-3)
    got.sum().backward()
    g_ref = jax.grad(lambda P_: jnp.sum(ref_sse(P_)))(jnp.asarray(params))
    np.testing.assert_allclose(P.grad.numpy(), np.asarray(g_ref), rtol=1e-3,
                               atol=1e-2)


@pytest.mark.parametrize("mult", [False, True])
def test_hw_long_series_matches_reference(mult):
    # T past the reference's 1024-step time chunk, the path's period 24
    b, t, m = 3, 1100, 24
    nv = np.array([t, t - 1050, t - 13], np.int32)
    y = _prefix_zeroed(_seasonal(b, t, m, 45, level=25.0), nv)
    params = np.tile([[0.3, 0.02, 0.2]], (b, 1)).astype(np.float32)
    params[1] = [0.1, 0.01, 0.5]
    jy, jnv = jnp.asarray(y), jnp.asarray(nv)

    def loss_scan(P):
        return jax.vmap(lambda pr, v, n: jhw.sse(pr, v, m, mult, n))(
            P, jy, jnv)

    P = _t(params).requires_grad_(True)
    got = ck.hw_sse(P, _t(y), m, mult, _t(nv, torch.int32))
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(loss_scan(jnp.asarray(params))),
                               rtol=5e-4)
    got.sum().backward()
    g_ref = jax.grad(lambda P_: jnp.sum(loss_scan(P_)))(jnp.asarray(params))
    np.testing.assert_allclose(P.grad.numpy(), np.asarray(g_ref), rtol=2e-3,
                               atol=5e-2)


@pytest.mark.parametrize("mult", [False, True])
def test_hw_error_cotangent_matches_jax_grad(mult):
    """The adjoint fed a [T, B] cotangent of the errors (no per-series
    SSE): against jax.grad of the reference's scan through its errors."""
    b, t, m = 4, 50, 6
    nv = np.array([t, t - 7, t - 20, 2 * m + 1], np.int32)
    y = _prefix_zeroed(_seasonal(b, t, m, 51, level=25.0), nv)
    params = _hw_params(b, 52)
    w = np.random.default_rng(53).normal(size=(b, t)).astype(np.float32)

    def errors(P):
        def one(pr, v, n):
            preds, _ = jhw._run(pr, v, m, mult, n)
            return jnp.where(jnp.arange(t) >= t - n + m, v - preds, 0.0)
        return jax.vmap(one)(P, jnp.asarray(y), jnp.asarray(nv))

    e_ref = errors(jnp.asarray(params))
    g_ref = jax.grad(lambda P: jnp.sum(jnp.asarray(w) * errors(P)))(
        jnp.asarray(params))
    l0, t0, s0r, zb = ck.hw_seeds(_t(y), m, mult, _t(nv, torch.int32))
    yt = layout.time_major(_t(y))
    e, lv, tr, so, _ = ck.hw_fwd(yt, _t(params), l0, t0, s0r, zb, m, mult,
                                 True)
    np.testing.assert_allclose(e.t().numpy(), np.asarray(e_ref), rtol=1e-4,
                               atol=1e-3)
    gpar = ck.hw_bwd(yt, _t(params), l0, t0, zb, lv, tr, so, None,
                     layout.time_major(_t(w)), m, mult)
    np.testing.assert_allclose(gpar.numpy(), np.asarray(g_ref), rtol=1e-3,
                               atol=1e-2)


@pytest.mark.parametrize("mult", [False, True])
@pytest.mark.parametrize("path", ["dense", "general"])
def test_hw_seeds_match_reference(mult, path):
    b, t, m = 7, 120, 24
    y = _seasonal(b, t, m, 41)
    nv = None
    if path == "general":  # incl. spans shorter than two and one season
        nv = np.array([t, 100, 50, 47, 20, 3, 0], np.int32)
        y = _prefix_zeroed(y, nv)
    ref = pk.hw_seeds(jnp.asarray(y), m, mult,
                      None if nv is None else jnp.asarray(nv))
    got = ck.hw_seeds(_t(y), m, mult,
                      None if nv is None else _t(nv, torch.int32))
    # the level is a mean of 24 values near 10, summed in another order
    # than XLA's: a few float32 ulps of the level apart
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-5)
    if nv is None:  # zb = 0, no rotation: the general path at full spans
        full = ck.hw_seeds(_t(y), m, mult, torch.full((b,), t))
        for a, r in zip(got, full):
            np.testing.assert_array_equal(a.numpy(), r.numpy())


@pytest.mark.parametrize("mult", [False, True])
def test_hw_sum_and_save_resid_bitwise(mult):
    # the optimizer compares f across the value-only and trajectory-saving
    # passes, so they must agree bit for bit
    b, t, m = 6, 300, 24
    nv = np.array([t, t - 5, t, t - 40, 30, 0], np.int32)
    y = _t(_prefix_zeroed(_seasonal(b, t, m, 7, level=25.0), nv))
    seeds = ck.hw_seeds(y, m, mult, _t(nv, torch.int32))
    yt, params = layout.time_major(y), _t(_hw_params(b, 8) * 0.5)
    sse = ck.hw_fwd(yt, params, *seeds, m, mult)
    out = ck.hw_fwd(yt, params, *seeds, m, mult, True)
    assert torch.equal(sse, out[-1])
    assert float(sse[5]) == 0.0  # never live


def test_smoothing_wrappers_reject_bad_arguments():
    yt, zb = torch.zeros(10, 4), torch.zeros(4)
    par = torch.full((4, 3), 0.3)
    with pytest.raises(ValueError):
        ck.ewma_fwd(yt, zb, zb, "tail")
    with pytest.raises(TypeError):
        ck.ewma_fwd(yt.double(), zb, zb, "sum")
    with pytest.raises(ValueError):  # a cotangent of neither shape
        ck.ewma_bwd(yt, yt, zb, zb, torch.zeros(9, 4))
    with pytest.raises(ValueError):  # the ring must be [B, period]
        ck.hw_fwd(yt, par, zb, zb, torch.zeros(4, 5), zb, 4, False)
    with pytest.raises(TypeError):  # the per-series cotangent needs e
        ck.hw_bwd(yt, par, zb, zb, zb, yt, yt, yt, None, zb, 4, False)
    assert ck.hw_structural_ok(24) and ck.hw_structural_ok(1024)
    assert not ck.hw_structural_ok(0) and not ck.hw_structural_ok(1025)
    for call in (lambda: ck.hw_sse(par, torch.zeros(4, 2100), 1025),
                 lambda: ck.hw_fwd(torch.zeros(2100, 4), par, zb, zb,
                                   torch.zeros(4, 1025), zb, 1025, False)):
        with pytest.raises(ValueError, match="period"):
            call()
