"""The PyTorch port's kernel module against the JAX package (the CSS,
Hannan-Rissanen and GARCH kernels; the transforms' kernels are in
``test_torch_transforms.py``).

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
from spark_timeseries_tpu.models import garch as jgarch
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
    assert ck.LAUNCHES == {"css_fwd": 0, "css_bwd": 0, "hr_moments": 0,
                           "fill_chain": 0, "autocorr": 0, "garch_fwd": 0,
                           "garch_bwd": 0}


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
