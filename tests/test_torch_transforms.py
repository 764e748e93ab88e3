"""The PyTorch port's transforms (``ops.univariate``, ``ops.lagmat``, the
fill-chain and autocorrelation kernels) against the JAX package.

Each function runs on the same float32 numpy inputs in both packages.  The
fill-chain and autocorrelation kernels' plain versions (which the wrappers
run for CPU tensors, and which ``chip_smoke.py`` holds the CUDA kernels
against on the card) are compared with the reference's Pallas kernels in
interpret mode and with its portable functions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu.ops import lagmat as jlagmat
from spark_timeseries_tpu.ops import pallas_kernels as pk
from spark_timeseries_tpu.ops import univariate as juv
from spark_timeseries_tpu_torch.ops import cuda_kernels as ck
from spark_timeseries_tpu_torch.ops import lagmat as tlagmat
from spark_timeseries_tpu_torch.ops import layout
from spark_timeseries_tpu_torch.ops import univariate as tuv

RTOL, ATOL = 1e-5, 1e-5  # float32 values


def _gappy(b, t, seed=0, edge_nans=True, gap=0.25):
    """Random walks with NaN gaps; rows 0-3 carry the edge cases: a leading
    run, a trailing run, an all-NaN row and a constant row."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t)).cumsum(axis=1).astype(np.float32)
    x[rng.random(size=(b, t)) < gap] = np.nan
    if edge_nans:
        x[0, :3] = np.nan
        x[1, -4:] = np.nan
        x[2, :] = np.nan
        x[3, :] = 2.5
    return x


def _close(got, ref, rtol=RTOL, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)


# -- the univariate functions, row by row ------------------------------------

_FUNCS = {
    "first_not_nan_loc": (lambda m, x: m.first_not_nan_loc(x)),
    "last_not_nan_loc": (lambda m, x: m.last_not_nan_loc(x)),
    "autocorr": (lambda m, x: m.autocorr(x, 5)),
    "lag": (lambda m, x: m.lag(x, 3)),
    "lags": (lambda m, x: m.lags(x, 3)),
    "lags_no_original": (lambda m, x: m.lags(x, 2, include_original=False)),
    "differences_at_lag": (lambda m, x: m.differences_at_lag(x, 2)),
    "differences_of_order": (lambda m, x: m.differences_of_order(x, 2)),
    "quotients": (lambda m, x: m.quotients(x, 1)),
    "price2ret": (lambda m, x: m.price2ret(x, 2)),
    "fill_value": (lambda m, x: m.fill_value(x, 1.5)),
    "fill_with_default": (lambda m, x: m.fill_with_default(x)),
    "fill_previous": (lambda m, x: m.fill_previous(x)),
    "fill_next": (lambda m, x: m.fill_next(x)),
    "fill_nearest": (lambda m, x: m.fill_nearest(x)),
    "fill_linear": (lambda m, x: m.fill_linear(x)),
    "fillts_zero": (lambda m, x: m.fillts(x, "zero")),
    "fillts_value": (lambda m, x: m.fillts(x, "value", -2.0)),
    "fillts_nearest": (lambda m, x: m.fillts(x, "nearest")),
}


@pytest.mark.parametrize("name", sorted(_FUNCS))
def test_univariate_matches_reference(name):
    fn = _FUNCS[name]
    x = _gappy(6, 41, seed=1) + 10.0  # positive, for the quotients
    ref = jax.jit(jax.vmap(lambda v: fn(juv, v)))(jnp.asarray(x))
    got = tuv.batched(lambda v: fn(tuv, v))(torch.as_tensor(x))
    _close(got, ref)
    # the port's functions also take the whole panel along the last axis
    _close(fn(tuv, torch.as_tensor(x)), ref)
    # and one series
    _close(fn(tuv, torch.as_tensor(x[4])),
           jax.jit(lambda v: fn(juv, v))(jnp.asarray(x[4])))


def test_fill_linear_interior_values():
    x = torch.tensor([np.nan, 1.0, np.nan, np.nan, 4.0, np.nan])
    got = tuv.fill_linear(x)
    np.testing.assert_array_equal(got.numpy(),
                                  [np.nan, 1.0, 2.0, 3.0, 4.0, np.nan])


def test_argument_errors_match_reference():
    x = torch.zeros(5)
    for bad in (lambda: tuv.autocorr(x, 5), lambda: tuv.autocorr(x, 0),
                lambda: tuv.lag(x, 5), lambda: tuv.fillts(x, "bogus"),
                lambda: tuv.fillts(x, "value")):
        with pytest.raises(ValueError):
            bad()
    # the spline fill is ported: fillts dispatches it, as the reference's
    xs = torch.tensor([np.nan, 1.0, np.nan, 3.0, 2.0, np.nan])
    _close(tuv.fillts(xs, "spline"), juv.fillts(jnp.asarray(xs.numpy()),
                                               "spline"))


def test_lagmat_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.normal(size=30).astype(np.float32)
    x2 = rng.normal(size=(30, 3)).astype(np.float32)
    for orig in (False, True):
        _close(tlagmat.lag_mat_trim_both(torch.as_tensor(x), 4, orig),
               jlagmat.lag_mat_trim_both(jnp.asarray(x), 4, orig))
        _close(tlagmat.lag_mat_trim_both_2d(torch.as_tensor(x2), 3, orig),
               jlagmat.lag_mat_trim_both_2d(jnp.asarray(x2), 3, orig))
    with pytest.raises(ValueError):
        tlagmat.lag_mat_trim_both(torch.as_tensor(x), 30)


# -- the fill chain -----------------------------------------------------------


def _straddling(b, t, seed):
    """Gappy panel whose gaps straddle the reference's 1024-step chunk
    boundaries (when t > 1024)."""
    x = _gappy(b, t, seed=seed, gap=0.1)
    for c in range(1024, t, 1024):
        x[4, c - 6:c + 9] = np.nan
        x[5, c - 1:c + 1] = np.nan
    return x


@pytest.mark.parametrize("t", [37, 2100])
def test_fill_chain_matches_reference_kernel(t):
    x = _straddling(7, t, seed=3)
    ref = pk.fill_linear_chain(jnp.asarray(x), interpret=True)
    got = ck.fill_linear_chain(torch.as_tensor(x))
    for g, r in zip(got, ref):
        _close(g, r)
    # and the reference's portable chain
    f = jax.jit(jax.vmap(juv.fill_linear))(jnp.asarray(x))
    _close(got[0], f)
    _close(got[1], juv.batched(juv.differences_at_lag, 1)(f))
    _close(got[2], juv.batched(juv.lag, 1)(f))
    _close(ck.fill_linear(torch.as_tensor(x)), ref[0])


@pytest.mark.parametrize("outputs", [("diff",), ("lag", "filled"),
                                     ("filled", "diff", "lag"), ("diff",
                                                                 "lag")])
def test_fill_chain_output_subsets_and_folded_input(outputs):
    x = _straddling(6, 1100, seed=4)
    full = dict(zip(ck.CHAIN_OUTPUTS,
                    ck.fill_linear_chain(torch.as_tensor(x))))
    fp = layout.fold_panel(torch.as_tensor(x))
    got = ck.fill_linear_chain_folded(fp, outputs)
    assert len(got) == len(outputs)
    for o, g in zip(outputs, got):
        assert isinstance(g, layout.FoldedPanel) and g.shape == (6, 1100)
        np.testing.assert_array_equal(layout.unfold_panel(g).numpy(),
                                      full[o].numpy())
    # the univariate dispatch: natural and folded panels, eager and kernel
    for backend in ("auto", "eager"):
        nat = tuv.batch_fill_linear_chain(torch.as_tensor(x), backend,
                                          outputs)
        fold = tuv.batch_fill_linear_chain(fp, backend, outputs)
        for o, n, f in zip(outputs, nat, fold):
            _close(n, full[o])
            _close(layout.unfold_panel(f), full[o])


def test_fill_chain_rejects_bad_outputs():
    fp = layout.fold_panel(torch.zeros(2, 5))
    for bad in (("diff", "bogus"), ()):
        with pytest.raises(ValueError):
            ck.fill_linear_chain_folded(fp, bad)
        with pytest.raises(ValueError):
            tuv.batch_fill_linear_chain(torch.zeros(2, 5), outputs=bad)


def test_batch_fill_dispatch_matches_reference():
    x = _gappy(5, 60, seed=5)
    for method in ("linear", "previous", "nearest"):
        ref = juv.batch_fill(method, backend="scan")(jnp.asarray(x))
        _close(tuv.batch_fill(method)(torch.as_tensor(x)), ref)
        _close(tuv.batch_fill(method, "eager")(torch.as_tensor(x)), ref)


# -- autocorrelation ----------------------------------------------------------


@pytest.mark.parametrize("nl,t", [(1, 2100), (7, 64), (20, 2100),
                                  (40, 2100)])
def test_autocorr_matches_reference_kernel(nl, t):
    x = _straddling(6, t, seed=6)
    ref = pk.batch_autocorr(jnp.asarray(x), nl, interpret=True)
    got = ck.batch_autocorr(torch.as_tensor(x), nl)
    assert got.shape == (6, nl)
    assert np.isnan(got[2].numpy()).all()  # all-NaN row: 0/0
    assert np.isnan(got[3].numpy()).all()  # constant row: 0/0
    _close(got, ref)
    portable = juv.batch_autocorr(nl, backend="scan")(jnp.asarray(x))
    _close(got, portable)
    _close(tuv.batch_autocorr(nl, "eager")(torch.as_tensor(x)), portable)
    folded = ck.batch_autocorr_folded(layout.fold_panel(torch.as_tensor(x)),
                                      nl)
    np.testing.assert_array_equal(folded.numpy(), got.numpy())


def test_autocorr_dispatch_and_gate():
    x = torch.as_tensor(_gappy(4, 50, seed=7))
    fp = layout.fold_panel(x)
    ref = tuv.autocorr(x, 6)
    for panel in (x, fp):
        _close(tuv.batch_autocorr(6)(panel), ref)
        _close(tuv.batch_autocorr(6, "eager")(panel), ref)
    # the kernel's bound is the reference's: 0 < num_lags < min(T, 1024)
    assert ck.autocorr_structural_ok(49, 50)
    assert not ck.autocorr_structural_ok(50, 50)
    assert not ck.autocorr_structural_ok(1024, 5000)
    for bad in (0, 50):
        with pytest.raises(ValueError):
            ck.batch_autocorr(x, bad)
        with pytest.raises(ValueError):
            tuv.batch_autocorr(bad)(x)
    # past the kernel's bound the eager function still runs
    long = torch.randn(3, 1100)
    _close(tuv.batch_autocorr(1030)(long), tuv.autocorr(long, 1030))


def test_backend_names_and_cuda_on_cpu():
    x = torch.randn(3, 20)
    with pytest.raises(ValueError, match="unknown backend"):
        tuv.batch_autocorr(3, "scan")
    with pytest.raises(ValueError, match="unknown backend"):
        tuv.batch_fill("linear", "pallas")
    # "cuda" insists on a float32 CUDA tensor: no quiet CPU run
    with pytest.raises(ValueError, match="CUDA"):
        tuv.batch_autocorr(3, "cuda")(x)
    with pytest.raises(ValueError, match="CUDA"):
        tuv.batch_fill_linear_chain(x, "cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tuv.batch_fill("linear", "cuda")(x)


def test_fold_unfold_roundtrip():
    x = torch.randn(5, 13)
    fp = layout.fold_panel(x)
    assert fp.shape == (5, 13) and fp.data.shape == (13, 5)
    assert fp.data.is_contiguous() and fp.dtype == torch.float32
    np.testing.assert_array_equal(layout.unfold_panel(fp).numpy(), x.numpy())
    with pytest.raises(ValueError):
        layout.FoldedPanel(torch.zeros(5, 13), 5, 13)
