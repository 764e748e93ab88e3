"""The port's counter-based draws (``forecasting/_prng.py``) against
``jax.random``.

Keys, ``fold_in`` and 32-bit draws are bitwise the reference's at the
global rows the forecast walk keys on (0, 1, 7, 2^20 and 2^24 - 1, the
last row a float32 row index can name).  Normals: ``jax.random.normal``
rounds XLA's float32 ``log1p`` and ``erf_inv`` polynomial, which the port
reproduces operation for operation except ``log1p`` (torch's may differ by
an ulp), so at least 98 % of the draws are bitwise and every draw is
within 2.4e-7 relative (two float32 ulps of a value just above a power of
two).  Both sides draw float32: ``tests/conftest.py`` enables x64, and
``jax.random.normal`` takes a different path for float64.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from spark_timeseries_tpu_torch.forecasting import _prng

ROWS = np.array([0, 1, 7, 1 << 20, (1 << 24) - 1])
SEEDS = [0, 1, 12345, (1 << 31) - 1]
NORMAL_REL = 2.4e-7


def _ref_keys(seed, rows):
    k = jax.random.PRNGKey(seed)
    return np.asarray(jax.vmap(lambda r: jax.random.fold_in(k, r))(
        jnp.asarray(rows, jnp.int32)), np.int64)


def _port_keys(seed, rows):
    return _prng.fold_in(_prng.PRNGKey(seed), torch.as_tensor(rows))


@pytest.mark.parametrize("k0,k1,x0,x1,want", [
    # the Threefry-2x32 (20 rounds) known answers of Random123
    (0, 0, 0, 0, (0x6B200159, 0x99BA4EFE)),
    (0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF,
     (0x1CB996FC, 0xBB002BE7)),
    (0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3,
     (0xC4923A9C, 0x483DF7A0)),
])
def test_threefry_known_answers(k0, k1, x0, x1, want):
    t = [torch.tensor([v], dtype=torch.int64) for v in (k0, k1, x0, x1)]
    o0, o1 = _prng.threefry2x32(*t)
    assert (int(o0), int(o1)) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_matches_reference(seed):
    want = np.asarray(jax.random.PRNGKey(seed), np.int64)
    np.testing.assert_array_equal(_prng.PRNGKey(seed).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_bitwise_at_walk_rows(seed):
    np.testing.assert_array_equal(_port_keys(seed, ROWS).numpy(),
                                  _ref_keys(seed, ROWS))


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_bitwise(seed):
    keys = _ref_keys(seed, ROWS)
    want = np.asarray(jax.vmap(
        lambda k: jax.random.bits(k, (30, 64), jnp.uint32))(
            jnp.asarray(keys, jnp.uint32)), np.int64)
    got = _prng.bits(_port_keys(seed, ROWS), (30, 64)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_normals_within_float32_rounding(seed):
    keys = _ref_keys(seed, ROWS)
    want = np.asarray(jax.vmap(
        lambda k: jax.random.normal(k, (30, 256), jnp.float32))(
            jnp.asarray(keys, jnp.uint32)))
    got = _prng.normal(_port_keys(seed, ROWS), (30, 256)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    rel = np.abs(got - want) / np.abs(want)
    assert rel.max() <= NORMAL_REL
    assert (got == want).mean() >= 0.98


def test_normals_blocked_generation_is_one_draw():
    # the int64 temporaries are bounded by drawing a few rows at a time;
    # the blocks must not change a single draw
    keys = _port_keys(3, np.arange(40))
    whole = _prng.normal(keys, (7, 9))
    old = _prng._BLOCK
    _prng._BLOCK = 7 * 9 * 3  # three rows a block
    try:
        blocked = _prng.normal(keys, (7, 9))
    finally:
        _prng._BLOCK = old
    assert torch.equal(whole, blocked)


def test_erf_inv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0], dtype=torch.float32)
    out = _prng._erf_inv(x)
    assert out[0] == -np.inf and out[1] == np.inf and out[2] == 0.0


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, (1 << 32) - 1),
       row=st.integers(0, (1 << 24) - 1))
def test_keys_and_bits_bitwise_over_seeds(seed, row):
    k = jax.random.PRNGKey(seed)
    want_key = np.asarray(jax.random.fold_in(k, row), np.int64)
    got_key = _prng.fold_in(_prng.PRNGKey(seed), torch.tensor([row]))[0]
    np.testing.assert_array_equal(got_key.numpy(), want_key)
    want_bits = np.asarray(jax.random.bits(
        jnp.asarray(want_key, jnp.uint32), (5, 3), jnp.uint32), np.int64)
    np.testing.assert_array_equal(
        _prng.bits(got_key[None], (5, 3))[0].numpy(), want_bits)
