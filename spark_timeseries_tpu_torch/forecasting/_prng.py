"""Counter-based random draws: threefry2x32 keys, bits and normals in plain
PyTorch.

The forecast walk keys every row's interval draws on the row's GLOBAL
index (``fold_in(PRNGKey(base_seed), row)``), so bands depend on (seed,
row) and never on chunk shape.  The reference draws them with
``jax.random``; torch generators cannot reproduce those draws, so this
module implements the same counter-based construction:

- :func:`threefry2x32`, the 20-round Threefry-2x32 hash (Salmon et al.,
  "Parallel random numbers: as easy as 1, 2, 3", SC 2011), with the
  rotation constants and key schedule of ``jax._src.prng``;
- :func:`PRNGKey` / :func:`fold_in`, the raw ``uint32[2]`` keys;
- :func:`bits`, 32-bit draws in the partitionable layout (a row's counters
  are the 64-bit iota of its shape, split into high and low words, and
  the draw is the xor of the two output words);
- :func:`normal`, float32 normals as ``jax.random.normal`` forms them:
  bits -> a uniform in ``(-1, 1)`` through the mantissa, then
  ``sqrt(2) * erf_inv`` with XLA's float32 ``erf_inv`` polynomial (Giles'
  approximation), operation for operation, its multiply-adds fused.

Every function is vectorised over a ``[B]`` batch of keys (``[B, 2]``).
torch has no unsigned 32-bit arithmetic, so words live in int64 and every
sum is masked back to 32 bits.  Keys and bits match ``jax.random``'s bit
for bit; normals agree to float32 rounding (``log1p`` may round
differently by an ulp).
"""

from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

# XLA's float32 erf_inv (Giles) coefficients, highest degree first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)

# float32 rows of at most this many draws are generated at a time: the
# hash's int64 temporaries stay bounded whatever the batch
_BLOCK = 1 << 24


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 of the counter words ``(x0, x1)`` under the key words
    ``(k0, k1)``: int64 tensors holding uint32 values, broadcast together.
    Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """The raw key of an integer seed: ``[seed >> 32, seed & 0xFFFFFFFF]``
    (int64 ``[2]``)."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK],
                        dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``fold_in`` of ``data`` (an integer or a ``[B]`` integer tensor)
    into ``key`` (``[2]`` or ``[B, 2]``) -> ``[..., 2]``: the hash of the
    counter pair ``(0, data)`` under ``key``."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & _MASK
    o0, o1 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([o0, o1], dim=-1)


def bits(keys: torch.Tensor, shape) -> torch.Tensor:
    """32-bit draws of ``shape`` per key: ``keys`` ``[B, 2]`` ->
    ``[B, *shape]`` int64 (values in ``[0, 2^32)``), counters in the
    partitionable layout.  Draws fewer than ``2^32`` per key."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if n >= 1 << 32:
        raise ValueError(f"at most 2^32 draws per key, got {n}")
    b = keys.shape[0]
    cnt = torch.arange(n, dtype=torch.int64, device=keys.device)
    o0, o1 = threefry2x32(keys[:, 0, None], keys[:, 1, None],
                          torch.zeros_like(cnt)[None, :], cnt[None, :])
    return (o0 ^ o1).reshape(b, *shape)


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (Giles' approximation): ``w =
    -log1p(-x^2)``, a degree-8 polynomial in ``w - 2.5`` below ``w = 5``
    and in ``sqrt(w) - 3`` above, times ``x``.  XLA selects each
    coefficient by the branch; evaluating both polynomials and selecting
    the result is the same arithmetic on every element."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    # XLA contracts each step into a fused multiply-add: the float32
    # product is exact in float64, so one float64 add rounded to float32
    # gives the fused result (up to a double rounding)
    out = []
    for coefs, arg in ((_ERFINV_LT5, w - 2.5),
                       (_ERFINV_GE5, torch.sqrt(w) - 3.0)):
        arg = arg.double()
        p = torch.full_like(x, coefs[0])
        for c in coefs[1:]:
            # the coefficient as the float32 constant XLA holds
            c32 = torch.tensor(c, dtype=torch.float32).item()
            p = (p.double() * arg + c32).float()
        out.append(p)
    res = torch.where(lt, out[0], out[1]) * x
    return torch.where(x.abs() == 1.0, x * math.inf, res)


def _uniform_pm1(u32: torch.Tensor) -> torch.Tensor:
    """32-bit draws -> float32 uniforms in ``(-1, 1)``: the top 23 bits as
    the mantissa of a float in ``[1, 2)``, minus 1, scaled by the float32
    width of ``(nextafter(-1, 0), 1)`` (2.0) and shifted, clamped below."""
    f = ((u32 >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(-0.99999994, dtype=torch.float32, device=u32.device)
    return torch.maximum(lo, f * 2.0 + lo)


def normal(keys: torch.Tensor, shape) -> torch.Tensor:
    """Float32 standard normals of ``shape`` per key: ``keys`` ``[B, 2]`` ->
    ``[B, *shape]``, as ``jax.random.normal(key, shape, float32)`` draws
    them for each key.  Generated in blocks of rows so the int64
    temporaries stay bounded."""
    shape = tuple(int(s) for s in shape)
    n = max(1, math.prod(shape))
    b = keys.shape[0]
    out = torch.empty((b, *shape), dtype=torch.float32, device=keys.device)
    step = max(1, _BLOCK // n)
    sqrt2 = torch.tensor(math.sqrt(2.0), dtype=torch.float32,
                         device=keys.device)
    for lo in range(0, b, step):
        u = _uniform_pm1(bits(keys[lo:lo + step], shape))
        out[lo:lo + step] = sqrt2 * _erf_inv(u)
    return out
