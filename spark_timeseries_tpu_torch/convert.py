"""Carry fitted parameters from the JAX package into the port.

The JAX package returns ``FitResult`` fields as arrays.  Each model family
keeps its parameter rows in one layout, the same in both packages:

- ARIMA (``models.arima``): ``[c (if intercept), phi_1..phi_p,
  theta_1..theta_q]``;
- GARCH(1,1) (``models.garch.fit``): ``[omega, alpha, beta]``;
- AR(1)+GARCH(1,1) (``models.garch.fit_argarch``): ``[c, phi, omega,
  alpha, beta]``;
- EWMA (``models.ewma.fit``): ``[alpha]``;
- Holt-Winters (``models.holtwinters.fit``): ``[alpha, beta, gamma]``.

:func:`from_jax_params` takes any of them (it does not reorder columns) and
turns them into the port's tensors, so a model fitted by either package
forecasts in the other.
"""

from __future__ import annotations

import numpy as np

from .models.base import FitResult, to_device
from .reliability.status import STATUS_DTYPE


def from_jax_params(params_np, *, device="cuda", neg_log_likelihood=None,
                    converged=None, iters=None, status=None) -> FitResult:
    """``[B, k]`` (or ``[k]``) fitted parameters, plus any of the optional
    ``FitResult`` fields, as a port ``FitResult`` on ``device``.

    Floating parameters keep their dtype (float32 or float64); fields not
    given are ``None``.  Array-likes of any kind are accepted (numpy, or a
    JAX array, which converts through ``numpy.asarray``).
    """
    params = np.asarray(params_np)
    if params.dtype.kind != "f":
        raise TypeError(f"parameters must be floating, got {params.dtype}")
    if params.ndim not in (1, 2):
        raise ValueError(f"parameters must be [k] or [B, k], got "
                         f"{params.shape}")

    def opt(x, dtype):
        return None if x is None else to_device(
            np.asarray(x).astype(dtype), device)

    return FitResult(
        params=to_device(params, device),
        neg_log_likelihood=opt(neg_log_likelihood, params.dtype),
        converged=opt(converged, np.bool_),
        iters=opt(iters, np.int32),
        status=opt(status, STATUS_DTYPE),
    )
