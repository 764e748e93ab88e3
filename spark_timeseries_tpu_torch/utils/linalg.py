"""Shared small-regression building blocks (port of ``utils/linalg.py``).

Every batched OLS in a fit funnels through :func:`ridge_solve`: tiny
``[k, k]`` Gram matrices over a huge batch, solved by an unrolled Cholesky
that is a few dozen elementwise ops over the batch.
"""

from __future__ import annotations

import torch


def _chol_solve_unrolled(A, y):
    """Batched SPD solve with a statically unrolled Cholesky.

    PRECONDITION: ``A`` is symmetric positive-definite at working precision
    (the decomposition is unpivoted).  Rows that violate it are reported in
    the returned ``bad`` mask; their pivots are clamped to a floor SCALED TO
    THE MATRIX (``eps * trace/k``), so their solutions stay bounded relative
    to the input but are not trustworthy (:func:`ridge_solve` replaces them).

    Returns ``(x, bad)``: the solutions ``[..., k]`` and a ``[...]`` bool
    mask of rows whose factorization hit a non-positive or NaN pivot.
    """
    k = A.shape[-1]
    finfo = torch.finfo(A.dtype)
    scale = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / k
    floor = finfo.eps * torch.clamp(scale, min=finfo.tiny)
    bad = torch.zeros(A.shape[:-2], dtype=torch.bool, device=A.device)
    L = [[None] * k for _ in range(k)]
    for i in range(k):
        for j in range(i + 1):
            s = A[..., i, j]
            for p in range(j):
                s = s - L[i][p] * L[j][p]
            if i == j:
                bad = bad | ~(s > 0.0)  # non-positive OR NaN pivot
                L[i][j] = torch.sqrt(torch.maximum(s, floor))
            else:
                L[i][j] = s / L[j][j]
    z = [None] * k
    for i in range(k):
        s = y[..., i]
        for p in range(i):
            s = s - L[i][p] * z[p]
        z[i] = s / L[i][i]
    x = [None] * k
    for i in reversed(range(k)):
        s = z[i]
        for p in range(i + 1, k):
            s = s - L[p][i] * x[p]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1), bad


def _lu_solve(A, b):
    # solve_ex never raises on a singular row (it returns inf/NaN there,
    # as the reference's jnp.linalg.solve does)
    return torch.linalg.solve_ex(A, b.unsqueeze(-1))[0].squeeze(-1)


def ridge_solve(XtX, Xty, ridge: float = 1e-8):
    """Solve normal equations with THE scaled-ridge stabilization rule.

    ``scale = max(trace/k, 1)``, ``A = XtX + ridge * scale * I``.  Systems
    with k <= 8 solve via the unrolled Cholesky; rows whose factorization
    hits a non-positive pivot are re-solved with a pivoted LU (one host read
    decides whether any row needs it, so clean batches never pay the LU).
    Larger systems go straight to the LU.
    """
    k = XtX.shape[-1]
    scale = torch.clamp(torch.diagonal(XtX, dim1=-2, dim2=-1).sum(-1) / k,
                        min=1.0)
    eye = torch.eye(k, dtype=XtX.dtype, device=XtX.device)
    A = XtX + (ridge * scale)[..., None, None] * eye
    if k > 8:
        return _lu_solve(A, Xty)
    x, bad = _chol_solve_unrolled(A, Xty)
    if bool(bad.any()):
        x = torch.where(bad[..., None], _lu_solve(A, Xty), x)
    return x


def ols(X, y, ridge: float = 1e-8):
    """OLS coefficients via ridge-stabilized normal equations
    (``X [..., n, k]``, ``y [..., n]``)."""
    Xt = X.transpose(-1, -2)
    return ridge_solve(Xt @ X, (Xt @ y.unsqueeze(-1)).squeeze(-1), ridge)
