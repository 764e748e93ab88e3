"""Finite-difference Newton steps on batched objectives.

An objective maps points ``V [S, B, k]`` (``S`` trial points of ``B``
independent problems) to values ``[S, B]``.  :func:`gain` takes one
saddle-free Newton step, at most :data:`RADIUS` long in any coordinate,
from each row's point and returns how far the objective falls along it: a
lower bound on how far the point's value lies above a nearby local
optimum.  :func:`minimize` repeats such steps; it is the fit that
the lower-precision control runs in the program's place.
"""

import torch

# step lengths tried along each Newton direction, longest first
TRIALS = tuple(2.0 ** -i for i in range(10))
# the farthest a step goes in any free coordinate: a local look, which
# does not jump into another basin along a flat direction
RADIUS = 1.0


def offsets(k: int, dtype, device) -> torch.Tensor:
    """``[S, k]`` stencil of the central differences, in units of the
    step: the point, then +e_i, -e_i for each i, then the four corners
    (+-e_i +-e_j) of each pair i < j."""
    eye = torch.eye(k, dtype=dtype, device=device)
    pts = [torch.zeros(k, dtype=dtype, device=device)]
    for i in range(k):
        pts += [eye[i], -eye[i]]
    for i in range(k):
        for j in range(i + 1, k):
            pts += [eye[i] + eye[j], eye[i] - eye[j], -eye[i] + eye[j],
                    -eye[i] - eye[j]]
    return torch.stack(pts)


def derivatives(F: torch.Tensor, h: float, k: int):
    """Values at :func:`offsets` -> ``(f [B], g [B, k], H [B, k, k])``."""
    f0 = F[0]
    g = torch.stack([(F[1 + 2 * i] - F[2 + 2 * i]) / (2 * h)
                     for i in range(k)], -1)
    H = torch.zeros(F.shape[1], k, k, dtype=F.dtype, device=F.device)
    for i in range(k):
        H[:, i, i] = (F[1 + 2 * i] - 2 * f0 + F[2 + 2 * i]) / (h * h)
    n = 1 + 2 * k
    for i in range(k):
        for j in range(i + 1, k):
            pp, pm, mp, mm = F[n], F[n + 1], F[n + 2], F[n + 3]
            H[:, i, j] = H[:, j, i] = (pp - pm - mp + mm) / (4 * h * h)
            n += 4
    return f0, g, H


def direction(g: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """Saddle-free Newton direction ``-|H|^-1 g``: the eigenvalues of the
    symmetric ``H`` by magnitude, floored at 1e-8 of the largest."""
    # small matrices, many of them: the host's solver takes any batch
    lam, vec = (x.to(g.device) for x in torch.linalg.eigh(H.cpu()))
    floor = 1e-8 * lam.abs().amax(-1, keepdim=True) + 1e-30
    lam = lam.abs().clamp(min=floor)
    coef = (vec.transpose(-1, -2) @ g[..., None])[..., 0] / lam
    return -(vec @ coef[..., None])[..., 0]


def _finite(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, torch.inf)


def step(objective, v: torch.Tensor, h: float):
    """One Newton step from ``v [B, k]`` -> ``(f at v, best f along the
    direction, the point there)``; a row whose direction gains nothing
    keeps its point."""
    k = v.shape[-1]
    F = _finite(objective(v[None] + h * offsets(k, v.dtype, v.device)[:, None]))
    f0, g, H = derivatives(F, h, k)
    ok = torch.isfinite(g).all(-1) & torch.isfinite(H).all(-1).all(-1)
    d = direction(torch.where(ok[:, None], g, 0.0),
                  torch.where(ok[:, None, None], H, 1.0))
    d = d * (RADIUS / d.abs().amax(-1, keepdim=True)).clamp(max=1.0)
    t = torch.tensor(TRIALS, dtype=v.dtype, device=v.device)
    pts = v[None] + t[:, None, None] * d[None]
    Ft = _finite(objective(pts))
    best, at = Ft.min(0)
    better = best < f0
    v_new = torch.where(better[:, None],
                        pts.gather(0, at[None, :, None].expand(1, *v.shape))[0],
                        v)
    return f0, torch.where(better, best, f0), v_new


def gain(objective, v: torch.Tensor, h: float):
    """``(f [B], fall [B])``: the objective at ``v`` and how far one
    Newton step from there lowers it (0 where it cannot)."""
    f0, best, _ = step(objective, v, h)
    return f0, (f0 - best).clamp(min=0.0)


def minimize(objective, v0: torch.Tensor, h: float, iters: int):
    """``iters`` Newton steps from ``v0`` -> ``(v, f(v))``."""
    v = v0
    for _ in range(iters):
        _, _, v = step(objective, v, h)
    return v, objective(v[None])[0]
