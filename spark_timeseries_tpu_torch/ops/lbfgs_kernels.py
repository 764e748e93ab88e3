"""The batched L-BFGS optimizer's per-row arithmetic: three CUDA kernels,
their wrappers, and the plain versions every other state runs.

Source ``csrc/lbfgs.cu``.  These kernels replace no Pallas kernel: the
reference's optimizer (``spark_timeseries_tpu/utils/optim.py``) is jitted
XLA, which fuses an iteration's per-row operations by itself.  The port
runs eagerly, and the same arithmetic was ~200 small PyTorch operations an
iteration, so a compacted straggler stage of a few thousand rows was paced
by the host issuing them.  ``utils.optim``'s step is these three calls
around the objective:

===================  ===================================================
wrapper              one iteration's
===================  ===================================================
``lbfgs_direction``  two-loop recursion, descent fallback, first step,
                     ``g.dir``, the Armijo test's noise floor and first
                     trial point
``lbfgs_trial``      line-search trial after each objective evaluation
``lbfgs_update``     update after the value-and-gradient evaluation (its
                     non-finite guard included), the history ring's slot
                     written in place
===================  ===================================================

They are bound by bytes: at ``[1M, 3]`` with ``m = 8`` the direction kernel
moves 295 MB (the ring is most of it), 88 us at 3.35 TB/s; the update 193
MB, a trial at most 61 MB.

The route (:func:`fused_ok`): float32 state on a CUDA device with ``d <=
16`` and ``m <= 16`` launches the kernels (counted in
``cuda_kernels.OPTIM_LAUNCHES``, apart from the objective's ``LAUNCHES``),
after checking dtype, shape and contiguity.  That is every fit of the port
(EWMA d = 1, ARIMA d = p + q (+1), GARCH 3, AR-GARCH 5, Holt-Winters 3,
the time-sharded fits of ``ops.seqparallel`` and the reliability ladder's
refits, all with ``m = 8``).  Any other state (the CPU, float64, wider
``d``) runs the plain versions: PyTorch operations on the batch, with
PyTorch's own row sums and norms.  The kernels round each operation once
and sum dot products and norms in two lanes by index parity, which is
PyTorch's CUDA row-sum order for d <= 4; ``lanes=True`` makes a plain
version sum in that order too, to check a kernel against it.

``flags`` is the caller's int32 ``[2]``: ``[0]`` the last trial in which a
row still backtracked, ``[1]`` the rows live after the update; the
direction zeroes both.  Neither route reads it on the host.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import cuda_kernels as ck

__all__ = ["MAX_DIM", "MAX_HISTORY", "structural_ok", "fused_ok",
           "row_dot", "row_norm", "Direction", "lbfgs_direction",
           "lbfgs_direction_plain",
           "lbfgs_trial", "lbfgs_trial_plain", "lbfgs_update",
           "lbfgs_update_plain"]

# the kernels' compile-time capacities (csrc/lbfgs.cu `with_caps`)
MAX_DIM = 16
MAX_HISTORY = 16


def structural_ok(d: int, m: int) -> bool:
    """Problem widths ``d`` and history depths ``m`` the kernels take."""
    return 1 <= d <= MAX_DIM and 1 <= m <= MAX_HISTORY


def fused_ok(x: torch.Tensor, m: int) -> bool:
    """True when the optimizer takes the kernel route for iterates ``x
    [B, d]`` with ``m`` history slots: float32 on a CUDA device and
    :func:`structural_ok`."""
    return ck.supported(x) and x.dim() == 2 and structural_ok(x.shape[1], m)


class Direction(NamedTuple):
    direction: torch.Tensor  # [B, d]
    t: torch.Tensor  # [B] first step
    ok: torch.Tensor  # [B] bool, the done rows (pre-satisfied)
    gd: torch.Tensor  # [B] g . direction
    eps: torch.Tensor  # [B] the Armijo test's noise floor
    xt: torch.Tensor  # [B, d] the first trial point


def _check_all(dev, flags, **tensors) -> None:
    """``tensors``: ``name=(tensor, shape, dtype)``."""
    for name, (x, shape, dtype) in tensors.items():
        ck._check(name, x, shape, dev, dtype)
    ck._check("flags", flags, (2,), dev, torch.int32)


def _depth(s_hist) -> int:
    if not isinstance(s_hist, torch.Tensor) or s_hist.dim() != 3:
        raise ValueError("s_hist must be a [B, m, d] tensor")
    m = s_hist.shape[1]
    if not 1 <= m <= MAX_HISTORY:
        raise ValueError(f"lbfgs kernels take 1 <= m <= {MAX_HISTORY} "
                         f"(got {m})")
    return m


def _width(x) -> tuple:
    if not isinstance(x, torch.Tensor) or x.dim() != 2:
        raise ValueError("x must be a [B, d] tensor")
    B, d = x.shape
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"lbfgs kernels take 1 <= d <= {MAX_DIM} (got {d})")
    return B, d


# -- row sums ----------------------------------------------------------------


def row_dot(a, b):
    """Row dot products as PyTorch sums them."""
    return (a * b).sum(-1)


def row_norm(a):
    """Row norms as PyTorch computes them."""
    return torch.linalg.vector_norm(a, dim=-1)


def _lane_dot(a, b):
    """Row dot products as the kernel's ``dot`` sums them: the even-index
    and the odd-index products each in index order, then added (PyTorch's
    CUDA row-sum order for d <= 4), each product and sum rounded once."""
    lanes = [a.new_zeros(a.shape[0]), a.new_zeros(a.shape[0])]
    for j in range(a.shape[1]):
        lanes[j % 2] = lanes[j % 2] + a[:, j] * b[:, j]
    return lanes[0] + lanes[1]


def _lane_norm(a):
    """Row norms as the kernel computes them: the square root of
    :func:`_lane_dot`, correctly rounded as ``__fsqrt_rn`` rounds it (in
    float64, then to float32: a CPU ``torch.sqrt`` in float32 may miss by
    an ulp)."""
    d = _lane_dot(a, a)
    return torch.sqrt(d.double()).to(d.dtype)


def _sums(lanes: bool):
    return (_lane_dot, _lane_norm) if lanes else (row_dot, row_norm)


# -- direction ----------------------------------------------------------------


def lbfgs_direction(x, f, g, s_hist, y_hist, rho_hist, tprev, converged,
                    failed, k: int, ftol: float, flags) -> Direction:
    """Iteration ``k``'s search direction and first trial (fresh outputs).

    The two-loop recursion over the ring (slot ``i`` valid where
    ``rho_hist[:, i] > 0``, newest ``(k - 1) % m``), ``-g`` where that is
    no descent direction, the first step (``min(4 tprev, 1)`` for rows with
    history and descent, else ``1 / max(|dir|, 1)``), ``gd = g . dir``, the
    noise floor ``ftol max(1, |f|)``, ``ok`` = the done rows and the trial
    point ``x + t dir``.  Zeroes ``flags``.
    """
    if not fused_ok(x, s_hist.shape[1]):
        return lbfgs_direction_plain(x, f, g, s_hist, y_hist, rho_hist,
                                     tprev, converged, failed, k, ftol, flags)
    B, d = _width(x)
    m = _depth(s_hist)
    dev, f32, b8 = x.device, torch.float32, torch.bool
    _check_all(dev, flags, x=(x, (B, d), f32), f=(f, (B,), f32),
               g=(g, (B, d), f32), s_hist=(s_hist, (B, m, d), f32),
               y_hist=(y_hist, (B, m, d), f32),
               rho_hist=(rho_hist, (B, m), f32), tprev=(tprev, (B,), f32),
               converged=(converged, (B,), b8), failed=(failed, (B,), b8))
    out = Direction(torch.empty_like(x), torch.empty_like(f),
                    torch.empty_like(converged), torch.empty_like(f),
                    torch.empty_like(f), torch.empty_like(x))
    if B:
        ck._launch("lbfgs", "sts_lbfgs_direction", "lbfgs_direction", dev,
                   *map(ck._ptr, (x, f, g, s_hist, y_hist, rho_hist, tprev,
                                  converged, failed, *out, flags)),
                   B, d, m, int(k), ctypes.c_float(ftol))
    else:
        flags.zero_()
    return out


def lbfgs_direction_plain(x, f, g, s_hist, y_hist, rho_hist, tprev,
                          converged, failed, k: int, ftol: float, flags, *,
                          lanes: bool = False) -> Direction:
    """Plain PyTorch version of :func:`lbfgs_direction` (``lanes``: sum as
    the kernel sums)."""
    dot, norm = _sums(lanes)
    m = s_hist.shape[1]
    flags.zero_()
    q, alphas = g, []
    for j in range(m):  # newest -> oldest
        i = (k - 1 - j) % m
        valid = rho_hist[:, i] > 0.0
        a = torch.where(valid, rho_hist[:, i] * dot(s_hist[:, i], q), 0.0)
        q = torch.where(valid[:, None], q - a[:, None] * y_hist[:, i], q)
        alphas.append(a)
    nw = (k - 1) % m
    sy = dot(s_hist[:, nw], y_hist[:, nw])
    yy = dot(y_hist[:, nw], y_hist[:, nw])
    gamma = torch.where((rho_hist[:, nw] > 0.0) & (yy > 0.0), sy / yy, 1.0)
    h = gamma[:, None] * q
    for j in reversed(range(m)):  # oldest -> newest
        i = (k - 1 - j) % m
        valid = rho_hist[:, i] > 0.0
        c = alphas[j] - rho_hist[:, i] * dot(y_hist[:, i], h)
        h = torch.where(valid[:, None], h + c[:, None] * s_hist[:, i], h)
    direction = -h
    gd = dot(g, direction)
    descent = gd < 0.0
    direction = torch.where(descent[:, None], direction, -g)
    gd = torch.where(descent, gd, dot(g, direction))
    # rows with no curvature history step along raw steepest descent, whose
    # scale is arbitrary: bound their first trial by 1; with history, warm
    # start from the row's last accepted step
    has_hist = (rho_hist > 0.0).any(-1)
    t = torch.where(has_hist & descent, torch.clamp(4.0 * tprev, max=1.0),
                    1.0 / torch.clamp(norm(direction), min=1.0))
    # done rows are pre-satisfied: their frozen state could never pass the
    # strict Armijo test and would drag the batch through every trial
    return Direction(direction, t, converged | failed, gd,
                     ftol * torch.clamp(f.abs(), min=1.0),
                     x + t[:, None] * direction)


# -- one line-search trial ---------------------------------------------------


def lbfgs_trial(x, direction, f, gd, eps, fnew, t, ok, xt, flags,
                trial: int, c1: float) -> None:
    """One backtracking trial on the objective's values ``fnew [B]`` at the
    trial points ``xt``, in place on ``t``, ``ok`` and ``xt``.

    Rows not yet ``ok``: a non-finite ``fnew`` counts as +inf; the row
    passes where ``fnew <= f + c1 t gd + eps``; otherwise ``t`` becomes the
    quadratic step ``-gd t^2 / (2 (fnew - f - gd t))`` (0 where not
    finite) clamped to ``[0.1 t, 0.5 t]``, its trial point ``x + t dir``,
    and ``flags[0]`` becomes ``trial``.  ``fnew`` may have any layout.
    """
    if not fused_ok(x, 1):  # a trial has no ring
        return lbfgs_trial_plain(x, direction, f, gd, eps, fnew, t, ok, xt,
                                 flags, trial, c1)
    fnew = fnew.contiguous()  # the objective's, in any layout
    B, d = _width(x)
    dev, f32 = x.device, torch.float32
    _check_all(dev, flags, x=(x, (B, d), f32),
               direction=(direction, (B, d), f32), f=(f, (B,), f32),
               gd=(gd, (B,), f32), eps=(eps, (B,), f32),
               fnew=(fnew, (B,), f32), t=(t, (B,), f32),
               ok=(ok, (B,), torch.bool), xt=(xt, (B, d), f32))
    if B:
        ck._launch("lbfgs", "sts_lbfgs_trial", "lbfgs_trial", dev,
                   *map(ck._ptr, (x, direction, f, gd, eps, fnew, t, ok, xt,
                                  flags)),
                   B, d, int(trial), ctypes.c_float(c1))
    return None


def lbfgs_trial_plain(x, direction, f, gd, eps, fnew, t, ok, xt, flags,
                      trial: int, c1: float) -> None:
    """Plain PyTorch version of :func:`lbfgs_trial` (it sums nothing)."""
    fnew = torch.where(torch.isfinite(fnew), fnew, torch.inf)
    passed = fnew <= f + c1 * t * gd + eps
    # a failed trial jumps to the minimizer of the quadratic through (0, f),
    # slope g.dir and (t, f(t))
    tq = -gd * t * t / (2.0 * (fnew - f - gd * t))
    tq = torch.where(torch.isfinite(tq), tq, 0.0)
    tq = torch.minimum(torch.maximum(tq, 0.1 * t), 0.5 * t)
    back = ~ok & ~passed
    t.copy_(torch.where(back, tq, t))
    ok.logical_or_(passed)
    xt.copy_(torch.where(back[:, None], x + t[:, None] * direction, xt))
    flags[0] = torch.where(back.any(), trial, flags[0])


# -- the update -------------------------------------------------------------


def lbfgs_update(x, f, g, xn, fn, gn, t, ok, converged, failed, tprev, bx,
                 bf, bg, iters, s_hist, y_hist, rho_hist, k: int, tol: float,
                 ftol: float, flags) -> tuple:
    """Iteration ``k``'s update from the objective's raw value ``fn`` and
    gradient ``gn`` at the trial point ``xn`` -> fresh ``(x, f, g,
    converged, failed, tprev, bx, bf, bg, iters)``.

    A row whose ``fn`` or ``gn`` is not finite counts as ``(inf, 0)``.  An
    accepted step (``ok``, ``fn <= f + ftol max(1, |f|)``, not done) with
    curvature ``s . y > 1e-10`` writes ring slot ``k % m`` of ``s_hist``,
    ``y_hist`` and ``rho_hist`` IN PLACE.  Convergence is the relative
    gradient-norm test or an accepted step's relative decrease below
    ``ftol``; a row whose line search failed and did not converge fails.
    ``flags[1]`` becomes the count of rows neither converged nor failed.
    ``fn`` and ``gn`` may have any layout.
    """
    if not fused_ok(x, s_hist.shape[1]):
        return lbfgs_update_plain(x, f, g, xn, fn, gn, t, ok, converged,
                                  failed, tprev, bx, bf, bg, iters, s_hist,
                                  y_hist, rho_hist, k, tol, ftol, flags)
    # the objective's value and gradient, in any layout (a kernel
    # objective's gradient comes back column-major)
    fn, gn = fn.contiguous(), gn.contiguous()
    B, d = _width(x)
    m = _depth(s_hist)
    dev, f32, b8 = x.device, torch.float32, torch.bool
    _check_all(dev, flags, x=(x, (B, d), f32), f=(f, (B,), f32),
               g=(g, (B, d), f32), xn=(xn, (B, d), f32),
               fn=(fn, (B,), f32), gn=(gn, (B, d), f32), t=(t, (B,), f32),
               ok=(ok, (B,), b8), converged=(converged, (B,), b8),
               failed=(failed, (B,), b8), tprev=(tprev, (B,), f32),
               bx=(bx, (B, d), f32), bf=(bf, (B,), f32),
               bg=(bg, (B, d), f32), iters=(iters, (B,), torch.int32),
               s_hist=(s_hist, (B, m, d), f32),
               y_hist=(y_hist, (B, m, d), f32),
               rho_hist=(rho_hist, (B, m), f32))
    out = (torch.empty_like(x), torch.empty_like(f), torch.empty_like(g),
           torch.empty_like(converged), torch.empty_like(failed),
           torch.empty_like(tprev), torch.empty_like(bx),
           torch.empty_like(bf), torch.empty_like(bg),
           torch.empty_like(iters))
    if B:
        ck._launch("lbfgs", "sts_lbfgs_update", "lbfgs_update", dev,
                   *map(ck._ptr, (x, f, g, xn, fn, gn, t, ok, converged,
                                  failed, tprev, bx, bf, bg, iters, s_hist,
                                  y_hist, rho_hist, *out, flags)),
                   B, d, m, int(k), ctypes.c_float(tol),
                   ctypes.c_float(ftol))
    return out


def lbfgs_update_plain(x, f, g, xn, fn, gn, t, ok, converged, failed, tprev,
                       bx, bf, bg, iters, s_hist, y_hist, rho_hist, k: int,
                       tol: float, ftol: float, flags, *,
                       lanes: bool = False) -> tuple:
    """Plain PyTorch version of :func:`lbfgs_update` (``lanes``: sum as the
    kernel sums)."""
    dot, norm = _sums(lanes)
    bad = ~torch.isfinite(fn) | ~torch.isfinite(gn).all(-1)
    fn = torch.where(bad, torch.inf, fn)
    gn = torch.where(bad[:, None], 0.0, gn)
    s, y = xn - x, gn - g
    sy = dot(s, y)
    done = converged | failed
    accept = ok & (fn <= f + ftol * torch.clamp(f.abs(), min=1.0)) & ~done
    # history is gated on accept: a step rejected at the re-evaluation must
    # not poison the curvature history
    good = (sy > 1e-10) & accept
    slot = k % s_hist.shape[1]
    s_hist[:, slot] = torch.where(good[:, None], s, s_hist[:, slot])
    y_hist[:, slot] = torch.where(good[:, None], y, y_hist[:, slot])
    rho_hist[:, slot] = torch.where(good, 1.0 / torch.clamp(sy, min=1e-30),
                                    rho_hist[:, slot])
    x_out = torch.where(accept[:, None], xn, x)
    f_out = torch.where(accept, fn, f)
    g_out = torch.where(accept[:, None], gn, g)
    conv = converged | (norm(g_out)
                        < tol * torch.clamp(norm(x_out), min=1.0))
    conv = conv | (accept & (f - fn <= ftol * torch.clamp(fn.abs(), min=1.0)))
    failed_out = failed | (~ok & ~conv & ~done)
    better = f_out < bf
    flags[1] = (~(conv | failed_out)).sum()
    return (x_out, f_out, g_out, conv, failed_out,
            torch.where(accept, t, tprev),
            torch.where(better[:, None], x_out, bx),
            torch.where(better, f_out, bf),
            torch.where(better[:, None], g_out, bg),
            torch.where(done, iters, torch.full_like(iters, k + 1)))
