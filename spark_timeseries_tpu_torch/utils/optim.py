"""Batched L-BFGS for model fitting (port of ``utils/optim.py``).

One optimizer fits a million independent small problems at once: every row
carries its own history, step size, convergence flag and best-seen iterate,
and all rows step in lockstep over ONE batched objective ``f(x[B, d]) ->
[B]``.  Rows are block-diagonal, so the gradient of ``sum(f)`` is exactly
the per-row gradient.

PyTorch runs eagerly, so the loop bounds live on the host: the driver reads
the device once per outer iteration (how many rows are still live) and once
per line-search trial (does any row still backtrack), and nowhere else.
Each such read is counted in :data:`host_reads`, so a run can show what the
loop cost in synchronisations.  (Fixed trip counts under CUDA graphs would
remove them.)

Straggler compaction: once at most ``cap`` rows remain unconverged, those
rows and their whole optimizer state are gathered into a ``[cap, d]``
problem whose objective is ``straggler_fun(row_indices)``; the loop finishes
them on the small batch inside the same iteration budget and scatters the
results back.  The cap sizing (:func:`compaction_cap`) and the gate
(:data:`COMPACT_MIN_BATCH`) are the reference's, so the straggler set is
the same.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import obs

# Straggler-compaction sizing shared by every fit driver: below this batch
# size the compaction stage is not worth its gather.
COMPACT_MIN_BATCH = 4096


class HostReadCounter:
    """Count of device->host reads the optimizer's loop bounds made."""

    def __init__(self):
        self.count = 0

    def read(self, x):
        """The Python value of a 0-d device tensor (one counted read)."""
        self.count += 1
        return x.item()


host_reads = HostReadCounter()


def compaction_cap(bsz: int) -> int:
    """Straggler cap for a batch of ``bsz`` rows: ~bsz/8, 1024-aligned."""
    return -(-max(1024, bsz // 8) // 1024) * 1024


def retry_cap(n: int, align: int = 8) -> int:
    """Bucket size for a failed-subset gather: the next power of two at or
    above ``n`` (minimum ``align``)."""
    n = max(int(n), 1)
    cap = max(align, 1)
    while cap < n:
        cap *= 2
    return cap


def gather_pad_indices(rows, cap: int):
    """Pad a row-index gather to ``cap`` slots by repeating the first index
    (the padded tail recomputes a real row; its results are dropped)."""
    rows = np.asarray(rows)
    if rows.size == 0:
        raise ValueError("gather_pad_indices needs at least one row")
    if int(cap) < rows.size:
        raise ValueError(f"cap {cap} smaller than the {rows.size}-row gather")
    return np.concatenate(
        [rows, np.full(int(cap) - rows.size, rows[0], rows.dtype)])


class LBFGSResult(NamedTuple):
    x: torch.Tensor  # [B, d] best-seen iterate
    f: torch.Tensor  # [B] objective there
    converged: torch.Tensor  # [B] bool
    iters: torch.Tensor  # [B] int32 iterations taken
    grad_norm: torch.Tensor  # [B] gradient norm at x


class _State(NamedTuple):
    x: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    s_hist: torch.Tensor  # [B, m, d]
    y_hist: torch.Tensor  # [B, m, d]
    rho_hist: torch.Tensor  # [B, m]
    converged: torch.Tensor
    failed: torch.Tensor  # line search broke down
    tprev: torch.Tensor  # last accepted step (line-search warm start)
    # best-seen iterate: the noise-floor-relaxed accept can adopt a step
    # that RAISES f by up to ftol*max(1,|f|), so the returned (x, f) is the
    # best visited point; bg is the gradient AT bx
    bx: torch.Tensor
    bf: torch.Tensor
    bg: torch.Tensor
    iters: torch.Tensor

    def take(self, idx):
        return _State(*(a[idx] for a in self))


def _rownorm(v):
    return torch.linalg.vector_norm(v, dim=-1)


def _rowdot(a, b):
    return (a * b).sum(-1)


def _two_loop_b(g, s_hist, y_hist, rho_hist, k: int, m: int):
    """Batched two-loop recursion over a ring of ``m`` history slots; slot
    ``i`` of a row is valid when its ``rho > 0``.  Returns ~ ``H g``."""
    idx = [(k - 1 - j) % m for j in range(m)]  # newest -> oldest
    q = g
    alphas = []
    for i in idx:
        valid = rho_hist[:, i] > 0.0
        alpha = torch.where(valid, rho_hist[:, i] * _rowdot(s_hist[:, i], q),
                            0.0)
        q = q - alpha[:, None] * y_hist[:, i] * valid[:, None]
        alphas.append(alpha)
    newest = idx[0]
    sy = _rowdot(s_hist[:, newest], y_hist[:, newest])
    yy = _rowdot(y_hist[:, newest], y_hist[:, newest])
    gamma = torch.where((rho_hist[:, newest] > 0.0) & (yy > 0.0), sy / yy, 1.0)
    r = gamma[:, None] * q
    for j in reversed(range(m)):
        i = idx[j]
        valid = rho_hist[:, i] > 0.0
        beta = torch.where(valid, rho_hist[:, i] * _rowdot(y_hist[:, i], r),
                           0.0)
        r = r + (alphas[j] - beta)[:, None] * s_hist[:, i] * valid[:, None]
    return r


def _value_and_grad(fb, x):
    """Batched value and gradient with the non-finite guard rows carry."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        f = fb(xr)
        (g,) = torch.autograd.grad(f.sum(), xr)
    f = f.detach()
    bad = ~torch.isfinite(f) | ~torch.isfinite(g).all(-1)
    return (torch.where(bad, torch.inf, f),
            torch.where(bad[:, None], 0.0, g))


def _init_state(fb, x0, m: int, tol: float) -> _State:
    bsz, d = x0.shape
    f0, g0 = _value_and_grad(fb, x0)
    z = lambda *s: torch.zeros(s, dtype=x0.dtype, device=x0.device)  # noqa: E731
    return _State(
        x=x0, f=f0, g=g0,
        s_hist=z(bsz, m, d), y_hist=z(bsz, m, d), rho_hist=z(bsz, m),
        converged=(_rownorm(g0) < tol) & torch.isfinite(f0),
        failed=torch.isinf(f0),
        tprev=torch.ones(bsz, dtype=x0.dtype, device=x0.device),
        bx=x0, bf=f0, bg=g0,
        iters=torch.zeros(bsz, dtype=torch.int32, device=x0.device),
    )


def _linesearch(fb, x, f, g, direction, done, t0, *, ftol, max_linesearch,
                c1):
    """Batched backtracking with quadratic interpolation -> ``(t, ok,
    trials)``.  Done rows are pre-satisfied (their frozen state could never
    pass the strict Armijo test and would drag the batch through every
    trial).  A failed trial jumps to the minimizer of the quadratic through
    (0, f), slope g.dir and (t, f(t)), clamped to [0.1t, 0.5t].  The Armijo
    test carries the noise floor ftol*max(1, |f|).  One host read per
    trial; ``trials`` counts the objective evaluations."""
    gd = _rowdot(g, direction)
    eps = ftol * torch.clamp(f.abs(), min=1.0)
    t, ok = t0, done
    trials = 0
    with torch.no_grad():
        for trials in range(1, max_linesearch + 1):
            fnew = fb(x + t[:, None] * direction)
            fnew = torch.where(torch.isfinite(fnew), fnew, torch.inf)
            ok_new = ok | (fnew <= f + c1 * t * gd + eps)
            tq = -gd * t * t / (2.0 * (fnew - f - gd * t))
            tq = torch.where(torch.isfinite(tq), tq, 0.0)
            tq = torch.minimum(torch.maximum(tq, 0.1 * t), 0.5 * t).to(t.dtype)
            t, ok = torch.where(ok_new, t, tq), ok_new
            if trials < max_linesearch and not host_reads.read((~ok).any()):
                break
    return t, ok, trials


def _step(fb, state: _State, k: int, *, m, tol, ftol, max_linesearch,
          c1, ls_evals: list) -> _State:
    """One lockstep L-BFGS iteration (iteration index ``k``); its
    line-search evaluations go to ``ls_evals[k]``."""
    done = state.converged | state.failed
    direction = -_two_loop_b(state.g, state.s_hist, state.y_hist,
                             state.rho_hist, k, m)
    descent = _rowdot(state.g, direction) < 0.0
    direction = torch.where(descent[:, None], direction, -state.g)
    # rows with no curvature history step along raw steepest descent, whose
    # scale is arbitrary: bound their first trial by 1; with history, warm
    # start from the row's last accepted step
    has_hist = (state.rho_hist > 0.0).any(-1)
    t0 = torch.where(has_hist & descent,
                     torch.clamp(4.0 * state.tprev, max=1.0),
                     1.0 / torch.clamp(_rownorm(direction), min=1.0)
                     ).to(state.x.dtype)
    t, ok, ls_evals[k] = _linesearch(fb, state.x, state.f, state.g,
                                     direction, done, t0, ftol=ftol,
                                     max_linesearch=max_linesearch, c1=c1)
    x_new = state.x + t[:, None] * direction
    f_new, g_new = _value_and_grad(fb, x_new)

    s = x_new - state.x
    y = g_new - state.g
    sy = _rowdot(s, y)
    slot = k % m
    accept = (ok & (f_new <= state.f + ftol * torch.clamp(state.f.abs(),
                                                          min=1.0))
              & ~done)
    # history is gated on accept: a step rejected at the re-evaluation must
    # not poison the curvature history
    good = (sy > 1e-10) & accept
    s_hist, y_hist, rho_hist = (state.s_hist.clone(), state.y_hist.clone(),
                                state.rho_hist.clone())
    s_hist[:, slot] = torch.where(good[:, None], s, state.s_hist[:, slot])
    y_hist[:, slot] = torch.where(good[:, None], y, state.y_hist[:, slot])
    rho_hist[:, slot] = torch.where(good, 1.0 / torch.clamp(sy, min=1e-30),
                                    state.rho_hist[:, slot])
    x_out = torch.where(accept[:, None], x_new, state.x)
    f_out = torch.where(accept, f_new, state.f)
    g_out = torch.where(accept[:, None], g_new, state.g)
    conv = state.converged | (
        _rownorm(g_out) < tol * torch.clamp(_rownorm(x_out), min=1.0))
    conv = conv | (accept & (state.f - f_new
                             <= ftol * torch.clamp(f_new.abs(), min=1.0)))
    better = f_out < state.bf
    return _State(
        x=x_out, f=f_out, g=g_out,
        s_hist=s_hist, y_hist=y_hist, rho_hist=rho_hist,
        converged=conv,
        failed=state.failed | (~ok & ~conv & ~done),
        tprev=torch.where(accept, t, state.tprev),
        bx=torch.where(better[:, None], x_out, state.bx),
        bf=torch.where(better, f_out, state.bf),
        bg=torch.where(better[:, None], g_out, state.bg),
        iters=torch.where(done, state.iters,
                          torch.full_like(state.iters, k + 1)),
    )


def _run(fb, state: _State, k: int, max_iters: int, stop_at: int, knobs):
    """Lockstep loop from iteration ``k`` while more than ``stop_at`` rows
    are live -> ``(state, k, n_live)``.  One host read per iteration."""
    while True:
        n_live = host_reads.read((~(state.converged | state.failed)).sum())
        if k >= max_iters or n_live <= stop_at:
            return state, k, n_live
        state = _step(fb, state, k, **knobs)
        k += 1


def minimize_lbfgs(
    fun: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    *,
    max_iters: int = 50,
    history: int = 8,
    tol: float = 1e-6,
    ftol: Optional[float] = None,
    max_linesearch: int = 20,
    c1: float = 1e-4,
) -> LBFGSResult:
    """Minimize ``fun(x [d]) -> scalar`` from ``x0 [d]`` with a fixed
    budget: one row of :func:`minimize_lbfgs_batched` (the same steps, the
    same relative gradient-norm and ``ftol`` stopping rules, the best-seen
    iterate returned; non-finite values count as +inf)."""
    x0 = torch.as_tensor(x0)
    res = minimize_lbfgs_batched(
        lambda X: fun(X[0]).reshape(1), x0[None, :], max_iters=max_iters,
        history=history, tol=tol, ftol=ftol, max_linesearch=max_linesearch,
        c1=c1)
    return LBFGSResult(*(a[0] for a in res))


def minimize_lbfgs_batched(
    fun_batched: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    *,
    max_iters: int = 50,
    history: int = 8,
    tol: float = 1e-6,
    ftol: Optional[float] = None,
    max_linesearch: int = 20,
    c1: float = 1e-4,
    count_evals: bool = False,
    straggler_fun: "Callable[[torch.Tensor], Callable] | None" = None,
    straggler_cap: Optional[int] = None,
) -> "LBFGSResult | tuple[LBFGSResult, dict]":
    """Jointly minimize ``B`` independent problems with ONE batched
    objective ``fun_batched(x[B, d]) -> f[B]``.

    Convergence is the relative gradient-norm test (``tol``) OR an accepted
    step whose relative decrease falls below ``ftol`` (``None``: 1e-6 in
    float32, 1e-9 in float64).  With ``straggler_fun`` the lockstep loop
    exits once at most ``straggler_cap`` (default ``max(128, B // 8)``) rows
    remain live; those rows finish on ``straggler_fun(idxc)``, a ``[cap]``
    objective, within the same iteration budget, and scatter back.  The
    gather happens only when rows remain and budget is left.

    ``count_evals=True`` returns ``(result, info)``, the reference's pass
    accounting: ``info["ls_evals"]`` (``[max_iters]`` int32, the line-search
    objective evaluations of each outer iteration; each iteration adds one
    value-and-gradient evaluation, and the start one more),
    ``info["compact_at"]`` (the iteration at which compaction engaged, or
    the iterations run when it never did) and ``info["cap"]`` (0 without
    compaction).  The counts are host integers the loop keeps anyway: no
    extra device read.
    """
    bsz, _ = x0.shape
    if ftol is None:
        ftol = 1e-9 if x0.dtype == torch.float64 else 1e-6
    cap = straggler_cap if straggler_cap is not None else max(128, bsz // 8)
    compact = straggler_fun is not None and cap < bsz
    ls_evals = [0] * max_iters  # each iteration's line-search evaluations
    knobs = dict(m=history, tol=tol, ftol=ftol,
                 max_linesearch=max_linesearch, c1=c1, ls_evals=ls_evals)
    state = _init_state(fun_batched, x0, history, tol)
    state, k, n_live = _run(fun_batched, state, 0, max_iters,
                            cap if compact else 0, knobs)
    compact_at = k
    if compact and n_live > 0 and k < max_iters:
        # n_live <= cap here: the loop only exits early once the stragglers
        # fit the cap.  Fill slots repeat row bsz-1 and are dropped on the
        # scatter, as in the reference's size=cap gather.  Counted once per
        # compaction (the reference counts its compacted programs' traces)
        obs.counter("optim.stage2_compact_traces").inc()
        live = torch.nonzero(~(state.converged | state.failed)).squeeze(1)
        idx = torch.full((cap,), bsz, dtype=torch.long, device=x0.device)
        idx[:n_live] = live
        idxc = torch.clamp(idx, max=bsz - 1)
        sub, _, _ = _run(straggler_fun(idxc), state.take(idxc), k, max_iters,
                         0, knobs)
        rows = idx[:n_live]
        state = state._replace(**{
            name: _scatter(getattr(state, name), rows,
                           getattr(sub, name)[:n_live])
            for name in ("converged", "failed", "bx", "bf", "bg", "iters")})
    result = LBFGSResult(
        x=state.bx, f=state.bf,
        converged=state.converged & torch.isfinite(state.bf),
        iters=state.iters, grad_norm=_rownorm(state.bg))
    if not count_evals:
        return result
    return result, {
        "ls_evals": torch.tensor(ls_evals, dtype=torch.int32,
                                 device=x0.device),
        "compact_at": compact_at, "cap": cap if compact else 0}


def _scatter(full, rows, vals):
    out = full.clone()
    out[rows] = vals
    return out


def batched_minimize(fun, x0, data, **kwargs) -> LBFGSResult:
    """``fun(x[B, d], data) -> f[B]`` minimized row by row in lockstep (the
    reference's ``vmap(minimize_lbfgs)``: in eager PyTorch the batch
    dimension is written out, so the per-row problems share one loop)."""
    return minimize_lbfgs_batched(lambda x: fun(x, data), x0, **kwargs)


# -- bounded-parameter transforms (BOBYQA replacement) ----------------------


def sigmoid_to_interval(u, lo, hi):
    """Map R -> (lo, hi)."""
    return lo + (hi - lo) * torch.sigmoid(u)


def interval_to_sigmoid(x, lo, hi):
    """Inverse of :func:`sigmoid_to_interval` (x strictly inside)."""
    p = torch.clamp((x - lo) / (hi - lo), 1e-7, 1 - 1e-7)
    return torch.log(p) - torch.log1p(-p)


def softplus_inverse(y):
    return torch.log(torch.expm1(torch.clamp(y, min=1e-10)))
