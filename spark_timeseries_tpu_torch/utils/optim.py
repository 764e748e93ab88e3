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

With the ``obs`` plane on, the loop opens spans (``optim.minimize``,
``optim.init``, ``optim.lockstep``, ``optim.direction``,
``optim.linesearch``, ``optim.update``, ``optim.compact``,
``optim.stragglers`` and ``optim.host_read`` around each counted read) and
feeds the ``work.*`` counters from host integers it holds anyway:
``work.row_evals`` (the rows of every objective evaluation),
``work.live_row_evals`` (of those, the rows live when their iteration
began), ``work.optim_iters`` (every lockstep and straggler iteration) and
``work.optim_fused_iters`` (those that took the kernel route).  None reads
the device.

An iteration's own arithmetic is three calls of ``ops.lbfgs_kernels``
around the objective: the direction and first trial point, one
line-search trial after each objective evaluation, and the update, which
writes the history ring's slot in place and counts the live rows on the
device for the next iteration's read.  For float32 state on a CUDA device
with ``d <= 16`` and ``m <= 16`` (``lbfgs_kernels.fused_ok``, which every
fit of the port meets) they are CUDA kernels; any other state (the CPU,
float64, wider ``d``) runs their plain versions, PyTorch operations on the
batch.  The loop, the objective, the reads and compaction are the same
either way.

Straggler compaction: once at most ``cap`` rows remain unconverged, those
rows and their whole optimizer state are gathered into a ``[cap, d]``
problem whose objective is ``straggler_fun(row_indices)``; the loop finishes
them on the small batch inside the same iteration budget and scatters the
results back.  The cap sizing (:func:`compaction_cap`) and the gate
(:data:`COMPACT_MIN_BATCH`) are the reference's, so the straggler set is
the same.
"""

from __future__ import annotations

import threading
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import obs
from ..ops import lbfgs_kernels as lk

# Straggler-compaction sizing shared by every fit driver: below this batch
# size the compaction stage is not worth its gather.
COMPACT_MIN_BATCH = 4096


class HostReadCounter:
    """Count of device->host reads the optimizer's loop bounds made."""

    # lanes run the optimizer from several threads at once: a bare
    # ``+= 1`` can lose a count between them
    _protected_by_ = {"count": "_lock"}

    def __init__(self):
        self.count = 0
        self._lock = threading.Lock()

    def read(self, x):
        """The Python value of a 0-d device tensor (one counted read; the
        host's wait is the ``optim.host_read`` span)."""
        with self._lock:
            self.count += 1
        with obs.span("optim.host_read"):
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


def _raw_value_and_grad(fb, x):
    """Batched value and gradient of ``fb`` at ``x``, unguarded."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        f = fb(xr)
        (g,) = torch.autograd.grad(f.sum(), xr)
    return f.detach(), g


def _value_and_grad(fb, x):
    """Batched value and gradient with the non-finite guard rows carry."""
    f, g = _raw_value_and_grad(fb, x)
    bad = ~torch.isfinite(f) | ~torch.isfinite(g).all(-1)
    return (torch.where(bad, torch.inf, f),
            torch.where(bad[:, None], 0.0, g))


def _init_state(fb, x0, m: int, tol: float) -> _State:
    bsz, d = x0.shape
    f0, g0 = _value_and_grad(fb, x0)
    _count_evals(bsz, bsz)  # every row is live at the start
    z = lambda *s: torch.zeros(s, dtype=x0.dtype, device=x0.device)  # noqa: E731
    return _State(
        x=x0, f=f0, g=g0,
        s_hist=z(bsz, m, d), y_hist=z(bsz, m, d), rho_hist=z(bsz, m),
        converged=(lk.row_norm(g0) < tol) & torch.isfinite(f0),
        failed=torch.isinf(f0),
        tprev=torch.ones(bsz, dtype=x0.dtype, device=x0.device),
        bx=x0, bf=f0, bg=g0,
        iters=torch.zeros(bsz, dtype=torch.int32, device=x0.device),
    )


def _linesearch(fb, x, f, dr: lk.Direction, flags, *, max_linesearch,
                c1) -> int:
    """Batched backtracking with quadratic interpolation from the direction
    ``dr`` -> the trials (objective evaluations).  Each trial updates
    ``dr.t``, ``dr.ok`` and the trial points ``dr.xt`` in place and leaves
    in ``flags[0]`` whether a row still backtracks: one host read per
    trial."""
    trials = 0
    with torch.no_grad():
        for trials in range(1, max_linesearch + 1):
            fnew = fb(dr.xt)
            lk.lbfgs_trial(x, dr.direction, f, dr.gd, dr.eps, fnew, dr.t,
                           dr.ok, dr.xt, flags, trials, c1)
            if trials < max_linesearch and \
                    host_reads.read(flags[0]) != trials:
                break
    return trials


def _step(fb, state: _State, k: int, flags, *, m, tol, ftol,
          max_linesearch, c1, ls_evals: list) -> _State:
    """One lockstep L-BFGS iteration (iteration index ``k``); its
    line-search evaluations go to ``ls_evals[k]``.  Writes the history ring
    in place and the count of live rows after it into ``flags[1]``."""
    with obs.span("optim.direction"):
        dr = lk.lbfgs_direction(state.x, state.f, state.g, state.s_hist,
                                state.y_hist, state.rho_hist, state.tprev,
                                state.converged, state.failed, k, ftol,
                                flags)
    with obs.span("optim.linesearch"):
        ls_evals[k] = _linesearch(fb, state.x, state.f, dr, flags,
                                  max_linesearch=max_linesearch, c1=c1)
    with obs.span("optim.update"):
        f_new, g_new = _raw_value_and_grad(fb, dr.xt)
        (x, f, g, converged, failed, tprev, bx, bf, bg,
         iters) = lk.lbfgs_update(
            state.x, state.f, state.g, dr.xt, f_new, g_new, dr.t, dr.ok,
            state.converged, state.failed, state.tprev, state.bx, state.bf,
            state.bg, state.iters,
            state.s_hist, state.y_hist, state.rho_hist, k, tol, ftol, flags)
        return _State(x=x, f=f, g=g, s_hist=state.s_hist,
                      y_hist=state.y_hist, rho_hist=state.rho_hist,
                      converged=converged, failed=failed, tprev=tprev,
                      bx=bx, bf=bf, bg=bg, iters=iters)


def _count_evals(rows: int, live: int) -> None:
    """Add objective evaluations to ``work.row_evals`` (``rows`` evaluated)
    and ``work.live_row_evals`` (``live`` of them still unconverged)."""
    obs.counter("work.row_evals").inc(rows)
    obs.counter("work.live_row_evals").inc(live)


def count_objective(x, steps: int) -> None:
    """Count one evaluation of a model's objective over ``x`` (``[rows,
    ...]``) and a panel of ``steps`` time steps in
    ``work.objective_row_steps``: rows x steps for the forward sweep, and
    as much again for the adjoint sweep when the evaluation will be
    differentiated.  Called by each model's objective on every backend, so
    the count is the same whatever computes the objective."""
    n = x.shape[0] * steps
    if x.requires_grad and torch.is_grad_enabled():
        n *= 2
    obs.counter("work.objective_row_steps").inc(n)


def _run(fb, state: _State, k: int, max_iters: int, stop_at: int, knobs):
    """Lockstep loop from iteration ``k`` while more than ``stop_at`` rows
    are live -> ``(state, k, n_live)``.  One host read per iteration, of
    the count the update left in ``flags``, this call's own buffer."""
    fused = lk.fused_ok(state.x, knobs["m"])
    if fused:
        # the kernels take row-major state; an objective's gradient may
        # come back strided (a no-op for the tensors that are not)
        state = _State(*(a.contiguous() for a in state))
    flags = torch.zeros(2, dtype=torch.int32, device=state.x.device)
    live = (~(state.converged | state.failed)).sum()
    while True:
        n_live = host_reads.read(live)
        if k >= max_iters or n_live <= stop_at:
            return state, k, n_live
        obs.counter("work.optim_iters").inc()
        if fused:
            obs.counter("work.optim_fused_iters").inc()
        state = _step(fb, state, k, flags, **knobs)
        live = flags[1]
        evals = knobs["ls_evals"][k] + 1  # the trials and the update
        _count_evals(state.x.shape[0] * evals, n_live * evals)
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
    with obs.span("optim.minimize", rows=x0.shape[0]):
        bsz, _ = x0.shape
        if ftol is None:
            ftol = 1e-9 if x0.dtype == torch.float64 else 1e-6
        cap = (straggler_cap if straggler_cap is not None
               else max(128, bsz // 8))
        compact = straggler_fun is not None and cap < bsz
        ls_evals = [0] * max_iters  # each iteration's line-search evaluations
        knobs = dict(m=history, tol=tol, ftol=ftol,
                     max_linesearch=max_linesearch, c1=c1, ls_evals=ls_evals)
        with obs.span("optim.init"):
            state = _init_state(fun_batched, x0, history, tol)
        with obs.span("optim.lockstep"):
            state, k, n_live = _run(fun_batched, state, 0, max_iters,
                                    cap if compact else 0, knobs)
        compact_at = k
        if compact and n_live > 0 and k < max_iters:
            # n_live <= cap here: the loop only exits early once the stragglers
            # fit the cap.  Fill slots repeat row bsz-1 and are dropped on the
            # scatter, as in the reference's size=cap gather; they start
            # converged, so that they neither hold the loop open nor count as
            # live rows.  Counted once per compaction (the reference counts its
            # compacted programs' traces)
            with obs.span("optim.compact", live=n_live, cap=cap):
                obs.counter("optim.stage2_compact_traces").inc()
                live = torch.nonzero(
                    ~(state.converged | state.failed)).squeeze(1)
                idx = torch.full((cap,), bsz, dtype=torch.long,
                                 device=x0.device)
                idx[:n_live] = live
                idxc = torch.clamp(idx, max=bsz - 1)
                fun_sub = straggler_fun(idxc)
                sub = state.take(idxc)
                filled = sub.converged.clone()
                filled[n_live:] = True
                sub = sub._replace(converged=filled)
            with obs.span("optim.stragglers"):
                sub, _, _ = _run(fun_sub, sub, k, max_iters, 0, knobs)
                rows = idx[:n_live]
                state = state._replace(**{
                    name: _scatter(getattr(state, name), rows,
                                   getattr(sub, name)[:n_live])
                    for name in ("converged", "failed", "bx", "bf", "bg",
                                 "iters")})
        result = LBFGSResult(
            x=state.bx, f=state.bf,
            converged=state.converged & torch.isfinite(state.bf),
            iters=state.iters, grad_norm=lk.row_norm(state.bg))
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
