"""The optimizer's step (``utils.optim._step`` over ``ops.lbfgs_kernels``)
against a plain eager L-BFGS step, and the kernels against their plain
versions.

On the CPU the wrappers run their plain versions, which sum rows as
PyTorch does: one iteration from random states (partly valid rings, done
rows, rows whose objective or gradient is not finite, rows with no
history, an iteration index that wraps the ring) and whole runs of
``minimize_lbfgs_batched`` with compaction equal, bit for bit, those of
``_eager_step``, the same iteration written out operation by operation;
with the plain versions summing in the kernels' order (``lanes=True``),
they move by rounding alone.

Tests marked ``card`` need a CUDA device and skip without one (decided
inside each test): each kernel against its plain version, GARCH and
Holt-Winters fits on both routes, and two optimizers in two threads.  Run
them on the card with ``python -m pytest tests/test_torch_lbfgs_kernels.py
--noconftest -m card -q`` (the package's conftest imports JAX, which the
card's machine does not have; this file imports neither).
"""

import functools
import json
import threading
from pathlib import Path

import pytest
import torch

from spark_timeseries_tpu_torch import entry, obs
from spark_timeseries_tpu_torch.models import base, garch
from spark_timeseries_tpu_torch.models import holtwinters as hw
from spark_timeseries_tpu_torch.ops import cuda_kernels as ck
from spark_timeseries_tpu_torch.ops import lbfgs_kernels as lk
from spark_timeseries_tpu_torch.utils import optim

LIMITS = Path(__file__).resolve().parent.parent / "bench_port" / "limits"
KNOBS = dict(tol=1e-4, ftol=1e-6, max_linesearch=20, c1=1e-4)


def _close(got, ref, rtol):
    got, ref = got.double().cpu(), ref.double().cpu()
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert torch.equal(torch.isinf(got), torch.isinf(ref))
    ok = torch.isfinite(ref)
    if ok.any():
        err = float((got[ok] - ref[ok]).abs().max())
        scale = max(1.0, float(ref[ok].abs().max()))
        assert err <= rtol * scale, (err, scale)


def _objective(b, d, seed, device="cpu"):
    """A per-row smooth objective with planted faults -> ``(fb, x0)``:
    row 3's value is NaN everywhere, row 4's gradient is NaN everywhere."""
    g = torch.Generator().manual_seed(seed)
    w = (0.5 + torch.rand(b, d, generator=g)).to(device)
    c = torch.randn(b, d, generator=g).to(device)
    nan_f = torch.zeros(b, dtype=torch.bool, device=device)
    nan_g = torch.zeros(b, dtype=torch.bool, device=device)
    nan_f[3], nan_g[4] = True, True

    def fb(x):
        f = (0.5 * w * (x - c) ** 2).sum(-1) + 0.1 * (x ** 4).sum(-1)
        f = torch.where(nan_f, torch.nan, f)
        # a NaN gradient under a finite value: the infinite slope of sqrt
        # at 0 times the zero slope of abs there
        z = torch.where(nan_g, x[:, 0] - x[:, 0].detach(), 1.0)
        return f + 0.0 * torch.sqrt(z.abs())

    return fb, torch.randn(b, d, generator=g).to(device)


def _state(fb, x, m, k, seed):
    """A random mid-run state at ``x``: the ring partly valid (row 0 has no
    history, rows 5.. some slots with rho <= 0), row 1 converged, row 2
    failed; f and g the objective's."""
    b, d = x.shape
    g = torch.Generator().manual_seed(seed + 1)
    dev = x.device
    f, grad = optim._value_and_grad(fb, x)
    # rows 3 and 4 were finite where the run stands; their objective now
    # returns a NaN value (row 3) or gradient (row 4) at every new point
    f[3:5] = 2.0
    grad[3:5] = torch.randn(2, d, generator=g).to(dev)
    s = 0.2 * torch.randn(b, m, d, generator=g).to(dev)
    y = s * (0.5 + torch.rand(b, m, 1, generator=g)).to(dev) \
        + 0.05 * torch.randn(b, m, d, generator=g).to(dev)
    rho = 1.0 / (s * y).sum(-1)
    drop = (torch.rand(b, m, generator=g) < 0.3).to(dev)
    rho = torch.where(drop, -rho.abs() * (torch.rand(b, m, generator=g)
                                          < 0.5).to(dev), rho)
    filled = min(k, m)  # slots written so far
    rho[:, filled:] = 0.0
    rho[0] = 0.0
    conv = torch.zeros(b, dtype=torch.bool, device=dev)
    failed = torch.zeros(b, dtype=torch.bool, device=dev)
    conv[1], failed[2] = True, True
    return optim._State(
        x=x, f=f, g=grad, s_hist=s.contiguous(), y_hist=y.contiguous(),
        rho_hist=rho.contiguous(), converged=conv, failed=failed,
        tprev=(0.05 + torch.rand(b, generator=g)).to(dev),
        bx=x.clone(), bf=f + 0.01, bg=grad.clone(),
        iters=torch.full((b,), k, dtype=torch.int32, device=dev))


def _recording(fb):
    points = []

    def rec(x):
        points.append(x.detach().clone())
        return fb(x)

    return rec, points


def _clone(state):
    return optim._State(*(a.clone() for a in state))


def _eager_step(fb, state, k, flags, *, m, tol, ftol, max_linesearch, c1,
                ls_evals):
    """One L-BFGS iteration as plain batched PyTorch, operation by
    operation (the history ring copied, a boolean read a trial): the oracle
    ``optim._step`` is held to, with its signature."""
    dot = lambda a, b: (a * b).sum(-1)  # noqa: E731
    norm = lambda a: torch.linalg.vector_norm(a, dim=-1)  # noqa: E731
    s_h, y_h, rho = state.s_hist, state.y_hist, state.rho_hist
    done = state.converged | state.failed
    idx = [(k - 1 - j) % m for j in range(m)]  # newest -> oldest
    q, alphas = state.g, []
    for i in idx:
        valid = rho[:, i] > 0.0
        alpha = torch.where(valid, rho[:, i] * dot(s_h[:, i], q), 0.0)
        q = q - alpha[:, None] * y_h[:, i] * valid[:, None]
        alphas.append(alpha)
    sy = dot(s_h[:, idx[0]], y_h[:, idx[0]])
    yy = dot(y_h[:, idx[0]], y_h[:, idx[0]])
    r = torch.where((rho[:, idx[0]] > 0.0) & (yy > 0.0), sy / yy,
                    1.0)[:, None] * q
    for j in reversed(range(m)):
        valid = rho[:, idx[j]] > 0.0
        beta = torch.where(valid, rho[:, idx[j]] * dot(y_h[:, idx[j]], r),
                           0.0)
        r = r + (alphas[j] - beta)[:, None] * s_h[:, idx[j]] * valid[:, None]
    direction = -r
    descent = dot(state.g, direction) < 0.0
    direction = torch.where(descent[:, None], direction, -state.g)
    t = torch.where((rho > 0.0).any(-1) & descent,
                    torch.clamp(4.0 * state.tprev, max=1.0),
                    1.0 / torch.clamp(norm(direction), min=1.0))
    gd = dot(state.g, direction)
    eps = ftol * torch.clamp(state.f.abs(), min=1.0)
    ok = done
    with torch.no_grad():
        for trials in range(1, max_linesearch + 1):
            fnew = fb(state.x + t[:, None] * direction)
            fnew = torch.where(torch.isfinite(fnew), fnew, torch.inf)
            ok_new = ok | (fnew <= state.f + c1 * t * gd + eps)
            tq = -gd * t * t / (2.0 * (fnew - state.f - gd * t))
            tq = torch.where(torch.isfinite(tq), tq, 0.0)
            tq = torch.minimum(torch.maximum(tq, 0.1 * t), 0.5 * t)
            t, ok = torch.where(ok_new, t, tq), ok_new
            if trials < max_linesearch and \
                    not optim.host_reads.read((~ok).any()):
                break
    ls_evals[k] = trials
    x_new = state.x + t[:, None] * direction
    f_new, g_new = optim._value_and_grad(fb, x_new)
    s, y = x_new - state.x, g_new - state.g
    sy = dot(s, y)
    accept = ok & (f_new <= state.f + eps) & ~done
    good = (sy > 1e-10) & accept
    ring = [a.clone() for a in (s_h, y_h, rho)]
    slot = k % m
    ring[0][:, slot] = torch.where(good[:, None], s, s_h[:, slot])
    ring[1][:, slot] = torch.where(good[:, None], y, y_h[:, slot])
    ring[2][:, slot] = torch.where(good, 1.0 / torch.clamp(sy, min=1e-30),
                                   rho[:, slot])
    x_out = torch.where(accept[:, None], x_new, state.x)
    f_out = torch.where(accept, f_new, state.f)
    g_out = torch.where(accept[:, None], g_new, state.g)
    conv = state.converged | (
        norm(g_out) < tol * torch.clamp(norm(x_out), min=1.0))
    conv = conv | (accept & (state.f - f_new
                             <= ftol * torch.clamp(f_new.abs(), min=1.0)))
    failed = state.failed | (~ok & ~conv & ~done)
    better = f_out < state.bf
    flags[1] = (~(conv | failed)).sum()
    return optim._State(
        x_out, f_out, g_out, *ring, conv, failed,
        torch.where(accept, t, state.tprev),
        torch.where(better[:, None], x_out, state.bx),
        torch.where(better, f_out, state.bf),
        torch.where(better[:, None], g_out, state.bg),
        torch.where(done, state.iters, torch.full_like(state.iters, k + 1)))


def _kernel_order(mp):
    """Make the plain versions sum as the kernels sum, through ``mp``, a
    monkeypatch."""
    for name in ("lbfgs_direction_plain", "lbfgs_update_plain"):
        mp.setattr(lk, name, functools.partial(getattr(lk, name),
                                               lanes=True))


def _one_step(fb, state, k, m, step=None):
    """``step`` (default ``optim._step``) from a copy of ``state`` ->
    (new state, trial points, trials, flags)."""
    rec, points = _recording(fb)
    ls, flags = [0] * 20, torch.zeros(2, dtype=torch.int32)
    out = (step or optim._step)(rec, _clone(state), k, flags, m=m,
                                ls_evals=ls, **KNOBS)
    return out, points, ls, flags


def _hold_step(got, ref, rtol):
    (a, pa, la, fa), (e, pe, le, fe) = got, ref
    assert la == le and len(pa) == len(pe)
    for p, q in zip(pa, pe):
        _close(p, q, rtol)
    for name in optim._State._fields:
        x, y = getattr(a, name), getattr(e, name)
        if x.dtype in (torch.bool, torch.int32) or rtol == 0.0:
            assert torch.equal(x, y), name
        else:
            _close(x, y, rtol)
    assert int(fa[1]) == int((~(e.converged | e.failed)).sum())


@pytest.mark.parametrize("d", [1, 3, 5, 11])
@pytest.mark.parametrize("k", [3, 8, 13], ids=["k3", "k8", "k13-wraps"])
def test_step_plain_route_matches_eager(d, k, monkeypatch):
    # one iteration from the same state: the plain route gives the eager
    # step's bits (trial points, trials, ring, iterate, statuses, best-seen
    # point); summing in the kernels' order it moves by rounding alone
    m, b = 8, 300
    fb, x = _objective(b, d, seed=d + k)
    state = _state(fb, x, m, k, seed=d * k)
    ref = _one_step(fb, state, k, m, _eager_step)
    got = _one_step(fb, state, k, m)
    _hold_step(got, ref, 0.0)
    _kernel_order(monkeypatch)
    _hold_step(_one_step(fb, state, k, m), ref, 0.0 if d == 1 else 2e-5)
    # the planted faults: row 3 backtracked every trial and failed, row 4's
    # NaN gradient kept it where it was, the done rows did not move
    new, _, ls, _ = got
    assert ls[k] == KNOBS["max_linesearch"]
    assert bool(new.failed[3]) and not bool(new.converged[3])
    assert torch.equal(new.x[4], state.x[4])
    assert torch.equal(new.x[1:3], state.x[1:3])
    assert torch.equal(new.iters[1:3], state.iters[1:3])


def test_each_plain_version_keeps_the_guards():
    b, d, m, k = 6, 3, 8, 9
    fb, x = _objective(b, d, seed=5)
    state = _state(fb, x, m, k, seed=5)
    flags = torch.tensor([7, 7], dtype=torch.int32)
    dr = lk.lbfgs_direction(state.x, state.f, state.g, state.s_hist,
                            state.y_hist, state.rho_hist, state.tprev,
                            state.converged, state.failed, k, 1e-6, flags)
    assert flags.tolist() == [0, 0]
    # no history: steepest descent, the first step 1 / max(|g|, 1)
    assert torch.equal(dr.direction[0], -state.g[0])
    want = 1.0 / max(float(state.g[0].norm()), 1.0)
    assert abs(float(dr.t[0]) - want) <= 1e-6 * want
    assert torch.equal(dr.ok, state.converged | state.failed)
    # a trial: a NaN value backtracks (flag set), a done row stays put
    fnew = state.f.clone()
    fnew[0] = torch.nan
    t0, xt0 = dr.t.clone(), dr.xt.clone()
    lk.lbfgs_trial(state.x, dr.direction, state.f, dr.gd, dr.eps, fnew, dr.t,
                   dr.ok, dr.xt, flags, 4, 1e-4)
    assert int(flags[0]) == 4 and not bool(dr.ok[0])
    # the quadratic step through an infinite value is 0: clamped to 0.1 t
    assert float(dr.t[0]) == pytest.approx(0.1 * float(t0[0]), rel=1e-6)
    assert torch.equal(dr.t[1:3], t0[1:3]) and torch.equal(dr.xt[1:3],
                                                            xt0[1:3])
    # the update: a non-finite gradient counts as (inf, 0) and is refused;
    # the ring slot k % m is written in place only for an accepted step
    ring = state.s_hist.clone()
    gn = state.g + 2.0 * (dr.xt - state.x)  # curvature s . y = 2 |s|^2
    gn[5, 1] = torch.inf
    ok = torch.ones(b, dtype=torch.bool)
    out = lk.lbfgs_update(state.x, state.f, state.g, dr.xt, state.f - 0.5,
                          gn, dr.t, ok, state.converged, state.failed,
                          state.tprev, state.bx, state.bf, state.bg,
                          state.iters, state.s_hist, state.y_hist,
                          state.rho_hist, k, 1e-4, 1e-6, flags)
    x_out, f_out = out[0], out[1]
    assert torch.equal(x_out[5], state.x[5]) and f_out[5] == state.f[5]
    assert torch.equal(state.s_hist[5], ring[5])
    changed = (state.s_hist != ring).any(-1)
    assert changed[[0, 3, 4], k % m].all()  # accepted rows: their slot
    assert not changed[1:3].any()  # done rows
    assert not changed[:, [i for i in range(m) if i != k % m]].any()
    assert int(flags[1]) == int((~(out[3] | out[4])).sum())


def _quadratics(d, b=256, seed=0, device="cpu", dtype=torch.float32):
    """Per-row convex quadratics -> ``(fb, straggler builder, x0,
    max_iters)``."""
    g = torch.Generator().manual_seed(seed + d)
    a = torch.randn(b, d, d, generator=g)
    a = (a @ a.transpose(1, 2) + 0.5 * torch.eye(d)).to(device, dtype)
    c = torch.randn(b, d, generator=g).to(device, dtype)

    def f(x, idx=slice(None)):
        return 0.5 * torch.einsum("bi,bij,bj->b", x, a[idx], x) \
            - (c[idx] * x).sum(-1)

    return f, (lambda idx: (lambda x: f(x, idx))), \
        torch.randn(b, d, generator=g).to(device, dtype), 80


def _garch_eager():
    r = entry.gen_garch_prices(256, 300, seed=2, device="cpu").diff(dim=1)
    ra, nv, u0, n_eff = garch._garch_prep(r, base.align_mode_on_host(r))
    fb, straggler = garch._garch_objective("eager", ra, nv, n_eff)
    return fb, straggler, u0, 80


class _ColumnMajorGrad(torch.autograd.Function):
    """The identity, whose gradient comes back column-major, as a kernel
    objective's ``[k, B]`` adjoint transposed does."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g.t().contiguous().t()


def _strided_gradient():
    f, straggler, x0, iters = _quadratics(3, seed=4)

    def col_major(fn):
        return lambda x: fn(_ColumnMajorGrad.apply(x))

    return col_major(f), (lambda idx: col_major(straggler(idx))), x0, iters


PROBLEMS = {"quadratic-d1": lambda: _quadratics(1),
            "quadratic-d3": lambda: _quadratics(3),
            "quadratic-d3-strided-gradient": _strided_gradient,
            # wider than the kernels take, in float64: the plain route
            "quadratic-d20-float64":
                lambda: _quadratics(20, dtype=torch.float64),
            "garch": _garch_eager}


def _minimize(fb, straggler, x0, iters):
    reads = optim.host_reads.count
    obs.enable()
    try:
        res, info = optim.minimize_lbfgs_batched(
            fb, x0, max_iters=iters, count_evals=True,
            straggler_fun=straggler, straggler_cap=64)
        work = {k: v for k, v in obs.snapshot()["counters"].items()
                if k.startswith("work.")}
    finally:
        obs.disable()
    return res, info, optim.host_reads.count - reads, work


@pytest.mark.parametrize("problem", PROBLEMS)
def test_minimize_plain_route_matches_eager(problem, monkeypatch):
    # whole runs, compaction engaged, against the same runs through the
    # eager step: the same bits, statuses, iterations, reads, line-search
    # trials and work counts
    fb, straggler, x0, iters = PROBLEMS[problem]()
    with monkeypatch.context() as mp:
        mp.setattr(optim, "_step", _eager_step)
        ref, ref_info, ref_reads, ref_work = _minimize(fb, straggler, x0,
                                                       iters)
    got, got_info, got_reads, got_work = _minimize(fb, straggler, x0, iters)
    assert ref_info["cap"] == 64 and ref_info["compact_at"] < iters
    assert got_info["compact_at"] == ref_info["compact_at"]
    assert torch.equal(got_info["ls_evals"], ref_info["ls_evals"])
    for a, e in zip(got, ref):
        assert torch.equal(a, e)
    assert got_reads == ref_reads
    assert got_work == ref_work and got_work["work.optim_iters"] > 0
    assert "work.optim_fused_iters" not in got_work  # the CPU: plain


@pytest.mark.parametrize("problem", PROBLEMS)
def test_minimize_plain_route_in_the_kernel_order(problem, monkeypatch):
    # the plain versions summing as the kernels sum: the kernels' order
    # moves a few rows by some iterations here (an ulp decides where a
    # row's relative decrease first falls below ftol), nothing more
    fb, straggler, x0, iters = PROBLEMS[problem]()
    ref, _, ref_reads, _ = _minimize(fb, straggler, x0, iters)
    _kernel_order(monkeypatch)
    got, _, got_reads, _ = _minimize(fb, straggler, x0, iters)
    assert torch.equal(got.converged, ref.converged)
    assert (got.iters == ref.iters).double().mean() >= 0.9
    assert abs(got_reads - ref_reads) <= 0.05 * ref_reads
    gap = (got.f - ref.f).abs() / ref.f.abs().clamp(min=1.0)
    assert float(gap.max()) <= 5e-3 and float(gap.median()) <= 1e-6


def test_route_rule_is_dtype_device_and_widths():
    x = torch.zeros(4, 3)
    assert not lk.fused_ok(x, 8)  # the CPU
    assert not lk.fused_ok(x.double(), 8)
    assert lk.structural_ok(1, 8) and lk.structural_ok(16, 16)
    assert not lk.structural_ok(17, 8) and not lk.structural_ok(3, 17)
    assert not lk.structural_ok(0, 8)
    # a CPU fit runs the plain route: no optimizer launch, no fused iteration
    fb, straggler, x0, _ = _quadratics(3, b=32)
    ck.reset_launch_counts()
    _, _, _, work = _minimize(fb, None, x0, 20)
    assert work["work.optim_iters"] > 0
    assert work.get("work.optim_fused_iters", 0) == 0
    assert sum(ck.OPTIM_LAUNCHES.values()) == 0


@pytest.mark.parametrize("bad", ["d17", "m17", "flags-float", "g-strided"])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad, monkeypatch):
    # the kernel route's checks, forced here (on the CPU, or wider than the
    # kernels take, the wrappers run the plain versions), before any launch
    monkeypatch.setattr(lk, "fused_ok", lambda x, m: True)
    b, d, m = 4, 17 if bad == "d17" else 3, 17 if bad == "m17" else 8
    st = optim._State(
        torch.zeros(b, d), torch.zeros(b), torch.zeros(b, d),
        torch.zeros(b, m, d), torch.zeros(b, m, d), torch.zeros(b, m),
        torch.zeros(b, dtype=torch.bool), torch.zeros(b, dtype=torch.bool),
        torch.ones(b), torch.zeros(b, d), torch.zeros(b), torch.zeros(b, d),
        torch.zeros(b, dtype=torch.int32))
    flags = torch.zeros(2, dtype=torch.float32 if bad == "flags-float"
                        else torch.int32)
    g = st.g.t().contiguous().t() if bad == "g-strided" else st.g
    err = TypeError if bad == "flags-float" else ValueError
    with pytest.raises(err):
        lk.lbfgs_direction(st.x, st.f, g, st.s_hist, st.y_hist, st.rho_hist,
                           st.tprev, st.converged, st.failed, 1, 1e-6, flags)


def test_two_optimizers_in_two_threads_plain_route():
    # each call keeps its flags in its own buffer: results as alone
    problems = [_quadratics(3, b=128, seed=s) for s in (1, 2)]
    alone = [_minimize(fb, st, x0, it)[0] for fb, st, x0, it in problems]
    out = [None, None]

    def work(i):
        fb, st, x0, it = problems[i]
        out[i] = optim.minimize_lbfgs_batched(
            fb, x0, max_iters=it, straggler_fun=st, straggler_cap=64)

    threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for a, e in zip(out, alone):
        assert torch.equal(a.x, e.x) and torch.equal(a.iters, e.iters)


# -- on the card -------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _close_rel(got, ref, rtol=3.4e-7):
    _close(got, ref, rtol)


@pytest.mark.card
@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_kernel_sums_are_pytorch_cuda_sums_on_the_card(d):
    # the lane order of the kernels' dot products and norms gives the bits
    # of the eager route's row sum and norm on the card
    dev = _card()
    g = torch.Generator(device=dev)
    g.manual_seed(d)
    a = torch.randn(1_000_000, d, generator=g, device=dev)
    b = torch.randn(1_000_000, d, generator=g, device=dev)
    assert torch.equal(lk._lane_dot(a, b), lk.row_dot(a, b))
    assert torch.equal(lk._lane_norm(a), lk.row_norm(a))


@pytest.mark.card
@pytest.mark.parametrize("d", [1, 3, 5, 11, 16])
@pytest.mark.parametrize("m", [8, 16])
def test_kernels_match_their_plain_versions_on_the_card(d, m):
    dev = _card()
    b, k = 5000, 2 * m + 3
    fb, x = _objective(b, d, seed=d + m, device=dev)
    state = _state(fb, x, m, k, seed=d)
    flags_k = torch.zeros(2, dtype=torch.int32, device=dev)
    flags_p = flags_k.clone()
    ck.reset_launch_counts()
    args = (state.x, state.f, state.g, state.s_hist, state.y_hist,
            state.rho_hist, state.tprev, state.converged, state.failed, k,
            1e-6)
    dk = lk.lbfgs_direction(*args, flags_k)
    dp = lk.lbfgs_direction_plain(*args, flags_p, lanes=True)
    for a, e in zip(dk, dp):
        if a.dtype == torch.bool:
            assert torch.equal(a, e)
        else:
            _close_rel(a, e)
    fnew = fb(dp.xt)
    for trial in (1, 2):
        lk.lbfgs_trial(state.x, dk.direction, state.f, dk.gd, dk.eps, fnew,
                       dk.t, dk.ok, dk.xt, flags_k, trial, 1e-4)
        lk.lbfgs_trial_plain(state.x, dp.direction, state.f, dp.gd, dp.eps,
                             fnew, dp.t, dp.ok, dp.xt, flags_p, trial, 1e-4)
        assert torch.equal(dk.ok, dp.ok)
        _close_rel(dk.t, dp.t)
        _close_rel(dk.xt, dp.xt)
        assert torch.equal(flags_k[0], flags_p[0])
    fn, gn = optim._raw_value_and_grad(fb, dp.xt)
    rk, rp = _clone(state), _clone(state)
    ok = dk.ok
    outs = []
    plain = functools.partial(lk.lbfgs_update_plain, lanes=True)
    for r, fn_update, fl in ((rk, lk.lbfgs_update, flags_k),
                             (rp, plain, flags_p)):
        outs.append(fn_update(state.x, state.f, state.g, dp.xt, fn, gn, dp.t,
                              ok, state.converged, state.failed, state.tprev,
                              state.bx, state.bf, state.bg, state.iters,
                              r.s_hist, r.y_hist, r.rho_hist, k, 1e-4, 1e-6,
                              fl))
    for a, e in zip(*outs):
        if a.dtype in (torch.bool, torch.int32):
            assert torch.equal(a, e)
        else:
            _close_rel(a, e)
    for name in ("s_hist", "y_hist", "rho_hist"):
        _close_rel(getattr(rk, name), getattr(rp, name))
    assert torch.equal(flags_k, flags_p)
    assert sum(ck.LAUNCHES.values()) == 0
    assert ck.OPTIM_LAUNCHES == {"lbfgs_direction": 1, "lbfgs_trial": 2,
                                 "lbfgs_update": 1}


def _limit(cell: str, name: str) -> float:
    return json.loads((LIMITS / f"{cell}.json").read_text())["limits"][name]


def _both_routes(fit):
    """``fit()`` on the kernel route and on the eager route -> ((result,
    launches, optimizer launches) for each)."""
    out = []
    real = lk.fused_ok
    for fused in (True, False):
        lk.fused_ok = real if fused else (lambda x, m: False)
        ck.reset_launch_counts()
        try:
            res = fit()
            torch.cuda.synchronize()
        finally:
            lk.fused_ok = real
        out.append((res, sum(ck.LAUNCHES.values()),
                    sum(ck.OPTIM_LAUNCHES.values())))
    return out


def _hold_fit(kern, eager, nll_limit):
    (a, la, oa), (e, le, oe) = kern, eager
    assert torch.equal(a.status, e.status)
    same_iters = (a.iters == e.iters).double().mean().item()
    assert same_iters >= 0.999, same_iters
    fa, fe = a.neg_log_likelihood, e.neg_log_likelihood
    ok = torch.isfinite(fe)
    assert torch.equal(torch.isfinite(fa), ok)
    gap = ((fa[ok] - fe[ok]).abs() / fe[ok].abs().clamp(min=1.0)).max()
    assert float(gap) <= nll_limit, float(gap)
    assert abs(la - le) <= 0.01 * le, (la, le)  # the objective's work
    assert oa > 0 and oe == 0


@pytest.mark.card
def test_garch_fit_on_both_routes_on_the_card():
    dev = _card()
    r = entry.gen_garch_prices(100_000, 1_000, seed=19, device=dev).diff(
        dim=1)
    _hold_fit(*_both_routes(lambda: garch.fit(r, device=dev)),
              _limit("garch11_vol_100k.pipeline", "nll_gap"))


@pytest.mark.card
def test_holtwinters_fit_on_both_routes_on_the_card():
    dev = _card()
    y = entry.gen_hourly_panel(1_000_000, 960, seed=19, device=dev)
    _hold_fit(*_both_routes(lambda: hw.fit(y, 24, "additive", device=dev)),
              _limit("hw_additive_hourly_1m.fit", "nll_gap"))


@pytest.mark.card
def test_two_optimizers_in_two_threads_on_the_card():
    dev = _card()
    runs = [_quadratics(3, b=20_000, seed=s, device=dev) for s in (1, 2)]
    alone = [optim.minimize_lbfgs_batched(fb, x0, max_iters=it)
             for fb, _, x0, it in runs]
    out = [None, None]

    def work(i):
        fb, _, x0, it = runs[i]
        out[i] = optim.minimize_lbfgs_batched(fb, x0, max_iters=it)

    threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    for a, e in zip(out, alone):
        assert torch.equal(a.x, e.x) and torch.equal(a.iters, e.iters)
