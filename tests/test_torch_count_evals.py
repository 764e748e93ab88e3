"""Pass accounting (``count_evals``) in the port's batched L-BFGS and fits.

The port's counterparts of the reference's checks (``tests/test_optim.py``
``test_compaction_engages_and_counts``, ``tests/test_pallas.py``
``test_arima_fit_straggler_compaction_parity``): the cap, compaction
engaging before the last iteration, and ``ls_evals`` adding up to the
line-search evaluations a wrapped objective counts.  An objective
evaluated with autograd on is a value-and-gradient evaluation (one at the
start, one an iteration); with autograd off it is a line-search trial.
"""

import numpy as np
import pytest
import torch

from spark_timeseries_tpu_torch import entry
from spark_timeseries_tpu_torch.models import arima, base, garch
from spark_timeseries_tpu_torch.models import holtwinters as hw
from spark_timeseries_tpu_torch.utils import optim


class _Counted:
    """Wraps an objective; counts its line-search trials (autograd off) and
    its value-and-gradient evaluations (autograd on)."""

    def __init__(self):
        self.trials = 0
        self.grads = 0

    def wrap(self, fn):
        def counted(*args, **kwargs):
            if torch.is_grad_enabled():
                self.grads += 1
            else:
                self.trials += 1
            return fn(*args, **kwargs)
        return counted


def _check_counts(info, calls: _Counted, max_iters: int):
    ls = info["ls_evals"]
    assert ls.dtype == torch.int32 and tuple(ls.shape) == (max_iters,)
    assert int(ls.sum()) == calls.trials
    # one value and gradient at the start and one each iteration run; an
    # iteration runs at least one trial
    ran = int((ls > 0).sum())
    assert calls.grads == 1 + ran
    assert bool((ls[ran:] == 0).all())


def _straggler_problem(bsz=64, d=3, seed=0):
    """The reference test's problem: rows with wildly mixed conditioning."""
    rng = np.random.default_rng(seed)
    scales = torch.as_tensor(rng.uniform(0.05, 50.0, size=(bsz, d)),
                             dtype=torch.float32)
    target = torch.as_tensor(rng.normal(size=(bsz, d)), dtype=torch.float32)

    def rows(x, sc, tg):
        r = (x - tg) * sc
        return (r ** 2 + 0.1 * r ** 4).sum(-1)

    return (lambda x: rows(x, scales, target),
            lambda idx: (lambda x: rows(x, scales[idx], target[idx])),
            torch.zeros(bsz, d))


def test_compaction_engages_and_counts():
    fun, straggler_fun, x0 = _straggler_problem()
    calls = _Counted()
    got, info = optim.minimize_lbfgs_batched(
        calls.wrap(fun), x0, max_iters=80,
        straggler_fun=lambda idx: calls.wrap(straggler_fun(idx)),
        straggler_cap=16, count_evals=True)
    assert int(info["cap"]) == 16
    # the batch cannot finish before the stragglers fit the cap, so
    # compaction engages strictly before the final iteration
    assert int(info["compact_at"]) < int(got.iters.max())
    assert bool(got.converged.all())
    _check_counts(info, calls, 80)


def test_count_evals_changes_nothing_else():
    fun, straggler_fun, x0 = _straggler_problem(seed=1)
    kw = dict(max_iters=80, straggler_fun=straggler_fun, straggler_cap=16)
    ref = optim.minimize_lbfgs_batched(fun, x0, **kw)
    got, info = optim.minimize_lbfgs_batched(fun, x0, count_evals=True, **kw)
    for a, b in zip(ref, got):
        assert torch.equal(a, b)


def test_without_compaction_compact_at_is_the_iterations_run():
    fun, _, x0 = _straggler_problem(bsz=8, seed=2)
    calls = _Counted()
    got, info = optim.minimize_lbfgs_batched(calls.wrap(fun), x0,
                                             max_iters=80, count_evals=True)
    assert info["cap"] == 0
    assert info["compact_at"] == int(got.iters.max())
    _check_counts(info, calls, 80)


@pytest.mark.parametrize("backend", ["eager", "cuda"])
def test_arima_fit_straggler_compaction_counts(monkeypatch, backend):
    # compaction forced on at a test-tractable batch, as the reference's
    # test forces it; the cuda backend's fit runs its kernels' plain
    # versions on the CPU
    b, t, iters = 2048, 64, 14
    y = entry.gen_panel(b, t, seed=77, device="cpu")
    calls = _Counted()
    if backend == "eager":
        monkeypatch.setattr(arima, "css_neg_loglik",
                            calls.wrap(arima.css_neg_loglik))
    else:
        monkeypatch.setattr(arima.ck, "css_neg_loglik_folded",
                            calls.wrap(arima.ck.css_neg_loglik_folded))
        monkeypatch.setattr(arima, "resolve_backend",
                            lambda backend, y, structural_ok=True: "cuda")
    monkeypatch.setattr(arima, "_COMPACT_MIN_BATCH", 2048)
    got, info = arima.fit(y, (1, 1, 1), max_iters=iters, backend=backend,
                          count_evals=True, device="cpu")
    assert int(info["cap"]) == 1024
    assert int(info["compact_at"]) < iters  # compaction actually engaged
    _check_counts(info, calls, iters)
    ref = arima.fit(y, (1, 1, 1), max_iters=iters, backend=backend,
                    device="cpu")
    for a, b_ in zip(ref, got):  # counting changes no result
        assert torch.equal(a, b_)


def test_garch_fit_counts():
    r = entry.gen_garch_prices(64, 300, seed=3, device="cpu").diff(dim=1)
    res, info = garch.fit(r, count_evals=True, device="cpu")
    assert set(info) == {"ls_evals", "compact_at", "cap"}
    assert info["cap"] == 0 and tuple(info["ls_evals"].shape) == (80,)
    assert info["compact_at"] == int(res.iters.max())
    single, info1 = garch.fit(r[5], count_evals=True, device="cpu")
    assert tuple(single.params.shape) == (3,)  # debatched, info kept
    assert tuple(info1["ls_evals"].shape) == (80,)


def test_holtwinters_fit_counts_the_first_start():
    y = entry.gen_hourly_panel(16, 24 * 8, seed=4, device="cpu")
    res, info = hw.fit(y, 24, "multiplicative", max_iters=20,
                       count_evals=True, device="cpu")
    assert info["n_starts"] == 3 and tuple(info["ls_evals"].shape) == (20,)
    ref = hw.fit(y, 24, "multiplicative", max_iters=20, device="cpu")
    for a, b in zip(ref, res):
        assert torch.equal(a, b)
    # the first start alone, counted: the same accounting
    one, info1 = hw.fit(y, 24, "multiplicative", max_iters=20, n_starts=1,
                        count_evals=True, device="cpu")
    assert torch.equal(info1["ls_evals"], info["ls_evals"])
    assert info1["n_starts"] == 1


def test_hannan_rissanen_refuses_count_evals():
    y = entry.gen_panel(8, 60, seed=5, device="cpu")
    with pytest.raises(ValueError, match="optimizing method"):
        arima.fit(y, (1, 1, 1), method="hannan-rissanen", count_evals=True,
                  device="cpu")


def test_require_and_debatch_fit():
    for backend in ("eager", "cuda"):
        base.require_pallas_for_count_evals(True, backend)
    base.require_pallas_for_count_evals(False, "auto")
    with pytest.raises(ValueError):
        base.require_pallas_for_count_evals(True, "auto")
    res = base.FitResult(torch.ones(1, 2), torch.ones(1), torch.ones(1),
                         torch.ones(1), None)
    one, info = base.debatch_fit((res, {"cap": 0}), True, True)
    assert tuple(one.params.shape) == (2,) and info == {"cap": 0}
    assert tuple(base.debatch_fit(res, False, False).params.shape) == (1, 2)
