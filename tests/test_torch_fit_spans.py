"""The telemetry plane inside the port's fits and its batched L-BFGS.

With ``obs`` on, each public fit opens its entry span (``fit.arima``,
``fit.garch``, ``fit.argarch``, ``fit.holtwinters``) with ``fit.prep``,
the optimizer's ``optim.*`` spans and ``fit.finalize`` inside, in that
order; every counted device read is an ``optim.host_read`` span; and the
``work.*`` counters equal what the pass accounting (``count_evals``) and
the batch shape say.  With the plane off a fit records nothing, and its
results are bit for bit those of a fit with the plane on.  The kernel
library build keeps its own clock.
"""

import threading
import time

import numpy as np
import pytest
import torch

from spark_timeseries_tpu_torch import entry, obs
from spark_timeseries_tpu_torch.models import arima, garch
from spark_timeseries_tpu_torch.models import holtwinters as hw
from spark_timeseries_tpu_torch.ops import _build
from spark_timeseries_tpu_torch.ops import univariate as uv
from spark_timeseries_tpu_torch.utils import compile_cache, optim


@pytest.fixture
def plane():
    """The plane on, ring only; off again after the test."""
    obs.enable(ring_size=1 << 16)
    yield obs.core._STATE.recorder
    obs.disable()


def _tree(recorder):
    """The recorded spans as ``(name, [children])`` roots, rebuilt from
    their depths: a span is recorded when it closes, after its
    children."""
    pending = {}
    for ev in recorder.tail():
        if ev["kind"] != "span":
            continue
        d = ev["depth"]
        node = (ev["name"], pending.pop(d + 1, []))
        pending.setdefault(d, []).append(node)
    return pending.get(0, [])


def _names(nodes):
    return [n for n, _ in nodes]


def _check_optimizer(node, compacted=False):
    name, kids = node
    assert name == "optim.minimize"
    want = ["optim.init", "optim.lockstep"]
    if compacted:
        want += ["optim.compact", "optim.stragglers"]
    assert _names(kids) == want
    for stage in kids[1:]:
        if stage[0] == "optim.compact":
            assert stage[1] == []  # its sync is torch.nonzero, not a read
            continue
        loop = _names(stage[1])
        # a read of the live rows, then direction / line search / update
        # and the next read, iteration by iteration
        assert loop[0] == "optim.host_read" and len(loop) % 4 == 1
        for i in range(1, len(loop), 4):
            assert loop[i:i + 4] == ["optim.direction", "optim.linesearch",
                                     "optim.update", "optim.host_read"]
        for kid_name, kid_kids in stage[1]:
            want = "optim.host_read" if kid_name == "optim.linesearch" \
                else None
            assert all(n == want for n in _names(kid_kids)), kid_name
    assert kids[0][1] == []  # the first value and gradient: no read


def _arima_panel(rows=48, t=80):
    return entry.gen_panel(rows, t, seed=11, device="cpu")


def _garch_returns(rows=48, t=120):
    return entry.gen_garch_prices(rows, t + 1, seed=12,
                                  device="cpu").diff(dim=1)


def _hourly(rows=16, t=24 * 6):
    return entry.gen_hourly_panel(rows, t, seed=13, device="cpu")


FITS = {
    "arima": (lambda: arima.fit(_arima_panel(), (1, 1, 1), max_iters=12,
                                device="cpu"), "fit.arima", 1),
    "seasonal": (lambda: arima.fit(_arima_panel(16, 60), (1, 0, 0),
                                   seasonal=(1, 0, 0, 4), max_iters=6,
                                   device="cpu"), "fit.arima", 1),
    "garch": (lambda: garch.fit(_garch_returns(), max_iters=12,
                                device="cpu"), "fit.garch", 1),
    "argarch": (lambda: garch.fit_argarch(_garch_returns(), max_iters=8,
                                          device="cpu"), "fit.argarch", 1),
    "holtwinters": (lambda: hw.fit(_hourly(), 24, "multiplicative",
                                   max_iters=8, device="cpu"),
                    "fit.holtwinters", 3),
}


@pytest.mark.parametrize("fit", sorted(FITS))
def test_span_tree_of_a_fit(plane, fit):
    run, entry_name, starts = FITS[fit]
    reads0 = optim.host_reads.count
    run()
    reads = optim.host_reads.count - reads0
    roots = _tree(plane)
    assert _names(roots) == [entry_name]
    _, kids = roots[0]
    assert _names(kids) == (["fit.prep"] + ["optim.minimize"] * starts
                            + ["fit.finalize"])
    assert kids[0][1] == [] and kids[-1][1] == []
    for node in kids[1:-1]:
        _check_optimizer(node)
    spans = [e for e in plane.tail() if e["kind"] == "span"]
    attrs = spans[-1]["attrs"]
    assert attrs["backend"] == "eager" and attrs["rows"] > 0
    # every counted read is a span, and nothing else is one
    assert sum(e["name"] == "optim.host_read" for e in spans) == reads > 0
    hist = obs.snapshot()["histograms"]
    assert hist["span.optim.host_read"]["count"] == reads


def _compacting_problem():
    """Rows of mixed conditioning; the last row converges last, so the
    compacted batch's padding repeats a live row."""
    bsz, d = 2048, 3
    rng = np.random.default_rng(3)
    scales = torch.as_tensor(rng.uniform(0.5, 2.0, size=(bsz, d)),
                             dtype=torch.float32)
    scales[-40:] = torch.as_tensor(rng.uniform(0.05, 60.0, size=(40, d)),
                                   dtype=torch.float32)
    target = torch.as_tensor(rng.normal(size=(bsz, d)), dtype=torch.float32)

    def rows(x, sc, tg):
        r = (x - tg) * sc
        return (r ** 2 + 0.1 * r ** 4).sum(-1)

    return (lambda x: rows(x, scales, target),
            lambda idx: (lambda x: rows(x, scales[idx], target[idx])),
            torch.zeros(bsz, d))


def _recorded_reads(monkeypatch):
    """Record every counted read, in order: ``(value, made by a line
    search)``."""
    got, depth = [], [0]
    real_read, real_linesearch = optim.HostReadCounter.read, optim._linesearch

    def read(self, x):
        v = real_read(self, x)
        got.append((v, depth[0] > 0))
        return v

    def linesearch(*args, **kwargs):
        depth[0] += 1
        try:
            return real_linesearch(*args, **kwargs)
        finally:
            depth[0] -= 1

    monkeypatch.setattr(optim.HostReadCounter, "read", read)
    monkeypatch.setattr(optim, "_linesearch", linesearch)
    return got


def _hand_counts(ls, bsz, compact_at, cap, live_reads):
    """``(row_evals, live_row_evals)`` from the pass accounting: the start
    evaluates every row; iteration k evaluates its batch ls[k] + 1 times
    (its trials and its update), with the rows live at its start."""
    rows, live = bsz, bsz
    steps = [k for k in range(len(ls)) if ls[k] > 0]
    assert len(live_reads) == len(steps)
    for k, n_live in zip(steps, live_reads):
        batch = bsz if k < compact_at else cap
        rows += batch * (ls[k] + 1)
        live += n_live * (ls[k] + 1)
    return rows, live


@pytest.mark.parametrize("compact", [False, True])
def test_work_counters_are_the_pass_accounting(plane, monkeypatch, compact):
    fun, straggler_fun, x0 = _compacting_problem()
    reads = _recorded_reads(monkeypatch)
    kw = dict(straggler_fun=straggler_fun, straggler_cap=1024) \
        if compact else {}
    res, info = optim.minimize_lbfgs_batched(fun, x0, max_iters=60,
                                             count_evals=True, **kw)
    ls = [int(v) for v in info["ls_evals"]]
    # the live counts: the loop's reads outside the line search, less the
    # one that ends each stage
    ints = [v for v, in_linesearch in reads if not in_linesearch]
    n_stages = 2 if info["cap"] else 1
    steps = sum(1 for v in ls if v > 0)
    assert len(ints) == steps + n_stages
    if info["cap"]:
        at = info["compact_at"]
        live_reads = ints[:at] + ints[at + 1:-1]
        n_real = ints[at]
        assert 0 < n_real <= info["cap"]
        # the padding repeats row bsz-1, which was live when the batch was
        # compacted: still only the real rows count as live
        assert int(res.iters[-1]) > at
        assert all(v <= n_real for v in ints[at + 1:])
    else:
        live_reads = ints[:-1]
    rows, live = _hand_counts(ls, x0.shape[0], info["compact_at"],
                              info["cap"], live_reads)
    counters = obs.snapshot()["counters"]
    assert counters["work.row_evals"] == rows
    assert counters["work.live_row_evals"] == live
    assert live < rows
    if compact:
        assert int(info["cap"]) == 1024 and info["compact_at"] < 60
        spans = {e["name"] for e in plane.tail() if e["kind"] == "span"}
        assert {"optim.compact", "optim.stragglers"} <= spans
        _check_optimizer(_tree(plane)[0], compacted=True)


def _count_rows(monkeypatch, model, attr):
    """Wrap ``model.attr`` (an objective) to note each call's rows and
    whether it is differentiated."""
    calls = []
    real = getattr(model, attr)

    def wrapped(p, *args, **kwargs):
        calls.append((p.shape[0], p.requires_grad and torch.is_grad_enabled()))
        return real(p, *args, **kwargs)

    monkeypatch.setattr(model, attr, wrapped)
    return calls


OBJECTIVES = {
    # fit, the objective the eager backend evaluates, its time steps
    "arima": (lambda: arima.fit(_arima_panel(), (1, 1, 1), max_iters=10,
                                backend="eager", count_evals=True,
                                device="cpu"), arima, "css_neg_loglik", 79),
    "garch": (lambda: garch.fit(_garch_returns(), max_iters=10,
                                backend="eager", count_evals=True,
                                device="cpu"), garch, "neg_log_likelihood",
              120),
    "holtwinters": (lambda: hw.fit(_hourly(), 24, "additive", max_iters=10,
                                   backend="eager", count_evals=True,
                                   device="cpu"), hw, "sse", 144),
}


@pytest.mark.parametrize("name", sorted(OBJECTIVES))
def test_objective_row_steps_on_the_eager_backend(plane, monkeypatch, name):
    run, model, attr, steps = OBJECTIVES[name]
    calls = _count_rows(monkeypatch, model, attr)
    res, info = run()
    ls = [int(v) for v in info["ls_evals"]]
    bsz = res.params.shape[0]
    ran = sum(1 for v in ls if v > 0)
    # the start and each update: a forward and an adjoint sweep of the
    # batch; each line-search trial: a forward sweep
    want = steps * bsz * (2 * (1 + ran) + sum(ls))
    assert obs.snapshot()["counters"]["work.objective_row_steps"] == want
    assert sum(r * (2 if grad else 1) for r, grad in calls) * steps == want


@pytest.mark.parametrize("name", ["arima", "garch"])
def test_objective_row_steps_reads_the_same_on_both_backends(monkeypatch,
                                                             name):
    # the cuda backend runs its kernels' plain versions on the CPU
    model = {"arima": arima, "garch": garch}[name]
    monkeypatch.setattr(model, "resolve_backend",
                        lambda backend, y, structural_ok=True: backend)
    got = {}
    for backend in ("eager", "cuda"):
        obs.enable()
        try:
            if name == "arima":
                _, info = arima.fit(_arima_panel(), (1, 1, 1), max_iters=10,
                                    backend=backend, count_evals=True,
                                    device="cpu")
            else:
                _, info = garch.fit(_garch_returns(), max_iters=10,
                                    backend=backend, count_evals=True,
                                    device="cpu")
            got[backend] = (obs.snapshot()["counters"]
                            ["work.objective_row_steps"],
                            [int(v) for v in info["ls_evals"]])
        finally:
            obs.disable()
    (n_e, ls_e), (n_c, ls_c) = got["eager"], got["cuda"]
    ran = sum(1 for v in ls_c if v > 0)
    steps = 79 if name == "arima" else 120
    assert n_c == steps * 48 * (2 * (1 + ran) + sum(ls_c))
    if ls_e == ls_c:  # the same passes: the same work
        assert n_e == n_c


class _Refuse:
    def __getattr__(self, name):
        raise AssertionError(f"the plane is off: nothing may reach {name}")


@pytest.mark.parametrize("fit", sorted(FITS))
def test_plane_on_and_off_give_the_same_bits(monkeypatch, fit):
    run = FITS[fit][0]
    # off: no span object is made and the registry is never touched
    monkeypatch.setattr(obs.core, "Span", _Refuse())
    monkeypatch.setattr(obs.core._STATE, "metrics", _Refuse())
    assert not obs.enabled()
    off = run()
    monkeypatch.undo()
    obs.enable()
    try:
        on = run()
    finally:
        obs.disable()
    for a, b in zip(off, on):
        if isinstance(a, torch.Tensor):
            assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


def test_profile_mirror_shows_the_fit_spans():
    from torch.profiler import ProfilerActivity, profile
    obs.enable(profile=True)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            garch.fit(_garch_returns(16, 60), max_iters=4, device="cpu")
    finally:
        obs.disable()
    names = {e.name for e in prof.events()}
    assert {"fit.garch", "fit.prep", "fit.finalize", "optim.minimize",
            "optim.init", "optim.lockstep", "optim.direction",
            "optim.linesearch", "optim.update", "optim.host_read"} <= names


def test_transform_spans(plane):
    y = _garch_returns(8, 50)
    y[:, 3] = float("nan")
    (diff,) = uv.batch_fill_linear_chain(y, outputs=["diff"])
    uv.batch_autocorr(5)(diff)
    uv.batch_autocorr(5)  # building the callable runs nothing
    names = [e["name"] for e in plane.tail() if e["kind"] == "span"]
    assert names == ["transforms.fill_chain", "transforms.autocorr"]


@pytest.mark.parametrize("on", [False, True])
def test_host_reads_count_every_read_across_threads(on):
    threads, calls = 8, 500
    x = torch.tensor(3)
    start = threading.Barrier(threads)
    if on:
        obs.enable()
    try:
        before = optim.host_reads.count

        def work():
            start.wait()
            for _ in range(calls):
                assert optim.host_reads.read(x) == 3

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in pool)
        assert optim.host_reads.count - before == threads * calls
        if on:
            hist = obs.snapshot()["histograms"]["span.optim.host_read"]
            assert hist["count"] == threads * calls
    finally:
        obs.disable()


class _FakeProc:
    def __init__(self, tmp):
        self.tmp, self.returncode = tmp, None

    def communicate(self):
        self.tmp.write_bytes(b"lib")
        self.returncode = 0
        return "ptxas info: fake", None

    def poll(self):
        return self.returncode


def test_build_clock_and_build_spans(tmp_path, monkeypatch):
    (tmp_path / "kernels").mkdir()
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_counted", set())
    monkeypatch.setattr(_build, "_start", lambda n, d, out: (
        _FakeProc(out.with_suffix(".tmp")), out.with_suffix(".tmp"), out))
    before = compile_cache.program_cache_stats()["build_s"]
    obs.enable()
    try:
        logs = _build.build_all(("ewma", "hr"))
        again = _build.build_all(("ewma", "hr"))  # up to date: no job
        hist = obs.snapshot()["histograms"]
    finally:
        obs.disable()
    assert len(logs) == 2 and again == {}
    assert hist["span.kernels.build"]["count"] == 2
    spent = compile_cache.program_cache_stats()["build_s"] - before
    assert spent >= hist["span.kernels.build"]["sum"] - 1e-6 and spent > 0


def test_process_clock_is_read_at_a_bounded_cost(monkeypatch):
    # a slow process clock (1 ms a read) is read at most once every 100
    # times its cost: a few reads over many short spans, none negative
    reads = []

    def slow_clock():
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 1e-3:
            pass
        reads.append(1)
        return time.thread_time()

    monkeypatch.setattr(obs.core.time, "process_time", slow_clock)
    monkeypatch.setattr(obs.core._TLS, "cpu", None, raising=False)
    obs.enable()
    try:
        t0 = time.perf_counter()
        spans = []
        for _ in range(2000):
            with obs.span("optim.host_read") as sp:
                pass
            spans.append(sp.process_s)
        wall = time.perf_counter() - t0
    finally:
        obs.disable()
    assert len(reads) <= wall / 0.1 + 2
    assert min(spans) >= 0.0
