"""The port's resilient fit path (``reliability``: sanitize -> fit -> retry
ladder, the deadline watchdog, fault injection, the OOM classifier)
against the reference's on the same seeded inputs.

The panel is 32 x 200 integrated ARMA(1,1) rows with every data fault
(interior NaN runs, inf spikes, a constant row, an all-NaN row, an
explosive row) and ``failing_fit`` rows at ``n_failures`` 1, 2 and 99.
Tolerances: the faults are the same bits; ``sanitize`` leaves untouched
rows bit for bit and repairs the others within 1e-6 (absolute plus
relative: the two linear fills round differently by an ulp); the ladder
gives the same status on every row and the same meta, the fallback rung's
backend name aside (a recorded difference); parameters agree within the
ARIMA parity bar ``test_torch_arima.py`` holds against the reference's
scan backend (4e-3).
"""

import importlib
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu import obs as ref_obs
from spark_timeseries_tpu.models import arima as jarima
from spark_timeseries_tpu.reliability import faultinject as jfi
from spark_timeseries_tpu.reliability import plan as jplan
from spark_timeseries_tpu.reliability import runner as jrunner
from spark_timeseries_tpu.reliability import watchdog as jwd
from spark_timeseries_tpu_torch import obs
from spark_timeseries_tpu_torch.models import arima as tarima
from spark_timeseries_tpu_torch.reliability import (FitStatus,
                                                    faultinject as tfi,
                                                    plan as tplan,
                                                    runner as trunner,
                                                    watchdog as twd)

jsan = importlib.import_module("spark_timeseries_tpu.reliability.sanitize")
tsan = importlib.import_module(
    "spark_timeseries_tpu_torch.reliability.sanitize")

B, T = 32, 200
NAN_ROWS, INF_ROWS, CONST_ROWS, ALLNAN_ROWS, EXPLOSIVE_ROWS = (
    [0, 1, 2], [3, 4], [5], [6], [7])
FAIL_ROWS = {1: [10, 11], 2: [12, 13], 99: [14, 15]}
PARAM_TOL = 4e-3
MAX_ITERS = 30


def _arma_panel(b=B, t=T, seed=3):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(b, t)).astype(np.float32)
    y = np.zeros_like(e)
    y[:, 0] = e[:, 0]
    for i in range(1, t):
        y[:, i] = 0.6 * y[:, i - 1] + e[:, i] + 0.3 * e[:, i - 1]
    return np.cumsum(y, axis=1)


def _faulted(fi, y):
    y = fi.inject_nan_rows(y, NAN_ROWS, seed=1)
    y = fi.inject_inf_rows(y, INF_ROWS, seed=2)
    y = fi.make_constant_rows(y, CONST_ROWS)
    y = fi.make_all_nan_rows(y, ALLNAN_ROWS)
    return fi.make_explosive_rows(y, EXPLOSIVE_ROWS, seed=4)


def _failing(fi, fit, y):
    for n, rows in FAIL_ROWS.items():
        fit = fi.failing_fit(fit, y, rows, n_failures=n)
    return fit


@pytest.fixture(autouse=True)
def _planes_off():
    yield
    obs.disable()
    ref_obs.disable()


@pytest.fixture(scope="module")
def panels():
    y = _arma_panel()
    return y, _faulted(jfi, y), _faulted(tfi, torch.as_tensor(y))


@pytest.fixture(scope="module")
def ladder_runs(panels, tmp_path_factory):
    """Both packages' resilient fits of the faulted panel, with each
    package's telemetry plane on: (ref result, port result, ref counters,
    port counters)."""
    _, yj, yt = panels
    d = tmp_path_factory.mktemp("obs")
    try:
        ref_obs.enable(str(d / "ref.jsonl"))
        ref = jrunner.resilient_fit(_failing(jfi, jarima.fit, yj),
                                    jnp.asarray(yj), order=(1, 1, 1),
                                    max_iters=MAX_ITERS)
        ref_counters = ref_obs.snapshot()["counters"]
        obs.enable(str(d / "port.jsonl"))
        port = trunner.resilient_fit(_failing(tfi, tarima.fit, yt), yt,
                                     order=(1, 1, 1), max_iters=MAX_ITERS,
                                     device="cpu")
        port_counters = obs.snapshot()["counters"]
    finally:
        obs.disable()
        ref_obs.disable()
    return ref, port, ref_counters, port_counters


# -- fault injection ---------------------------------------------------------


def test_data_faults_are_the_references_bits(panels):
    y, yj, yt = panels
    np.testing.assert_array_equal(yt.numpy(), yj)
    # numpy in, numpy out, as the reference; the input is never written
    yn = _faulted(tfi, y)
    assert isinstance(yn, np.ndarray)
    np.testing.assert_array_equal(yn, yj)
    np.testing.assert_array_equal(y, _arma_panel())
    np.testing.assert_array_equal(tfi.nonspd_gram(5), jfi.nonspd_gram(5))


def test_failing_fit_needs_unique_finite_tails(panels):
    y, yj, yt = panels
    with pytest.raises(ValueError):
        tfi.failing_fit(tarima.fit, yt, ALLNAN_ROWS)
    dup = yt.clone()
    dup[20, -1] = dup[21, -1]
    with pytest.raises(ValueError):
        tfi.failing_fit(tarima.fit, dup, [20, 21])


def test_oom_fit_and_the_classifier():
    fit = tfi.oom_fit(lambda yb, **kw: "ran", max_rows=4)
    assert fit(torch.zeros(4, 3)) == "ran"
    with pytest.raises(tfi.SimulatedResourceExhausted) as ei:
        fit(torch.zeros(5, 3))
    err = ei.value
    assert tplan.is_resource_exhausted(err)
    assert jplan.is_resource_exhausted(err)
    cuda_oom = torch.cuda.OutOfMemoryError("CUDA error: allocation refused")
    assert tplan.is_resource_exhausted(cuda_oom)
    for e in (MemoryError(), RuntimeError("Out of memory while x"),
              RuntimeError("shape mismatch"), ValueError("out of memory"),
              jfi.SimulatedResourceExhausted(8)):
        assert tplan.is_resource_exhausted(e) == jplan.is_resource_exhausted(e)
    assert issubclass(tplan.OOMBackoffExceeded, RuntimeError)
    assert issubclass(tfi.SimulatedCrash, BaseException)
    assert not issubclass(tfi.SimulatedCrash, Exception)


# -- sanitize ----------------------------------------------------------------


@pytest.mark.parametrize("policy", ["impute", "exclude"])
def test_sanitize_matches_reference(panels, policy):
    y, yj, yt = panels
    ref = jsan.sanitize(jnp.asarray(yj), policy=policy)
    got = tsan.sanitize(yt, policy=policy)
    np.testing.assert_array_equal(got.status, ref.status)
    assert got.status.dtype == ref.status.dtype
    assert got.meta == ref.meta
    assert set(got.flags) == set(ref.flags)
    for k in ref.flags:
        np.testing.assert_array_equal(got.flags[k], np.asarray(ref.flags[k]))
    gv, rv = got.values.numpy(), np.asarray(ref.values)
    touched = got.status != FitStatus.OK
    # untouched rows: the input's bits
    np.testing.assert_array_equal(gv[~touched], yj[~touched])
    np.testing.assert_array_equal(rv[~touched], yj[~touched])
    np.testing.assert_array_equal(np.isnan(gv), np.isnan(rv))
    np.testing.assert_allclose(gv[touched], rv[touched], rtol=1e-6,
                               atol=1e-6)


def test_sanitize_raise_policy_and_shapes(panels):
    y, yj, yt = panels
    with pytest.raises(ValueError, match="failed sanitization"):
        tsan.sanitize(yt, policy="raise")
    with pytest.raises(ValueError):
        jsan.sanitize(jnp.asarray(yj), policy="raise")
    with pytest.raises(ValueError, match="unknown sanitize policy"):
        tsan.sanitize(yt, policy="drop")
    with pytest.raises(ValueError, match=r"\[batch, time\]"):
        tsan.sanitize(yt[0])


def test_sanitize_leaves_a_clean_panel_alone(panels):
    y, _, _ = panels
    yc = torch.as_tensor(y)
    yc[2, :7] = float("nan")  # ragged starts and ends are not faults
    yc[3, -5:] = float("nan")
    rep = tsan.sanitize(yc)
    assert rep.values is yc  # nothing to repair: no copy
    assert rep.meta == jsan.sanitize(jnp.asarray(yc.numpy())).meta
    assert not rep.status.any()
    # a numpy panel with nothing wrong passes the reference and the raise
    # policy alike
    assert tsan.sanitize(yc, policy="raise").values is yc


def test_sanitize_probe_blocks_agree(panels, monkeypatch):
    _, _, yt = panels
    whole = tsan.sanitize(yt)
    monkeypatch.setattr(tsan, "_PROBE_BLOCK_ELEMENTS", 3 * T)  # 3-row blocks
    blocked = tsan.sanitize(yt)
    np.testing.assert_array_equal(blocked.status, whole.status)
    assert blocked.meta == whole.meta
    assert torch.equal(torch.isnan(blocked.values), torch.isnan(whole.values))
    ok = ~torch.isnan(whole.values)
    assert torch.equal(blocked.values[ok], whole.values[ok])


def _edge_rows(t=12):
    """Rows at the edges of the probe's definitions."""
    inf, nan = float("inf"), float("nan")
    r = np.arange(t, dtype=np.float32)
    rows = {
        "ragged": np.r_[[nan] * 3, r[3:-2], [nan] * 2],
        "one valid": np.r_[[nan] * 5, [2.5], [nan] * (t - 6)],
        "inf at the ends": np.r_[[inf], r[1:-1], [-inf]],
        "inf and constant": np.r_[[1.5] * 4, [inf], [1.5] * (t - 5)],
        "all inf": np.full(t, inf),
        "signed zeros": np.r_[[0.0, -0.0] * (t // 2)],
        "constant with a gap": np.r_[[nan, 3.0, 3.0, nan], [3.0] * (t - 4)],
        "gap by one": np.r_[r[:5], [nan], r[6:]],
        "all NaN": np.full(t, nan),
        "nan and inf only": np.r_[[nan, inf] * (t // 2)],
    }
    return list(rows), np.stack(list(rows.values())).astype(np.float32)


@pytest.mark.parametrize("block_rows", [1, 3, 64])
def test_sanitize_edge_rows_match_reference(block_rows, monkeypatch):
    names, y = _edge_rows()
    monkeypatch.setattr(tsan, "_PROBE_BLOCK_ELEMENTS",
                        block_rows * y.shape[1])
    ref = jsan.sanitize(jnp.asarray(y))
    got = tsan.sanitize(torch.as_tensor(y))
    for k in ref.flags:
        np.testing.assert_array_equal(got.flags[k], np.asarray(ref.flags[k]),
                                      err_msg=f"{k}: rows {names}")
    np.testing.assert_array_equal(got.status, ref.status)
    assert got.meta == ref.meta


# -- the ladder ---------------------------------------------------------------


def test_resilient_fit_status_per_row_matches_reference(ladder_runs):
    ref, port, _, _ = ladder_runs
    np.testing.assert_array_equal(port.status, ref.status)
    assert port.status.dtype == np.int8
    assert port.meta["status_counts"] == ref.meta["status_counts"]
    want = np.zeros(B, np.int8)
    want[NAN_ROWS + INF_ROWS] = FitStatus.SANITIZED
    want[CONST_ROWS + ALLNAN_ROWS] = FitStatus.EXCLUDED
    want[EXPLOSIVE_ROWS] = FitStatus.DIVERGED
    want[FAIL_ROWS[1]] = FitStatus.RETRIED
    want[FAIL_ROWS[2]] = FitStatus.FALLBACK
    want[FAIL_ROWS[99]] = FitStatus.DIVERGED
    np.testing.assert_array_equal(port.status, want)


def test_resilient_fit_meta_matches_reference(ladder_runs):
    ref, port, _, _ = ladder_runs
    assert port.meta["sanitize"] == ref.meta["sanitize"]
    assert port.meta["retry_rows_over_cap"] == ref.meta["retry_rows_over_cap"]
    want = [dict(r, kwargs=dict(r["kwargs"])) for r in ref.meta["ladder"]]
    assert want[1]["kwargs"]["backend"] == "scan"
    want[1]["kwargs"]["backend"] = "auto"  # the recorded difference
    assert port.meta["ladder"] == want


def test_resilient_fit_params_match_reference(ladder_runs):
    ref, port, _, _ = ladder_runs
    for f in ("params", "neg_log_likelihood", "converged", "iters"):
        assert isinstance(getattr(port, f), np.ndarray), f
    np.testing.assert_array_equal(np.isnan(port.params),
                                  np.isnan(np.asarray(ref.params)))
    np.testing.assert_array_equal(port.converged, np.asarray(ref.converged))
    fin = np.isfinite(port.params).all(1)
    usable = ~np.isin(port.status, [FitStatus.EXCLUDED, FitStatus.DIVERGED])
    np.testing.assert_array_equal(fin, usable)
    np.testing.assert_allclose(port.params[fin],
                               np.asarray(ref.params)[fin],
                               rtol=PARAM_TOL, atol=PARAM_TOL)


def test_ladder_counters_match_reference(ladder_runs):
    _, _, ref_c, port_c = ladder_runs
    # compile_cache.* counts the reference's compiled-program lookups and
    # the port's kernel-library loads: different programs, not compared;
    # work.* (the optimizer's and objectives' work counts) is the port's
    # alone
    keep = lambda c: {k: v for k, v in c.items()  # noqa: E731
                      if not k.startswith(("compile_cache.", "work."))}
    assert keep(port_c) == keep(ref_c)
    assert port_c["ladder.retry.attempted"] == 7
    assert port_c["sanitize.rows_sanitized"] == 5


def test_ok_rows_equal_a_plain_fit_of_the_sanitized_panel(panels,
                                                          ladder_runs):
    _, _, yt = panels
    _, port, _, _ = ladder_runs
    clean = tsan.sanitize(yt).values
    plain = tarima.fit(clean, (1, 1, 1), max_iters=MAX_ITERS, device="cpu")
    ok = port.status <= FitStatus.SANITIZED
    np.testing.assert_array_equal(port.params[ok], plain.params.numpy()[ok])


def test_clean_panel_is_the_plain_fit_bit_for_bit(panels):
    y, _, _ = panels
    yc = torch.as_tensor(y[:12])
    res = trunner.resilient_fit(tarima.fit, yc, order=(1, 1, 1),
                                max_iters=MAX_ITERS, device="cpu")
    plain = tarima.fit(yc, (1, 1, 1), max_iters=MAX_ITERS, device="cpu")
    for f in ("params", "neg_log_likelihood", "converged", "iters"):
        np.testing.assert_array_equal(getattr(res, f),
                                      getattr(plain, f).numpy(), err_msg=f)
    assert res.meta["ladder"] == []
    assert res.meta["status_counts"]["OK"] == 12
    # numpy in: moved to fit_kwargs["device"]
    res_np = trunner.resilient_fit(tarima.fit, y[:12], order=(1, 1, 1),
                                   max_iters=MAX_ITERS, device="cpu")
    np.testing.assert_array_equal(res_np.params, res.params)


def test_ladder_options(panels):
    _, yj, yt = panels
    fit = tfi.failing_fit(tarima.fit, yt, [10, 11, 12], n_failures=99)
    kw = dict(order=(1, 1, 1), max_iters=MAX_ITERS, device="cpu")
    res = trunner.resilient_fit(fit, yt, ladder=(), **kw)
    assert res.meta["ladder"] == []
    assert (res.status[[10, 11, 12]] == FitStatus.DIVERGED).all()
    fit = tfi.failing_fit(tarima.fit, yt, [10, 11, 12], n_failures=99)
    res = trunner.resilient_fit(fit, yt, max_retry_rows=2, **kw)
    assert res.meta["retry_rows_over_cap"] == 2  # explosive row too
    assert res.meta["ladder"][0]["attempted"] == 2
    res = trunner.resilient_fit(tarima.fit, yt, sanitize=False, **kw)
    assert res.meta["sanitize"] == {"policy": "off"}
    # the model itself refuses the all-NaN row (retry cannot help)
    assert (res.status[ALLNAN_ROWS] == FitStatus.EXCLUDED).all()
    one = trunner.resilient_fit(tarima.fit, yt[20], **kw)
    assert one.params.shape == (3,) and one.status == FitStatus.OK
    # the reference's ladder with the port's fallback backend
    got = trunner.default_ladder(tarima.fit, 50)
    want = jrunner.default_ladder(jarima.fit, 50)
    assert [(r.name, r.status, r.perturb) for r in got] == [
        (r.name, r.status, r.perturb) for r in want]
    assert got[0].kwargs == want[0].kwargs
    assert got[1].kwargs == dict(want[1].kwargs, backend="auto")


def test_align_hint_downgrades_after_repairs(panels):
    y, _, yt = panels
    seen = []

    def fit(yb, align_mode=None, **kw):
        seen.append(align_mode)
        return tarima.fit(yb, align_mode=align_mode, **kw)

    kw = dict(order=(1, 1, 1), max_iters=10, device="cpu", ladder=())
    trunner.resilient_fit(fit, torch.as_tensor(y[:8]), align_mode="dense",
                          **kw)
    trunner.resilient_fit(fit, yt[:8], align_mode="dense", **kw)
    assert seen == ["dense", "general"]


def test_errors_propagate_and_dump(tmp_path):
    obs.enable(str(tmp_path / "run.jsonl"))

    def broken(yb, **kw):
        raise RuntimeError("kernel launch failed")

    y = torch.as_tensor(_arma_panel(4, 50))
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        trunner.resilient_fit(broken, y)
    dump = obs.last_crash_dump()
    assert dump is not None
    oom = tfi.oom_fit(tarima.fit, max_rows=2)
    with pytest.raises(tfi.SimulatedResourceExhausted):
        trunner.resilient_fit(oom, y, order=(1, 1, 1), device="cpu")
    assert obs.last_crash_dump() == dump  # recoverable one layer up


# -- the watchdog --------------------------------------------------------------


def test_deadline_watchdog_times_out_a_hanging_fit(panels, tmp_path):
    y, _, _ = panels
    obs.enable(str(tmp_path / "run.jsonl"))
    seen = {}

    def probe(yb, **kw):
        seen["lane"] = twd.current_lane()
        seen["request"] = twd.current_request()
        seen["trace"] = obs.current_trace()
        seen["thread"] = threading.current_thread().name
        return tarima.fit(yb, (1, 1, 0), max_iters=5, device="cpu")

    fit = tfi.hanging_fit(probe, hang_calls=[0], sleep_s=1.0)
    yb = torch.as_tensor(y[:4])
    ctx = obs.trace_for_request("req-9", "server")
    t0 = time.perf_counter()
    with twd.lane_context(3), twd.request_context(("tenant-a",)), \
            obs.trace_scope(ctx):
        with pytest.raises(twd.DeadlineExceeded) as ei:
            twd.call_with_deadline(lambda: fit(yb), 0.2, label="chunk 0")
        assert time.perf_counter() - t0 < 0.9
        assert ei.value.budget_s == 0.2 and ei.value.label == "chunk 0"
        res = twd.call_with_deadline(lambda: fit(yb), 30.0, label="chunk 1")
    # the abandoned worker runs its fit to the end; wait for it so no
    # thread outlives the test
    for t in threading.enumerate():
        if t.name == "watchdog:chunk 0":
            t.join(timeout=60)
    assert res.params.shape == (4, 2)
    assert seen["lane"] == 3 and seen["request"] == ("tenant-a",)
    assert seen["trace"] == ctx and seen["thread"].startswith("watchdog:")
    snap = obs.snapshot()["counters"]
    assert snap["watchdog.deadline_exceeded"] == 1
    # inline without a budget, the lane tag kept
    with twd.lane_context(5):
        assert twd.call_with_deadline(twd.current_lane) == 5
        assert twd.call_with_deadline(twd.current_lane, lane=7) == 7
    # an error inside the budget comes back unchanged
    with pytest.raises(ZeroDivisionError):
        twd.call_with_deadline(lambda: 1 / 0, 5.0)


def test_deadline_budget_semantics():
    for mod in (twd, jwd):
        d = mod.Deadline(None)
        assert d.remaining() is None and not d.exceeded()
        d = mod.Deadline(0.05)
        assert 0 < d.remaining() <= 0.05 and not d.exceeded()
        time.sleep(0.06)
        assert d.exceeded() and d.elapsed() >= 0.05
    assert str(twd.DeadlineExceeded("x", 1.5)) == str(
        jwd.DeadlineExceeded("x", 1.5))
    assert twd.current_lane() is None and twd.current_request() is None
