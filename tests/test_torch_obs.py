"""The port's telemetry plane (``obs``) and kernel-library cache accounting
(``utils.compile_cache``) against the reference's.

- trace and span ids are the reference's bit for bit (they are derived, not
  propagated, in every process that handles a request);
- the same calls leave the same counters, gauges, histogram counts and
  JSONL line shapes in both planes;
- a port stream passes ``tools/obs_report.py --check`` (run as a
  subprocess) and a port Prometheus textfile passes the reference's
  ``validate_textfile``;
- the counters the reference emits from modules already ported
  (``align.host_probes``, ``auto_fit.diff_cache_hits``,
  ``optim.stage2_compact_traces``) are emitted by the port too.

Both planes are process-global, so every test that enables one does so in
its own ``tmp_path`` and the autouse fixture disables both afterwards.
"""

import importlib
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu import obs as ref_obs
from spark_timeseries_tpu.models import arima as jarima
from spark_timeseries_tpu.obs import promsink as ref_promsink
from spark_timeseries_tpu.obs import tracing as ref_tracing
from spark_timeseries_tpu_torch import obs
from spark_timeseries_tpu_torch.models import arima as tarima
from spark_timeseries_tpu_torch.obs import promsink, tracing
from spark_timeseries_tpu_torch.ops import _build
from spark_timeseries_tpu_torch.utils import compile_cache, optim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _planes_off():
    obs.disable()
    ref_obs.disable()
    yield
    obs.disable()
    ref_obs.disable()


def _panel(b=16, t=150, seed=11):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(b, t)).astype(np.float32)
    y = np.zeros_like(e)
    y[:, 0] = e[:, 0]
    for i in range(1, t):
        y[:, i] = 0.5 * y[:, i - 1] + e[:, i] + 0.2 * e[:, i - 1]
    return np.cumsum(y, axis=1)


# -- tracing -----------------------------------------------------------------

REQUESTS = ["req-0", "req-1", "tenant-a/job-42", "", "ünïcode-✓", "x" * 300]
SITES = ["client", "server", "server.batch", "journal"]


@pytest.mark.parametrize("request_id", REQUESTS)
def test_trace_and_span_ids_are_the_references_bit_for_bit(request_id):
    tid = tracing.derive_trace_id(request_id)
    assert tid == ref_tracing.derive_trace_id(request_id)
    assert len(tid) == 16 and set(tid) <= set("0123456789abcdef")
    for site in SITES:
        assert (tracing.derive_span_id(tid, site)
                == ref_tracing.derive_span_id(tid, site))


def test_trace_contexts_match_with_both_planes_on(tmp_path):
    # off: no hashing, no context, in both
    assert tracing.trace_for_request("req-0") is None
    assert ref_tracing.trace_for_request("req-0") is None
    obs.enable(str(tmp_path / "port.jsonl"))
    ref_obs.enable(str(tmp_path / "ref.jsonl"))
    for rid in REQUESTS[:3]:
        for site in SITES:
            got = tracing.trace_for_request(rid, site, parent_id="ab" * 8)
            want = ref_tracing.trace_for_request(rid, site,
                                                 parent_id="ab" * 8)
            assert tuple(got) == tuple(want)
            assert got.to_dict() == want.to_dict()
            wire = tracing.trace_to_wire(got)
            assert wire == ref_tracing.trace_to_wire(want)
            assert (tuple(tracing.trace_from_wire({"trace": wire}))
                    == tuple(ref_tracing.trace_from_wire({"trace": wire})))
    assert tracing.trace_from_wire({"trace": "junk"}) is None
    assert tracing.trace_for_request("") is None


# -- the same calls, the same registry and lines ---------------------------


def _drive(o, tracing_mod):
    """One sequence of plane calls; returns the snapshot."""
    o.counter("ladder.retry.attempted").inc(3)
    o.counter("ladder.retry.attempted").add(2)
    o.gauge("memory.source").set("host_rss")
    o.gauge("chunk.rows").set(4096)
    o.gauge("queue.depth").max(3)
    o.gauge("queue.depth").max(1)
    o.histogram("commit.latency_s").observe(0.25)
    o.histogram("commit.latency_s").observe(0.75)
    with o.span("fit.primary", rows=8):
        with o.span("sanitize", rows=8, policy="impute"):
            pass
    ctx = tracing_mod.trace_for_request("req-7", "server")
    with tracing_mod.trace_scope(ctx):
        o.event("watchdog.timeout", label="chunk", budget_s=1.5)
        with o.span("fit.rung.retry", rows=2, cap=8):
            pass
    o.event("plain.event")
    assert o.first_dispatch(("fit", 8)) and not o.first_dispatch(("fit", 8))
    o.emit_metrics()
    return o.snapshot()


def _lines(path):
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def _shape(ev):
    """A line without its times and run id: kind, names, keys, attrs."""
    drop = {"ts", "t0", "wall_s", "process_s", "run_id", "pid"}
    out = {k: v for k, v in ev.items() if k not in drop}
    if ev.get("kind") == "metrics":
        out["histograms"] = {k: v.get("count")
                             for k, v in ev["histograms"].items()}
    return out


def test_same_calls_leave_the_same_registry_and_line_shapes(tmp_path):
    pp, rp = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    obs.enable(str(pp))
    ref_obs.enable(str(rp))
    got = _drive(obs, tracing)
    want = _drive(ref_obs, ref_tracing)
    assert got["counters"] == want["counters"]
    assert got["gauges"] == want["gauges"]
    assert ({k: v["count"] for k, v in got["histograms"].items()}
            == {k: v["count"] for k, v in want["histograms"].items()})
    assert (got["histograms"]["commit.latency_s"]
            == want["histograms"]["commit.latency_s"])
    obs.disable()
    ref_obs.disable()
    gl, rl = _lines(pp), _lines(rp)
    assert [_shape(e) for e in gl] == [_shape(e) for e in rl]
    assert gl[0]["schema"] == ref_obs.SCHEMA_VERSION == obs.SCHEMA_VERSION


def test_summary_and_disabled_path(tmp_path):
    assert obs.span("a") is obs.span("b") is obs.NULL_SPAN
    assert obs.counter("a") is obs.gauge("b") is obs.histogram("c")
    assert obs.snapshot() is None and obs.summary() is None
    assert obs.stream_path() is None
    obs.enable(str(tmp_path / "run.jsonl"))
    base = obs.snapshot()["counters"]
    obs.counter("x").inc(5)
    s = obs.summary(counters_since=base, rows=3)
    assert s["counters"] == {"x": 5} and s["rows"] == 3
    # no CUDA initialized in this process: the labelled host fallback
    assert s["peak_memory"]["source"] == "host_rss"
    assert s["peak_memory"]["bytes"] > 0
    assert obs.stream_path() == str(tmp_path / "run.jsonl")


def test_peak_memory_labels_its_source():
    pm = obs.peak_memory()
    assert not torch.cuda.is_available()
    assert pm.source == "host_rss" and pm.bytes > 0
    assert pm.source == ref_obs.peak_memory().source


def test_port_stream_passes_obs_report_check(tmp_path):
    ev, prom = tmp_path / "events.jsonl", tmp_path / "metrics.prom"
    obs.enable(str(ev))
    _drive(obs, tracing)
    obs.summary()  # memory gauges, as a fit's telemetry block records
    sink = obs.PromTextfileSink(str(prom))
    sink.write()
    assert promsink.validate_textfile(str(prom), obs.snapshot()) == []
    obs.disable()
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "obs_report.py"),
         str(ev), "--check"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "events valid" in out.stdout
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "obs_report.py"),
         str(ev), "--check", "--prom", str(prom)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_reference_validator_accepts_the_port_textfile(tmp_path):
    obs.enable()
    _drive(obs, tracing)
    obs.summary()
    snap = obs.snapshot()
    path = obs.PromTextfileSink(str(tmp_path / "m.prom")).write(
        extra={"server.queue_rows": 7.0})
    assert ref_promsink.validate_textfile(path, snapshot=snap) == []
    text = open(path, encoding="utf-8").read()
    assert text == ref_promsink.render_textfile(
        snap, {"server.queue_rows": 7.0, "sink_writes_total": 1.0})
    assert promsink.prom_name("a.b-c") == ref_promsink.prom_name("a.b-c")
    # a dropped metric fails the gate in both validators
    snap["counters"]["renamed.counter"] = 1
    assert promsink.validate_textfile(path, snap)
    assert ref_promsink.validate_textfile(path, snapshot=snap)


def test_profile_mode_mirrors_spans_into_torch_profiler():
    from torch.profiler import ProfilerActivity, profile

    obs.enable(profile=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("sanitize"):
            with obs.span("fit.primary"):
                torch.ones(4).sum()
    names = {e.key for e in prof.key_averages()}
    assert {"sanitize", "fit.primary"} <= names


def test_failure_dump_and_unless(tmp_path):
    obs.enable(str(tmp_path / "run.jsonl"))

    @obs.dump_on_failure("unit", unless=lambda e: isinstance(e, KeyError))
    def boom(kind):
        with obs.span("inner"):
            raise kind("bad")

    with pytest.raises(ValueError):
        boom(ValueError)
    dump = obs.last_crash_dump()
    assert dump and os.path.dirname(dump) == str(tmp_path)
    lines = _lines(dump)
    assert any(e.get("name") == "fit.failure" for e in lines)
    assert lines[-1]["kind"] == "metrics"
    with pytest.raises(KeyError):
        boom(KeyError)
    assert obs.last_crash_dump() == dump  # skipped: no second dump


def test_env_opt_in_matches_the_reference(tmp_path):
    code = ("import json, os; from spark_timeseries_tpu_torch import obs; "
            "print(json.dumps([obs.enabled(), obs.stream_path()]))")
    env = dict(os.environ, STSTPU_OBS="1",
               STSTPU_OBS_JSONL=str(tmp_path / "env.jsonl"),
               PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == [True, str(tmp_path / "env.jsonl")]


# -- counters the reference emits from ported modules ----------------------


def test_fit_and_grid_counters_match_the_reference(tmp_path):
    y = _panel()
    obs.enable(str(tmp_path / "port.jsonl"))
    ref_obs.enable(str(tmp_path / "ref.jsonl"))
    # numpy in: both packages probe each call's own panel once
    tarima.fit(y, (1, 1, 1), max_iters=20, device="cpu")
    jarima.fit(y, (1, 1, 1), max_iters=20)
    # a static configuration no other test compiles (the reference counts
    # its shared-prep savings when it builds the grid's program)
    specs = [((1, 1, 0), None), ((0, 1, 1), None), ((1, 1, 1), None),
             ((0, 1, 1), (0, 1, 1, 5)), ((1, 1, 0), (1, 1, 0, 5))]
    tarima.fit_grid(y, specs, max_iters=17, device="cpu")
    jarima.fit_grid(y, specs, max_iters=17)
    got, want = obs.snapshot()["counters"], ref_obs.snapshot()["counters"]
    for name in ("align.host_probes", "auto_fit.diff_cache_hits"):
        assert got[name] == want[name], name
    assert got["align.host_probes"] == 2
    assert got["auto_fit.diff_cache_hits"] == len(specs) - 2


def _quad_with_stragglers(bsz=16, slow=(3, 9)):
    """Batched objective: most rows a quadratic (a few iterations), the
    ``slow`` rows Rosenbrock (many); and its straggler builder."""
    scale = torch.ones(bsz, dtype=torch.float64)
    rosen = torch.zeros(bsz, dtype=torch.bool)
    rosen[list(slow)] = True

    def f(x, rs=rosen, sc=scale):
        quad = sc * (x ** 2).sum(-1)
        rb = (1 - x[:, 0]) ** 2 + 100 * (x[:, 1] - x[:, 0] ** 2) ** 2
        return torch.where(rs, rb, quad)

    def straggler(idxc):
        return lambda x: f(x, rosen[idxc], scale[idxc])

    x0 = torch.full((bsz, 2), -1.2, dtype=torch.float64)
    return f, straggler, x0


def test_stage2_counter_counts_each_compaction(tmp_path):
    obs.enable(str(tmp_path / "port.jsonl"))
    f, straggler, x0 = _quad_with_stragglers()
    res, info = optim.minimize_lbfgs_batched(
        f, x0, max_iters=200, count_evals=True, straggler_fun=straggler,
        straggler_cap=4)
    assert info["cap"] == 4 and info["compact_at"] < 200
    assert bool(res.converged.all())
    assert obs.snapshot()["counters"]["optim.stage2_compact_traces"] == 1
    optim.minimize_lbfgs_batched(f, x0, max_iters=200)  # no compaction
    optim.minimize_lbfgs_batched(f, x0, max_iters=200,
                                 straggler_fun=straggler, straggler_cap=4)
    assert obs.snapshot()["counters"]["optim.stage2_compact_traces"] == 2


# -- compile-cache accounting over the kernel libraries ---------------------


class _FakeProc:
    """Stands in for an nvcc process: writes the library it was asked for."""

    def __init__(self, tmp):
        self.tmp, self.returncode = tmp, None

    def communicate(self):
        self.tmp.write_bytes(b"lib")
        self.returncode = 0
        return "ptxas info: fake", None

    def poll(self):
        return self.returncode


class _FakeLib:
    def __getattr__(self, name):
        fn = type("Fn", (), {})()
        setattr(self, name, fn)
        return fn


def test_compile_cache_counts_builds_and_loads(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_counted", set())
    monkeypatch.setattr(compile_cache, "_enabled_dir", None)
    monkeypatch.setattr(_build, "_start", lambda n, d, out: (
        _FakeProc(out.with_suffix(".tmp")), out.with_suffix(".tmp"), out))
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: _FakeLib())
    cache = tmp_path / "kernels"
    assert compile_cache.enable_compile_cache(str(cache)) == str(cache)
    assert compile_cache.enabled_dir() == str(cache)
    assert _build.BUILD_DIR == cache
    obs.enable(str(tmp_path / "run.jsonl"))
    before = compile_cache.program_cache_stats()
    _build.load("ewma")  # not on disk: one nvcc, one miss
    _build.load("ewma")  # loaded: reused, not looked up
    assert _build.library_path("ewma").parent == cache
    assert _build.library_path("ewma").is_file()
    monkeypatch.setattr(_build, "_libs", {})
    _build.load("ewma")  # counted already in this process: nothing
    monkeypatch.setattr(_build, "_counted", set())  # a new process
    monkeypatch.setattr(_build, "_libs", {})
    _build.load("ewma")  # built on disk by an earlier run: a hit
    _build.load("ewma")
    logs = _build.build_all(("ewma", "hr"))  # hr built, ewma up to date
    assert list(logs) == [_build.library_path("hr").name]
    _build.load("hr")  # built by this process: its miss counted
    after = compile_cache.program_cache_stats()
    assert (after["misses"] - before["misses"],
            after["hits"] - before["hits"]) == (2, 1)
    assert obs.snapshot()["counters"] == {"compile_cache.miss": 2,
                                          "compile_cache.hit": 1}
    assert set(after) == {"hits", "misses", "hit_rate", "build_s"}


def test_compile_cache_env_opt_in(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(compile_cache, "_enabled_dir", None)
    monkeypatch.delenv("STSTPU_COMPILE_CACHE", raising=False)
    assert compile_cache.enable_from_env() is None
    monkeypatch.setenv("STSTPU_COMPILE_CACHE", str(tmp_path / "cc"))
    assert compile_cache.enable_from_env() == str(tmp_path / "cc")
    assert _build.BUILD_DIR == tmp_path / "cc"


@pytest.mark.parametrize("name", ["core", "metrics", "recorder", "tracing",
                                  "memory", "promsink"])
def test_module_exports_match_the_reference(name):
    port = importlib.import_module(f"spark_timeseries_tpu_torch.obs.{name}")
    ref = importlib.import_module(f"spark_timeseries_tpu.obs.{name}")
    assert sorted(port.__all__) == sorted(ref.__all__)


def test_package_exports_match_the_reference():
    assert sorted(obs.__all__) == sorted(ref_obs.__all__)
    assert sorted(compile_cache.__all__) == sorted(
        importlib.import_module(
            "spark_timeseries_tpu.utils.compile_cache").__all__
        + ["enabled_dir"])
