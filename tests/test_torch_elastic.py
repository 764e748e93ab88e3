"""The port's elastic lanes (``reliability.plan.LaneSupervisor`` over a
``WorkQueue``; single-process sharded walks) against the reference's
(``tests/test_elastic.py``).

The reference runs under ``tests/conftest.py``'s forced 8-device CPU mesh,
the port on a mesh listing ``torch.device("cpu")`` eight times.  Against the
reference, with a stand-in fit of exact float32 arithmetic: the elastic
record of each fault (``lane_kill`` permanent and transient, at the first
chunk and later, ``lane_oom_storm``, a fit that kills every lane) — who was
quarantined, after how many retries, over which span — and the merged
manifest's owner tags and ``rebalance`` block, bit for bit.  The port's own
bitwise contract on every fault, with the stand-in and with ARIMA: the
degraded walk equals the single-lane walk, a straggler's stolen chunks
included, and a crashed degraded walk resumes to the same bits.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from spark_timeseries_tpu import reliability as jrel
from spark_timeseries_tpu.reliability import faultinject as jfi
from spark_timeseries_tpu_torch import obs
from spark_timeseries_tpu_torch import reliability as rel
from spark_timeseries_tpu_torch.models import arima
from spark_timeseries_tpu_torch.parallel import mesh as meshlib
from spark_timeseries_tpu_torch.reliability import faultinject as fi
from spark_timeseries_tpu_torch.reliability import plan as plan_mod
from spark_timeseries_tpu_torch.reliability import watchdog as watchdog_mod
from test_torch_chunked import _assert_bitwise, _jfake, _tfake

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
MESH = meshlib.default_mesh(devices=[CPU] * 8)


def _panel(b=64, t=8, seed=7):
    return np.random.default_rng(seed).normal(size=(b, t)).astype(np.float32)


def _fit(y, d=None, fit_fn=_tfake, **kw):
    kw.setdefault("chunk_rows", 2)
    kw.setdefault("resilient", False)
    kw.setdefault("lane_retry_backoff_s", 0.01)
    return rel.fit_chunked(fit_fn, torch.as_tensor(y), checkpoint_dir=d,
                           device="cpu", **kw)


def _ref(y, d=None, fit_fn=_jfake, **kw):
    kw.setdefault("chunk_rows", 2)
    kw.setdefault("resilient", False)
    kw.setdefault("lane_retry_backoff_s", 0.01)
    return jrel.fit_chunked(fit_fn, y, checkpoint_dir=d, shard=True, **kw)


def _manifest(d):
    return json.load(open(os.path.join(d, "manifest.json")))


# -- quarantine against the reference ----------------------------------------


FAULTS = {
    "kill_after_1": (lambda m, f: m.lane_kill(f, 3, after_chunks=1), {}),
    "kill_first": (lambda m, f: m.lane_kill(f, 0, after_chunks=0),
                   {"lane_retries": 0}),
    "transient": (lambda m, f: m.lane_kill(f, 4, after_chunks=0,
                                           n_failures=1),
                  {"lane_retries": 1}),
    "oom_storm": (lambda m, f: m.lane_oom_storm(f, 1),
                  {"min_chunk_rows": 1}),
    "kill_unjournaled": (lambda m, f: m.lane_kill(f, 7, after_chunks=0), {}),
}


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_quarantine_record_matches_reference(name, tmp_path):
    wrap, kw = FAULTS[name]
    y = _panel(b=32)
    single = _fit(y)
    journaled = name != "kill_unjournaled"
    pd = str(tmp_path / "p") if journaled else None
    rd = str(tmp_path / "r") if journaled else None
    got = _fit(y, pd, fit_fn=wrap(fi, _tfake), mesh=MESH, **kw)
    want = _ref(y, rd, fit_fn=wrap(jfi, _jfake), **kw)
    _assert_bitwise(got, single)
    _assert_bitwise(got, want)
    ge, we = got.meta["shards"]["elastic"], want.meta["shards"]["elastic"]
    assert ([(q["shard_id"], q["retries"], q["span"])
             for q in ge["quarantined"]]
            == [(q["shard_id"], q["retries"], q["span"])
                for q in we["quarantined"]])
    assert [q["cause"].split(":")[0] for q in ge["quarantined"]] == \
        [q["cause"].split(":")[0] for q in we["quarantined"]]
    for k in ("lane_retries_used", "reassigned_spans"):
        assert ge[k] == we[k], k
    if journaled:
        pm, rm = _manifest(pd), _manifest(rd)
        assert pm["rebalance"]["reassigned_chunks"] == \
            rm["rebalance"]["reassigned_chunks"]
        assert ([c["lo"] for c in pm["chunks"]]
                == [c["lo"] for c in rm["chunks"]])
        assert all(c.get("owner") == c["shard_id"] for c in pm["chunks"])


def test_all_lanes_lost_surfaces_original_error():
    def bad_fit(yb, **kw):
        raise ValueError("deterministic fit bug: every lane dies")

    with pytest.raises(ValueError, match="deterministic fit bug"):
        _fit(_panel(b=32), fit_fn=bad_fit, mesh=MESH, lane_retries=0)


def test_supervisor_level_error_fails_loudly(monkeypatch):
    def boom(self, *a, **k):
        raise RuntimeError("lane runner construction failed")

    monkeypatch.setattr(plan_mod.LaneRunner, "__init__", boom)
    with pytest.raises(RuntimeError, match="construction failed"):
        _fit(_panel(b=32), mesh=MESH)


def test_healthy_run_is_static_layout_as_in_reference(tmp_path):
    y = _panel(b=32)
    got = _fit(y, str(tmp_path / "p"), mesh=MESH)
    want = _ref(y, str(tmp_path / "r"))
    assert got.meta["shards"]["elastic"] == want.meta["shards"]["elastic"] \
        == {"quarantined": [], "steals": 0, "lane_retries_used": 0,
            "reassigned_spans": 0}
    pm = _manifest(tmp_path / "p")
    assert pm["rebalance"] == {**_manifest(tmp_path / "r")["rebalance"]}
    assert all(s["owner"] == s["shard_id"] and s["chunks_reassigned_in"] == 0
               for s in pm["shards"])


def test_timeout_entries_carry_owner_tag(tmp_path):
    d = str(tmp_path / "j")
    res = _fit(_panel(b=32), d, mesh=MESH, job_budget_s=0.0)
    assert res.meta["status_counts"]["TIMEOUT"] == 32
    m = _manifest(d)
    assert all(c["status"] == "TIMEOUT" and c.get("owner") == c["shard_id"]
               for c in m["chunks"])
    assert all(s["chunks_timeout"] == 2 for s in m["shards"])


# -- rebalance ----------------------------------------------------------------


def test_straggler_steal_bitwise():
    y = _panel(b=64)  # 4 chunks a lane: room to steal
    single = _fit(y)
    slow = _fit(y, fit_fn=fi.slow_lane(_tfake, 5, 0.3), mesh=MESH,
                rebalance_threshold=2.0)
    _assert_bitwise(slow, single)
    el = slow.meta["shards"]["elastic"]
    assert el["steals"] >= 1 and el["quarantined"] == []


def test_work_queue_preference_is_strict():
    q = plan_mod.WorkQueue()
    q.push(0, 8, preferred=0)
    q.push(8, 16, preferred=1)
    q.push(16, 24, preferred=None)
    assert q._pull_locked(1) == (8, 16)
    assert q._pull_locked(1) == (16, 24)
    assert q._pull_locked(1) is None
    assert q.pending() == [(0, 8)]
    q._release_preference_locked(0)
    assert q._pull_locked(1) == (0, 8)
    assert q.pending() == []


def _runner():
    plan = plan_mod.ExecutionPlan(
        n_rows=32, chunk_rows=4, min_chunk_rows=1, max_backoffs=8,
        resilient=False, policy="impute", ladder=None, checkpoint_dir=None,
        resume="auto", chunk_budget_s=None, job_budget_s=None,
        pipeline=False, pipeline_depth=2, prefetch_depth=0, align_mode=None,
        lanes=(plan_mod.LaneSpec(0, 0, 32),), process_index=0, n_shards=2,
        elastic=True)
    return plan_mod.LaneRunner(plan, plan.lanes[0], _tfake, {},
                               torch.as_tensor(_panel(b=32)))


def test_try_steal_grid_aligned_and_closed():
    r = _runner()
    assert r.try_steal() == (16, 32) and r.hi == 16
    assert r.try_steal() == (8, 16)
    assert r.try_steal() == (4, 8)
    assert r.try_steal() is None
    r2 = _runner()
    assert r2.try_steal() == (16, 32)
    assert r2.close_steals() == 16
    assert r2.try_steal() is None


def test_lane_faults_only_fire_on_their_lane():
    calls = {"n": 0}

    def fit(yb, **kw):
        calls["n"] += 1
        return _tfake(yb)

    y = torch.as_tensor(_panel(b=4))
    wrapped = fi.lane_kill(fit, 3, after_chunks=0)
    wrapped(y)
    with watchdog_mod.lane_context(2):
        wrapped(y)
    with watchdog_mod.lane_context(3):
        with pytest.raises(fi.SimulatedLaneFailure):
            wrapped(y)
    assert calls["n"] == 2
    storm = fi.lane_oom_storm(fit, 1)
    with watchdog_mod.lane_context(1):
        with pytest.raises(fi.SimulatedResourceExhausted):
            storm(y)
    assert rel.is_resource_exhausted(fi.SimulatedResourceExhausted(4))


# -- durability ---------------------------------------------------------------


def test_quarantine_composes_with_crash_resume(tmp_path):
    y = _panel(b=64)
    single = _fit(y)
    d = str(tmp_path / "j")
    with pytest.raises(fi.SimulatedCrash):
        _fit(y, d, fit_fn=fi.lane_kill(_tfake, 2, after_chunks=0), mesh=MESH,
             _journal_commit_hook=fi.crash_after_commits(6))
    committed = sum(
        sum(1 for c in json.load(open(mp))["chunks"]
            if c["status"] == "committed")
        for mp in glob.glob(os.path.join(d, "shard_*",
                                         "manifest.shard_*.json")))
    assert committed >= 6
    res = _fit(y, d, mesh=MESH)
    _assert_bitwise(res, single)
    assert res.meta["shards"]["elastic"]["quarantined"] == []
    assert res.meta["journal"]["chunks_resumed"] >= committed
    assert res.meta["journal"]["chunks_committed"] == 32


def test_completed_degraded_job_resumes_all_from_journal(tmp_path):
    y = _panel(b=32)
    single = _fit(y)
    d = str(tmp_path / "j")
    first = _fit(y, d, fit_fn=fi.lane_kill(_tfake, 2, after_chunks=0),
                 mesh=MESH)
    _assert_bitwise(first, single)
    again = _fit(y, d, mesh=MESH)
    _assert_bitwise(again, single)
    assert again.meta["shards"]["elastic"]["quarantined"] == []
    assert again.meta["journal"]["chunks_resumed"] == 16


def test_steal_composes_with_crash_resume(tmp_path):
    y = _panel(b=64)
    single = _fit(y)
    d = str(tmp_path / "j")
    with pytest.raises(fi.SimulatedCrash):
        _fit(y, d, fit_fn=fi.slow_lane(_tfake, 5, 0.2), mesh=MESH,
             rebalance_threshold=2.0,
             _journal_commit_hook=fi.crash_after_commits(10))
    res = _fit(y, d, mesh=MESH)
    _assert_bitwise(res, single)
    assert res.meta["journal"]["chunks_committed"] == 32


def test_degraded_manifest_validates_and_records_the_lane_lifecycle(
        tmp_path):
    y = _panel(b=32)
    d = str(tmp_path / "j")
    ev = str(tmp_path / "ev.jsonl")
    obs.enable(ev)
    try:
        c0 = (obs.snapshot() or {}).get("counters", {})
        res = _fit(y, d, fit_fn=fi.lane_kill(_tfake, 1, after_chunks=1),
                   mesh=MESH)
        snap = obs.snapshot()
    finally:
        obs.disable()
    assert res.meta["shards"]["elastic"]["quarantined"]
    counters, gauges = snap["counters"], snap["gauges"]
    assert counters.get("lane.quarantine", 0) - c0.get(
        "lane.quarantine", 0) == 1
    assert counters.get("lane.retry", 0) - c0.get("lane.retry", 0) == 1
    assert gauges.get("lane.state.1") == "quarantined"
    assert gauges.get("lane.state.0") == "done"
    m = _manifest(d)
    assert m["rebalance"]["reassigned_chunks"] >= 1
    # the reference's schema gate accepts the port's degraded manifest
    r = subprocess.run(
        [sys.executable, os.path.join(_ROOT, "tools", "obs_report.py"),
         "--check", ev, "--manifest", d],
        capture_output=True, text=True, cwd=_ROOT, timeout=120)
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr}"
    from spark_timeseries_tpu_torch.serving import _advise

    a = _advise.advise(_advise.load_manifest(d))
    assert "lane_retries" in a["suggest"]
    assert "rebalance_threshold" in a["suggest"]


# -- real fits ---------------------------------------------------------------


def test_arima_elastic_bitwise_under_every_lane_fault():
    y = _panel(b=16, t=60)
    kw = dict(chunk_rows=2, order=(1, 0, 0), max_iters=15)
    mesh = meshlib.default_mesh(devices=[CPU] * 4)
    single = _fit(y, fit_fn=arima.fit, **kw)
    for wrap in (lambda f: fi.lane_kill(f, 1, after_chunks=1),
                 lambda f: fi.lane_oom_storm(f, 2),
                 lambda f: fi.slow_lane(f, 3, 0.3)):
        got = _fit(y, fit_fn=wrap(arima.fit), mesh=mesh, min_chunk_rows=1,
                   rebalance_threshold=2.0, **kw)
        _assert_bitwise(got, single)


def test_resilient_elastic_quarantine():
    y = _panel(b=16, t=60)
    mesh = meshlib.default_mesh(devices=[CPU] * 4)
    kw = dict(chunk_rows=4, resilient=True, order=(1, 0, 0), max_iters=15)
    single = _fit(y, fit_fn=arima.fit, **kw)
    killed = _fit(y, fit_fn=fi.lane_kill(arima.fit, 3, after_chunks=0),
                  mesh=mesh, **kw)
    _assert_bitwise(killed, single)
    assert killed.meta["shards"]["elastic"]["quarantined"]
