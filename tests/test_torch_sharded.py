"""The port's sharded chunk walk (``fit_chunked(mesh=... | shard=True)``)
against the reference's (``tests/test_sharded.py``).

The reference runs under ``tests/conftest.py``'s forced 8-device CPU mesh;
the port on a ``parallel.mesh`` mesh that lists ``torch.device("cpu")``
eight times (virtual shards of one device, the analog a card's lanes
share).  Against the reference, on the same numpy panels: the chunk-grid
partition (``shard_spans``), an ARIMA(1,0,0) sharded walk (status exact,
parameters within the ARIMA parity bar 4e-3), and — with a stand-in fit of
exact float32 arithmetic — the merged job manifest (chunk entries, shard
tags, ``shards`` block, ``merged_from_shards``) and the shard-tagged
backoff events.  The port's own contracts, bit for bit: sharded ==
single-lane on every knob surface, crash-and-resume == uninterrupted, and
a merged manifest adopted by a later single-lane walk.
"""

import glob
import gc
import json
import os

import numpy as np
import pytest
import torch

from spark_timeseries_tpu import reliability as jrel
from spark_timeseries_tpu.models import arima as jarima
from spark_timeseries_tpu.reliability import faultinject as jfi
from spark_timeseries_tpu.reliability import plan as jplan
from spark_timeseries_tpu_torch import obs
from spark_timeseries_tpu_torch import reliability as rel
from spark_timeseries_tpu_torch.models import arima, ewma
from spark_timeseries_tpu_torch.parallel import mesh as meshlib
from spark_timeseries_tpu_torch.reliability import faultinject as fi
from spark_timeseries_tpu_torch.reliability import plan as plan_mod
from test_torch_chunked import _assert_bitwise, _jfake, _tfake

PARAM_TOL = 4e-3  # tests/test_torch_chunked.py's ARIMA parity bar
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _no_pool_outlives_its_test():
    """A staging pool registers with the process-wide peak-memory probe
    while it lives; one left in cyclic garbage would show in the next
    test's journal entries (``peak_staging_pool_bytes``)."""
    yield
    gc.collect()


def _mesh(n=8):
    return meshlib.default_mesh(devices=[CPU] * n)


def _ar_panel(b=48, t=96, seed=7, phi=0.6):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(b, t)).astype(np.float32)
    y = np.zeros_like(e)
    y[:, 0] = e[:, 0]
    for i in range(1, t):
        y[:, i] = phi * y[:, i - 1] + e[:, i]
    return y


def _walk(fit, y, **kw):
    kw.setdefault("resilient", False)
    return rel.fit_chunked(fit, torch.as_tensor(y), device="cpu", **kw)


def _manifest(d):
    return json.load(open(os.path.join(d, "manifest.json")))


# -- the chunk-grid partition ------------------------------------------------


@pytest.mark.parametrize("b,c,s", [(64, 8, 8), (80, 8, 4), (52, 8, 4),
                                   (16, 8, 8), (100, 8, 1), (100, 7, 5),
                                   (33, 4, 8), (8, 8, 8), (9, 2, 3)])
def test_shard_spans_match_reference(b, c, s):
    got = list(plan_mod.shard_spans(b, c, s))
    assert got == [tuple(sp) for sp in jplan.shard_spans(b, c, s)]
    assert got[0][0] == 0 and got[-1][1] == b
    assert all(lo % c == 0 for lo, _ in got)


# -- against the reference -------------------------------------------------


def test_arima_sharded_walk_matches_reference(lane_mesh):
    y = _ar_panel(b=32, t=80)
    y[3, 10:14] = np.nan  # the ladder path, per lane
    kw = dict(chunk_rows=4, order=(1, 0, 0), max_iters=20)
    port = _walk(arima.fit, y, mesh=_mesh(), resilient=True, **kw)
    ref = jrel.fit_chunked(jarima.fit, y, shard=True, resilient=True, **kw)
    np.testing.assert_array_equal(port.status, np.asarray(ref.status))
    np.testing.assert_array_equal(port.converged, np.asarray(ref.converged))
    np.testing.assert_allclose(port.params, np.asarray(ref.params),
                               rtol=PARAM_TOL, atol=PARAM_TOL)
    for k in ("n_shards", "spans", "lanes_run"):
        assert port.meta["shards"][k] == ref.meta["shards"][k], k
    assert port.meta["align_mode"] == ref.meta["align_mode"]


def _tele_free(m):
    return {k: v for k, v in m.items()
            if k not in ("run_id", "created_at", "updated_at", "git_commit",
                         "config_hash", "panel_fingerprint", "telemetry",
                         "extra", "chunks", "shards")}


def test_merged_manifest_matches_reference(lane_mesh, tmp_path):
    y = _ar_panel(b=32, t=8)
    port = _walk(_tfake, y, mesh=_mesh(), chunk_rows=4,
                 checkpoint_dir=str(tmp_path / "p"))
    ref = jrel.fit_chunked(_jfake, y, shard=True, chunk_rows=4,
                           resilient=False,
                           checkpoint_dir=str(tmp_path / "r"))
    _assert_bitwise(port, ref)
    pm, rm = _manifest(tmp_path / "p"), _manifest(tmp_path / "r")
    assert _tele_free(pm) == _tele_free(rm)
    drop = ("run_id", "committed_at", "wall_s", "peak_hbm_bytes",
            "peak_hbm_source", "chunk_fingerprint")
    assert ([{k: v for k, v in c.items() if k not in drop}
             for c in pm["chunks"]]
            == [{k: v for k, v in c.items() if k not in drop}
                for c in rm["chunks"]])
    assert ([{k: v for k, v in s.items() if k != "run_id"}
             for s in pm["shards"]]
            == [{k: v for k, v in s.items() if k != "run_id"}
                for s in rm["shards"]])
    for c in pm["chunks"]:
        assert c["shard_id"] == c["lo"] // 4
        assert os.path.exists(os.path.join(tmp_path / "p", c["shard"]))
    # ONE root manifest; the lanes journal under shard namespaces
    roots = glob.glob(os.path.join(tmp_path / "p", "**", "manifest.json"),
                      recursive=True)
    assert roots == [os.path.join(tmp_path / "p", "manifest.json")]
    j = port.meta["journal"]
    assert j["merged_shards"] == 8 and j["chunks_committed"] == 8
    for k in ("merged_shards", "chunks_committed", "chunks_timeout",
              "chunks_resumed"):
        assert j[k] == ref.meta["journal"][k], k


def test_oom_backoff_is_per_lane_as_in_reference(lane_mesh):
    y = _ar_panel(b=32, t=8)
    kw = dict(chunk_rows=4, min_chunk_rows=1)
    single = _walk(fi.oom_fit(_tfake, 3), y, **kw)
    port = _walk(fi.oom_fit(_tfake, 3), y, mesh=_mesh(), **kw)
    ref = jrel.fit_chunked(jfi.oom_fit(_jfake, 3), y, shard=True,
                           resilient=False, **kw)
    _assert_bitwise(port, single)
    _assert_bitwise(port, ref)
    assert port.meta["oom_backoffs"] == ref.meta["oom_backoffs"] == 8
    assert (sorted(e["shard"] for e in port.meta["oom_events"])
            == sorted(e["shard"] for e in ref.meta["oom_events"]))


# -- sharded == single-lane, bit for bit ------------------------------------


@pytest.mark.parametrize("b,chunk,n", [(48, 6, 8), (52, 8, 8), (32, 4, 4),
                                       (64, None, 8)])
def test_sharded_matches_single_lane(b, chunk, n):
    y = _ar_panel(b=b, t=40)
    single = _walk(ewma.fit, y, chunk_rows=chunk or b // n)
    shard = _walk(ewma.fit, y, chunk_rows=chunk, mesh=_mesh(n))
    _assert_bitwise(shard, single)
    sh = shard.meta["shards"]
    assert sh["n_shards"] == len(plan_mod.shard_spans(
        b, chunk or b // n, n))
    assert sh["lanes_run"] == sh["n_shards"]
    assert "shards" not in single.meta


def test_resilient_sharded_matches_single_lane():
    y = _ar_panel(b=16, t=60)
    y[3, 10:14] = np.nan
    kw = dict(chunk_rows=4, resilient=True, order=(1, 0, 0), max_iters=15)
    _assert_bitwise(_walk(arima.fit, y, mesh=_mesh(4), **kw),
                    _walk(arima.fit, y, **kw))


def test_lane_values_are_row_views_on_the_panel_device():
    y = torch.as_tensor(_ar_panel(b=16, t=8))
    lanes = meshlib.lane_values(y, _mesh(4), plan_mod.shard_spans(16, 4, 4))
    for sid, lo, hi, dev, vals in lanes:
        assert vals.data_ptr() == y[lo:hi].data_ptr()  # a view, no copy
        assert dev == CPU and (lo, hi) == (4 * sid, 4 * sid + 4)
    rp = plan_mod.RestagedPanel(y, device=CPU, base=8)
    assert rp[slice(0, 4)].data_ptr() == y[8:12].data_ptr()
    np.testing.assert_array_equal(rp[slice(2, 4)].numpy(), y[10:12].numpy())


def test_source_backed_sharded_walk(tmp_path):
    y = _ar_panel(b=32, t=8)
    single = _walk(_tfake, y, chunk_rows=4)
    src = rel.HostChunkSource(y)
    got = rel.fit_chunked(_tfake, src, chunk_rows=4, resilient=False,
                          device="cpu", mesh=_mesh(4),
                          checkpoint_dir=str(tmp_path / "s"))
    _assert_bitwise(got, single)
    assert got.meta["source"]["kind"] == "host"
    assert _manifest(tmp_path / "s")["merged_from_shards"] == 4


def test_time_sharded_mesh_and_sink_rejected(tmp_path):
    y = _ar_panel(b=16, t=8)
    mesh2d = meshlib.default_mesh(devices=[CPU] * 8, time_shards=2)
    with pytest.raises(ValueError, match="1-D"):
        _walk(_tfake, y, chunk_rows=4, mesh=mesh2d)
    with pytest.raises(ValueError, match="sink="):
        _walk(_tfake, y, chunk_rows=4, mesh=_mesh(4),
              checkpoint_dir=str(tmp_path / "j"),
              sink=str(tmp_path / "out"))


def test_job_deadline_shared_across_lanes():
    res = _walk(_tfake, _ar_panel(b=32, t=8), chunk_rows=4, mesh=_mesh(),
                job_budget_s=0.0)
    assert res.meta["status_counts"]["TIMEOUT"] == 32
    assert all(e["scope"] == "job" for e in res.meta["timeout_events"])


def test_panel_fit_and_compat_take_the_mesh(tmp_path):
    from spark_timeseries_tpu_torch import index as pix
    from spark_timeseries_tpu_torch import panel as ppanel
    from spark_timeseries_tpu_torch.compat import sparkts

    y = _ar_panel(b=16, t=40)
    ix = pix.uniform("2022-01-03", y.shape[1], pix.DayFrequency(1))
    p = ppanel.TimeSeriesPanel(ix, [f"s{i}" for i in range(16)],
                               torch.as_tensor(y))
    single = p.fit("ewma", chunk_rows=2, resilient=False)
    shard = p.fit("ewma", chunk_rows=2, resilient=False, mesh=_mesh())
    _assert_bitwise(shard, single)
    plain = sparkts.EWMA.fit_model(torch.as_tensor(y), chunk_rows=2,
                                   checkpoint_dir=str(tmp_path / "a"))
    lanes = sparkts.EWMA.fit_model(torch.as_tensor(y), chunk_rows=2,
                                   checkpoint_dir=str(tmp_path / "b"),
                                   mesh=_mesh())
    np.testing.assert_array_equal(np.asarray(plain.params),
                                  np.asarray(lanes.params))
    assert _manifest(tmp_path / "b")["merged_from_shards"] == 8


# -- journaled sharded walks ------------------------------------------------


def test_crash_resume_replays_only_uncommitted(tmp_path):
    y = _ar_panel(b=64, t=8)
    full = _walk(_tfake, y, chunk_rows=4)
    d = str(tmp_path / "j")
    with pytest.raises(fi.SimulatedCrash):
        _walk(_tfake, y, chunk_rows=4, mesh=_mesh(), checkpoint_dir=d,
              _journal_commit_hook=fi.crash_after_commits(3))
    assert not os.path.exists(os.path.join(d, "manifest.json"))
    committed = sum(
        sum(1 for c in json.load(open(mp))["chunks"]
            if c["status"] == "committed")
        for mp in glob.glob(os.path.join(d, "shard_*", "manifest.*.json")))
    assert 3 <= committed < 16
    res = _walk(_tfake, y, chunk_rows=4, mesh=_mesh(), checkpoint_dir=d,
                pipeline=False, prefetch_depth=0)
    _assert_bitwise(res, full)
    assert res.meta["journal"]["chunks_resumed"] == committed
    assert res.meta["journal"]["chunks_committed"] == 16


def test_merged_manifest_adopted_by_single_lane_walk(tmp_path):
    y = _ar_panel(b=32, t=8)
    d = str(tmp_path / "j")
    sharded = _walk(_tfake, y, chunk_rows=4, mesh=_mesh(), checkpoint_dir=d)
    single = _walk(_tfake, y, chunk_rows=4, checkpoint_dir=d)
    _assert_bitwise(single, sharded)
    assert single.meta["journal"]["chunks_resumed"] == 8


def test_stale_layout_and_foreign_root_rejected(tmp_path):
    y = _ar_panel(b=32, t=8)
    d = str(tmp_path / "j")
    _walk(_tfake, y, chunk_rows=4, mesh=_mesh(), checkpoint_dir=d)
    with pytest.raises(rel.StaleJournalError, match="shard layout"):
        _walk(_tfake, y, chunk_rows=4, mesh=_mesh(4), checkpoint_dir=d)
    d2 = str(tmp_path / "k")
    _walk(_tfake, y, chunk_rows=4, checkpoint_dir=d2)
    with pytest.raises(rel.StaleJournalError, match="root manifest"):
        _walk(_tfake, _ar_panel(b=32, t=8, seed=9), chunk_rows=4,
              mesh=_mesh(), checkpoint_dir=d2)
    assert "merged_from_shards" not in _manifest(d2)


def test_sharded_telemetry_merged_timeline(tmp_path):
    y = _ar_panel(b=32, t=8)
    d = str(tmp_path / "j")
    off = _walk(_tfake, y, chunk_rows=4)
    obs.enable(str(tmp_path / "ev.jsonl"))
    try:
        on = _walk(_tfake, y, chunk_rows=4, mesh=_mesh(), checkpoint_dir=d)
    finally:
        obs.disable()
    _assert_bitwise(on, off)
    chunks = on.meta["telemetry"]["chunks"]
    assert [c["lo"] for c in chunks] == sorted(c["lo"] for c in chunks)
    assert sorted({c["shard"] for c in chunks}) == list(range(8))
    assert {c["phase"] for c in chunks} == {"compile+execute"}
    assert {c["shard"] for c in _manifest(d)["telemetry"]["chunks"]} == \
        set(range(8))
    pipe = on.meta["pipeline"]
    assert [s["shard"] for s in pipe["shards"]] == list(range(8))
    assert pipe["commits_background"] == 8


def test_merge_warmer_and_shard_view(tmp_path):
    y = _ar_panel(b=16, t=8)
    d = str(tmp_path / "j")
    _walk(_tfake, y, chunk_rows=4, mesh=_mesh(4), checkpoint_dir=d)
    warm = rel.MergeWarmer(d, 4, interval_s=0.01)
    cache = warm.stop()
    assert len(cache) == 4
    m = _manifest(d)
    acct = rel.merge_job_manifest(
        d, config_hash=m["config_hash"],
        panel_fingerprint=m["panel_fingerprint"], n_rows=16, chunk_rows=4,
        spans=plan_mod.shard_spans(16, 4, 4), cache=cache,
        extra=m["extra"])
    assert acct["merged_shards"] == 4 and acct["chunks_committed"] == 4
    assert _manifest(d)["chunks"] == m["chunks"]


def test_lane_stream_discipline(monkeypatch):
    """A lane on a card runs inside a stream of its own that first waits
    for the caller's stream on that device, is what the watchdog and the
    committer see as the walk's stream, and is synchronized before the
    lane's thread hands its results back (no card here: torch.cuda's
    stream calls are stood in for and recorded)."""
    import contextlib

    from spark_timeseries_tpu_torch.reliability import watchdog

    log = []

    class Stream:
        def __init__(self, device=None):
            self.device = device
            log.append(("new", str(device)))

        def wait_stream(self, other):
            log.append(("wait", other))

        def synchronize(self):
            log.append(("sync", str(self.device)))

    @contextlib.contextmanager
    def enter(s):
        log.append(("enter", str(s.device)))
        yield

    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "stream", enter)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: f"caller@{d}")
    parents = plan_mod._parent_streams(
        [torch.device("cuda"), torch.device("cuda", 0), None, CPU])
    assert parents == {torch.device("cuda", 0): "caller@cuda:0"}
    with plan_mod._lane_stream(torch.device("cuda"), parents) as s:
        assert watchdog._walk_stream() is s
        log.append(("body",))
    assert watchdog._walk_stream() is None
    assert log == [("new", "cuda:0"), ("wait", "caller@cuda:0"),
                   ("enter", "cuda:0"), ("body",), ("sync", "cuda:0")]
    log.clear()
    with plan_mod._lane_stream(CPU, parents) as s:
        assert s is None and watchdog._walk_stream() is None
    assert log == []
