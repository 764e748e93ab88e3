"""The port's chunk walk (``reliability.fit_chunked`` with its plan, lane
runner, committer and prefetcher) against the reference's.

Against the reference, on the same numpy panels:
- an ARIMA(1,1,1) walk (32 x 200 integrated ARMA rows with two NaN-holed
  rows, four chunks, the resilient path): the same status on every row,
  the same convergence, and parameters within the ARIMA parity bar of
  ``tests/test_torch_reliability.py`` (4e-3);
- with a deterministic stand-in fit (exact float32 arithmetic in both
  packages): the chunk grid after out-of-memory halvings (``oom_fit`` at
  the fit and a commit-time failure), ``meta`` and the journal's chunk
  boundaries, and the TIMEOUT status maps under ``hanging_fit`` with
  ``chunk_budget_s`` and ``job_budget_s``, bit for bit.
The port's own promises, bit for bit: pipelined equals serial, prefetch on
equals prefetch off, a chunk budget changes nothing that finishes in it;
the failed fit's frames are freed before the halved retry.  The
multi-lane keywords run the reference's multi-lane walk (the stand-in fit,
bit for bit); ``tests/test_torch_sharded.py`` and
``test_torch_elastic.py`` hold that walk in full.
"""

import functools
import gc
import json
import os
import threading
import time
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu import reliability as jrel
from spark_timeseries_tpu.models import arima as jarima
from spark_timeseries_tpu.models import base as jbase
from spark_timeseries_tpu.reliability import faultinject as jfi
from spark_timeseries_tpu_torch import reliability as rel
from spark_timeseries_tpu_torch.models import arima
from spark_timeseries_tpu_torch.models import base as tbase
from spark_timeseries_tpu_torch.reliability import FitStatus
from spark_timeseries_tpu_torch.reliability import faultinject as fi
from spark_timeseries_tpu_torch.reliability.committer import ChunkCommitter
from spark_timeseries_tpu_torch.reliability.prefetcher import ChunkPrefetcher

FIELDS = ("params", "neg_log_likelihood", "converged", "iters", "status")
PARAM_TOL = 4e-3  # tests/test_torch_reliability.py's ARIMA parity bar


def _arma_panel(b=32, t=200, seed=3):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(b, t)).astype(np.float32)
    y = np.zeros_like(e)
    y[:, 0] = e[:, 0]
    for i in range(1, t):
        y[:, i] = 0.6 * y[:, i - 1] + e[:, i] + 0.3 * e[:, i - 1]
    return np.cumsum(y, axis=1)


def _assert_bitwise(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)),
                                      err_msg=f"field {f!r} differs")


# a stand-in fit with exact float32 arithmetic in both packages: the
# driver's grid, meta and status logic is what the comparisons hold


def _tfake(y, *, align_mode=None, device="cpu", scale=2.0):
    return tbase.FitResult(torch.stack([y[:, 0], y[:, -1]], 1) * scale,
                           y[:, 1] + y[:, 2], y[:, 0] > 0,
                           (y[:, 3] > 0).to(torch.int32), None)


def _jfake(y, *, align_mode=None, scale=2.0):
    y = jnp.asarray(y)
    return jbase.FitResult(jnp.stack([y[:, 0], y[:, -1]], 1) * scale,
                           y[:, 1] + y[:, 2], y[:, 0] > 0,
                           (y[:, 3] > 0).astype(jnp.int32), None)


def _fake_panel(b=40, t=6, seed=1):
    return np.random.default_rng(seed).normal(size=(b, t)).astype(np.float32)


def _both(tfit, jfit, y, **kw):
    """The same walk through the port (CPU tensors) and the reference."""
    port = rel.fit_chunked(tfit, torch.as_tensor(y), resilient=False,
                           device="cpu", **kw)
    ref = jrel.fit_chunked(jfit, y, resilient=False, **kw)
    return port, ref


# -- against the reference: an ARIMA walk --------------------------------------


@pytest.fixture(scope="module")
def arima_walks():
    y = fi.inject_nan_rows(_arma_panel(), [3, 17], seed=1)
    kw = dict(chunk_rows=8, order=(1, 1, 1), max_iters=30)
    port = rel.fit_chunked(arima.fit, torch.as_tensor(y), device="cpu", **kw)
    ref = jrel.fit_chunked(jarima.fit, y, **kw)
    return port, ref


def test_arima_walk_matches_reference(arima_walks):
    port, ref = arima_walks
    np.testing.assert_array_equal(port.status, np.asarray(ref.status))
    np.testing.assert_array_equal(port.converged, np.asarray(ref.converged))
    assert port.status[[3, 17]].tolist() == [FitStatus.SANITIZED] * 2
    fin = np.isfinite(port.params).all(1)
    np.testing.assert_array_equal(fin,
                                  np.isfinite(np.asarray(ref.params)).all(1))
    np.testing.assert_allclose(port.params[fin], np.asarray(ref.params)[fin],
                               rtol=PARAM_TOL, atol=PARAM_TOL)
    for k in ("chunk_rows_initial", "chunk_rows_final", "chunks_run",
              "degraded", "status_counts", "align_mode"):
        assert port.meta[k] == ref.meta[k], k


def test_arima_walk_is_resilient_fit_chunk_by_chunk(arima_walks):
    port, _ = arima_walks
    y = torch.as_tensor(fi.inject_nan_rows(_arma_panel(), [3, 17], seed=1))
    for lo in range(0, 32, 8):
        one = rel.resilient_fit(arima.fit, y[lo:lo + 8], order=(1, 1, 1),
                                max_iters=30, device="cpu",
                                align_mode=port.meta["align_mode"])
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(one, f),
                                          getattr(port, f)[lo:lo + 8], f)


# -- against the reference: backoff grids and TIMEOUT maps -------------------


def _grid(d):
    """(lo, hi, chunk_rows_after) of every journaled chunk."""
    with open(os.path.join(d, "manifest.json")) as f:
        return [(c["lo"], c["hi"], c["chunk_rows_after"])
                for c in json.load(f)["chunks"]]


@pytest.mark.parametrize("chunk_rows,max_rows,min_rows", [
    (32, 9, 4), (40, 7, 2), (16, 16, 4), (12, 5, 2)])
def test_oom_backoff_grid_matches_reference(tmp_path, chunk_rows, max_rows,
                                            min_rows):
    y = _fake_panel()
    kw = dict(chunk_rows=chunk_rows, min_chunk_rows=min_rows)
    port, ref = _both(fi.oom_fit(_tfake, max_rows),
                      jfi.oom_fit(_jfake, max_rows), y, **kw)
    _assert_bitwise(port, ref)
    for k in ("degraded", "oom_backoffs", "oom_events", "chunk_rows_initial",
              "chunk_rows_final", "chunks_run", "status_counts"):
        assert port.meta[k] == ref.meta[k], k
    # the journaled grid: the same chunks, the same backoff state recorded
    pj = rel.fit_chunked(fi.oom_fit(_tfake, max_rows), torch.as_tensor(y),
                         resilient=False, device="cpu",
                         checkpoint_dir=str(tmp_path / "port"), **kw)
    rj = jrel.fit_chunked(jfi.oom_fit(_jfake, max_rows), y, resilient=False,
                          checkpoint_dir=str(tmp_path / "ref"), **kw)
    _assert_bitwise(pj, rj)
    assert _grid(str(tmp_path / "port")) == _grid(str(tmp_path / "ref"))


def test_oom_floor_raises_like_the_reference():
    y = _fake_panel()
    with pytest.raises(rel.OOMBackoffExceeded):
        rel.fit_chunked(fi.oom_fit(_tfake, 1), torch.as_tensor(y),
                        chunk_rows=16, min_chunk_rows=4, resilient=False,
                        device="cpu")
    with pytest.raises(jrel.OOMBackoffExceeded):
        jrel.fit_chunked(jfi.oom_fit(_jfake, 1), y, chunk_rows=16,
                         min_chunk_rows=4, resilient=False)


class _FetchOOM:
    """A result field whose host read fails once with the simulated OOM —
    a chunk whose failure surfaces on the committer thread."""

    def __init__(self, value, exc):
        self.value, self.exc = value, exc

    def __array__(self, dtype=None, copy=None):
        raise self.exc


def _fetch_oom_fit(fit, exc_type, at_call=1):
    calls = {"n": 0}

    def wrapped(y, **kw):
        out = fit(y, **kw)
        calls["n"] += 1
        if calls["n"] - 1 == at_call:
            return out._replace(params=_FetchOOM(out.params, exc_type(1)))
        return out

    return wrapped


def test_commit_time_oom_rolls_back_like_the_reference(tmp_path):
    y = _fake_panel()
    kw = dict(chunk_rows=16, min_chunk_rows=2)
    port = rel.fit_chunked(_fetch_oom_fit(_tfake,
                                          fi.SimulatedResourceExhausted),
                           torch.as_tensor(y), resilient=False, device="cpu",
                           checkpoint_dir=str(tmp_path / "port"), **kw)
    ref = jrel.fit_chunked(_fetch_oom_fit(_jfake,
                                          jfi.SimulatedResourceExhausted),
                           y, resilient=False,
                           checkpoint_dir=str(tmp_path / "ref"), **kw)
    _assert_bitwise(port, ref)
    for k in ("oom_events", "chunk_rows_final", "chunks_run"):
        assert port.meta[k] == ref.meta[k], k
    assert port.meta["oom_events"][0]["at_row"] == 16


@pytest.mark.parametrize("hang", [[1], [0, 3]])
def test_timeout_status_map_matches_reference(tmp_path, hang):
    y = _fake_panel()
    _jfake(y[:10])  # the reference's first eager ops compile: not in budget
    kw = dict(chunk_rows=10, chunk_budget_s=1.0)
    port, ref = _both(fi.hanging_fit(_tfake, hang, sleep_s=2.5),
                      jfi.hanging_fit(_jfake, hang, sleep_s=2.5), y, **kw)
    _assert_bitwise(port, ref)
    want = np.zeros(40, bool)
    for h in hang:
        want[h * 10:(h + 1) * 10] = True
    np.testing.assert_array_equal(port.status == FitStatus.TIMEOUT, want)
    for k in ("timeouts", "timeout_events", "degraded", "status_counts"):
        assert port.meta[k] == ref.meta[k], k
    # a journaled resume retries exactly the TIMEOUT chunks
    d = str(tmp_path / "j")
    rel.fit_chunked(fi.hanging_fit(_tfake, hang, sleep_s=2.5),
                    torch.as_tensor(y), resilient=False, device="cpu",
                    checkpoint_dir=d, **kw)
    calls = []

    @functools.wraps(_tfake)  # the same fit identity: the journal resumes
    def counted(yb, **k):
        calls.append(1)
        return _tfake(yb, **k)

    res = rel.fit_chunked(counted, torch.as_tensor(y), resilient=False,
                          device="cpu", checkpoint_dir=d, **kw)
    assert len(calls) == len(hang) and not res.meta["degraded"]
    _assert_bitwise(res, rel.fit_chunked(_tfake, torch.as_tensor(y),
                                         resilient=False, device="cpu",
                                         chunk_rows=10))


def test_job_budget_matches_reference():
    y = _fake_panel()
    port, ref = _both(_tfake, _jfake, y, chunk_rows=10, job_budget_s=0.0)
    _assert_bitwise(port, ref)
    assert port.meta["timeout_events"] == ref.meta["timeout_events"]
    assert (port.status == FitStatus.TIMEOUT).all()
    assert np.isnan(port.params).all() and port.params.shape == (40, 1)


def test_meta_and_manifest_keys_match_reference(tmp_path):
    y = _fake_panel()
    kw = dict(chunk_rows=10, grid=(1, 3, [1, 2]))
    port = rel.fit_chunked(_tfake, torch.as_tensor(y), resilient=False,
                           device="cpu", checkpoint_dir=str(tmp_path / "p"),
                           **kw)
    ref = jrel.fit_chunked(_jfake, y, resilient=False,
                           checkpoint_dir=str(tmp_path / "r"), **kw)
    _assert_bitwise(port, ref)
    assert set(port.meta) == set(ref.meta)
    assert set(port.meta["pipeline"]) == set(ref.meta["pipeline"])
    assert set(port.meta["journal"]) == set(ref.meta["journal"])
    assert port.meta["grid"] == ref.meta["grid"]
    pm, rm = ({**json.load(open(os.path.join(str(tmp_path / d),
                                             "manifest.json")))}
              for d in ("p", "r"))
    assert set(pm) == set(rm)
    assert set(pm["extra"]) == set(rm["extra"])
    assert pm["extra"]["grid"] == rm["extra"]["grid"]
    assert pm["panel_fingerprint"] == rm["panel_fingerprint"]
    assert [set(c) for c in pm["chunks"]] == [set(c) for c in rm["chunks"]]
    assert [c["chunk_fingerprint"] for c in pm["chunks"]] == \
        [c["chunk_fingerprint"] for c in rm["chunks"]]
    for bad in ((3, 3), (0, 2, [1])):
        for f, mod, yy in ((_tfake, rel, torch.as_tensor(y)),
                           (_jfake, jrel, y)):
            with pytest.raises(ValueError):
                mod.fit_chunked(f, yy, resilient=False, chunk_rows=10,
                                grid=bad, **({"device": "cpu"}
                                             if mod is rel else {}))


# -- the port's own promises ------------------------------------------------


@pytest.fixture(scope="module")
def walk_panel():
    return torch.as_tensor(_arma_panel(48, 80, seed=5))


def _arima_walk(y, **kw):
    return rel.fit_chunked(arima.fit, y, chunk_rows=12, resilient=False,
                           order=(1, 1, 1), max_iters=25, device="cpu", **kw)


@pytest.fixture(scope="module")
def serial_walk(walk_panel):
    return _arima_walk(walk_panel, pipeline=False)


@pytest.mark.parametrize("kw", [
    {"pipeline": True}, {"pipeline": True, "prefetch_depth": 0},
    {"pipeline": True, "prefetch_depth": 2, "pipeline_depth": 1},
    {"pipeline": True, "chunk_budget_s": 60.0},
    {"pipeline": True, "journal": True},
    {"pipeline": False, "journal": True}],
    ids=["pipelined", "no-prefetch", "deep-prefetch", "chunk-budget",
         "journaled", "journaled-serial"])
def test_pipelined_equals_serial(tmp_path, walk_panel, serial_walk, kw):
    kw = dict(kw)
    if kw.pop("journal", False):
        kw["checkpoint_dir"] = str(tmp_path / "j")
    res = _arima_walk(walk_panel, **kw)
    _assert_bitwise(res, serial_walk)
    pipe = res.meta.get("pipeline") or {}
    if kw.get("pipeline") and kw.get("prefetch_depth", 1):
        assert pipe["staged_hits"] == 3 and pipe["staged_misses"] == 1
    if "checkpoint_dir" in kw and kw["pipeline"]:
        assert pipe["commits_background"] == 4


def test_oom_retry_runs_after_the_failed_fit_is_freed():
    held, seen = {}, []

    class Marker:
        pass

    def fit(y, **kw):
        if "ref" not in held:
            big = Marker()  # a local of the failed fit's frame
            held["ref"] = weakref.ref(big)
            raise fi.SimulatedResourceExhausted(1)
        seen.append(held["ref"]() is None)
        return _tfake(y, **kw)

    gc.disable()
    try:
        rel.fit_chunked(fit, torch.as_tensor(_fake_panel()), chunk_rows=40,
                        min_chunk_rows=2, resilient=False, device="cpu")
    finally:
        gc.enable()
    assert seen and all(seen)  # freed by refcount, before the first retry


def test_multi_lane_keywords_raise(tmp_path):
    # the multi-lane keywords run the multi-lane walk: an 8-lane walk is
    # the reference's 8-lane walk (the stand-in fit's exact arithmetic)
    # bit for bit, meta and merged manifest included; a process_index
    # other than 0 journals under proc_00001/ as the reference's does
    from spark_timeseries_tpu_torch.parallel import mesh as meshlib

    y = _fake_panel()
    mesh = meshlib.default_mesh(devices=[torch.device("cpu")] * 8)
    port = rel.fit_chunked(_tfake, torch.as_tensor(y), resilient=False,
                           device="cpu", mesh=mesh, chunk_rows=5,
                           checkpoint_dir=str(tmp_path / "p"))
    ref = jrel.fit_chunked(_jfake, y, resilient=False, shard=True,
                           chunk_rows=5, checkpoint_dir=str(tmp_path / "r"))
    _assert_bitwise(port, ref)
    for k in ("chunks_run", "status_counts", "chunk_rows_final"):
        assert port.meta[k] == ref.meta[k], k
    for k in ("n_shards", "spans", "lanes_run"):
        assert port.meta["shards"][k] == ref.meta["shards"][k], k
    pm = json.load(open(tmp_path / "p" / "manifest.json"))
    rm = json.load(open(tmp_path / "r" / "manifest.json"))
    assert [(c["lo"], c["hi"], c["shard_id"], c["shard"])
            for c in pm["chunks"]] == \
        [(c["lo"], c["hi"], c["shard_id"], c["shard"]) for c in rm["chunks"]]
    assert pm["merged_from_shards"] == rm["merged_from_shards"] == 8
    assert [{k: v for k, v in sh.items() if k != "run_id"}
            for sh in pm["shards"]] == \
        [{k: v for k, v in sh.items() if k != "run_id"}
         for sh in rm["shards"]]
    for kw in ({"process_index": 1}, {"process_index": 0}):
        d = tmp_path / f"pi{kw['process_index']}"
        got = rel.fit_chunked(_tfake, torch.as_tensor(y), resilient=False,
                              device="cpu", chunk_rows=16,
                              checkpoint_dir=str(d), **kw)
        want = jrel.fit_chunked(_jfake, y, resilient=False, chunk_rows=16,
                                checkpoint_dir=str(tmp_path / "r" / d.name),
                                **kw)
        _assert_bitwise(got, want)
        assert (os.path.basename(got.meta["journal"]["manifest"])
                == os.path.basename(want.meta["journal"]["manifest"]))


def test_numpy_panel_goes_to_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        rel.fit_chunked(_tfake, _fake_panel(), resilient=False)
    res = rel.fit_chunked(_tfake, _fake_panel(), resilient=False,
                          device="cpu", chunk_rows=16)
    assert res.params.shape == (40, 2)


# -- committer and prefetcher ----------------------------------------------


class _Journal:
    def __init__(self, fail_at=None):
        self.commits, self.fail_at = [], fail_at

    def commit_chunk(self, lo, hi, arrays, **info):
        if lo == self.fail_at:
            raise OSError(5, "injected")
        time.sleep(0.01)
        self.commits.append((lo, hi, sorted(info)))


def test_committer_commits_in_order_and_surfaces_errors():
    j = _Journal()
    c = ChunkCommitter(j, lambda p: {"status": np.zeros(2, np.int8)},
                       depth=2, status_counts=rel.status_counts)
    for lo in range(0, 10, 2):
        c.submit(lo, lo + 2, None, wall_s=0.0, chunk_rows_after=2)
    stats = c.close()
    assert [x[:2] for x in j.commits] == [(lo, lo + 2)
                                         for lo in range(0, 10, 2)]
    assert j.commits[0][2] == ["chunk_rows_after", "status_counts",
                               "wall_s"]
    assert stats.commits == 5 and stats.max_queue_depth <= 2
    bad = ChunkCommitter(_Journal(fail_at=2), lambda p: {"status":
                                                       np.zeros(2, np.int8)},
                         depth=4)
    for lo in range(0, 8, 2):
        bad.submit(lo, lo + 2, None, wall_s=0.0)
    err = bad.drain(raise_pending=False)
    assert isinstance(err[0], OSError) and err[1:] == (2, 4)
    assert bad.close().commits == 1  # commits queued behind it discarded


def test_prefetcher_hits_misses_invalidation_and_errors():
    panel = torch.arange(40.0).reshape(20, 2)
    pf = ChunkPrefetcher(panel, depth=2)
    pf.schedule(0, 5)
    pf.schedule(5, 10)
    pf.schedule(10, 15)  # beyond the depth: ignored
    assert torch.equal(pf.take(0, 5), panel[0:5])
    assert torch.equal(pf.take(10, 15), panel[10:15])  # a miss, inline
    pf.invalidate()  # drops (5, 10)
    st = pf.close()
    assert (st.hits, st.misses, st.invalidated) == (1, 1, 1)

    class Boom:
        def __getitem__(self, s):
            raise fi.SimulatedResourceExhausted(8)

    pf = ChunkPrefetcher(Boom(), depth=1)
    pf.schedule(0, 2)
    with pytest.raises(fi.SimulatedResourceExhausted):
        pf.take(0, 2)
    pf.close()


def test_prefetcher_worker_is_a_named_daemon():
    pf = ChunkPrefetcher(torch.zeros(4, 2))
    assert any(t.name == "chunk-prefetcher" and t.daemon
               for t in threading.enumerate())
    pf.close()
