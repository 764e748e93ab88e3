"""The port's chunk journal (``reliability.journal``) against the
reference's: the hashing and the file protocol bit for bit, crash and
resume, torn and stale journals, disk faults and the lease protocol.

Bit for bit: ``panel_fingerprint``, ``chunk_fingerprint``,
``_array_digest`` and ``config_hash`` give the reference's hex for the
same bytes, a tensor hashing its host copy; a journal written by either
package resumes under the other's ``ChunkJournal`` (the same shards, the
same manifest schema); ``disk_fault_schedule`` draws the reference's plan.
The walks here are the port's own: a crash (in process with
``crash_after_commits``, and a real ``SIGKILL`` of a worker process,
``python tests/test_torch_journal.py worker ...``) resumes to the bits of
an uninterrupted walk.
"""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from spark_timeseries_tpu.reliability import faultinject as jfi
from spark_timeseries_tpu.reliability import journal as jj
from spark_timeseries_tpu_torch import reliability as rel
from spark_timeseries_tpu_torch.models import arima
from spark_timeseries_tpu_torch.reliability import faultinject as fi
from spark_timeseries_tpu_torch.reliability import journal as tj

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("params", "neg_log_likelihood", "converged", "iters", "status")
B, T, CHUNK = 48, 64, 12


def _ar_panel(b=B, t=T, seed=7, phi=0.6):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(b, t)).astype(np.float32)
    y = np.zeros_like(e)
    y[:, 0] = e[:, 0]
    for i in range(1, t):
        y[:, i] = phi * y[:, i - 1] + e[:, i]
    return y


def _walk(y, d, **kw):
    return rel.fit_chunked(arima.fit, torch.as_tensor(y), chunk_rows=CHUNK,
                           resilient=False, checkpoint_dir=d,
                           order=(1, 0, 0), max_iters=25, device="cpu", **kw)


def _assert_bitwise(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)),
                                      err_msg=f"field {f!r} differs")


def _committed(d):
    with open(os.path.join(d, "manifest.json")) as f:
        m = json.load(f)
    return [(c["lo"], c["hi"]) for c in m["chunks"]
            if c["status"] == "committed"]


@pytest.fixture(scope="module")
def panel():
    return _ar_panel()


@pytest.fixture(scope="module")
def full(panel):
    """The uninterrupted, unjournaled walk every resume is held to."""
    return _walk(panel, None)


# -- hashing: the reference's hex --------------------------------------------


@pytest.mark.parametrize("shape", [(5, 7), (300, 40), (700, 513)])
def test_panel_fingerprint_is_the_references(shape):
    rng = np.random.default_rng(sum(shape))
    y = rng.normal(size=shape).astype(np.float32)
    y[rng.random(shape) < 0.05] = np.nan
    want = jj.panel_fingerprint(y)
    assert tj.panel_fingerprint(y) == want
    assert tj.panel_fingerprint(torch.as_tensor(y)) == want
    # a different NaN placement is a different panel
    y[0, 0] = np.nan if not np.isnan(y[0, 0]) else 1.0
    assert tj.panel_fingerprint(torch.as_tensor(y)) != want


@pytest.mark.parametrize("value", [
    np.arange(12, dtype=np.float32).reshape(3, 4),
    np.arange(7, dtype=np.int64),
    np.float32(2.5),
    np.linspace(0, 1, 1100 * 1000, dtype=np.float32).reshape(1100, 1000),
], ids=["small", "int", "scalar", "strided-sample"])
def test_array_digest_is_the_references(value):
    want = jj._array_digest(value)
    assert tj._array_digest(value) == want
    assert tj._array_digest(torch.as_tensor(value)) == want


def test_chunk_fingerprint_is_the_references():
    y = _ar_panel(300, 200)
    for n_rows, n_cols in ((300, 200), (37, 5), (1, 1)):
        assert tj.chunk_sample_steps(n_rows, n_cols) == \
            jj.chunk_sample_steps(n_rows, n_cols)
        sr, sc = tj.chunk_sample_steps(n_rows, n_cols)
        sample = y[:n_rows:sr, :n_cols:sc]
        assert tj.chunk_fingerprint(sample, n_rows, n_cols) == \
            jj.chunk_fingerprint(sample, n_rows, n_cols)


def _shared_fit(y, *, order=(1, 0, 0), init_params=None, **kw):
    """One fit function handed to both packages' ``config_hash``."""
    return y


@pytest.mark.parametrize("kwargs", [
    {"order": (1, 1, 1), "max_iters": 30},
    {"order": (2, 0, 1), "init_params": np.ones((4, 4), np.float32),
     "device": "cpu"},
    {},
], ids=["plain", "array-kwarg", "empty"])
def test_config_hash_is_the_references(kwargs):
    extra = {"chunk_rows": 12, "resilient": False, "ladder": "default"}
    want = jj.config_hash(_shared_fit, kwargs, extra=extra)
    assert tj.config_hash(_shared_fit, kwargs, extra=extra) == want
    part = functools.partial(_shared_fit, order=(3, 0, 0))
    assert tj.config_hash(part, kwargs) == jj.config_hash(part, kwargs)
    # a tensor kwarg hashes as its host bytes
    tkw = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
           for k, v in kwargs.items()}
    assert tj.config_hash(_shared_fit, tkw, extra=extra) == want


def test_config_hash_names_the_fit_module():
    # the recorded difference: the port's fit and the reference's are
    # different functions, so their journals never adopt each other's
    from spark_timeseries_tpu.models import arima as jarima

    kw = {"order": (1, 0, 0)}
    assert tj.config_hash(arima.fit, kw) != jj.config_hash(jarima.fit, kw)
    assert tj.config_hash(arima.fit, kw) == jj.config_hash(arima.fit, kw)


# -- the file protocol is shared ---------------------------------------------


def _journal(mod, d, **kw):
    return mod.ChunkJournal(d, config_hash="cfg", panel_fingerprint="fp",
                            n_rows=8, chunk_rows=4, **kw)


def _arrays(lo, hi):
    n = hi - lo
    return {"params": np.arange(n * 2, dtype=np.float32).reshape(n, 2) + lo,
            "nll": np.full(n, lo, np.float32),
            "converged": np.ones(n, bool),
            "iters": np.full(n, 3, np.int32),
            "status": np.zeros(n, np.int8)}


@pytest.mark.parametrize("writer,reader", [(tj, jj), (jj, tj)],
                         ids=["port-writes", "reference-writes"])
def test_journal_files_resume_across_packages(tmp_path, writer, reader):
    d = str(tmp_path / "j")
    w = _journal(writer, d)
    w.commit_chunk(0, 4, _arrays(0, 4), wall_s=0.1)
    w.mark_timeout(4, 8, scope="chunk")
    r = _journal(reader, d)
    entry = r.committed(0)
    assert entry is not None and r.committed(4) is None
    piece = r.load_chunk(entry)
    for k, v in _arrays(0, 4).items():
        key = {"nll": "neg_log_likelihood"}.get(k, k)
        np.testing.assert_array_equal(getattr(piece, key), v)
    acct = r.accounting()
    assert (acct["chunks_committed"], acct["chunks_timeout"],
            acct["chunks_resumed"], acct["resumes"]) == (1, 1, 1, 1)


def test_journal_rejections_are_the_references(tmp_path):
    for mod in (tj, jj):
        d = str(tmp_path / mod.__name__.split(".")[0])
        _journal(mod, d)
        with pytest.raises(mod.StaleJournalError):
            mod.ChunkJournal(d, config_hash="other", panel_fingerprint="fp",
                             n_rows=8, chunk_rows=4)
        with pytest.raises(mod.StaleJournalError):
            mod.ChunkJournal(d, config_hash="cfg", panel_fingerprint="fp",
                             n_rows=9, chunk_rows=4)
        with pytest.raises(mod.JournalError):
            _journal(mod, str(tmp_path / "none" / mod.__name__),
                     resume="require")
        with pytest.raises(ValueError):
            _journal(mod, d, resume="sometimes")
        fi.tear_file(os.path.join(d, "manifest.json"))
        with pytest.raises(mod.TornManifestError):
            _journal(mod, d)
        with pytest.raises(mod.TornManifestError):
            _journal(mod, d, resume="never")  # never silently destroyed


def test_check_root_manifest(tmp_path):
    d = str(tmp_path)
    tj.check_root_manifest(d, config_hash="cfg", panel_fingerprint="fp",
                           n_rows=8)  # absent: fine
    _journal(jj, d)
    tj.check_root_manifest(d, config_hash="cfg", panel_fingerprint="fp",
                           n_rows=8)
    with pytest.raises(tj.StaleJournalError):
        tj.check_root_manifest(d, config_hash="cfg", panel_fingerprint="x",
                               n_rows=8)


def test_torn_shard_downgrades_to_recompute(tmp_path):
    d = str(tmp_path)
    j = _journal(tj, d)
    entry = j.commit_chunk(0, 4, _arrays(0, 4), wall_s=0.0)
    fi.tear_file(os.path.join(d, entry["shard"]))
    assert j.load_chunk(entry) is None
    assert j.committed(0) is None
    with open(os.path.join(d, "manifest.json")) as f:
        assert json.load(f)["chunks"][0]["status"] == "shard-lost"


# -- disk faults --------------------------------------------------------------


@pytest.mark.parametrize("seed,n", [(0, 50), (17, 200)])
def test_disk_fault_schedule_is_the_references(seed, n):
    assert fi.disk_fault_schedule(seed, n, eio_frac=0.1, torn_frac=0.2) == \
        jfi.disk_fault_schedule(seed, n, eio_frac=0.1, torn_frac=0.2)
    with pytest.raises(ValueError):
        fi.disk_fault_schedule(seed, n, eio_frac=0.6, enospc_frac=0.5)


def _disk_outcome(mod, fmod, d, verdict):
    """What one commit under one scheduled disk fault does, as the
    reference would report it: (error class, errno) or the shard's fate."""
    j = _journal(mod, d)  # the manifest write passes (not in the plan)
    with fmod.disk_faults([verdict], path_substr="chunk_") as faults:
        try:
            entry = j.commit_chunk(0, 4, _arrays(0, 4), wall_s=0.0)
        except OSError as e:
            return type(e).__name__, e.errno, faults.log[0][2]
    return "loaded" if j.load_chunk(entry) is not None else "lost", \
        None, faults.log[0][2] if faults.log else "pass"


@pytest.mark.parametrize("verdict", ["eio", "enospc", "torn", "pass"])
def test_disk_faults_surface_as_the_references(tmp_path, verdict):
    got = _disk_outcome(tj, fi, str(tmp_path / "port"), verdict)
    want = _disk_outcome(jj, jfi, str(tmp_path / "ref"), verdict)
    assert got == want
    # the hook is uninstalled on exit
    assert tj._disk_fault_hook is None


def test_disk_fault_on_a_walk_then_resume(tmp_path, panel, full):
    d = str(tmp_path / "j")
    # the second chunk's shard write fails with EIO on the committer
    # thread; the error surfaces in the driver, the first chunk stays
    with fi.disk_faults(["pass", "eio"], path_substr="chunk_"):
        with pytest.raises(OSError) as ei:
            _walk(panel, d)
    assert ei.value.errno == 5
    assert _committed(d) == [(0, CHUNK)]
    res = _walk(panel, d)
    _assert_bitwise(res, full)
    assert res.meta["journal"]["chunks_resumed"] == 1
    # a torn shard (a lying fsync) is recomputed on resume
    d2 = str(tmp_path / "torn")
    with fi.disk_faults(["torn"], path_substr="chunk_000000012"):
        _walk(panel, d2)
    res = _walk(panel, d2)
    _assert_bitwise(res, full)
    assert res.meta["journal"]["chunks_resumed"] == 3


# -- crash and resume ---------------------------------------------------------


@pytest.mark.parametrize("pipeline", [True, False], ids=["pipelined",
                                                         "serial"])
@pytest.mark.parametrize("mid_commit", [False, True],
                         ids=["between-commits", "mid-commit"])
def test_crash_resume_is_bitwise(tmp_path, panel, full, pipeline,
                                 mid_commit):
    d = str(tmp_path / "j")
    with pytest.raises(fi.SimulatedCrash):
        _walk(panel, d, pipeline=pipeline,
              _journal_commit_hook=fi.crash_after_commits(
                  2, mid_commit=mid_commit))
    # mid-commit: the second shard is on disk, the manifest never named it
    want = [(0, CHUNK)] if mid_commit else [(0, CHUNK), (CHUNK, 2 * CHUNK)]
    assert _committed(d) == want
    res = _walk(panel, d, pipeline=pipeline)
    _assert_bitwise(res, full)
    acct = res.meta["journal"]
    assert acct["chunks_resumed"] == len(want)
    assert acct["chunks_committed"] == B // CHUNK
    assert acct["resumes"] == 1


def test_torn_and_stale_walk_journals(tmp_path, panel):
    d = str(tmp_path / "j")
    _walk(panel, d)
    with pytest.raises(tj.StaleJournalError):  # another config
        rel.fit_chunked(arima.fit, torch.as_tensor(panel), chunk_rows=CHUNK,
                        resilient=False, checkpoint_dir=d, order=(1, 0, 0),
                        max_iters=26, device="cpu")
    other = panel.copy()
    other[0, 0] += 1.0
    with pytest.raises(tj.StaleJournalError):  # another panel
        _walk(other, d)
    fi.tear_file(os.path.join(d, "manifest.json"))
    with pytest.raises(tj.TornManifestError):
        _walk(panel, d)


def test_kill_after_commits_resume_is_bitwise(tmp_path, full):
    d, out = str(tmp_path / "j"), str(tmp_path / "resumed.npz")
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    me = os.path.abspath(__file__)
    killed = subprocess.run(
        [sys.executable, me, "worker", d, "2", "mid"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert killed.returncode == -9, killed.stderr[-2000:]
    assert _committed(d) == [(0, CHUNK)]
    done = subprocess.run(
        [sys.executable, me, "worker", d, "0", "-", out], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    with np.load(out) as z:
        for f in FIELDS:
            np.testing.assert_array_equal(z[f], getattr(full, f), err_msg=f)
        acct = json.loads(str(z["journal"]))
    assert acct["chunks_resumed"] == 1 and acct["chunks_committed"] == 4


# -- the lease protocol --------------------------------------------------------


def test_lease_protocol_and_fencing(tmp_path):
    root = str(tmp_path)
    a = tj.acquire_lease(root, "a", ttl_s=30.0)
    assert a is not None and a.token == 1
    assert tj.acquire_lease(root, "b", ttl_s=30.0) is None  # live holder
    assert jj.lease_is_live(root) and jj.highest_claim(root) == 1
    a.heartbeat()
    assert tj.read_lease(root)["owner"] == "a"
    a.release()
    assert not tj.lease_is_live(root)
    b = jj.acquire_lease(root, "b", ttl_s=30.0)  # the reference takes over
    assert b is not None and b.token == 2
    with pytest.raises(tj.FencedError):
        a.check()  # a stale-token holder loses loudly
    with pytest.raises(tj.FencedError):
        a.heartbeat()
    a.release()  # no-op once fenced
    assert tj.read_lease(root)["owner"] == "b"


def _worker(argv):
    """``worker DIR KILL_AFTER MID|- [OUT]``: one journaled walk of the
    module's panel; with KILL_AFTER > 0 the process SIGKILLs itself after
    that many commits (mid-commit with MID), else it saves the result."""
    d, kill_after, mid = argv[0], int(argv[1]), argv[2] == "mid"
    hook = (fi.kill_after_commits(kill_after, mid_commit=mid)
            if kill_after else None)
    res = _walk(_ar_panel(), d, _journal_commit_hook=hook)
    if kill_after:
        sys.exit("the kill hook never fired")
    np.savez(argv[3], journal=json.dumps(res.meta["journal"]),
             **{f: getattr(res, f) for f in FIELDS})


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker(sys.argv[2:])
