"""The port's chunk sources, staging pool, write-back sink and panel
augmentation against the reference's.

Bit for bit: npz and parquet shard directories written by either package
read back in the other (rows, shapes, the shard-identity fingerprint); a
host panel fingerprints as the reference does; ``augmented_host``,
``augmented_panel``, ``derive_status`` and ``ColumnBlockSource`` give the
reference's bytes.  The port's own promises, bit for bit: walks over a
tensor, a host array and an npz directory give the same result; a staged
chunk on the CPU owns its bytes (the pool buffer is reused for the next
chunk under it); a sink walk's output shards read back as the in-memory
result, also after a resume.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu.forecasting import augment as jaug
from spark_timeseries_tpu.reliability import source as jsrc
from spark_timeseries_tpu_torch import obs
from spark_timeseries_tpu_torch import reliability as rel
from spark_timeseries_tpu_torch.forecasting import augment as taug
from spark_timeseries_tpu_torch.models import arima
from spark_timeseries_tpu_torch.reliability import faultinject as fi
from spark_timeseries_tpu_torch.reliability import journal as tj
from spark_timeseries_tpu_torch.reliability import sink as tsink
from spark_timeseries_tpu_torch.reliability import source as tsrc

FIELDS = ("params", "neg_log_likelihood", "converged", "iters", "status")
B, T, CHUNK = 48, 64, 12


def _panel(b=B, t=T, seed=11):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(b, t)).astype(np.float32)
    y = np.zeros_like(e)
    y[:, 0] = e[:, 0]
    for i in range(1, t):
        y[:, i] = 0.5 * y[:, i - 1] + e[:, i]
    return y


def _walk(src, **kw):
    return rel.fit_chunked(arima.fit, src, chunk_rows=CHUNK, resilient=False,
                           order=(1, 0, 0), max_iters=25, device="cpu", **kw)


def _assert_bitwise(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)),
                                      err_msg=f"field {f!r} differs")


@pytest.fixture(scope="module")
def panel():
    return _panel()


@pytest.fixture(scope="module")
def device_walk(panel):
    return _walk(torch.as_tensor(panel))


# -- shard directories are shared with the reference --------------------------


@pytest.mark.parametrize("writer,reader", [
    (jsrc, tsrc), (tsrc, jsrc)], ids=["reference-writes", "port-writes"])
def test_npz_shards_cross_packages(tmp_path, panel, writer, reader):
    d = str(tmp_path / "npz")
    writer.write_npz_shards(d, panel, rows_per_shard=10)
    got, want = reader.NpzShardSource(d), writer.NpzShardSource(d)
    assert got.shape == want.shape == panel.shape
    assert got.default_chunk_rows == want.default_chunk_rows == 10
    assert got.fingerprint() == want.fingerprint()
    out = np.empty((23, T), np.float32)
    got.read_rows(7, 30, out)
    np.testing.assert_array_equal(out, panel[7:30])
    # appended series and appended time steps, read by the other package
    writer.NpzShardSource(d).append_rows(panel[:5])
    grown = reader.NpzShardSource(d)
    assert grown.shape == (B + 5, T)
    writer.write_npz_shards(d, np.ones((B + 5, 2), np.float32),
                            append_time=True, expect_time=T)
    wide = reader.NpzShardSource(d)
    out = np.empty((B + 5, T + 2), np.float32)
    wide.read_rows(0, B + 5, out)
    np.testing.assert_array_equal(out[:B, :T], panel)
    np.testing.assert_array_equal(out[B:, :T], panel[:5])
    assert (out[:, T:] == 1).all()


@pytest.mark.parametrize("writer,reader", [
    (jsrc, tsrc), (tsrc, jsrc)], ids=["reference-writes", "port-writes"])
def test_parquet_shards_cross_packages(tmp_path, panel, writer, reader):
    d = str(tmp_path / "pq")
    writer.write_parquet_shards(d, panel, rows_per_shard=16)
    got = reader.as_source(d)
    assert isinstance(got, reader.ParquetShardSource)
    assert got.fingerprint() == writer.ParquetShardSource(d).fingerprint()
    out = np.empty((B, T), np.float32)
    got.read_rows(0, B, out)
    np.testing.assert_array_equal(out, panel)


def test_host_fingerprint_is_the_references(panel):
    want = jsrc.HostChunkSource(panel).fingerprint()
    assert tsrc.HostChunkSource(panel).fingerprint() == want
    assert tj.panel_fingerprint(torch.as_tensor(panel)) == want
    assert tsrc.DeviceChunkSource(torch.as_tensor(panel)).fingerprint() == want
    assert tsrc.HostChunkSource(panel).align_mode() == \
        jsrc.HostChunkSource(panel).align_mode() == "dense"


def test_malformed_sources_raise_source_error(tmp_path, panel):
    d = str(tmp_path / "mixed")
    tsrc.write_npz_shards(d, panel[:10], rows_per_shard=10)
    np.savez(os.path.join(d, "part_00009.npz"), values=panel[:4, :5])
    with pytest.raises(tsrc.SourceError, match="mixed"):
        tsrc.NpzShardSource(d)
    d2 = str(tmp_path / "torn")
    tsrc.write_npz_shards(d2, panel, rows_per_shard=24)
    fi.tear_file(os.path.join(d2, "part_00001.npz"))
    with pytest.raises(tsrc.SourceError, match="unreadable/torn"):
        tsrc.NpzShardSource(d2)
    with pytest.raises(tsrc.SourceError):
        tsrc.HostChunkSource(panel[0])
    with pytest.raises(tsrc.SourceError):
        tsrc.write_npz_shards(d, panel, append_rows=True, append_time=True)


# -- staging ---------------------------------------------------------------


def test_staged_chunk_owns_its_bytes_on_the_cpu(panel):
    src = tsrc.HostChunkSource(panel)
    a = src.stage(0, 12, device="cpu")
    b = src.stage(12, 24, device="cpu")  # reuses the pool buffer
    np.testing.assert_array_equal(a.numpy(), panel[0:12])
    np.testing.assert_array_equal(b.numpy(), panel[12:24])
    st = src.stats()
    assert (st["pool_hits"], st["pool_misses"], st["pool_buffers"]) == \
        (1, 1, 1)
    assert st["h2d_bytes"] == 24 * T * 4
    assert st["peak_live_device_bytes"] == 24 * T * 4
    del a, b
    assert src.stats()["peak_live_device_bytes"] == 24 * T * 4
    src.reset_peak_live()
    assert src.stats()["peak_live_device_bytes"] == 0  # both retired
    with pytest.raises(IndexError):
        src.stage(40, 60, device="cpu")


def test_source_stages_to_the_card_by_default(panel):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsrc.HostChunkSource(panel).stage(0, 4)


@pytest.mark.parametrize("kind", ["host", "npz", "npz-shard-grid",
                                  "device-source"])
def test_residencies_are_bitwise_equal(tmp_path, panel, device_walk, kind):
    if kind == "host":
        src = tsrc.HostChunkSource(panel)
    elif kind == "device-source":
        src = tsrc.as_source(torch.as_tensor(panel))
        assert isinstance(src, tsrc.DeviceChunkSource)
    else:
        d = str(tmp_path / "npz")
        tsrc.write_npz_shards(d, panel, rows_per_shard=
                              CHUNK if kind == "npz-shard-grid" else 20)
        src = tsrc.as_source(d)
    res = _walk(src)
    _assert_bitwise(res, device_walk)
    if kind != "device-source":
        st = res.meta["source"]["staging_pool"]
        assert st["h2d_bytes"] == panel.nbytes
        assert st["h2d_copies"] == B // CHUNK
        # O(chunk): at most the chunk computing and the one staged ahead
        assert st["peak_live_device_bytes"] <= 2 * CHUNK * T * 4
        assert res.meta["pipeline"]["staged_hits"] == B // CHUNK - 1


def test_journals_cross_resume_between_residencies(tmp_path, panel,
                                                   device_walk):
    d = str(tmp_path / "j")
    with pytest.raises(fi.SimulatedCrash):
        _walk(torch.as_tensor(panel), checkpoint_dir=d,
              _journal_commit_hook=fi.crash_after_commits(2))
    res = _walk(tsrc.HostChunkSource(panel), checkpoint_dir=d)
    _assert_bitwise(res, device_walk)
    assert res.meta["journal"]["chunks_resumed"] == 2
    assert res.meta["source"]["staging_pool"]["h2d_copies"] == 2


def test_staging_pool_bytes_reach_peak_memory(panel):
    src = tsrc.HostChunkSource(panel)
    src.stage(0, 8, device="cpu")
    pm = obs.peak_memory()
    assert pm.staging_pool_bytes is not None
    assert pm.staging_pool_bytes >= 8 * T * 4


# -- write-back sink ---------------------------------------------------------


def _read_sink(d, key):
    src = tsrc.NpzShardSource(d, key=key) if key == "params" else None
    if src is not None:
        out = np.empty(src.shape, src.dtype)
        src.read_rows(0, src.shape[0], out)
        return out
    parts = sorted(n for n in os.listdir(d) if n.startswith("out_"))
    return np.concatenate([np.load(os.path.join(d, n))[key] for n in parts])


def test_sink_round_trips_and_resumes(tmp_path, panel, device_walk):
    with pytest.raises(ValueError, match="checkpoint_dir"):
        _walk(torch.as_tensor(panel), sink=str(tmp_path / "nowhere"))
    sd, jd = str(tmp_path / "sink"), str(tmp_path / "j")
    with pytest.raises(fi.SimulatedCrash):
        _walk(torch.as_tensor(panel), checkpoint_dir=jd, sink=sd,
              _journal_commit_hook=fi.crash_after_commits(3))
    res = _walk(torch.as_tensor(panel), checkpoint_dir=jd, sink=sd)
    assert res.params is None and res.status is None
    acct = res.meta["sink"]
    assert acct["spans"] == B // CHUNK
    assert res.meta["status_counts"] == device_walk.meta["status_counts"]
    for key, f in (("params", "params"), ("nll", "neg_log_likelihood"),
                   ("converged", "converged"), ("iters", "iters"),
                   ("status", "status")):
        np.testing.assert_array_equal(_read_sink(sd, key),
                                      getattr(device_walk, f), err_msg=key)
    with open(os.path.join(sd, tsink.SINK_MANIFEST)) as fh:
        m = json.load(fh)
    assert m["n_rows"] == B and [s["lo"] for s in m["shards"]] == \
        list(range(0, B, CHUNK))


def test_sink_finalize_refuses_a_gap(tmp_path):
    s = tsink.WritableChunkSource(str(tmp_path))
    s.write(0, 4, {"params": np.zeros((4, 2), np.float32)})
    s.write(8, 12, {"params": np.zeros((4, 2), np.float32)})
    with pytest.raises(tsink.SinkError, match="gap"):
        s.finalize(12)


# -- panel augmentation -------------------------------------------------------


def test_augmentation_is_the_references(panel):
    params = np.random.default_rng(0).normal(size=(B, 3)).astype(np.float32)
    params[5] = np.nan
    np.testing.assert_array_equal(taug.derive_status(params),
                                  jaug.derive_status(params))
    status = taug.derive_status(params)
    np.testing.assert_array_equal(
        taug.augmented_host(panel, params, status, base_row=7),
        jaug.augmented_host(panel, params, status, base_row=7))
    got, t, k = taug.augmented_panel(torch.as_tensor(panel), params, status)
    want, jt, jk = jaug.augmented_panel(jnp.asarray(panel), params, status)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (t, k) == (jt, jk) == (T, 3)
    # the streamed spelling: the same bytes, the same panel identity
    srcs, _, _ = taug.augmented_panel(tsrc.HostChunkSource(panel), params,
                                      status)
    jsrcs, _, _ = jaug.augmented_panel(jsrc.HostChunkSource(panel), params,
                                       status)
    assert isinstance(srcs, taug.ColumnBlockSource)
    out = np.empty(srcs.shape, np.float32)
    srcs.read_rows(0, B, out)
    np.testing.assert_array_equal(out, got.numpy())
    assert srcs.fingerprint() == jsrcs.fingerprint() == \
        tj.panel_fingerprint(got)
    with pytest.raises(ValueError):
        taug.augmented_panel(torch.as_tensor(panel), params[:3], status)
    with pytest.raises(ValueError):
        taug._check_row_index((1 << 24) + 1, np.dtype(np.float32))
