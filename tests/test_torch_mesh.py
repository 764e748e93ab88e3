"""The port's mesh (``parallel/mesh.py``) against the reference's.

The mesh axes and shapes, the single-process contract of
``init_distributed`` and its environment probe (the reference's
``test_parallel.py`` cases, on the port), the padding rule, the sharding
specs, and the row placement of ``distribute_panel`` / ``lane_values``.
The port cannot force eight CPU devices, so its CPU meshes list the CPU
device several times (virtual shards); a panel on a ``(4,)`` and a
``(4, 2)`` such mesh is held against the unsharded panel bit for bit and
against the reference's panel on its forced 8-device mesh.  Values are
float64 on both sides (``tests/conftest.py`` enables x64).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spark_timeseries_tpu as ref
from spark_timeseries_tpu import index as rix
from spark_timeseries_tpu.parallel import mesh as rmesh
import spark_timeseries_tpu_torch as port
from spark_timeseries_tpu_torch import index as pix
from spark_timeseries_tpu_torch.parallel import mesh as meshlib
from spark_timeseries_tpu_torch.reliability import plan

CPU = torch.device("cpu")


def _cpu_mesh(n=8, time_shards=1):
    return meshlib.default_mesh(devices=[CPU] * n, time_shards=time_shards)


@pytest.fixture
def no_pod_env(monkeypatch):
    for var in ("TPU_WORKER_HOSTNAMES", "MEGASCALE_COORDINATOR_ADDRESS",
                "CLOUD_TPU_TASK_ID"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture
def two_cards(monkeypatch):
    """Two visible CUDA devices as far as the mesh can tell (no tensor is
    made on them)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------


def test_default_mesh_axes_and_shapes(cpu_devices):
    m = _cpu_mesh()
    r = rmesh.default_mesh()
    assert m.axis_names == r.axis_names == (meshlib.SERIES_AXIS,)
    assert m.shape == dict(r.shape) == {"series": 8}
    m2 = _cpu_mesh(time_shards=2)
    r2 = rmesh.default_mesh(time_shards=2)
    assert m2.axis_names == r2.axis_names
    assert m2.shape == dict(r2.shape) == {"series": 4, "time": 2}
    assert m2.devices.shape == (4, 2) and m2.devices.size == 8
    assert all(d == CPU for d in m2.devices.flat)
    assert _cpu_mesh(8, 4).shape == {"series": 2, "time": 4}
    assert meshlib.default_mesh(3, devices=[CPU] * 8).shape == {"series": 3}
    with pytest.raises(ValueError, match="not divisible"):
        _cpu_mesh(6, 4)
    with pytest.raises(ValueError, match="not divisible"):
        rmesh.default_mesh(6, time_shards=4)


def test_default_mesh_lists_the_visible_cards(two_cards):
    m = meshlib.default_mesh()
    assert list(m.devices.flat) == [torch.device("cuda", 0),
                                    torch.device("cuda", 1)]
    assert meshlib.default_mesh(time_shards=2).shape == {"series": 1,
                                                         "time": 2}


def test_default_mesh_without_a_card_asks_for_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        meshlib.default_mesh()


# ---------------------------------------------------------------------------
# init_distributed and the pod probe (reference test_parallel.py l.16-42)
# ---------------------------------------------------------------------------


def test_init_distributed_single_process_returns_mesh(no_pod_env, two_cards):
    m = meshlib.init_distributed()
    assert meshlib.SERIES_AXIS in m.axis_names
    assert m.devices.size >= 1
    assert meshlib.init_distributed(num_processes=1).shape == m.shape
    assert list(meshlib.init_distributed(local_device_ids=[1])
                .devices.flat) == [torch.device("cuda", 1)]


@pytest.mark.parametrize("kw", [dict(coordinator_address="127.0.0.1:1"),
                                dict(num_processes=2, process_id=0)])
def test_init_distributed_multi_process_is_the_multi_lane_half(no_pod_env,
                                                               kw):
    # a topology the group cannot start from is refused before any
    # connection: the coordinator needs num_processes= and process_id=
    # (nothing here discovers a cluster), and several processes need the
    # coordinator's address.  A one-process gloo group on a free port
    # then starts for real and returns the mesh of its devices, tagged
    # with its rank, as the reference's single-process group does
    import socket

    import torch.distributed as dist

    with pytest.raises(ValueError, match="coordinator|num_processes"):
        meshlib.init_distributed(**kw)
    assert not dist.is_initialized()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port_no = s.getsockname()[1]
    try:
        m = meshlib.init_distributed(f"127.0.0.1:{port_no}",
                                     num_processes=1, process_id=0,
                                     devices=[torch.device("cpu")] * 2)
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert meshlib.process_count() == 1 and meshlib.process_index() == 0
        assert list(m.devices.flat) == [torch.device("cpu")] * 2
        assert meshlib.cell_processes(m) == [0, 0]
        # re-entry keeps the running group (the reference's contract)
        m2 = meshlib.init_distributed(f"127.0.0.1:{port_no}",
                                      num_processes=1, process_id=0,
                                      devices=[torch.device("cpu")] * 2)
        assert m2.shape == m.shape
        rm = rmesh.init_distributed()
        assert meshlib.SERIES_AXIS in rm.axis_names
    finally:
        dist.destroy_process_group()


def test_init_distributed_pod_env_warns_and_stays_local(no_pod_env,
                                                        two_cards,
                                                        monkeypatch):
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "h0,h1")
    with pytest.warns(UserWarning, match="single-process"):
        m = meshlib.init_distributed()
    assert m.shape == {"series": 2}


@pytest.mark.parametrize("env,want", [
    ({}, False),
    ({"TPU_WORKER_HOSTNAMES": "localhost"}, False),
    ({"TPU_WORKER_HOSTNAMES": "h0,h1"}, True),
    ({"MEGASCALE_COORDINATOR_ADDRESS": "10.0.0.1:8476"}, True),
])
def test_pod_detection_is_env_driven(no_pod_env, monkeypatch, env, want):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert meshlib._on_cloud_tpu_pod() is want
    assert rmesh._on_cloud_tpu_pod() is want


# ---------------------------------------------------------------------------
# padding, specs, placement
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 21, 24, 1000])
@pytest.mark.parametrize("m", [1, 3, 8])
def test_pad_to_multiple(n, m):
    assert meshlib.pad_to_multiple(n, m) == rmesh.pad_to_multiple(n, m)


@pytest.mark.parametrize("fn", ["series_sharding", "replicated_sharding",
                                "instant_sharding"])
@pytest.mark.parametrize("time_shards", [1, 2])
def test_sharding_specs_match_the_reference(cpu_devices, fn, time_shards):
    pm = _cpu_mesh(time_shards=time_shards)
    rm = rmesh.default_mesh(time_shards=time_shards)
    got = getattr(meshlib, fn)(pm)
    want = getattr(rmesh, fn)(rm)
    assert got.mesh is pm
    assert tuple(got.spec) == tuple(want.spec)


def test_series_devices(cpu_devices):
    assert meshlib.series_devices(_cpu_mesh(4)) == [CPU] * 4
    with pytest.raises(ValueError, match="1-D"):
        meshlib.series_devices(_cpu_mesh(8, 2))
    with pytest.raises(ValueError, match="1-D"):
        rmesh.series_devices(rmesh.default_mesh(time_shards=2))


def test_shard_series_places_without_a_copy():
    v = torch.arange(24.0).reshape(8, 3)
    assert meshlib.shard_series(v, None) is v
    out = meshlib.shard_series(v, _cpu_mesh(4))
    assert out.data_ptr() == v.data_ptr()


@pytest.mark.parametrize("chunk_rows", [2, 3, 5, 16])
def test_lane_values_blocks_are_the_rows(chunk_rows):
    rng = np.random.default_rng(3)
    y = rng.normal(size=(16, 5))
    yt = torch.as_tensor(y.copy())
    m = _cpu_mesh(4)
    spans = plan.shard_spans(16, chunk_rows, 4)
    lanes = meshlib.lane_values(yt, m, spans)
    assert [(i, lo, hi) for i, lo, hi, _, _ in lanes] == [
        (i, lo, hi) for i, (lo, hi) in enumerate(spans)]
    for _, lo, hi, dev, blk in lanes:
        assert dev == CPU
        assert np.array_equal(blk.numpy(), y[lo:hi])
        assert blk.data_ptr() == yt[lo:hi].data_ptr()  # a view, no copy
    host = meshlib.lane_values(y, m, spans)  # a host array goes to the lanes
    assert all(np.array_equal(b.numpy(), y[lo:hi])
               for _, lo, hi, _, b in host)


def test_lane_values_refuses_more_spans_than_devices():
    with pytest.raises(ValueError, match="series devices"):
        meshlib.lane_values(torch.zeros(8, 2), _cpu_mesh(2),
                            [(0, 2), (2, 4), (4, 8)])


def test_distribute_panel_blocks_feed_the_lanes():
    y = np.arange(48.0).reshape(16, 3)
    m = _cpu_mesh(4)
    blocks = meshlib.distribute_panel(y, m)
    assert [b.shape for b in blocks] == [(4, 3)] * 4
    assert np.array_equal(torch.cat(blocks).numpy(), y)
    lanes = meshlib.lane_values(blocks, m, [(0, 4), (4, 8), (8, 12),
                                            (12, 16)])
    assert all(blk is blocks[i] for i, _, _, _, blk in lanes)
    with pytest.raises(ValueError, match="chunk-grid"):
        meshlib.lane_values(blocks, m, [(0, 8), (8, 16)])
    with pytest.raises(ValueError, match="evenly"):
        meshlib.distribute_panel(y[:15], m)


# ---------------------------------------------------------------------------
# a panel on a mesh of CPU devices
# ---------------------------------------------------------------------------


def _values():
    rng = np.random.default_rng(7)
    vals = rng.normal(size=(21, 50)).cumsum(axis=1)  # 21 series pad to 24
    vals[3, 7] = np.nan
    vals[5, :4] = np.nan
    return vals


@pytest.fixture(params=[(8, 1), (8, 2)], ids=["series(8)", "series(4)xtime(2)"])
def meshes(request, cpu_devices):
    n, ts = request.param
    if ts == 1:  # the (8,) series mesh; the (4,) one is below
        return _cpu_mesh(n), rmesh.default_mesh()
    return _cpu_mesh(n, ts), rmesh.default_mesh(time_shards=ts)


def _panels(pm, rm, t=50):
    vals = _values()[:, :t]
    pidx = pix.uniform("2021-01-04", t, pix.BusinessDayFrequency(1))
    ridx = rix.uniform("2021-01-04", t, rix.BusinessDayFrequency(1))
    keys = [f"s{i}" for i in range(21)]
    return (port.TimeSeriesPanel(pidx, keys, torch.as_tensor(vals.copy()),
                                 mesh=pm),
            port.TimeSeriesPanel(pidx, keys, torch.as_tensor(vals.copy())),
            ref.TimeSeriesPanel(ridx, keys, jnp.asarray(vals), mesh=rm))


def test_panel_on_a_mesh_pads_and_matches_unsharded(meshes):
    pm, rm = meshes
    p, flat, r = _panels(pm, rm)
    n_series = pm.shape["series"]
    assert p.values.shape[0] == r.values.shape[0] == (
        meshlib.pad_to_multiple(21, n_series))
    assert p.n_series == 21 and len(p) == 21
    assert bool(torch.isnan(p.values[21:]).all())
    assert torch.equal(p.series_values().nan_to_num(7.0),
                       flat.series_values().nan_to_num(7.0))
    for name, a, b, rr in (
            ("differences", p.differences(2), flat.differences(2),
             r.differences(2)),
            ("fill", p.fill("linear"), flat.fill("linear"),
             r.fill("linear")),
            ("return_rates", p.return_rates(), flat.return_rates(),
             r.return_rates())):
        av = a.series_values().numpy()
        np.testing.assert_array_equal(av, b.series_values().numpy(),
                                      err_msg=name)
        np.testing.assert_allclose(av, np.asarray(rr.series_values()),
                                   rtol=1e-12, equal_nan=True, err_msg=name)
        assert a.mesh is pm
    for k in ("count", "mean", "stdev", "min", "max"):
        np.testing.assert_array_equal(p.series_stats()[k].numpy(),
                                      flat.series_stats()[k].numpy())
        np.testing.assert_allclose(p.series_stats()[k].numpy(),
                                   np.asarray(r.series_stats()[k]),
                                   rtol=1e-12)
    acf = p.fill("linear").autocorr(3)
    assert acf.shape == (21, 3)
    np.testing.assert_allclose(acf.numpy(),
                               np.asarray(r.fill("linear").autocorr(3)),
                               rtol=1e-10)
    dts, inst = p.to_instants()
    rdts, rinst = r.to_instants()
    assert inst.shape == (50, 21)
    np.testing.assert_array_equal(dts, rdts)
    np.testing.assert_array_equal(inst.numpy(), np.asarray(rinst))
    back = p.with_mesh(None)
    assert back.mesh is None and back.values.shape == (21, 50)


def test_panel_on_a_four_series_mesh():
    pm = _cpu_mesh(4)
    vals = _values()
    idx = pix.uniform("2021-01-04", 50, pix.BusinessDayFrequency(1))
    p = port.TimeSeriesPanel(idx, [f"s{i}" for i in range(21)],
                             torch.as_tensor(vals), mesh=pm)
    assert p.values.shape == (24, 50)
    flat = p.with_mesh(None)
    np.testing.assert_array_equal(p.differences(1).series_values().numpy(),
                                  flat.differences(1).series_values().numpy())
    np.testing.assert_array_equal(p.pacf(2).numpy(), flat.pacf(2).numpy())


def test_panel_rejects_undivisible_time(cpu_devices):
    pidx = pix.uniform("2020-01-01", 51, pix.DayFrequency(1))
    ridx = rix.uniform("2020-01-01", 51, rix.DayFrequency(1))
    keys = [f"k{i}" for i in range(4)]
    with pytest.raises(ValueError, match="time shards"):
        port.TimeSeriesPanel(pidx, keys, np.zeros((4, 51)),
                             mesh=_cpu_mesh(8, 2))
    with pytest.raises(ValueError, match="time shards"):
        ref.TimeSeriesPanel(ridx, keys, np.zeros((4, 51)),
                            mesh=rmesh.default_mesh(time_shards=2))


def test_host_values_go_to_the_mesh_device():
    idx = pix.uniform("2020-01-01", 64, pix.DayFrequency(1))
    p = port.TimeSeriesPanel(idx, [f"k{i}" for i in range(6)],
                             np.ones((6, 64)), mesh=_cpu_mesh(8, 2))
    assert p.values.shape == (8, 64) and p.values.device == CPU
