"""The port's in-process serving loop (``serving.FitServer``) against the
reference's (``tests/test_serving.py``), case for case: admission,
batching, deadlines, shedding, quarantine, crash recovery, warmth and the
Prometheus sink.  Every port server fits on ``device="cpu"`` here.

Against the reference: the same requests through both servers give the
same per-row status and parameters within the ARIMA parity bar (4e-3),
the same batch membership, and the same admission/shed/quota/deadline
outcomes and counters.  The port's own bitwise contracts: a micro-batched
tenant equals the same request served alone (ragged rows included) and a
direct ``fit_chunked(chunk_rows=cell)`` walk; a server killed by SIGKILL
mid-batch (``faultinject.server_kill``, a real subprocess) and restarted
on its root re-answers every request as an uninterrupted server does.
The subprocess worker is this file:
``python tests/test_torch_serving.py run|recover ROOT [OUT]``.
"""

import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

T = 48
CELL = 8
KW = dict(order=(1, 0, 0), max_iters=15)
FIELDS = ("params", "neg_log_likelihood", "converged", "iters", "status")
PARAM_TOL = 4e-3  # tests/test_torch_chunked.py's ARIMA parity bar
IDS = ("req-a", "req-b", "req-c")


def _panel(rows=24, seed=0):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(rows, T)).astype(np.float32)
    y = np.zeros_like(e)
    y[:, 0] = e[:, 0]
    for i in range(1, T):
        y[:, i] = 0.6 * y[:, i - 1] + e[:, i]
    return y


def _server(root, **kw):
    from spark_timeseries_tpu_torch import serving

    kw.setdefault("cell_rows", CELL)
    kw.setdefault("batch_window_s", 0.02)
    kw.setdefault("autotune", False)
    kw.setdefault("device", "cpu")
    return serving.FitServer(str(root), **kw)


def _eq(a, b, msg=""):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)),
                                      err_msg=f"{msg}: field {f}")


def _close(port, ref):
    np.testing.assert_array_equal(port.status, np.asarray(ref.status))
    fin = np.isfinite(port.params).all(1)
    np.testing.assert_allclose(port.params[fin], np.asarray(ref.params)[fin],
                               rtol=PARAM_TOL, atol=PARAM_TOL)


# the subprocess worker (kill-and-restart) ------------------------------------


def _fill(srv, y):
    return [srv.submit(t, y[i * CELL:(i + 1) * CELL], "arima",
                       request_id=rid, **KW)
            for i, (t, rid) in enumerate(zip("abc", IDS))]


def _worker(mode, root, out=None):
    from spark_timeseries_tpu_torch.reliability import faultinject as fi

    y = _panel(24)
    if mode == "run":
        # dies by SIGKILL inside the batch walk, after two durable commits
        # (shard written, manifest not yet updated: the torn window)
        srv = _server(root, _commit_hook=fi.server_kill(2, mid_commit=True))
        tickets = _fill(srv, y)
        srv.start()
        for t in tickets:
            t.result(timeout=120)
        raise SystemExit("the server was meant to die mid-batch")
    srv = _server(root)
    srv.start()
    deadline = time.monotonic() + 100
    got = {}
    while time.monotonic() < deadline and len(got) < len(IDS):
        for rid in IDS:
            try:
                got[rid] = srv.result_for(rid)
            except KeyError:
                pass
        time.sleep(0.05)
    srv.stop(timeout_s=60)
    arrays = {f"{rid}__{f}": np.asarray(getattr(r, f))
              for rid, r in got.items() for f in FIELDS}
    for rid, r in got.items():
        arrays[f"{rid}__resumed"] = np.asarray(
            r.meta["journal"]["chunks_resumed"])
    np.savez(out, **arrays)
    print(json.dumps(srv.health()["counters"]))


if __name__ == "__main__" and sys.argv[1:2] in (["run"], ["recover"]):
    _worker(*sys.argv[1:])
    raise SystemExit(0)


from spark_timeseries_tpu import serving as rserving  # noqa: E402
from spark_timeseries_tpu_torch import obs  # noqa: E402
from spark_timeseries_tpu_torch import reliability as rel  # noqa: E402
from spark_timeseries_tpu_torch import serving  # noqa: E402
from spark_timeseries_tpu_torch.models import arima  # noqa: E402
from spark_timeseries_tpu_torch.obs import promsink  # noqa: E402
from spark_timeseries_tpu_torch.reliability import faultinject as fi  # noqa: E402
from spark_timeseries_tpu_torch.reliability import watchdog  # noqa: E402
from spark_timeseries_tpu_torch.reliability.status import FitStatus  # noqa: E402
from spark_timeseries_tpu_torch.serving import batcher  # noqa: E402


@pytest.fixture(autouse=True)
def _no_pool_outlives_its_test():
    """A staging pool registers with the process-wide peak-memory probe
    while it lives; one left in cyclic garbage would show in the next
    test's journal entries (``peak_staging_pool_bytes``)."""
    yield
    gc.collect()


def _rserver(root, **kw):
    kw.setdefault("cell_rows", CELL)
    kw.setdefault("batch_window_s", 0.02)
    kw.setdefault("autotune", False)
    return rserving.FitServer(str(root), **kw)


# -- batching ----------------------------------------------------------------


def test_batched_equals_solo_direct_and_reference(tmp_path):
    y = _panel(24)
    srv = _server(tmp_path / "batched")
    t1 = srv.submit("a", y[:8], "arima", **KW)
    t2 = srv.submit("b", torch.as_tensor(y[8:16]), "arima", **KW)
    t3 = srv.submit("c", y[16:21], "arima", **KW)  # ragged: 5 rows
    srv.start()
    r1, r2, r3 = (t.result(timeout=300) for t in (t1, t2, t3))
    srv.stop()
    assert r1.meta["batch_members"] == 3
    assert r3.params.shape[0] == 5
    with _server(tmp_path / "solo") as srv2:
        s1 = srv2.submit("a", y[:8], "arima", **KW).result(timeout=300)
        s3 = srv2.submit("c", y[16:21], "arima", **KW).result(timeout=300)
    _eq(r1, s1, "batched vs solo (aligned member)")
    _eq(r3, s3, "batched vs solo (ragged member)")
    direct = rel.fit_chunked(arima.fit, torch.as_tensor(y[:8]),
                             chunk_rows=CELL, resilient=False,
                             align_mode="dense", device="cpu", **KW)
    _eq(r1, direct, "batched vs direct fit_chunked")
    rs = _rserver(tmp_path / "ref")
    w = [rs.submit(t, v, "arima", **KW)
         for t, v in (("a", y[:8]), ("b", y[8:16]), ("c", y[16:21]))]
    rs.start()
    want = [t.result(timeout=300) for t in w]
    rs.stop()
    assert want[0].meta["batch_members"] == 3
    for got, ref in zip((r1, r2, r3), want):
        _close(got, ref)
        assert got.meta["status_counts"] == ref.meta["status_counts"]


def test_incompatible_keys_do_not_coalesce(tmp_path):
    y = _panel(16)
    srv = _server(tmp_path / "s")
    ta = srv.submit("a", y[:8], "arima", order=(1, 0, 0), max_iters=15)
    tb = srv.submit("b", y[8:], "arima", order=(0, 0, 1), max_iters=15)
    srv.start()
    ra, rb = ta.result(timeout=300), tb.result(timeout=300)
    srv.stop()
    assert ra.meta["batch_members"] == rb.meta["batch_members"] == 1
    assert ra.meta["batch_id"] != rb.meta["batch_id"]


def test_sharded_walk_composes(tmp_path):
    from spark_timeseries_tpu_torch.parallel import mesh as meshlib

    y = _panel(16)
    mesh = meshlib.default_mesh(devices=[torch.device("cpu")] * 2)
    srv = _server(tmp_path / "sh", walk_kwargs={"mesh": mesh})
    ta = srv.submit("a", y[:8], "arima", **KW)
    tb = srv.submit("b", y[8:], "arima", **KW)
    srv.start()
    ra, rb = ta.result(timeout=300), tb.result(timeout=300)
    srv.stop()
    with _server(tmp_path / "nosh") as srv2:
        sa = srv2.submit("a", y[:8], "arima", **KW).result(timeout=300)
    _eq(ra, sa, "sharded server batch vs unsharded solo")


# -- deadlines ----------------------------------------------------------------


def test_expired_in_queue_returns_timeout_rows(tmp_path):
    y = _panel(8)
    got = []
    for mk, root in ((_server, "p"), (_rserver, "r")):
        srv = mk(tmp_path / root)
        t = srv.submit("a", y, "arima", deadline_s=0.001, **KW)
        time.sleep(0.05)
        srv.start()
        res = t.result(timeout=60)
        srv.stop()
        assert (np.asarray(res.status) == FitStatus.TIMEOUT).all()
        assert np.isnan(np.asarray(res.params)).all()
        assert res.meta["deadline_expired"] is True
        got.append(srv.health()["counters"])
    assert got[0]["deadline_expired"] == got[1]["deadline_expired"] == 1


def test_straggling_batch_times_out_never_hangs(tmp_path):
    import threading

    y = _panel(8)
    slow = fi.slow_tenant(arima.fit, "slowpoke", 3.0)
    done = threading.Event()

    def tracked(yb, **kw):
        try:
            return slow(yb, **kw)
        finally:
            done.set()

    srv = _server(tmp_path / "s", models={"slow": tracked},
                  chunk_budget_s=0.3)
    t = srv.submit("slowpoke", y, "slow", **KW)
    srv.start()
    res = t.result(timeout=120)
    srv.stop(timeout_s=60)
    assert (res.status == FitStatus.TIMEOUT).all()
    assert srv.health()["counters"]["timeout_requests"] == 1
    # the abandoned fit runs on in the watchdog's worker: let it end, so
    # its staged chunk (and pool) does not outlive the test
    assert done.wait(30)


def test_slow_tenant_targets_only_its_batches(tmp_path):
    y = _panel(16)
    slow = fi.slow_tenant(arima.fit, "slowpoke", 30.0)
    srv = _server(tmp_path / "s", models={"slow": slow}, chunk_budget_s=10.0)
    t = srv.submit("healthy", y[:8], "slow", **KW)
    srv.start()
    res = t.result(timeout=120)
    srv.stop()
    assert not (res.status == FitStatus.TIMEOUT).any()


# -- admission control ---------------------------------------------------------


def test_queue_full_rejects_with_retry_after(tmp_path):
    y = _panel(8)
    srv = _server(tmp_path / "s", max_queue_rows=16)
    srv.submit("a", y, "arima", **KW)
    srv.submit("b", y, "arima", **KW)
    with pytest.raises(serving.RejectedError) as ei:
        srv.submit("c", y, "arima", **KW)
    assert ei.value.retry_after_s > 0 and ei.value.shed is False
    assert srv.state() in ("starting", "degraded")
    assert srv.health()["counters"]["rejected"] == 1
    assert len(os.listdir(os.path.join(srv.root, "requests"))) == 2
    srv.start()
    srv.stop()


def test_priority_sheds_lowest_first_as_in_reference(tmp_path):
    y = _panel(8)
    for mk, root, err in ((_server, "p", serving.RejectedError),
                          (_rserver, "r", rserving.RejectedError)):
        srv = mk(tmp_path / root, max_queue_rows=16)
        t_low1 = srv.submit("a", y, "arima", priority=0, **KW)
        t_low2 = srv.submit("b", y, "arima", priority=0, **KW)
        t_high = srv.submit("vip", y, "arima", priority=5, **KW)
        assert t_low2.done()
        with pytest.raises(err) as ei:
            t_low2.result()
        assert ei.value.shed is True
        assert not t_low1.done()
        srv.start()
        res = t_high.result(timeout=300)
        assert (np.asarray(res.status) == FitStatus.OK).any()
        srv.stop()
        assert srv.health()["counters"]["shed"] == 1


def test_tenant_quota_and_request_cap(tmp_path):
    y = _panel(8)
    srv = _server(tmp_path / "s", max_inflight_per_tenant=1)
    srv.submit("a", y, "arima", **KW)
    with pytest.raises(serving.RejectedError) as ei:
        srv.submit("a", y, "arima", **KW)
    assert "quota" in str(ei.value)
    assert srv.health()["counters"]["rejected"] == 1
    srv.submit("b", y, "arima", **KW)
    srv.start()
    assert srv.state() == "degraded"
    srv.stop()
    capped = _server(tmp_path / "c", max_rows_per_request=8)
    with pytest.raises(serving.RejectedError):
        capped.submit("a", _panel(16), "arima", **KW)


def test_request_storm_conserves_every_request(tmp_path):
    y = _panel(8)
    srv = _server(tmp_path / "s", max_queue_rows=32, batch_window_s=0.0)
    srv.start()
    calls = [((f"t{i}", y, "arima"), dict(KW)) for i in range(12)]
    tickets, errors = fi.request_storm(srv.submit, calls, threads=6)
    for tk, err in zip(tickets, errors):
        assert (tk is None) != (err is None)
        if err is not None:
            assert isinstance(err, serving.RejectedError)
    done = [tk.result(timeout=300) for tk in tickets if tk is not None]
    assert done and all(r.params.shape[0] == 8 for r in done)
    srv.stop()
    c = srv.health()["counters"]
    assert c["admitted"] == len(done)
    assert c["admitted"] + c["rejected"] + c["shed"] == 12


def test_cancel_closed_and_bad_requests(tmp_path):
    y = _panel(8)
    srv = _server(tmp_path / "s")
    t1 = srv.submit("a", y, "arima", **KW)
    t2 = srv.submit("b", y, "arima", **KW)
    assert t2.cancel() is True
    with pytest.raises(serving.CancelledError):
        t2.result()
    with pytest.raises(ValueError, match="unknown model"):
        srv.submit("a", y, "nosuchmodel")
    with pytest.raises(TypeError, match="JSON-serializable"):
        srv.submit("a", y, "arima", order=(1, 0, 0),
                   init_params=np.zeros((8, 3)))
    with pytest.raises(TypeError, match="registered by name"):
        srv.submit("a", y, arima.fit)
    with pytest.raises(ValueError, match="non-empty"):
        srv.submit("a", np.zeros((4, 0), np.float32), "arima", **KW)
    srv.start()
    t1.result(timeout=300)
    srv.stop()
    assert srv.health()["counters"]["cancelled"] == 1
    with pytest.raises(KeyError):
        srv.result_for(t2.req_id)
    with pytest.raises(serving.ServerClosedError):
        srv.submit("a", y, "arima", **KW)


def test_drain_stop_rejects_a_racing_offer(tmp_path):
    srv = _server(tmp_path / "s")
    t = srv.submit("a", _panel(8), "arima", **KW)
    srv.stop(drain=True)
    assert t.done()
    with pytest.raises(serving.ServerClosedError):
        t.result()
    assert len(os.listdir(os.path.join(srv.root, "requests"))) == 1


def test_max_batch_rows_bounds_the_padded_panel(tmp_path):
    y = _panel(16)
    srv = _server(tmp_path / "s", max_batch_rows=12)
    t1 = srv.submit("a", y[:5], "arima", **KW)
    t2 = srv.submit("b", y[8:13], "arima", **KW)
    srv.start()
    r1, r2 = t1.result(timeout=300), t2.result(timeout=300)
    srv.stop()
    assert r1.meta["batch_members"] == r2.meta["batch_members"] == 1


# -- quarantine -----------------------------------------------------------------


def test_poison_tenant_isolated_by_solo_retry(tmp_path):
    y = _panel(16)

    def poison_fit(yb, **kwargs):
        if "poison" in (watchdog.current_request() or ()):
            raise ValueError("poisoned panel blew up the walk")
        return arima.fit(yb, **kwargs)

    srv = _server(tmp_path / "s", models={"m": poison_fit})
    tp = srv.submit("poison", y[:8], "m", **KW)
    tg = srv.submit("good", y[8:], "m", **KW)
    srv.start()
    rg = tg.result(timeout=300)
    with pytest.raises(ValueError, match="poisoned"):
        tp.result(timeout=300)
    r_after = srv.submit("later", y[:8], "m", **KW).result(timeout=300)
    srv.stop()
    c = srv.health()["counters"]
    assert c["batch_failures"] >= 1 and c["solo_retries"] == 2
    assert (r_after.status == FitStatus.OK).any()
    with _server(tmp_path / "ref") as srv2:
        ref = srv2.submit("good", y[8:], "arima", **KW).result(timeout=300)
    _eq(rg, ref, "quarantine solo retry vs solo fit")


# -- crash recovery ---------------------------------------------------------------


def test_crash_mid_batch_resumes_bitwise(tmp_path):
    y = _panel(24)
    srv = _server(tmp_path / "crash", _commit_hook=fi.crash_after_commits(1))
    tickets = _fill(srv, y)
    srv.start()
    with pytest.raises(serving.ServerClosedError):
        tickets[0].result(timeout=120)
    assert srv.state() == "crashed"
    srv.stop()
    assert srv.state() == "crashed"
    assert len(os.listdir(os.path.join(srv.root, "requests"))) == 3
    srv2 = _server(tmp_path / "crash", max_inflight_per_tenant=1)
    srv2.start()
    got = [srv2.result_for(rid) for rid in IDS]
    assert srv2.quota.snapshot() == {}
    srv2.stop()
    c = srv2.health()["counters"]
    assert c["recovered_batches"] == 1 and c["recovered_requests"] == 3
    assert got[0].meta["journal"]["chunks_resumed"] == 1
    srv3 = _server(tmp_path / "ref")
    ref = _fill(srv3, y)
    srv3.start()
    for g, t in zip(got, ref):
        _eq(g, t.result(timeout=300), "recovered vs uninterrupted")
    srv3.stop()


def test_admitted_but_unbatched_requests_recover_and_dedupe(tmp_path):
    y = _panel(16)
    srv = _server(tmp_path / "s")
    srv.submit("a", y[:8], "arima", request_id="ov-1", **KW)
    srv.submit("b", y[8:], "arima", request_id="ov-2", **KW)
    reqs = dict(srv._live)
    knobs = dict(srv._knobs)
    # the post-crash layout of a quarantine: the 2-member record plus a
    # solo record naming ov-1 again — each request must run exactly once
    batcher.pack([reqs["ov-1"], reqs["ov-2"]], 1,
                 cell_rows=CELL).save_members(srv.root, knobs)
    batcher.pack([reqs["ov-1"]], 2, cell_rows=CELL).save_members(srv.root,
                                                                  knobs)
    del srv
    srv2 = _server(tmp_path / "s")
    srv2.start()
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        try:
            r1 = srv2.result_for("ov-1")
            srv2.result_for("ov-2")
            break
        except KeyError:
            time.sleep(0.05)
    srv2.stop()
    c = srv2.health()["counters"]
    assert c["completed"] == 2 and c["recovered_requests"] == 2
    t = _server(tmp_path / "s2")
    t.start()
    again = t.submit("a", y[:8], "arima", request_id="dup", **KW)
    first = again.result(timeout=300)
    assert t.submit("a", y[:8], "arima", request_id="dup", **KW).done()
    t.stop()
    _eq(first, r1, "recovered vs fresh")


def test_sigkill_mid_batch_and_restart_reanswer_bitwise(tmp_path):
    root = str(tmp_path / "killed")
    os.makedirs(root)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    me = os.path.abspath(__file__)
    run = subprocess.run([sys.executable, me, "run", root], env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == -9, run.stderr  # SIGKILL, not an exit
    assert len(os.listdir(os.path.join(root, "requests"))) == 3
    out = str(tmp_path / "recovered.npz")
    rec = subprocess.run([sys.executable, me, "recover", root, out], env=env,
                         capture_output=True, text=True, timeout=120)
    assert rec.returncode == 0, rec.stderr
    counters = json.loads(rec.stdout.strip().splitlines()[-1])
    assert counters["recovered_batches"] == 1
    z = np.load(out)
    assert int(z["req-a__resumed"]) >= 1
    srv = _server(tmp_path / "ref")
    ref = _fill(srv, _panel(24))
    srv.start()
    for rid, t in zip(IDS, ref):
        r = t.result(timeout=300)
        for f in FIELDS:
            np.testing.assert_array_equal(z[f"{rid}__{f}"],
                                          np.asarray(getattr(r, f)),
                                          err_msg=f"{rid} {f}")
    srv.stop()


# -- forecasts, auto requests, warmth, observability ---------------------------


def test_submit_forecast_equals_the_local_walk(tmp_path):
    from spark_timeseries_tpu_torch import forecasting

    y = _panel(16)
    fit = rel.fit_chunked(arima.fit, torch.as_tensor(y), chunk_rows=CELL,
                          resilient=False, device="cpu", **KW)
    with _server(tmp_path / "s") as srv:
        t1 = srv.submit_forecast("a", y[:8], fit.params[:8], model="arima",
                                 horizon=6, model_kwargs={"order": (1, 0, 0)})
        t2 = srv.submit_forecast("b", y[8:], fit.params[8:], model="arima",
                                 horizon=6, model_kwargs={"order": (1, 0, 0)},
                                 intervals=True, n_samples=32, seed=5)
        f1 = forecasting.as_result(t1.result(timeout=300), 6, False)
        f2 = forecasting.as_result(t2.result(timeout=300), 6, True)
    local = forecasting.forecast_chunked(
        "arima", fit.params[:8], torch.as_tensor(y[:8]), 6,
        model_kwargs={"order": (1, 0, 0)}, device="cpu")
    np.testing.assert_array_equal(f1.forecast, local.forecast)
    local2 = forecasting.forecast_chunked(
        "arima", fit.params[8:], torch.as_tensor(y[8:]), 6,
        model_kwargs={"order": (1, 0, 0)}, intervals=True, n_samples=32,
        seed=5, device="cpu")
    for f in ("forecast", "lo", "hi"):
        np.testing.assert_array_equal(getattr(f2, f), getattr(local2, f))


def test_pool_warmth_autotune_and_advisor(tmp_path):
    y = _panel(8)
    srv = _server(tmp_path / "s", batch_window_s=0.0)
    srv.start()
    srv.submit("a", y, "arima", **KW).result(timeout=300)
    pool1 = sum(p["pool_hits"]
                for p in srv.health()["staging_pools"].values())
    for _ in range(2):
        srv.submit("a", y, "arima", **KW).result(timeout=300)
    h = srv.health()
    srv.stop()
    assert len(h["staging_pools"]) == 1
    assert sum(p["pool_hits"] for p in h["staging_pools"].values()) > pool1
    auto = _server(tmp_path / "t", autotune=True, batch_window_s=0.0)
    assert auto._advise is not None  # the package's own advisor copy
    auto._advise = lambda m: {"suggest": {"chunk_rows": 4,
                                          "pipeline_depth": 3}}
    auto.start()
    auto.submit("a", y, "arima", **KW).result(timeout=300)
    deadline = time.monotonic() + 30
    while (auto.health()["knobs"]["cell_rows"] != 4
           and time.monotonic() < deadline):
        time.sleep(0.02)
    auto.stop()
    assert auto.health()["knobs"]["cell_rows"] == 4
    assert auto.health()["counters"]["autotune_updates"] == 1
    assert _server(tmp_path / "t", autotune=True)._knobs["cell_rows"] == 4


def test_health_states_prom_sink_and_server_json(tmp_path):
    y = _panel(8)
    jsonl = str(tmp_path / "events.jsonl")
    prom = str(tmp_path / "fits.prom")
    obs.enable(jsonl)
    try:
        srv = _server(tmp_path / "s", prom_path=prom, prom_interval_s=0.0,
                      max_queue_rows=8)
        assert srv.state() == "starting"
        srv.start()
        assert srv.state() == "ready" and srv.ready()
        srv.submit("a", y, "arima", **KW).result(timeout=300)
        with pytest.raises(serving.RejectedError):
            srv.submit("big", _panel(16), "arima", **KW)
        assert srv.state() == "degraded"
        srv.stop()
        assert srv.state() == "stopped"
    finally:
        obs.disable()
    text = open(prom).read()
    for name in ("ststpu_server_queue_rows", "ststpu_server_admitted_total",
                 "ststpu_server_batches"):
        assert name in text
    assert promsink.validate_textfile(prom) == []
    sj = json.load(open(os.path.join(srv.root, "server.json")))
    assert sj["counters"]["completed"] == 1
    # the reference's advisor reads the port's serving root
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, os.path.join(repo, "tools", "advise_budget.py"),
         srv.root], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "cell_rows" in out.stdout


def test_admission_queue_units_match_reference():
    def req(mod, rid, rows=8, priority=0, seq=0):
        return mod.FitRequest(rid, seq, "t", _panel(rows), "arima", {},
                              priority=priority)

    for mod in (serving, rserving):
        q = mod.AdmissionQueue(max_queue_rows=24, max_queue_requests=99)
        for rid, pr, seq in (("r1", 1, 1), ("r2", 0, 2), ("r3", 0, 3)):
            q.offer(req(mod, rid, priority=pr, seq=seq))
        shed = []
        q.offer(req(mod, "r4", priority=2, seq=4),
                on_shed=lambda r: shed.append(r.req_id))
        assert shed == ["r3"]
        q2 = mod.AdmissionQueue(max_queue_rows=999, max_queue_requests=99)
        a, b, c = (req(mod, n, seq=i) for i, n in enumerate("abc"))
        b.fit_kwargs = {"order": [2, 0, 0]}
        for r in (a, b, c):
            q2.offer(r)
        got = q2.take_batch(mod.batch_key, max_rows=64, window_s=0,
                            timeout_s=1)
        assert [r.req_id for r in got] == ["a", "c"]
