"""The port's replica fleet (``serving.fleet``) and its lease election
against the reference's (``tests/test_fleet.py``).  Every replica's
``FitServer`` fits on ``device="cpu"`` here (``server_kwargs``).

- The election seats exactly one winner: eight racers in six rounds, and
  a deterministic interleaving in which a second racer reads the claims
  only after the first has linked ``claim_1`` (one read of the highest
  claim a round: the reference reads it twice and seats two winners).
- A fleet primary answers bit for bit what a standalone port server
  answers, and within the ARIMA parity bar (4e-3) what a reference server
  answers; a takeover after the primary crashed mid-batch re-answers the
  in-flight request bit for bit; standbys read durable results and serve
  forecasts from their scratch root bit for bit; the degradation ladder,
  torn results and ``STATE_CODES`` are the reference's.
- A fenced primary's batch ends its walk and the replica demotes as
  fenced, never retrying the batch solo.
- A real SIGKILL: two replica processes on one root, the primary killed
  mid-commit, the survivor re-answers every request bit for bit.  The
  worker is this file: ``python tests/test_torch_fleet.py replica ROOT
  OWNER TTL [KILL_COMMITS]``.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

T = 96
CELL = 8
KW = dict(order=(1, 0, 0), max_iters=15)
FIELDS = ("params", "neg_log_likelihood", "converged", "iters", "status")
PARAM_TOL = 4e-3  # tests/test_torch_chunked.py's ARIMA parity bar
SRV_KW = dict(cell_rows=CELL, batch_window_s=0.02, autotune=False,
              device="cpu")


def _panel(rows=8, seed=0):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(rows, T)).astype(np.float32)
    y = np.zeros_like(e)
    y[:, 0] = e[:, 0]
    for i in range(1, T):
        y[:, i] = 0.6 * y[:, i - 1] + e[:, i]
    return y


# the subprocess worker --------------------------------------------------


def _replica(root, owner, ttl, kill_commits=None):
    from spark_timeseries_tpu_torch.reliability import faultinject as fi
    from spark_timeseries_tpu_torch.serving.fleet import FleetReplica

    kw = dict(SRV_KW, batch_window_s=0.05)
    if kill_commits is not None:
        kw["_commit_hook"] = fi.server_kill(int(kill_commits),
                                            mid_commit=True)
    rep = FleetReplica(root, owner=owner, ttl_s=float(ttl), server_kwargs=kw)
    rep.start()
    stop = os.path.join(root, f"stop_{owner}")
    while not os.path.exists(stop):
        time.sleep(0.05)
    rep.stop()
    print(json.dumps({"role": rep.role(), **rep.counters}))


if __name__ == "__main__" and sys.argv[1:2] == ["replica"]:
    _replica(*sys.argv[2:])
    raise SystemExit(0)


from spark_timeseries_tpu import serving as rserving  # noqa: E402
from spark_timeseries_tpu.reliability import journal as rjournal  # noqa: E402
from spark_timeseries_tpu_torch import serving  # noqa: E402
from spark_timeseries_tpu_torch.reliability import faultinject as fi  # noqa: E402
from spark_timeseries_tpu_torch.reliability import journal  # noqa: E402
from spark_timeseries_tpu_torch.reliability.journal import (  # noqa: E402
    FencedError, acquire_lease, read_lease)
from spark_timeseries_tpu_torch.serving.client import FitClient  # noqa: E402
from spark_timeseries_tpu_torch.serving.fleet import (  # noqa: E402
    STATE_CODES, FleetReplica, _FencedFitServer, advertise_endpoint,
    discover_endpoints, withdraw_endpoint)
from spark_timeseries_tpu_torch.serving.transport import (  # noqa: E402
    NotLeaderError, ReadOnlyError)


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


def _standalone(root, y, req_id):
    with serving.FitServer(str(root), **SRV_KW) as srv:
        return srv.submit("a", y, "arima", request_id=req_id,
                          **KW).result(timeout=600)


# -- the election ------------------------------------------------------------


def test_contended_acquire_one_winner(tmp_path):
    for rnd in range(6):
        root = str(tmp_path / f"round{rnd}")
        wins = []
        barrier = threading.Barrier(8)

        def race(owner):
            barrier.wait()
            lease = acquire_lease(root, owner, ttl_s=5.0)
            if lease is not None:
                wins.append(lease)

        ts = [threading.Thread(target=race, args=(f"o{i}",))
              for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert len(wins) == 1, [w.owner for w in wins]
        wins[0].check()
        assert journal.highest_claim(root) == 1


@pytest.mark.parametrize("mod,winners", [(journal, 1), (rjournal, 2)],
                         ids=["port", "reference"])
def test_interleaved_election(tmp_path, monkeypatch, mod, winners):
    """Racer D reads the claims; racer A links ``claim_1`` before D's read
    returns.  One read a round loses D ``claim_1``; the reference's second
    read hands D ``claim_2``, a second winner (A is fenced at once)."""
    root = str(tmp_path)
    real = mod.highest_claim
    armed = [True]
    wins = []

    def highest_claim(r):
        top = real(r)
        if armed[0]:
            armed[0] = False
            wins.append(mod.acquire_lease(r, "A", ttl_s=5.0))
        return top

    monkeypatch.setattr(mod, "highest_claim", highest_claim)
    wins.append(mod.acquire_lease(root, "D", ttl_s=5.0))
    monkeypatch.setattr(mod, "highest_claim", real)
    seated = [w for w in wins if w is not None]
    assert len(seated) == winners, [w.owner for w in seated]
    assert seated[0].owner == "A" and seated[0].token == 1
    if winners == 1:
        seated[0].check()
        assert mod.highest_claim(root) == 1


def test_lease_records_and_fencing(tmp_path):
    root = str(tmp_path / "a")
    lease = acquire_lease(root, "a", ttl_s=5.0)
    assert lease is not None and lease.token == 1
    assert acquire_lease(root, "b", ttl_s=5.0) is None
    assert read_lease(root)["owner"] == "a"
    lease.release()
    b = acquire_lease(root, "b", ttl_s=5.0)
    assert b is not None and b.token == 2
    with pytest.raises(FencedError):
        lease.check()
    root = str(tmp_path / "b")
    a = acquire_lease(root, "a", ttl_s=0.2)
    time.sleep(0.5)  # no heartbeat: the lease expires
    # the reference takes over the port's root
    b = rjournal.acquire_lease(root, "b", ttl_s=5.0)
    assert b is not None and b.token == a.token + 1
    with pytest.raises(FencedError):
        a.heartbeat()
    a.release()
    assert read_lease(root)["owner"] == "b"
    with open(journal._claim_path(root, 2), "rb") as f:
        claim = json.load(f)
    assert set(claim) == {"token", "owner", "ttl_s", "claimed_at"}


def test_fenced_store_refuses_to_splice(tmp_path):
    zombie = acquire_lease(str(tmp_path), "zombie", ttl_s=0.2)
    srv = _FencedFitServer(str(tmp_path / "srv"), zombie, **SRV_KW)
    time.sleep(0.5)
    assert acquire_lease(str(tmp_path), "new", ttl_s=5.0) is not None
    res = serving.TenantFitResult(
        params=np.zeros((2, 2), np.float32),
        neg_log_likelihood=np.zeros(2, np.float32),
        converged=np.ones(2, bool), iters=np.zeros(2, np.int32),
        status=np.zeros(2, np.int8), meta={})
    with pytest.raises(FencedError):
        srv._store_result("r1", res)
    with pytest.raises(FencedError):
        srv.profiles.fence()


def test_fenced_batch_ends_the_walk_and_crashes(tmp_path):
    zombie = acquire_lease(str(tmp_path), "zombie", ttl_s=0.2)
    srv = _FencedFitServer(str(tmp_path / "srv"), zombie, **SRV_KW)
    time.sleep(0.5)
    assert acquire_lease(str(tmp_path), "new", ttl_s=5.0) is not None
    tickets = [srv.submit(t, _panel(8, seed=i), "arima", request_id=t, **KW)
               for i, t in enumerate(("f-1", "f-2"))]
    srv.start(wait_ready=False)
    for t in tickets:
        with pytest.raises(serving.ServerClosedError):
            t.result(timeout=300)
    assert srv.state() == "crashed"
    assert isinstance(srv._crash_error, FencedError)
    assert srv.counters["solo_retries"] == 0
    assert srv.counters["batch_failures"] == 0
    # the requests stay durable for the lease holder to re-answer
    assert sorted(os.listdir(str(tmp_path / "srv" / "requests"))) == [
        "f-1.npz", "f-2.npz"]
    srv.stop(drain=False)


def test_advertise_discover_withdraw(tmp_path):
    root = str(tmp_path)
    assert discover_endpoints(root) == []
    advertise_endpoint(root, "r2", "127.0.0.1", 7002)
    advertise_endpoint(root, "r1", "127.0.0.1", 7001)
    assert discover_endpoints(root) == [("127.0.0.1", 7001),
                                        ("127.0.0.1", 7002)]
    with open(os.path.join(root, "endpoints", "r1.json"), "rb") as f:
        assert json.loads(f.read())["port"] == 7001
    withdraw_endpoint(root, "r1")
    assert discover_endpoints(root) == [("127.0.0.1", 7002)]
    withdraw_endpoint(root, "r1")


# -- election and serving, in process ----------------------------------------


def test_primary_bitwise_standby_reads_and_forecasts(tmp_path):
    y = _panel(8)
    want = _standalone(tmp_path / "ref", y, "q-1")
    with rserving.FitServer(str(tmp_path / "rref"), cell_rows=CELL,
                            batch_window_s=0.02, autotune=False) as rs:
        _close(want, rs.submit("a", y, "arima", request_id="q-1",
                               **KW).result(timeout=600))
    root = str(tmp_path / "fleet")
    with FleetReplica(root, owner="r1", ttl_s=2.0,
                      server_kwargs=SRV_KW) as r1:
        assert r1.wait_role("primary", 60), r1.role()
        with FleetReplica(root, owner="r2", ttl_s=2.0,
                          server_kwargs=SRV_KW) as r2:
            assert r2.wait_role("standby", 10) and r2.state() == "standby"
            with FitClient(discover_endpoints(root), seed=1,
                           deadline_s=600.0) as cli:
                got = cli.submit("a", y, "arima", request_id="q-1",
                                 **KW).result(timeout=600)
                _eq(got, want, "fleet primary vs standalone")
                _eq(cli.submit("a", y, "arima", request_id="q-1",
                               **KW).result(timeout=600), got, "resubmit")
                fc_primary = cli.submit_forecast(
                    "a", y, got, horizon=4, model_kwargs={"order": (1, 0, 0)},
                    request_id="fc-p").result(timeout=600)
            with FitClient([r2.address], seed=2, deadline_s=60.0) as cli2:
                _eq(cli2.result_for("q-1", timeout=60), want, "standby poll")
                # a standby computes forecasts on its scratch root
                fc_standby = cli2.submit_forecast(
                    "a", y, got, horizon=4, model_kwargs={"order": (1, 0, 0)},
                    request_id="fc-s").result(timeout=600)
                # and answers an already stored one from the shared root
                fc_stored = cli2.submit_forecast(
                    "a", y, got, horizon=4, model_kwargs={"order": (1, 0, 0)},
                    request_id="fc-p").result(timeout=600)
            _eq(fc_standby, fc_primary, "standby forecast read")
            _eq(fc_stored, fc_primary, "stored forecast read")
            # the poll of q-1, the two forecast submits, and the poll of
            # the stored forecast's durable file
            assert r2.counters["standby_reads"] == 4
            assert os.path.isdir(os.path.join(root, "standby_scratch", "r2"))
            with pytest.raises(NotLeaderError, match="r1"):
                r2.submit("a", y, "arima", request_id="q-x", **KW)
            h = r2.health()
            assert (h["role"], h["state"]) == ("standby", "standby")
            assert r1.health()["server"]["state"] in ("ready", "degraded")


def test_takeover_reanswers_inflight_bitwise(tmp_path):
    y = _panel(8, seed=3)
    want = _standalone(tmp_path / "ref", y, "k-1")
    root = str(tmp_path / "fleet")
    a = FleetReplica(root, owner="a", ttl_s=1.0, retire_on_crash=True,
                     server_kwargs=dict(
                         SRV_KW, _commit_hook=fi.crash_after_commits(1)))
    b = FleetReplica(root, owner="b", ttl_s=1.0, server_kwargs=SRV_KW)
    try:
        a.start()
        assert a.wait_role("primary", 60), a.role()
        b.start()
        with FitClient(discover_endpoints(root), seed=3,
                       deadline_s=600.0) as cli:
            got = cli.submit("a", y, "arima", request_id="k-1",
                             **KW).result(timeout=600)
        _eq(got, want, "takeover re-answer vs uninterrupted")
        assert got.meta["journal"]["chunks_resumed"] >= 1
        assert a.wait_role("retired", 60), a.role()
        assert b.wait_role("primary", 60), b.role()
        assert a.counters["crash_demotions"] == 1
        assert b.counters["elections"] == 1
        rec = read_lease(root)
        assert rec["owner"] == "b" and rec["token"] == 2
    finally:
        a.stop()
        b.stop()


def test_stop_hands_over_cleanly(tmp_path):
    root = str(tmp_path)
    a = FleetReplica(root, owner="a", ttl_s=1.0, server_kwargs=SRV_KW)
    b = FleetReplica(root, owner="b", ttl_s=1.0, server_kwargs=SRV_KW)
    a.start()
    assert a.wait_role("primary", 60)
    b.start()
    tok_a = a.lease_token()
    a.stop()
    assert b.wait_role("primary", 60), b.role()
    assert b.lease_token() > tok_a
    b.stop()
    assert b.role() == "stopped" and b.state() == "stopped"
    assert discover_endpoints(root) == []


def test_fenced_primary_demotes_as_fenced(tmp_path):
    root = str(tmp_path)
    a = FleetReplica(root, owner="a", ttl_s=30.0, server_kwargs=SRV_KW)
    try:
        a.start()
        assert a.wait_role("primary", 60)
        # a higher claim lands behind the holder's back (a successor that
        # judged it dead): its next fenced write must end the walk
        os.link(journal._claim_path(root, 1), journal._claim_path(root, 2))
        tk = a.submit("a", _panel(8, seed=4), "arima", request_id="z-1",
                      **KW)
        with pytest.raises(serving.ServerClosedError):
            tk.result(timeout=300)
        deadline = time.monotonic() + 60
        while a.counters["fenced_demotions"] < 1 and \
                time.monotonic() < deadline:
            time.sleep(0.02)
        assert a.counters["fenced_demotions"] == 1
        assert a.counters["crash_demotions"] == 0
    finally:
        a.stop(timeout_s=60)


# -- the degradation ladder --------------------------------------------------


def test_leaderless_window_serves_reads_refuses_writes(tmp_path):
    y = _panel(seed=31)
    want = _standalone(tmp_path / "ref", y, "ro-1")
    root = str(tmp_path / "fleet")
    with FleetReplica(root, owner="p", ttl_s=1.0,
                      server_kwargs=SRV_KW) as p:
        assert p.wait_role("primary", 60) and p.state() == "full"
        got = p.submit("acme", y, "arima", request_id="ro-1",
                       **KW).result(timeout=600)
    _eq(got, want, "fleet primary vs standalone")
    r = FleetReplica(root, owner="r", ttl_s=1.0, server_kwargs=SRV_KW)
    assert r.state() == "read_only"
    _eq(r.result_for("ro-1"), want, "leaderless durable read")
    assert r.counters["standby_reads"] == 1
    with pytest.raises(ReadOnlyError) as exc:
        r.submit("acme", y, "arima", request_id="ro-2", **KW)
    assert exc.value.retry_after_s > 0


def test_standby_under_live_leader_redirects_not_read_only(tmp_path):
    root = str(tmp_path)
    assert acquire_lease(root, "ghost", ttl_s=30.0) is not None
    with FleetReplica(root, owner="s", ttl_s=30.0,
                      server_kwargs=SRV_KW) as s:
        assert s.wait_role("standby", 10) and s.state() == "standby"
        with pytest.raises(NotLeaderError, match="ghost"):
            s.submit("acme", _panel(seed=2), "arima", request_id="nl-1",
                     **KW)


def test_storage_degraded_sits_out_elections_still_reads(tmp_path):
    root = str(tmp_path)
    a = FleetReplica(root, owner="a", ttl_s=0.5, server_kwargs=SRV_KW)
    a.start()
    with FleetReplica(root, owner="b", ttl_s=0.5, server_kwargs=SRV_KW,
                      storage_cooldown_s=60.0) as b:
        assert a.wait_role("primary", 60)
        want = a.submit("acme", _panel(seed=3), "arima", request_id="sd-1",
                        **KW).result(timeout=600)
        b._note_storage_degraded("injected: EIO on shared root")
        assert b.state() == "storage_degraded"
        assert b.health()["storage_degraded"]
        a.stop()
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            assert b.role() == "standby", b.role()
            time.sleep(0.05)
        assert b.counters["elections"] == 0
        assert not journal.lease_is_live(root)
        _eq(b.result_for("sd-1"), want, "degraded standby read")
        with pytest.raises(ReadOnlyError):
            b.submit("acme", _panel(seed=3), "arima", request_id="sd-2",
                     **KW)


def test_torn_durable_result_is_discarded_loudly(tmp_path):
    root = str(tmp_path)
    r = FleetReplica(root, owner="r", ttl_s=1.0, server_kwargs=SRV_KW)
    os.makedirs(os.path.join(root, "results"), exist_ok=True)
    path = os.path.join(root, "results", "torn-1.npz")
    with open(path, "wb") as f:
        f.write(b"\x00garbage, not an npz")
    with pytest.raises(KeyError, match="torn"):
        r.result_for("torn-1")
    assert not os.path.exists(path)
    assert r.counters["torn_results"] == 1


def test_state_codes_are_the_reference_ladder():
    from spark_timeseries_tpu.serving.fleet import STATE_CODES as REF

    assert STATE_CODES == REF == {"full": 0, "recovering": 1, "standby": 2,
                                  "read_only": 3, "storage_degraded": 4,
                                  "retired": 5, "stopped": 6}


# -- real process death ------------------------------------------------------


def _spawn(root, owner, kill_commits=None):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    args = [sys.executable, os.path.abspath(__file__), "replica", root,
            owner, "1.0"]
    if kill_commits is not None:
        args.append(str(kill_commits))
    return subprocess.Popen(args, env=dict(os.environ, PYTHONPATH=repo),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _wait(cond, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def test_sigkill_primary_survivor_reanswers_bitwise(tmp_path):
    ids = ("s-0", "s-1", "s-2")
    panels = [_panel(8, seed=40 + i) for i in range(3)]
    with serving.FitServer(str(tmp_path / "ref"), **SRV_KW) as ref:
        want = [ref.submit(f"t{i}", p, "arima", request_id=rid,
                           **KW).result(timeout=600)
                for i, (rid, p) in enumerate(zip(ids, panels))]
    root = str(tmp_path / "fleet")
    os.makedirs(root)
    a = _spawn(root, "a", kill_commits=2)
    b = None
    try:
        _wait(lambda: (read_lease(root) or {}).get("owner") == "a", 120,
              "replica a's lease")
        b = _spawn(root, "b")
        _wait(lambda: len(discover_endpoints(root)) == 2, 120,
              "replica b's advert")
        with FitClient(discover_endpoints(root), seed=5, deadline_s=300.0,
                       backoff_base_s=0.02) as cli:
            tickets = [cli.submit(f"t{i}", p, "arima", request_id=rid, **KW)
                       for i, (rid, p) in enumerate(zip(ids, panels))]
            got = [t.result(timeout=300) for t in tickets]
        assert a.wait(timeout=120) == -9, a.stderr.read()[-2000:]
        for rid, g, w in zip(ids, got, want):
            _eq(g, w, f"{rid}: survivor vs uninterrupted")
        rec = read_lease(root)
        assert rec["owner"] == "b" and rec["token"] >= 2
    finally:
        for owner in ("a", "b"):
            open(os.path.join(root, f"stop_{owner}"), "w").close()
        if b is not None:
            out, err = b.communicate(timeout=120)
            assert b.returncode == 0, err[-2000:]
            counters = json.loads(out.strip().splitlines()[-1])
            assert counters["elections"] == 1 and counters["role"] == "stopped"
        if a.poll() is None:
            a.kill()
            a.wait(timeout=30)
