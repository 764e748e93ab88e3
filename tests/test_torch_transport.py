"""The port's socket transport and remote client (``serving.transport``,
``serving.client``) and the wire faults of ``reliability.faultinject``
against the reference's (``tests/test_transport.py``).

The wire is the reference's, byte for byte:

- frames, messages (with and without an HMAC secret) and the request and
  result blobs the port encodes equal the reference's for the same
  inputs, and each package decodes the other's;
- the first frame a port ``FitClient`` sends for a submit or a forecast
  submit equals the reference client's, and a tensor argument gives the
  bytes of its host array;
- a port client against a reference ``TransportServer`` and a reference
  client against a port ``TransportServer``, both over a stub backend,
  round-trip results bit for bit, with the same auth refusals and
  degraded error kinds;
- ``frame_fault_schedule`` draws the reference's plan for the same seed,
  and a client on a ``FaultyWire`` storm loses and duplicates nothing.

The reference's client cases run on the port (stub backend: no fits), and
a port ``FitServer`` on the CPU answers over the wire what it answers in
process, bit for bit, its result meta equal after the JSON round trip.
"""

import io
import json
import socket
import threading
import time
import zlib

import numpy as np
import pytest
import torch

from spark_timeseries_tpu.reliability import faultinject as rfi
from spark_timeseries_tpu.serving import client as rclient
from spark_timeseries_tpu.serving import session as rsession
from spark_timeseries_tpu.serving import transport as rtransport
from spark_timeseries_tpu_torch.reliability import faultinject as fi
from spark_timeseries_tpu_torch.serving import client as client_mod
from spark_timeseries_tpu_torch.serving import transport
from spark_timeseries_tpu_torch.serving.client import (ClientDeadlineError,
                                                       FitClient,
                                                       backoff_schedule)
from spark_timeseries_tpu_torch.serving.session import (RejectedError,
                                                        ServerClosedError,
                                                        StorageError,
                                                        TenantFitResult)

FIELDS = ("params", "neg_log_likelihood", "converged", "iters", "status")
PKGS = {"port": (transport, client_mod), "ref": (rtransport, rclient)}
# (client package, server package): every pairing across the two
PAIRS = [("port", "port"), ("port", "ref"), ("ref", "port")]


def _result_for(req_id, rows=3, k=2):
    rng = np.random.default_rng(zlib.crc32(req_id.encode()))
    return TenantFitResult(
        params=rng.normal(size=(rows, k)).astype(np.float32),
        neg_log_likelihood=rng.normal(size=rows).astype(np.float32),
        converged=np.ones(rows, bool),
        iters=np.full(rows, 7, np.int32),
        status=np.zeros(rows, np.int8),
        meta={"req_id": req_id})


def _same(a, b):
    for f in FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


class _StubTicket:
    def __init__(self, req_id):
        self.req_id = req_id


class StubBackend:
    """The FitServer surface over a dict (the reference tests' stub):
    submit records the call, results appear when the test says so."""

    def __init__(self):
        self.lock = threading.Lock()
        self.submits = []
        self.forecasts = []
        self.results = {}
        self.inflight = set()
        self.reject_next = 0
        self.answer_delay_s = 0.0

    def submit(self, tenant, values, model="arima", *, priority=0,
               deadline_s=None, request_id=None, **fit_kwargs):
        with self.lock:
            if request_id in self.results:
                return _StubTicket(request_id)
            if self.reject_next > 0:
                self.reject_next -= 1
                raise RejectedError("stub overload", retry_after_s=0.01)
            self.submits.append((request_id, tenant, np.array(values),
                                 model, dict(fit_kwargs)))
            self.inflight.add(request_id)
        if self.answer_delay_s:
            t = threading.Timer(self.answer_delay_s, self._answer,
                                args=(request_id,))
            t.daemon = True
            t.start()
        else:
            self._answer(request_id)
        return _StubTicket(request_id)

    def submit_forecast(self, tenant, values, fitted, **kw):
        with self.lock:
            self.forecasts.append((tenant, np.array(values),
                                   np.array(fitted), kw))
        return self.submit(tenant, values, "forecast",
                           request_id=kw.get("request_id"))

    def _answer(self, req_id):
        with self.lock:
            rows = self.submits[-1][2].shape[0] if self.submits else 3
            self.results[req_id] = _result_for(req_id, rows=rows)
            self.inflight.discard(req_id)

    def result_for(self, req_id):
        with self.lock:
            if req_id not in self.results:
                raise KeyError(req_id)
            return self.results[req_id]

    def request_pending(self, req_id):
        with self.lock:
            return req_id in self.inflight

    def health(self):
        return {"state": "ready", "stub": True}


@pytest.fixture()
def stub_server():
    backend = StubBackend()
    with transport.TransportServer(backend) as ts:
        yield backend, ts


# -- codecs: the reference's bytes --------------------------------------------

PAYLOADS = [b"", b"x", b"hello" * 100, bytes(range(256)) * 7]


@pytest.mark.parametrize("payload", PAYLOADS, ids=range(len(PAYLOADS)))
def test_frames_equal_the_reference(payload):
    assert transport.encode_frame(payload) == \
        rtransport.encode_frame(payload)
    assert ((transport.MAGIC, transport.MAX_FRAME,
             transport._FRAME_HDR.format)
            == (rtransport.MAGIC, rtransport.MAX_FRAME,
                rtransport._FRAME_HDR.format))


@pytest.mark.parametrize("secret", [None, b"k", b"s3cret" * 9])
def test_messages_equal_the_reference_and_cross_decode(secret):
    hdr = {"op": "submit", "msg_id": "m1", "n": 3, "z": [1, 2]}
    blob = b"\x00\x01binary\xff"
    framed = transport.encode_msg(hdr, blob, secret)
    assert framed == rtransport.encode_msg(hdr, blob, secret)
    payload = rtransport.FrameDecoder().feed(framed)[0]
    assert transport.decode_msg(payload, secret) == (hdr, blob)
    assert rtransport.decode_msg(
        transport.FrameDecoder().feed(framed)[0], secret) == (hdr, blob)


def test_request_blob_equals_the_reference_and_the_durable_record(tmp_path):
    from spark_timeseries_tpu_torch.serving.session import FitRequest

    y = np.random.default_rng(0).normal(size=(5, 7)).astype(np.float32)
    meta = {"req_id": "r1", "tenant": "t", "model": "arima",
            "fit_kwargs": {"order": [1, 0, 0]}, "priority": 0,
            "deadline_s": None}
    blob = transport.encode_request_blob(y, meta)
    assert blob == rtransport.encode_request_blob(y, meta)
    # a tensor (non-contiguous here) gives its host array's bytes
    assert transport.encode_request_blob(
        torch.as_tensor(np.asfortranarray(y)).t().contiguous().t(),
        meta) == blob
    for mod in (transport, rtransport):
        values, meta2 = mod.decode_request_blob(blob)
        np.testing.assert_array_equal(values, y)
        assert meta2 == meta
    # one npz spelling: a durable request record decodes as a wire blob
    req = FitRequest("r1", 4, "t", y, "arima", {"order": [1, 0, 0]})
    req.save(str(tmp_path / "r1.npz"))
    values, rec = transport.decode_request_blob(
        (tmp_path / "r1.npz").read_bytes())
    np.testing.assert_array_equal(values, y)
    assert {k: rec[k] for k in meta if k in rec} == {
        **meta, "priority": 0, "deadline_s": None}
    with np.load(io.BytesIO(blob)) as z:
        assert set(z.files) == {"values", "meta"}


def test_result_blob_equals_the_reference_both_ways():
    res = _result_for("r2", rows=5)
    res = res._replace(meta={"req_id": "r2", "x": np.float32(1.5),
                             "journal": {"chunks_resumed": 1}})
    blob = transport.encode_result_blob(res)
    assert blob == rtransport.encode_result_blob(res)
    for got in (transport.decode_result_blob(blob),
                rtransport.decode_result_blob(blob)):
        _same(got, res)
        assert got.meta == {"req_id": "r2", "x": "np.float32(1.5)",
                            "journal": {"chunks_resumed": 1}}


def test_frame_decoder_cases():
    wire = b"".join(transport.encode_frame(p) for p in PAYLOADS)
    for step in (1, 3, 7, len(wire)):
        dec = transport.FrameDecoder()
        got = []
        for i in range(0, len(wire), step):
            got.extend(dec.feed(wire[i:i + step]))
        assert got == PAYLOADS and dec.pending == 0
    with pytest.raises(transport.FrameError, match="magic"):
        transport.FrameDecoder().feed(b"JUNK" + b"\x00" * 12)
    frame = bytearray(transport.encode_frame(b"payload-bytes"))
    frame[-1] ^= 0xFF
    with pytest.raises(transport.FrameError, match="CRC"):
        transport.FrameDecoder().feed(bytes(frame))
    frame = transport.encode_frame(b"half-written")
    dec = transport.FrameDecoder()
    assert dec.feed(frame[:-4]) == [] and dec.pending > 0
    assert dec.feed(frame[-4:]) == [b"half-written"] and dec.pending == 0
    with pytest.raises(transport.FrameError, match="exceeds"):
        transport.FrameDecoder(max_frame=8).feed(
            transport.encode_frame(b"x" * 64)[:16])
    with pytest.raises(transport.FrameError, match="exceeds"):
        transport.encode_frame(b"x" * (transport.MAX_FRAME + 1))
    dec = transport.FrameDecoder()
    dec.requeue(b"b")
    dec.requeue(b"a")
    assert dec.feed(b"") == [b"a", b"b"]


def test_wire_secret_resolution(monkeypatch, tmp_path):
    for var in ("STSTPU_WIRE_SECRET", "STSTPU_WIRE_SECRET_FILE"):
        monkeypatch.delenv(var, raising=False)
    assert transport.resolve_wire_secret() is None
    assert transport.resolve_wire_secret("abc") == b"abc"
    f = tmp_path / "secret"
    f.write_bytes(b"from-file\n")
    monkeypatch.setenv("STSTPU_WIRE_SECRET_FILE", str(f))
    assert transport.resolve_wire_secret() == b"from-file"
    monkeypatch.setenv("STSTPU_WIRE_SECRET", "from-env")
    assert transport.resolve_wire_secret() == b"from-env" == \
        rtransport.resolve_wire_secret()


@pytest.mark.parametrize("seed", [0, 11, 100])
def test_frame_fault_schedule_equals_the_reference(seed):
    for kw in ({}, {"drop_frac": 0.3, "dup_frac": 0.3, "tear_frac": 0.2}):
        assert fi.frame_fault_schedule(seed, 200, **kw) == \
            rfi.frame_fault_schedule(seed, 200, **kw)
    with pytest.raises(ValueError):
        fi.frame_fault_schedule(0, 4, drop_frac=0.6, dup_frac=0.6)


def test_backoff_schedule_equals_the_reference():
    for seed in (0, 3, 4):
        assert backoff_schedule(seed, 24) == rclient.backoff_schedule(seed,
                                                                      24)
    sched = backoff_schedule(0, 24, base_s=0.05, max_s=2.0)
    assert all(0.0 < s <= 2.0 for s in sched)
    assert max(sched[:3]) < max(sched[-3:])


# -- what a client puts on the wire ------------------------------------------


def _first_frame(client_module, call):
    """The payload of the first frame a client sends for ``call(cli)``,
    read by a bare listener that acks it (``req_id`` echoed)."""
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    got = {}

    def serve():
        conn, _ = lst.accept()
        dec = rtransport.FrameDecoder()
        frames = []
        while not frames:
            frames = dec.feed(conn.recv(1 << 16))
        got["payload"] = frames[0]
        hdr, blob = rtransport.decode_msg(frames[0])
        meta = rtransport.decode_request_blob(blob)[1]
        rtransport.send_msg(conn, {"ok": True, "req_id": meta["req_id"],
                                   "msg_id": hdr["msg_id"]})
        conn.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    with client_module.FitClient([lst.getsockname()], seed=1,
                                 deadline_s=30.0) as cli:
        call(cli)
    t.join(30)
    lst.close()
    return got["payload"]


def test_submit_frame_equals_the_reference_client_s():
    y = np.random.default_rng(1).normal(size=(4, 9)).astype(np.float32)

    def call(values):
        return lambda cli: cli.submit("t", values, "arima", priority=2,
                                      deadline_s=9.5, request_id="w-1",
                                      order=(1, 0, 0), max_iters=15)

    want = _first_frame(rclient, call(y))
    assert _first_frame(client_mod, call(y)) == want
    assert _first_frame(client_mod, call(torch.as_tensor(y))) == want


def test_forecast_frame_equals_the_reference_client_s():
    rng = np.random.default_rng(2)
    y = rng.normal(size=(4, 9)).astype(np.float32)
    fit = _result_for("f", rows=4, k=3)

    def call(values, fitted, status=None):
        return lambda cli: cli.submit_forecast(
            "t", values, fitted, model="arima", horizon=5,
            model_kwargs={"order": (1, 0, 1)}, status=status,
            intervals=True, n_samples=16, seed=3, request_id="w-2")

    want = _first_frame(rclient, call(y, fit))
    assert _first_frame(client_mod, call(y, fit)) == want
    tfit = fit._replace(params=torch.as_tensor(fit.params),
                        status=torch.as_tensor(fit.status))
    assert _first_frame(client_mod, call(torch.as_tensor(y), tfit)) == want
    want = _first_frame(rclient, call(y, fit.params, fit.status))
    assert _first_frame(client_mod, call(
        y, torch.as_tensor(fit.params), torch.as_tensor(fit.status))) == want


# -- clients and servers across the two packages -----------------------------


@pytest.mark.parametrize("cpkg,spkg", PAIRS)
def test_cross_package_round_trip_bitwise(cpkg, spkg):
    ctrans, cmod = PKGS[cpkg]
    strans, _ = PKGS[spkg]
    backend = StubBackend()
    y = np.ones((4, 8), np.float32)
    with strans.TransportServer(backend) as ts:
        with cmod.FitClient([ts.address], seed=1, deadline_s=30.0) as cli:
            assert cli.ping() is True
            assert cli.health()["stub"] is True
            r1 = cli.submit("t", y, "arima", order=(1, 0, 0),
                            request_id="x-1").result(timeout=30)
            r2 = cli.submit("t", y, request_id="x-1").result(timeout=30)
            r3 = cli.result_for("x-1", timeout=30)
            fc = cli.submit_forecast("t", y, np.ones((4, 3), np.float32),
                                     horizon=4, request_id="x-2",
                                     ).result(timeout=30)
            with pytest.raises(KeyError):
                cli.result_for("never", timeout=5)
    for got in (r1, r2, r3):
        _same(got, backend.results["x-1"])
        assert got.meta == {"req_id": "x-1"}
    _same(fc, backend.results["x-2"])
    assert [s[0] for s in backend.submits] == ["x-1", "x-2"]
    assert backend.submits[0][4] == {"order": [1, 0, 0]}
    tenant, values, fitted, kw = backend.forecasts[0]
    assert (kw["horizon"], kw["model"], kw["status"]) == (4, "arima", None)


@pytest.mark.parametrize("cpkg,spkg", PAIRS)
def test_cross_package_auth(cpkg, spkg):
    ctrans, cmod = PKGS[cpkg]
    strans, _ = PKGS[spkg]
    backend = StubBackend()
    with strans.TransportServer(backend, secret=b"s3cret") as ts:
        with cmod.FitClient([ts.address], seed=11, deadline_s=10.0,
                            secret=b"s3cret") as cli:
            res = cli.submit("t", np.ones((3, 8), np.float32),
                             request_id="auth-1").result(timeout=30)
        _same(res, backend.results["auth-1"])
        t0 = time.monotonic()
        with cmod.FitClient([ts.address], seed=12, deadline_s=30.0,
                            retries=8, secret=b"wrong") as bad:
            with pytest.raises(ctrans.WireAuthError):
                bad.ping()
        assert time.monotonic() - t0 < 10.0  # terminal: never retried
    assert [s[0] for s in backend.submits] == ["auth-1"]


@pytest.mark.parametrize("cpkg,spkg", PAIRS)
def test_cross_package_fault_storm(cpkg, spkg):
    _, cmod = PKGS[cpkg]
    strans, _ = PKGS[spkg]
    wire = {"port": fi, "ref": rfi}[cpkg]
    backend = StubBackend()
    wires = []

    def wrap(sock):
        w = wire.FaultyWire(sock, wire.frame_fault_schedule(
            100 + len(wires), 4, drop_frac=0.3, dup_frac=0.3,
            tear_frac=0.2))
        wires.append(w)
        return w

    y = np.ones((3, 8), np.float32)
    with strans.TransportServer(backend) as ts:
        with cmod.FitClient([ts.address], seed=8, deadline_s=60.0,
                            io_timeout_s=0.5, backoff_base_s=0.01,
                            _wire_wrap=wrap) as cli:
            results = [cli.submit("t", y, request_id=f"storm-{i}")
                       .result(timeout=60) for i in range(4)]
    assert any(f != "pass" for w in wires for f in w.log)
    for i, res in enumerate(results):
        _same(res, backend.results[f"storm-{i}"])
    ids = [s[0] for s in backend.submits]
    assert sorted(set(ids)) == sorted(ids)


# each package's server maps its own error classes onto the wire
ERRORS = {"port": (transport.ReadOnlyError, StorageError),
          "ref": (rtransport.ReadOnlyError, rsession.StorageError)}


class _ReadOnlyBackend(StubBackend):
    def __init__(self, pkg="port"):
        super().__init__()
        self.pkg = pkg

    def submit(self, *a, **kw):
        raise ERRORS[self.pkg][0]("leaderless window", retry_after_s=0.02)


class _DegradedBackend(StubBackend):
    def __init__(self, fail_first_n, pkg="port"):
        super().__init__()
        self.refusals = fail_first_n
        self.pkg = pkg

    def submit(self, *a, **kw):
        with self.lock:
            if self.refusals > 0:
                self.refusals -= 1
                raise ERRORS[self.pkg][1]("EIO on write-ahead",
                                          retry_after_s=0.02)
        return super().submit(*a, **kw)


def _submit_blob(req_id):
    meta = {"req_id": req_id, "tenant": "t", "model": "arima",
            "fit_kwargs": {}, "priority": 0, "deadline_s": None}
    return transport.encode_request_blob(np.ones((2, 4), np.float32), meta)


@pytest.mark.parametrize("spkg", ["port", "ref"])
def test_degraded_kinds_reach_the_wire(spkg):
    strans, _ = PKGS[spkg]
    with strans.TransportServer(_ReadOnlyBackend(spkg)) as ts:
        s = socket.create_connection(ts.address)
        try:
            transport.send_msg(s, {"op": "submit", "msg_id": "m-1"},
                               _submit_blob("ro-1"))
            reply, _ = transport.recv_msg(s, transport.FrameDecoder())
        finally:
            s.close()
    assert reply == {"error": "read_only", "message": "leaderless window",
                     "retry_after_s": 0.02, "msg_id": "m-1"}
    with strans.TransportServer(_DegradedBackend(1, spkg)) as ts:
        s = socket.create_connection(ts.address)
        try:
            transport.send_msg(s, {"op": "submit", "msg_id": "m-2"},
                               _submit_blob("sd-1"))
            reply, _ = transport.recv_msg(s, transport.FrameDecoder())
        finally:
            s.close()
    assert reply["error"] == "storage_degraded"
    assert reply["retry_after_s"] == pytest.approx(0.02)


# -- the reference's client cases on the port ---------------------------------


def test_submit_result_roundtrip(stub_server):
    backend, ts = stub_server
    y = np.ones((4, 8), np.float32)
    with FitClient([ts.address], seed=1, deadline_s=30.0) as cli:
        res = cli.submit("t", y, "arima", order=(1, 0, 0),
                         request_id="req-1").result(timeout=30)
    _same(res, backend.results["req-1"])
    (rid, tenant, values, model, kw) = backend.submits[0]
    assert (rid, tenant, model) == ("req-1", "t", "arima")
    np.testing.assert_array_equal(values, y)
    assert kw == {"order": [1, 0, 0]}


def test_rejected_backs_off_then_lands(stub_server):
    backend, ts = stub_server
    backend.reject_next = 2
    with FitClient([ts.address], seed=3, deadline_s=30.0,
                   backoff_base_s=0.01) as cli:
        res = cli.submit("t", np.ones((3, 8), np.float32),
                         request_id="rej-1").result(timeout=30)
    assert res.params.shape == (3, 2) and backend.reject_next == 0


def test_deadline_raises_typed_error_not_hang(stub_server):
    backend, ts = stub_server
    backend.answer_delay_s = 60.0
    with FitClient([ts.address], seed=4, deadline_s=30.0,
                   poll_interval_s=0.01) as cli:
        tk = cli.submit("t", np.ones((3, 8), np.float32),
                        request_id="slow-1")
        assert not tk.done()
        t0 = time.monotonic()
        with pytest.raises(ClientDeadlineError) as ei:
            tk.result(timeout=0.5)
        assert time.monotonic() - t0 < 10.0
        assert ei.value.deadline_s == pytest.approx(0.5)


def test_unknown_result_resubmits_idempotently(stub_server):
    backend, ts = stub_server
    with FitClient([ts.address], seed=5, deadline_s=30.0) as cli:
        tk = cli.submit("t", np.ones((3, 8), np.float32),
                        request_id="lost-1")
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            with backend.lock:
                if "lost-1" in backend.results:
                    break
            time.sleep(0.01)
        with backend.lock:
            backend.results.clear()
            backend.submits.clear()
            backend.inflight.clear()
        with pytest.raises(KeyError):
            cli.result_for("lost-1", timeout=5)
        res = tk.result(timeout=30)
    assert res.params.shape == (3, 2)
    assert backend.submits[0][0] == "lost-1"


def test_connect_failure_rotates_endpoints(stub_server):
    _backend, ts = stub_server
    dead = socket.socket()
    dead.bind(("127.0.0.1", 0))
    host, port = dead.getsockname()
    try:
        with FitClient([dead.getsockname(), ts.address], seed=6,
                       deadline_s=30.0, connect_timeout_s=0.2,
                       backoff_base_s=0.01) as cli:
            assert cli.ping() is True
            snap = cli.endpoint_health.snapshot()
    finally:
        dead.close()
    assert snap["endpoints"][f"{host}:{port}"]["failures"] >= 1


def test_bad_op_and_listener_survive_garbage(stub_server):
    _backend, ts = stub_server
    bad = socket.create_connection(ts.address)
    bad.sendall(b"NOT A FRAME AT ALL" * 4)
    bad.close()
    with FitClient([ts.address], seed=7, deadline_s=10.0) as cli:
        assert cli.ping() is True
        with pytest.raises(ValueError, match="unknown op"):
            cli._call({"op": "no-such-op"}, b"", what="bad",
                      resubmit_ok=False)
    s = socket.create_connection(ts.address)
    try:
        transport.send_msg(s, {"op": "ping", "msg_id": "m-42"})
        hdr, _ = transport.recv_msg(s, transport.FrameDecoder())
    finally:
        s.close()
    assert hdr == {"ok": True, "msg_id": "m-42"}


def test_reset_after_drops_connection(stub_server):
    _backend, ts = stub_server
    raw = socket.create_connection(ts.address)
    wire = fi.FaultyWire(raw, [], reset_after=0)
    try:
        with pytest.raises(ConnectionResetError):
            transport.send_msg(wire, {"op": "ping"})
    finally:
        wire.close()
    assert wire.log == ["reset"]


def test_unauthenticated_client_refused_and_env_secret(monkeypatch):
    backend = StubBackend()
    with transport.TransportServer(backend, secret=b"armed") as ts:
        s = socket.create_connection(ts.address)
        try:
            transport.send_msg(s, {"op": "ping", "msg_id": "m"})
            reply, _ = transport.recv_msg(s, transport.FrameDecoder(),
                                          secret=b"armed")
        finally:
            s.close()
    assert reply["error"] == "auth_failed" and backend.submits == []
    monkeypatch.setenv("STSTPU_WIRE_SECRET", "from-env")
    with transport.TransportServer(StubBackend()) as ts:
        with FitClient([ts.address], seed=14, deadline_s=10.0) as cli:
            assert cli.ping() is True
        with FitClient([ts.address], seed=15, deadline_s=10.0,
                       secret=b"not-from-env") as bad:
            with pytest.raises(transport.WireAuthError):
                bad.ping()


def test_read_only_reads_flow_and_storage_degraded_retries():
    backend = _ReadOnlyBackend()
    backend.results["done-1"] = _result_for("done-1")
    with transport.TransportServer(backend) as ts:
        with FitClient([ts.address], seed=16, deadline_s=10.0, retries=2,
                       backoff_base_s=0.01) as cli:
            _same(cli.result_for("done-1", timeout=10),
                  backend.results["done-1"])
            with pytest.raises(ServerClosedError):
                cli.submit("t", np.ones((2, 4), np.float32),
                           request_id="ro-2").result(timeout=10)
    backend = _DegradedBackend(fail_first_n=3)
    with transport.TransportServer(backend) as ts:
        key = f"{ts.address[0]}:{ts.address[1]}"
        with FitClient([ts.address], seed=19, deadline_s=30.0,
                       backoff_base_s=0.01, failure_threshold=3) as cli:
            res = cli.submit("t", np.ones((3, 8), np.float32),
                             request_id="sd-2").result(timeout=30)
            snap = cli.endpoint_health.snapshot()
    _same(res, backend.results["sd-2"])
    assert snap["endpoints"][key]["failures"] >= 3
    backend = _DegradedBackend(fail_first_n=99)
    with transport.TransportServer(backend) as ts:
        with FitClient([ts.address], seed=18, deadline_s=30.0, retries=1,
                       backoff_base_s=0.01) as cli:
            with pytest.raises(StorageError):
                cli._call({"op": "submit"}, _submit_blob("sd-typed"),
                          what="probe", resubmit_ok=False)


def test_hedged_poll_answers_from_a_second_endpoint():
    slow, fast = StubBackend(), StubBackend()
    fast.results["h-1"] = _result_for("h-1")
    slow.inflight.add("h-1")  # the first endpoint only ever says pending
    with transport.TransportServer(slow) as a, \
            transport.TransportServer(fast) as b:
        with FitClient([a.address, b.address], seed=20, deadline_s=30.0,
                       poll_interval_s=0.01, hedge_after_s=0.05) as cli:
            res = cli._poll_result("h-1", None, 30.0)
    _same(res, fast.results["h-1"])


# -- a port FitServer over the wire (CPU) -------------------------------------

T = 96


def _panel(rows=8, seed=0):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(rows, T)).astype(np.float32)
    y = np.zeros_like(e)
    y[:, 0] = e[:, 0]
    for i in range(1, T):
        y[:, i] = 0.6 * y[:, i - 1] + e[:, i]
    y[::3, :10] = np.nan  # ragged starts
    return y


def test_wired_fit_server_answers_its_in_process_bits(tmp_path):
    from spark_timeseries_tpu_torch import serving
    from spark_timeseries_tpu_torch.forecasting import as_result

    kw = dict(order=(1, 0, 0), max_iters=15)
    y = [_panel(8, seed=s) for s in (0, 1)]
    srv = serving.FitServer(str(tmp_path / "srv"), cell_rows=8,
                            batch_window_s=0.02, autotune=False,
                            device="cpu")
    inproc = [srv.submit(f"t{i}", v, "arima", request_id=f"in-{i}", **kw)
              for i, v in enumerate(y)]
    with srv, transport.TransportServer(srv, secret=b"k") as ts:
        want = [t.result(timeout=300) for t in inproc]
        with FitClient([ts.address], seed=1, deadline_s=300.0,
                       secret=b"k") as cli:
            got = [cli.submit(f"t{i}", torch.as_tensor(v), "arima",
                              request_id=f"in-{i}", **kw).result(timeout=300)
                   for i, v in enumerate(y)]
            wired_fc = cli.submit_forecast(
                "t0", y[0], want[0], model="arima", horizon=4,
                model_kwargs={"order": (1, 0, 0)},
                request_id="fc-wire").result(timeout=300)
        local_fc = srv.submit_forecast(
            "t0", y[0], want[0], model="arima", horizon=4,
            model_kwargs={"order": (1, 0, 0)},
            request_id="fc-local").result(timeout=300)
    for g, w in zip(got, want):
        _same(g, w)
        # the in-process meta is JSON-native: the wire changes nothing
        assert g.meta == json.loads(json.dumps(w.meta))
        assert g.meta == w.meta
    a = as_result(wired_fc, 4, False)
    b = as_result(local_fc, 4, False)
    assert np.array_equal(a.forecast, b.forecast, equal_nan=True)
    _same(wired_fc._replace(meta={}), local_fc._replace(meta={}))
