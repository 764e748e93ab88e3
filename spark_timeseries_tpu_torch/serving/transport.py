"""Socket transport for the fit server: length-prefixed frames over TCP
(port of ``serving/transport.py``; the wire is the reference's, byte for
byte, so a port client talks to a reference server and the other way
round).

Every :class:`~.server.FitServer` caller used to be a thread in the
server's own process; this module puts the EXISTING request vocabulary
on a wire without inventing a second serialization.  Only host bytes
cross it: the server fits on its own device, and results are host
arrays.

- **Frames**: ``b"STSF" | u32 payload_len | u32 crc32(payload) |
  payload`` (big-endian).  The CRC is what turns a half-written frame
  (a peer killed mid-``send``, a torn proxy buffer) into a loud
  :class:`FrameError` instead of a silently corrupted request; a
  connection that produces one is poisoned and closed — the client
  reconnects and idempotently retries.
- **Messages**: one frame per message; the payload is
  ``u32 header_len | canonical-JSON header | blob``.  The blob for
  ``submit`` is the durable request record's npz bytes VERBATIM
  (``values`` array + ``meta`` uint8 JSON — exactly what
  :meth:`~.session.FitRequest.save` writes under ``requests/``), so the
  wire format and the crash-recovery format cannot drift apart.
- **Ops**: ``submit`` / ``submit_forecast`` (ack after durable
  admission), ``result`` (poll: done / pending / unknown),
  ``health``, ``ping``.  Every reply echoes the request's ``msg_id`` so
  a duplicated frame (fault injection, a retrying middlebox) can never
  pair a stale reply with the wrong call.

The server side (:class:`TransportServer`) is a thin adapter over any
backend exposing the FitServer surface (``submit`` / ``submit_forecast``
/ ``result_for`` / ``request_pending`` / ``health``) — a bare
:class:`~.server.FitServer` or a :class:`~.fleet.FleetReplica` (which
answers :class:`NotLeaderError` while standby).  Admission stays the
backend's job: the transport never queues, so overload surfaces as the
same :class:`~.session.RejectedError` backpressure callers see
in-process, serialized as ``{"error": "rejected", "retry_after_s": ...}``.
"""

from __future__ import annotations

import hashlib
import hmac
import io
import json
import os
import socket
import struct
import threading
import time
import zlib
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from .. import obs
from ..reliability.journal import FencedError
from ..reliability.runner import _host
from .session import (RejectedError, ServerClosedError, StorageError,
                      TenantFitResult)

__all__ = [
    "FrameDecoder",
    "FrameError",
    "NotLeaderError",
    "ReadOnlyError",
    "TransportError",
    "TransportServer",
    "WireAuthError",
    "decode_msg",
    "decode_request_blob",
    "encode_frame",
    "encode_msg",
    "encode_request_blob",
    "encode_result_blob",
    "decode_result_blob",
    "recv_msg",
    "resolve_wire_secret",
    "send_msg",
]

MAGIC = b"STSF"
_FRAME_HDR = struct.Struct(">4sII")  # magic | payload_len | crc32
_U32 = struct.Struct(">I")
MAX_FRAME = 256 * 1024 * 1024  # a request panel, with headroom

WIRE_SECRET_ENV = "STSTPU_WIRE_SECRET"
WIRE_SECRET_FILE_ENV = "STSTPU_WIRE_SECRET_FILE"
_TAG_LEN = hashlib.sha256().digest_size  # HMAC-SHA256 tag prefix


class TransportError(RuntimeError):
    """Base class for wire-protocol failures (connection-scoped)."""


class FrameError(TransportError):
    """A frame failed validation (bad magic, CRC mismatch, oversized,
    or truncated mid-frame) — the connection is poisoned; reconnect."""


class WireAuthError(RuntimeError):
    """A message failed HMAC verification (or the peer rejected ours).
    Deliberately NOT a :class:`TransportError`: a CRC failure means a
    flaky wire and retrying is right; an auth failure means the two
    sides disagree on the shared secret and retrying can never help —
    it is terminal, a configuration problem for the operator."""


class NotLeaderError(RuntimeError):
    """The replica answering this connection does not hold the fleet
    lease — resubmit to (or wait for) the current primary."""


class ReadOnlyError(RuntimeError):
    """The fleet is in a leaderless window (no replica holds the lease)
    — reads over durable state still work, but a write has nowhere safe
    to land.  Distinct from :class:`NotLeaderError` ("retry ELSEWHERE:
    a primary exists, it just is not me"): this says "retry LATER — an
    election is in flight"."""

    def __init__(self, message: str, retry_after_s: float = 0.5):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


def resolve_wire_secret(secret=None) -> Optional[bytes]:
    """The shared wire-auth secret, or None (auth disarmed).

    Explicit ``secret`` (str/bytes) wins; else ``STSTPU_WIRE_SECRET``
    (utf-8), else ``STSTPU_WIRE_SECRET_FILE`` (file bytes, stripped).
    Server and every client must resolve the SAME bytes or every frame
    between them dies with :class:`WireAuthError`."""
    if secret is not None:
        return secret.encode() if isinstance(secret, str) else bytes(secret)
    env = os.environ.get(WIRE_SECRET_ENV)
    if env:
        return env.encode()
    path = os.environ.get(WIRE_SECRET_FILE_ENV)
    if path:
        with open(path, "rb") as f:
            return f.read().strip()
    return None


# ---------------------------------------------------------------------------
# frame codec (pure bytes -> bytes; the seeded fault tests drive these)
# ---------------------------------------------------------------------------


def encode_frame(payload: bytes) -> bytes:
    """One wire frame around ``payload`` (magic, length, CRC)."""
    if len(payload) > MAX_FRAME:
        raise FrameError(f"payload of {len(payload)} bytes exceeds the "
                         f"{MAX_FRAME}-byte frame bound")
    return _FRAME_HDR.pack(MAGIC, len(payload),
                           zlib.crc32(payload) & 0xFFFFFFFF) + payload


class FrameDecoder:
    """Incremental frame parser: ``feed(chunk)`` returns the payloads of
    every frame completed by that chunk, raising :class:`FrameError` on
    corruption.  ``pending`` reports buffered-but-incomplete bytes so a
    closed connection can distinguish a clean EOF from a half-written
    frame."""

    def __init__(self, max_frame: int = MAX_FRAME):
        self._buf = bytearray()
        self._max = int(max_frame)

    @property
    def pending(self) -> int:
        return len(self._buf)

    def requeue(self, payload: bytes) -> None:
        """Push an already-validated payload back to the buffer's front
        (duplicated-frame faults can complete several frames in one
        ``recv``; the extras re-enter FIFO)."""
        self._buf[:0] = encode_frame(payload)

    def feed(self, chunk: bytes) -> list:
        self._buf.extend(chunk)
        out = []
        while len(self._buf) >= _FRAME_HDR.size:
            magic, length, crc = _FRAME_HDR.unpack_from(self._buf)
            if magic != MAGIC:
                raise FrameError(f"bad frame magic {bytes(magic)!r}")
            if length > self._max:
                raise FrameError(f"frame of {length} bytes exceeds the "
                                 f"{self._max}-byte bound")
            end = _FRAME_HDR.size + length
            if len(self._buf) < end:
                break
            payload = bytes(self._buf[_FRAME_HDR.size:end])
            del self._buf[:end]
            if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                raise FrameError("frame CRC mismatch (half-written or "
                                 "corrupted frame)")
            out.append(payload)
        return out


def encode_msg(header: dict, blob: bytes = b"",
               secret: Optional[bytes] = None) -> bytes:
    """A full message frame: canonical-JSON header + optional blob.

    With a ``secret`` armed the payload is prefixed by a 32-byte
    HMAC-SHA256 tag over the rest (header length + header + blob), so
    every frame on the wire is authenticated — the CRC catches
    accidents, the tag catches peers without the secret."""
    hdr = json.dumps(header, sort_keys=True).encode()
    body = _U32.pack(len(hdr)) + hdr + blob
    if secret is not None:
        body = hmac.new(secret, body, hashlib.sha256).digest() + body
    return encode_frame(body)


def decode_msg(payload: bytes,
               secret: Optional[bytes] = None) -> Tuple[dict, bytes]:
    if secret is not None:
        if len(payload) < _TAG_LEN:
            raise WireAuthError(
                "frame too short to carry an auth tag — peer is not "
                "speaking the authenticated protocol")
        tag, payload = payload[:_TAG_LEN], payload[_TAG_LEN:]
        want = hmac.new(secret, payload, hashlib.sha256).digest()
        if not hmac.compare_digest(tag, want):  # constant-time
            raise WireAuthError(
                "frame HMAC verification failed — shared-secret mismatch")
    if len(payload) < _U32.size:
        raise FrameError("message payload shorter than its header length")
    (hlen,) = _U32.unpack_from(payload)
    if _U32.size + hlen > len(payload):
        raise FrameError("message header overruns its payload")
    try:
        header = json.loads(payload[_U32.size:_U32.size + hlen].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise FrameError(f"unparseable message header: {e}") from None
    return header, payload[_U32.size + hlen:]


def send_msg(sock, header: dict, blob: bytes = b"",
             secret: Optional[bytes] = None) -> None:
    """One message = one ``sendall`` — the unit the fault-injection
    wrappers (``reliability.faultinject``) drop/duplicate/tear."""
    sock.sendall(encode_msg(header, blob, secret))


def recv_msg(sock, decoder: FrameDecoder, bufsize: int = 1 << 16,
             secret: Optional[bytes] = None
             ) -> Optional[Tuple[dict, bytes]]:
    """Block for the next whole message on ``sock`` (None on clean EOF;
    :class:`FrameError` on EOF inside a frame)."""
    frames: list = []
    while not frames:
        chunk = sock.recv(bufsize)
        if not chunk:
            if decoder.pending:
                raise FrameError(
                    f"connection closed mid-frame ({decoder.pending} "
                    "buffered bytes) — half-written frame dropped")
            return None
        frames.extend(decoder.feed(chunk))
    first = frames[0]
    for extra in reversed(frames[1:]):
        decoder.requeue(extra)
    return decode_msg(first, secret)


# ---------------------------------------------------------------------------
# request / result blobs (the existing npz+JSON spelling, verbatim)
# ---------------------------------------------------------------------------


def encode_request_blob(values, meta: dict) -> bytes:
    """The durable request record's npz bytes (``FitRequest.save``'s
    spelling: ``values`` + ``meta`` as uint8 canonical JSON).  ``values``
    may be a tensor on any device (read to the host once)."""
    buf = io.BytesIO()
    np.savez(buf, values=np.ascontiguousarray(_host(values)),
             meta=np.frombuffer(
                 json.dumps(meta, sort_keys=True).encode(), dtype=np.uint8))
    return buf.getvalue()


def decode_request_blob(blob: bytes) -> Tuple[np.ndarray, dict]:
    with np.load(io.BytesIO(blob)) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        values = np.array(z["values"])
    return values, meta


def encode_result_blob(res: TenantFitResult) -> bytes:
    """A stored result's npz bytes (``FitServer._store_result``'s
    spelling), so polls ship exactly what recovery re-answers."""
    buf = io.BytesIO()
    np.savez(buf, params=res.params, nll=res.neg_log_likelihood,
             converged=res.converged, iters=res.iters, status=res.status,
             meta=np.frombuffer(
                 json.dumps(res.meta, default=repr).encode(),
                 dtype=np.uint8))
    return buf.getvalue()


def decode_result_blob(blob: bytes) -> TenantFitResult:
    with np.load(io.BytesIO(blob)) as z:
        return TenantFitResult(
            params=np.array(z["params"]),
            neg_log_likelihood=np.array(z["nll"]),
            converged=np.array(z["converged"]),
            iters=np.array(z["iters"]),
            status=np.array(z["status"]),
            meta=json.loads(bytes(z["meta"].tobytes()).decode()))


# ---------------------------------------------------------------------------
# server side
# ---------------------------------------------------------------------------


class TransportServer:
    """Listener + per-connection handler threads over a serving backend.

    .. attribute:: _protected_by_

        Lock-discipline contract (the lint lock map): the accept
        thread registers connections while ``stop()`` (any thread)
        closes them — the connection registry mutates only under its
        lock.

    The backend is duck-typed: a :class:`~.server.FitServer` (submit /
    submit_forecast / result_for / request_pending / health) or a
    :class:`~.fleet.FleetReplica` delegating to its leased server.
    Backend exceptions map to typed error replies; everything else is
    ``{"error": "internal"}`` — a handler never kills the listener.
    """

    _protected_by_ = {"_conns": "_conns_lock"}

    def __init__(self, backend, host: str = "127.0.0.1", port: int = 0,
                 *, max_frame: int = MAX_FRAME, secret=None):
        self.backend = backend
        self._host = host
        self._port = int(port)
        self._max_frame = int(max_frame)
        self._secret = resolve_wire_secret(secret)
        self._sock: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._conns: Dict[int, socket.socket] = {}
        self._conns_lock = threading.Lock()
        self._conn_seq = 0
        self._stopped = threading.Event()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "TransportServer":
        if self._sock is not None:
            raise RuntimeError("TransportServer.start() called twice")
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self._host, self._port))
        s.listen(64)
        # bounded accept wait: close() alone does NOT wake a thread
        # blocked in accept() on Linux, so the loop re-checks _stopped
        s.settimeout(0.25)
        self._sock = s
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="transport-accept")
        self._accept_thread.start()
        obs.event("transport.listening", address=list(self.address))
        return self

    @property
    def address(self) -> Tuple[str, int]:
        """The bound (host, port) — with ``port=0`` the kernel picked."""
        if self._sock is None:
            raise RuntimeError("TransportServer not started")
        addr = self._sock.getsockname()
        return (addr[0], int(addr[1]))

    def stop(self) -> None:
        self._stopped.set()
        if self._sock is not None:
            try:  # wakes a blocked accept() immediately (EINVAL)
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
        with self._conns_lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        t = self._accept_thread
        if t is not None and t.is_alive():
            t.join(timeout=10.0)

    def __enter__(self) -> "TransportServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- connection handling -------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue  # bounded wait: re-check _stopped
            except OSError:
                return  # listener closed by stop()
            conn.settimeout(None)  # handlers block; only accept is bounded
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                self._conn_seq += 1
                cid = self._conn_seq
                self._conns[cid] = conn
            threading.Thread(target=self._handle_conn, args=(cid, conn),
                             daemon=True,
                             name=f"transport-conn-{cid}").start()

    def _handle_conn(self, cid: int, conn: socket.socket) -> None:
        decoder = FrameDecoder(self._max_frame)
        try:
            while not self._stopped.is_set():
                try:
                    msg = recv_msg(conn, decoder, secret=self._secret)
                except WireAuthError as e:
                    # an unauthenticated peer: one typed refusal (so an
                    # honest-but-misconfigured client fails LOUDLY, not
                    # by timeout), then close — never dispatch the frame
                    obs.event("transport.auth_failed", conn=cid,
                              error=repr(e)[:200])
                    try:
                        send_msg(conn, {"error": "auth_failed",
                                        "message": str(e)},
                                 secret=self._secret)
                    except OSError:
                        pass
                    return
                except (FrameError, OSError) as e:
                    obs.event("transport.conn_poisoned", conn=cid,
                              error=repr(e)[:200])
                    return  # poisoned/reset connection: drop it
                if msg is None:
                    return  # clean EOF
                header, blob = msg
                reply_hdr, reply_blob = self._dispatch(header, blob)
                if "msg_id" in header:
                    reply_hdr["msg_id"] = header["msg_id"]
                if "trace" in header:
                    # a tracing client gets this replica's monotonic
                    # clock on every reply — the raw material for the
                    # client's per-endpoint offset estimates;
                    # non-tracing requests get byte-identical replies
                    reply_hdr["ts_mono"] = time.monotonic()
                try:
                    send_msg(conn, reply_hdr, reply_blob,
                             secret=self._secret)
                except OSError:
                    return  # peer went away mid-reply; it will retry
        finally:
            with self._conns_lock:
                self._conns.pop(cid, None)
            try:
                conn.close()
            except OSError:
                pass

    # -- dispatch ------------------------------------------------------------

    def _dispatch(self, header: dict, blob: bytes) -> Tuple[dict, bytes]:
        # continue the wire-carried trace: every event/span
        # the backend emits while handling this frame — admission, batch
        # membership, result store — lands in THIS replica's stream
        # stamped with the request's fleet-wide trace id
        with obs.trace_scope(obs.trace_from_wire(header, site="server")):
            return self._dispatch_traced(header, blob)

    def _dispatch_traced(self, header: dict,
                         blob: bytes) -> Tuple[dict, bytes]:
        op = header.get("op")
        try:
            if op == "ping":
                return {"ok": True}, b""
            if op == "health":
                h = self.backend.health()
                return {"ok": True,
                        "health": json.loads(
                            json.dumps(h, default=repr))}, b""
            if op == "submit":
                return self._op_submit(blob)
            if op == "submit_forecast":
                return self._op_submit_forecast(header, blob)
            if op == "result":
                return self._op_result(header)
            return {"error": "bad_request",
                    "message": f"unknown op {op!r}"}, b""
        except NotLeaderError as e:
            return {"error": "not_leader", "message": str(e)}, b""
        except ReadOnlyError as e:
            return {"error": "read_only", "message": str(e),
                    "retry_after_s": e.retry_after_s}, b""
        except FencedError as e:
            return {"error": "fenced", "message": str(e)}, b""
        except StorageError as e:
            # before RejectedError (its base): storage refusals carry a
            # distinct kind so clients prefer OTHER replicas
            return {"error": "storage_degraded", "message": str(e),
                    "retry_after_s": e.retry_after_s}, b""
        except RejectedError as e:
            return {"error": "rejected", "message": str(e),
                    "retry_after_s": e.retry_after_s,
                    "shed": e.shed}, b""
        except ServerClosedError as e:
            return {"error": "closed", "message": str(e)}, b""
        except (ValueError, TypeError, KeyError, FrameError) as e:
            return {"error": "bad_request",
                    "message": f"{type(e).__name__}: {e}"}, b""
        except Exception as e:  # noqa: BLE001 - handler never kills listener
            obs.event("transport.internal_error", op=op,
                      error=repr(e)[:300])
            return {"error": "internal",
                    "message": f"{type(e).__name__}: {e}"}, b""

    def _op_submit(self, blob: bytes) -> Tuple[dict, bytes]:
        values, meta = decode_request_blob(blob)
        req_id = meta.get("req_id")
        if req_id and self.backend.request_pending(req_id):
            # idempotent resubmit of an in-flight id: already durable,
            # the serve loop will answer it — ack instead of re-admitting
            return {"ok": True, "req_id": req_id, "pending": True}, b""
        try:
            ticket = self.backend.submit(
                meta["tenant"], values, meta.get("model", "arima"),
                priority=int(meta.get("priority") or 0),
                deadline_s=meta.get("deadline_s"),
                request_id=req_id,
                **(meta.get("fit_kwargs") or {}))
        except RejectedError:
            # raced another resubmit of the same id into admission: the
            # winner's record is durable, which is all the ack promises
            if req_id and self.backend.request_pending(req_id):
                return {"ok": True, "req_id": req_id, "pending": True}, b""
            raise
        return {"ok": True, "req_id": ticket.req_id}, b""

    def _op_submit_forecast(self, header: dict,
                            blob: bytes) -> Tuple[dict, bytes]:
        values, meta = decode_request_blob(blob)
        with np.load(io.BytesIO(blob)) as z:
            fitted = np.array(z["fitted"])
            status = np.array(z["status"]) if "status" in z else None
        req_id = meta.get("req_id")
        if req_id and self.backend.request_pending(req_id):
            return {"ok": True, "req_id": req_id, "pending": True}, b""
        fc = meta.get("forecast") or {}
        try:
            ticket = self.backend.submit_forecast(
                meta["tenant"], values, fitted,
                model=fc.get("model", "arima"),
                horizon=int(fc.get("horizon") or 1),
                model_kwargs=fc.get("model_kwargs") or {},
                status=status,
                intervals=bool(fc.get("intervals")),
                level=float(fc.get("level") or 0.9),
                n_samples=int(fc.get("n_samples") or 256),
                seed=fc.get("seed"),
                priority=int(meta.get("priority") or 0),
                deadline_s=meta.get("deadline_s"),
                request_id=req_id)
        except RejectedError:
            if req_id and self.backend.request_pending(req_id):
                return {"ok": True, "req_id": req_id, "pending": True}, b""
            raise
        return {"ok": True, "req_id": ticket.req_id}, b""

    def _op_result(self, header: dict) -> Tuple[dict, bytes]:
        req_id = header.get("req_id")
        if not req_id:
            return {"error": "bad_request",
                    "message": "result op needs req_id"}, b""
        try:
            res = self.backend.result_for(req_id)
        except KeyError:
            if self.backend.request_pending(req_id):
                return {"ok": True, "done": False, "req_id": req_id}, b""
            return {"error": "unknown_request", "req_id": req_id,
                    "message": f"request {req_id!r} has no stored result "
                               "and is not in flight — resubmit it "
                               "(idempotent by request id)"}, b""
        return ({"ok": True, "done": True, "req_id": req_id},
                encode_result_blob(res))
