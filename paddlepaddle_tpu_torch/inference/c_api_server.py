"""Server half of the C inference API (native/paddle_inference_c.cpp).

The port's own copy of the jax-free ``paddlepaddle_tpu/inference/
c_api_server.py``. Its frames are the reference's byte for byte, so the
repo's native client (``native/libpaddle_inference_c.so``) and the
reference's Python clients talk to it unchanged.

Reference surface: paddle/fluid/inference/capi_exp/ — there the C API calls
into the in-process C++ predictor; here the predictor is a program owned by
this Python runtime, so the C library is a native client speaking a
length-prefixed binary protocol over a Unix domain socket (or loopback
TCP), and this module is the listener that runs the program on the device.
One thread per connection; tensors cross as raw little-endian numpy
buffers (f32/i64/i32/u8). The predictor ops serve any object with
``get_input_names`` / ``get_output_names`` / ``run`` (numpy arrays in;
numpy arrays or torch tensors out).

Beyond the predictor ops (``_OP_RUN/_OP_INFO/_OP_HEALTH/_OP_METRICS``)
the server can front a live :class:`~.serving.ServingEngine` (pass
``engine=``), which arms the replica-process ops the remote fleet is
built on (:mod:`~.remote_replica`):

* ``_OP_SUBMIT`` — STREAMING: one generation request per connection.
  Request kwargs cross as JSON + the prompt as a packed tensor; the
  server answers with chunk frames (status 2: admit / first-token /
  progress events) and exactly one terminal frame — status 0 with the
  SLO stamps, the stitched request-journey spans, and the output tensor,
  or status 3 with a TYPED error document
  (:func:`~.robustness.error_to_wire`) so the client rehydrates the
  same exception class the in-process engine would have raised. A client
  that disconnects mid-stream gets its request cancelled — the decode
  slot (and its KV pages) come back on the next scheduler cycle.
* ``_OP_DRAIN`` — graceful admission close (JSON ``{timeout, reason}``).
* ``_OP_RESTART`` — drain + in-place engine restart for native clients;
  the replica supervisor restarts by SIGTERM/respawn instead.

Wire hardening (the netchaos proxy's counterpart — see
``docs/serving.md`` "Wire-protocol hardening"):

* **frame CRC** — a submit header carrying ``"crc": true`` negotiates
  CRC32-protected frames for that stream: the status byte gains the
  ``_ST_CRC_FLAG`` high bit and a ``<u32 crc32(rest)>`` follows it.
  Legacy clients never set the flag and keep the old frames bit-exact.
* **idempotent submit** — a header ``req_uid`` keys a bounded ring of
  recent terminal results; a resubmit whose uid has a cached terminal
  replays it without decoding again (the ambiguous-failure case: the
  decode finished but the terminal frame was lost on the wire).
* **write deadline + bounded send buffer** — ``SO_SNDTIMEO`` +
  ``SO_SNDBUF`` per connection, so a slow-loris client (reads at
  1 byte/s, or never) sheds with a cancelled request instead of wedging
  this handler thread in ``sendall`` forever.
* **mid-frame read deadline** — once a frame STARTS arriving, the rest
  must land within ``frame_timeout_s`` (idle waits between requests stay
  unbounded — persistent native connections are legal). A trickled or
  abandoned half-frame gets an error frame and a close, bounded-time.
"""

from __future__ import annotations

import json
import os
import select
import socket
import struct
import threading
import zlib
from collections import OrderedDict
from time import perf_counter as _now
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

_MAGIC = 0x50444331
_DTYPES = [np.dtype("<f4"), np.dtype("<i8"), np.dtype("<i4"), np.dtype("u1")]
_OP_RUN, _OP_INFO, _OP_HEALTH, _OP_METRICS = 1, 2, 3, 4
_OP_SUBMIT, _OP_DRAIN, _OP_RESTART = 5, 6, 7

# reply statuses. 1 carries a plain text message (the predictor ops'
# legacy form); 3 carries a JSON error document that rehydrates into the
# SAME typed exception client-side (robustness.error_from_wire); 2 is a
# mid-stream submit chunk. Every nonzero status has the same
# <u32 len | payload> body shape, so a legacy native client reading any
# nonzero status as "error text" keeps working.
_ST_OK, _ST_ERR, _ST_CHUNK, _ST_TYPED = 0, 1, 2, 3

# status-byte high bit: the frame payload is CRC-protected —
# <u32 magic><u8 status|0x80><u32 crc32(rest)><rest>. Only set on submit
# streams whose client ASKED (hdr {"crc": true}), so legacy peers never
# see it; the low 7 bits still carry the real status.
_ST_CRC_FLAG = 0x80

# the server heartbeats an idle submit stream this often — exported so
# RemoteReplicaClient can cross-check its watchdog against it (a client
# heartbeat_timeout_s at or below this guarantees spurious stalls)
_HB_INTERVAL_S = 0.5

# a frame length past this is garbage (or an attack), not a request: reply
# with an error frame and close instead of trying to buffer it
_MAX_FRAME = 1 << 28  # 256 MiB


class _FrameStall(Exception):
    """A started frame did not finish within ``frame_timeout_s``."""

    def __init__(self, missing: int):
        super().__init__(f"{missing} bytes missing")
        self.missing = int(missing)


def crc_wrap(frame: bytes) -> bytes:
    """Arm a reply frame's CRC: flag the status byte, splice the checksum
    of everything after it. ``frame`` is ``<u32 magic><u8 status><rest>``."""
    rest = frame[5:]
    return (frame[:4] + bytes([frame[4] | _ST_CRC_FLAG])
            + struct.pack("<I", zlib.crc32(rest)) + rest)


class _ResultRing:
    """Bounded req_uid → terminal-frame cache backing idempotent submit.
    Holds the last ``cap`` OK terminals (raw frames, pre-CRC); a resubmit
    that hits replays the bytes instead of decoding twice. Error
    terminals are NOT cached — a retry after a typed failure must re-run."""

    def __init__(self, cap: int = 256):
        self.cap = int(cap)
        self._d: "OrderedDict[str, bytes]" = OrderedDict()
        self._lock = threading.Lock()
        self.replays = 0

    def put(self, uid: str, frame: bytes) -> None:
        with self._lock:
            self._d[uid] = frame
            self._d.move_to_end(uid)
            while len(self._d) > self.cap:
                self._d.popitem(last=False)

    def get(self, uid: str) -> Optional[bytes]:
        with self._lock:
            frame = self._d.get(uid)
            if frame is not None:
                self._d.move_to_end(uid)
            return frame

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)


def _pack_tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    matches = [i for i, d in enumerate(_DTYPES) if d == arr.dtype.newbyteorder("<")]
    if not matches:
        raise ValueError(
            f"tensor {name!r} has dtype {arr.dtype}, which the C API wire "
            f"format does not carry (supported: float32, int64, int32, "
            f"uint8) — cast the model output first")
    code = matches[0]
    head = struct.pack("<I", len(name)) + name.encode()
    head += struct.pack("<B", code) + struct.pack("<I", arr.ndim)
    head += b"".join(struct.pack("<q", d) for d in arr.shape)
    return head + arr.tobytes()


class _Cursor:
    def __init__(self, buf: bytes):
        self.b, self.o = buf, 0

    def take(self, fmt: str):
        v = struct.unpack_from("<" + fmt, self.b, self.o)
        self.o += struct.calcsize("<" + fmt)
        return v if len(v) > 1 else v[0]

    def raw(self, n: int) -> bytes:
        out = self.b[self.o:self.o + n]
        self.o += n
        return out


def _unpack_tensor(c: _Cursor) -> Tuple[str, np.ndarray]:
    name = c.raw(c.take("I")).decode()
    code = c.take("B")
    ndim = c.take("I")
    dims = [c.take("q") for _ in range(ndim)]
    dt = _DTYPES[code]
    n = int(np.prod(dims)) if dims else 1
    arr = np.frombuffer(c.raw(n * dt.itemsize), dtype=dt).reshape(dims)
    return name, arr


def _as_numpy(x) -> np.ndarray:
    """A predictor output as a host array (a torch tensor is copied off its
    device)."""
    if hasattr(x, "detach") and hasattr(x, "cpu"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class CApiServer:
    """Serves a Predictor (or any (named inputs) -> [outputs] callable).

    ``health_fn`` (optional) backs the ``_OP_HEALTH`` frame — pass
    ``ServingEngine.health`` (or any () -> dict) and native clients get the
    readiness snapshot as JSON without touching Python. ``metrics_fn``
    (optional) backs the ``_OP_METRICS`` frame — it defaults to the
    process-wide ``observability.to_prometheus_text()``, so a native client
    (or a sidecar scraper with a UDS pipe) can pull the same exposition
    text the HTTP exporter serves; an empty registry yields an OK frame
    with a zero-length payload, not an error."""

    def __init__(self, predictor, socket_path: Optional[str] = None,
                 input_names: Optional[Sequence[str]] = None,
                 output_names: Optional[Sequence[str]] = None,
                 health_fn: Optional[Callable[[], dict]] = None,
                 metrics_fn: Optional[Callable[[], str]] = None,
                 engine=None,
                 port: Optional[int] = None,
                 host: str = "127.0.0.1",
                 heartbeat_interval_s: float = _HB_INTERVAL_S,
                 write_timeout_s: float = 10.0,
                 frame_timeout_s: float = 30.0,
                 send_buffer_bytes: Optional[int] = 256 * 1024,
                 result_cache: int = 256):
        if socket_path is None and port is None:
            raise ValueError("CApiServer needs socket_path= (UDS) or "
                             "port= (loopback TCP)")
        self.predictor = predictor
        self.path = socket_path
        self.port = port          # 0 = ephemeral; real port after start()
        self.host = host
        self.engine = engine      # arms _OP_SUBMIT/_OP_DRAIN/_OP_RESTART
        self.health_fn = health_fn
        self.metrics_fn = metrics_fn
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.write_timeout_s = float(write_timeout_s)
        self.frame_timeout_s = float(frame_timeout_s)
        self.send_buffer_bytes = send_buffer_bytes
        self._results = _ResultRing(result_cache)
        if predictor is None:
            self.input_names = list(input_names or [])
            self.output_names = list(output_names or [])
        else:
            self.input_names = list(input_names if input_names is not None
                                    else predictor.get_input_names())
            self.output_names = list(
                output_names if output_names is not None
                else predictor.get_output_names())
        self._sock: Optional[socket.socket] = None
        self._threads: List[threading.Thread] = []
        self._conns: List[socket.socket] = []
        self._conns_lock = threading.Lock()
        self._stop = threading.Event()

    # -- protocol -----------------------------------------------------------
    def _reply_ok(self, body: bytes) -> bytes:
        return struct.pack("<IB", _MAGIC, 0) + body

    def _reply_err(self, msg: str) -> bytes:
        m = msg.encode()[:4096]
        return struct.pack("<IB", _MAGIC, 1) + struct.pack("<I", len(m)) + m

    def _reply_json(self, status: int, doc: dict,
                    tail: bytes = b"") -> bytes:
        blob = json.dumps(doc, default=str).encode()
        return (struct.pack("<IB", _MAGIC, status)
                + struct.pack("<I", len(blob)) + blob + tail)

    def _reply_typed(self, exc: BaseException, **extra) -> bytes:
        from .robustness import error_to_wire

        doc = error_to_wire(exc)
        doc.update(extra)
        return self._reply_json(_ST_TYPED, doc)

    @staticmethod
    def _send_frame(conn: socket.socket, frame: bytes) -> None:
        conn.sendall(struct.pack("<Q", len(frame)) + frame)

    def _handle(self, req: bytes) -> Tuple[bytes, bool]:
        """Returns (reply frame, close_connection). A malformed frame (bad
        magic, truncated payload, garbage tensor header) gets an ERROR
        frame and a close — never an unhandled struct.error that kills the
        connection thread with no reply on the wire."""
        c = _Cursor(req)
        try:
            if c.take("I") != _MAGIC:
                return self._reply_err("bad magic"), True
            op = c.take("B")
        except struct.error:
            return self._reply_err("malformed frame: truncated header"), True
        if op == _OP_INFO:
            body = struct.pack("<I", len(self.input_names))
            for n in self.input_names:
                body += struct.pack("<I", len(n)) + n.encode()
            body += struct.pack("<I", len(self.output_names))
            for n in self.output_names:
                body += struct.pack("<I", len(n)) + n.encode()
            return self._reply_ok(body), False
        if op == _OP_HEALTH:
            try:
                snap = self.health_fn() if self.health_fn is not None \
                    else {"state": "serving", "ok": True}
                payload = json.dumps(snap, default=str).encode()
            except Exception as e:
                return self._reply_err(f"health probe failed: {e}"), False
            return (self._reply_ok(struct.pack("<I", len(payload)) + payload),
                    False)
        if op == _OP_METRICS:
            try:
                if self.metrics_fn is not None:
                    text = self.metrics_fn()
                else:
                    from ..observability import to_prometheus_text

                    text = to_prometheus_text()
                payload = text.encode()
            except Exception as e:
                return self._reply_err(f"metrics scrape failed: {e}"), False
            return (self._reply_ok(struct.pack("<I", len(payload)) + payload),
                    False)
        if op == _OP_DRAIN:
            if self.engine is None:
                return self._reply_err("no serving engine attached"), False
            try:
                kw = {}
                if c.o < len(c.b):
                    kw = json.loads(c.raw(c.take("I")).decode() or "{}")
                res = self.engine.drain(kw.get("timeout"),
                                        reason=kw.get("reason", "drain"))
                return self._reply_json(_ST_OK, dict(res)), False
            except Exception as e:
                return self._reply_typed(e), False
        if op == _OP_RESTART:
            if self.engine is None:
                return self._reply_err("no serving engine attached"), False
            try:
                kw = {}
                if c.o < len(c.b):
                    kw = json.loads(c.raw(c.take("I")).decode() or "{}")
                self.engine.drain(kw.get("timeout"), reason="restart")
                self.engine.start()
                return self._reply_json(
                    _ST_OK, {"ok": True,
                             "health": self.engine.health()}), False
            except Exception as e:
                return self._reply_typed(e), False
        if op != _OP_RUN:
            return self._reply_err(f"unknown op {op}"), False
        try:
            n = c.take("I")
            named = dict(_unpack_tensor(c) for _ in range(n))
        except Exception:  # struct.error / bad dtype code / absurd dims
            return (self._reply_err("malformed frame: truncated or invalid "
                                    "tensor payload"), True)
        try:
            inputs = [named[k] for k in self.input_names]
            outs = self.predictor.run(inputs)
            # the name snapshot may predate the first run (Predictor only
            # knows its real output arity after running) — never let the
            # declared count and the serialized tensors disagree
            names = (self.output_names if len(self.output_names) == len(outs)
                     else [f"output_{i}" for i in range(len(outs))])
            self.output_names = names
            body = struct.pack("<I", len(outs))
            for name, o in zip(names, outs):
                body += _pack_tensor(name, _as_numpy(o))
            return self._reply_ok(body), False
        except Exception as e:  # surfaced as PD_PredictorGetLastError
            return self._reply_err(f"{type(e).__name__}: {e}"), False

    # -- streaming submit (one request per connection) -----------------------
    def _handle_submit(self, c: _Cursor, conn: socket.socket) -> None:
        """``_OP_SUBMIT``: parse kwargs + prompt, submit to the engine,
        stream lifecycle chunks, finish with ONE terminal frame (typed
        error or SLO header + output tensor). The connection is this
        request's: it closes when the frame lands. A half-written stream
        whose client disconnected cancels the request, releasing its
        decode slot and KV pages — a dead client must not leak pages.

        Hardening seams (all negotiated by the CLIENT's header, so legacy
        peers are untouched): ``"crc": true`` arms CRC32 frames for this
        stream; ``"req_uid"`` keys the idempotent-resubmit ring — a uid
        whose terminal is cached REPLAYS it, zero re-decode. Writes ride
        the connection's ``SO_SNDTIMEO``: a client that stops reading
        (slow-loris) trips it, the request is cancelled and the decode
        slot released instead of this thread wedging in ``sendall``."""
        from .robustness import RequestValidationError, error_to_wire
        from .robustness import safe_inc as _safe_inc

        eng = self.engine
        try:
            hdr = json.loads(c.raw(c.take("I")).decode())
            if not isinstance(hdr, dict):
                raise ValueError("submit kwargs must be a JSON object")
            _, prompt = _unpack_tensor(c)
        except Exception:
            self._send_frame(conn, self._reply_typed(RequestValidationError(
                "malformed _OP_SUBMIT frame: truncated or invalid "
                "kwargs/prompt payload")))
            return
        crc = bool(hdr.pop("crc", False))
        uid = hdr.pop("req_uid", None)

        def send(frame: bytes) -> None:
            self._send_frame(conn, crc_wrap(frame) if crc else frame)

        if eng is None:
            send(self._reply_typed(RequestValidationError(
                "this server has no serving engine attached "
                "(predictor-only endpoint)")))
            return
        if uid:
            cached = self._results.get(str(uid))
            if cached is not None:
                # idempotent resubmit: this uid already decoded to a
                # terminal once — its frame was (presumably) lost on the
                # wire. Replay the cached bytes: token-exact by
                # construction, zero engine work, never a double decode
                self._results.replays += 1
                _safe_inc("paddle_capi_dedup_replays_total",
                          "resubmits served from the terminal-result ring "
                          "instead of decoding again")
                try:
                    send(self._reply_json(_ST_CHUNK, {"ev": "accepted"}))
                    send(self._reply_json(_ST_CHUNK, {"ev": "replay"}))
                    send(cached)
                except OSError:
                    pass
                return
        journey = None
        tr = hdr.pop("trace", None)
        if isinstance(tr, dict):
            # a wire journey: a plain span collector carrying the parent
            # trace id — NOT registered in this process's in-flight ring
            # (the client owns the journey; replica-side spans travel
            # back in the terminal frame and are stitched there)
            try:
                from ..observability import reqtrace as _rt

                journey = _rt.Journey(tr.get("req_id"), 256)
                journey.trace_id = str(tr.get("trace_id")
                                       or journey.trace_id)
            except Exception:
                journey = None
        kw = {k: hdr[k] for k in ("max_new_tokens", "temperature", "top_k",
                                  "eos_token_id", "deadline_s",
                                  "prefix_len")
              if hdr.get(k) is not None}
        if journey is not None:
            kw["trace"] = journey
        try:
            # a writable copy: the frame's buffer is read-only, and the
            # engine hands the prompt to torch
            fut = eng.submit(np.array(prompt), **kw)
        except Exception as e:       # typed admission refusal, validation
            send(self._reply_typed(e))
            return
        try:
            # the client's submit() blocks on this first frame: accepted
            # here mirrors the in-process contract where a returning
            # submit() call IS the admission decision
            send(self._reply_json(_ST_CHUNK, {"ev": "accepted"}))
            sent_admit = sent_first = False
            last_n = 0
            last_tx = _now()
            while not fut._event.wait(0.005):
                # disconnect probe: the client never writes after the
                # request frame, so any EOF here means it went away
                try:
                    if conn.recv(1, socket.MSG_DONTWAIT) == b"":
                        fut.cancel()
                        return
                except (BlockingIOError, InterruptedError):
                    pass
                except OSError:
                    fut.cancel()
                    return
                events = []
                if not sent_admit and fut._t_admit is not None:
                    sent_admit = True
                    events.append({"ev": "admit"})
                if not sent_first and fut._t_first is not None:
                    sent_first = True
                    last_n = fut._n_at_first
                    events.append({"ev": "first", "n": fut._n_at_first})
                if sent_first and fut._n_new > last_n:
                    last_n = fut._n_new
                    events.append({"ev": "progress", "n": last_n})
                if (not events
                        and _now() - last_tx > self.heartbeat_interval_s):
                    # heartbeat: a long decode with nothing to report
                    # must not read as a dead replica to the client's
                    # stall watchdog
                    events.append({"ev": "hb"})
                for ev in events:
                    send(self._reply_json(_ST_CHUNK, ev))
                if events:
                    last_tx = _now()
            err = fut._error
            if err is not None:
                doc = error_to_wire(err)
                if journey is not None:
                    doc["journey"] = self._journey_wire(journey)
                send(self._reply_json(_ST_TYPED, doc))
                return
            out = np.ascontiguousarray(np.asarray(fut._output))
            head = {
                "n_new": fut._n_new,
                "n_at_first": fut._n_at_first,
                "streaming": bool(fut._streaming),
                # lifecycle stamps as offsets from the REPLICA-side
                # submit: the client re-anchors them on its own clock
                "admit_rel": (None if fut._t_admit is None
                              else fut._t_admit - fut._t_submit),
                "first_rel": (None if fut._t_first is None
                              else fut._t_first - fut._t_submit),
                "done_rel": (None if fut._t_done is None
                             else fut._t_done - fut._t_submit),
            }
            if journey is not None:
                head["journey"] = self._journey_wire(journey)
            terminal = self._reply_json(
                _ST_OK, head, _pack_tensor("output_ids", out))
            if uid:
                # cache BEFORE the send: the case dedup exists for is the
                # terminal frame dying on the wire after decode finished
                self._results.put(str(uid), terminal)
            send(terminal)
        except (socket.timeout, BlockingIOError):
            # the per-connection write deadline (SO_SNDTIMEO) tripped:
            # the client reads too slowly to drain our bounded send
            # buffer (slow-loris) — shed it and release the decode slot
            # instead of wedging this handler thread in sendall
            _safe_inc("paddle_capi_write_timeouts_total",
                      "submit streams shed because the client stopped "
                      "draining its socket before the write deadline")
            try:
                from ..observability import flight
                flight.record("capi", "write_timeout",
                              timeout_s=self.write_timeout_s)
            except Exception:
                pass
            fut.cancel()
        except OSError:
            # client went away mid-stream (BrokenPipe/reset): release the
            # slot — kv.pages_free must come back to its idle value
            fut.cancel()
        finally:
            if not fut.done():
                fut.cancel()

    @staticmethod
    def _journey_wire(j) -> dict:
        return {"trace_id": j.trace_id, "t0_wall": j.t0_wall,
                "spans": list(j.spans), "dropped": j.dropped}

    # -- transport ----------------------------------------------------------
    def _recv_within(self, conn: socket.socket, n: int,
                     deadline: float) -> Optional[bytes]:
        """Read exactly ``n`` bytes before ``deadline`` (monotonic).
        Returns None on EOF, raises :class:`_FrameStall` on deadline.
        select-based so it composes with the connection's blocking
        mode — ``settimeout`` would also put ``recv(1, MSG_DONTWAIT)``
        disconnect probes to sleep, breaking the 5 ms submit poll loop."""
        buf = b""
        while len(buf) < n:
            left = deadline - _now()
            if left <= 0:
                raise _FrameStall(n - len(buf))
            r, _, _ = select.select([conn], [], [], min(left, 1.0))
            if not r:
                continue
            chunk = conn.recv(min(1 << 20, n - len(buf)))
            if not chunk:
                return None
            buf += chunk
        return buf

    def _serve_conn(self, conn: socket.socket):
        from .robustness import safe_inc as _safe_inc

        try:
            # bounded send buffer + kernel write deadline: a peer that
            # stops reading makes sendall raise (socket.timeout /
            # BlockingIOError) after write_timeout_s instead of wedging
            # this thread for the life of the connection
            try:
                if self.send_buffer_bytes:
                    conn.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                                    int(self.send_buffer_bytes))
                if self.write_timeout_s:
                    sec = int(self.write_timeout_s)
                    usec = int((self.write_timeout_s - sec) * 1e6)
                    conn.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                                    struct.pack("ll", sec, usec))
            except OSError:
                pass   # non-fatal: platform without the sockopt
            with conn:
                while not self._stop.is_set():
                    # the wait for a frame's FIRST byte is unbounded — a
                    # persistent legacy connection may idle between ops.
                    # Once a frame starts, the rest must land within
                    # frame_timeout_s or the peer is stalling us mid-frame
                    first = conn.recv(1)
                    if not first:
                        return
                    deadline = _now() + self.frame_timeout_s
                    try:
                        rest = self._recv_within(conn, 7, deadline)
                        if rest is None:
                            return
                        (length,) = struct.unpack("<Q", first + rest)
                        if length > _MAX_FRAME:
                            # status 1 (not typed): the op byte lives
                            # inside the payload we refuse to buffer, so
                            # the peer may be a legacy native client —
                            # keep the legacy error-frame contract here
                            reply = self._reply_err(
                                f"frame length {length} exceeds max "
                                f"{_MAX_FRAME} bytes")
                            conn.sendall(
                                struct.pack("<Q", len(reply)) + reply)
                            return
                        buf = self._recv_within(conn, length, deadline)
                        if buf is None:
                            return
                    except _FrameStall as st:
                        # a frame started but never finished: the peer is
                        # stalling us mid-frame (trunc chaos, wedged
                        # client). Typed close in bounded time — never a
                        # handler thread parked on recv forever
                        _safe_inc(
                            "paddle_capi_frame_timeouts_total",
                            "connections closed because a started frame "
                            "did not complete within frame_timeout_s")
                        try:
                            reply = self._reply_err(
                                f"frame read timed out mid-frame: "
                                f"{st.missing} bytes still missing after "
                                f"{self.frame_timeout_s:.0f}s")
                            conn.sendall(
                                struct.pack("<Q", len(reply)) + reply)
                        except OSError:
                            pass
                        return
                    if (len(buf) >= 5
                            and struct.unpack_from("<IB", buf)
                            == (_MAGIC, _OP_SUBMIT)):
                        # streaming op: owns the connection, one request
                        # per connection, closes when the terminal frame
                        # (or the client) goes away
                        c = _Cursor(buf)
                        c.take("I")
                        c.take("B")
                        self._handle_submit(c, conn)
                        return
                    reply, close = self._handle(buf)
                    conn.sendall(struct.pack("<Q", len(reply)) + reply)
                    if close:
                        return
        finally:
            with self._conns_lock:
                try:
                    self._conns.remove(conn)
                except ValueError:
                    pass   # stop() already cleared the list

    def start(self):
        if self.port is not None:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._sock.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEADDR, 1)
            self._sock.bind((self.host, self.port))
            self.port = self._sock.getsockname()[1]   # resolve port 0
        else:
            if os.path.exists(self.path):
                os.unlink(self.path)
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._sock.bind(self.path)
        self._sock.listen(8)

        def accept_loop():
            while not self._stop.is_set():
                try:
                    conn, _ = self._sock.accept()
                except OSError:
                    return
                t = threading.Thread(target=self._serve_conn, args=(conn,),
                                     daemon=True)
                t.start()
                with self._conns_lock:
                    self._conns.append(conn)
                # prune finished handlers so a long-lived server does not
                # accumulate dead Thread objects per connection
                self._threads = [x for x in self._threads if x.is_alive()]
                self._threads.append(t)

        t = threading.Thread(target=accept_loop, daemon=True)
        t.start()
        self._threads.append(t)
        return self

    def stop(self):
        self._stop.set()
        if self._sock is not None:
            self._sock.close()
        with self._conns_lock:
            conns, self._conns = self._conns[:], []
        for conn in conns:            # unblock handlers waiting in recv
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        if self.path is not None and os.path.exists(self.path):
            os.unlink(self.path)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def serve_predictor(predictor, socket_path: str,
                    health_fn: Optional[Callable[[], dict]] = None
                    ) -> CApiServer:
    """Start serving ``predictor`` for native clients; returns the server."""
    return CApiServer(predictor, socket_path, health_fn=health_fn).start()
