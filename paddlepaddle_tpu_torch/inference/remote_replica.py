"""True multi-process fleet: socket-backed replica client + OS-process
supervisor.

The port's own copy of the jax-free ``paddlepaddle_tpu/inference/
remote_replica.py``. The supervisor spawns the port's replica process,
``python -m paddlepaddle_tpu_torch.inference.replica_main``, which serves
on the card unless ``--device cpu`` is passed (``extra_args``). A respawned
replica finds its kernel libraries in the package's build directory (or
loads them from its ``--bundle``), so it runs no ``nvcc``. The wire is the
reference's, so this client serves a reference replica process and the
reference's client serves the port's.

Reference surface: the reference fleet executor runs replicas as real
processes by construction (paddle/fluid distributed serving); here the
same boundary lands on the serving engine's seams:

* :class:`RemoteReplicaClient` implements the exact 4-method
  :class:`~.router.ReplicaClient` surface (submit/health/drain/restart,
  plus start/stop/warmup/kill) over the C-API frame protocol against a
  :mod:`~.replica_main` process. Typed errors rehydrate through
  :func:`~.robustness.error_from_wire`, so the router's failover,
  breaker, and backoff semantics are byte-identical to in-process; a
  request journey (:mod:`~..observability.reqtrace`) rides the submit
  frame as ``{trace_id, req_id}`` and the replica's spans come back in
  the terminal frame, re-anchored onto the client's clock — one stitched
  waterfall across the process hop.
* :class:`ReplicaSupervisor` spawns/monitors/restarts the engine process
  from a bundle path: readiness via the ``REPLICA_READY`` line,
  crash-loop exponential backoff with jitter on unexpected exits
  (:func:`~..resilience.retry.compute_delay`), last-exit capture (code +
  final output lines) for the health block,
  ``paddle_replica_{spawns,crashes,crash_loop_backoffs}_total``
  counters. restart = SIGTERM → drain (the preemption hook) → respawn; kill =
  SIGKILL — the chaos seam is a real process death.
* :class:`ProcessReplicaFactory` slots both into
  :class:`~.fleet.FleetController`'s versioned replica factory
  (``makes_clients`` marker), so autoscaling, canary deploys, and
  rolling restarts manage OS processes, each loading its serving bundle
  in a fresh interpreter — which deletes the in-process "Symbols not
  found" bundle caveat instead of documenting it.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import uuid
import zlib
from collections import deque
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from ..resilience.retry import RetryPolicy, call_with_retry, compute_delay
from .c_api_server import (
    _HB_INTERVAL_S,
    _MAGIC,
    _OP_DRAIN,
    _OP_HEALTH,
    _OP_RESTART,
    _OP_SUBMIT,
    _ST_CHUNK,
    _ST_CRC_FLAG,
    _ST_OK,
    _ST_TYPED,
    _Cursor,
    _pack_tensor,
    _unpack_tensor,
)
from .robustness import ReplicaStalledError, WireCorruptionError, \
    error_from_wire
from .robustness import safe_inc as _safe_inc
from .router import ReplicaClient
from .serving import _REQ_IDS, GenerationResult

__all__ = ["RemoteReplicaClient", "ReplicaSupervisor",
           "ProcessReplicaFactory"]

_KEEP = object()      # restart(): "keep the current bundle" sentinel


# ---------------------------------------------------------------------------
# wire plumbing
# ---------------------------------------------------------------------------

def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("replica closed the connection")
        buf += chunk
    return buf


def _recv_frame(sock: socket.socket) -> bytes:
    (length,) = struct.unpack("<Q", _recv_exact(sock, 8))
    return _recv_exact(sock, length)


def _send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(struct.pack("<Q", len(payload)) + payload)


def _parse_reply(frame: bytes) -> Tuple[int, _Cursor]:
    c = _Cursor(frame)
    if c.take("I") != _MAGIC:
        raise ConnectionError("bad reply magic from replica")
    status = c.take("B")
    if status & _ST_CRC_FLAG:
        # CRC-armed frame (this stream asked for it): verify before ANY
        # byte of the payload is interpreted — corruption must surface as
        # a typed infra failure, never as wrong tokens
        want = c.take("I")
        rest = c.b[c.o:]
        if zlib.crc32(rest) != want:
            raise WireCorruptionError(
                f"frame payload failed CRC32 ({len(rest)} bytes, "
                f"status {status & 0x7F})")
        status &= 0x7F
    return status, c


def _json_body(c: _Cursor) -> dict:
    return json.loads(c.raw(c.take("I")).decode() or "{}")


def _stitch_journey(parent, wire: Optional[dict], replica: str) -> None:
    """Append the replica process's spans onto the client-side journey,
    re-anchored by the wall-clock offset between the two processes'
    journey births (perf_counter and wall clocks advance in lockstep on
    one host, so the wall delta IS the perf_counter delta)."""
    if parent is None or not wire:
        return
    try:
        delta = float(wire.get("t0_wall") or 0.0) - parent.t0_wall
        for s in wire.get("spans") or []:
            if len(parent.spans) >= parent.max_spans:
                parent.dropped += 1
                continue
            s2 = dict(s)
            s2["t"] = round(float(s.get("t", 0.0)) + delta, 6)
            s2.setdefault("replica", replica)
            parent.spans.append(s2)
        parent.dropped += int(wire.get("dropped") or 0)
    except Exception:
        pass        # observability must never break request delivery


# ---------------------------------------------------------------------------
# the socket-backed ReplicaClient
# ---------------------------------------------------------------------------

class RemoteReplicaClient(ReplicaClient):
    """The :class:`~.router.ReplicaClient` surface over a replica
    PROCESS (a subclass so the router's isinstance wrapping passes
    clients through; every method is overridden — there is no in-process
    engine). ``address`` is a UDS path (str) or a TCP port (int,
    loopback) — or pass ``supervisor=`` and the address (and the process
    behind it) is the supervisor's, re-resolved per connection so a
    respawned replica on a fresh ephemeral port is found again.

    Transport failures surface as ``ConnectionError``/``TimeoutError`` —
    untyped, which the router classifies as retryable infra failure:
    a dead process reads exactly like :meth:`ReplicaClient.kill` did
    in-process. Typed serving errors cross the wire as JSON and
    rehydrate into the same classes (same retryability, same
    ``retry_after_s`` hints).

    Wire hardening (all client-negotiated, legacy servers unaffected):

    * **stall watchdog** — the submit stream expects SOME frame (chunk,
      heartbeat, terminal) within ``heartbeat_timeout_s``; silence means
      the wire black-holed, and the typed retryable
      :class:`~.robustness.ReplicaStalledError` fails the request over
      in ~2 s instead of pinning it for ``read_timeout_s``.
    * **frame CRC** — ``crc=True`` (default) asks the server to CRC32
      its reply payloads; a mismatch raises the typed retryable
      :class:`~.robustness.WireCorruptionError` and abandons the
      connection.
    * **idempotent submit** — every submit carries a ``req_uid``; a
      resubmit of the same uid after an ambiguous failure replays the
      server's cached terminal instead of decoding twice.

    Set ``PADDLE_NETCHAOS`` and every connection routes through a
    :class:`~..resilience.netchaos.NetChaosProxy` injecting the spec'd
    faults — the deterministic chaos drill for all three paths."""

    supports_req_uid = True

    def __init__(self, address=None, name: str = "replica",
                 supervisor: Optional["ReplicaSupervisor"] = None,
                 connect_timeout_s: float = 5.0,
                 read_timeout_s: float = 30.0,
                 heartbeat_timeout_s: float = 2.0,
                 crc: bool = True,
                 connect_policy: Optional[RetryPolicy] = None):
        if address is None and supervisor is None:
            raise ValueError("RemoteReplicaClient needs address= or "
                             "supervisor=")
        self.name = name
        self.supervisor = supervisor
        self._address = address
        self.connect_timeout_s = float(connect_timeout_s)
        self.read_timeout_s = float(read_timeout_s)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.crc = bool(crc)
        self._nc_proxy = None       # None = not checked, False = disabled
        if min(self.heartbeat_timeout_s, self.read_timeout_s) \
                <= _HB_INTERVAL_S:
            # config cross-check: a watchdog at or below the server's
            # heartbeat interval reads EVERY long decode as a stall —
            # guaranteed spurious failovers and breaker evictions. Warn
            # loudly; do not silently "fix" the caller's number
            _safe_inc("paddle_replica_timeout_misconfig_total",
                      "clients built with stall/read timeouts at or "
                      "below the server heartbeat interval",
                      replica=name)
            sys.stderr.write(
                f"[remote-replica] {name}: heartbeat_timeout_s="
                f"{self.heartbeat_timeout_s:g}s / read_timeout_s="
                f"{self.read_timeout_s:g}s is at or below the server "
                f"heartbeat interval ({_HB_INTERVAL_S:g}s) — every "
                f"quiet-but-healthy decode will trip the stall watchdog "
                f"and cause spurious failovers\n")
        # bounded reconnect with jittered backoff for SUBMIT connects: a
        # replica mid-respawn (supervisor restart window) is a transient,
        # not a failover — health probes stay single-attempt so the
        # router's 0.25 s prober is never wedged behind a backoff sleep
        self.connect_policy = connect_policy or RetryPolicy(
            max_attempts=3, base_delay=0.05, max_delay=0.5, jitter=0.25)
        self.generation = 0
        self._killed = False

    # -- transport -----------------------------------------------------------
    def address(self):
        if self.supervisor is not None:
            return self.supervisor.address()
        return self._address

    def _netchaos(self):
        """PADDLE_NETCHAOS auto-wrap: lazily start ONE proxy per client
        targeting :meth:`address` (re-resolved per connection, so a
        supervisor respawn is chased through the proxy too). Disabled =
        one getenv on the first connect, then a cached False."""
        if self._nc_proxy is False:
            return None
        if self._nc_proxy is None:
            from ..resilience import netchaos as _nc

            spec = _nc.env_spec()
            if not spec:
                self._nc_proxy = False
                return None
            self._nc_proxy = _nc.NetChaosProxy(
                self.address, specs=spec,
                name=f"netchaos:{self.name}").start()
        return self._nc_proxy

    def _connect_once(self) -> socket.socket:
        proxy = self._netchaos()
        addr = proxy.address() if proxy is not None else self.address()
        if addr is None:
            raise ConnectionError(
                f"replica {self.name} has no address (process not ready)")
        if isinstance(addr, int):
            s = socket.create_connection(("127.0.0.1", addr),
                                         timeout=self.connect_timeout_s)
        else:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.settimeout(self.connect_timeout_s)
            try:
                s.connect(str(addr))
            except OSError:
                s.close()
                raise
        s.settimeout(self.read_timeout_s)
        return s

    def _connect(self, retry: bool = True) -> socket.socket:
        if not retry:
            return self._connect_once()
        return call_with_retry(self._connect_once,
                               policy=self.connect_policy,
                               name=f"replica_connect:{self.name}")

    def _rpc(self, payload: bytes, retry: bool = False) -> Tuple[int, _Cursor]:
        s = self._connect(retry=retry)
        try:
            _send_frame(s, payload)
            return _parse_reply(_recv_frame(s))
        finally:
            s.close()

    # -- ReplicaClient surface -----------------------------------------------
    def start(self) -> "RemoteReplicaClient":
        if self._killed:
            raise ConnectionError(f"replica {self.name} is dead")
        if self.supervisor is not None:
            self.supervisor.start()
        self.health()         # reachable or raise — start() must be honest
        return self

    def submit(self, prompt_ids, max_new_tokens: int = 32,
               temperature: float = 0.0, top_k: int = 0,
               eos_token_id=None, deadline_s: Optional[float] = None,
               prefix_len: Optional[int] = None,
               req_uid: Optional[str] = None,
               trace=None) -> GenerationResult:
        if self._killed:
            raise ConnectionError(f"replica {self.name} is dead")
        fut = GenerationResult()
        fut._req_id = next(_REQ_IDS)
        fut._trace = trace            # carried, never closed: the caller
        #   (router wrapper or direct user) owns the journey
        # mint a uid when the caller (router hedging passes its own)
        # didn't: an ambiguous terminal-frame loss must be resubmittable
        # without a second decode
        fut._req_uid = req_uid or uuid.uuid4().hex
        hdr = {"max_new_tokens": int(max_new_tokens),
               "temperature": float(temperature), "top_k": int(top_k),
               "eos_token_id": eos_token_id, "deadline_s": deadline_s,
               "prefix_len": prefix_len,
               "req_uid": fut._req_uid}
        if self.crc:
            hdr["crc"] = True
        if trace is not None:
            hdr["trace"] = {"trace_id": getattr(trace, "trace_id", None),
                            "req_id": getattr(trace, "req_id", None)}
        blob = json.dumps(hdr, default=str).encode()
        prompt = np.ascontiguousarray(
            np.asarray(prompt_ids, np.int32).reshape(-1))
        payload = (struct.pack("<IB", _MAGIC, _OP_SUBMIT)
                   + struct.pack("<I", len(blob)) + blob
                   + _pack_tensor("prompt", prompt))
        s = self._connect()
        try:
            _send_frame(s, payload)
            # the stream-progress watchdog starts NOW: the server's
            # accepted frame (and after it, at least a heartbeat every
            # _HB_INTERVAL_S) must land within heartbeat_timeout_s, or
            # the wire black-holed — fail over in ~2 s, not
            # read_timeout_s
            s.settimeout(self.heartbeat_timeout_s)
            status, c = _parse_reply(_recv_frame(s))
        except socket.timeout:
            s.close()
            raise self._stall_error()
        except Exception:
            s.close()
            raise
        if status == _ST_TYPED:
            # admission refusal: raise the SAME typed error the
            # in-process engine would have raised from submit()
            s.close()
            raise error_from_wire(_json_body(c))
        if status != _ST_CHUNK:
            s.close()
            raise ConnectionError(
                f"replica {self.name}: unexpected first frame "
                f"status {status}")
        # accepted: the stream is live — hand it to a reader thread
        t = threading.Thread(target=self._read_stream, args=(s, fut, trace),
                             daemon=True,
                             name=f"remote-replica-read:{self.name}")
        t.start()
        # a client cancel must reach the replica: closing the socket trips
        # the server's disconnect probe, which cancels the remote request
        # and releases its decode slot + KV pages
        fut._add_done_callback(
            lambda f, _s=s: (_close_quietly(_s) if f.cancelled() else None))
        return fut

    def _stall_error(self) -> ReplicaStalledError:
        _safe_inc("paddle_replica_stalls_total",
                  "stream-progress watchdog trips (no frame within "
                  "heartbeat_timeout_s)", replica=self.name)
        try:
            from ..observability import flight

            flight.record("stall", self.name,
                          timeout_s=self.heartbeat_timeout_s)
        except Exception:
            pass
        return ReplicaStalledError(
            f"replica {self.name}: no stream frame (chunk or heartbeat) "
            f"within {self.heartbeat_timeout_s:g}s — wire black-holed or "
            f"replica wedged", stalled_after_s=self.heartbeat_timeout_s)

    def _read_stream(self, s: socket.socket, fut: GenerationResult,
                     trace) -> None:
        try:
            while not fut.done():
                status, c = _parse_reply(_recv_frame(s))
                if status == _ST_CHUNK:
                    ev = _json_body(c)
                    kind = ev.get("ev")
                    if kind == "admit" and fut._t_admit is None:
                        fut._t_admit = time.perf_counter()
                    elif kind == "first" and fut._t_first is None:
                        fut._t_first = time.perf_counter()
                        fut._n_at_first = int(ev.get("n") or 1)
                        fut._n_new = max(fut._n_new, fut._n_at_first)
                    elif kind == "progress":
                        fut._n_new = int(ev.get("n") or fut._n_new)
                    continue
                if status == _ST_OK:
                    head = _json_body(c)
                    _, out = _unpack_tensor(c)
                    fut._n_new = int(head.get("n_new") or 0)
                    fut._n_at_first = int(head.get("n_at_first") or 1)
                    fut._streaming = bool(head.get("streaming", True))
                    if fut._t_admit is None \
                            and head.get("admit_rel") is not None:
                        fut._t_admit = (fut._t_submit
                                        + float(head["admit_rel"]))
                    if fut._t_first is None \
                            and head.get("first_rel") is not None:
                        # no first-token chunk arrived in time (a fast
                        # request finishing inside one poll tick): fall
                        # back to the replica-relative stamp so TTFT is
                        # the engine's, never fabricated-now
                        fut._t_first = (fut._t_submit
                                        + float(head["first_rel"]))
                    _stitch_journey(trace, head.get("journey"), self.name)
                    fut._set(output=out)
                    return
                if status == _ST_TYPED:
                    doc = _json_body(c)
                    _stitch_journey(trace, doc.get("journey"), self.name)
                    fut._set(error=error_from_wire(doc))
                    return
                fut._set(error=ConnectionError(
                    f"replica {self.name}: unexpected stream frame "
                    f"status {status}"))
                return
        except socket.timeout:
            # the watchdog tripped mid-stream: close the socket (the
            # server's disconnect probe then cancels the request and
            # releases its decode slot) and surface the typed stall
            fut._set(error=self._stall_error())
        except WireCorruptionError as e:
            _safe_inc("paddle_wire_corruption_total",
                      "reply frames abandoned on CRC32 mismatch",
                      replica=self.name)
            fut._set(error=e)
        except Exception as e:
            # SIGKILL mid-stream lands here: EOF/reset → an UNTYPED
            # connection error, which the router fails over — the exact
            # in-process kill() contract
            fut._set(error=ConnectionError(
                f"replica {self.name} connection lost mid-stream "
                f"({type(e).__name__}: {e})"))
        finally:
            _close_quietly(s)

    def health(self) -> Dict[str, object]:
        if self._killed:
            raise ConnectionError(f"replica {self.name} is dead")
        status, c = self._rpc(struct.pack("<IB", _MAGIC, _OP_HEALTH))
        if status != _ST_OK:
            raise ConnectionError(
                f"replica {self.name} health probe failed: "
                f"{c.raw(c.take('I')).decode(errors='replace')}")
        snap = _json_body(c)
        if self.supervisor is not None:
            snap["supervisor"] = self.supervisor.info()
        return snap

    def warmup(self) -> Dict[str, object]:
        """Remote replicas warm at boot (bundle load / --warmup inside
        :mod:`~.replica_main`) — the pre-admission warmup the router
        calls is a no-op, exactly the duck-typed contract
        :meth:`ReplicaClient.warmup` documents for remote forms."""
        if self._killed:
            raise ConnectionError(f"replica {self.name} is dead")
        return {"programs": 0, "compiled": 0, "remote": True}

    def drain(self, timeout: Optional[float] = None,
              reason: Optional[str] = None) -> Dict[str, object]:
        if self._killed:
            raise ConnectionError(f"replica {self.name} is dead")
        blob = json.dumps({"timeout": timeout,
                           "reason": reason or "drain"}).encode()
        status, c = self._rpc(struct.pack("<IB", _MAGIC, _OP_DRAIN)
                              + struct.pack("<I", len(blob)) + blob)
        doc = _json_body(c)
        if status == _ST_TYPED:
            raise error_from_wire(doc)
        if status != _ST_OK:
            raise ConnectionError(f"replica {self.name} drain failed")
        return doc

    def stop(self) -> None:
        # drain FIRST, tear the chaos proxy down LAST: the drain RPC goes
        # through _connect, which would lazily re-arm a fresh proxy from
        # the env after a premature stop (and leak its accept thread)
        try:
            if self.supervisor is not None:
                self.supervisor.stop()
            else:
                try:
                    self.drain(0.0, reason="stop")
                except Exception:
                    pass
        finally:
            if self._nc_proxy:
                self._nc_proxy.stop()
                self._nc_proxy = None

    def restart(self, drain_timeout: Optional[float] = None,
                factory: Optional[Callable] = None) -> None:
        """SIGTERM → drain (the replica's preemption hook) → respawn.
        ``factory`` keeps the deploy pipeline's version-switch seam: the
        fleet controller's factories carry a ``version`` attribute (the
        candidate/rollback bundle path), which becomes the respawned
        process's ``--bundle``. Without a supervisor this falls back to
        the wire ``_OP_RESTART`` (drain + in-place engine restart)."""
        bundle = getattr(factory, "version", _KEEP)
        if self.supervisor is not None:
            self.supervisor.restart(drain_timeout=drain_timeout,
                                    bundle=bundle)
        else:
            blob = json.dumps({"timeout": drain_timeout}).encode()
            status, c = self._rpc(struct.pack("<IB", _MAGIC, _OP_RESTART)
                                  + struct.pack("<I", len(blob)) + blob,
                                  retry=True)
            if status == _ST_TYPED:
                raise error_from_wire(_json_body(c))
            if status != _ST_OK:
                raise ConnectionError(
                    f"replica {self.name} restart failed")
        self.generation += 1
        self._killed = False

    def kill(self) -> None:
        """Chaos seam, now REAL: SIGKILL the replica process. In-flight
        streams see EOF and fail untyped (router failover); submits and
        probes refuse until :meth:`restart` respawns it."""
        self._killed = True
        if self.supervisor is not None:
            self.supervisor.kill()


def _close_quietly(s: socket.socket) -> None:
    try:
        s.close()
    except OSError:
        pass


# ---------------------------------------------------------------------------
# the process supervisor
# ---------------------------------------------------------------------------

class ReplicaSupervisor:
    """Owns ONE replica process: spawn from a bundle path, watch for
    readiness (``REPLICA_READY`` line) and for death, respawn crashed
    processes under exponential jittered crash-loop backoff, capture the
    last exit (code + final output lines) for the health block.

    ``auto_respawn`` (default on) covers UNEXPECTED exits only —
    deliberate :meth:`stop`/:meth:`restart`/:meth:`kill` set the
    expected flag first, so chaos kills stay dead until the router's
    recovery path restarts them, exactly like the in-process seam."""

    def __init__(self, bundle: Optional[str] = None,
                 socket_path: Optional[str] = None,
                 port: Optional[int] = None,
                 preset: str = "tiny",
                 model_json: Optional[str] = None,
                 engine_json: Optional[str] = None,
                 server_json: Optional[str] = None,
                 warmup: str = "auto",
                 metrics_port: Optional[int] = None,
                 allow_bundle_fallback: bool = False,
                 ready_timeout_s: float = 180.0,
                 term_grace_s: float = 10.0,
                 auto_respawn: bool = True,
                 max_respawns: int = 8,
                 backoff: Optional[RetryPolicy] = None,
                 name: str = "replica",
                 python: Optional[str] = None,
                 extra_args: Sequence[str] = (),
                 env: Optional[Dict[str, str]] = None):
        self.bundle = bundle
        if socket_path is None and port is None:
            # short, stable path: respawns keep the address (UDS paths
            # have a ~107-char limit — never derive from a test tmpdir)
            socket_path = os.path.join(
                tempfile.gettempdir(),
                f"pdr-{os.getpid()}-{id(self) & 0xFFFF:x}-{name}.sock")
        self.socket_path = socket_path
        self.port = port
        self.preset = preset
        self.model_json = model_json
        self.engine_json = engine_json
        self.server_json = server_json
        self.warmup = warmup
        self.metrics_port = metrics_port
        self.allow_bundle_fallback = bool(allow_bundle_fallback)
        self.ready_timeout_s = float(ready_timeout_s)
        self.term_grace_s = float(term_grace_s)
        self.auto_respawn = bool(auto_respawn)
        self.max_respawns = int(max_respawns)
        self.backoff = backoff or RetryPolicy(
            max_attempts=max(2, self.max_respawns), base_delay=0.25,
            max_delay=8.0, multiplier=2.0, jitter=0.25)
        self.name = name
        self.python = python or sys.executable
        self.extra_args = list(extra_args)
        self.env = env
        self._proc: Optional[subprocess.Popen] = None
        self._ready = threading.Event()
        self.ready_info: Dict[str, object] = {}
        self._ring: deque = deque(maxlen=40)   # last output lines
        self._lock = threading.RLock()
        self._expected_exit = False
        self._consecutive_crashes = 0
        self.state = "idle"
        self.stats = {"spawns": 0, "restarts": 0, "crashes": 0,
                      "crash_loop_backoffs": 0}
        self.last_exit: Optional[Dict[str, object]] = None

    # -- address / info ------------------------------------------------------
    def address(self):
        if self.socket_path is not None:
            return self.socket_path
        info = self.ready_info
        return info.get("port") if info else None

    def pid(self) -> Optional[int]:
        p = self._proc
        return p.pid if p is not None and p.poll() is None else None

    def info(self) -> Dict[str, object]:
        """The supervisor health block ``obsctl fleet``/``top`` render:
        pid, spawn/restart/crash counters, last exit (code + why)."""
        return {"pid": self.pid(), "state": self.state,
                "bundle": self.bundle, **self.stats,
                "last_exit": self.last_exit}

    # -- lifecycle -----------------------------------------------------------
    def _cmd(self):
        cmd = [self.python, "-m",
               "paddlepaddle_tpu_torch.inference.replica_main",
               "--preset", self.preset, "--warmup", self.warmup]
        if self.socket_path is not None:
            cmd += ["--socket", self.socket_path]
        else:
            cmd += ["--port", str(self.port or 0)]
        if self.bundle:
            cmd += ["--bundle", str(self.bundle)]
        if self.allow_bundle_fallback:
            cmd += ["--allow-bundle-fallback"]
        if self.model_json:
            cmd += ["--model-json", self.model_json]
        if self.engine_json:
            cmd += ["--engine-json", self.engine_json]
        if self.server_json:
            cmd += ["--server-json", self.server_json]
        if self.metrics_port is not None:
            cmd += ["--metrics-port", str(self.metrics_port)]
        return cmd + self.extra_args

    def _spawn(self) -> None:
        # lock held by caller
        self._ready.clear()
        self.ready_info = {}
        self.state = "starting"
        env = dict(os.environ)
        if self.env:
            env.update(self.env)
        self._proc = subprocess.Popen(
            self._cmd(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))))
        self.stats["spawns"] += 1
        _safe_inc("paddle_replica_spawns_total",
                  "replica processes spawned by the supervisor",
                  replica=self.name)
        threading.Thread(target=self._pump, args=(self._proc,),
                         daemon=True,
                         name=f"replica-pump:{self.name}").start()
        threading.Thread(target=self._watch, args=(self._proc,),
                         daemon=True,
                         name=f"replica-watch:{self.name}").start()

    def _pump(self, proc: subprocess.Popen) -> None:
        try:
            for line in proc.stdout:
                line = line.rstrip("\n")
                self._ring.append(line)
                if line.startswith("REPLICA_READY "):
                    try:
                        self.ready_info = json.loads(
                            line[len("REPLICA_READY "):])
                    except Exception:
                        self.ready_info = {}
                    if proc is self._proc:
                        self.state = "serving"
                        self._ready.set()
        except Exception:
            pass

    def _watch(self, proc: subprocess.Popen) -> None:
        code = proc.wait()
        with self._lock:
            if proc is not self._proc:
                return          # an old generation's watcher: stale
            tail = [ln for ln in list(self._ring)[-5:] if ln.strip()]
            self.last_exit = {"code": code, "wall": time.time(),
                              "reason": (tail[-1] if tail else None)}
            self._ready.clear()
            if self._expected_exit:
                if self.state != "dead":    # kill() already branded it
                    self.state = "stopped"
                return
            # UNEXPECTED death: a crash (or an external SIGKILL)
            self.stats["crashes"] += 1
            self._consecutive_crashes += 1
            _safe_inc("paddle_replica_crashes_total",
                      "replica processes that died unexpectedly",
                      replica=self.name)
            if not self.auto_respawn \
                    or self._consecutive_crashes > self.max_respawns:
                self.state = "dead"
                return
            self.state = "backoff"
            delay = compute_delay(self.backoff,
                                  min(self._consecutive_crashes, 8))
            self.stats["crash_loop_backoffs"] += 1
            _safe_inc("paddle_replica_crash_loop_backoffs_total",
                      "crash-loop backoff sleeps before a respawn",
                      replica=self.name)
            sys.stderr.write(
                f"[replica-supervisor] {self.name} exited {code} "
                f"unexpectedly (crash #{self._consecutive_crashes}); "
                f"respawn in {delay:.2f}s\n")
        # sleep OUTSIDE the lock — stop()/restart() must not block on a
        # backoff window
        time.sleep(delay)
        with self._lock:
            if proc is not self._proc or self._expected_exit:
                return
            self._spawn()

    def start(self) -> "ReplicaSupervisor":
        with self._lock:
            if self.pid() is not None:
                return self
            self._expected_exit = False
            self._consecutive_crashes = 0
            self._spawn()
        # poll-wait so a crash-looped-to-dead replica fails fast instead
        # of sitting out the whole ready timeout
        deadline = time.monotonic() + self.ready_timeout_s
        while not self._ready.wait(0.2):
            if self.state == "dead" or time.monotonic() > deadline:
                proc = self._proc
                code = proc.poll() if proc is not None else None
                tail = "; ".join(list(self._ring)[-3:])
                raise RuntimeError(
                    f"replica {self.name} never became ready "
                    f"(state={self.state}, exit={code}, "
                    f"last output: {tail!r})")
        # a replica that stays up resets the crash-loop streak: backoff
        # punishes LOOPS, not one transient failure a week apart
        with self._lock:
            self._consecutive_crashes = 0
        return self

    def _terminate(self, sig: int, wait_s: float) -> None:
        # lock held by caller
        proc = self._proc
        if proc is None or proc.poll() is not None:
            return
        try:
            proc.send_signal(sig)
        except (ProcessLookupError, OSError):
            return
        try:
            proc.wait(wait_s)
        except subprocess.TimeoutExpired:
            try:
                proc.kill()
                proc.wait(5.0)
            except (ProcessLookupError, OSError,
                    subprocess.TimeoutExpired):
                pass

    def stop(self, drain_timeout: Optional[float] = None) -> None:
        """Graceful: SIGTERM (the replica drains via its preemption hook
        and exits 143), escalate to SIGKILL past the grace window."""
        with self._lock:
            self._expected_exit = True
            grace = (drain_timeout if drain_timeout is not None
                     else self.term_grace_s) + 5.0
            self._terminate(signal.SIGTERM, grace)
            self.state = "stopped"

    def restart(self, drain_timeout: Optional[float] = None,
                bundle=_KEEP) -> "ReplicaSupervisor":
        """SIGTERM → wait → respawn (optionally onto a new bundle — the
        deploy pipeline's version switch)."""
        self.stop(drain_timeout)
        with self._lock:
            if bundle is not _KEEP:
                self.bundle = bundle
            self.stats["restarts"] += 1
        return self.start()

    def kill(self) -> None:
        """Chaos: SIGKILL, no drain, no respawn — a dead replica stays
        dead until something deliberately restarts it."""
        with self._lock:
            self._expected_exit = True
            self._terminate(signal.SIGKILL, 5.0)
            self.state = "dead"

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        if self.socket_path and os.path.exists(self.socket_path):
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass


# ---------------------------------------------------------------------------
# the fleet factory
# ---------------------------------------------------------------------------

class ProcessReplicaFactory:
    """Versioned replica factory producing :class:`RemoteReplicaClient`s
    (one supervised OS process each) — hand it to
    :class:`~.fleet.FleetController` and autoscaling/canary/rolling
    restarts manage processes. The ``makes_clients`` marker tells the
    controller the factory returns ready clients, not engines; the
    VERSION it is called with (a serving-bundle path, or None before any
    deploy) becomes the spawned process's ``--bundle``."""

    makes_clients = True

    def __init__(self, preset: str = "tiny",
                 engine_json: Optional[str] = None,
                 model_json: Optional[str] = None,
                 warmup: str = "auto",
                 default_bundle: Optional[str] = None,
                 supervisor_kw: Optional[dict] = None,
                 client_kw: Optional[dict] = None):
        self.preset = preset
        self.engine_json = engine_json
        self.model_json = model_json
        self.warmup = warmup
        self.default_bundle = default_bundle
        self.supervisor_kw = dict(supervisor_kw or {})
        self.client_kw = dict(client_kw or {})

    def __call__(self, version: Optional[str] = None,
                 name: str = "replica") -> RemoteReplicaClient:
        sup = ReplicaSupervisor(
            bundle=version or self.default_bundle, preset=self.preset,
            model_json=self.model_json, engine_json=self.engine_json,
            warmup=self.warmup, name=name, **self.supervisor_kw)
        return RemoteReplicaClient(supervisor=sup, name=name,
                                   **self.client_kw)
