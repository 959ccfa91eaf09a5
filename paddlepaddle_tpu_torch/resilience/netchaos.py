"""Deterministic NETWORK fault injection — a TCP proxy that breaks the
wire on a reproducible schedule.

The port's own copy of the jax-free ``paddlepaddle_tpu/resilience/
netchaos.py``.

:mod:`~.chaos` injects faults at *code* seams (an exception, a sleep, a
kill); this module injects them at the *transport* between a
:class:`~..inference.remote_replica.RemoteReplicaClient` and a replica
socket, where the gray failures live (Huang et al., "Gray Failure"): a
connection that black-holes mid-stream, a peer that trickles bytes, a
frame that arrives corrupted. :class:`NetChaosProxy` listens on its own
address, forwards frames to the real replica, and applies armed fault
modes per direction — so the wire-hardening paths (stall watchdog, frame
CRC, idempotent resubmit, server write deadline) are exercised in CI
instead of waiting for a real partition.

Spec grammar — the :mod:`~.chaos` ``PADDLE_CHAOS_POINTS`` grammar with
network points and modes, via ``PADDLE_NETCHAOS``::

    point:mode:sched[:arg] [; ...]

* ``point`` — injection direction: ``up`` (client → server frames),
  ``down`` (server → client frames), ``conn`` (at accept time).
* ``mode``:
    - ``blackhole``   accept/keep the connection, stop forwarding — the
                      nastiest gray failure (arg: none)
    - ``delay``       hold the frame ``arg`` ms before forwarding
                      (default 50)
    - ``throttle``    slow-loris: forward at ``arg`` bytes/sec (default
                      256) for the rest of the connection — also throttles
                      the proxy's READS, so server-side backpressure is
                      real
    - ``reset``       RST the client connection mid-stream (SO_LINGER 0)
    - ``trunc``       forward the length header + half the payload, then
                      close — a mid-frame cut
    - ``corrupt``     flip payload bytes (past the frame's magic/status/
                      CRC header, so the damage lands in the CRC-protected
                      region)
* ``sched`` — same kinds as chaos: ``0.25`` probability per hit, ``@N``
  exactly the Nth hit, ``%N`` every Nth, ``xN`` the first N. Hits are
  counted per point across the proxy's lifetime (``conn`` per accept,
  ``up``/``down`` per FRAME), and probability draws come from a per-point
  RNG seeded ``crc32(point) ^ seed`` — the same determinism contract as
  :mod:`~.chaos`: fixed seed + fixed frame sequence ⇒ identical injections
  run-to-run.

Arming: construct the proxy with ``specs=``, or set ``PADDLE_NETCHAOS``
(+ ``PADDLE_NETCHAOS_SEED``, falling back to ``PADDLE_CHAOS_SEED``) and
:class:`~..inference.remote_replica.RemoteReplicaClient` wraps itself
automatically (see :func:`env_spec`). With the env unset the client's hot
path never touches this module beyond one cached getenv.

Every injection emits ``paddle_netchaos_injections_total{point,mode}``
and a flight-recorder event, so a chaos run's evidence trail shows WHAT
was injected next to how the stack responded.
"""

from __future__ import annotations

import os
import random
import socket
import struct
import threading
import time
import zlib
from typing import Dict, List, Optional

from .chaos import ChaosSpec, parse_specs

__all__ = ["NetChaosProxy", "parse_netchaos", "env_spec", "env_seed",
           "NETCHAOS_MODES", "NETCHAOS_POINTS"]

NETCHAOS_POINTS = ("up", "down", "conn")
NETCHAOS_MODES = ("blackhole", "delay", "throttle", "reset", "trunc",
                  "corrupt")

_MAX_FRAME = 1 << 28          # mirror c_api_server's guard


def parse_netchaos(text: str) -> List[ChaosSpec]:
    """Parse a ``PADDLE_NETCHAOS`` spec string, validating points/modes
    against the network vocabulary (the shared grammar accepts any token;
    a typo'd mode must fail loud at arm time, not silently never fire)."""
    specs = []
    for entry in text.replace(",", ";").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) < 3:
            raise ValueError(
                f"netchaos spec {entry!r} needs point:mode:sched[:arg]")
        point, mode = parts[0], parts[1]
        if point not in NETCHAOS_POINTS:
            raise ValueError(f"netchaos point {point!r} not in "
                             f"{'|'.join(NETCHAOS_POINTS)}")
        if mode not in NETCHAOS_MODES:
            raise ValueError(f"netchaos mode {mode!r} not in "
                             f"{'|'.join(NETCHAOS_MODES)}")
        # reuse the chaos schedule parser by round-tripping through a
        # placeholder mode (ChaosSpec validates modes; the schedule
        # grammar is what we're borrowing)
        (tmp,) = parse_specs(f"{point}:exc:{':'.join(parts[2:])}")
        spec = ChaosSpec.__new__(ChaosSpec)
        spec.point, spec.mode = point, mode
        spec.sched_kind, spec.sched_value = tmp.sched_kind, tmp.sched_value
        spec.arg = tmp.arg
        specs.append(spec)
    return specs


def env_spec() -> str:
    return os.environ.get("PADDLE_NETCHAOS", "").strip()


def env_seed() -> int:
    raw = (os.environ.get("PADDLE_NETCHAOS_SEED")
           or os.environ.get("PADDLE_CHAOS_SEED") or "0")
    try:
        return int(raw)
    except ValueError:
        return 0


def _emit(name: str, point: str, mode: str) -> None:
    try:
        from ..observability import flight, safe_inc

        safe_inc("paddle_netchaos_injections_total",
                 "network faults injected by the netchaos proxy, "
                 "by point and mode",
                 proxy=name, point=point, mode=mode)
        flight.record("netchaos", name, point=point, mode=mode)
    except Exception:
        pass


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class _ConnState:
    """Per-connection mutable state shared by both pump threads."""

    def __init__(self, client: socket.socket, server: socket.socket):
        self.client = client
        self.server = server
        self.throttle_bps: Dict[str, float] = {}   # direction -> Bps
        self.leave_open = False      # mid-stream blackhole: the victim
        #   must see SILENCE when this pump exits, never our FIN
        self.closed = threading.Event()

    def close(self, rst: bool = False) -> None:
        if self.closed.is_set():
            return
        self.closed.set()
        if rst:
            try:
                # SO_LINGER(on, 0): close() sends RST instead of FIN —
                # the client sees ECONNRESET mid-stream (TCP only; on a
                # UDS listener it degrades to a plain close)
                self.client.setsockopt(
                    socket.SOL_SOCKET, socket.SO_LINGER,
                    struct.pack("ii", 1, 0))
            except OSError:
                pass
        for s in (self.client, self.server):
            # shutdown() BEFORE close(): the opposite-direction pump is
            # usually blocked in recv() on this very socket, and close()
            # alone defers the kernel teardown until that syscall returns
            # (the in-flight recv pins the file description) — no FIN/RST
            # would ever reach the victim.  shutdown wakes the reader AND
            # emits the teardown segment immediately.  For the RST case
            # shut only the read half: SHUT_WR would send a FIN and the
            # peer must see a hard reset, not a clean EOF.
            try:
                s.shutdown(socket.SHUT_RD if rst and s is self.client
                           else socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass


class NetChaosProxy:
    """A frame-aware fault-injection proxy in front of ONE replica socket.

    ``target`` is the replica's address — a UDS path (str), a TCP port
    (int, loopback), or a zero-arg callable returning either (pass the
    client's ``address`` method so a supervisor respawn onto a fresh
    ephemeral port is re-resolved per connection). The proxy listens on
    loopback TCP (ephemeral port by default); :meth:`address` is what the
    client should dial.

    The proxy parses the C-API framing (``<u64 len><payload>``) so frame
    schedules (``@N``/``%N``) are deterministic: the Nth ``down`` hit is
    the Nth server→client frame, whatever the kernel's segmentation did.
    Bytes that never form a full frame (a trickling peer, EOF mid-frame)
    propagate as-is when the frame completes or the connection dies.
    """

    def __init__(self, target, specs=None, seed: Optional[int] = None,
                 name: str = "netchaos", listen_port: int = 0):
        if isinstance(specs, str):
            specs = parse_netchaos(specs)
        self.name = name
        self.seed = env_seed() if seed is None else int(seed)
        self._by_point: Dict[str, List[ChaosSpec]] = {}
        for s in (specs or []):
            self._by_point.setdefault(s.point, []).append(s)
        self._target = target
        self._listen_port = listen_port
        self._lock = threading.Lock()
        self._hits: Dict[str, int] = {}
        self._fires: Dict[str, int] = {}
        self._rngs: Dict[str, random.Random] = {}
        self._sock: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._conns: List[_ConnState] = []
        self.port: Optional[int] = None

    # -- schedule ------------------------------------------------------------
    def _hit(self, point: str) -> List[ChaosSpec]:
        """One seam crossing; returns the specs that fire on it. Counts
        and RNG draws live under one lock so the decision sequence depends
        only on the per-point hit order — the determinism contract."""
        specs = self._by_point.get(point)
        with self._lock:
            hit = self._hits[point] = self._hits.get(point, 0) + 1
            if not specs:
                return []
            rng = self._rngs.get(point)
            if rng is None:
                rng = self._rngs[point] = random.Random(
                    zlib.crc32(point.encode()) ^ self.seed)
            fired = [s for s in specs if s.should_fire(hit, rng)]
            if fired:
                self._fires[point] = self._fires.get(point, 0) + len(fired)
        for s in fired:
            _emit(self.name, point, s.mode)
        return fired

    def hit_counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._hits)

    def fire_counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._fires)

    # -- lifecycle -----------------------------------------------------------
    def address(self) -> int:
        """The port clients dial (proxy always listens on loopback TCP —
        the target may still be a UDS path)."""
        if self.port is None:
            raise RuntimeError("NetChaosProxy not started")
        return self.port

    def start(self) -> "NetChaosProxy":
        if self._sock is not None:
            return self
        self._stop.clear()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", self._listen_port))
        self.port = self._sock.getsockname()[1]
        self._sock.listen(16)
        threading.Thread(target=self._accept_loop, daemon=True,
                         name=f"netchaos-accept:{self.name}").start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        with self._lock:
            conns, self._conns = self._conns[:], []
        for st in conns:
            st.close()

    def __enter__(self) -> "NetChaosProxy":
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- forwarding ----------------------------------------------------------
    def _resolve_target(self):
        t = self._target
        return t() if callable(t) else t

    def _connect_target(self) -> socket.socket:
        addr = self._resolve_target()
        if addr is None:
            raise ConnectionError(
                f"netchaos {self.name}: target has no address")
        if isinstance(addr, int):
            return socket.create_connection(("127.0.0.1", addr), timeout=5)
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(5)
        s.connect(str(addr))
        s.settimeout(None)
        return s

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                client, _ = self._sock.accept()
            except OSError:
                return
            fired = self._hit("conn")
            if any(s.mode == "reset" for s in fired):
                try:
                    client.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                      struct.pack("ii", 1, 0))
                except OSError:
                    pass
                client.close()
                continue
            for s in fired:
                if s.mode == "delay":
                    time.sleep((s.arg if s.arg is not None else 50) / 1e3)
            try:
                server = self._connect_target()
            except Exception:
                client.close()
                continue
            st = _ConnState(client, server)
            if any(s.mode == "blackhole" for s in fired):
                # accept, never forward in EITHER direction: drain the
                # client silently so it sees a live-but-silent peer
                threading.Thread(target=self._drain, args=(st, client),
                                 daemon=True).start()
                with self._lock:
                    self._conns.append(st)
                continue
            with self._lock:
                self._conns.append(st)
            threading.Thread(
                target=self._pump, args=(st, client, server, "up"),
                daemon=True, name=f"netchaos-up:{self.name}").start()
            threading.Thread(
                target=self._pump, args=(st, server, client, "down"),
                daemon=True, name=f"netchaos-down:{self.name}").start()

    def _drain(self, st: _ConnState, src: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                if not src.recv(1 << 16):
                    break
        except OSError:
            pass
        finally:
            st.close()

    def _blackhole_drain(self, st: _ConnState, src: socket.socket) -> None:
        """Mid-stream black hole: swallow the source WITHOUT closing the
        connection pair — the victim must see silence (a live socket that
        never speaks), not an EOF its error path would classify cleanly.
        The opposite-direction pump still owns teardown: when the victim
        gives up and closes, that pump's EOF closes everything."""
        try:
            while not self._stop.is_set() and not st.closed.is_set():
                if not src.recv(1 << 16):
                    return
        except OSError:
            pass

    def _pump(self, st: _ConnState, src: socket.socket,
              dst: socket.socket, point: str) -> None:
        try:
            while not self._stop.is_set() and not st.closed.is_set():
                bps = st.throttle_bps.get(point)
                if bps is not None:
                    self._trickle(st, src, dst, bps)
                    return
                head = _recv_exact(src, 8)
                if head is None:
                    break
                (length,) = struct.unpack("<Q", head)
                if length > _MAX_FRAME:
                    # not our protocol (or garbage): stop parsing, fall
                    # back to raw passthrough of what we read
                    dst.sendall(head)
                    self._trickle(st, src, dst, None)
                    return
                payload = _recv_exact(src, length)
                if payload is None:
                    # mid-frame EOF from the source: propagate the cut
                    break
                fired = self._hit(point)
                if not self._apply(st, src, dst, point, fired, head,
                                   payload):
                    return
        except OSError:
            pass
        finally:
            if st.leave_open:
                # one free pass, consumed by the black-holing pump: the
                # opposite pump still owns teardown once the victim gives
                # up and ITS recv sees the EOF
                st.leave_open = False
            else:
                st.close()

    def _trickle(self, st: _ConnState, src: socket.socket,
                 dst: socket.socket, bps: Optional[float]) -> None:
        """Raw chunk passthrough; with ``bps`` set, a slow-loris — the
        proxy also READS slowly, so the source's send buffer backs up and
        server-side write deadlines get real evidence."""
        chunk = 64 if bps else (1 << 16)
        try:
            while not self._stop.is_set() and not st.closed.is_set():
                buf = src.recv(chunk)
                if not buf:
                    break
                dst.sendall(buf)
                if bps:
                    time.sleep(len(buf) / max(bps, 1.0))
        except OSError:
            pass

    def _apply(self, st: _ConnState, src: socket.socket,
               dst: socket.socket, point: str, fired: List[ChaosSpec],
               head: bytes, payload: bytes) -> bool:
        """Apply fired modes to one frame; returns False when the pump
        must stop (connection torn down or handed off)."""
        for s in fired:
            if s.mode == "delay":
                time.sleep((s.arg if s.arg is not None else 50) / 1e3)
        for s in fired:
            if s.mode == "corrupt":
                payload = self._corrupt(point, payload)
        for s in fired:
            if s.mode == "reset":
                st.close(rst=True)
                return False
            if s.mode == "trunc":
                try:
                    dst.sendall(head + payload[: len(payload) // 2])
                except OSError:
                    pass
                st.close()
                return False
            if s.mode == "blackhole":
                # this frame (and everything after it on this direction)
                # vanishes: keep READING the source and discarding, so
                # the sender never blocks — a true black hole swallows.
                # The other direction keeps flowing; only silence here —
                # even after the SOURCE closes, the victim's socket must
                # stay open (silence, not FIN) until the victim gives up
                # and the opposite pump sees its EOF.
                self._blackhole_drain(st, src)
                st.leave_open = True
                return False
        dst.sendall(head + payload)
        for s in fired:
            if s.mode == "throttle":
                st.throttle_bps[point] = (s.arg if s.arg is not None
                                          else 256.0)
        return True

    def _corrupt(self, point: str, payload: bytes) -> bytes:
        """Flip 1–4 bytes past the magic/status/CRC header (offset 9) so
        the damage lands in the CRC-protected region, not the framing —
        corruption must surface as WireCorruptionError, never as a parse
        desync the test can't tell from truncation."""
        if not payload:
            return payload
        with self._lock:
            rng = self._rngs.get(point)
            if rng is None:
                rng = self._rngs[point] = random.Random(
                    zlib.crc32(point.encode()) ^ self.seed)
            lo = 9 if len(payload) > 9 else 0
            n = min(len(payload) - lo, 1 + rng.randrange(4))
            offs = [lo + rng.randrange(len(payload) - lo)
                    for _ in range(max(n, 1))]
        buf = bytearray(payload)
        for o in offs:
            buf[o] ^= 0xFF
        return bytes(buf)
