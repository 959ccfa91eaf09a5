"""Crash flight recorder — a black box for every worker process.

The port's own copy of the jax-free ``paddlepaddle_tpu/observability/
flight.py``. The port feeds it from the seams it has: the serving engine
(request lifecycle, breaker transitions, sheds, KV spills and restores,
warmup and bundle events), preemption, the capture/build watchdog, the
eager collectives, retries and chaos, and the step watchdog
(``distributed.watchdog``); a dump carries the in-flight comm-task table
(``distributed.comm_task``, reference :226).

Reference surface: production training runs (MegaScale, §5 "diagnosis
tools") keep a bounded in-memory log of recent runtime events per worker and
persist it when something dies, because the telemetry that explains a crash
is exactly the telemetry a crashed process can no longer serve over HTTP.
Dapper-style aside: the recorder keeps structured events, not strings, so
the dump is greppable/joinable across ranks.

The recorder is a bounded ring of structured events fed by the runtime's
existing fault/progress seams:

* step boundaries (``distributed.watchdog.Watchdog.step``),
* eager collective launches (``distributed.collective``),
* retries and retry exhaustion (``resilience.retry``),
* chaos injections (``resilience.chaos``),
* circuit-breaker transitions and load sheds (``inference.serving``),
* preemption signals (``resilience.preemption``),
* jit recompilations (``observability.watchdog``).

Recording costs one module-global read + branch when disabled, and a deque
append when enabled — cheap enough to leave on for a whole job
(``tools/check_obs_overhead.py`` gates the enabled hot path).

On an *unrecoverable* event the buffer is flushed as JSONL — one record per
line, plus all-thread stack traces (``sys._current_frames``), the in-flight
comm-task table, and any open step — to ``FLAGS_obs_blackbox_dir``:

* unhandled exception (``sys.excepthook`` / ``threading.excepthook``),
* step-watchdog timeout (``distributed.watchdog._dump``),
* SIGTERM preemption (``resilience.preemption``),
* serving circuit breaker opening (``inference.serving``),
* an injected chaos kill, right before its ``os._exit``.

Enable with ``PADDLE_OBS_BLACKBOX=1`` (``FLAGS_obs_blackbox``) or
:func:`enable`; read a dump with ``tools/obsctl.py blackbox tail``.
"""

from __future__ import annotations

import itertools
import json
import os
import socket
import sys
import threading
import time
import traceback
from collections import deque
from typing import Optional

from ..core import flags as _flags

__all__ = [
    "FlightRecorder", "enable", "disable", "is_enabled", "get",
    "record", "dump", "annotate", "default_dir",
]

# process-level header annotations (serving quant mode, etc.): kept OUTSIDE
# the recorder so a subsystem can annotate before/without the recorder being
# armed — enabling later still dumps them. Plain dict set; no lock needed
# (atomic under the GIL, dumps snapshot via dict()).
_annotations: dict = {}


def annotate(key: str, value) -> None:
    """Attach a key to every future black-box header (e.g. the serving
    engine's quant mode). Values must be JSON-serializable — or a
    zero-argument callable returning one, resolved at dump time (how the
    perf plane keeps the program-cost table in crash dumps current
    without re-annotating on every observation)."""
    _annotations[str(key)] = value


def _rank() -> int:
    """Launcher env first, torch-style spelling second — the same order
    ``distributed.host_collectives`` uses to decide a job is multi-process.
    Shared by the exporter and the fleet autostart (one definition, not
    three); jax-free so a dump/scrape never forces a backend import."""
    return int(os.environ.get("PADDLE_TRAINER_ID")
               or os.environ.get("RANK") or 0)


def _world() -> int:
    return int(os.environ.get("PADDLE_TRAINERS_NUM")
               or os.environ.get("WORLD_SIZE") or 1)


def default_dir() -> str:
    """``FLAGS_obs_blackbox_dir`` or ``<tmp>/paddle_blackbox``."""
    d = _flags.flag_value("obs_blackbox_dir")
    if d:
        return d
    import tempfile

    return os.path.join(tempfile.gettempdir(), "paddle_blackbox")


class FlightRecorder:
    """Bounded ring of structured runtime events + JSONL crash dumps.

    Thread-safe by construction: the ring is a ``deque`` (atomic append
    under the GIL), the sequence counter is an ``itertools.count``, and
    ``dump()`` only snapshots — it must be callable from a signal handler
    or an excepthook without taking locks that arbitrary frames might
    hold."""

    def __init__(self, directory: Optional[str] = None,
                 capacity: Optional[int] = None):
        self.directory = directory or default_dir()
        cap = (capacity if capacity is not None
               else _flags.flag_value("obs_blackbox_events"))
        self._events: deque = deque(maxlen=max(int(cap), 16))
        self._seq = itertools.count(1)
        self._dump_ordinal = itertools.count(1)
        self._open_steps: dict = {}  # (name) -> event dict of the open step
        self.started_wall = time.time()
        self.started_mono = time.monotonic()

    # -- write side ----------------------------------------------------------
    def record(self, kind: str, name: str = "",
               data: Optional[dict] = None) -> None:
        ev = {
            "seq": next(self._seq),
            "wall": time.time(),
            "mono": time.monotonic(),
            "kind": kind,
            "name": name,
        }
        if data:
            ev["data"] = data
        # track open steps so a dump can name the in-flight step even after
        # the begin event aged out of a busy ring
        if kind == "step" and data is not None:
            phase = data.get("phase")
            if phase == "begin":
                self._open_steps[name] = ev
            elif phase == "end":
                self._open_steps.pop(name, None)
        self._events.append(ev)

    def events(self) -> list:
        return list(self._events)

    # -- dump side -----------------------------------------------------------
    def _stacks(self) -> list:
        names = {t.ident: (t.name, t.daemon) for t in threading.enumerate()}
        out = []
        for tid, frame in sys._current_frames().items():
            name, daemon = names.get(tid, ("?", None))
            out.append({
                "tid": tid, "name": name, "daemon": daemon,
                "frames": [ln.rstrip("\n")
                           for ln in traceback.format_stack(frame)],
            })
        return out

    def dump(self, reason: str, exc_info=None) -> Optional[str]:
        """Flush the ring + stacks + in-flight tables to one JSONL file.
        Never raises (a black box must not add a second failure to the
        first); returns the path, or None if the write failed."""
        try:
            return self._dump(reason, exc_info)
        except Exception:
            try:
                sys.stderr.write(
                    f"[flight] black-box dump for {reason!r} failed:\n"
                    + traceback.format_exc())
            except Exception:
                pass
            return None

    def _dump(self, reason: str, exc_info) -> str:
        os.makedirs(self.directory, exist_ok=True)
        n = next(self._dump_ordinal)
        slug = "".join(c if c.isalnum() or c in "-_" else "_"
                       for c in reason)[:48] or "dump"
        path = os.path.join(
            self.directory,
            f"blackbox-rank{_rank()}-pid{os.getpid()}-{n:02d}-{slug}.jsonl")
        events = list(self._events)  # snapshot before anything else
        open_steps = list(self._open_steps.values())
        lines = [{
            "rec": "header",
            "reason": reason,
            "rank": _rank(),
            "world": _world(),
            "host": socket.gethostname(),
            "pid": os.getpid(),
            "wall": time.time(),
            "uptime_s": round(time.monotonic() - self.started_mono, 3),
            "argv": list(sys.argv),
            "dump_ordinal": n,
            "buffered_events": len(events),
        }]
        if _annotations:
            resolved = {}
            for k, v in dict(_annotations).items():
                if callable(v):
                    try:
                        v = v()
                    except Exception as e:   # a sick annotation must not
                        v = f"<annotation failed: {e!r}>"  # sink the dump
                resolved[k] = v
            lines[0]["annotations"] = resolved
        for ev in events:
            lines.append(dict(ev, rec="event"))
        if exc_info is not None:
            tp, val, tb = exc_info
            lines.append({
                "rec": "exception",
                "type": getattr(tp, "__name__", str(tp)),
                "value": str(val),
                "traceback": [ln.rstrip("\n") for ln in
                              traceback.format_exception(tp, val, tb)],
            })
        for ev in open_steps:
            lines.append({
                "rec": "in_flight_step",
                "name": ev.get("name"),
                "data": ev.get("data"),
                "began_s_before_dump":
                    round(time.monotonic() - ev["mono"], 3),
            })
        try:
            from ..distributed.comm_task import in_flight

            lines.append({
                "rec": "in_flight",
                "tasks": [{"name": t[0], "group": t[1],
                           "elapsed_s": round(t[2], 3), "thread": t[3]}
                          for t in in_flight()],
            })
        except Exception:
            pass
        try:
            # sampling-profiler context: the instantaneous stack snapshot
            # below says where the process IS; the last ~10 s of hot
            # folded stacks say where it has been SPENDING — the
            # difference between "stuck here now" and "spinning here"
            from . import profiler as _profiler

            prof = _profiler.get()
            if prof is not None:
                lines.append({
                    "rec": "hot_stacks",
                    "window_s": 10.0,
                    "hz": prof.hz,
                    "categories": prof.categories(10.0),
                    "stacks": prof.hot_stacks(10.0, 15),
                })
        except Exception:
            pass
        lines.append({"rec": "stacks", "threads": self._stacks()})
        lines.append({"rec": "end", "events": len(events)})
        with open(path, "w") as f:
            for obj in lines:
                f.write(json.dumps(obj, default=str) + "\n")
            f.flush()
            os.fsync(f.fileno())  # the process may _exit right after
        sys.stderr.write(f"[flight] black box written: {path} "
                         f"(reason={reason}, {len(events)} events)\n")
        return path


# ---------------------------------------------------------------------------
# module singleton + crash hooks. `_rec is None` is THE disabled fast path.
# ---------------------------------------------------------------------------

_rec: Optional[FlightRecorder] = None
_prev_excepthook = None
_prev_threading_hook = None


def record(kind: str, name: str = "", **data) -> None:
    """Hot-seam entry point: one global read + branch when disabled."""
    r = _rec
    if r is not None:
        r.record(kind, name, data or None)


def dump(reason: str, exc_info=None) -> Optional[str]:
    """Flush the black box (no-op when disabled)."""
    r = _rec
    if r is None:
        return None
    return r.dump(reason, exc_info)


def _excepthook(tp, val, tb):
    dump("unhandled_exception", (tp, val, tb))
    if _prev_excepthook is not None:
        _prev_excepthook(tp, val, tb)


def _threading_hook(args):
    # a dead helper thread (engine loop, publisher) is a crash too
    dump(f"unhandled_exception_in_thread:{args.thread.name if args.thread else '?'}",
         (args.exc_type, args.exc_value, args.exc_traceback))
    if _prev_threading_hook is not None:
        _prev_threading_hook(args)


def enable(directory: Optional[str] = None, capacity: Optional[int] = None,
           install_hooks: bool = True) -> FlightRecorder:
    """Arm the flight recorder (idempotent — re-enable swaps the config).
    ``install_hooks`` chains ``sys.excepthook``/``threading.excepthook`` so
    an unhandled exception dumps before the interpreter reports it."""
    global _rec, _prev_excepthook, _prev_threading_hook
    _rec = FlightRecorder(directory, capacity)
    if install_hooks:
        if _prev_excepthook is None:
            _prev_excepthook = sys.excepthook
            sys.excepthook = _excepthook
        if _prev_threading_hook is None and hasattr(threading, "excepthook"):
            _prev_threading_hook = threading.excepthook
            threading.excepthook = _threading_hook
    return _rec


def disable() -> None:
    """Disarm and restore the hooks. The recorder (and its events) is
    dropped; dumps already on disk are untouched."""
    global _rec, _prev_excepthook, _prev_threading_hook
    _rec = None
    if _prev_excepthook is not None:
        sys.excepthook = _prev_excepthook
        _prev_excepthook = None
    if _prev_threading_hook is not None:
        threading.excepthook = _prev_threading_hook
        _prev_threading_hook = None


def is_enabled() -> bool:
    return _rec is not None


def get() -> Optional[FlightRecorder]:
    return _rec
