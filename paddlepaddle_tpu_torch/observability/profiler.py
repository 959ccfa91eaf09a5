"""Always-on sampling wall-clock profiler — "where were the cycles".

Port of ``paddlepaddle_tpu/observability/profiler.py``. The sampler and the
seam classifier are host-side and copied; the classifier also knows the
port's own seams (the captured decode and speculative bodies, the eager
admission impls), and within one frame a function name wins over a file
suffix, so the engine's admission, which lives in ``decode_engine.py``
beside its decode, reads as ``admission``. :meth:`SamplingProfiler.
device_trace` opens a ``torch.profiler`` window (CPU and CUDA activity)
and exports a Chrome trace, where the reference opens a ``jax.profiler``
trace (:290).

Reference surface: ``paddle.profiler``'s host tracer. That design (enter/
exit hooks on every instrumented region) answers "how long did the things
I annotated take"; production triage needs the inverse — "what was the
process ACTUALLY doing when the 2 a.m. page fired", including the code
nobody annotated. This module is the statistical answer: a daemon thread
samples ``sys._current_frames()`` at ``FLAGS_obs_prof_hz`` (default
50 Hz), folds each thread's stack into a ``category;thread;frames...``
collapsed line, and aggregates counts into per-second buckets kept for
``FLAGS_obs_prof_window_s``. Memory is bounded by distinct stacks per
second, not by runtime; per-sample cost is one stack walk per live
thread (~tens of microseconds), which is what keeps the <5% overhead
gate honest (tools/check_obs_overhead.py gate 7).

Every sampled stack is classified by SEAM — the first frame (scanning
innermost-out) that lands in a known subsystem names the category:

* ``decode``    — decode/spec chunk, first-token collect, retirement
* ``admission`` — admission control, queue pop, batch collect
* ``router``    — dispatch, hedging, failover
* ``wire``      — socket serving / replica client I/O
* ``gc``        — interpreter GC callbacks
* ``idle``      — parked in a lock/queue/sleep wait
* ``other``     — everything else

Read side: ``hot_stacks(seconds, n)`` (top-N table), ``collapsed()``
(flamegraph-ready ``stack count`` lines for inferno/speedscope),
``jsonable()`` (the ``/profile`` and ``/fleet/profile`` payload), plus
an on-demand ``device_trace(seconds)`` window (``torch.profiler``) for
the card's side — the sampler sees host frames only; device time appears
as the host thread parked in the chunk's sync.

Flight-recorder dumps attach ``hot_stacks`` of the last ~10 s so a
watchdog/breaker/alert dump says where the process was spinning, not
just that it was.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import Counter, deque
from typing import Dict, List, Optional

from ..core import flags as _flags

#: frames deeper than this are truncated (outermost end) — a runaway
#: recursion must not turn every sample into a megabyte of folded text
MAX_DEPTH = 64

# seam classification: (category, function names, filename suffixes).
# Scanned per frame innermost-out; first hit names the stack. ``idle``
# is matched ONLY on the innermost frame — a decode thread blocked in
# a lock deep inside the engine is idle, but an engine frame above a
# helper's wait() must still win as decode.
_SEAMS = (
    ("decode", {"_decode_chunk", "_spec_chunk", "_collect_firsts",
                "_retire", "_run_static_batch", "_decode_attempt",
                "_loop_continuous", "_decode_body", "draft_body",
                "verify_body"},
     ("decode_engine.py", "speculative.py")),
    ("admission", {"_admit", "_check_admission", "_precheck",
                   "_next_request", "_collect_batch", "_requeue_expired_sweep",
                   "_sweep_slots", "_admit_paged_impl",
                   "_admit_contiguous_impl", "draft_admit",
                   "_warm_admissions"}, ()),
    ("router", {"_dispatch", "_maybe_hedge", "_cancel_losers",
                "_finish_ok", "_finish_fail", "_pick_replica"},
     ("router.py",)),
    ("wire", set(),
     ("c_api_server.py", "remote_replica.py", "socket.py", "selectors.py",
      "socketserver.py", "ssl.py")),
    ("gc", set(), ("gc.py",)),
)
#: a thread whose INNERMOST frame is one of these waits is parked, not
#: burning — including a server parked in select/accept waiting for a
#: connection (actual wire work — recv_into/sendall mid-RPC — still
#: classifies as ``wire`` through the seam table above)
_IDLE_FUNCS = {"wait", "acquire", "get", "select", "poll", "sleep",
               "accept", "_wait_for_tstate_lock"}
_IDLE_FILES = ("threading.py", "queue.py", "selectors.py", "socket.py")

_basename_cache: Dict[str, str] = {}


def _short(path: str) -> str:
    b = _basename_cache.get(path)
    if b is None:
        b = os.path.basename(path)
        _basename_cache[path] = b
    return b


def classify(frames_innermost_first: List[tuple]) -> str:
    """Category of one sampled stack; ``frames`` are ``(file, func)``
    pairs, innermost first. Within a frame a seam's function name wins
    over another seam's file suffix."""
    for depth, (fname, func) in enumerate(frames_innermost_first):
        if depth == 0 and (func in _IDLE_FUNCS
                           and fname.endswith(_IDLE_FILES)):
            return "idle"
        for cat, funcs, _files in _SEAMS:
            if func in funcs:
                return cat
        for cat, _funcs, files in _SEAMS:
            if files and fname.endswith(files):
                return cat
    return "other"


class SamplingProfiler:
    """Bounded folded-stack aggregator over ``sys._current_frames()``.

    ``start_thread=False`` leaves sampling to be driven manually — tests
    call :meth:`sample_once` with a synthetic clock, exactly the tsdb
    sampler's contract."""

    def __init__(self, hz: Optional[float] = None,
                 window_s: Optional[float] = None):
        self.hz = float(hz or _flags.flag_value("obs_prof_hz") or 50.0)
        self.window_s = float(
            window_s or _flags.flag_value("obs_prof_window_s") or 120.0)
        self._lock = threading.Lock()
        # (epoch_second, Counter{folded_stack: samples}) — appended by the
        # sampler, pruned past window_s; readers merge the suffix they need
        self._buckets: deque = deque()
        self.samples = 0            # stack samples recorded (thread-seconds)
        self.ticks = 0              # sampler wakeups
        self._started_at = time.time()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._trace_lock = threading.Lock()

    # -- write side ----------------------------------------------------------

    def sample_once(self, now: Optional[float] = None) -> int:
        """Take one sample of every live thread (except the sampler
        itself). Returns the number of stacks recorded."""
        t = time.time() if now is None else now
        sec = int(t)
        own = threading.get_ident()
        try:
            frames = sys._current_frames()
        except Exception:
            return 0
        names = {}
        try:
            for th in threading.enumerate():
                if th.ident is not None:
                    names[th.ident] = th.name
        except Exception:
            pass
        recorded = 0
        folded = []
        for tid, frame in frames.items():
            if tid == own:
                continue
            inner = []
            f = frame
            while f is not None and len(inner) < MAX_DEPTH:
                code = f.f_code
                inner.append((_short(code.co_filename), code.co_name))
                f = f.f_back
            if not inner:
                continue
            cat = classify(inner)
            parts = [f"{fn}:{fun}" for fn, fun in reversed(inner)]
            tname = names.get(tid, f"tid{tid}")
            folded.append(cat + ";" + tname + ";" + ";".join(parts))
            recorded += 1
        del frames
        with self._lock:
            if self._buckets and self._buckets[-1][0] == sec:
                bucket = self._buckets[-1][1]
            else:
                bucket = Counter()
                self._buckets.append((sec, bucket))
                edge = sec - self.window_s
                while self._buckets and self._buckets[0][0] < edge:
                    self._buckets.popleft()
            for line in folded:
                bucket[line] += 1
            self.samples += recorded
            self.ticks += 1
        return recorded

    def _run(self) -> None:
        period = 1.0 / max(self.hz, 0.1)
        next_t = time.monotonic()
        while True:
            next_t += period
            delay = next_t - time.monotonic()
            if delay < -1.0:       # fell behind (GIL stall): don't burst
                next_t = time.monotonic()
                delay = 0.0
            if self._stop.wait(max(delay, 0.0)):
                return
            try:
                self.sample_once()
            except Exception:
                pass    # the profiler must never take the process down

    def start(self) -> "SamplingProfiler":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="obs-profiler")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None

    # -- read side -----------------------------------------------------------

    def _merged(self, seconds: Optional[float],
                now: Optional[float] = None) -> Counter:
        t = time.time() if now is None else now
        edge = None if seconds is None else int(t) - float(seconds)
        out: Counter = Counter()
        with self._lock:
            for sec, bucket in self._buckets:
                if edge is None or sec >= edge:
                    out.update(bucket)
        return out

    def hot_stacks(self, seconds: Optional[float] = 10.0, n: int = 20,
                   now: Optional[float] = None) -> List[dict]:
        """Top-N folded stacks over the trailing window, hottest burning
        stacks first; parked (``idle``) stacks sort after all of them."""
        merged = self._merged(seconds, now)
        total = sum(merged.values())
        # the table answers "what was BURNING": parked (idle) stacks rank
        # after every burning stack no matter their wall-clock count — a
        # wall-clock sampler sees parked threads on every tick, and a
        # triage table led by ten thread-pool waits is useless. The idle
        # share is still first-class in categories()/collapsed().
        ranked = sorted(merged.items(),
                        key=lambda kv: (kv[0].startswith("idle;"), -kv[1],
                                        kv[0]))
        rows = []
        for stack, count in ranked[:max(int(n), 0)]:
            cat, _, rest = stack.partition(";")
            tname, _, frames = rest.partition(";")
            rows.append({
                "category": cat,
                "thread": tname,
                "stack": stack,
                "leaf": frames.rsplit(";", 1)[-1] if frames else "",
                "samples": count,
                "pct": round(100.0 * count / total, 2) if total else 0.0,
            })
        return rows

    def categories(self, seconds: Optional[float] = 10.0,
                   now: Optional[float] = None) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for stack, count in self._merged(seconds, now).items():
            cat = stack.split(";", 1)[0]
            out[cat] = out.get(cat, 0) + count
        return out

    def collapsed(self, seconds: Optional[float] = None,
                  now: Optional[float] = None) -> str:
        """Flamegraph-ready collapsed format: one ``stack count`` line per
        distinct folded stack (feed to inferno / flamegraph.pl /
        speedscope)."""
        merged = self._merged(seconds, now)
        return "\n".join(f"{stack} {count}"
                         for stack, count in sorted(merged.items()))

    def jsonable(self, seconds: Optional[float] = 10.0, n: int = 30,
                 now: Optional[float] = None) -> dict:
        cats = self.categories(seconds, now)
        return {
            "hz": self.hz,
            "window_s": self.window_s,
            "uptime_s": round(time.time() - self._started_at, 1),
            "ticks": self.ticks,
            "samples": self.samples,
            "query_seconds": seconds,
            "categories": dict(sorted(cats.items(),
                                      key=lambda kv: -kv[1])),
            "top": self.hot_stacks(seconds, n, now),
        }

    # -- on-demand device trace ---------------------------------------------

    def device_trace(self, seconds: float = 3.0,
                     outdir: Optional[str] = None) -> str:
        """Capture a ``torch.profiler`` window of ``seconds`` (CPU activity,
        and CUDA activity when there is a card), write it as a Chrome trace
        (``trace.json``, Perfetto-loadable) and return its directory.
        Serialized: a second caller while a window is open gets a
        RuntimeError instead of corrupting the first trace."""
        import tempfile

        import torch
        from torch.profiler import ProfilerActivity

        if not self._trace_lock.acquire(blocking=False):
            raise RuntimeError("a device-trace window is already open")
        try:
            out = outdir or tempfile.mkdtemp(prefix="paddle_devtrace_")
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=acts) as prof:
                time.sleep(max(float(seconds), 0.0))
            prof.export_chrome_trace(os.path.join(out, "trace.json"))
            return out
        finally:
            self._trace_lock.release()


# -- module singleton --------------------------------------------------------

_profiler: Optional[SamplingProfiler] = None
_prof_lock = threading.Lock()


def enable(hz: Optional[float] = None, window_s: Optional[float] = None,
           start_thread: bool = True) -> SamplingProfiler:
    """Arm (or return) the process profiler. Idempotent; an explicit
    ``hz`` on an already-armed profiler restarts it at the new rate."""
    global _profiler
    with _prof_lock:
        p = _profiler
        if p is not None:
            if hz is not None and float(hz) != p.hz:
                p.stop()
            else:
                if start_thread:
                    p.start()
                return p
        p = SamplingProfiler(hz=hz, window_s=window_s)
        _profiler = p
    if start_thread:
        p.start()
    return p


def disable() -> None:
    global _profiler
    with _prof_lock:
        p, _profiler = _profiler, None
    if p is not None:
        p.stop()


def get() -> Optional[SamplingProfiler]:
    return _profiler


def reset() -> None:
    disable()
