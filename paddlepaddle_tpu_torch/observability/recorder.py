"""Host span/event recorder — the single event pipeline for the framework.

Port of ``paddlepaddle_tpu/observability/recorder.py``. Every
``RecordEvent`` lands in a ring buffer and exports as chrome trace-event
JSON. Where the reference opens a ``jax.profiler.TraceAnnotation`` (:95),
each span here opens ``torch.profiler.record_function``, so host spans
interleave with the card's kernels in the same timeline when a
``torch.profiler`` trace is active.

A span around a CUDA-graph replay (the serving engine's decode chunk) is a
host span: it covers the replay's launch and whatever host work follows up
to the span's end, not the graph's device time. The chunk's device time is
the profiler's device events, or the chunk's wall up to its one readback.

Design constraints:

* zero dependencies, thread-safe: a ``threading.local`` span stack gives
  correct nesting per thread; completed spans append to a bounded
  ``deque`` (ring buffer — old events fall off, the recorder never OOMs a
  long-running trainer);
* two admission paths: *hooked* spans from the hot-path instrumentation
  (dispatch/autograd/collectives) are gated by ``FLAGS_obs_trace``, while
  *explicit* spans (``RecordEvent`` / ``trace_region(..., force=True)``)
  always record — ``paddle.profiler`` rides the explicit path so it works
  without any flags set;
* aggregation happens at record time (name -> count/total/min/max), so
  ``summary()`` never walks the ring buffer.
"""

from __future__ import annotations

import json
import threading
import time
from collections import defaultdict, deque
from typing import Dict, List, Optional

_PID = 0  # single-process timeline; multi-host traces merge on rank metadata


class Event:
    """One completed span (chrome trace-event "X" phase), or — with
    ``ph="C"`` — a counter sample rendered by Perfetto as a stacked
    counter track (the step-time phase tracks)."""

    __slots__ = ("name", "cat", "ts_us", "dur_us", "tid", "args", "ph")

    def __init__(self, name, cat, ts_us, dur_us, tid, args=None, ph="X"):
        self.name = name
        self.cat = cat
        self.ts_us = ts_us
        self.dur_us = dur_us
        self.tid = tid
        self.args = args
        self.ph = ph

    def to_chrome(self) -> dict:
        ev = {
            "name": self.name,
            "cat": self.cat,
            "ph": self.ph,
            "ts": self.ts_us,
            "pid": _PID,
            "tid": self.tid,
        }
        if self.ph == "X":
            ev["dur"] = self.dur_us
        if self.args:
            ev["args"] = self.args
        return ev


class _SpanStack(threading.local):
    def __init__(self):
        self.stack: List[tuple] = []


class Recorder:
    """Ring-buffer span recorder with per-name aggregates."""

    def __init__(self, capacity: int = 100000):
        self._events: deque = deque(maxlen=int(capacity))
        self._local = _SpanStack()
        self._lock = threading.Lock()
        # (cat, name) -> [count, total_s, min_s, max_s]; aggregated at
        # record time so readers never walk the ring buffer
        self._stats: Dict[tuple, list] = defaultdict(
            lambda: [0, 0.0, float("inf"), 0.0])

    # -- span API ------------------------------------------------------------

    def begin(self, name: str, cat: str = "region",
              annotate: bool = True) -> None:
        """Push a span onto this thread's stack. ``annotate`` opens a
        ``torch.profiler.record_function`` so the span shows in profiler
        timelines; hot-path hooks pass False (annotation costs ~µs)."""
        ann = None
        if annotate:
            import torch

            ann = torch.profiler.record_function(name)
            ann.__enter__()
        self._local.stack.append((name, cat, time.perf_counter(), ann))

    def end(self, args: Optional[dict] = None) -> Optional[Event]:
        """Pop the innermost span and record it. Returns the Event (or None
        on stack underflow — an unmatched end is dropped, not fatal)."""
        if not self._local.stack:
            return None
        name, cat, t0, ann = self._local.stack.pop()
        t1 = time.perf_counter()
        if ann is not None:
            ann.__exit__(None, None, None)
        return self._record(name, cat, t0, t1, args)

    def record_complete(self, name: str, cat: str, dur_s: float,
                        args: Optional[dict] = None) -> Event:
        """Record an already-timed span ending now (hot-path hooks measure
        with a bare perf_counter pair and hand in the duration)."""
        t1 = time.perf_counter()
        return self._record(name, cat, t1 - dur_s, t1, args)

    def _record(self, name, cat, t0, t1, args):
        ev = Event(name, cat, int(t0 * 1e6), int((t1 - t0) * 1e6),
                   threading.get_ident(), args)
        self._events.append(ev)  # deque.append is atomic under the GIL
        dur = t1 - t0
        with self._lock:
            s = self._stats[(cat, name)]
            s[0] += 1
            s[1] += dur
            if dur < s[2]:
                s[2] = dur
            if dur > s[3]:
                s[3] = dur
        return ev

    def count(self, name: str, cat: str = "instant",
              args: Optional[dict] = None) -> None:
        """Zero-duration instant event (chrome "i" phase approximated as a
        0-µs complete event so Perfetto renders it on the track)."""
        now = time.perf_counter()
        self._record(name, cat, now, now, args)

    def counter_track(self, name: str, values: dict,
                      cat: str = "counter") -> None:
        """Chrome "C" (counter) sample: Perfetto draws one stacked track
        per name with one series per key in ``values``. Counter samples
        ride the same ring buffer but stay OUT of the span aggregates
        (they have no duration)."""
        ev = Event(name, cat, int(time.perf_counter() * 1e6), 0,
                   threading.get_ident(),
                   {k: float(v) for k, v in values.items()}, ph="C")
        self._events.append(ev)

    # -- introspection -------------------------------------------------------

    def depth(self) -> int:
        """Current nesting depth on the calling thread."""
        return len(self._local.stack)

    def events(self) -> List[Event]:
        return list(self._events)

    def signature(self) -> tuple:
        """O(1) change detector over the ring (length + newest event's
        identity) — lets periodic exporters skip re-serializing an
        unchanged multi-MB trace."""
        try:
            last = self._events[-1]
        except IndexError:
            return (0, None)
        return (len(self._events), (last.ts_us, last.dur_us, last.name))

    def cat_totals(self) -> Dict[str, float]:
        """Total recorded seconds per span category — the StepTimeline
        diffs two of these to attribute one step's wall time to phases."""
        with self._lock:
            out: Dict[str, float] = {}
            for (c, _name), v in self._stats.items():
                out[c] = out.get(c, 0.0) + v[1]
        return out

    def stats(self, cat: Optional[str] = None) -> Dict[str, tuple]:
        """name -> (count, total_s, min_s, max_s), a consistent copy.
        ``cat`` restricts to one category (e.g. the profiler reports only
        its "record_event" spans); None merges all categories by name."""
        with self._lock:
            items = [(k, tuple(v)) for k, v in self._stats.items()]
        out: Dict[str, tuple] = {}
        for (c, name), (cnt, total, mn, mx) in items:
            if cat is not None and c != cat:
                continue
            prev = out.get(name)
            if prev is None:
                out[name] = (cnt, total, mn, mx)
            else:
                out[name] = (prev[0] + cnt, prev[1] + total,
                             min(prev[2], mn), max(prev[3], mx))
        return out

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._stats.clear()

    def set_capacity(self, capacity: int) -> None:
        with self._lock:
            self._events = deque(self._events, maxlen=int(capacity))

    # -- export --------------------------------------------------------------

    def to_chrome_trace(self) -> dict:
        """Trace-event JSON object (the format Perfetto / chrome://tracing
        loads): {"traceEvents": [...], "displayTimeUnit": "ms"}."""
        return {
            "traceEvents": [e.to_chrome() for e in self._events],
            "displayTimeUnit": "ms",
        }

    def export_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path


class trace_region:
    """Context manager / decorator bracketing one host span.

    ``force=True`` records regardless of ``FLAGS_obs_trace`` (the
    paddle.profiler RecordEvent path); otherwise the region is a no-op
    unless tracing is enabled, so liberally-annotated library code costs
    one attribute read when observability is off.
    """

    __slots__ = ("name", "cat", "force", "_live")

    def __init__(self, name: str, cat: str = "region", force: bool = False):
        self.name = name
        self.cat = cat
        self.force = force
        self._live = False

    def __enter__(self):
        from . import _recorder_if_tracing, get_recorder

        rec = get_recorder() if self.force else _recorder_if_tracing()
        if rec is not None:
            self._live = True
            rec.begin(self.name, self.cat)
        return self

    def __exit__(self, *exc):
        if self._live:
            from . import get_recorder

            get_recorder().end()
            self._live = False
        return False

    def __call__(self, fn):
        name, cat, force = self.name, self.cat, self.force

        def wrapper(*args, **kwargs):
            with trace_region(name, cat, force):
                return fn(*args, **kwargs)

        wrapper.__name__ = getattr(fn, "__name__", name)
        wrapper.__doc__ = fn.__doc__
        wrapper.__wrapped__ = fn
        return wrapper
