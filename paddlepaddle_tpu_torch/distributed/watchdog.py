"""Training watchdog — hang detection for distributed steps (the port's
own copy of the jax-free ``paddlepaddle_tpu/distributed/watchdog.py``).

Reference surface: the collective watchdog (CommTaskManager
paddle/phi/core/distributed/comm_task_manager.h:37 — every NCCL collective
registers a CommTask; a loop detects timeout, logs the exact op, optionally
aborts) and the launcher watch loop (launch/controllers/watcher.py).

A step can hang on a wedged host, a dead peer (a store wait or a gloo
collective that never completes) or a stuck input. The watchdog wraps step
execution: each step registers a task with a deadline; a monitor thread
fires a timeout handler (log + optional abort) if the step doesn't retire
in time — the launcher then restarts the worker
(``distributed.launch --max_restarts``) and training resumes from the
checkpoint (``distributed.checkpoint``, ``resilience.CheckpointManager``).
Each step is a flight-recorder span (``observability.flight``) and a
``step`` chaos seam; a timeout dumps the in-flight comm-task table
(:mod:`.comm_task`), every thread's stack and the black box.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Callable, Optional

from ..observability import flight
from ..resilience.chaos import chaos_point


class StepTimeout(RuntimeError):
    pass


class Watchdog:
    def __init__(self, timeout: float = 1800.0, on_timeout: Optional[Callable] = None,
                 abort: bool = True, poll_interval: float = 1.0):
        self.timeout = timeout
        self.on_timeout = on_timeout
        self.abort = abort
        self.poll_interval = poll_interval
        self._lock = threading.Lock()
        self._current = None  # (name, start_time)
        self._steps = 0  # monotonically-increasing step ordinal (flight)
        self._stop = threading.Event()
        # the task (identity) the watchdog last fired for: a new step re-arms
        # the watchdog (FLAGS_watchdog_rearm), so every hung step is reported
        # — the old boolean latch went dead after the first timeout ever
        self._fired_for = None
        self._thread: Optional[threading.Thread] = None
        self.last_in_flight = []  # populated at timeout for on_timeout consumers

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- task registration (the CommTask analogue) --------------------------
    def step(self, name: str = "train_step"):
        wd = self

        class _Task:
            def __enter__(self):
                with wd._lock:
                    wd._steps += 1
                    ordinal = wd._steps
                self._ordinal = ordinal
                # black box first, chaos second: an injected kill at the
                # step seam must leave the in-flight step in the dump
                flight.record("step", name, phase="begin", ordinal=ordinal)
                try:
                    chaos_point("step")  # injection seam: step execution
                except BaseException:
                    # an exc injection aborts the step before __exit__ can
                    # run — close the flight span or it reads as a stale
                    # in-flight step in a later unrelated dump
                    flight.record("step", name, phase="end",
                                  ordinal=ordinal, ok=False)
                    raise
                with wd._lock:
                    wd._current = (name, time.monotonic())
                return self

            def __exit__(self, *exc):
                flight.record("step", name, phase="end",
                              ordinal=self._ordinal, ok=exc[0] is None)
                with wd._lock:
                    wd._current = None
                return False

        return _Task()

    def run(self, fn, *args, name: str = "train_step", **kwargs):
        with self.step(name):
            return fn(*args, **kwargs)

    # -- monitor ------------------------------------------------------------
    def _loop(self):
        while not self._stop.wait(self.poll_interval):
            with self._lock:
                cur = self._current
            if cur is None:
                continue
            name, start = cur
            elapsed = time.monotonic() - start
            if elapsed > self.timeout and cur is not self._fired_for:
                if self._fired_for is not None and not self._rearm():
                    continue  # legacy one-shot latch opted back in
                self._fired_for = cur  # once per step; a NEW step re-arms
                self._count_timeout(name)
                from .comm_task import in_flight

                # snapshot for programmatic consumers (on_timeout handlers)
                self.last_in_flight = in_flight()
                self._dump(name, elapsed)
                if self.on_timeout is not None:
                    try:
                        self.on_timeout(name, elapsed)
                    except Exception:
                        pass
                if self.abort:
                    # non-zero exit lets the launcher's watch loop restart us
                    os._exit(114)

    @staticmethod
    def _rearm() -> bool:
        try:
            from ..core import flags as _flags

            return bool(_flags.flag_value("watchdog_rearm"))
        except Exception:
            return True

    @staticmethod
    def _count_timeout(name: str) -> None:
        # observability: operators see hang handling happen (cold path)
        try:
            from ..observability import safe_inc

            safe_inc("paddle_watchdog_step_timeouts_total",
                     "steps that exceeded the watchdog timeout, by step name",
                     step=name)
        except Exception:
            pass

    def _dump(self, name, elapsed):
        from .comm_task import format_in_flight

        sys.stderr.write(
            f"[watchdog] step {name!r} exceeded {self.timeout:.0f}s "
            f"(elapsed {elapsed:.0f}s)\n")
        # per-collective/region attribution (the CommTaskManager report,
        # comm_task_manager.cc:273): WHICH op on WHICH group is in flight
        sys.stderr.write("[watchdog] in-flight communication/regions:\n")
        sys.stderr.write(format_in_flight())
        sys.stderr.write("[watchdog] stacks of all threads:\n")
        for tid, frame in sys._current_frames().items():
            sys.stderr.write(f"--- thread {tid} ---\n")
            sys.stderr.write("".join(traceback.format_stack(frame)))
        sys.stderr.flush()
        # black box: stderr dies with the process (or scrolls away in a
        # worker log); the flight recorder persists the same report — the
        # hung step, every thread's stack, the in-flight comm-task table
        flight.record("watchdog_timeout", name,
                      elapsed_s=round(elapsed, 3), timeout_s=self.timeout)
        flight.dump("step_timeout")
