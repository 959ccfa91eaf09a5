"""Preemption-aware shutdown: SIGTERM -> emergency callbacks -> restartable
exit (the port's own copy of the jax-free
``paddlepaddle_tpu/resilience/preemption.py``).

On a signal the handler runs the registered callbacks in order, then exits
with a restart-eligible code (default 143 = 128 + SIGTERM). Serving hosts
register here through ``ServingEngine.install_preemption_hook()``: a
SIGTERM'd server drains (in-flight requests finish within the drain
timeout, the rest are shed with a typed error) before the exit.
Cooperative loops install with ``exit_on_signal=False`` and poll
:func:`preemption_requested`. The reference also flushes the distributed
checkpoint writer here; the port has none yet (ROADMAP A10), and the flight
recorder's dump waits for A8.
"""

from __future__ import annotations

import os
import signal
import sys
import threading
import traceback
from typing import Callable, List, Optional

__all__ = [
    "PreemptionHandler", "install_preemption_handler",
    "preemption_requested", "uninstall_preemption_handler",
    "RESTART_EXIT_CODE",
]

RESTART_EXIT_CODE = 143


class PreemptionHandler:
    def __init__(self, exit_code: int = RESTART_EXIT_CODE,
                 exit_on_signal: bool = True):
        self.exit_code = exit_code
        self.exit_on_signal = exit_on_signal
        self._callbacks: List[Callable[[], None]] = []
        self._requested = threading.Event()
        self._prev_handlers = {}
        self._lock = threading.Lock()

    def register(self, callback: Callable[[], None]) -> None:
        """Add an emergency callback (run in registration order)."""
        self._callbacks.append(callback)

    def requested(self) -> bool:
        return self._requested.is_set()

    def install(self, signals=(signal.SIGTERM,)) -> "PreemptionHandler":
        """Hook every signal in ``signals`` not already hooked."""
        with self._lock:
            for sig in signals:
                if sig not in self._prev_handlers:
                    self._prev_handlers[sig] = signal.signal(
                        sig, self._on_signal)
        return self

    def uninstall(self) -> None:
        with self._lock:
            for sig, prev in self._prev_handlers.items():
                try:
                    signal.signal(sig, prev)
                except (ValueError, OSError):
                    pass
            self._prev_handlers.clear()

    def _on_signal(self, signum, frame):
        self._requested.set()
        sys.stderr.write(
            f"[preemption] signal {signum} received: emergency callbacks "
            f"then exit({self.exit_code})\n")
        sys.stderr.flush()
        self.drain()
        if self.exit_on_signal:
            # os._exit: the signal may interrupt frames (native code
            # included) where SystemExit would be swallowed
            os._exit(self.exit_code)

    def drain(self) -> None:
        """Run the emergency callbacks; one that raises is reported and the
        rest still run."""
        for cb in self._callbacks:
            try:
                cb()
            except Exception:
                sys.stderr.write("[preemption] emergency callback failed:\n"
                                 + traceback.format_exc())
        sys.stderr.flush()


_handler: Optional[PreemptionHandler] = None


def install_preemption_handler(*callbacks: Callable[[], None],
                               exit_code: Optional[int] = None,
                               exit_on_signal: Optional[bool] = None,
                               signals=(signal.SIGTERM,)) -> PreemptionHandler:
    """Install (or extend) the process-wide handler. On an existing
    handler, ``exit_code`` / ``exit_on_signal`` change its configuration
    only when passed explicitly."""
    global _handler
    if _handler is None:
        _handler = PreemptionHandler(
            exit_code=RESTART_EXIT_CODE if exit_code is None else exit_code,
            exit_on_signal=True if exit_on_signal is None else exit_on_signal)
        _handler.install(signals)
    else:
        if exit_code is not None:
            _handler.exit_code = exit_code
        if exit_on_signal is not None:
            _handler.exit_on_signal = exit_on_signal
        _handler.install(signals)
    for cb in callbacks:
        _handler.register(cb)
    return _handler


def uninstall_preemption_handler() -> None:
    global _handler
    if _handler is not None:
        _handler.uninstall()
        _handler = None


def preemption_requested() -> bool:
    """True once a preemption signal arrived (cooperative-polling mode)."""
    return _handler is not None and _handler.requested()
