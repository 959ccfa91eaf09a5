"""In-flight communication/region tracking for hang attribution (the
port's own copy of the jax-free ``paddlepaddle_tpu/distributed/
comm_task.py``).

Reference surface: CommTaskManager (paddle/phi/core/distributed/
comm_task_manager.h:37, comm_task_manager.cc:273) — every NCCL collective
registers a CommTask so a timeout names the exact op and process group.

In the port the tasks are the host-blocking waits: the TCP store's
``get`` / ``wait`` and barrier, the host collectives over it
(:mod:`.host_collectives`), the worker ranks' control gathers
(:mod:`.worker_ranks`), and the eager ``barrier``; and named host regions
(``observability.RecordEvent`` pushes and pops here). The registry keeps
every in-flight task with its name, group and start time; the
:class:`~.watchdog.Watchdog` and the flight recorder dump it, so a hang
reports "store.wait(['hcoll/0/7/r1']) on group store for 1799s inside
region 'train_step'" instead of only a stack dump.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import List, Optional, Tuple

_lock = threading.Lock()
_tasks = {}  # task_id -> (name, group, start_monotonic, thread_id)
_ids = itertools.count()

# observability hook: _obs_task(name, group, elapsed_s) on every completed
# task — per-collective/region latency histograms + trace spans. None when
# observability is off.
_obs_task = None


def begin_task(name: str, group: Optional[str] = None) -> int:
    tid = next(_ids)
    with _lock:
        _tasks[tid] = (name, group, time.monotonic(),
                       threading.get_ident())
    return tid


def end_task(tid: int) -> None:
    with _lock:
        task = _tasks.pop(tid, None)
    if _obs_task is not None and task is not None:
        name, group, start, _thread = task
        _obs_task(name, group, time.monotonic() - start)


class comm_task:
    """Context manager bracketing one communication/region (CommTask)."""

    def __init__(self, name: str, group: Optional[str] = None):
        self.name = name
        self.group = group
        self._tid = None

    def __enter__(self):
        self._tid = begin_task(self.name, self.group)
        return self

    def __exit__(self, *exc):
        if self._tid is not None:
            end_task(self._tid)
            self._tid = None
        return False


def in_flight() -> List[Tuple[str, Optional[str], float, int]]:
    """(name, group, elapsed_s, thread_id) for every live task, oldest
    first — what the watchdog reports at timeout."""
    now = time.monotonic()
    with _lock:
        items = sorted(_tasks.values(), key=lambda t: t[2])
    return [(name, group, now - start, thread)
            for name, group, start, thread in items]


def format_in_flight() -> str:
    tasks = in_flight()
    if not tasks:
        return "  (no registered communication/region in flight)\n"
    lines = []
    for name, group, elapsed, thread in tasks:
        g = f" group={group}" if group else ""
        lines.append(f"  {name}{g} in flight {elapsed:.1f}s (thread {thread})\n")
    return "".join(lines)
