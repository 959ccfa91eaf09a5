"""Step-time decomposition — where did this training step's wall time go?

Port of ``paddlepaddle_tpu/observability/perf/steptime.py``. One
difference: PyTorch returns before the card finishes, so a bracket closes
with ``torch.cuda.synchronize()`` (when this process has initialised a
card) before it reads the clock; the step's wall, and so its ``compute``
phase, then include the device work the step queued, as the reference's
wall does once the caller materializes the loss. Of the recorder
categories below, the port's hooks record the collectives and comm tasks
(:mod:`...distributed`) and the data loader's waits (:mod:`...io`);
eager dispatch and autograd wait for ROADMAP A11, so their time reads as
``compute``.

Reference surface: the reference profiler's timeline summary buckets
(``paddle.profiler`` statistic categories: Operator / CudaRuntime /
Communication / Dataloader). TPU-native equivalent over the existing span
recorder: the hot-path hooks already record every eager dispatch
("op"), autograd backward ("autograd"), collective/comm task
("collective"/"comm") and — with this PR — dataloader wait
("dataloader") span into the recorder's per-category aggregates, so a
step bracket only has to DIFF those aggregates across the step to know
how much of the wall went to each phase:

* ``comm``      — collective launches + host-blocking comm tasks;
* ``host``      — eager dispatch + autograd node execution (python/
  dispatch overhead; ~0 when the step is one jitted program);
* ``data_wait`` — time blocked on DataLoader workers;
* ``compute``   — the remainder: device execution + the jit dispatch of
  the fused step. For a jitted step that is (to first order) the chip.

This is the attribution tool for the ResNet MFU gap (ROADMAP item 3): a
step that is 30% ``data_wait`` needs input overlap, one that is 95%
``compute`` but low-MFU needs the cost registry's per-program roofline.

Usage::

    tl = obs.perf.timeline()            # module singleton
    for batch in loader:
        with tl.step("train"):
            loss = train_step(*batch)
            loss.numpy()                # sync: wall must include the chip
    print(obs.summary())                # "Step time" section
    obs.export_chrome_trace(path)       # per-phase counter tracks

The step bracket costs two aggregate snapshots (a dict copy under the
recorder lock) — microseconds against millisecond steps. Phases sum to
the step wall by construction (``compute`` is the floor-at-zero
remainder); if nested spans double-count a category the excess shows as
``compute == 0`` with phases > wall, which the summary flags.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional

PHASES = ("compute", "host", "comm", "data_wait")

# recorder categories folded into each non-compute phase
_CAT_PHASE = {
    "collective": "comm",
    "comm": "comm",
    "op": "host",
    "autograd": "host",
    "dataloader": "data_wait",
}


def _device_sync() -> None:
    """Wait for the card's queued work (a no-op without an initialised
    card), so a step's wall ends when its device work does."""
    try:
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    except Exception:
        pass


class StepRecord:
    __slots__ = ("name", "wall_s", "phases", "t_end")

    def __init__(self, name, wall_s, phases, t_end):
        self.name = name
        self.wall_s = wall_s
        self.phases = phases
        self.t_end = t_end


class _StepCtx:
    __slots__ = ("_tl", "_name", "_t0", "_base")

    def __init__(self, tl: "StepTimeline", name: str):
        self._tl = tl
        self._name = name

    def __enter__(self):
        self._base = self._tl._cat_totals()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _device_sync()
        wall = time.perf_counter() - self._t0
        cur = self._tl._cat_totals()
        base = self._base
        phases = {p: 0.0 for p in PHASES}
        for cat, phase in _CAT_PHASE.items():
            phases[phase] += max(0.0, cur.get(cat, 0.0) - base.get(cat, 0.0))
        attributed = sum(phases.values())
        phases["compute"] = max(0.0, wall - attributed)
        # the comm/host/data spans feeding cat_totals are trace-gated: a
        # step bracketed with tracing OFF reads as 100% compute no matter
        # what it did — record the blind spot so render() can say so
        # instead of silently confirming the wrong conclusion
        try:
            from .. import _trace_on

            traced = _trace_on
        except Exception:
            traced = False
        self._tl._push(self._name, wall, phases, traced=traced)
        return False


class StepTimeline:
    """Per-step phase decomposition over the span recorder's aggregates."""

    def __init__(self, recorder=None, keep: int = 512):
        self._recorder = recorder
        self._lock = threading.Lock()
        self.steps: deque = deque(maxlen=int(keep))
        self.totals: Dict[str, float] = {p: 0.0 for p in PHASES}
        self.wall_total = 0.0
        self.count = 0
        self.untraced = 0    # steps bracketed with tracing off (blind)

    def _rec(self):
        if self._recorder is not None:
            return self._recorder
        from .. import get_recorder

        return get_recorder()

    def _cat_totals(self) -> Dict[str, float]:
        return self._rec().cat_totals()

    def step(self, name: str = "step") -> _StepCtx:
        """Context manager bracketing ONE step; it closes with a device
        sync, so ``compute`` covers the card's work, not only dispatch."""
        return _StepCtx(self, name)

    def _push(self, name: str, wall: float, phases: Dict[str, float],
              traced: bool = True) -> None:
        rec = StepRecord(name, wall, phases, time.perf_counter())
        with self._lock:
            self.steps.append(rec)
            self.count += 1
            if not traced:
                self.untraced += 1
            self.wall_total += wall
            for p, v in phases.items():
                self.totals[p] += v
        # metrics: cumulative per-phase seconds (off-cost: one is-enabled
        # check inside safe paths; a step is ms-scale, this is ns-scale)
        try:
            from .. import _metrics_if_enabled, _recorder_if_tracing

            reg = _metrics_if_enabled()
            if reg is not None:
                c = reg.counter("paddle_step_phase_seconds_total",
                                "step wall time attributed per phase")
                for p, v in phases.items():
                    c.inc(v, phase=p)
                reg.counter("paddle_steps_total",
                            "steps bracketed by the StepTimeline").inc()
            r = _recorder_if_tracing()
            if r is not None:
                # Perfetto counter track: stacked per-phase ms at step end
                r.counter_track("step_phases_ms", {
                    p: round(v * 1e3, 3) for p, v in phases.items()})
                r.record_complete(name, "step", wall,
                                  {p: round(v * 1e3, 3)
                                   for p, v in phases.items()})
        except Exception:
            pass

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "count": self.count,
                "untraced": self.untraced,
                "wall_total_s": self.wall_total,
                "phase_totals_s": dict(self.totals),
                "last": [{"name": s.name, "wall_s": s.wall_s,
                          "phases": dict(s.phases)}
                         for s in list(self.steps)[-8:]],
            }

    def clear(self) -> None:
        with self._lock:
            self.steps.clear()
            self.totals = {p: 0.0 for p in PHASES}
            self.wall_total = 0.0
            self.count = 0
            self.untraced = 0

    def render(self) -> str:
        """Summary() section body: phase totals + share of step wall."""
        snap = self.snapshot()
        n = snap["count"]
        if n == 0:
            return "(no steps bracketed)"
        wall = snap["wall_total_s"]
        lines = [f"{n} steps, {wall * 1e3:.1f}ms total "
                 f"({wall / n * 1e3:.2f}ms/step)"]
        for p in PHASES:
            v = snap["phase_totals_s"][p]
            pct = v / wall * 100 if wall > 0 else 0.0
            lines.append(f"  {p:<10}{v * 1e3:>10.2f}ms{pct:>7.1f}%")
        attributed = sum(snap["phase_totals_s"].values())
        if attributed > wall * 1.001:
            lines.append("  (phases exceed wall: nested spans double-"
                         "counted a category; compute floored at 0)")
        if snap["untraced"]:
            lines.append(
                f"  WARNING: {snap['untraced']}/{n} steps bracketed with "
                "tracing OFF — comm/host/data_wait spans were not "
                "recorded, so their time reads as 'compute'; enable "
                "obs.enable(trace=True) for real attribution")
        return "\n".join(lines)
