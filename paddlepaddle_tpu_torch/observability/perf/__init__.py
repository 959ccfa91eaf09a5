"""Performance attribution plane — measured rooflines, step decomposition.

Port of ``paddlepaddle_tpu/observability/perf/__init__.py``:

* :mod:`~.costs` — program cost registry: FLOPs/bytes of each program
  (train step, the decode engine's programs) counted over one execution
  (:func:`~.costs.counting`; the reference asks XLA's ``cost_analysis``),
  combined with measured wall time and the device peaks (:mod:`~.device`:
  the H100 SXM, matched by name) into measured MFU, bandwidth share and a
  roofline class. Exported as ``paddle_program_*`` gauges and the
  exporter's ``/programs`` endpoint;
* :mod:`~.steptime` — :class:`~.steptime.StepTimeline`: per-step phase
  breakdown over the recorder's category aggregates, each step closing in
  a device sync.

Off by default: arm with ``PADDLE_OBS_PERF=1`` / ``FLAGS_obs_perf`` or
:func:`enable`. When off, instrumented call sites pay one attribute read;
when on, each program is counted ONCE (its first execution after arming)
and wall observation is a dict update per execution.
"""

from __future__ import annotations

from typing import Optional

from ...core import flags as _flags
from . import costs, device, steptime  # noqa: F401
from .costs import (  # noqa: F401
    CostRegistry,
    counting,
    kernel_work,
    observe,
    registry,
    table_jsonable,
)
from .steptime import StepTimeline  # noqa: F401

_enabled = False
_timeline: Optional[StepTimeline] = None


def enabled() -> bool:
    return _enabled


def enable() -> None:
    """Arm cost capture (idempotent). Programs that ran BEFORE enabling are
    counted at their next execution."""
    global _enabled
    _enabled = True
    _flags.set_flags({"obs_perf": True})
    # crash dumps carry the live program-cost table, resolved at dump time
    try:
        from .. import flight

        flight.annotate("program_costs",
                        lambda: registry().table())
    except Exception:
        pass


def disable() -> None:
    global _enabled
    _enabled = False
    _flags.set_flags({"obs_perf": False})


def reset() -> None:
    """Clear captured costs, observations and the step timeline."""
    registry().clear()
    if _timeline is not None:
        _timeline.clear()


def timeline() -> StepTimeline:
    """The module StepTimeline (created on first use; ``summary()`` renders
    it when it has steps)."""
    global _timeline
    if _timeline is None:
        _timeline = StepTimeline()
    return _timeline


def step(name: str = "step"):
    """Convenience: ``with obs.perf.step("train"): ...`` brackets one step
    on the module timeline."""
    return timeline().step(name)


def publish_gauges() -> None:
    """Mirror the cost table into ``paddle_program_*`` gauges on the
    observability registry (called from ``to_prometheus_text()``)."""
    from .. import get_registry

    costs.publish_gauges(get_registry())


# arm from env (PADDLE_OBS_PERF) at import — same contract as the other
# obs subsystems
if _flags.flag_value("obs_perf"):
    enable()

__all__ = [
    "enabled", "enable", "disable", "reset", "counting", "kernel_work",
    "observe", "registry", "table_jsonable", "publish_gauges",
    "timeline", "step", "StepTimeline", "CostRegistry",
    "costs", "device", "steptime",
]
