"""Runtime flags: the port's own copy of the subset the serving path reads.

Counterpart of ``paddlepaddle_tpu/core/flags.py`` (same semantics: typed
flags, ``FLAGS_xxx`` env override at definition, settable at runtime). Only
the ``serving_*`` limits that ``ServingEngine`` resolves through ``_flag_or``
are defined here; the rest arrive with the modules that read them.
"""

from __future__ import annotations

import os
from typing import Any, Dict


class _Flag:
    __slots__ = ("name", "default", "type", "help", "value")

    def __init__(self, name, default, help_):
        self.name = name
        self.default = default
        self.type = type(default)
        self.help = help_
        self.value = default


_registry: Dict[str, _Flag] = {}


def _key(name: str) -> str:
    return name if name.startswith("FLAGS_") else "FLAGS_" + name


def _parse(s: str, t: type):
    if t is bool:
        return s.lower() in ("1", "true", "yes", "on")
    return t(s)


def define_flag(name: str, default: Any, help_: str = "",
                env: str = None) -> _Flag:
    """Register a typed flag; ``FLAGS_<name>`` (then ``env``) in the
    environment sets its initial value."""
    name = _key(name)
    if name in _registry:
        return _registry[name]
    f = _Flag(name, default, help_)
    raw = os.environ.get(name)
    if raw is None and env is not None:
        raw = os.environ.get(env)
    if raw is not None:
        f.value = _parse(raw, f.type)
    _registry[name] = f
    return f


def flag_value(name: str):
    return _registry[_key(name)].value


# Serving robustness family (inference/serving.py): fleet-wide defaults for
# the ServingEngine's overload/failure protection. 0 means "off" for the
# bound-style flags; constructor arguments win.
define_flag("serving_max_queue", 0,
            "bound on queued generation requests; submits past it shed with "
            "ServerOverloadedError (0 = unbounded)",
            env="PADDLE_SERVING_MAX_QUEUE")
define_flag("serving_max_queue_wait_s", 0.0,
            "shed submits whose estimated queue wait (EWMA of decode-attempt "
            "time x depth) exceeds this many seconds (0 = off)",
            env="PADDLE_SERVING_MAX_QUEUE_WAIT_S")
define_flag("serving_breaker_threshold", 5,
            "consecutive decode failures that open the serving circuit "
            "breaker (submits then fail fast with CircuitOpenError)",
            env="PADDLE_SERVING_BREAKER_THRESHOLD")
define_flag("serving_breaker_reset_s", 30.0,
            "seconds an open serving breaker waits before letting one "
            "half-open probe request through",
            env="PADDLE_SERVING_BREAKER_RESET_S")
