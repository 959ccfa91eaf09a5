"""Runtime flags: the port's own copy of the subset the serving path reads.

Counterpart of ``paddlepaddle_tpu/core/flags.py`` (same semantics: typed
flags, ``FLAGS_xxx`` env override at definition, settable at runtime). Only
the ``serving_*`` flags the serving path reads are defined here: the limits,
the deadline, watchdog and drain defaults ``ServingEngine`` resolves, and
the KV-memory pair ``BatchDecodeEngine`` resolves itself; the rest arrive
with the modules that read them.
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
define_flag("serving_default_deadline_s", 0.0,
            "default per-request deadline applied when submit() passes none "
            "(0 = no deadline)", env="PADDLE_SERVING_DEADLINE_S")
define_flag("serving_breaker_threshold", 5,
            "consecutive decode failures that open the serving circuit "
            "breaker (submits then fail fast with CircuitOpenError)",
            env="PADDLE_SERVING_BREAKER_THRESHOLD")
define_flag("serving_breaker_reset_s", 30.0,
            "seconds an open serving breaker waits before letting one "
            "half-open probe request through",
            env="PADDLE_SERVING_BREAKER_RESET_S")

define_flag("serving_decode_timeout_s", 0.0,
            "engine-thread watchdog: a decode attempt in flight longer than "
            "this trips the breaker open (0 = watchdog off)",
            env="PADDLE_SERVING_DECODE_TIMEOUT_S")
define_flag("serving_drain_timeout_s", 30.0,
            "default drain(timeout): how long a draining engine lets "
            "in-flight slots finish before shedding the remainder",
            env="PADDLE_SERVING_DRAIN_TIMEOUT_S")

# KV-memory family (reference core/flags.py:321-333): int8 KV pages and the
# host-RAM prefix tier. Constructor arguments win; "" / "off" and 0 are off.
define_flag("serving_kv_quant", "",
            "KV-cache quantization for the paged pool: 'int8' stores K/V "
            "pages as int8 codes with per-page-per-head scales (about 2x "
            "pages at a fixed byte budget); '' = full-precision KV",
            env="PADDLE_SERVING_KV_QUANT")
define_flag("serving_kv_host_bytes", 0,
            "byte budget for the host-RAM prefix-cache spill tier: "
            "refcount-0 prefix entries evicted from the device pool are "
            "serialized to host RAM and restored into fresh device pages "
            "on the next hit (0 = tier off, eviction discards)",
            env="PADDLE_SERVING_KV_HOST_BYTES")
