"""Runtime flags: the port's own copy of the subset the serving path reads.

Counterpart of ``paddlepaddle_tpu/core/flags.py`` (same semantics: typed
flags, ``FLAGS_xxx`` env override at definition, settable at runtime). Only
the flags the port's modules read are defined here: the ``serving_*``
limits, the deadline, watchdog and drain defaults ``ServingEngine``
resolves, the KV-memory pair ``BatchDecodeEngine`` resolves itself, the
checkpoint's CRC check and the step watchdog's re-arm, and the
``obs_*`` / ``slo_*`` families of the observability planes; the rest
arrive with the modules that read them.
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


def get_flags(flags) -> Dict[str, Any]:
    """Current values of ``flags`` (one name or a list), keyed by the names
    as given; an unknown name raises ``ValueError`` (reference :66)."""
    if isinstance(flags, str):
        flags = [flags]
    out = {}
    for k in flags:
        key = _key(k)
        if key not in _registry:
            raise ValueError(f"Unknown flag {k}")
        out[k] = _registry[key].value
    return out


def set_flags(flags: Dict[str, Any]) -> None:
    """Set flags at runtime (an unknown name is defined on the spot); a
    string value is parsed to the flag's type."""
    for k, v in flags.items():
        k = _key(k)
        if k not in _registry:
            define_flag(k, v)
            continue
        f = _registry[k]
        f.value = (_parse(v, f.type) if isinstance(v, str) and f.type is not str
                   else f.type(v))


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

# Resilience family (reference core/flags.py:279-288): checkpoint integrity
# verification, read by distributed.checkpoint and resilience.integrity,
# and the step watchdog's re-arm (distributed.watchdog).
define_flag("ckpt_verify_crc", True,
            "verify per-shard CRC32 (checkpoint format v3) when loading; "
            "corrupted shards raise CheckpointCorruptionError instead of "
            "loading silently-wrong weights", env="PADDLE_CKPT_VERIFY")
define_flag("watchdog_rearm", True,
            "re-arm the step watchdog after a timed-out step retires, so "
            "every hung step is reported (not only the first)")

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

# Observability family (reference core/flags.py:128-241; observability/):
# each flag also reads its PADDLE_OBS_* spelling; all default off so the
# hot paths carry no instrumentation. The profiler and the memory ledger
# (planes that run a thread) are started by their enable() calls, never at
# import, so they have no arming flag here; the exporter has one,
# obs_export, which distributed.launch --obs_export sets for every worker.
define_flag("obs_trace", False,
            "record host spans into the observability ring buffer for "
            "chrome-trace export", env="PADDLE_OBS_TRACE")
define_flag("obs_metrics", False,
            "aggregate counters, gauges and latency histograms in the "
            "observability metrics registry", env="PADDLE_OBS_METRICS")
define_flag("obs_recompile_watch", False,
            "watch CUDA-graph captures and kernel builds and warn on a "
            "storm (one program captured or built repeatedly)",
            env="PADDLE_OBS_RECOMPILE_WATCH")
define_flag("obs_buffer_size", 100000,
            "observability ring buffer capacity (events)",
            env="PADDLE_OBS_BUFFER_SIZE")
define_flag("obs_recompile_threshold", 3,
            "unplanned captures or builds of one program before the "
            "watchdog flags a storm", env="PADDLE_OBS_RECOMPILE_THRESHOLD")
define_flag("obs_export", False,
            "start the per-rank HTTP telemetry exporter (/metrics /healthz "
            "/vars /trace) when observability is imported, and under a "
            "multi-process launch the fleet publisher (rank 0 serves the "
            "merged view); distributed.launch --obs_export sets this for "
            "every worker", env="PADDLE_OBS_EXPORT")
define_flag("obs_port", 9470,
            "base port for the telemetry exporter; a worker listens on "
            "obs_port + rank (falls back to an ephemeral port if taken)",
            env="PADDLE_OBS_PORT")
define_flag("obs_export_host", "127.0.0.1",
            "bind address for the telemetry exporter",
            env="PADDLE_OBS_EXPORT_HOST")
define_flag("obs_blackbox", False,
            "arm the crash flight recorder: a bounded ring of structured "
            "runtime events dumped as JSONL + all-thread stacks on an "
            "unhandled exception, preemption or breaker open",
            env="PADDLE_OBS_BLACKBOX")
define_flag("obs_blackbox_dir", "",
            "directory for black-box dumps (empty = <tmpdir>/paddle_blackbox)",
            env="PADDLE_OBS_BLACKBOX_DIR")
define_flag("obs_blackbox_events", 2048,
            "flight recorder ring capacity (structured events)",
            env="PADDLE_OBS_BLACKBOX_EVENTS")
define_flag("obs_reqtrace", False,
            "arm request-journey tracing (observability/reqtrace.py): one "
            "stitched trace per serving request, served at /requests",
            env="PADDLE_OBS_REQTRACE")
define_flag("obs_reqtrace_ring", 256,
            "completed request journeys kept in the bounded reqtrace ring",
            env="PADDLE_OBS_REQTRACE_RING")
define_flag("obs_reqtrace_spans", 256,
            "span cap per request journey (overflow counts dropped_spans "
            "instead of growing)", env="PADDLE_OBS_REQTRACE_SPANS")
define_flag("obs_perf", False,
            "arm the performance-attribution plane (observability/perf/): "
            "count the FLOPs and bytes of each program once (train step, "
            "decode engine programs) and serve measured MFU and roofline "
            "as paddle_program_* gauges and /programs",
            env="PADDLE_OBS_PERF")
define_flag("obs_prof_hz", 50.0,
            "sampling-profiler rate in samples per second",
            env="PADDLE_OBS_PROF_HZ")
define_flag("obs_prof_window_s", 120.0,
            "seconds of per-second folded-stack aggregation the profiler "
            "keeps", env="PADDLE_OBS_PROF_WINDOW_S")
define_flag("obs_memledger_interval_s", 5.0,
            "seconds between memory-ledger samples",
            env="PADDLE_OBS_MEMLEDGER_INTERVAL_S")

# Metric history (observability/tsdb.py) and the alert rules' windows
# (observability/alerts.py), reference core/flags.py:162, :197-203; the
# history plane starts only when observability.enable_history() is called.
define_flag("obs_tsdb_interval_s", 2.0,
            "seconds between metric-history samples (and alert-rule "
            "evaluations)", env="PADDLE_OBS_TSDB_INTERVAL_S")
define_flag("obs_tsdb_points", 512,
            "raw-tier ring capacity per series; the coarse tier keeps the "
            "same point count at 10x the spacing, so total history = "
            "points * interval * 11", env="PADDLE_OBS_TSDB_POINTS")
define_flag("obs_publish_interval_s", 2.0,
            "seconds between fleet snapshot publications (the staleness "
            "alert's window reads it)", env="PADDLE_OBS_PUBLISH_INTERVAL_S")

# SLO targets (observability/reqtrace.py burn tracker, reference
# core/flags.py:259-277); 0 = target off.
define_flag("slo_ttft_ms", 0.0,
            "TTFT SLO target in milliseconds; nonzero arms the sliding-"
            "window burn-rate gauge paddle_slo_burn_ttft",
            env="PADDLE_SLO_TTFT_MS")
define_flag("slo_tpot_ms", 0.0,
            "TPOT SLO target in milliseconds; nonzero arms the sliding-"
            "window burn-rate gauge paddle_slo_burn_tpot",
            env="PADDLE_SLO_TPOT_MS")
define_flag("slo_burn_window_s", 60.0,
            "sliding window (seconds) the SLO burn rate is computed over",
            env="PADDLE_SLO_BURN_WINDOW_S")
define_flag("slo_error_budget", 0.01,
            "allowed SLO violation fraction; burn = violation_rate / budget",
            env="PADDLE_SLO_ERROR_BUDGET")
