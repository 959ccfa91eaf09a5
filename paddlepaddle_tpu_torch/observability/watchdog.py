"""Capture-and-build watchdog — unplanned program builds, made loud.

Port of ``paddlepaddle_tpu/observability/watchdog.py``. The reference
listens to ``jax.monitoring``'s backend-compile event: every new jit
signature is a fresh XLA compilation. The port compiles in two places, and
both call :func:`record_compile` directly (there is no monitoring bus):

* a CUDA-graph capture of an engine program
  (``inference/decode_engine.py`` ``_CapturedProgram._warm_up_and_capture``;
  site ``capture:<program key>``), the port's counterpart of compiling a
  serving program;
* an ``nvcc`` build of a kernel library (``ops/kernels/_build.build_all``;
  site ``build:<source>``).

A site that crosses ``FLAGS_obs_recompile_threshold`` unplanned builds is a
storm: one warning naming it, a flight-recorder event and the storm
callback. Builds inside :func:`expected_compiles` (an engine warmup, a
bundle save) still count but never feed the storm count, as in the
reference. The reference's persistent-compile-cache latch has no twin
(nothing is retrieved from a cache); a library already on disk is not a
build and is not recorded.
"""

from __future__ import annotations

import logging
import threading
from contextlib import contextmanager
from typing import Dict, List, Optional

_logger = logging.getLogger("paddlepaddle_tpu_torch.observability")

_lock = threading.Lock()
_active = False
_threshold = 3
# site -> [builds, total_s, stormable]; stormable = builds outside every
# expected_compiles() region, the count the threshold watches
_sites: Dict[str, list] = {}
_compile_log: List[dict] = []
_warned: set = set()
_on_storm = None  # test/user hook: callback(site, count)
_tls = threading.local()  # .expected: label inside expected_compiles()


@contextmanager
def expected_compiles(label: str = "planned"):
    """Builds on this thread inside the context still COUNT (reports,
    metrics) but do not feed storm detection — for planned builds (an
    engine warmup walking its compile plan, a bundle save) where several
    builds from one engine are the design."""
    prev = getattr(_tls, "expected", None)
    _tls.expected = label
    try:
        yield
    finally:
        _tls.expected = prev


def record_compile(kind: str, name: str, dur_s: float) -> None:
    """One capture (``kind="capture"``) or kernel build (``"build"``) of
    ``name`` that took ``dur_s`` seconds. Never raises into the caller; a
    no-op unless the watchdog is installed."""
    if not _active:
        return
    try:
        _on_compile(f"{kind}:{name}", float(dur_s))
    except Exception:  # never let telemetry break a capture or a build
        _logger.debug("capture/build watchdog failed", exc_info=True)


def _on_compile(site: str, dur_s: float) -> None:
    from . import _metrics_if_enabled, _recorder_if_tracing

    expected = getattr(_tls, "expected", None)
    storm = None
    with _lock:
        rec = _sites.setdefault(site, [0, 0.0, 0])
        rec[0] += 1
        rec[1] += dur_s
        if expected is None:
            rec[2] += 1
        entry = {"site": site, "duration_s": dur_s, "ordinal": rec[0]}
        if expected is not None:
            entry["planned"] = expected
        _compile_log.append(entry)
        if len(_compile_log) > 1000:
            del _compile_log[:100]
        if rec[2] >= _threshold and site not in _warned:
            _warned.add(site)
            storm = (site, rec[2], rec[1])
    reg = _metrics_if_enabled()
    if reg is not None:
        reg.counter("paddle_jit_compiles_total",
                    "program builds: CUDA-graph captures and kernel "
                    "library builds").inc(site=site)
        reg.histogram("paddle_jit_compile_seconds",
                      "capture / build wall time").observe(dur_s)
    from . import flight

    flight.record("recompile", site, duration_s=round(dur_s, 4),
                  **({"planned": expected} if expected else {}))
    tracer = _recorder_if_tracing()
    if tracer is not None:
        tracer.record_complete("jit_compile", "compile", dur_s,
                               {"site": site})
    if storm is not None:
        site, n, total = storm
        _logger.warning(
            "capture storm: %s was built %d times outside a warmup (%.2fs "
            "in all). Each serve-window capture or build stalls the "
            "requests behind it — warm the engine (warmup()) before it "
            "serves, or load a bundle.", site, n, total)
        if _on_storm is not None:
            _on_storm(site, n)


def install(threshold: Optional[int] = None) -> None:
    global _active, _threshold
    if threshold is not None:
        _threshold = max(int(threshold), 1)
    _active = True


def uninstall() -> None:
    global _active
    _active = False


def set_storm_callback(cb) -> None:
    global _on_storm
    _on_storm = cb


def reset() -> None:
    with _lock:
        _sites.clear()
        _compile_log.clear()
        _warned.clear()


def compile_counts() -> Dict[str, int]:
    """site -> builds recorded (planned and unplanned)."""
    with _lock:
        return {site: rec[0] for site, rec in _sites.items()}


def unplanned_counts() -> Dict[str, int]:
    """site -> builds outside every :func:`expected_compiles` region — what
    a serve window after ``warmup()`` must hold at zero."""
    with _lock:
        return {site: rec[2] for site, rec in _sites.items() if rec[2]}


def compile_log() -> List[dict]:
    with _lock:
        return list(_compile_log)


def report() -> str:
    """Per-site build table, most-built first."""
    with _lock:
        rows = sorted(_sites.items(), key=lambda kv: -kv[1][0])
    lines = [f"{'Builds':>9}  {'Unplanned':>9}  {'Total(s)':>9}  Site"]
    for site, rec in rows:
        n, total, stormable = rec
        marker = "  <-- storm" if stormable >= _threshold else ""
        lines.append(f"{n:>9}  {stormable:>9}  {total:>9.2f}  {site}{marker}")
    if not rows:
        lines.append("  (no captures or builds observed)")
    return "\n".join(lines)
