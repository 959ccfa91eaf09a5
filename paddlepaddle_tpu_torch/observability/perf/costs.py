"""Program cost registry — counted FLOPs/bytes per program, combined with
measured wall time into per-program roofline numbers.

Port of ``paddlepaddle_tpu/observability/perf/costs.py``. The reference
asks XLA for the cost of the program it compiled (``cost_analysis``); an
eager PyTorch program has no compiler to ask, so the port counts one
execution instead (:func:`counting`):

* ``torch.utils.flop_counter.FlopCounterMode`` counts the matmul-class
  operations (``mm``, ``bmm``, ``addmm``, attention, convolutions) at 2
  FLOPs a multiply-add, as XLA counts a dot;
* a dispatch mode adds one FLOP per output element of every pointwise
  operation and one per input element of every reduction (XLA's
  elementwise count), and the bytes every operation reads and writes —
  eager PyTorch runs each operation as its own kernel, so these are the
  bytes it moves, where the reference's bytes are those of its program;
* the port's own kernels are ctypes calls that no dispatch mode sees, so
  each kernel wrapper reports the work of its launch
  (:func:`kernel_work`; the formulas live beside each wrapper:
  ``paged_work``, ``flash_work``, ``varlen_pairs``, ``gather_gemm_work``).
  On the CPU a wrapper runs its plain version, which the two modes count.

Call sites observe wall time per execution with
:func:`CostRegistry.observe`; the registry then derives, per (program,
shape-bucket):

* ``mfu``      — flops / (min_wall * peak_flops): achieved fraction of
  the chip's matmul peak at the program's best observed wall time;
* ``hbm_util`` — bytes / (min_wall * peak_bw): achieved fraction of HBM
  bandwidth;
* ``intensity`` (flops/byte) vs the device ridge point -> ``bound``
  ("compute" or "bandwidth") and ``pct_of_peak`` against the respective
  peak — the roofline classification.

Counting runs only where the perf plane is armed, once per program; the
window times nothing and adds a Python call per operation to the one
execution it counts.
"""

from __future__ import annotations

import sys
import threading
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from . import device as _device


class ProgramCost:
    """Cost + timing accumulator for one (program, bucket)."""

    __slots__ = ("name", "bucket", "flops", "bytes_accessed", "bytes_out",
                 "calls", "wall_total", "wall_min", "meta")

    def __init__(self, name: str, bucket: str):
        self.name = name
        self.bucket = bucket
        self.flops: Optional[float] = None
        self.bytes_accessed: Optional[float] = None
        self.bytes_out: Optional[float] = None
        self.calls = 0
        self.wall_total = 0.0
        self.wall_min = float("inf")
        self.meta: Dict[str, object] = {}

    def derived(self, specs: dict) -> dict:
        """One row of the /programs table: raw cost + roofline numbers."""
        row = {
            "program": self.name,
            "bucket": self.bucket,
            "flops": self.flops,
            "hbm_bytes": self.bytes_accessed,
            "out_bytes": self.bytes_out,
            "calls": self.calls,
            "wall_s_min": None if self.calls == 0 else self.wall_min,
            "wall_s_avg": (None if self.calls == 0
                           else self.wall_total / self.calls),
        }
        row.update(self.meta)
        f, b = self.flops, self.bytes_accessed
        if specs.get("peak_flops") is None:
            return row     # a card without peaks: raw costs only
        if f is not None and b and b > 0:
            ai = f / b
            row["intensity_flops_per_byte"] = ai
            row["bound"] = ("compute" if ai >= specs["ridge_flops_per_byte"]
                            else "bandwidth")
        if self.calls and self.wall_min > 0:
            if f is not None:
                row["mfu"] = f / (self.wall_min * specs["peak_flops"])
            if b is not None:
                row["hbm_util"] = b / (self.wall_min
                                       * specs["peak_hbm_bytes_per_s"])
            bound = row.get("bound")
            if bound == "compute" and "mfu" in row:
                row["pct_of_peak"] = row["mfu"]
            elif bound == "bandwidth" and "hbm_util" in row:
                row["pct_of_peak"] = row["hbm_util"]
        return row


class CostRegistry:
    """Thread-safe store of :class:`ProgramCost` rows keyed by
    (program name, shape bucket)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._programs: Dict[Tuple[str, str], ProgramCost] = {}

    def _get(self, name: str, bucket: str) -> ProgramCost:
        key = (str(name), str(bucket))
        with self._lock:
            pc = self._programs.get(key)
            if pc is None:
                pc = self._programs[key] = ProgramCost(*key)
            return pc

    def record(self, name: str, flops=None, bytes_accessed=None,
               bytes_out=None, bucket: str = "", **meta) -> ProgramCost:
        """Register (or update) a program's compiler-reported cost."""
        pc = self._get(name, bucket)
        if flops is not None:
            pc.flops = float(flops)
        if bytes_accessed is not None:
            pc.bytes_accessed = float(bytes_accessed)
        if bytes_out is not None:
            pc.bytes_out = float(bytes_out)
        if meta:
            pc.meta.update(meta)
        return pc

    def observe(self, name: str, wall_s: float, bucket: str = "") -> None:
        """Fold one measured execution wall time into the program's row
        (creates the row if cost capture hasn't happened / failed)."""
        pc = self._get(name, bucket)
        wall_s = float(wall_s)
        with self._lock:
            pc.calls += 1
            pc.wall_total += wall_s
            if wall_s < pc.wall_min:
                pc.wall_min = wall_s

    def programs(self) -> List[ProgramCost]:
        with self._lock:
            return list(self._programs.values())

    def table(self, specs: Optional[dict] = None) -> List[dict]:
        """Derived rows (roofline numbers included), MFU-descending."""
        if specs is None:
            try:
                specs = _device.specs()
            except Exception:   # no device to describe: raw costs only
                specs = {"peak_flops": None}
        rows = [pc.derived(specs) for pc in self.programs()]
        rows.sort(key=lambda r: -(r.get("mfu") or 0.0))
        return rows

    def clear(self) -> None:
        with self._lock:
            self._programs.clear()


_registry = CostRegistry()


def registry() -> CostRegistry:
    return _registry


def observe(name: str, wall_s: float, bucket: str = "") -> None:
    _registry.observe(name, wall_s, bucket=bucket)


# the open counting windows' kernel-work lists, innermost last. Process-wide,
# not thread-local: autograd runs a CUDA backward (and its kernels) on its
# own device thread.
_windows: List[list] = []
_windows_lock = threading.Lock()


def counting_open() -> bool:
    """Whether a :func:`counting` window is open (a wrapper computes its
    launch's work only then: some formulas read indices on the host)."""
    return bool(_windows)


def kernel_work(name: str, flops: float, bytes_: float) -> None:
    """A kernel wrapper's report of one launch's work (where it launches
    its kernel, never on the CPU's plain path): added to the innermost open
    :func:`counting` window, a no-op without one."""
    if _windows:
        with _windows_lock:
            if _windows:
                _windows[-1].append((name, float(flops), float(bytes_)))


class _OpCounter:
    """Dispatch mode adding XLA's elementwise FLOPs and every operation's
    bytes read and written (built lazily: the mode's base class lives in
    torch)."""

    def __new__(cls):
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_flatten

        pointwise, reduction = torch.Tag.pointwise, torch.Tag.reduction

        class Mode(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.flops = 0
                self.bytes = 0

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                ins = [a for a in tree_flatten((args, kwargs))[0]
                       if isinstance(a, torch.Tensor)]
                outs = [a for a in tree_flatten(out)[0]
                        if isinstance(a, torch.Tensor)]
                if pointwise in func.tags:
                    self.flops += max((o.numel() for o in outs), default=0)
                elif reduction in func.tags:
                    self.flops += max((i.numel() for i in ins), default=0)
                self.bytes += sum(t.numel() * t.element_size()
                                  for t in ins + outs)
                return out

        return Mode()


class Count:
    """What one :func:`counting` window counted."""

    __slots__ = ("flops", "bytes_accessed")

    def __init__(self):
        self.flops = 0.0
        self.bytes_accessed = 0.0


@contextmanager
def counting(name: Optional[str] = None, bucket: str = "",
             scale: float = 1.0, **meta):
    """Count the FLOPs and bytes of the work run inside the window (see
    the module docstring) and, with ``name``, record them as the cost of
    one execution of program ``(name, bucket)``, times ``scale``. Yields a
    :class:`Count` filled in when the window closes. The window runs its
    body for real: count an execution the caller was going to make."""
    from torch.utils.flop_counter import FlopCounterMode

    c = Count()
    acc: List[tuple] = []
    with _windows_lock:
        _windows.append(acc)
    ops = _OpCounter()
    try:
        with FlopCounterMode(display=False) as fc, ops:
            yield c
    finally:
        with _windows_lock:
            del _windows[next(i for i, w in enumerate(_windows)
                              if w is acc)]
            prev = _windows[-1] if _windows else None
    c.flops = float(fc.get_total_flops() + ops.flops
                    + sum(f for _, f, _ in acc))
    c.bytes_accessed = float(ops.bytes + sum(b for _, _, b in acc))
    if prev is not None:      # an enclosing window sees this one's kernels
        prev.extend(acc)
    if name is not None:
        if scale != 1.0:
            meta.setdefault("cost_scale", scale)
        _registry.record(name, flops=c.flops * scale,
                         bytes_accessed=c.bytes_accessed * scale,
                         bucket=bucket, cost_source="counted", **meta)


def _capture_failed(name: str, e: Exception) -> None:
    try:
        from .. import safe_inc

        safe_inc("paddle_program_capture_failures_total",
                 "program cost captures that failed (the "
                 "count)", program=name)
        sys.stderr.write(
            f"[obs.perf] cost capture for {name!r} failed: "
            f"{type(e).__name__}: {e}\n")
    except Exception:
        pass


# -- export ------------------------------------------------------------------

def table_jsonable() -> dict:
    """The /programs endpoint body: device specs + derived program rows
    (strict JSON — non-finite values nulled)."""
    import math

    try:
        specs = _device.specs()
    except Exception:
        specs = None

    def scrub(v):
        if isinstance(v, float) and not math.isfinite(v):
            return None
        return v

    rows = [{k: scrub(v) for k, v in r.items()}
            for r in _registry.table(specs)]
    return {"device": specs, "programs": rows}


def publish_gauges(metrics_registry) -> None:
    """Mirror the derived table into ``paddle_program_*`` gauges on the
    given metrics registry — called lazily from ``to_prometheus_text()``
    so every /metrics scrape sees fresh roofline numbers without any
    per-step publication cost."""
    rows = _registry.table()
    if not rows:
        return
    g = {
        "flops": metrics_registry.gauge(
            "paddle_program_flops",
            "counted FLOPs per execution of the program"),
        "hbm_bytes": metrics_registry.gauge(
            "paddle_program_hbm_bytes",
            "counted bytes read and written per execution"),
        "calls": metrics_registry.gauge(
            "paddle_program_calls",
            "observed executions folded into the program's timing"),
        "wall_s_min": metrics_registry.gauge(
            "paddle_program_wall_seconds_min",
            "best observed wall time of one execution"),
        "mfu": metrics_registry.gauge(
            "paddle_program_mfu",
            "measured FLOPs / (best wall * device peak FLOP/s)"),
        "hbm_util": metrics_registry.gauge(
            "paddle_program_hbm_util",
            "accessed bytes / (best wall * device peak HBM bandwidth)"),
    }
    bound = metrics_registry.gauge(
        "paddle_program_compute_bound",
        "roofline classification (1 = compute-bound, 0 = bandwidth-bound)")
    for row in rows:
        labels = {"program": row["program"], "bucket": row["bucket"]}
        for key, gauge in g.items():
            v = row.get(key)
            if v is not None:
                gauge.set(float(v), **labels)
        if row.get("bound") is not None:
            bound.set(1.0 if row["bound"] == "compute" else 0.0, **labels)


def render_table(rows: List[dict]) -> str:
    """Human-readable table over derived rows (summary() and obsctl)."""

    def fnum(v, unit=""):
        if v is None:
            return "-"
        for scale, suf in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "k")):
            if abs(v) >= scale:
                return f"{v / scale:.2f}{suf}{unit}"
        return f"{v:.3g}{unit}"

    lines = [f"{'Program':<28}{'Bucket':>10}{'Calls':>7}{'FLOPs':>9}"
             f"{'Bytes':>9}{'Wall(ms)':>10}{'MFU':>7}{'BW%':>7}  Bound"]
    for r in rows:
        wall = r.get("wall_s_min")
        mfu = r.get("mfu")
        bw = r.get("hbm_util")
        lines.append(
            f"{r['program'][:28]:<28}{r['bucket'][:10]:>10}"
            f"{r.get('calls', 0):>7}{fnum(r.get('flops')):>9}"
            f"{fnum(r.get('hbm_bytes')):>9}"
            f"{'-' if wall is None else f'{wall * 1e3:.3f}':>10}"
            f"{'-' if mfu is None else f'{mfu:.3f}':>7}"
            f"{'-' if bw is None else f'{bw * 100:.1f}':>7}"
            f"  {r.get('bound', '-')}")
    return "\n".join(lines)
