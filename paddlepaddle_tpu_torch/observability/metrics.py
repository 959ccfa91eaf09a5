"""Metrics registry — counters, gauges, histograms with exponential buckets.

The port's own copy of the jax-free ``paddlepaddle_tpu/observability/
metrics.py``, unchanged: for the same calls it writes the same Prometheus
text, byte for byte.

Reference surface: ``paddle.monitor``-style stat registries
(paddle/fluid/platform/monitor.h — STAT_ADD/STAT_RESET macros over named
int64 stats) plus the profiler's summary statistics. Exposed here with the
two read APIs operators actually use: ``snapshot()`` (a plain dict for
logging/assertions) and ``to_prometheus_text()`` (the exposition format, so
a serving process can mount it on a /metrics endpoint verbatim).

Label support is deliberately minimal: one optional label set per
observation, stored keyed by the sorted (k, v) tuple. The hot-path callers
(dispatch, collectives) use a single ``op``/``coll`` label, so cardinality
stays bounded by the op vocabulary.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple


def exponential_buckets(start: float, factor: float, count: int) -> List[float]:
    """``count`` upper bounds growing geometrically from ``start``."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError(
            f"exponential_buckets needs start>0, factor>1, count>=1; got "
            f"({start}, {factor}, {count})")
    out, b = [], float(start)
    for _ in range(count):
        out.append(b)
        b *= factor
    return out


# default latency buckets: 1 µs .. ~134 s in powers of 2 (seconds)
LATENCY_BUCKETS = exponential_buckets(1e-6, 2.0, 28)
# default size buckets: 64 B .. ~4 GiB in powers of 4
BYTES_BUCKETS = exponential_buckets(64, 4.0, 14)


def _label_key(labels: Optional[dict]) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _esc(v: str) -> str:
    """Prometheus exposition label-value escaping (backslash, quote, LF)."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def format_value(v: float) -> str:
    """Exposition sample-value formatting that never loses precision: a
    ``%g`` (6 significant digits) silently corrupts counters past ~1e6 —
    real on any long job — so integral values print as exact integers and
    everything else as the shortest round-tripping repr."""
    f = float(v)
    if f != f or f in (float("inf"), float("-inf")):
        return f"{f:g}"  # nan/inf spellings Prometheus understands
    if f == int(f) and abs(f) < 1e17:
        return str(int(f))
    return repr(f)


def _fmt_labels(key: Tuple[Tuple[str, str], ...], extra: str = "") -> str:
    parts = [f'{k}="{_esc(v)}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class Counter:
    """Monotonically increasing count (per label set)."""

    kind = "counter"

    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._lock = threading.Lock()
        self._values: Dict[tuple, float] = {}

    def inc(self, n: float = 1, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + n

    def value(self, **labels) -> float:
        return self._values.get(_label_key(labels), 0)

    def snapshot(self):
        with self._lock:
            return {key: v for key, v in self._values.items()}

    def expose(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} counter"]
        for key, v in sorted(self.snapshot().items()):
            lines.append(f"{self.name}{_fmt_labels(key)} {format_value(v)}")
        return lines

    def clear(self):
        with self._lock:
            self._values.clear()


class Gauge:
    """Last-written value (per label set)."""

    kind = "gauge"

    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._lock = threading.Lock()
        self._values: Dict[tuple, float] = {}

    def set(self, v: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = v

    def inc(self, n: float = 1, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + n

    def dec(self, n: float = 1, **labels) -> None:
        self.inc(-n, **labels)

    def value(self, **labels) -> float:
        return self._values.get(_label_key(labels), 0)

    def snapshot(self):
        with self._lock:
            return {key: v for key, v in self._values.items()}

    def expose(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} gauge"]
        for key, v in sorted(self.snapshot().items()):
            lines.append(f"{self.name}{_fmt_labels(key)} {format_value(v)}")
        return lines

    def clear(self):
        with self._lock:
            self._values.clear()


class _HistState:
    __slots__ = ("counts", "sum", "count", "min", "max")

    def __init__(self, nbuckets):
        self.counts = [0] * (nbuckets + 1)  # +1 for the +Inf bucket
        self.sum = 0.0
        self.count = 0
        self.min = float("inf")
        self.max = 0.0


class Histogram:
    """Cumulative histogram over fixed (typically exponential) buckets."""

    kind = "histogram"

    def __init__(self, name: str, help_: str = "",
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.help = help_
        self.buckets = list(buckets if buckets is not None else LATENCY_BUCKETS)
        if self.buckets != sorted(self.buckets):
            raise ValueError(f"histogram {name}: buckets must be sorted")
        self._lock = threading.Lock()
        self._states: Dict[tuple, _HistState] = {}

    def observe(self, v: float, **labels) -> None:
        key = _label_key(labels)
        # le (<=) bucket semantics: v equal to a bound counts IN that bucket
        idx = bisect_left(self.buckets, v)
        with self._lock:
            st = self._states.get(key)
            if st is None:
                st = self._states[key] = _HistState(len(self.buckets))
            st.counts[idx] += 1
            st.sum += v
            st.count += 1
            if v < st.min:
                st.min = v
            if v > st.max:
                st.max = v

    def quantile(self, q: float, **labels) -> float:
        """Upper-bound estimate of the q-quantile from bucket counts."""
        st = self._states.get(_label_key(labels))
        if st is None or st.count == 0:
            return 0.0
        target = q * st.count
        seen = 0
        for i, c in enumerate(st.counts):
            seen += c
            if seen >= target:
                return self.buckets[i] if i < len(self.buckets) else st.max
        return st.max

    def snapshot(self):
        with self._lock:
            return {
                key: {"count": st.count, "sum": st.sum, "min": st.min,
                      "max": st.max,
                      "buckets": dict(zip(self.buckets + [float("inf")],
                                          st.counts))}
                for key, st in self._states.items()
            }

    def expose(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        for key, snap in sorted(self.snapshot().items()):
            cum = 0
            for le, c in snap["buckets"].items():
                cum += c
                le_s = "+Inf" if le == float("inf") else f"{le:g}"
                le_label = 'le="%s"' % le_s
                lines.append(
                    f"{self.name}_bucket{_fmt_labels(key, le_label)} {cum}")
            lines.append(f"{self.name}_sum{_fmt_labels(key)} "
                         f"{format_value(snap['sum'])}")
            lines.append(f"{self.name}_count{_fmt_labels(key)} {snap['count']}")
        return lines

    def clear(self):
        with self._lock:
            self._states.clear()


def snapshot_to_jsonable(snap: dict) -> dict:
    """Registry ``snapshot()`` re-shaped for JSON: tuple label keys become
    ``{"labels": {...}, "value": ...}`` rows, histogram bucket bounds become
    strings (``"+Inf"`` for the overflow bucket), non-finite floats become
    null — strict-JSON consumers (browsers, jq) must be able to load the
    ``/vars`` endpoint verbatim."""
    import math

    def scalar(v):
        return None if isinstance(v, float) and not math.isfinite(v) else v

    out = {}
    for metric, by_key in snap.items():
        rows = []
        for key, v in sorted(by_key.items()):
            if isinstance(v, dict):  # histogram state
                v = dict(v, sum=scalar(v.get("sum")),
                         min=scalar(v.get("min")), max=scalar(v.get("max")),
                         buckets={("+Inf" if le == float("inf") else f"{le:g}"): c
                                  for le, c in v.get("buckets", {}).items()})
            else:
                v = scalar(v)
            rows.append({"labels": dict(key), "value": v})
        out[metric] = rows
    return out


def _unesc(v: str) -> str:
    """Inverse of :func:`_esc` (exposition label-value escaping)."""
    out, i = [], 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            out.append({"\\": "\\", '"': '"', "n": "\n"}.get(nxt, "\\" + nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _parse_label_block(line: str, start: int, lineno: int):
    """Parse ``{k="v",...}`` beginning at ``line[start] == '{'``; returns
    (labels dict, index just past the closing brace)."""
    labels: Dict[str, str] = {}
    i = start + 1
    while i < len(line) and line[i] != "}":
        eq = line.find("=", i)
        if eq < 0 or line[eq + 1: eq + 2] != '"':
            raise ValueError(f"line {lineno}: malformed label block")
        key = line[i:eq].strip().lstrip(",").strip()
        j = eq + 2  # scan the quoted value, honoring backslash escapes
        raw = []
        while j < len(line):
            c = line[j]
            if c == "\\" and j + 1 < len(line):
                raw.append(line[j:j + 2])
                j += 2
                continue
            if c == '"':
                break
            raw.append(c)
            j += 1
        if j >= len(line):
            raise ValueError(f"line {lineno}: unterminated label value")
        labels[key] = _unesc("".join(raw))
        i = j + 1
    if i >= len(line) or line[i] != "}":
        raise ValueError(f"line {lineno}: unterminated label block")
    return labels, i + 1


def parse_prometheus_text(text: str) -> Dict[str, dict]:
    """Strict parser for the exposition subset :meth:`Registry.
    to_prometheus_text` emits. Returns ``{family_name: {"help": str,
    "type": str, "samples": [(sample_name, labels_dict, value), ...]}}``.

    Strict means it *raises* ``ValueError`` on anything the emitter should
    never produce: a sample before its ``# HELP``/``# TYPE`` pair, a TYPE
    for an undeclared family, an unknown metric type, a malformed label
    block, or a histogram-suffixed sample whose base family is not a
    histogram. Used both by the round-trip exposition tests and by the
    fleet aggregator (which re-labels every sample with its rank).
    """
    families: Dict[str, dict] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            name, _, help_ = line[len("# HELP "):].partition(" ")
            if not name:
                raise ValueError(f"line {lineno}: HELP without a name")
            families.setdefault(
                name, {"help": help_, "type": None, "samples": []}
            )["help"] = help_
            continue
        if line.startswith("# TYPE "):
            name, _, kind = line[len("# TYPE "):].partition(" ")
            if name not in families:
                raise ValueError(f"line {lineno}: TYPE before HELP for {name!r}")
            if kind not in ("counter", "gauge", "histogram"):
                raise ValueError(f"line {lineno}: unknown type {kind!r}")
            families[name]["type"] = kind
            continue
        if line.startswith("#"):
            continue  # comments are legal exposition
        brace = line.find("{")
        space = line.find(" ")
        if brace != -1 and (space == -1 or brace < space):
            sample_name = line[:brace]
            labels, end = _parse_label_block(line, brace, lineno)
            value_text = line[end:].strip()
        else:
            sample_name, _, value_text = line.partition(" ")
            labels = {}
        try:
            value = float(value_text)
        except ValueError:
            raise ValueError(f"line {lineno}: bad sample value {value_text!r}")
        fam = families.get(sample_name)
        if fam is None:
            for suffix in ("_bucket", "_sum", "_count"):
                if sample_name.endswith(suffix):
                    base = families.get(sample_name[:-len(suffix)])
                    if base is not None and base["type"] == "histogram":
                        fam = base
                        break
        if fam is None or fam["type"] is None:
            raise ValueError(
                f"line {lineno}: sample {sample_name!r} has no declared "
                f"HELP/TYPE family")
        fam["samples"].append((sample_name, labels, value))
    return families


class Registry:
    """Named metric store. ``counter``/``gauge``/``histogram`` are
    get-or-create (idempotent, like prometheus_client), so instrumented
    modules can resolve their metrics at install time without ordering
    constraints."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get_or_create(self, cls, name, help_, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help_, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get_or_create(Counter, name, help_)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help_)

    def histogram(self, name: str, help_: str = "",
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help_, buckets=buckets)

    def get(self, name: str):
        return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> dict:
        """{metric_name: {label_key: value-or-hist-dict}} for everything."""
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: m.snapshot() for m in metrics}

    def to_prometheus_text(self) -> str:
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.expose())
        return "\n".join(lines) + ("\n" if lines else "")

    def clear(self) -> None:
        """Zero every metric (registrations survive — hooks keep their
        references)."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.clear()
