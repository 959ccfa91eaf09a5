"""Live memory ledger — "where did the HBM go", attributed and reconciled.

Port of ``paddlepaddle_tpu/observability/memledger.py``. The reference's
two raw feeds become PyTorch's caching allocator: the live bytes
(``jax.live_arrays()``, :223) are ``torch.cuda.memory_allocated()``, and
the allocator's footprint and the card's limit (``memory_stats()``, :233)
are ``torch.cuda.memory_reserved()`` and ``torch.cuda.mem_get_info()``.
Both read only a card this process has already initialised, so on the CPU
(and before any CUDA work) they read nothing: ``unattributed``,
``workspace`` and the headroom gauge stay unset there, as the reference
leaves them on a backend without ``memory_stats``. The buckets are the
reference's, with the engine's own bookkeeping:

* ``params``       — the weights the engine serves with (``engine.net``:
  the model, or its int8 view)
* ``kv_pages``     — the paged (or contiguous) KV pool allocation,
  minus the prefix-pinned share
* ``prefix_pinned`` — prefix-cache pages currently pinned shared
* ``draft``        — speculative draft model weights + draft KV caches
* ``workspace``    — allocator bytes reserved beyond live tensors (the
  CUDA-graph pools, freed blocks the allocator keeps, fragmentation)
* ``kv_host_spill`` — prefix-cache page slabs spilled to the host-RAM
  tier (ROADMAP item 4); HOST bytes, so deliberately excluded from the
  attributed-device sum that ``unattributed`` reconciles against
* ``unattributed`` — live array bytes no bucket claims

Gauges (``paddle_mem_bytes{bucket=}``, ``paddle_mem_total_bytes``,
``paddle_mem_headroom_ratio``, ``paddle_mem_leaked_pages``) ride the
registry, so the tsdb sampler histories headroom and the ``hbm_headroom``
page alert fires on sustained low watermark — on backends with no
``memory_stats`` (CPU) the headroom gauge is simply never set, and the
alert engine's absence-of-data rule means it can never false-fire.

Leak detection reconciles the ``PagePool`` free list against the
engine's slot/prefix page bookkeeping: every used page must be owned by
exactly one slot's private list or pinned by the prefix cache.
``leaked_pages > 0`` after a chaos drill means a release path dropped
pages on the floor — the thing the drill exists to catch.

Engines self-register at construction (weakly — the ledger must never
keep a dead engine's device buffers alive).
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Dict, List, Optional

from ..core import flags as _flags

BUCKETS = ("params", "kv_pages", "prefix_pinned", "draft", "workspace",
           "kv_host_spill", "unattributed")

# module-level so engines can register BEFORE (or without) the ledger
# being armed — arming later must see engines constructed earlier
_engines: List[weakref.ref] = []
_engines_lock = threading.Lock()


def register_engine(engine) -> None:
    """Weakly track a BatchDecodeEngine for attribution/leak checks.
    Called from the engine constructor; never raises."""
    try:
        with _engines_lock:
            _engines[:] = [r for r in _engines if r() is not None]
            if all(r() is not engine for r in _engines):
                _engines.append(weakref.ref(engine))
    except Exception:
        pass


def live_engines() -> list:
    with _engines_lock:
        return [e for e in (r() for r in _engines) if e is not None]


def _tree_bytes(tree) -> int:
    """Bytes of the distinct tensors in ``tree``: a ``torch.nn.Module``
    (its parameters and buffers), a tensor, or nested lists / tuples /
    dicts of them. A storage shared by two leaves (tied embeddings, the
    int8 view's shared norms) counts once."""
    import torch

    seen = set()
    total = 0

    def walk(x):
        nonlocal total
        if isinstance(x, torch.nn.Module):
            for t in list(x.parameters()) + list(x.buffers()):
                walk(t)
        elif isinstance(x, torch.Tensor):
            key = (x.device, x.untyped_storage().data_ptr())
            if key not in seen:
                seen.add(key)
                total += x.untyped_storage().nbytes()
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    try:
        walk(tree)
    except Exception:
        return 0
    return total


def _safe_set(name: str, help_: str, value: float, **labels) -> None:
    try:
        from . import safe_set

        safe_set(name, help_, value, **labels)
    except Exception:
        pass


def leak_check(engine) -> Dict[str, int]:
    """Reconcile the page pool's used count against slot + prefix
    ownership. ``leaked_pages`` is the pages the pool says are out but
    nobody owns (a dropped release); negative would mean double
    ownership. Contiguous-layout engines have no pool — zeros.

    With the host prefix tier armed the check spans both tiers: a prefix
    hash must live in the device cache XOR the host tier (``tier_overlap``
    — a hash in both means a spill forgot to evict, i.e. double-resident
    KV), and ``host_entries``/``host_bytes`` make the host side of "zero
    leaked pages either tier" auditable from one call."""
    if getattr(engine, "kv_layout", None) != "paged":
        return {"pages_used": 0, "slot_pages": 0, "prefix_pages": 0,
                "leaked_pages": 0, "host_entries": 0, "host_bytes": 0,
                "tier_overlap": 0}
    slot_pages = sum(len(p) for p in engine._slot_pages)
    prefix_pages = int(engine.prefix.cached_pages)
    used = int(engine.pool.used)
    host = getattr(engine, "kv_host", None)
    host_entries = host_bytes = overlap = 0
    if host is not None:
        host_entries = len(host)
        host_bytes = int(host.used_bytes)
        overlap = sum(1 for h in host.keys()
                      if engine.prefix.lookup(h) is not None)
    return {
        "pages_used": used,
        "slot_pages": int(slot_pages),
        "prefix_pages": prefix_pages,
        "leaked_pages": used - slot_pages - prefix_pages,
        "host_entries": host_entries,
        "host_bytes": host_bytes,
        "tier_overlap": overlap,
    }


class MemoryLedger:
    """Periodic (or manually driven) bucketed attribution sampler.

    ``start_thread=False`` leaves sampling to explicit :meth:`sample`
    calls — the test/bench contract shared with the tsdb sampler."""

    def __init__(self, interval_s: Optional[float] = None):
        self.interval_s = float(
            interval_s
            or _flags.flag_value("obs_memledger_interval_s") or 5.0)
        self._lock = threading.Lock()
        self._last: Optional[dict] = None
        self._prev: Optional[dict] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- sampling ------------------------------------------------------------

    def sample(self, now: Optional[float] = None) -> dict:
        """Attribute device memory right now, publish the gauges, and
        return the sample (also kept as ``last`` for delta rendering)."""
        t = time.time() if now is None else now
        buckets = {b: 0 for b in BUCKETS}
        engines = live_engines()
        leaked = 0
        for eng in engines:
            buckets["params"] += _tree_bytes(getattr(eng, "net", None))
            try:
                ks = eng.kv_stats()
            except Exception:
                ks = {}
            kv_bytes = int(ks.get("kv_bytes", 0) or 0)
            pinned = 0
            if ks.get("layout") == "paged":
                pinned = (int(ks.get("page_bytes", 0) or 0)
                          * int(ks["prefix"]["cached_pages"]))
            buckets["kv_pages"] += max(kv_bytes - pinned, 0)
            buckets["prefix_pinned"] += pinned
            host = ks.get("host") or {}
            if host.get("enabled"):
                # host-RAM slabs, not device memory: tracked as its own
                # bucket but kept OUT of the attributed-device sum below
                buckets["kv_host_spill"] += int(host.get("used_bytes", 0)
                                                or 0)
            spec = getattr(eng, "spec", None)
            if spec is not None:
                buckets["draft"] += _tree_bytes(
                    getattr(spec, "draft_net", None))
                buckets["draft"] += _tree_bytes(
                    getattr(spec, "draft_caches", None))
            leaked += leak_check(eng)["leaked_pages"]
        live_total = self._live_array_bytes()
        attributed = (buckets["params"] + buckets["kv_pages"]
                      + buckets["prefix_pinned"] + buckets["draft"])
        if live_total:
            buckets["unattributed"] = max(live_total - attributed, 0)
        in_use, limit = self._device_stats()
        if in_use is not None and live_total:
            buckets["workspace"] = max(in_use - live_total, 0)
        sample = {
            "t": t,
            "buckets": buckets,
            "live_array_bytes": live_total,
            "engines": len(engines),
            "leaked_pages": leaked,
            "device_bytes_in_use": in_use,
            "device_bytes_limit": limit,
            "headroom_ratio": (None if not limit
                               else round(1.0 - (in_use or 0) / limit, 4)),
        }
        for b, v in buckets.items():
            _safe_set("paddle_mem_bytes",
                      "attributed device memory, by bucket", v, bucket=b)
        _safe_set("paddle_mem_total_bytes",
                  "total live device array bytes", live_total)
        _safe_set("paddle_mem_leaked_pages",
                  "KV pages the pool holds that no slot or prefix owns",
                  leaked)
        if sample["headroom_ratio"] is not None:
            # only when the backend reports limits: never publishing on
            # CPU keeps the hbm_headroom page alert structurally unable
            # to false-fire where headroom is meaningless
            _safe_set("paddle_mem_headroom_ratio",
                      "free share of the device memory limit "
                      "(hbm_headroom alert input)",
                      sample["headroom_ratio"])
        with self._lock:
            self._prev, self._last = self._last, sample
        return sample

    @staticmethod
    def _live_array_bytes() -> int:
        """Bytes of live tensors on the card (the allocator's allocated
        bytes); 0 where this process has no initialised card."""
        try:
            import torch

            if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
                return 0
            return int(torch.cuda.memory_allocated())
        except Exception:
            return 0

    @staticmethod
    def _device_stats():
        """``(bytes the allocator reserves, the card's total bytes)``;
        ``(None, None)`` without an initialised card."""
        try:
            import torch

            if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
                return None, None
            _free, total = torch.cuda.mem_get_info()
            return int(torch.cuda.memory_reserved()), int(total)
        except Exception:
            return None, None

    # -- read side -----------------------------------------------------------

    def jsonable(self) -> dict:
        """Last sample plus per-bucket deltas since the one before — the
        ``/mem`` payload and ``obsctl mem``'s table."""
        with self._lock:
            last, prev = self._last, self._prev
        if last is None:
            return {"sampled": False}
        deltas = None
        if prev is not None:
            deltas = {b: last["buckets"][b] - prev["buckets"].get(b, 0)
                      for b in last["buckets"]}
        out = dict(last)
        out["sampled"] = True
        out["deltas"] = deltas
        out["interval_s"] = self.interval_s
        return out

    # -- thread --------------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample()
            except Exception:
                pass    # the ledger must never take the process down

    def start(self) -> "MemoryLedger":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="obs-memledger")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None


# -- module singleton --------------------------------------------------------

_ledger: Optional[MemoryLedger] = None
_ledger_lock = threading.Lock()


def enable(interval_s: Optional[float] = None,
           start_thread: bool = True) -> MemoryLedger:
    global _ledger
    with _ledger_lock:
        if _ledger is None:
            _ledger = MemoryLedger(interval_s=interval_s)
        led = _ledger
    if start_thread:
        led.start()
    return led


def disable() -> None:
    global _ledger
    with _ledger_lock:
        led, _ledger = _ledger, None
    if led is not None:
        led.stop()


def get() -> Optional[MemoryLedger]:
    return _ledger


def sample_now() -> dict:
    """One-shot sample for ``/mem`` / ``obsctl mem`` when the ledger is
    not armed: uses the armed ledger if present, else a throwaway one
    over the same registered engines."""
    led = _ledger
    if led is not None:
        led.sample()
        return led.jsonable()
    led = MemoryLedger()
    led.sample()
    return led.jsonable()


def reset() -> None:
    disable()
