"""Host-side KV page-pool bookkeeping for the paged decode engine.

The port's own copy of the jax-free host half of
``paddlepaddle_tpu/inference/kv_pool.py``: ``pages_needed``, ``prefix_hash``,
the ``KVS1`` page-slab format (``serialize_page_slab`` :55 /
``deserialize_page_slab`` :91), ``HostSlab`` (:130), ``HostPrefixTier``
(:149), ``PagePool`` (:245), ``PrefixEntry`` and ``PrefixCache`` (:317).
The device half is the engine's ``[slots, max_len/page_size]`` int32 page
table, which the paged-attention kernel walks itself.

The slab format is byte-identical to the reference's in both directions.
Arrays are torch tensors or numpy arrays on the way in and CPU torch tensors
on the way out: numpy has no bfloat16, so a bf16 tensor is written under the
manifest name ``"bfloat16"`` as its raw 2-byte payload and read back into
``torch.bfloat16`` through the same 16-bit view (the reference goes through
``ml_dtypes``).

The one engine thread owns every mutation (admission, retirement, eviction,
spill, restore).

Page 0 is the NULL page: every unmapped page-table entry points at it, so a
scatter past a slot's reservation lands in one sacrificial page and a read
through an unmapped entry sees finite values that the length mask hides. It
is never allocated.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import struct
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["PagePool", "PrefixCache", "PrefixEntry", "HostPrefixTier",
           "HostSlab", "pages_needed", "prefix_hash",
           "serialize_page_slab", "deserialize_page_slab"]


def pages_needed(tokens: int, page_size: int) -> int:
    """Pages covering ``tokens`` KV positions (ceil division)."""
    return -(-int(tokens) // int(page_size))


def prefix_hash(prompt_ids, aligned: int) -> str:
    """Content hash of the page-aligned shared prefix. Keyed by the token
    bytes AND the aligned length, so a prefix cached at 128 tokens never
    answers a lookup for its own 64-token head."""
    ids = np.ascontiguousarray(np.asarray(prompt_ids, np.int32).reshape(-1))
    return f"{aligned}:" + hashlib.sha1(ids[:aligned].tobytes()).hexdigest()


_SLAB_MAGIC = b"KVS1"
# manifest dtype name <-> torch dtype: the names numpy (and ml_dtypes, for
# bfloat16) give ``dtype.name`` in the reference
_TORCH_OF_NAME = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}
_NAME_OF_TORCH = {v: k for k, v in _TORCH_OF_NAME.items()}


def _name_and_bytes(a) -> Tuple[str, List[int], bytes]:
    """(manifest dtype name, shape, raw little-endian bytes) of one array."""
    if isinstance(a, torch.Tensor):
        # at least 1-d, as the reference's np.ascontiguousarray makes it
        t = a.detach().to("cpu").contiguous().reshape(a.shape or (1,))
        if t.dtype not in _NAME_OF_TORCH:
            raise TypeError(f"page slab: unsupported dtype {t.dtype}")
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
        return _NAME_OF_TORCH[t.dtype], list(t.shape), raw.tobytes()
    a = np.ascontiguousarray(np.asarray(a))
    return a.dtype.name, list(a.shape), a.tobytes()


def serialize_page_slab(meta: dict, arrays) -> bytes:
    """Pack the physical content of a prefix's KV pages (per-layer page
    tensors, their scales under int8) and the engine facts in ``meta`` into
    one byte string, the reference's wire format:

        [4B magic "KVS1"][u32 header_len][header JSON][raw array bytes...]

    The header is ``{"meta": meta, "arrays": [{"dtype", "shape"}, ...]}``
    as sorted-key JSON."""
    manifest = []
    chunks = []
    for a in arrays:
        name, shape, raw = _name_and_bytes(a)
        manifest.append({"dtype": name, "shape": shape})
        chunks.append(raw)
    header = json.dumps({"meta": meta, "arrays": manifest},
                        sort_keys=True).encode("utf-8")
    out = bytearray()
    out += _SLAB_MAGIC
    out += struct.pack("<I", len(header))
    out += header
    for c in chunks:
        out += c
    return bytes(out)


def deserialize_page_slab(blob: bytes) -> Tuple[dict, List[torch.Tensor]]:
    """Inverse of :func:`serialize_page_slab`: ``(meta, [CPU tensor])``.
    Raises ``ValueError`` on a bad magic, an unknown dtype, a truncated
    payload or trailing bytes: a corrupt slab surfaces loudly, never as
    wrong KV."""
    if blob[:4] != _SLAB_MAGIC:
        raise ValueError("page slab: bad magic (not a KVS1 slab)")
    (hlen,) = struct.unpack("<I", blob[4:8])
    header = json.loads(blob[8:8 + hlen].decode("utf-8"))
    meta, manifest = header["meta"], header["arrays"]
    arrays = []
    off = 8 + hlen
    for spec in manifest:
        dt = _TORCH_OF_NAME.get(spec["dtype"])
        if dt is None:
            raise ValueError(f"page slab: unknown dtype {spec['dtype']!r}")
        shape = tuple(int(n) for n in spec["shape"])
        n = dt.itemsize * int(np.prod(shape, dtype=np.int64))
        raw = blob[off:off + n]
        if len(raw) != n:
            raise ValueError("page slab: truncated array payload")
        store = torch.int16 if dt == torch.bfloat16 else dt
        t = torch.frombuffer(bytearray(raw), dtype=store) if n \
            else torch.empty(0, dtype=store)
        arrays.append(t.view(dt).reshape(shape))
        off += n
    if off != len(blob):
        raise ValueError("page slab: trailing bytes after last array")
    return meta, arrays


class HostSlab:
    """One spilled prefix resident in the host tier: its serialized page
    slab plus the LRU stamp it carried on the device tier (so host-tier
    discard order continues the device-tier LRU, not insertion order)."""

    __slots__ = ("blob", "length", "n_pages", "stamp", "hits")

    def __init__(self, blob: bytes, length: int, n_pages: int, stamp: int):
        self.blob = blob
        self.length = int(length)
        self.n_pages = int(n_pages)
        self.stamp = int(stamp)
        self.hits = 0

    @property
    def nbytes(self) -> int:
        return len(self.blob)


class HostPrefixTier:
    """Bounded host-RAM spill tier for refcount-0 prefix entries. The two
    tiers are EXCLUSIVE: a prefix lives either in device pages
    (:class:`PrefixCache`) or here as a serialized slab, never both;
    restore pops the slab before device pages are written.

    LRU spans both tiers: ``put`` carries the device entry's ``last_used``
    stamp across, and when the byte budget is exceeded the smallest stamp is
    discarded first. A host-tier discard is the TRUE eviction; the
    device-tier "eviction" above it was only a spill."""

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        if self.max_bytes <= 0:
            raise ValueError(
                f"host tier byte budget must be > 0, got {max_bytes} "
                "(use no tier at all for 'off')")
        self._entries: Dict[str, HostSlab] = {}
        self.used_bytes = 0
        self.spills = 0      # slabs accepted into the tier
        self.restores = 0    # slabs popped for device restore
        self.discards = 0    # true evictions (budget pressure or rejects)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, h: str) -> bool:
        return h in self._entries

    def keys(self):
        return list(self._entries.keys())

    @property
    def occupancy(self) -> float:
        return self.used_bytes / self.max_bytes

    def put(self, h: str, slab: HostSlab) -> bool:
        """Admit a slab, discarding oldest-stamp entries until it fits.
        Returns False (counted as a discard: the bytes are dropped) when
        the slab alone exceeds the whole budget."""
        if h in self._entries:
            self.used_bytes -= self._entries.pop(h).nbytes
        if slab.nbytes > self.max_bytes:
            self.discards += 1
            return False
        while self.used_bytes + slab.nbytes > self.max_bytes:
            victim = min(self._entries.items(),
                         key=lambda kv: kv[1].stamp)[0]
            self.used_bytes -= self._entries.pop(victim).nbytes
            self.discards += 1
        self._entries[h] = slab
        self.used_bytes += slab.nbytes
        self.spills += 1
        return True

    def pop(self, h: str) -> Optional[HostSlab]:
        """Remove and return the slab for ``h`` (None on miss). The caller
        is now its only owner: on a failed restore it either re-``put``s
        the slab or accepts the discard."""
        slab = self._entries.pop(h, None)
        if slab is not None:
            self.used_bytes -= slab.nbytes
            slab.hits += 1
            self.restores += 1
        return slab

    def put_back(self, h: str, slab: HostSlab) -> None:
        """Undo a ``pop`` whose restore could not proceed (reservation dry,
        admission rollback) without counting a second spill or a phantom
        restore."""
        if self.put(h, slab):
            self.spills -= 1
        self.restores -= 1

    def clear(self) -> None:
        self._entries.clear()
        self.used_bytes = 0

    def stats(self) -> dict:
        return {
            "entries": len(self._entries),
            "budget_bytes": self.max_bytes,
            "used_bytes": self.used_bytes,
            "occupancy": self.occupancy,
            "spills": self.spills,
            "restores": self.restores,
            "discards": self.discards,
        }


class PagePool:
    """Free list over ``num_pages`` physical KV pages (page 0 reserved as
    the null page). ``alloc``/``free`` are O(n) list ops on the host path
    that already does per-request Python bookkeeping."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (page 0 is the reserved null "
                f"page), got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        # LIFO free list: recently-freed pages are re-used first, which
        # keeps the working set of physical pages small and cache-warm.
        # A parallel set keeps the double-free guard O(1) per page
        # (retiring a long request frees hundreds of pages on the engine
        # thread between decode chunks)
        self._free: List[int] = list(range(1, self.num_pages))
        self._free_set = set(self._free)
        self.peak_used = 0

    @property
    def usable(self) -> int:
        """Allocatable pages (total minus the null page)."""
        return self.num_pages - 1

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used(self) -> int:
        return self.usable - len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: need {n}, free {len(self._free)} "
                "(caller must check free_count / evict first)")
        pages = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(pages)
        self.peak_used = max(self.peak_used, self.used)
        return pages

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if not 1 <= p < self.num_pages:
                raise ValueError(f"free of invalid page id {p}")
            if p in self._free_set:
                raise ValueError(f"double free of page {p}")
        self._free.extend(pages)
        self._free_set.update(pages)


class PrefixEntry:
    """One cached shared prefix: its physical pages, how many live slots
    reference it, and an LRU stamp for eviction."""

    __slots__ = ("pages", "refcount", "last_used", "length", "hits")

    def __init__(self, pages: List[int], length: int, stamp: int):
        self.pages = list(pages)
        self.refcount = 1          # the registering slot holds the first ref
        self.last_used = stamp
        self.length = int(length)  # aligned token length the pages hold
        self.hits = 0


class PrefixCache:
    """Ref-counted, LRU-evicted registry of shared (system-prompt)
    prefixes. Entries with ``refcount == 0`` stay cached — that IS the
    cache — and are evicted oldest-first only when the page pool's free
    list runs dry."""

    def __init__(self):
        self._entries: Dict[str, PrefixEntry] = {}
        self._clock = itertools.count(1)
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def cached_pages(self) -> int:
        # list() snapshot: health() probes read this from client threads
        # while the engine thread registers/evicts entries
        return sum(len(e.pages) for e in list(self._entries.values()))

    def lookup(self, h: str) -> Optional[PrefixEntry]:
        return self._entries.get(h)

    def register(self, h: str, pages: List[int], length: int) -> PrefixEntry:
        if h in self._entries:
            raise ValueError(f"prefix {h} already registered")
        entry = PrefixEntry(pages, length, next(self._clock))
        self._entries[h] = entry
        return entry

    def ref(self, h: str) -> PrefixEntry:
        entry = self._entries[h]
        entry.refcount += 1
        entry.last_used = next(self._clock)
        entry.hits += 1
        self.hits += 1
        return entry

    def unref(self, h: str) -> None:
        entry = self._entries.get(h)
        if entry is None:
            return                # already evicted under us: nothing to do
        entry.refcount -= 1
        if entry.refcount < 0:
            raise ValueError(f"prefix {h} refcount underflow")

    def evict_until(self, pool: PagePool, need_free: int,
                    exclude: Optional[str] = None,
                    spill: Optional[Callable[[str, PrefixEntry], bool]]
                    = None) -> int:
        """Evict refcount-0 entries oldest-first until ``pool`` has at
        least ``need_free`` free pages (or no evictable entry remains).
        Returns the number of entries removed from the device tier.
        ``exclude`` protects one hash — the entry a prefix HIT is about to
        reference must not be evicted to make room for that very request's
        private pages.

        ``spill``, when given, is called with ``(hash, entry)`` BEFORE the
        entry's pages return to the pool (the page content is still live on
        device). A True return means the entry moved to a lower tier — the
        pages are still freed here, but ``evictions`` (the true-discard
        counter) is not bumped; the host tier's own discard is the real
        eviction."""
        evicted = 0
        while pool.free_count < need_free:
            victims = [(e.last_used, h) for h, e in self._entries.items()
                       if e.refcount == 0 and h != exclude]
            if not victims:
                break
            _, h = min(victims)
            entry = self._entries.pop(h)
            spilled = bool(spill(h, entry)) if spill is not None else False
            pool.free(entry.pages)
            evicted += 1
            if not spilled:
                self.evictions += 1
        return evicted

    def clear(self, pool: PagePool) -> None:
        """Drop every entry regardless of refcount (engine teardown)."""
        for e in self._entries.values():
            pool.free(e.pages)
        self._entries.clear()
