"""Host-side KV page-pool bookkeeping for the paged decode engine.

The port's own copy of the jax-free host half of
``paddlepaddle_tpu/inference/kv_pool.py``: ``pages_needed``, ``prefix_hash``,
``PagePool`` (:245), ``PrefixEntry`` and ``PrefixCache`` (:317), unchanged.
The device half is the engine's ``[slots, max_len/page_size]`` int32 page
table, which the paged-attention kernel walks itself. ``HostPrefixTier`` and
the ``KVS1`` slab format arrive with int8 KV (ROADMAP A4.4).

The one engine thread owns every mutation (admission, retirement, eviction).

Page 0 is the NULL page: every unmapped page-table entry points at it, so a
scatter past a slot's reservation lands in one sacrificial page and a read
through an unmapped entry sees finite values that the length mask hides. It
is never allocated.
"""

from __future__ import annotations

import hashlib
import itertools
from typing import Callable, Dict, List, Optional

__all__ = ["PagePool", "PrefixCache", "PrefixEntry", "pages_needed",
           "prefix_hash"]


def pages_needed(tokens: int, page_size: int) -> int:
    """Pages covering ``tokens`` KV positions (ceil division)."""
    return -(-int(tokens) // int(page_size))


def prefix_hash(prompt_ids, aligned: int) -> str:
    """Content hash of the page-aligned shared prefix. Keyed by the token
    bytes AND the aligned length, so a prefix cached at 128 tokens never
    answers a lookup for its own 64-token head."""
    import numpy as np

    ids = np.ascontiguousarray(np.asarray(prompt_ids, np.int32).reshape(-1))
    return f"{aligned}:" + hashlib.sha1(ids[:aligned].tobytes()).hexdigest()


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
