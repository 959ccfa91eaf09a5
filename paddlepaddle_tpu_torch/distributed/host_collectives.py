"""Eager host-side collectives over the TCP store (counterpart of
``paddlepaddle_tpu/distributed/host_collectives.py``): small numpy values
(flags, metrics, rendezvous facts) moved between ranks through
:mod:`.store`, the same protocol as the reference. Model tensors go through
``torch.distributed`` (:mod:`.collective`), not here.

Every process must issue the same collectives in the same order (the
standard process-group contract); a per-group sequence number keys each
op's slots in the store. Each collective is a comm task
(:mod:`.comm_task`) named by its op and sequence number.
"""

from __future__ import annotations

import functools
import io
import os
import pickle
from typing import List, Optional

import numpy as np

from .comm_task import comm_task


def _dumps(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr), allow_pickle=False)
    return buf.getvalue()


def _loads(raw: bytes) -> np.ndarray:
    return np.load(io.BytesIO(raw), allow_pickle=False)


_REDUCERS = {
    "sum": lambda xs: np.sum(xs, axis=0),
    "avg": lambda xs: np.mean(xs, axis=0),
    "max": lambda xs: np.max(xs, axis=0),
    "min": lambda xs: np.min(xs, axis=0),
    "prod": lambda xs: np.prod(xs, axis=0),
}


_SLOT_WINDOW = 64


def _task(fn):
    """Run a collective of :class:`HostProcessGroup` as a comm task."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with comm_task(f"host_collectives.{fn.__name__}#{self._seq + 1}",
                       group=f"host/{self.gid}"):
            return fn(self, *args, **kwargs)

    return wrapper


class HostProcessGroup:
    """Eager collectives for one process per host, keyed through the store.

    Keys carry the FULL group sequence number — two different collectives can
    never alias, so a fast rank can never read a stale payload (the previous
    ``seq % window`` addressing broke exactly when a writer lapped a slot
    whose old key still satisfied the existence-based ``wait``). Memory on
    the master stays bounded by a windowed garbage-collection protocol:

    * every participant ACKs op ``seq`` once it is done with its payloads
      (readers after reading; one-sided writers such as a broadcast source
      right after posting);
    * the LAST acker — the rank whose atomic ``add`` reaches world_size —
      deletes the op's data keys, then marks ``done/{seq}``;
    * before starting op ``seq``, every rank gates on ``done/{seq - window}``,
      so at most ``window`` ops are ever outstanding, even for one-sided
      writers (a broadcast source can no longer run unboundedly ahead);
    * the last acker of op ``seq`` also deletes ``done/{seq - window}`` —
      by then every rank has passed that gate, so nobody waits on it again.

    Point-to-point send/recv is one-sided (only the pair participates), so
    p2p keys carry the full per-pair sequence and the receiver deletes each
    payload after reading it.
    """

    def __init__(self, store, rank: int, world_size: int, gid: int = 0):
        self.store = store
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.gid = gid
        # an elastic world's ops never alias an earlier world's on the same
        # store (the launcher sets PADDLE_WORLD_VERSION, 0 without one)
        version = os.environ.get("PADDLE_WORLD_VERSION", "0") or "0"
        world = "" if version == "0" else f"w{version}/"
        self._prefix, self._p2p_prefix = f"hcoll/{world}", f"hp2p/{world}"
        self._seq = 0
        self._p2p: dict = {}          # (src, dst) -> per-pair sequence
        self._posted: dict = {}       # seq -> data tags THIS rank wrote

    def _key(self, seq: int, tag: str) -> str:
        return f"{self._prefix}{self.gid}/{seq}/{tag}"

    def rejoin(self, op_index: int) -> None:
        """Elastic re-admission: a restarted worker resuming from a
        checkpoint fast-forwards its collective stream to ``op_index``
        (the number of group ops its peers have already completed for the
        checkpointed state — ops-per-step x steps under a deterministic
        schedule). Without this, a fresh incarnation's sequence restarts
        at 0 and its collectives ALIAS live ranks' older slots, silently
        reading stale payloads (reference elastic contract:
        fleet/elastic/manager.py re-admission)."""
        if op_index < self._seq:
            raise ValueError(
                f"rejoin(op_index={op_index}) would move the sequence "
                f"backwards (already at {self._seq})")
        self._seq = int(op_index)
        self._posted.clear()

    def _next(self) -> int:
        """Advance the group sequence, gating on the retirement of the op one
        window back so outstanding state on the master stays O(window).

        Data-key GC rides the gate: ``done/{seq-window}`` existing proves
        every rank acked that op (all reads finished), so each rank retires
        the keys IT posted for it here — O(own posts) deletes spread across
        ranks, off the collective's critical path, instead of one last-acker
        paying O(world) serial round-trips inside the op."""
        self._seq += 1
        if self._seq > _SLOT_WINDOW:
            old = self._seq - _SLOT_WINDOW
            self.store.wait([self._key(old, "done")])
            for tag in self._posted.pop(old, ()):
                self.store.delete_key(self._key(old, tag))
        return self._seq

    def _finish(self, seq: int, posted_tags: List[str]) -> None:
        """ACK op ``seq``, recording the tags this rank posted for deferred
        GC; the last acker retires the op's control keys."""
        if posted_tags:
            self._posted[seq] = posted_tags
        n = self.store.add(self._key(seq, "ack"), 1)
        if n >= self.world_size:
            self.store.delete_key(self._key(seq, "ack"))
            self.store.set(self._key(seq, "done"), b"1")
            if seq > _SLOT_WINDOW:
                self.store.delete_key(self._key(seq - _SLOT_WINDOW, "done"))

    # -- primitives ---------------------------------------------------------
    @_task
    def all_gather(self, arr: np.ndarray) -> List[np.ndarray]:
        seq = self._next()
        self.store.set(self._key(seq, f"r{self.rank}"), _dumps(arr))
        keys = [self._key(seq, f"r{r}") for r in range(self.world_size)]
        self.store.wait(keys)
        out = [_loads(self.store.get(k)) for k in keys]
        self._finish(seq, [f"r{self.rank}"])
        return out

    @_task
    def all_reduce(self, arr: np.ndarray, op: str = "sum") -> np.ndarray:
        parts = self.all_gather(arr)
        return _REDUCERS[op](np.stack(parts))

    @_task
    def broadcast(self, arr: np.ndarray, src: int = 0) -> np.ndarray:
        seq = self._next()
        key = self._key(seq, f"src{src}")
        if self.rank == src:
            self.store.set(key, _dumps(arr))
            self._finish(seq, [f"src{src}"])
            return np.asarray(arr)
        self.store.wait([key])
        out = _loads(self.store.get(key))
        self._finish(seq, [])
        return out

    @_task
    def scatter(self, parts: Optional[List[np.ndarray]], src: int = 0) -> np.ndarray:
        seq = self._next()
        if self.rank == src:
            assert parts is not None and len(parts) == self.world_size
            for r, p in enumerate(parts):
                self.store.set(self._key(seq, f"d{r}"), _dumps(p))
        key = self._key(seq, f"d{self.rank}")
        self.store.wait([key])
        out = _loads(self.store.get(key))
        self._finish(seq, [f"d{r}" for r in range(self.world_size)]
                     if self.rank == src else [])
        return out

    @_task
    def all_to_all(self, parts: List[np.ndarray]) -> List[np.ndarray]:
        seq = self._next()
        assert len(parts) == self.world_size
        for r, p in enumerate(parts):
            self.store.set(self._key(seq, f"{self.rank}to{r}"), _dumps(p))
        keys = [self._key(seq, f"{r}to{self.rank}")
                for r in range(self.world_size)]
        self.store.wait(keys)
        out = [_loads(self.store.get(k)) for k in keys]
        self._finish(seq, [f"{self.rank}to{r}" for r in range(self.world_size)])
        return out

    def _p2p_key(self, src: int, dst: int) -> str:
        # per-pair counter: p2p must NOT touch the group sequence (only the
        # pair participates; bumping _seq would desync the other ranks)
        n = self._p2p.get((src, dst), 0) + 1
        self._p2p[(src, dst)] = n
        return f"{self._p2p_prefix}{self.gid}/{src}to{dst}/{n}"

    def send(self, arr: np.ndarray, dst: int) -> None:
        self.store.set(self._p2p_key(self.rank, dst), _dumps(arr))

    @_task
    def recv(self, src: int) -> np.ndarray:
        key = self._p2p_key(src, self.rank)
        self.store.wait([key])
        out = _loads(self.store.get(key))
        self.store.delete_key(key)    # retire the payload: bound master memory
        return out

    @_task
    def gather_object(self, obj) -> List[object]:
        seq = self._next()
        self.store.set(self._key(seq, f"o{self.rank}"), pickle.dumps(obj))
        keys = [self._key(seq, f"o{r}") for r in range(self.world_size)]
        self.store.wait(keys)
        out = [pickle.loads(self.store.get(k)) for k in keys]
        self._finish(seq, [f"o{self.rank}"])
        return out

    @_task
    def barrier(self) -> None:
        # the ack/done machinery IS a barrier: done/{seq} appears only after
        # every rank has acked, and the window gate retires it later
        seq = self._next()
        self._finish(seq, [])
        self.store.wait([self._key(seq, "done")])


_host_group: Optional[HostProcessGroup] = None
_probed = False


def get_host_group() -> Optional[HostProcessGroup]:
    """The world host-group, or None when this job is single-process (the
    eager wrappers then use single-controller semantics)."""
    global _host_group, _probed
    if _probed:
        return _host_group
    _probed = True
    world = int(os.environ.get("PADDLE_TRAINERS_NUM")
                or os.environ.get("WORLD_SIZE") or 1)
    if world > 1:
        rank = int(os.environ.get("PADDLE_TRAINER_ID")
                   or os.environ.get("RANK") or 0)
        # the global store factory reads only the PADDLE_* names — pin them
        # so torch-style RANK/WORLD_SIZE jobs configure the SAME store
        # (rank 0 hosting, everyone else connecting)
        os.environ.setdefault("PADDLE_TRAINER_ID", str(rank))
        os.environ.setdefault("PADDLE_TRAINERS_NUM", str(world))
        from .store import create_or_get_global_tcp_store

        _host_group = HostProcessGroup(create_or_get_global_tcp_store(),
                                       rank, world)
    return _host_group
