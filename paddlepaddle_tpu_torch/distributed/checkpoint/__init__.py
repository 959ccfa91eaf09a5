"""Distributed checkpoint: sharded save and reshard-on-load (counterpart of
``paddlepaddle_tpu/distributed/checkpoint/__init__.py``, format v3).

The files are the contract, and they are the reference's byte for byte:

* one ``.npy`` per unique shard (replicas written once: a rank writes a
  block only where its coordinate on every axis the value is replicated
  over is 0, the reference's ``replica_id == 0`` rule) and one
  ``metadata.json`` holding ``tensors.{shape, dtype, sharding, shards[{file,
  box, crc32}]}``; the file names, their ``__n`` de-collision and the
  ``.p{rank}`` / ``.s{i}`` tags follow the reference (:277-294);
* a one-rank save stages into a hidden sibling directory and commits by
  rename (a kill mid-save leaves the old checkpoint or none, never a torn
  one); a multi-rank save writes in place, each rank putting out a
  ``metadata.json.e{epoch}.rank{r}`` record last, which the coordinator
  merges into ``metadata.json`` (the commit point);
* async saves on one path are chained, ``wait_all_saves`` surfaces every
  failure, and an atexit hook flushes what is pending.

What a value is, in the port:

* a plain ``torch.Tensor``: whole and replicated, so only rank 0 of a
  multi-rank save writes it;
* a ``torch.distributed.tensor.DTensor`` (:func:`..sharding_api.
  shard_tensor`): its local block, whose box comes from the placements
  and this rank's mesh coordinate; the ``sharding`` record carries the
  mesh's shape and axis names and the spec;
* :class:`LocalShards`, as in the reference (blocks given explicitly);
* anything else (numpy arrays, Python numbers): written by every rank,
  as the reference writes a host value.

The state of a :class:`~..parallel.sharded.ShardedTrainStep`
(``step.params``, ``step.opt_state``, ``step.state_dict()``) is saved and
loaded through the step: every rank of its plan writes or reads its own
blocks (the worker ranks of a single-process step too), and nothing is
gathered whole.

Load is reshard-on-load: each target reads only the box it holds (a
``DTensor`` its local block, a step's rank its shards) from whichever
files overlap it. A ``torch.Tensor`` target is filled in place (``copy_``
under ``no_grad``, on its own device and in its own dtype), so
``load_state_dict(model.state_dict(), path)`` changes the model; a shape
mismatch raises. Any other target is replaced by a writable numpy copy.

Two things the reference's design gets for free and the port must do:

* **The snapshot.** JAX arrays are immutable, so the reference's async
  save reads them later. The port's optimizers update in place: an async
  save copies every value before it returns (:class:`_Snapshot`). A CUDA
  tensor goes to one page-locked host buffer, its copy enqueued on its
  device's current stream, so an update enqueued after the call runs
  after the copy; the card holds no second copy of the state. The host
  holds one, as the reference's ``copy_to_host_async`` does, and keeps
  the locked buffer for the next async save, since locking costs far
  more than the copy (:func:`release_snapshot_buffers` drops it).
* **bf16.** numpy has no bfloat16. A bf16 tensor is written as its raw
  2-byte words with the header descr ``'<V2'`` and ``"dtype":
  "bfloat16"`` in the metadata, the bytes the reference's ``np.save`` of
  an ``ml_dtypes`` array writes; such a file is read back as
  ``torch.bfloat16`` (the reference's own load cannot read it: ROADMAP,
  fifth divergence). A bf16 record loaded into a non-tensor target gives a
  ``torch.bfloat16`` tensor.

Formats v1 (one global-value file per tensor) and v2 (no CRCs) are still
read. CRCs are verified per file before its bytes are used
(``FLAGS_ckpt_verify_crc`` / ``PADDLE_CKPT_VERIFY``), a load's files
several at a time.
"""

from __future__ import annotations

import atexit
import json
import os
import re
import shutil
import sys
import threading
import time
import warnings
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ...core import flags as _flags
from ...resilience.chaos import chaos_point
from ...resilience.integrity import (  # noqa: F401  (file_crc32: the
    CRC_WORKERS, CheckpointCorruptionError,  # reference's path)
    _count_corruption, _crcs, file_crc32)
from ...resilience.retry import RetryPolicy, call_with_retry

__all__ = [
    "save_state_dict", "load_state_dict", "wait_all_saves", "LocalShards",
    "CheckpointSaveError", "get_checkpoint_metadata",
    "release_snapshot_buffers",
]

_META_NAME = "metadata.json"
_FORMAT = "paddlepaddle_tpu.dist_ckpt.v3"
_pending_saves = []
_path_last_save: Dict[str, threading.Thread] = {}  # write-order chain per path
# RLock: a preemption handler may save while the interrupted frame holds it
_path_last_lock = threading.RLock()

# shared-filesystem blips (ESTALE, EIO, injected faults) are transient:
# three quick attempts before surfacing (reference :76)
_FS_RETRY = RetryPolicy(max_attempts=3, base_delay=0.05, max_delay=0.5)

# the pinned host buffers a CUDA tensor crosses to or from the disk in
_STAGE_BYTES = 32 << 20
# the pieces a host array is checksummed and written in
_WRITE_PIECE = 8 << 20


class CheckpointSaveError(RuntimeError):
    """One or more async writer threads failed; ``errors`` holds all of
    them (wait_all_saves surfaces every failure, not just the first)."""

    def __init__(self, message: str, errors):
        super().__init__(message)
        self.errors = list(errors)


@dataclass
class LocalShards:
    """One rank's view of a globally-sharded tensor: the blocks whose bytes
    live here, each ``(box [[lo, hi], ...], array or tensor)``. A
    multi-rank save writes these; the coordinator merges every rank's
    records into one metadata.json."""

    global_shape: Tuple[int, ...]
    dtype: str
    shards: List = field(default_factory=list)
    sharding: Optional[dict] = None


def _sanitize(key: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", key)


# -- dtypes and host arrays ---------------------------------------------------

_TORCH_NAMES = {torch.float32: "float32", torch.float64: "float64",
                torch.float16: "float16", torch.bfloat16: "bfloat16",
                torch.int8: "int8", torch.int16: "int16",
                torch.int32: "int32", torch.int64: "int64",
                torch.uint8: "uint8", torch.bool: "bool",
                torch.complex64: "complex64", torch.complex128: "complex128"}
_BF16_DESCR = "<V2"      # what np.save writes for an ml_dtypes bfloat16 array


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        if dtype not in _TORCH_NAMES:
            raise TypeError(f"no checkpoint dtype for {dtype}")
        return _TORCH_NAMES[dtype]
    return str(dtype)


def _descr(dtype_name: str, dtype) -> str:
    """The ``.npy`` header descr of a record's dtype (``dtype`` a numpy or
    torch dtype; a bf16 record gets the reference's ``'<V2'``)."""
    if dtype_name == "bfloat16":
        return _BF16_DESCR
    if isinstance(dtype, torch.dtype):
        dtype = torch.empty(0, dtype=dtype).numpy().dtype
    return np.lib.format.dtype_to_descr(np.dtype(dtype))


def _host_view(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's bytes as a numpy array (bf16 as 2-byte words)."""
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _contig(a) -> np.ndarray:
    """``a`` C-contiguous, its shape kept (0-d included)."""
    return np.asarray(a, order="C")


def _as_torch(piece: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A piece read from a shard file as a CPU tensor of the record's
    dtype (a bf16 record's ``|V2`` words through an int16 view)."""
    arr = _contig(piece)
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr)


# -- what a value contributes ------------------------------------------------

def _is_dtensor(v) -> bool:
    # a DTensor exists only once its module is imported; importing it here
    # would cost a plain save or load over a second
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(v, mod.DTensor)


def _dtensor_box(t) -> Tuple[List[List[int]], bool, dict]:
    """``(box, writer, sharding record)`` of a DTensor's local block: the
    box from its placements (mesh dims in order, each ``Shard(d)`` cutting
    the current extent of ``d`` as ``torch.chunk`` does), ``writer`` True
    where this rank's coordinate is 0 on every axis not sharding it."""
    from torch.distributed.tensor import Partial, Shard

    mesh = t.device_mesh
    coord = mesh.get_coordinate()
    names = list(mesh.mesh_dim_names or
                 [f"d{i}" for i in range(mesh.ndim)])
    box = [[0, int(d)] for d in t.shape]
    spec: List[object] = [None] * t.dim()
    writer = True
    for axis, p in enumerate(t.placements):
        n, c = mesh.size(axis), coord[axis]
        if isinstance(p, Shard):
            lo, hi = box[p.dim]
            chunk = -(-(hi - lo) // n)
            box[p.dim] = [min(lo + c * chunk, hi), min(lo + (c + 1) * chunk,
                                                       hi)]
            e = spec[p.dim]
            spec[p.dim] = names[axis] if e is None else (
                (e if isinstance(e, list) else [e]) + [names[axis]])
        elif isinstance(p, Partial):
            raise ValueError(
                f"a Partial placement over mesh axis {names[axis]!r} holds "
                "no value of its own: reshard to Replicate before saving")
        elif c != 0:
            writer = False
    record = {"mesh_shape": list(mesh.shape), "mesh_axes": names,
              "spec": spec}
    return box, writer, record


def _contribution(val, pid: int):
    """``(shape, dtype name, sharding record, [(box, data)])`` of one
    value for rank ``pid``."""
    if isinstance(val, LocalShards):
        return (tuple(val.global_shape), str(val.dtype), val.sharding,
                [(list(map(list, b)), d) for b, d in val.shards])
    if isinstance(val, torch.Tensor):
        shape = tuple(val.shape)
        if _is_dtensor(val):
            box, writer, record = _dtensor_box(val)
            return (shape, _dtype_name(val.dtype), record,
                    [(box, val.to_local())] if writer else [])
        full = [[0, int(d)] for d in shape]
        return (shape, _dtype_name(val.dtype), None,
                [(full, val)] if pid == 0 else [])
    arr = np.asarray(val)
    if arr.dtype == object:
        raise TypeError(f"cannot checkpoint a {type(val).__name__}: values "
                        "are tensors, arrays or numbers")
    return (tuple(arr.shape), str(arr.dtype), None,
            [([[0, int(d)] for d in arr.shape], val)])


_ALIGN = 64                # bytes between two tensors in a snapshot buffer

# the page-locked host buffer that no save is using (one at most), kept
# for the next async save: locking is the slow part (10.4 GB took 3-15 s
# on an H100 host, the copy into it from the card 0.2-0.5 s; PERF.md)
_free_locked: List[torch.Tensor] = []
_free_lock = threading.Lock()


def release_snapshot_buffers() -> None:
    """Unlock and drop the host buffers kept for later async saves (the
    next async save of CUDA tensors locks a new one)."""
    with _free_lock:
        while _free_locked:
            torch.cuda.cudart().cudaHostUnregister(
                _free_locked.pop().data_ptr())


def _locked_buffer(nbytes: int) -> Tuple[torch.Tensor, bool]:
    """A host buffer of at least ``nbytes``, page-locked where CUDA allows
    it (``(buffer, locked)``): the kept one if it fits, else a new one
    (a kept one too small is unlocked and dropped)."""
    with _free_lock:
        if _free_locked and _free_locked[0].numel() >= nbytes:
            return _free_locked.pop(), True
    release_snapshot_buffers()
    buf = torch.empty(nbytes, dtype=torch.uint8)
    err = int(torch.cuda.cudart().cudaHostRegister(buf.data_ptr(), nbytes,
                                                   0))
    if err:
        # pageable: each copy returns once it is done (still before any
        # later update), only slower
        warnings.warn(f"async checkpoint: cudaHostRegister of {nbytes} "
                      f"bytes failed (cudaError {err}); copying through "
                      "pageable memory")
    return buf, err == 0


class _Snapshot:
    """An async save's copy of its values, taken before the save returns.
    A CPU tensor or an array is copied. The CUDA tensors are copied into
    one page-locked host buffer (:func:`_locked_buffer`), each on its
    device's current stream: an in-place update enqueued after the save
    runs after its copy, and nothing more is held on the card. The writer
    waits for the copies (:meth:`wait`) and, when it is done, gives the
    buffer back for the next save (:meth:`release`)."""

    def __init__(self, datas):
        cuda = [i for i, d in enumerate(datas)
                if isinstance(d, torch.Tensor) and d.is_cuda]
        sizes = [-(-datas[i].numel() * datas[i].element_size() // _ALIGN)
                 * _ALIGN for i in cuda]
        self.buf, self.locked, self.events = None, False, []
        if sum(sizes):
            self.buf, self.locked = _locked_buffer(sum(sizes))
        self.data = list(datas)
        off, devices = 0, []
        try:
            for i, n in zip(cuda, sizes):
                d = datas[i]
                host = self.buf[off:off + d.numel() * d.element_size()].view(
                    d.dtype).view(d.shape)
                with torch.cuda.device(d.device):
                    host.copy_(d.detach(), non_blocking=True)
                self.data[i] = host
                if d.device not in devices:
                    devices.append(d.device)
                off += n
        finally:
            for dev in devices:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))
                self.events.append(ev)
            if off < sum(sizes):         # a copy raised: give back, re-raise
                self.release()
        on_card = set(cuda)
        for i, d in enumerate(datas):
            if i not in on_card:
                self.data[i] = (d.detach().clone()
                                if isinstance(d, torch.Tensor)
                                else np.array(d, copy=True))

    def wait(self) -> None:
        for ev in self.events:
            ev.synchronize()

    def release(self) -> None:
        """Wait for the copies, then keep a locked buffer for the next
        save (a pageable one is dropped)."""
        self.wait()
        if self.locked:
            with _free_lock:          # keep one: the larger
                _free_locked.append(self.buf)
                _free_locked.sort(key=lambda b: b.numel())
                if len(_free_locked) > 1:
                    torch.cuda.cudart().cudaHostUnregister(
                        _free_locked.pop(0).data_ptr())
        self.buf = self.data = None
        self.locked = False


# -- writing -----------------------------------------------------------------

class _Pinned:
    """Two reusable pinned host buffers and a copy stream (one set per
    thread that moves bytes between a card and the disk): while one
    buffer's copy runs on the stream, the host fills or drains the
    other."""

    def __init__(self, device: torch.device):
        self.bufs = [torch.empty(_STAGE_BYTES, dtype=torch.uint8,
                                 pin_memory=True) for _ in range(2)]
        self.done = [None, None]        # the event of each buffer's copy
        self.stream = torch.cuda.Stream(device)

    def take(self, i: int) -> torch.Tensor:
        """Buffer ``i % 2``, once its last copy has finished."""
        i %= 2
        if self.done[i] is not None:
            self.done[i].synchronize()
            self.done[i] = None
        return self.bufs[i]

    def copied(self, i: int) -> None:
        """Mark the copy just enqueued on the stream for buffer ``i % 2``."""
        ev = torch.cuda.Event()
        ev.record(self.stream)
        self.done[i % 2] = ev


def _stage(stage: dict, device: torch.device) -> _Pinned:
    pin = stage.get(device)
    if pin is None:
        pin = stage[device] = _Pinned(device)
    return pin


def _npy_header(descr: str, shape) -> bytes:
    import io

    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(
        buf, {"descr": descr, "fortran_order": False,
              "shape": tuple(int(d) for d in shape)})
    return buf.getvalue()


def _write_npy(fpath: str, data, dtype_name: str, stage: dict) -> int:
    """Write ``data`` (a tensor on any device, or an array) as the ``.npy``
    the reference's ``np.save`` writes; return the file's CRC32, taken
    over the bytes as they are written."""
    if isinstance(data, torch.Tensor) and data.is_cuda:
        t = data.detach().contiguous()
        header = _npy_header(_descr(dtype_name, t.dtype), t.shape)
        flat = t.reshape(-1).view(torch.uint8)
        pin = _stage(stage, t.device)
        pin.stream.wait_stream(torch.cuda.current_stream(t.device))
        chunks = [(lo, min(_STAGE_BYTES, flat.numel() - lo))
                  for lo in range(0, flat.numel(), _STAGE_BYTES)]

        def fetch(i):                    # enqueue chunk i's copy
            lo, n = chunks[i]
            buf = pin.take(i)
            with torch.cuda.stream(pin.stream):
                buf[:n].copy_(flat[lo:lo + n], non_blocking=True)
            pin.copied(i)

        crc = zlib.crc32(header)
        with open(fpath, "wb") as f:
            f.write(header)
            if chunks:
                fetch(0)
            for i, (_lo, n) in enumerate(chunks):
                if i + 1 < len(chunks):
                    fetch(i + 1)         # the next chunk crosses meanwhile
                mv = memoryview(pin.take(i)[:n].numpy())
                crc = zlib.crc32(mv, crc)
                f.write(mv)
        return crc & 0xFFFFFFFF
    arr = _contig(_host_view(data) if isinstance(data, torch.Tensor)
                  else data)
    header = _npy_header(_descr(dtype_name, arr.dtype), arr.shape)
    mv = memoryview(arr.reshape(-1).view(np.uint8)) if arr.size else b""
    crc = zlib.crc32(header)
    with open(fpath, "wb") as f:
        f.write(header)
        # each piece written right after its CRC read it, from the cache
        for lo in range(0, len(mv), _WRITE_PIECE):
            piece = mv[lo:lo + _WRITE_PIECE]
            crc = zlib.crc32(piece, crc)
            f.write(piece)
    return crc & 0xFFFFFFFF


_save_epochs: Dict[Tuple[str, int], int] = {}  # (path, rank) -> saves issued


def _rank_meta_name(rank: int, epoch: int = 0) -> str:
    # epoch-namespaced: two back-to-back saves to one path never mix rank
    # records (save is collective, so every rank's counter agrees)
    return f"{_META_NAME}.e{epoch}.rank{rank}"


def _merge_rank_metadata(path: str, world: int, timeout: float,
                         epoch: int = 0) -> None:
    """Coordinator: wait for every rank's record, merge the shard lists
    (a box several ranks recorded is kept once, the lowest rank's) and
    commit ``metadata.json`` atomically (reference :164-218)."""
    deadline = time.monotonic() + timeout
    ranks = {}
    while len(ranks) < world:
        for r in range(world):
            if r in ranks:
                continue
            fp = os.path.join(path, _rank_meta_name(r, epoch))
            if os.path.exists(fp):
                try:
                    with open(fp) as f:
                        ranks[r] = json.load(f)
                except (json.JSONDecodeError, OSError):
                    pass  # mid-write; retry
        if len(ranks) < world:
            if time.monotonic() > deadline:
                missing = [r for r in range(world) if r not in ranks]
                raise TimeoutError(
                    f"multi-host checkpoint merge: ranks {missing} never "
                    f"wrote {path}/{_META_NAME}.e{epoch}.rank*")
            time.sleep(0.05)
    for r in range(world):
        try:
            os.remove(os.path.join(path, _rank_meta_name(r, epoch)))
        except OSError:
            pass
    meta = {"tensors": {}, "format": _FORMAT, "world_size": world}
    for r in sorted(ranks):
        for key, rec in ranks[r]["tensors"].items():
            tgt = meta["tensors"].setdefault(key, {
                "shape": rec["shape"], "dtype": rec["dtype"],
                "sharding": rec.get("sharding"), "shards": []})
            if tuple(tgt["shape"]) != tuple(rec["shape"]):
                raise ValueError(
                    f"{key}: rank {r} reports shape {rec['shape']} vs "
                    f"{tgt['shape']}")
            have = {tuple(map(tuple, s["box"])) for s in tgt["shards"]}
            for s in rec["shards"]:
                if tuple(map(tuple, s["box"])) not in have:
                    tgt["shards"].append(s)
    tmp = os.path.join(path, _META_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1)
    os.replace(tmp, os.path.join(path, _META_NAME))


def _commit_staging(staging: str, path: str) -> None:
    """Atomic commit: the staging dir takes the final name in one rename;
    an overwrite swaps the old dir aside first (a crash between the renames
    leaves it recoverable under ``*.__old__*``)."""
    if os.path.isdir(path):
        trash = f"{path}.__old__.{os.getpid()}"
        if os.path.exists(trash):
            shutil.rmtree(trash)
        os.rename(path, trash)
        os.rename(staging, path)
        shutil.rmtree(trash, ignore_errors=True)
    else:
        os.rename(staging, path)


def save_state_dict(state_dict: Dict[str, object], path: str,
                    process_group=None, coordinator_rank: int = 0,
                    unique_name: bool = True, async_save: bool = False,
                    process_index: Optional[int] = None,
                    process_count: Optional[int] = None,
                    merge_timeout: float = 300.0) -> None:
    """Write per-shard files and the metadata (format v3, module doc).

    A multi-rank save (``process_count`` > 1, by default the job's world
    size) writes this rank's blocks and a rank record; the coordinator
    merges the records once every rank's has appeared on the shared path.
    ``async_save`` snapshots every value, returns, and writes in a thread
    (:func:`wait_all_saves` joins). A :class:`~..parallel.sharded.
    ShardedTrainStep`'s state is saved by every rank of its plan."""
    step = getattr(state_dict, "sharded_step", None)
    if step is not None:
        step._ckpt_save(path, state_dict.kind, async_save=async_save,
                        coordinator_rank=coordinator_rank,
                        merge_timeout=merge_timeout)
        return
    from ..env import get_rank, get_world_size

    pid = get_rank() if process_index is None else process_index
    world = get_world_size() if process_count is None else process_count
    _save(state_dict, path, pid, world, coordinator_rank, async_save,
          merge_timeout)


def _save(state_dict, path, pid, world, coordinator_rank, async_save,
          merge_timeout) -> None:
    epoch = _save_epochs.get((path, pid), 0)
    _save_epochs[(path, pid)] = epoch + 1
    meta = {"tensors": {}, "format": _FORMAT}
    items = []  # (fname, data, dtype name)
    rec_by_file: Dict[str, dict] = {}
    used_names = set()
    for key, val in state_dict.items():
        shape, dtype, sharding, shards = _contribution(val, pid)

        def _files(base, n=len(shards)):
            tag = f".p{pid}" if world > 1 else ""
            return ([f"{base}{tag}.npy"] if n == 1 and world == 1
                    else [f"{base}{tag}.s{i}.npy" for i in range(n)])

        # unique on the FINAL names: distinct keys may sanitize alike, and
        # a key named "w.s0" must not collide with the shards of "w"
        base = _sanitize(key)
        n = 0
        while any(f in used_names for f in _files(base)):
            n += 1
            base = f"{_sanitize(key)}__{n}"
        used_names.update(_files(base))
        shard_recs = []
        for fname, (box, data) in zip(_files(base), shards):
            rec = {"file": fname, "box": box}
            shard_recs.append(rec)
            rec_by_file[fname] = rec
            items.append((fname, data, dtype))
        meta["tensors"][key] = {"shape": list(shape), "dtype": dtype,
                                "sharding": sharding, "shards": shard_recs}
    snap = None
    if async_save:
        snap = _Snapshot([d for _, d, _ in items])
        items = [(f, d, dt) for (f, _, dt), d in zip(items, snap.data)]
        snap.data = None

    def write():
        if snap is not None:
            snap.wait()
        staging = None
        tgt = path
        if world == 1:
            parent = os.path.dirname(os.path.abspath(path))
            staging = os.path.join(
                parent,
                f".{os.path.basename(path)}.staging.{os.getpid()}.e{epoch}")
            if os.path.exists(staging):
                shutil.rmtree(staging)
            os.makedirs(staging)
            tgt = staging
        else:
            os.makedirs(path, exist_ok=True)
        stage: dict = {}
        try:
            while items:
                fname, data, dtype = items.pop(0)   # free each as written
                fpath = os.path.join(tgt, fname)

                def _write_one(fp=fpath, d=data, dt=dtype):
                    chaos_point("ckpt.write_shard")
                    return _write_npy(fp, d, dt, stage)

                rec_by_file[fname]["crc32"] = call_with_retry(
                    _write_one, policy=_FS_RETRY, name="ckpt.write_shard")
                del data
            if world == 1:
                with open(os.path.join(tgt, _META_NAME), "w") as f:
                    json.dump(meta, f, indent=1)
                _commit_staging(staging, path)
                return
            # the rank record LAST: it says this rank's files are written
            tmp = os.path.join(path, _rank_meta_name(pid, epoch) + ".tmp")
            with open(tmp, "w") as f:
                json.dump(meta, f, indent=1)
            os.replace(tmp, os.path.join(path, _rank_meta_name(pid, epoch)))
            if pid == coordinator_rank:
                _merge_rank_metadata(path, world, merge_timeout, epoch)
        except BaseException:
            if staging is not None:
                shutil.rmtree(staging, ignore_errors=True)
            raise

    if async_save:
        box = {}

        # writers on one path are serialized: data file names repeat
        # across saves, so save N+1 must not race a stalled save N
        def run():
            try:
                if prev is not None:
                    prev.join()
                write()
            except BaseException as e:  # surfaced by wait_all_saves
                box["error"] = e
            finally:
                snap.release()
                with _path_last_lock:
                    if _path_last_save.get(path) is t:
                        _path_last_save.pop(path, None)

        t = threading.Thread(target=run, daemon=True)
        t._error_box = box
        with _path_last_lock:
            prev = _path_last_save.get(path)
            _path_last_save[path] = t
        t.start()
        _pending_saves.append(t)
    else:
        with _path_last_lock:
            prev = _path_last_save.get(path)
        if prev is not None:
            prev.join()  # a sync save orders after pending async ones
        write()


def wait_all_saves():
    """Join outstanding async saves; surfaces EVERY writer failure (one
    re-raised as it is, several wrapped in :class:`CheckpointSaveError`
    with ``.errors``), and leaves no failed entry behind."""
    errors = []
    while _pending_saves:
        t = _pending_saves.pop()
        try:
            t.join()
        except BaseException:  # interrupted mid-join: t may still write
            _pending_saves.append(t)
            raise
        err = getattr(t, "_error_box", {}).get("error")
        if err is not None:
            errors.append(err)
    if len(errors) == 1:
        raise errors[0]
    if errors:
        raise CheckpointSaveError(
            f"{len(errors)} async checkpoint saves failed: "
            + "; ".join(f"{type(e).__name__}: {e}" for e in errors), errors)


def _wait_all_saves_at_exit():
    """Process-exit flush: daemon writer threads would otherwise die
    mid-write. Failures are reported, not raised."""
    try:
        wait_all_saves()
    except BaseException as e:  # pragma: no cover - exit-path reporting
        print(f"[paddlepaddle_tpu_torch.checkpoint] async save failed at "
              f"exit: {e!r}", file=sys.stderr)


atexit.register(_wait_all_saves_at_exit)


def get_checkpoint_metadata(path: str) -> dict:
    with open(os.path.join(path, _META_NAME)) as f:
        return json.load(f)


# -- reading -----------------------------------------------------------------

class _ShardReader:
    """Partial reads over a tensor's shard files (mmap-backed)."""

    def __init__(self, path: str, rec: dict, verified=None):
        self.shape = tuple(rec["shape"])
        self.dtype = rec.get("dtype", "")
        self._crcs = {}
        self._verified = verified if verified is not None else set()
        if "shards" in rec:  # v2/v3
            self.shards = [(tuple(map(tuple, s["box"])),
                            os.path.join(path, s["file"]))
                           for s in rec["shards"]]
            for s in rec["shards"]:
                if "crc32" in s:
                    self._crcs[os.path.join(path, s["file"])] = s["crc32"]
        else:  # v1: one file holding the global value
            self.shards = [(tuple((0, d) for d in self.shape),
                            os.path.join(path, rec["file"]))]
        self._maps = {}

    def files(self, want) -> List[str]:
        """The files that overlap the box ``want``."""
        return [fp for box, fp in self.shards
                if _overlap(want, box) is not None]

    def _mmap(self, fpath):
        if fpath not in self._maps:
            # v3 integrity: a file's CRC is checked once, before any of its
            # bytes are trusted (FLAGS_ckpt_verify_crc)
            crc = self._crcs.get(fpath)
            if (crc is not None and fpath not in self._verified
                    and _flags.flag_value("ckpt_verify_crc")):
                _check_crcs({fpath: crc})
                self._verified.add(fpath)
            try:
                self._maps[fpath] = np.load(fpath, mmap_mode="r")
            except ValueError:  # dtypes numpy can't mmap
                self._maps[fpath] = np.load(fpath)
        return self._maps[fpath]

    def read(self, want) -> np.ndarray:
        """Assemble the global box ``want`` ``((lo, hi), ...)`` from the
        overlapping shard files."""
        out_shape = tuple(b - a for a, b in want)
        out = covered = None
        for box, fpath in self.shards:
            inter = _overlap(want, box)
            if inter is None:
                continue
            src = self._mmap(fpath)
            src_sl = tuple(slice(a - c, b - c)
                           for (a, b), (c, _) in zip(inter, box))
            dst_sl = tuple(slice(a - wa, b - wa)
                           for (a, b), (wa, _) in zip(inter, want))
            piece = src[src_sl]
            if out is None:
                if all(s == o for s, o in zip(piece.shape, out_shape)):
                    return piece  # one shard covers the request: no copy
                out = np.empty(out_shape, dtype=src.dtype)
                covered = np.zeros(out_shape, dtype=bool)
            out[dst_sl] = piece
            covered[dst_sl] = True
        if out is None:
            if 0 not in out_shape:
                raise ValueError(f"checkpoint shards do not cover {want}")
            return np.empty(out_shape, dtype=np.int16 if self.dtype ==
                            "bfloat16" else np.dtype(self.dtype or "f4"))
        if not covered.all():
            raise ValueError(f"checkpoint shards only partially cover {want}")
        return out


def _overlap(want, box):
    """The intersection of two boxes, or None when it is empty."""
    inter = tuple((max(a, c), min(b, d)) for (a, b), (c, d) in zip(want, box))
    return None if any(a >= b for a, b in inter) else inter


def _check_crcs(expected: Dict[str, int]) -> None:
    """Verify the files of ``expected`` (path -> CRC), several at once;
    raise :class:`CheckpointCorruptionError` on the first mismatch."""
    paths = list(expected)
    for fpath, got in zip(paths, _crcs(paths)):
        crc = expected[fpath]
        if got != crc:
            _count_corruption(fpath)
            raise CheckpointCorruptionError(
                f"{fpath}: CRC mismatch (recorded {crc:#010x}, actual "
                f"{got:#010x})")


def _full_box(shape) -> Tuple[Tuple[int, int], ...]:
    return tuple((0, int(d)) for d in shape)


def _raw(a: np.ndarray) -> np.ndarray:
    """``a``'s bytes, C order, as a flat uint8 array (a view when ``a`` is
    contiguous)."""
    return _contig(a).reshape(-1).view(np.uint8)


@torch.no_grad()
def _fill(target: torch.Tensor, piece: np.ndarray, dtype_name: str,
          stage: dict) -> None:
    """Copy a piece read from the files into ``target`` in place (its
    device and dtype kept). A piece of the target's own dtype is copied
    as bytes, once, from the file's pages (a CUDA target through the
    pinned buffers); another dtype is converted by torch."""
    if tuple(piece.shape) != tuple(target.shape):
        raise ValueError(f"piece {tuple(piece.shape)} for a target of "
                         f"{tuple(target.shape)}")
    if (_dtype_name(target.dtype) != dtype_name
            or not target.is_contiguous() or not target.numel()):
        target.copy_(_as_torch(piece, dtype_name))
        return
    src = _raw(piece)
    dst = target.view(-1).view(torch.uint8)
    if not target.is_cuda:
        dst.numpy()[:] = src
        return
    pin = _stage(stage, target.device)
    pin.stream.wait_stream(torch.cuda.current_stream(target.device))
    for i, lo in enumerate(range(0, src.size, _STAGE_BYTES)):
        n = min(_STAGE_BYTES, src.size - lo)
        buf = pin.take(i)
        buf[:n].numpy()[:] = src[lo:lo + n]
        with torch.cuda.stream(pin.stream):
            dst[lo:lo + n].copy_(buf[:n], non_blocking=True)
        pin.copied(i)
    pin.stream.synchronize()


def _readinto(f, mv: memoryview) -> None:
    """Fill ``mv`` from ``f`` (a short read goes on; EOF raises)."""
    done = 0
    while done < len(mv):
        n = f.readinto(mv[done:])
        if not n:
            raise CheckpointCorruptionError(
                f"{f.name}: truncated ({done} of {len(mv)} bytes)")
        done += n


@torch.no_grad()
def _stream(target: torch.Tensor, fpath: str, stage: dict) -> None:
    """Read a shard file whose box is the whole of ``target`` (same dtype,
    contiguous) straight into it: no map, no intermediate copy; a CUDA
    target through the pinned buffers, each chunk crossing while the next
    is read."""
    with open(fpath, "rb") as f:
        version = np.lib.format.read_magic(f)
        read_header = (np.lib.format.read_array_header_1_0
                       if version == (1, 0)
                       else np.lib.format.read_array_header_2_0)
        shape, fortran, _ = read_header(f)
        if tuple(shape) != tuple(target.shape) or fortran:
            raise ValueError(f"{fpath}: holds {tuple(shape)}, the target "
                             f"is {tuple(target.shape)}")
        dst = target.view(-1).view(torch.uint8)
        if not target.is_cuda:
            _readinto(f, memoryview(dst.numpy()))
            return
        pin = _stage(stage, target.device)
        pin.stream.wait_stream(torch.cuda.current_stream(target.device))
        for i, lo in enumerate(range(0, dst.numel(), _STAGE_BYTES)):
            n = min(_STAGE_BYTES, dst.numel() - lo)
            buf = pin.take(i)
            _readinto(f, memoryview(buf[:n].numpy()))
            with torch.cuda.stream(pin.stream):
                dst[lo:lo + n].copy_(buf[:n], non_blocking=True)
            pin.copied(i)
        pin.stream.synchronize()


def _fill_pieces(target: torch.Tensor, reader: "_ShardReader", want,
                 stage: dict) -> None:
    """Fill ``target`` (the box ``want``) piece by piece from the files
    that overlap it, each piece into its view of the target: a whole file
    whose view is contiguous and of its dtype read straight in
    (:func:`_stream`), any other piece through its map (:func:`_fill`).
    Nothing is assembled on the host."""
    same = _dtype_name(target.dtype) == reader.dtype
    covered = 0
    for box, fpath in reader.shards:
        inter = _overlap(want, box)
        if inter is None:
            continue
        dst = target[tuple(slice(a - wa, b - wa)
                           for (a, b), (wa, _) in zip(inter, want))]
        covered += dst.numel()
        if same and inter == box and dst.is_contiguous():
            _stream(dst, fpath, stage)
        else:
            src = reader._mmap(fpath)[tuple(
                slice(a - c, b - c) for (a, b), (c, _) in zip(inter, box))]
            _fill(dst, src, reader.dtype, stage)
    if covered != target.numel():
        raise ValueError(f"checkpoint shards cover {covered} of the "
                         f"{target.numel()} elements of {want}")


def _read_into(targets, path: str, meta: dict) -> None:
    """Fill each ``(key, tensor, box)`` of ``targets`` in place from the
    checkpoint: the files they overlap CRC-checked first, then the keys
    several at once, each piece into its view of the target
    (:func:`_fill_pieces`), each key's maps released when it is done."""
    import concurrent.futures

    verified: set = set()
    readers: Dict[str, _ShardReader] = {}
    boxes: Dict[str, list] = {}
    expected: Dict[str, int] = {}
    verify = _flags.flag_value("ckpt_verify_crc")
    for key, target, box in targets:
        reader = readers.get(key)
        if reader is None:
            reader = readers[key] = _ShardReader(
                path, meta["tensors"][key], verified)
        boxes.setdefault(key, []).append((target, box))
        if verify:
            for fp in reader.files(box):
                if fp in reader._crcs:
                    expected[fp] = reader._crcs[fp]
    if expected:
        _check_crcs(expected)
        verified.update(expected)
    local = threading.local()

    def fill_key(key):
        if not hasattr(local, "stage"):
            local.stage = {}
        reader = readers[key]
        try:
            for target, box in boxes[key]:
                _fill_pieces(target, reader, box, local.stage)
        finally:
            reader._maps.clear()

    if len(boxes) > 1:
        with concurrent.futures.ThreadPoolExecutor(
                min(CRC_WORKERS, len(boxes))) as ex:
            list(ex.map(fill_key, boxes))
    else:
        for key in boxes:
            fill_key(key)


def load_state_dict(state_dict: Dict[str, object], path: str,
                    process_group=None, coordinator_rank: int = 0,
                    offload: bool = False) -> None:
    """In-place load INTO ``state_dict``'s values: each target reads only
    the box it holds (module doc). A :class:`~..parallel.sharded.
    ShardedTrainStep`'s state is loaded by every rank of its plan; an
    optimizer's ``checkpoint_state()`` takes its step count and scheduler
    from the loaded values."""
    wait_all_saves()
    step = getattr(state_dict, "sharded_step", None)
    if step is not None:
        step._ckpt_load(path, state_dict.kind)
        return
    meta = get_checkpoint_metadata(path)
    missing = [k for k in state_dict if k not in meta["tensors"]]
    if missing:
        raise KeyError(f"checkpoint at {path} lacks keys: {missing[:5]}...")
    targets = []
    for key, target in state_dict.items():
        rec = meta["tensors"][key]
        if isinstance(target, torch.Tensor):
            if tuple(rec["shape"]) != tuple(target.shape):
                raise ValueError(
                    f"shape mismatch for {key}: ckpt {tuple(rec['shape'])} "
                    f"vs {tuple(target.shape)}")
            if _is_dtensor(target):
                box, _, _ = _dtensor_box(target)
                targets.append((key, target.to_local(),
                                tuple(map(tuple, box))))
            else:
                targets.append((key, target, _full_box(rec["shape"])))
    _read_into(targets, path, meta)
    for key, target in state_dict.items():
        if isinstance(target, torch.Tensor):
            continue
        rec = meta["tensors"][key]
        piece = _ShardReader(path, rec).read(_full_box(rec["shape"]))
        # a copy: read() may give a read-only mmap view
        state_dict[key] = (_as_torch(piece, "bfloat16")
                           if rec.get("dtype") == "bfloat16"
                           else np.array(piece))
    loaded = getattr(state_dict, "loaded", None)
    if callable(loaded):
        loaded()
