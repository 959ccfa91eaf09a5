"""DataLoader (counterpart of ``paddlepaddle_tpu/io/dataloader.py`` :1-662;
reference python/paddle/io/reader.py:262 + dataloader/worker.py +
dataloader_iter.py).

Batches are assembled on the host and handed to the training loop as
tensors on the loader's device (``places=``, or ``device=``; ``cuda`` by
default, and without CUDA it raises unless ``"cpu"`` is given, as every
entry point of the port does). Three ways to assemble them, as in the JAX
package:

* ``num_workers=0`` — in the calling thread;
* ``use_multiprocess=False`` — a thread pool (numpy-heavy datasets where
  a process start costs more than it saves);
* subprocess workers (the default for ``num_workers > 0``): each worker
  owns an index queue, runs ``dataset[i]`` + collate outside the parent's
  GIL, and ships host batches back over one bounded data queue. Workers
  never touch the card: they produce numpy (or CPU tensor) leaves, and
  the parent makes the device copy. They start through ``forkserver`` by
  default, so no worker is forked from a process that holds a CUDA context
  (``_worker_context``; ``PADDLE_TPU_MP_START_METHOD`` selects
  fork / forkserver / spawn; a ``__main__`` read from stdin, and a payload
  that does not pickle, fall back to fork with a warning).
  ``worker_init_fn``, ``persistent_workers``, ``timeout``, the replacement
  of a pool whose worker died, and ``IterableDataset`` self-sharding
  (``get_worker_info()``) behave as in the JAX package.

The copy to the card. Each batch is copied when it is handed over: its
host leaves are page-locked and sent with a non-blocking copy on the
consumer's current stream, so the host goes on at once and the step that
reads the batch is queued behind its copy on the same stream (nothing to
fence, no block the allocator could hand out early). The host assembly of
the next batches already overlaps the card's work: the workers (or the
thread pool) run ahead by ``prefetch_factor`` batches, and the loop that
queued a step on the card gets back to the loader before the card has
run it. ``use_buffer_reader`` is accepted and has no effect, as in the
JAX package. A failed copy raises; nothing falls back to the CPU.

Observability: ``_obs_io(event, value)`` (installed by
``observability.enable``) gets ``"wait"`` (seconds the loop blocked on
the loader for one batch: a ``dataloader`` span the step-time
decomposition reads as ``data_wait``), ``"qdepth"`` and ``"batch"``.
"""

from __future__ import annotations

import itertools
import multiprocessing
import os
import queue
import threading
import time
import traceback

import numpy as np
import torch

from ..device import resolve_device
from ..resilience.chaos import chaos_point
from .dataset import IterableDataset
from .sampler import BatchSampler

# observability hook: _obs_io(event, value) with events "wait", "qdepth",
# "batch"; None when observability is off
_obs_io = None


class WorkerInfo:
    """Visible to dataset code inside a worker (reference: paddle.io
    get_worker_info, python/paddle/io/dataloader/worker.py)."""

    def __init__(self, id, num_workers, seed, dataset):
        self.id = id
        self.num_workers = num_workers
        self.seed = seed
        self.dataset = dataset

    def __repr__(self):
        return (f"WorkerInfo(id={self.id}, num_workers={self.num_workers}, "
                f"seed={self.seed})")


_worker_info = None


def get_worker_info():
    """Inside a worker process: that worker's WorkerInfo; None in the main
    process. IterableDataset code uses it to shard itself across workers."""
    return _worker_info


def np_collate_fn(batch):
    """Collate into host leaves (runs inside workers): numpy arrays, CPU
    tensors for tensor samples, lists for strings."""
    sample = batch[0]
    if isinstance(sample, (list, tuple)):
        return type(sample)(np_collate_fn([b[i] for b in batch])
                            for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: np_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, torch.Tensor):
        return torch.stack([b.cpu() for b in batch])
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, np.float32)
    if isinstance(sample, str):
        return list(batch)
    return np.asarray(batch)


def _as_tensor(leaf) -> torch.Tensor:
    return (leaf if isinstance(leaf, torch.Tensor)
            else torch.from_numpy(np.ascontiguousarray(leaf)))


def _map_leaves(obj, fn):
    """``fn`` over every numpy / tensor leaf of a nested batch."""
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return fn(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_leaves(o, fn) for o in obj)
    if isinstance(obj, dict):
        return {k: _map_leaves(v, fn) for k, v in obj.items()}
    return obj


def default_collate_fn(batch):
    """Stack samples into CPU tensors with the JAX package's dtypes: int64
    for ints, float32 for floats, lists for strings, the nesting kept."""
    return _map_leaves(np_collate_fn(batch), _as_tensor)


class DataLoaderWorkerError(RuntimeError):
    """A DataLoader worker process failed: it raised (the remote traceback
    is attached), died without reporting (killed / startup crash), or the
    parent timed out waiting on it. Raised in the parent instead of blocking
    forever on the data queue."""


def _count_worker_deaths(n: int) -> None:
    from ..observability import safe_inc

    safe_inc("paddle_dataloader_worker_deaths_total",
             "DataLoader worker processes that died without reporting "
             "an error", n)


def _is_pickle_error(e):
    """True for the exception shapes CPython's picklers raise on an
    unpicklable object."""
    import pickle

    if isinstance(e, pickle.PicklingError):
        return True
    return (isinstance(e, (TypeError, AttributeError))
            and ("pickle" in str(e) or "local object" in str(e)
                 or "local class" in str(e)))


def _main_reimportable():
    """True when spawn/forkserver worker prep can reconstruct __main__ (a
    ``__main__`` read from stdin has a ``__file__`` that does not exist)."""
    import sys

    main = sys.modules.get("__main__")
    if main is None:
        return True
    path = getattr(main, "__file__", None)
    if path is None:
        return True  # REPL/embedded: spawn prep has nothing to re-run
    return os.path.exists(path)


def _worker_context():
    """The multiprocessing context for workers and whether it was chosen
    explicitly. Default ``forkserver``: children fork from a clean
    single-threaded server, never from this process, which may hold a CUDA
    context and threads (a forked CUDA context is unusable, and a fork of a
    multithreaded process can deadlock). ``PADDLE_TPU_MP_START_METHOD``
    overrides (fork|forkserver|spawn)."""
    method = os.environ.get("PADDLE_TPU_MP_START_METHOD", "").strip()
    explicit = bool(method)
    method = method or "forkserver"
    if method != "fork" and not explicit and not _main_reimportable():
        import warnings

        warnings.warn(
            "DataLoader workers: __main__ was not started from an "
            "importable file (stdin/heredoc/embedded interpreter), which "
            "the 'forkserver' start method cannot re-import in workers; "
            "falling back to 'fork'. Run from a real script file (with "
            "dataset definitions importable) to use forkserver.",
            stacklevel=3)
        method = "fork"
    ctx = multiprocessing.get_context(method)
    if method == "forkserver":
        # the server imports this module (torch with it, never CUDA) once;
        # each worker is then a fork of it and starts in milliseconds
        ctx.set_forkserver_preload([__name__])
    return ctx, explicit


def _to_host_leaves(obj):
    """Tensor leaves -> CPU so batches pickle through the queue even when a
    user collate_fn builds tensors in the worker."""
    return _map_leaves(obj, lambda t: t.cpu() if isinstance(
        t, torch.Tensor) else t)


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[-1].split()[0] != "Z"
    except OSError:
        return True


def _next_job(index_queue, loader_pid: int):
    """The next message of ``index_queue``; None (stop) once the loader's
    process is gone: one killed outright (SIGKILL, a lost host) leaves no
    worker behind. (A forkserver worker's parent is the server, which
    stays up while its workers hold its liveness pipe, so the worker
    watches the loader's pid itself.)"""
    while True:
        try:
            return index_queue.get(timeout=1.0)
        except queue.Empty:
            if not _alive(loader_pid):
                return None


def _worker_loop(dataset, index_queue, data_queue, collate_fn, init_fn,
                 worker_id, num_workers, seed, iterable, batch_size,
                 drop_last, loader_pid):
    """Reference: python/paddle/io/dataloader/worker.py _worker_loop.

    Every message is tagged with the epoch id of the job that produced it so
    the parent can discard leftovers from an abandoned epoch."""
    global _worker_info
    _worker_info = WorkerInfo(worker_id, num_workers, seed + worker_id,
                              dataset)
    np.random.seed(seed + worker_id)
    torch.manual_seed(seed + worker_id)
    try:
        if init_fn is not None:
            init_fn(worker_id)
    except Exception:
        data_queue.put(("error", 0, worker_id, traceback.format_exc()))
        return
    try:
        if iterable:
            # epochs arrive as ('epoch', id) messages; each runs this
            # worker's self-sharded iterator to exhaustion
            while True:
                msg = _next_job(index_queue, loader_pid)
                if msg is None:
                    break
                _, epoch = msg
                batch, seq = [], 0
                for item in iter(dataset):
                    batch.append(item)
                    if len(batch) == batch_size:
                        chaos_point("dataloader.worker")
                        data_queue.put(("data", epoch, (worker_id, seq),
                                        _to_host_leaves(collate_fn(batch))))
                        batch, seq = [], seq + 1
                if batch and not drop_last:
                    data_queue.put(("data", epoch, (worker_id, seq),
                                    _to_host_leaves(collate_fn(batch))))
                data_queue.put(("end", epoch, worker_id, None))
        else:
            while True:
                job = _next_job(index_queue, loader_pid)
                if job is None:
                    break
                # chaos seam: a killed/failing worker here exercises the
                # parent's dead-worker detection (DataLoaderWorkerError)
                chaos_point("dataloader.worker")
                epoch, bidx, indices = job
                data_queue.put(
                    ("data", epoch, bidx,
                     _to_host_leaves(collate_fn([dataset[i]
                                                 for i in indices]))))
    except Exception:
        data_queue.put(("error", 0, worker_id, traceback.format_exc()))


class _WorkerPool:
    """Subprocess pool: per-worker index queues + one bounded data queue
    (backpressure), the shape of the reference's
    _DataLoaderIterMultiProcess. Holds no reference back to the DataLoader
    (no cycle); epoch ids let a reused pool discard leftovers from an
    abandoned epoch."""

    def __init__(self, dataset, collate_fn, worker_init_fn, num_workers,
                 prefetch_factor, iterable, batch_size, drop_last,
                 ctx=None, explicit_method=False):
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.epoch = 0
        if ctx is None:
            ctx, explicit_method = _worker_context()
        self.alive = False
        try:
            self._build(ctx, dataset, collate_fn, worker_init_fn,
                        iterable, batch_size, drop_last)
        except Exception as e:
            # spawn/forkserver contexts pickle the worker args in the
            # parent's Process.start(): an unpicklable payload lands here
            self._teardown_partial()
            if ctx.get_start_method() == "fork" or not _is_pickle_error(e):
                raise
            if explicit_method:
                raise RuntimeError(
                    f"DataLoader workers with start method "
                    f"'{ctx.get_start_method()}' need a picklable "
                    f"dataset/collate_fn/worker_init_fn: {e}. Define them "
                    "at module level, or set "
                    "PADDLE_TPU_MP_START_METHOD=fork.") from e
            import warnings

            warnings.warn(
                "DataLoader worker payload is not picklable "
                f"({type(e).__name__}: {e}); falling back to the 'fork' "
                "start method. A fork of a multithreaded parent (or one "
                "holding a CUDA context) risks child deadlock; prefer "
                "module-level dataset/collate/init_fn definitions (or opt "
                "in explicitly via PADDLE_TPU_MP_START_METHOD=fork).",
                stacklevel=2)
            self._build(multiprocessing.get_context("fork"), dataset,
                        collate_fn, worker_init_fn, iterable, batch_size,
                        drop_last)
        self.alive = True

    def _build(self, ctx, dataset, collate_fn, worker_init_fn, iterable,
               batch_size, drop_last):
        self.ctx = ctx
        self.start_method = ctx.get_start_method()
        self.index_queues = [ctx.Queue() for _ in range(self.num_workers)]
        self.data_queue = ctx.Queue(
            maxsize=self.num_workers * self.prefetch_factor)
        seed = int(np.random.randint(0, 2**31 - 1))
        self.procs = []
        for w in range(self.num_workers):
            p = ctx.Process(
                target=_worker_loop,
                args=(dataset, self.index_queues[w], self.data_queue,
                      collate_fn, worker_init_fn, w, self.num_workers, seed,
                      iterable, batch_size, drop_last, os.getpid()),
                daemon=True)
            p.start()
            self.procs.append(p)

    def _teardown_partial(self):
        for p in getattr(self, "procs", []):
            try:
                p.terminate()
            except Exception:
                pass

    def healthy(self) -> bool:
        return self.alive and all(p.is_alive() for p in self.procs)

    def get(self, timeout):
        """One message for the CURRENT epoch (stale-epoch messages dropped).

        Polls in short slices so a worker that died WITHOUT posting an
        error message (killed, or crashed in interpreter startup before
        the loop) surfaces as an exception instead of a parent hang."""
        obs = _obs_io
        waited = 0.0
        while True:
            slice_t = min(timeout - waited, 1.0) if timeout else 1.0
            try:
                msg = self.data_queue.get(timeout=max(slice_t, 0.001))
            except queue.Empty:
                if not self.alive:
                    raise DataLoaderWorkerError(
                        "DataLoader worker pool was shut down while an "
                        "iterator was still reading from it")
                if not self.healthy():
                    dead = [w for w, p in enumerate(self.procs)
                            if not p.is_alive()]
                    codes = [self.procs[w].exitcode for w in dead]
                    _count_worker_deaths(len(dead))
                    hint = ""
                    if self.start_method != "fork" and codes and all(
                            c == 1 for c in codes):
                        hint = (
                            " With the '%s' start method, a script that "
                            "builds its DataLoader at module top level "
                            "must guard it with `if __name__ == "
                            "'__main__':` (workers re-import the main "
                            "module); alternatively set "
                            "PADDLE_TPU_MP_START_METHOD=fork."
                            % self.start_method)
                    raise DataLoaderWorkerError(
                        f"DataLoader worker(s) {dead} died unexpectedly "
                        f"(exitcode {codes}) without reporting an error — "
                        f"e.g. killed, or crashed during startup.{hint}")
                waited += slice_t
                if timeout and waited >= timeout:
                    raise DataLoaderWorkerError(
                        f"DataLoader timed out after {timeout}s waiting "
                        "for worker data") from None
                continue
            kind, epoch, key, payload = msg
            if kind == "error" or epoch == self.epoch:
                if obs is not None:
                    try:
                        obs("qdepth", self.data_queue.qsize())
                    except NotImplementedError:  # macOS mp queues
                        pass
                return kind, key, payload
            # else: leftover from an abandoned epoch — discard

    def shutdown(self):
        if not self.alive:
            return
        self.alive = False
        for q in self.index_queues:
            try:
                q.put(None)
            except Exception:
                pass
        for p in self.procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)

    def __del__(self):
        try:
            self.shutdown()
        except Exception:
            pass


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False,
                 drop_last=False, collate_fn=None, num_workers=0,
                 use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, use_multiprocess=True, *,
                 device=None):
        place = device if device is not None else places
        if isinstance(place, (list, tuple)):
            place = place[0] if place else None
        self.device = resolve_device(place)
        self.dataset = dataset
        self._user_collate = collate_fn
        self.collate_fn = collate_fn or np_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = max(prefetch_factor, 2)
        self.worker_init_fn = worker_init_fn
        self.persistent_workers = persistent_workers
        self.use_multiprocess = use_multiprocess
        self.timeout = timeout
        self.batch_size = batch_size
        self.drop_last = drop_last
        self._pool = None
        self._mp_ctx = None  # resolved start-method context, cached per loader
        self._iterable = isinstance(dataset, IterableDataset)
        if self._iterable:
            self.batch_sampler = None
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __del__(self):
        if getattr(self, "_pool", None) is not None:
            self._pool.shutdown()

    def __len__(self):
        if self._iterable:
            raise TypeError("IterableDataset has no len()")
        return len(self.batch_sampler)

    def _batches(self):
        if self._iterable:
            batch = []
            for item in self.dataset:
                batch.append(item)
                if len(batch) == self.batch_size:
                    yield self.collate_fn(batch)
                    batch = []
            if batch and not self.drop_last:
                yield self.collate_fn(batch)
        else:
            for indices in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in indices])

    def __iter__(self):
        obs = _obs_io
        it = self._device_iter()
        while True:
            t0 = time.perf_counter() if obs is not None else 0.0
            try:
                b = next(it)
            except StopIteration:
                return
            if obs is not None:
                obs("wait", time.perf_counter() - t0)
                obs("batch", 1)
            yield b

    def _device_iter(self):
        if self.device.type != "cuda":
            for host in self._iter_impl():
                yield _map_leaves(host, _as_tensor)
            return
        dev = self.device
        for host in self._iter_impl():
            yield _map_leaves(host, lambda x: _as_tensor(x).pin_memory().to(
                dev, non_blocking=True))

    def _iter_impl(self):
        if self.num_workers == 0:
            yield from self._batches()
            return
        if self.use_multiprocess:
            yield from (self._iter_mp_iterable() if self._iterable
                        else self._iter_mp_map())
            return
        if self._iterable:
            # IterableDataset must be consumed sequentially; one producer
            # thread gives prefetch overlap
            yield from self._prefetch_single()
            return
        # map-style: N threads load batches concurrently, yielded in order
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        def load(indices):
            return self.collate_fn([self.dataset[i] for i in indices])

        window = self.num_workers * self.prefetch_factor
        with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            pending = deque()
            it = iter(self.batch_sampler)
            try:
                for indices in it:
                    pending.append(ex.submit(load, indices))
                    if len(pending) >= window:
                        yield pending.popleft().result()
                while pending:
                    yield pending.popleft().result()
            finally:
                for f in pending:
                    f.cancel()

    # -- subprocess workers (reference dataloader/worker.py) ----------------

    def _get_pool(self):
        if self._pool is not None:
            if self._pool.healthy():
                self._pool.epoch += 1
                return self._pool
            self._pool.shutdown()  # a worker died: never reuse a broken pool
            self._pool = None
        if self._mp_ctx is None:
            self._mp_ctx = _worker_context()
        pool = _WorkerPool(self.dataset, self.collate_fn,
                           self.worker_init_fn, self.num_workers,
                           self.prefetch_factor, self._iterable,
                           self.batch_size if self._iterable else 0,
                           self.drop_last if self._iterable else False,
                           ctx=self._mp_ctx[0],
                           explicit_method=self._mp_ctx[1])
        # remember the method the pool ended on (a picklability fallback
        # to fork happens once, not every epoch)
        if pool.start_method != self._mp_ctx[0].get_start_method():
            self._mp_ctx = (pool.ctx, self._mp_ctx[1])
        if self.persistent_workers:
            self._pool = pool
        return pool

    def _raise_worker_error(self, pool, worker_id, tb):
        # the failing worker's process has exited — tear the pool down so a
        # retry gets fresh workers instead of hanging on a dead queue
        pool.shutdown()
        if self._pool is pool:
            self._pool = None
        raise DataLoaderWorkerError(
            f"DataLoader worker {worker_id} failed:\n{tb}")

    def _iter_mp_map(self):
        pool = self._get_pool()
        epoch = pool.epoch
        try:
            jobs = list(self.batch_sampler)
            # windowed feeding: at most W*prefetch_factor jobs outstanding
            window = pool.num_workers * pool.prefetch_factor
            sent = 0

            def feed():
                nonlocal sent
                while sent < len(jobs) and sent - done < window:
                    pool.index_queues[sent % pool.num_workers].put(
                        (epoch, sent, list(jobs[sent])))
                    sent += 1

            done = 0
            buf = {}
            feed()
            for want in range(len(jobs)):
                while want not in buf:
                    kind, key, payload = pool.get(self.timeout)
                    if kind == "error":
                        self._raise_worker_error(pool, key, payload)
                    buf[key] = payload
                done += 1
                feed()
                yield buf.pop(want)
        finally:
            if not self.persistent_workers:
                pool.shutdown()

    def _iter_mp_iterable(self):
        """Each worker runs its own (self-sharded via get_worker_info)
        iterator; batches interleave round-robin across workers."""
        pool = self._get_pool()
        W = pool.num_workers
        try:
            for q in pool.index_queues:
                q.put(("epoch", pool.epoch))
            pending = {w: {} for w in range(W)}
            next_seq = [0] * W
            ended = set()
            rr = itertools.cycle(range(W))
            while True:
                if len(ended) == W and not any(pending.values()):
                    break
                target = next(rr)
                if target in ended and not pending[target]:
                    continue
                while (next_seq[target] not in pending[target]
                       and target not in ended):
                    kind, key, payload = pool.get(self.timeout)
                    if kind == "error":
                        self._raise_worker_error(pool, key, payload)
                    elif kind == "end":
                        ended.add(key)
                    else:
                        wq, seq = key
                        pending[wq][seq] = payload
                if next_seq[target] in pending[target]:
                    yield pending[target].pop(next_seq[target])
                    next_seq[target] += 1
        finally:
            if not self.persistent_workers:
                pool.shutdown()

    def _prefetch_single(self):
        q: queue.Queue = queue.Queue(
            maxsize=self.num_workers * self.prefetch_factor)
        sentinel = object()
        error_holder = []

        def producer():
            try:
                for b in self._batches():
                    q.put(b)
            except Exception as e:  # surface worker errors to the consumer
                error_holder.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        t.join()
        if error_holder:
            raise error_holder[0]
