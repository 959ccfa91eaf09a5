"""Worker ranks of a single-process plan: the reference's one-controller
form of a multi-rank :class:`~.shard_plan.ShardingPlan`.

The reference is single-controller: one process builds
``ServingEngine(model, mesh="mp2")`` or ``ShardedTrainStep(..., plan=
train_plan("dp2mp2"))`` and drives every device of the mesh. Here the
caller's process is rank 0 and starts ranks 1..n-1 itself
(:func:`start_workers`), as processes of the ``spawn`` start method (CUDA
needs it) running :func:`_worker_main`. Each worker builds its rank's object
(a decode engine, :mod:`..inference.tp_worker`; a train step,
:mod:`..parallel.sharded`) and follows rank 0's led steps over the
:class:`Control` channel until rank 0 stops it.

* GROUPS. Rank 0 hosts a ``TCPStore`` on an ephemeral port; every rank
  builds the plan's groups over it
  (:meth:`~.shard_plan.RankContext.from_store`). Nobody registers them with
  ``torch.distributed``, and none becomes the default group, so two such
  objects live in one process (a router's replicas).
* BACKEND: the launcher's rule. NCCL when every rank has a card of its own
  (rank r on ``cuda:(r % device_count)``, rank 0 on the caller's card),
  gloo when ranks share one (one card: every rank on it; the compute on
  the card, the collectives through the host), gloo on the CPU. A backend
  that fails to initialise raises; it is never swapped for the other.
* HAND-OVER. Rank 0 cuts every rank's view of the model
  (:meth:`~.shard_plan.ShardingPlan.cut_module`, no collective attached);
  each worker receives what it holds as an argument of its process: CPU
  tensors through shared memory, CUDA tensors as IPC handles. A worker on
  a card of its own copies them there once; on a shared card it maps rank
  0's memory with no copy, unless its builder copies (a train step owns
  its parameters). Rank 0 keeps the tensors until the workers no longer
  map them: until they report ready when they copied (``owned``), else
  until they end. A worker runs with rank 0's CPU thread count and float32
  matmul settings.
* LIFETIME. A worker exits 0 when rank 0's stop step releases it, and
  non-zero on any fault: its construction error reaches rank 0 through the
  store, and rank 0 raises it. It ends with rank 0 too: a thread waits on
  the parent's sentinel (and watches the parent pid), and a blocked
  collective fails when rank 0's sockets close. Rank 0 reaps its workers
  when it stops them, when their owner is collected without a stop (a
  ``weakref.finalize`` on :func:`release`) and at interpreter exit; a worker
  that died fails rank 0's next led step at once (:meth:`WorkerRanks.check`).
"""

from __future__ import annotations

import datetime
import os
import pickle
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

import torch

_READY_POLL_S = 0.02

# the step name that releases the followers
STOP = "__stop__"


def rank_device(device: torch.device, rank: int) -> torch.device:
    """Rank ``rank``'s device: rank 0's own, ``cuda:(r % device_count)``
    for the others on the card."""
    if device.type != "cuda" or rank == 0:
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


def pick_backend(devices: List[torch.device]) -> str:
    """NCCL when every rank has a card of its own, gloo otherwise (ranks
    that share a card, or the CPU)."""
    if devices[0].type != "cuda":
        return "gloo"
    return "nccl" if len(set(devices)) == len(devices) else "gloo"


class WorkerRanks:
    """Rank 0's handle on the worker ranks it started: their processes, the
    store their groups rendezvoused on, and each worker's start arguments,
    which hold the tensors it maps (kept alive until it no longer maps
    them; a process object keeps its arguments, so they are emptied, not
    dropped). ``what`` names the workers in errors."""

    def __init__(self, procs, store, backend: str,
                 what: str = "worker"):
        self.procs = list(procs)
        self.store = store
        self.specs: List[Dict[str, object]] = []
        self.backend = backend
        self.what = what
        self.closed = False
        # seconds of the start: until every worker connected to the store
        # (process start, imports, the hand-over), its groups, its build
        self.startup: Dict[str, float] = {}

    @property
    def pids(self) -> List[int]:
        return [p.pid for p in self.procs]

    def check(self) -> None:
        """Raise when a worker has exited (a rank lost: the plan cannot run
        a step without it)."""
        for r, p in enumerate(self.procs, start=1):
            if p.exitcode is not None:
                raise RuntimeError(
                    f"{self.what} rank {r} (pid {p.pid}) exited with code "
                    f"{p.exitcode}; the plan cannot run without it — build "
                    "a new one")

    def raise_lost(self, error: BaseException) -> None:
        """Raise ``error`` (a collective or the control channel failed) as
        a lost rank, naming the worker that exited: a killed worker's
        sockets close a moment before its exit status can be read, so wait
        up to 1 s for it."""
        deadline = time.monotonic() + 1.0
        for p in self.procs:
            p.join(max(0.0, deadline - time.monotonic()))
        try:
            self.check()
        except RuntimeError as lost:
            raise lost from error
        raise RuntimeError(f"{self.what} rank lost: the control channel "
                           f"failed ({error})") from error

    def wait(self, key: str, timeout_s: float) -> List[str]:
        """Each worker's value of ``<key>/<rank>`` in the store, waiting
        while the worker lives; raises when one exits first or the wait
        passes ``timeout_s``."""
        deadline = time.monotonic() + timeout_s
        out = []
        for r, p in enumerate(self.procs, start=1):
            name = f"{key}/{r}"
            while not self.store.check([name]):
                if p.exitcode is not None:
                    raise RuntimeError(
                        f"{self.what} rank {r} (pid {p.pid}) exited with "
                        f"code {p.exitcode} while starting")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{self.what} rank {r} (pid {p.pid}) did not reach "
                        f"{key!r} within {timeout_s:g} s")
                time.sleep(_READY_POLL_S)
            out.append(self.store.get(name).decode())
        return out

    def close(self, timeout_s: float = 15.0) -> None:
        """Wait up to ``timeout_s`` for the workers to exit (after rank 0's
        stop step they do at once), then terminate and kill the rest. Then
        let go of the mapped tensors and the store. Idempotent."""
        if self.closed:
            return
        self.closed = True
        deadline = time.monotonic() + timeout_s
        for p in self.procs:
            p.join(max(0.0, deadline - time.monotonic()))
        for p in self.procs:
            if p.exitcode is None:
                p.terminate()
                p.join(5)
            if p.exitcode is None:
                p.kill()
                p.join()
        self.release_specs()
        self.store = None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            # the workers released what they mapped: free it now (a killed
            # worker's share stays held until this process exits)
            torch.cuda.ipc_collect()

    def release_specs(self) -> None:
        """Let go of what the workers were started with."""
        for spec in self.specs:
            spec.clear()


def release(ranks: WorkerRanks) -> None:
    """The owner's finalizer: an object collected without a stop (or alive
    at interpreter exit) takes its workers with it."""
    ranks.close(timeout_s=0.0)


def start_workers(plan, held: List[Dict[str, object]], build: Callable,
                  build_kw: Dict[str, object], device: torch.device,
                  what: str = "worker", owned: bool = False):
    """Start ranks 1..n-1 of ``plan`` for an owner on ``device`` (rank 0,
    the caller). Rank r maps ``held[r - 1]`` (its view, cut by rank 0, and
    whatever else it needs whole), then calls ``build(held, bound plan,
    device, **build_kw)`` (a module-level function: it is sent by name),
    which returns the rank's object; the worker then runs its
    ``follow()``. ``owned``: every worker copies what it maps before it
    reports ready, so rank 0 lets go of it then. Returns ``(plan bound to
    rank 0's groups, WorkerRanks)`` once every worker has built its object;
    a worker's construction error raises here."""
    import multiprocessing as mp

    import torch.distributed as dist

    from .env import pg_timeout_s
    from .shard_plan import RankContext

    n = plan.n_devices
    plan.process_mesh.require_ranks(n)
    devices = [rank_device(device, r) for r in range(n)]
    backend = pick_backend(devices)
    timeout_s = pg_timeout_s()
    store = dist.TCPStore("127.0.0.1", 0, None, True,
                          timeout=datetime.timedelta(seconds=timeout_s),
                          wait_for_workers=False)
    copies = [devices[r] != device for r in range(n)]
    numerics = {"threads": torch.get_num_threads(),
                "matmul_precision": torch.get_float32_matmul_precision(),
                "cuda_matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
                "cudnn_tf32": torch.backends.cudnn.allow_tf32}
    ctx = mp.get_context("spawn")
    ranks = WorkerRanks([], store, backend, what)
    t0 = time.perf_counter()
    try:
        for r in range(1, n):
            spec = {"rank": r, "port": store.port, "backend": backend,
                    "device": str(devices[r]), "copy": copies[r],
                    "plan": plan, "held": held[r - 1], "build": build,
                    "build_kw": dict(build_kw), "timeout_s": timeout_s,
                    "numerics": numerics}
            p = ctx.Process(target=_worker_main, args=(spec,), daemon=True,
                            name=f"{what.replace(' ', '-')}-rank{r}")
            p.start()
            ranks.procs.append(p)
            ranks.specs.append(spec)
        ranks.wait("hello", timeout_s)
        t1 = time.perf_counter()
        rctx = RankContext.from_store(plan.process_mesh, store, 0, backend,
                                      timeout_s, plan.product_axes())
        t2 = time.perf_counter()
        errors = [(r, v) for r, v in
                  enumerate(ranks.wait("ready", timeout_s), start=1)
                  if v != "ok"]
        ranks.startup = {"connect_s": t1 - t0, "groups_s": t2 - t1,
                         "build_s": time.perf_counter() - t2}
        if errors:
            r, msg = errors[0]
            raise RuntimeError(f"{what} rank {r} failed to build: {msg}")
    except BaseException:
        ranks.close(timeout_s=5.0)
        raise
    if owned or all(copies[1:]):
        ranks.release_specs()    # every worker holds its own copy now
        if device.type == "cuda":
            torch.cuda.ipc_collect()
    return plan.bind(rctx), ranks


class Control:
    """Rank 0's led steps to the followers over the plan's CPU gloo
    control group: the pickled step, its length first, through the group
    object's own ``broadcast`` (``broadcast_object_list`` maps ranks
    through the default group's registry, which holds no group that a
    single-process plan built from its own store). ``failed`` holds the
    error that broke the channel (a rank lost)."""

    def __init__(self, plan):
        self.pg = plan.control_group()
        self.driver = plan.rank == 0
        self.size = plan.n_devices
        self.stopped = False
        self.failed: Optional[BaseException] = None
        # rank 0 broadcasts and runs each step under one lock, so steps
        # from two threads reach the followers in the order they run; the
        # nesting depth is the calling thread's own
        self.lock = threading.RLock()
        self._local = threading.local()

    @property
    def depth(self) -> int:
        return getattr(self._local, "depth", 0)

    @depth.setter
    def depth(self, value: int) -> None:
        self._local.depth = value

    def _bcast(self, t: torch.Tensor) -> None:
        import torch.distributed as dist

        opts = dist.BroadcastOptions()
        opts.rootRank = 0
        self.pg.broadcast([t], opts).wait()

    def send(self, name: str, args, kwargs) -> None:
        blob = pickle.dumps((name, tuple(args), dict(kwargs)))
        self._bcast(torch.tensor([len(blob)], dtype=torch.int64))
        self._bcast(torch.frombuffer(bytearray(blob), dtype=torch.uint8))

    def receive(self):
        n = torch.zeros(1, dtype=torch.int64)
        self._bcast(n)
        buf = torch.empty(int(n[0]), dtype=torch.uint8)
        self._bcast(buf)
        return pickle.loads(buf.numpy().tobytes())

    def gather(self, obj) -> list:
        """Every rank's ``obj``, in rank order (inside a led step)."""
        blob = pickle.dumps(obj)
        n = torch.tensor([len(blob)], dtype=torch.int64)
        sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(self.size)]
        self.pg.allgather([sizes], [n]).wait()
        width = int(max(int(x[0]) for x in sizes))
        mine = torch.zeros(width, dtype=torch.uint8)
        mine[:len(blob)] = torch.frombuffer(bytearray(blob), dtype=torch.uint8)
        outs = [torch.empty(width, dtype=torch.uint8)
                for _ in range(self.size)]
        self.pg.allgather([outs], [mine]).wait()
        return [pickle.loads(o[:int(k[0])].numpy().tobytes())
                for o, k in zip(outs, sizes)]


def _watch_parent() -> None:
    """End this process when rank 0's does, whatever it was doing: a thread
    waits on the parent's sentinel (readable once the parent is gone) and
    checks the parent pid once a second."""
    import multiprocessing as mp
    from multiprocessing.connection import wait

    parent = mp.parent_process()
    ppid = os.getppid()

    def watch():
        while True:
            if (parent is not None and wait([parent.sentinel], 1.0)) \
                    or os.getppid() != ppid:
                os._exit(1)
            if parent is None:
                time.sleep(1.0)

    threading.Thread(target=watch, name="rank-parent-watch",
                     daemon=True).start()


def _flush() -> None:
    for f in (sys.stdout, sys.stderr):
        try:
            f.flush()
        except Exception:  # noqa: BLE001 — best effort before _exit
            pass


def _worker_main(spec: Dict[str, object]) -> None:
    """One worker rank: connect to rank 0's store, build the plan's groups,
    build this rank's object, tell rank 0, follow it. Exits 0 after rank
    0's stop step, non-zero on any fault. Before it exits it drops every
    tensor it mapped from rank 0: a mapped CUDA tensor's release is what
    lets rank 0 free that memory, and ``os._exit`` runs no destructor."""
    import gc

    _watch_parent()
    rank = int(spec["rank"])
    # popped: this process's Process object keeps ``spec`` to the end
    held = spec.pop("held")
    obj = None
    store = None
    code = 1
    try:
        import torch.distributed as dist

        from .shard_plan import RankContext

        num = spec["numerics"]
        torch.set_num_threads(num["threads"])
        torch.set_float32_matmul_precision(num["matmul_precision"])
        torch.backends.cuda.matmul.allow_tf32 = num["cuda_matmul_tf32"]
        torch.backends.cudnn.allow_tf32 = num["cudnn_tf32"]
        dev = torch.device(spec["device"])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        if spec["copy"]:
            held = {k: None if v is None else v.to(dev)
                    for k, v in held.items()}
        store = dist.TCPStore(
            "127.0.0.1", int(spec["port"]), None, False,
            timeout=datetime.timedelta(seconds=float(spec["timeout_s"])))
        store.set(f"hello/{rank}", "1")
        plan = spec["plan"]
        ctx = RankContext.from_store(plan.process_mesh, store, rank,
                                     spec["backend"],
                                     float(spec["timeout_s"]),
                                     plan.product_axes())
        obj = spec["build"](held, plan.bind(ctx), dev, **spec["build_kw"])
        gc.collect()             # what the build let go of is unmapped now
        store.set(f"ready/{rank}", "ok")
    except BaseException as e:  # noqa: BLE001 — reported, then exit
        if store is not None:
            try:
                store.set(f"ready/{rank}", f"{type(e).__name__}: {e}")
            except Exception:  # noqa: BLE001 — rank 0 sees the exit
                pass
        traceback.print_exc()
    else:
        try:
            obj.follow()
            code = 0
        except BaseException:  # noqa: BLE001 — this rank dies; rank 0 fails
            traceback.print_exc()
    obj = None
    held.clear()
    gc.collect()
    _flush()
    os._exit(code)
