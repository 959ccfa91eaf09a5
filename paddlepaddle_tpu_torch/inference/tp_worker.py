"""Worker ranks of a single-process tensor-parallel decode engine.

The reference is single-controller: one process calls
``ServingEngine(model, mesh="mp2")`` and serves over every device of the
mesh. Here the caller's process is rank 0 and the engine starts ranks
1..n-1 itself (:func:`start_workers`), as processes of the ``spawn`` start
method (CUDA needs it) running :func:`_worker_main`, which builds the
rank's engine and follows rank 0 (:meth:`.decode_engine.BatchDecodeEngine.
follow`) until rank 0's ``stop()``.

* GROUPS. Rank 0 hosts a ``TCPStore`` on an ephemeral port; every rank
  builds the plan's groups over it
  (:meth:`~..distributed.shard_plan.RankContext.from_store`). Nobody
  registers them with ``torch.distributed``, and none becomes the default
  group, so two such engines live in one process (a router's replicas).
* BACKEND: the launcher's rule. NCCL when every rank has a card of its own
  (rank r on ``cuda:(r % device_count)``, rank 0 on the engine's card),
  gloo when ranks share one (one card: every rank on it; the compute on
  the card, the collectives through the host), gloo on the CPU. A backend
  that fails to initialise raises; it is never swapped for the other.
* HAND-OVER. Rank 0 quantizes (``quant=``) and then cuts every rank's view
  of the model (:meth:`~..distributed.shard_plan.ShardingPlan.cut_module`,
  no collective attached); each worker receives its view, and the draft of
  speculative decoding (replicated: the whole model), as an argument of
  its process: CPU tensors through shared memory, CUDA tensors as IPC
  handles. On a shared card the worker maps rank 0's memory with no copy,
  so rank 0 keeps those tensors until the worker has ended (a worker drops
  them before it exits, and rank 0 then frees them); on a card of
  its own the worker copies its view there once and rank 0 lets go of it
  when the worker reports ready. A worker runs with rank 0's CPU thread
  count and float32 matmul settings.
* LIFETIME. A worker exits 0 when rank 0's ``stop()`` releases it, and
  non-zero on any fault: its construction error reaches rank 0 through the
  store, and the engine raises it. It ends with rank 0 too: a thread waits
  on the parent's sentinel (and watches the parent pid), and a blocked
  collective fails when rank 0's sockets close. Rank 0 reaps its workers on
  ``stop()``, when the engine is collected without one (a
  ``weakref.finalize``) and at interpreter exit; a worker that died fails
  rank 0's next step at once (:meth:`WorkerRanks.check`).
"""

from __future__ import annotations

import datetime
import os
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional

import torch

_READY_POLL_S = 0.02


def _rank_device(device: torch.device, rank: int) -> torch.device:
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
    which hold the tensors it maps (kept alive until it ends; a process
    object keeps its arguments, so they are emptied, not dropped)."""

    def __init__(self, procs, store, backend: str):
        self.procs = list(procs)
        self.store = store
        self.specs: List[Dict[str, object]] = []
        self.backend = backend
        self.closed = False
        # seconds of the start: until every worker connected to the store
        # (process start, imports, the hand-over), its groups, its engine
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
                    f"tensor-parallel worker rank {r} (pid {p.pid}) exited "
                    f"with code {p.exitcode}; the engine cannot serve "
                    "without it — build a new engine")

    def raise_lost(self, error: BaseException) -> None:
        """Raise ``error`` (the control channel failed) as a lost rank,
        naming the worker that exited: a killed worker's sockets close a
        moment before its exit status can be read, so wait up to 1 s for
        it."""
        deadline = time.monotonic() + 1.0
        for p in self.procs:
            p.join(max(0.0, deadline - time.monotonic()))
        try:
            self.check()
        except RuntimeError as lost:
            raise lost from error
        raise RuntimeError(f"tensor-parallel rank lost: the control "
                           f"channel failed ({error})") from error

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
                        f"tensor-parallel worker rank {r} (pid {p.pid}) "
                        f"exited with code {p.exitcode} while starting")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"tensor-parallel worker rank {r} (pid {p.pid}) "
                        f"did not reach {key!r} within {timeout_s:g} s")
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
        """Let go of what the workers were started with (their views and
        the draft)."""
        for spec in self.specs:
            spec.clear()


def _release(ranks: WorkerRanks) -> None:
    """The engine's finalizer: an engine collected without ``stop()`` (or
    alive at interpreter exit) takes its workers with it."""
    ranks.close(timeout_s=0.0)


def start_workers(plan, cuts, draft, engine_kw: Dict[str, object],
                  device: torch.device):
    """Start ranks 1..n-1 of ``plan`` for an engine on ``device`` (rank 0,
    the caller): rank r builds its engine on ``cuts[r]`` (its view, cut by
    rank 0) with ``engine_kw`` and the replicated ``draft``. Returns
    ``(plan bound to rank 0's groups, WorkerRanks)`` once every worker has
    built its engine; a worker's construction error raises here."""
    import multiprocessing as mp

    import torch.distributed as dist

    from ..distributed.env import pg_timeout_s
    from ..distributed.shard_plan import RankContext

    n = plan.n_devices
    devices = [_rank_device(device, r) for r in range(n)]
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
    ranks = WorkerRanks([], store, backend)
    t0 = time.perf_counter()
    try:
        for r in range(1, n):
            spec = {"rank": r, "port": store.port, "backend": backend,
                    "device": str(devices[r]), "copy": copies[r],
                    "plan": plan, "net": cuts[r], "draft": draft,
                    "engine": dict(engine_kw), "timeout_s": timeout_s,
                    "numerics": numerics}
            p = ctx.Process(target=_worker_main, args=(spec,), daemon=True,
                            name=f"tp-rank{r}")
            p.start()
            ranks.procs.append(p)
            ranks.specs.append(spec)
        ranks.wait("hello", timeout_s)
        t1 = time.perf_counter()
        rctx = RankContext.from_store(plan.process_mesh, store, 0, backend,
                                      timeout_s)
        t2 = time.perf_counter()
        errors = [(r, v) for r, v in
                  enumerate(ranks.wait("engine", timeout_s), start=1)
                  if v != "ok"]
        ranks.startup = {"connect_s": t1 - t0, "groups_s": t2 - t1,
                         "engine_s": time.perf_counter() - t2}
        if errors:
            r, msg = errors[0]
            raise RuntimeError(f"tensor-parallel worker rank {r} failed to "
                               f"build its engine: {msg}")
    except BaseException:
        ranks.close(timeout_s=5.0)
        raise
    if all(copies[1:]):
        ranks.release_specs()    # every worker holds its own copy now
    return plan.bind(rctx), ranks


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

    threading.Thread(target=watch, name="tp-parent-watch",
                     daemon=True).start()


def _flush() -> None:
    for f in (sys.stdout, sys.stderr):
        try:
            f.flush()
        except Exception:  # noqa: BLE001 — best effort before _exit
            pass


def _worker_main(spec: Dict[str, object]) -> None:
    """One worker rank: connect to rank 0's store, build the plan's groups,
    build the engine on this rank's view, tell rank 0, follow it. Exits 0
    after rank 0's stop step, non-zero on any fault. Before it exits it
    drops every tensor it mapped from rank 0: a mapped CUDA tensor's
    release is what lets rank 0 free that memory, and ``os._exit`` runs no
    destructor."""
    import gc

    _watch_parent()
    rank = int(spec["rank"])
    # popped: this process's Process object keeps ``spec`` to the end
    held = {"net": spec.pop("net"), "draft": spec.pop("draft")}
    store = None
    code = 1
    try:
        import torch.distributed as dist

        from ..distributed.shard_plan import RankContext
        from .decode_engine import BatchDecodeEngine

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
                                     float(spec["timeout_s"]))
        held["engine"] = BatchDecodeEngine(
            held.pop("net"), plan=plan.bind(ctx), draft=held.pop("draft"),
            device=dev, **spec["engine"])
        store.set(f"engine/{rank}", "ok")
    except BaseException as e:  # noqa: BLE001 — reported, then exit
        if store is not None:
            try:
                store.set(f"engine/{rank}", f"{type(e).__name__}: {e}")
            except Exception:  # noqa: BLE001 — rank 0 sees the exit
                pass
        traceback.print_exc()
    else:
        try:
            held["engine"].follow()
            code = 0
        except BaseException:  # noqa: BLE001 — this rank dies; rank 0 fails
            traceback.print_exc()
    held.clear()
    gc.collect()
    _flush()
    os._exit(code)
