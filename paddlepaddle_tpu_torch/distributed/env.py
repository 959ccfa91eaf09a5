"""Process environment (counterpart of ``paddlepaddle_tpu/distributed/env.py``
:20-62): ``init_parallel_env``, ``get_rank``, ``get_world_size``,
``parallel_device_count``.

The reference runs one controller process per host that drives every local
chip, so its rank is a host index. The port runs SPMD, PyTorch's and
Paddle's own idiom: one process per rank under ``torch.distributed``, each
on one device, with explicit collectives.

``init_parallel_env(backend=None)`` reads the launcher's environment
(:mod:`.launch` sets ``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM`` /
``PADDLE_LOCAL_RANK`` and the torch-style ``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``) and calls
``torch.distributed.init_process_group``. The default backend is ``nccl``
when every local rank has a card of its own and ``gloo`` on the CPU. Ranks
that would share one card raise unless the caller passes
``backend="gloo"``: NCCL refuses two ranks on one device, and the port never
picks a transport silently. With gloo, CUDA tensors stay on the card and
only the collectives cross the host. A rank's device is
``cuda:(LOCAL_RANK % device_count)``.
"""

from __future__ import annotations

import atexit
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

def _env_int(names, default=None) -> Optional[int]:
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v)
    return default


def _rank_env() -> int:
    return _env_int(("PADDLE_TRAINER_ID", "RANK"), 0)


def _world_env() -> int:
    return _env_int(("PADDLE_TRAINERS_NUM", "WORLD_SIZE"), 1)


def _local_rank_env() -> int:
    return _env_int(("PADDLE_LOCAL_RANK", "LOCAL_RANK"), 0)


def _local_world_env(world: int) -> int:
    """Ranks on this host: the launcher's ``LOCAL_WORLD_SIZE``, else every
    rank of a one-node job."""
    return _env_int(("PADDLE_LOCAL_WORLD_SIZE", "LOCAL_WORLD_SIZE"), world)


def pg_timeout_s() -> float:
    """The process-group timeout in seconds: ``PADDLE_PG_TIMEOUT_S`` (the
    launcher and :func:`.launch.spawn` set it), else 300. A rank that dies
    or hangs fails its peers' collectives within it."""
    return float(os.environ.get("PADDLE_PG_TIMEOUT_S") or 300.0)


def _pick_backend(backend: Optional[str], world: int) -> str:
    """``nccl`` when every local rank has its own card, ``gloo`` on the CPU;
    ranks sharing a card raise unless ``backend="gloo"`` is explicit."""
    if not torch.cuda.is_available():
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} needs CUDA; this host "
                             "has none (use gloo)")
        return "gloo"
    shared = _local_world_env(world) > torch.cuda.device_count()
    if backend is None or backend == "nccl":
        if shared:
            raise ValueError(
                f"{_local_world_env(world)} local ranks share "
                f"{torch.cuda.device_count()} card(s): NCCL refuses two "
                "ranks on one device. Pass backend='gloo' explicitly to run "
                "them over gloo with CUDA tensors (collectives cross the "
                "host)")
        return "nccl"
    if backend != "gloo":
        raise ValueError(f"unsupported backend {backend!r} (nccl or gloo)")
    return "gloo"


def init_parallel_env(backend: Optional[str] = None):
    """Join the job the launcher started: one ``torch.distributed`` process
    group over every rank, on this rank's device. Idempotent. A one-rank
    job without ``MASTER_ADDR`` rendezvouses on a private store (port 0),
    so a single process can still hold a real group (NCCL at world size
    1)."""
    if dist.is_initialized():
        return
    rank, world = _rank_env(), _world_env()
    chosen = _pick_backend(backend, world)
    if torch.cuda.is_available():
        dev = torch.device("cuda",
                           _local_rank_env() % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=pg_timeout_s())
    addr = os.environ.get("MASTER_ADDR")
    if addr is None and world == 1:
        store = dist.TCPStore("127.0.0.1", 0, None, True, timeout=timeout,
                              wait_for_workers=False)
    else:
        if addr is None:
            raise RuntimeError(
                f"world size {world} without MASTER_ADDR / MASTER_PORT: "
                "start the job with python -m "
                "paddlepaddle_tpu_torch.distributed.launch")
        from .store import launcher_hosts_store

        port = int(os.environ.get("MASTER_PORT", "0"))
        store = dist.TCPStore(
            addr, port, None, rank == 0 and not launcher_hosts_store(),
            timeout=timeout, wait_for_workers=False)
        # a restarted worker must not read an earlier incarnation's keys
        store = dist.PrefixStore(
            f"pg/{os.environ.get('PADDLE_WORLD_VERSION', '0')}/"
            f"{os.environ.get('PADDLE_RESTART_NUM', '0')}", store)
    kw = {}
    if chosen == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(chosen, store=store, rank=rank, world_size=world,
                            timeout=timeout, **kw)
    # an orderly teardown at exit: a group left to the interpreter's
    # finalizers can abort the process ("terminate called without an
    # active exception") while its transport threads still run
    global _teardown_registered
    if not _teardown_registered:
        atexit.register(_destroy_at_exit)
        _teardown_registered = True


_teardown_registered = False


def _destroy_at_exit() -> None:
    if dist.is_initialized():
        try:
            dist.destroy_process_group()
        except Exception:
            pass


def is_initialized() -> bool:
    return dist.is_initialized()


def backend() -> Optional[str]:
    """The world group's backend, or None without a group."""
    return dist.get_backend() if dist.is_initialized() else None


def get_rank(group=None) -> int:
    """This process's rank (in ``group`` when given): the process group's
    answer once one exists, else the launcher's ``PADDLE_TRAINER_ID``, else
    0."""
    if dist.is_initialized():
        pg = getattr(group, "pg", group)
        return dist.get_rank(pg) if pg is not None else dist.get_rank()
    r = os.environ.get("PADDLE_TRAINER_ID")
    return int(r) if r is not None else 0


def get_world_size(group=None) -> int:
    if dist.is_initialized():
        pg = getattr(group, "pg", group)
        return (dist.get_world_size(pg) if pg is not None
                else dist.get_world_size())
    w = os.environ.get("PADDLE_TRAINERS_NUM")
    return int(w) if w is not None else 1


def parallel_device_count() -> int:
    """Cards this host sees (1 on a host without CUDA)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1
