"""TCPStore, the rendezvous key-value store (counterpart of
``paddlepaddle_tpu/distributed/store.py`` :93).

The reference builds its own C++ server (``native/tcp_store.cpp``) with g++;
the port keeps the reference's API and semantics over
``torch.distributed.TCPStore``, which is the same design (the master hosts
a socket server, every rank connects a client; blocking ``get``, atomic
``add``) and needs no build. ``set`` / ``get`` retry transient failures
under the reference's policy; ``add`` is never retried (rank assignment
relies on exactly-once increments); ``wait`` raises ``TimeoutError``.
A blocking ``get`` or ``wait`` is a comm task (:mod:`.comm_task`), so a
watchdog timeout names the key a rank waits on.
"""

from __future__ import annotations

import datetime
import os
import threading
from typing import Optional

import torch.distributed as dist

from ..resilience.chaos import ChaosError, chaos_point  # noqa: F401
from ..resilience.retry import RetryPolicy, call_with_retry

# the reference's policy (store.py:35-37): a fast transport error retries,
# an attempt that already burned the blocking timeout surfaces at once
_STORE_RETRY = RetryPolicy(
    max_attempts=3, base_delay=0.05, max_delay=1.0, deadline=10.0,
    retry_on=(OSError, TimeoutError, RuntimeError))


def _connect_policy(timeout: float) -> RetryPolicy:
    return RetryPolicy(max_attempts=30, base_delay=0.1, max_delay=2.0,
                       deadline=timeout)


class TCPStore:
    """``is_master=True`` hosts the server in this process and connects a
    client to it (rank 0 uses the store too, as in the reference);
    ``port=0`` binds a free port, read back as ``self.port``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 is_master: bool = False, world_size: int = 1,
                 timeout: float = 300.0):
        self._timeout = float(timeout)
        td = datetime.timedelta(seconds=self._timeout)

        def _connect():
            chaos_point("store.connect")
            return dist.TCPStore(host, int(port), None, bool(is_master),
                                 timeout=td, wait_for_workers=False)

        self._store = (_connect() if is_master else call_with_retry(
            _connect, policy=_connect_policy(self._timeout),
            name="store.connect"))
        self.port = int(self._store.port)
        self.world_size = int(world_size)

    @property
    def torch_store(self) -> dist.Store:
        """The underlying ``torch.distributed`` store (a process group can
        rendezvous on it)."""
        return self._store

    # -- reference API -------------------------------------------------------
    def set(self, key: str, value) -> None:
        data = value if isinstance(value, bytes) else str(value).encode()

        def _set():
            chaos_point("store.set")
            self._store.set(key, data)

        call_with_retry(_set, policy=_STORE_RETRY, name="store.set")

    def get(self, key: str) -> bytes:
        """The value of ``key``, waiting for it up to the store's timeout."""

        from .comm_task import comm_task

        def _get():
            chaos_point("store.get")
            return bytes(self._store.get(key))

        # a blocking get is a comm task: a hang names the key it waits on
        with comm_task(f"store.get({key!r})", group="store"):
            return call_with_retry(_get, policy=_STORE_RETRY,
                                   name="store.get")

    def add(self, key: str, amount: int = 1) -> int:
        return int(self._store.add(key, int(amount)))

    def check(self, keys) -> bool:
        keys = [keys] if isinstance(keys, str) else list(keys)
        return bool(self._store.check(keys))

    def delete_key(self, key: str) -> bool:
        """Erase a key; True if it existed."""
        return bool(self._store.delete_key(key))

    def wait(self, keys, timeout: Optional[float] = None) -> None:
        keys = [keys] if isinstance(keys, str) else list(keys)
        t = self._timeout if timeout is None else float(timeout)
        from .comm_task import comm_task

        try:
            with comm_task(f"store.wait({keys!r})", group="store"):
                self._store.wait(keys, datetime.timedelta(seconds=t))
        except dist.DistStoreError as e:
            raise TimeoutError(f"TCPStore.wait timed out on {keys}") from e


_global_store: Optional[TCPStore] = None
_global_store_lock = threading.Lock()


def create_or_get_global_tcp_store() -> TCPStore:
    """The job's store (reference store.py:343): rank 0 hosts it unless the
    launcher does (``PADDLE_LAUNCH_STORE``), every other rank connects to
    ``MASTER_ADDR:MASTER_PORT``. Thread-safe."""
    global _global_store
    with _global_store_lock:
        if _global_store is None:
            host = os.environ.get("MASTER_ADDR", "127.0.0.1")
            port = int(os.environ.get("MASTER_PORT", "0") or 0)
            rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
            world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
            _global_store = TCPStore(
                host, port,
                is_master=(rank == 0 and not launcher_hosts_store()),
                world_size=world)
        return _global_store


def launcher_hosts_store() -> bool:
    """True when an external launcher hosts the ``MASTER_PORT`` store, so
    rank 0 connects as a client; ``"0"`` / ``"false"`` opt out."""
    return os.environ.get(
        "PADDLE_LAUNCH_STORE", "").strip().lower() in ("1", "true", "yes")
