"""paddle.distributed.rpc — simple RPC between workers (counterpart of
``paddlepaddle_tpu/distributed/rpc.py``).

Reference surface: python/paddle/distributed/rpc/ (init_rpc, rpc_sync,
rpc_async, shutdown, get_worker_info over a TensorPipe-like C++ agent).

Host-side control-plane RPC only: tensors move over the collectives, not
RPC, as in the reference, which uses RPC for control and CPU payloads. The
transport is pickle over TCP, one listener per worker; workers find each
other through the port's :class:`~.store.TCPStore`.
"""

from __future__ import annotations

import os
import pickle
import socket
import socketserver
import struct
import threading
from concurrent.futures import Future
from typing import Any, Dict, Optional

from .store import TCPStore

_state: Dict[str, Any] = {}


class WorkerInfo:
    def __init__(self, name: str, rank: int, ip: str, port: int):
        self.name = name
        self.rank = rank
        self.ip = ip
        self.port = port

    def __repr__(self):
        return f"WorkerInfo(name={self.name}, rank={self.rank}, ip={self.ip}, port={self.port})"


def _send_msg(sock, obj):
    payload = pickle.dumps(obj)
    sock.sendall(struct.pack(">Q", len(payload)) + payload)


def _recv_msg(f):
    head = f.read(8)
    if len(head) < 8:
        raise ConnectionError("rpc peer closed")
    (n,) = struct.unpack(">Q", head)
    return pickle.loads(f.read(n))


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        f = self.request.makefile("rb")
        try:
            fn, args, kwargs = _recv_msg(f)
            try:
                result = ("ok", fn(*args, **kwargs))
            except Exception as e:  # ship the exception back
                result = ("err", e)
            try:
                _send_msg(self.request, result)
            except Exception as e:  # result/exception not picklable
                _send_msg(self.request,
                          ("err", RuntimeError(f"rpc reply not picklable: {e}")))
        except ConnectionError:
            pass


def init_rpc(name: str, rank: Optional[int] = None, world_size: Optional[int] = None,
             master_endpoint: Optional[str] = None):
    """Start this worker's RPC agent and register it in the store."""
    rank = rank if rank is not None else int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    world_size = world_size or int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    from .store import launcher_hosts_store

    host_it = rank == 0 and not launcher_hosts_store()
    if master_endpoint:
        host, port = master_endpoint.rsplit(":", 1)
        store = TCPStore(host, int(port), is_master=host_it,
                         world_size=world_size)
    else:
        store = TCPStore(os.environ.get("MASTER_ADDR", "127.0.0.1"),
                         int(os.environ.get("MASTER_PORT", "0") or 0),
                         is_master=host_it, world_size=world_size)

    srv = socketserver.ThreadingTCPServer(("0.0.0.0", 0), _Handler)
    srv.daemon_threads = True
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()

    my_ip = os.environ.get("POD_IP", "127.0.0.1")
    store.set(f"rpc/{name}", f"{rank}|{my_ip}|{port}".encode())
    store.set(f"rpc/rank{rank}", name.encode())
    _state.update(name=name, rank=rank, world_size=world_size, store=store, server=srv)


def get_worker_info(name: Optional[str] = None) -> WorkerInfo:
    store: TCPStore = _state["store"]
    name = name or _state["name"]
    if not store.check(f"rpc/{name}"):
        raise KeyError(f"no rpc worker named {name!r} is registered")
    rank, ip, port = store.get(f"rpc/{name}").decode().split("|")
    return WorkerInfo(name, int(rank), ip, int(port))


def get_all_worker_infos():
    store: TCPStore = _state["store"]
    infos = []
    for r in range(_state["world_size"]):
        try:
            name = store.get(f"rpc/rank{r}").decode()
            infos.append(get_worker_info(name))
        except Exception:
            pass
    return infos


def rpc_sync(to: str, fn, args=(), kwargs=None, timeout: float = 120.0):
    info = get_worker_info(to)
    with socket.create_connection((info.ip, info.port), timeout=timeout) as s:
        _send_msg(s, (fn, tuple(args), kwargs or {}))
        status, payload = _recv_msg(s.makefile("rb"))
    if status == "err":
        raise payload
    return payload


def rpc_async(to: str, fn, args=(), kwargs=None, timeout: float = 120.0) -> Future:
    fut: Future = Future()

    def run():
        try:
            fut.set_result(rpc_sync(to, fn, args, kwargs, timeout))
        except Exception as e:
            fut.set_exception(e)

    threading.Thread(target=run, daemon=True).start()
    return fut


def shutdown():
    srv = _state.pop("server", None)
    if srv is not None:
        srv.shutdown()
        srv.server_close()
    _state.clear()
