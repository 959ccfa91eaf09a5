"""``python -m paddlepaddle_tpu_torch.distributed.launch`` — the multi-process
launcher (counterpart of ``paddlepaddle_tpu/distributed/launch/__init__.py``
:29-290 and its ``__main__.py``; one module here, run with ``-m``), and
:func:`spawn`.

``launch`` starts ``--nproc_per_node`` workers of a script with the
reference's environment (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_LOCAL_RANK``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` / ``MASTER_PORT``, plus ``LOCAL_WORLD_SIZE``), hosts the
rendezvous store itself (``PADDLE_LAUNCH_STORE=1``: it outlives worker
restarts), and watches them: a worker that fails is restarted up to
``--max_restarts`` times (``PADDLE_RESTART_NUM`` counts its incarnations),
after which the job is stopped with the worker's exit code; SIGTERM drains
the workers and restarts none.

Elastic membership (``--nnodes lo:hi``, reference
``launch/__init__.py``:124-175, :237-262, over
:mod:`.fleet.elastic`): node 0's launcher hosts the store and runs the
``ElasticManager``; every node's launcher registers an ``ElasticNode`` and
heartbeats. The first committed world sets the world size; a node's index
is its place in the member list, so ranks stay contiguous. Workers get
``PADDLE_WORLD_VERSION``. On a scale event (a node's heartbeat stops, or a
node joins) every local worker is stopped and relaunched into the new
world, where it resumes from the newest checkpoint; a node outside the
committed world (past ``hi``) runs no workers until a world includes it.
A silent node counts as alive for the manager's 5 s. The first world
waits up to ``_LAST_CALL_S`` (30 s) for all ``hi`` nodes before it settles
for ``lo``, so nodes started together begin in one world instead of a
world of ``lo`` that the others' joins then resize (the JAX package
commits as soon as ``lo`` nodes are alive; ROADMAP lists the divergence).

``spawn(func, args, nprocs)`` runs ``func(*args)`` in ``nprocs`` fresh
processes (the multiprocessing spawn context: nothing of the parent's CUDA
or other state is forked) with the same environment and a store the parent
hosts, joins them with a timeout, and returns each rank's return value. A
rank that raises, exits or outlives the timeout fails the call, and every
other rank is stopped.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time

# a SIGTERMed launcher (preemption) exits 143 itself after draining workers
_SIGNAL_EXIT = {signal.SIGTERM: 143, signal.SIGINT: 130}
# how long the first elastic world waits for all hi nodes once node 0 is
# up (torchrun's rendezvous waits as long past its minimum); a node that
# registered waits 60 s for that world
_LAST_CALL_S = 30.0


def _parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="paddlepaddle_tpu_torch.distributed.launch",
        description="launch distributed training")
    p.add_argument("--nnodes", type=str, default="1",
                   help="number of nodes, or range 'lo:hi' for elastic")
    p.add_argument("--node_rank", type=int,
                   default=int(os.environ.get("PADDLE_NODE_RANK", "0")))
    p.add_argument("--nproc_per_node", type=int, default=1)
    p.add_argument("--master", type=str,
                   default=os.environ.get("PADDLE_MASTER", ""),
                   help="host:port of the rendezvous store (node 0 hosts it)")
    p.add_argument("--devices", "--gpus", type=str, default=None)
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--max_restarts", type=int, default=0)
    p.add_argument("--run_mode", type=str, default="collective")
    p.add_argument("--obs_export", action="store_true",
                   default=os.environ.get("PADDLE_OBS_EXPORT", "").lower()
                   in ("1", "true", "yes", "on"),
                   help="start a telemetry exporter in every worker")
    p.add_argument("--obs_port", type=int, default=0,
                   help="base exporter port; worker rank r listens on "
                        "obs_port + r")
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _worker_env(args, local_rank: int, world_size: int, master_addr,
                master_port, node_index: int = None):
    env = dict(os.environ)
    node = args.node_rank if node_index is None else node_index
    rank = node * args.nproc_per_node + local_rank
    env.update({
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_TRAINERS_NUM": str(world_size),
        "PADDLE_LOCAL_RANK": str(local_rank),
        "PADDLE_NNODES": str(args.nnodes),
        "RANK": str(rank),
        "WORLD_SIZE": str(world_size),
        "LOCAL_RANK": str(local_rank),
        "LOCAL_WORLD_SIZE": str(args.nproc_per_node),
        "MASTER_ADDR": master_addr,
        "MASTER_PORT": str(master_port),
        # the launcher hosts the rendezvous store (it outlives worker
        # restarts); every worker connects as a client, rank 0 included
        "PADDLE_LAUNCH_STORE": "1",
    })
    if args.obs_export:
        env["PADDLE_OBS_EXPORT"] = "1"
        env.setdefault("PADDLE_OBS_METRICS", "1")
        if args.obs_port:
            env["PADDLE_OBS_PORT"] = str(args.obs_port)
    if args.devices:
        env["CUDA_VISIBLE_DEVICES"] = args.devices
    # the package importable in workers even when not installed
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _count_scale_event() -> None:
    from ..observability import safe_inc

    safe_inc("paddle_launch_scale_events_total",
             "elastic worlds the launch watch loop relaunched its workers "
             "into")


def _count_restart(local_rank: int, rc: int) -> None:
    """Restart events feed the observability registry."""
    from ..observability import safe_inc

    safe_inc("paddle_launch_restarts_total",
             "workers respawned by the launch watch loop, by exit code",
             exit_code=rc)


def _elastic_start(args, store, master_addr, master_port, lo, hi):
    """Register this node (node 0 also starts the manager) and wait for the
    first committed world: ``(node, manager or None, version, members)``."""
    from .fleet.elastic import ElasticManager, ElasticNode
    from .store import TCPStore

    # a non-master node routinely dials before the master's store is up:
    # the connect retry backs off under this timeout
    client = store or TCPStore(master_addr, master_port, timeout=60.0)
    enode = ElasticNode(client, node_id=f"node{args.node_rank}")
    enode.register()
    manager = None
    if store is not None:  # the master node runs the membership watcher
        manager = ElasticManager(client, (lo, hi))
        deadline = time.monotonic() + _LAST_CALL_S
        while time.monotonic() < deadline and \
                len(manager.alive_nodes()) < hi:
            time.sleep(manager.poll_interval)
        manager.wait_for_np(lo)
        manager.start()
    deadline = time.time() + 60
    while time.time() < deadline:
        version, members = ElasticManager.read_world(client)
        if version > 0:
            return enode, manager, version, members
        time.sleep(0.2)
    raise RuntimeError("elastic rendezvous: no world committed within 60s "
                       "(is the master node up?)")


def launch(argv=None) -> int:
    args = _parse_args(argv)
    # PADDLE_OBS_EXPORT in the launcher's own environment starts an
    # exporter here at import, on rank 0's port (obs_port + 0): the
    # launcher serves no telemetry, so it lets the port go before any
    # worker starts
    from ..observability import stop_exporter

    stop_exporter()
    spec = str(args.nnodes)
    lo = int(spec.split(":")[0])
    hi = int(spec.split(":")[1]) if ":" in spec else lo
    elastic = hi > lo
    world_size = lo * args.nproc_per_node
    if args.master:
        master_addr, master_port = args.master.split(":")
        master_port = int(master_port)
    else:
        master_addr, master_port = "127.0.0.1", 0
    store = None
    if args.node_rank == 0:
        from .store import TCPStore

        store = TCPStore(master_addr if args.master else "127.0.0.1",
                         master_port, is_master=True, world_size=world_size)
        master_port = store.port
    me = f"node{args.node_rank}"
    enode, manager, world_version, members = None, None, 0, []
    if elastic:
        enode, manager, world_version, members = _elastic_start(
            args, store, master_addr, master_port, lo, hi)
        world_size = len(members) * args.nproc_per_node
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)

    procs = {}
    restarts = {i: 0 for i in range(args.nproc_per_node)}

    def start(local_rank):
        node_index = members.index(me) if enode is not None else None
        env = _worker_env(args, local_rank, world_size, master_addr,
                          master_port, node_index=node_index)
        env["PADDLE_WORLD_VERSION"] = str(world_version)
        # incarnation counter: a script tells a fresh start from a resume
        env["PADDLE_RESTART_NUM"] = str(restarts[local_rank])
        cmd = [sys.executable, args.training_script] + args.training_script_args
        stdout = None
        if args.log_dir:
            stdout = open(os.path.join(
                args.log_dir, f"workerlog.{local_rank}"), "ab")
        procs[local_rank] = subprocess.Popen(
            cmd, env=env, stdout=stdout,
            stderr=subprocess.STDOUT if stdout else None)

    def start_all():
        if enode is not None and me not in members:
            print(f"[launch] {me} is outside elastic world "
                  f"v{world_version} {members}; waiting", file=sys.stderr)
            return
        for i in range(args.nproc_per_node):
            start(i)

    start_all()

    stopping = {"requested": False, "code": 0}

    def shutdown(signum=None, frame=None):
        if signum is not None and not stopping["requested"]:
            # preempted or cancelled: forward the TERM, give the workers
            # the grace window, restart none
            stopping["requested"] = True
            stopping["code"] = _SIGNAL_EXIT.get(signum, 1)
            print(f"[launch] signal {signum}: draining workers, no restarts",
                  file=sys.stderr)
        for p in procs.values():
            if p.poll() is None:
                p.terminate()
        t0 = time.time()
        while time.time() - t0 < 10 and any(p.poll() is None
                                             for p in procs.values()):
            time.sleep(0.2)
        for p in procs.values():
            if p.poll() is None:
                p.kill()

    signal.signal(signal.SIGTERM, shutdown)
    signal.signal(signal.SIGINT, shutdown)

    exit_code = 0
    try:
        while procs or (enode is not None and me not in members):
            if stopping["requested"]:
                return stopping["code"]
            time.sleep(0.5)
            if stopping["requested"]:
                return stopping["code"]
            # elastic scale event: the membership changed, so every local
            # worker is relaunched into the new world (reference
            # manager.py:237-316)
            changed = False
            if enode is not None:
                try:
                    changed = enode.world_changed(world_version)
                except (RuntimeError, OSError):
                    # node 0's store is gone: the job's master has ended;
                    # this node's workers end on their own and are reaped
                    if me not in members:
                        return exit_code
            if changed:
                from .fleet.elastic import ElasticManager

                world_version, members = ElasticManager.read_world(
                    enode.store)
                world_size = len(members) * args.nproc_per_node
                print(f"[launch] elastic scale event v{world_version}: "
                      f"{len(members)} nodes; relaunching workers",
                      file=sys.stderr, flush=True)
                _count_scale_event()
                for p in procs.values():
                    if p.poll() is None:
                        p.terminate()
                for p in procs.values():
                    try:
                        p.wait(timeout=10)
                    except subprocess.TimeoutExpired:
                        p.kill()
                        p.wait()
                procs.clear()
                start_all()
                continue
            for lr, p in list(procs.items()):
                if stopping["requested"]:
                    return stopping["code"]
                rc = p.poll()
                if rc is None:
                    continue
                if rc == 0:
                    procs.pop(lr)
                elif restarts[lr] < args.max_restarts:
                    restarts[lr] += 1
                    print(f"[launch] worker {lr} exited {rc}; restart "
                          f"{restarts[lr]}/{args.max_restarts}",
                          file=sys.stderr)
                    _count_restart(lr, rc)
                    start(lr)
                else:
                    print(f"[launch] worker {lr} failed with {rc}; aborting "
                          "job", file=sys.stderr)
                    exit_code = rc
                    shutdown()
                    return exit_code
    finally:
        shutdown()
        if manager is not None:
            manager.stop()
        if enode is not None:
            enode.stop()
        del store
    return exit_code


# ---------------------------------------------------------------------------
# spawn
# ---------------------------------------------------------------------------


def _spawn_entry(func, args, env, rank, queue):
    os.environ.update(env)
    try:
        out = func(*args)
        queue.put((rank, True, out))
    except BaseException:  # noqa: BLE001 — reported to the parent
        import traceback

        queue.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def spawn(func, args=(), nprocs=1, join=True, daemon=False, **options):
    """Run ``func(*args)`` in ``nprocs`` processes with the launcher's
    per-rank environment and return ``[rank 0's value, rank 1's, ...]``.

    Options: ``timeout`` (seconds to wait for every rank, default 600),
    ``pg_timeout`` (the ranks' process-group timeout, default 120), ``env``
    (extra variables for every rank), ``local_world_size`` (ranks counted
    as sharing this host's cards; default ``nprocs``). The parent hosts the
    rendezvous store (port 0, so concurrent jobs never collide). A rank
    that raises or exits non-zero, or a job past ``timeout``, stops every
    rank and raises ``RuntimeError`` (``TimeoutError``) with the failing
    rank's traceback. ``join=False`` is not supported: the call owns its
    processes."""
    import multiprocessing as mp
    import queue as _queue

    from .store import TCPStore

    if not join:
        raise ValueError("spawn(join=False) is not supported: the call "
                         "joins and stops every process it starts")
    timeout = float(options.get("timeout", 600.0))
    store = TCPStore(is_master=True, world_size=nprocs)
    base = {
        "PADDLE_TRAINERS_NUM": str(nprocs), "WORLD_SIZE": str(nprocs),
        "LOCAL_WORLD_SIZE": str(options.get("local_world_size", nprocs)),
        "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(store.port),
        "PADDLE_LAUNCH_STORE": "1",
        "PADDLE_PG_TIMEOUT_S": str(options.get("pg_timeout", 120.0)),
    }
    base.update({k: str(v) for k, v in options.get("env", {}).items()})
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = []
    for rank in range(nprocs):
        env = dict(base, PADDLE_TRAINER_ID=str(rank), RANK=str(rank),
                   PADDLE_LOCAL_RANK=str(rank), LOCAL_RANK=str(rank))
        p = ctx.Process(target=_spawn_entry,
                        args=(func, tuple(args), env, rank, q),
                        daemon=daemon)
        p.start()
        procs.append(p)
    results, failure = {}, None
    deadline = time.monotonic() + timeout
    try:
        while len(results) < nprocs and failure is None:
            try:
                rank, ok, val = q.get(timeout=0.5)
            except _queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in results]
                if dead:
                    # give a dying rank's traceback a moment to arrive
                    try:
                        rank, ok, val = q.get(timeout=5)
                    except _queue.Empty:
                        failure = (f"rank {dead[0][0]} exited with code "
                                   f"{dead[0][1]} without a result")
                        break
                elif time.monotonic() > deadline:
                    failure = TimeoutError(
                        f"spawn: ranks {sorted(set(range(nprocs)) - set(results))} "
                        f"did not finish within {timeout:g} s")
                    break
                else:
                    continue
            if ok:
                results[rank] = val
            else:
                failure = f"rank {rank} failed:\n{val}"
    finally:
        for p in procs:
            if failure is None:
                p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        q.close()
        del store
    if isinstance(failure, BaseException):
        raise failure
    if failure is not None:
        raise RuntimeError(f"spawn: {failure}")
    return [results[r] for r in range(nprocs)]


if __name__ == "__main__":
    sys.exit(launch())
