"""Elastic membership: scale up and down over the job's TCP store
(counterpart of ``paddlepaddle_tpu/distributed/fleet/elastic/__init__.py``
:1-188).

Reference surface: python/paddle/distributed/fleet/elastic/manager.py:125,
237-316 (ElasticManager: hosts register etcd leases, watch membership, on
scale-up/down rewrite endpoints and relaunch trainers; entry
python/paddle/distributed/elastic.py).

The port's TCPStore (:mod:`..store`, over ``torch.distributed.TCPStore``)
replaces etcd. Each node claims a slot by atomic add and heartbeats a
COUNTER under its key; the manager deems a node alive while its counter
keeps advancing (judged on the observer's clock, immune to wall-clock skew
between hosts). When the alive set changes and its size is inside the
allowed np range, the manager commits a new versioned world (member list)
to the store under ``elastic/world``; launchers watch the version and
relaunch their workers with the new world size, which resume from the
newest checkpoint (:mod:`...checkpoint`, ``CheckpointManager``): the same
restart-plus-state contract as the reference. The launcher
(:mod:`...launch`, ``--nnodes lo:hi``) drives both halves.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Callable, List, Optional, Tuple

_NODES_COUNT = "elastic/nodes_count"
_NODE_KEY = "elastic/node/{}"
_HB_KEY = "elastic/hb/{}"
_WORLD_KEY = "elastic/world"


class ElasticNode:
    """One participating host: registers itself and heartbeats a counter."""

    def __init__(self, store, node_id: str, heartbeat_interval: float = 1.0):
        self.store = store
        self.node_id = node_id
        self.heartbeat_interval = heartbeat_interval
        self._beat = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def register(self) -> int:
        slot = int(self.store.add(_NODES_COUNT, 1)) - 1
        self.store.set(_NODE_KEY.format(slot), self.node_id.encode())
        self.heartbeat()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return slot

    def heartbeat(self):
        self._beat += 1
        self.store.set(_HB_KEY.format(self.node_id), str(self._beat).encode())

    def _loop(self):
        while not self._stop.wait(self.heartbeat_interval):
            self.heartbeat()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # -- worker-side world watching -----------------------------------------
    def current_world(self) -> Tuple[int, List[str]]:
        return ElasticManager.read_world(self.store)

    def world_changed(self, known_version: int) -> bool:
        version, _ = self.current_world()
        return version != known_version


class ElasticManager:
    """Membership watcher (reference ElasticManager): scans node heartbeats,
    commits new worlds on scale events within [min_np, max_np]."""

    def __init__(self, store, np_range: Tuple[int, int],
                 heartbeat_timeout: float = 5.0, poll_interval: float = 0.5,
                 on_scale: Optional[Callable[[int, List[str]], None]] = None):
        self.store = store
        self.min_np, self.max_np = np_range
        self.heartbeat_timeout = heartbeat_timeout
        self.poll_interval = poll_interval
        self.on_scale = on_scale
        self._last_seen = {}  # node_id -> (beat_value, local_monotonic)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.version = 0
        self.members: List[str] = []

    # -- store protocol ------------------------------------------------------
    @staticmethod
    def read_world(store) -> Tuple[int, List[str]]:
        if not store.check(_WORLD_KEY):
            return 0, []
        rec = json.loads(store.get(_WORLD_KEY).decode())
        return int(rec["version"]), list(rec["nodes"])

    def _registered_nodes(self) -> List[str]:
        if not self.store.check(_NODES_COUNT):
            return []
        n = int(self.store.add(_NODES_COUNT, 0))
        out = []
        for i in range(n):
            key = _NODE_KEY.format(i)
            if self.store.check(key):
                nid = self.store.get(key).decode()
                if nid not in out:
                    out.append(nid)
        return out

    def alive_nodes(self) -> List[str]:
        """A node is alive while its heartbeat counter keeps advancing
        (observer-side timing, no cross-host clock comparison)."""
        now = time.monotonic()
        alive = []
        for nid in self._registered_nodes():
            key = _HB_KEY.format(nid)
            if not self.store.check(key):
                continue
            beat = int(self.store.get(key).decode())
            prev = self._last_seen.get(nid)
            if prev is None or prev[0] != beat:
                self._last_seen[nid] = (beat, now)
                alive.append(nid)
            elif now - prev[1] <= self.heartbeat_timeout:
                alive.append(nid)
        return alive

    def _commit(self, nodes: List[str]):
        self.version += 1
        self.members = list(nodes)
        self.store.set(_WORLD_KEY, json.dumps(
            {"version": self.version, "nodes": self.members}).encode())
        if self.on_scale is not None:
            try:
                self.on_scale(self.version, self.members)
            except Exception:
                pass

    # -- watch loop ----------------------------------------------------------
    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.poll_interval):
            self.scan_once()

    def scan_once(self):
        alive = self.alive_nodes()
        # compare the world we WOULD commit (capped at max_np) — comparing
        # the raw alive set would re-commit an identical world every poll
        # whenever alive > max_np, relaunch-storming the workers
        want = sorted(alive)[: self.max_np]
        if want == sorted(self.members):
            return
        if len(alive) < self.min_np:
            # below the floor: keep the old world — the job blocks/restarts
            # rather than committing an undersized membership
            return
        self._commit(want)

    def wait_for_np(self, min_np: Optional[int] = None,
                    timeout: float = 60.0) -> Tuple[int, List[str]]:
        """Block until at least min_np nodes are alive; commit + return the
        world (the rendezvous barrier of the reference's elastic start)."""
        want = self.min_np if min_np is None else min_np
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            alive = self.alive_nodes()
            if len(alive) >= want:
                world = sorted(alive)[: self.max_np]
                if world != sorted(self.members):
                    self._commit(world)
                return self.version, self.members
            time.sleep(self.poll_interval)
        raise TimeoutError(
            f"elastic: only {len(self.alive_nodes())} nodes alive, "
            f"need {want}")

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
