"""``ProcessMesh``, a named-axis grid of ranks (counterpart of
``paddlepaddle_tpu/distributed/mesh.py`` :17-122), with ``set_mesh`` /
``get_mesh`` / ``auto_mesh``.

The reference's mesh maps onto a ``jax.sharding.Mesh`` of devices driven by
one process. Here each entry is a rank of the ``torch.distributed`` job,
and the mesh makes one process group per axis slice
(:meth:`ProcessMesh.group`): the ranks that differ only along that axis.
``torch.distributed.new_group`` is collective, so the first call creates
every slice's group of every axis on every rank, in one order. A mesh can
also hand out a ``torch.distributed.DeviceMesh`` over the same ranks
(:meth:`ProcessMesh.device_mesh`).
"""

from __future__ import annotations

import datetime
from typing import Dict, List, Optional, Sequence

import numpy as np


class ProcessMesh:
    def __init__(self, mesh=None, dim_names: Optional[Sequence[str]] = None,
                 shape: Optional[Sequence[int]] = None):
        if mesh is None and shape is not None:
            mesh = np.arange(int(np.prod(shape))).reshape(shape)
        arr = np.asarray(mesh)
        self._process_ids = arr.reshape(-1).tolist()
        self._shape = list(arr.shape)
        if dim_names is None:
            dim_names = [f"d{i}" for i in range(arr.ndim)]
        self._dim_names = list(dim_names)
        self._groups: Optional[Dict[str, object]] = None
        self._device_mesh = None

    # -- reference API ------------------------------------------------------
    @property
    def shape(self) -> List[int]:
        return list(self._shape)

    @property
    def ndim(self) -> int:
        return len(self._shape)

    @property
    def process_ids(self) -> List[int]:
        return list(self._process_ids)

    @property
    def dim_names(self) -> List[str]:
        return list(self._dim_names)

    @property
    def mesh(self):
        return np.asarray(self._process_ids).reshape(self._shape)

    def get_dim_size(self, dim_name: str) -> int:
        return self._shape[self._dim_names.index(dim_name)]

    def get_rank_by_dim_and_process_id(self, dim_name, process_id):
        axis = self._dim_names.index(dim_name)
        coords = np.argwhere(self.mesh == process_id)
        return int(coords[0][axis]) if len(coords) else -1

    def __eq__(self, other):
        return (
            isinstance(other, ProcessMesh)
            and self._shape == other._shape
            and self._process_ids == other._process_ids
            and self._dim_names == other._dim_names
        )

    def __hash__(self):
        return hash((tuple(self._shape), tuple(self._process_ids),
                     tuple(self._dim_names)))

    def __repr__(self):
        return f"ProcessMesh(shape={self._shape}, dim_names={self._dim_names})"

    @staticmethod
    def from_spec(spec: str) -> "ProcessMesh":
        """``ProcessMesh.from_spec("dp2mp4")``: axis order in the string is
        the mesh axis order (``mp`` last, so tensor-parallel peers are
        neighbouring ranks)."""
        from .shard_plan import mesh_from_spec

        return mesh_from_spec(spec)

    # -- ranks and groups -----------------------------------------------------
    def coords(self, rank: int) -> Dict[str, int]:
        """``{axis: index}`` of ``rank`` in the mesh."""
        where = np.argwhere(self.mesh == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in {self!r}")
        return {n: int(i) for n, i in zip(self._dim_names, where[0])}

    def slice_ranks(self, dim_name: str, rank: int) -> List[int]:
        """The ranks of ``dim_name``'s slice through ``rank``, in axis
        order."""
        axis = self._dim_names.index(dim_name)
        idx = list(np.argwhere(self.mesh == rank)[0])
        idx[axis] = slice(None)
        return [int(r) for r in self.mesh[tuple(idx)]]

    def _all_slices(self, dim_name: str) -> List[List[int]]:
        axis = self._dim_names.index(dim_name)
        moved = np.moveaxis(self.mesh, axis, -1)
        return [[int(r) for r in row]
                for row in moved.reshape(-1, moved.shape[-1])]

    def init_groups(self, backend: Optional[str] = None,
                    timeout_s: Optional[float] = None) -> None:
        """Create a process group for every slice of every axis (collective:
        every rank of the job calls it, in the same order). Idempotent."""
        import torch.distributed as dist

        from .env import pg_timeout_s

        if self._groups is not None:
            return
        if not dist.is_initialized():
            raise RuntimeError("ProcessMesh.init_groups needs an initialized "
                               "process group (init_parallel_env)")
        world = dist.get_world_size()
        if sorted(self._process_ids) != list(range(world)):
            raise ValueError(f"{self!r} must cover the job's {world} ranks "
                             f"exactly, got {self._process_ids}")
        me = dist.get_rank()
        td = datetime.timedelta(seconds=timeout_s or pg_timeout_s())
        groups = {}
        for name in self._dim_names:
            for ranks in self._all_slices(name):
                g = dist.new_group(ranks, timeout=td, backend=backend)
                if me in ranks:
                    groups[name] = g
        self._groups = groups

    def group(self, dim_name: str):
        """This rank's process group along ``dim_name`` (created on first
        use by :meth:`init_groups`)."""
        self.init_groups()
        return self._groups[dim_name]

    def device_mesh(self, device_type: str = "cuda"):
        """A ``torch.distributed.DeviceMesh`` over the same ranks and axis
        names (collective on first call)."""
        if self._device_mesh is None:
            from torch.distributed.device_mesh import DeviceMesh

            self._device_mesh = DeviceMesh(
                device_type, self.mesh.tolist(),
                mesh_dim_names=tuple(self._dim_names))
        return self._device_mesh


_global_mesh: Optional[ProcessMesh] = None


def set_mesh(mesh: ProcessMesh):
    global _global_mesh
    _global_mesh = mesh


def get_mesh() -> Optional[ProcessMesh]:
    return _global_mesh


def auto_mesh(**axis_sizes) -> ProcessMesh:
    """A mesh over every rank of the job, e.g. ``auto_mesh(dp=2, mp=4)``."""
    from .env import get_world_size

    names = list(axis_sizes.keys())
    sizes = [axis_sizes[n] for n in names]
    n = int(np.prod(sizes))
    if n != get_world_size():
        raise ValueError(f"mesh {sizes} != #ranks {get_world_size()}")
    return ProcessMesh(np.arange(n).reshape(sizes), names)
