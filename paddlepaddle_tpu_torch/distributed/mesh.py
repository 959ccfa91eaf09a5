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
        self._device_meshes: Dict[str, object] = {}

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

    def _axes(self, dim_names) -> List[int]:
        names = (dim_names,) if isinstance(dim_names, str) else dim_names
        return [self._dim_names.index(n) for n in names]

    def _moved(self, axes: List[int]) -> np.ndarray:
        """The mesh with ``axes`` moved last, in the given order."""
        return np.moveaxis(self.mesh, axes,
                           list(range(-len(axes), 0)))

    def slice_ranks(self, dim_name, rank: int) -> List[int]:
        """The ranks of ``dim_name``'s slice through ``rank``, in axis
        order; for a tuple of axes, their product's slice, row-major over
        the tuple (its first axis majorest)."""
        axes = self._axes(dim_name)
        where = np.argwhere(self.mesh == rank)[0]
        rest = tuple(int(where[i]) for i in range(self.ndim)
                     if i not in axes)
        return [int(r) for r in self._moved(axes)[rest].reshape(-1)]

    def _all_slices(self, dim_name) -> List[List[int]]:
        axes = self._axes(dim_name)
        n = int(np.prod([self._shape[a] for a in axes]))
        return [[int(r) for r in row]
                for row in self._moved(axes).reshape(-1, n)]

    def require_ranks(self, world: int) -> None:
        """Raise unless the mesh's entries are the ranks ``0..world-1``,
        each once: a job's ranks under the launcher, or the ranks a
        single-process plan starts (rank 0 the caller)."""
        if sorted(self._process_ids) != list(range(world)):
            raise ValueError(f"{self!r} must cover the job's {world} ranks "
                             f"exactly, got {self._process_ids}")

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
        self.require_ranks(dist.get_world_size())
        self._group_args = (backend, datetime.timedelta(
            seconds=timeout_s or pg_timeout_s()))
        self._groups = {}
        for name in self._dim_names:
            self._make_groups(name)

    def _make_groups(self, key) -> None:
        import torch.distributed as dist

        backend, td = self._group_args
        me = dist.get_rank()
        for ranks in self._all_slices(key):
            g = dist.new_group(ranks, timeout=td, backend=backend)
            if me in ranks:
                self._groups[key] = g

    def group(self, dim_name):
        """This rank's process group along ``dim_name`` (created on first
        use by :meth:`init_groups`). A tuple of axes names their product,
        whose groups are created on the first call for it (collective, as
        :meth:`init_groups` is)."""
        self.init_groups()
        key = dim_name if isinstance(dim_name, str) else (
            dim_name[0] if len(dim_name) == 1 else tuple(dim_name))
        if key not in self._groups:
            self._make_groups(key)
        return self._groups[key]

    def device_mesh(self, device_type: str = "cuda"):
        """A ``torch.distributed.DeviceMesh`` of ``device_type`` over the
        same ranks and axis names (collective on the first call for each
        device type)."""
        if device_type not in self._device_meshes:
            from torch.distributed.device_mesh import DeviceMesh

            self._device_meshes[device_type] = DeviceMesh(
                device_type, self.mesh.tolist(),
                mesh_dim_names=tuple(self._dim_names))
        return self._device_meshes[device_type]


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
