"""Hybrid-parallel topology (counterpart of
``paddlepaddle_tpu/distributed/fleet/topology.py``; reference:
python/paddle/distributed/fleet/base/topology.py — CommunicateTopology
:70-81, HybridCommunicateGroup :189).

The five canonical axes ``["data", "pipe", "sharding", "sep", "model"]``
map onto one :class:`~..mesh.ProcessMesh` with axes ``("dp", "pp",
"sharding", "sep", "mp")``. :class:`CommunicateTopology` is the
reference's rank <-> coordinate table (row-major over the axes).

The reference is one controller that sees the whole mesh, so its rank
accessors report 0 (:74-80). In the port one process is one rank. In a
process with no process group the port answers as the reference does.
Under a group spanning the topology's ranks each accessor gives this
rank's coordinate, and ``get_*_parallel_group()`` returns a
:class:`~..collective.Group` over this rank's slice of that axis (the
ranks ``CommunicateTopology.get_comm_list`` puts with it) holding a real
process group: the mesh's group of that axis, which the mpu layers use
too once ``fleet.init`` has set the mesh.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..collective import Group
from ..mesh import ProcessMesh


class ParallelMode:
    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3
    SEGMENT_PARALLEL = 4


_AXIS_TO_MESH_NAME = {
    "data": "dp", "pipe": "pp", "sharding": "sharding", "sep": "sep",
    "model": "mp",
}


class CommunicateTopology:
    def __init__(self, hybrid_group_names=("data", "pipe", "sharding", "sep",
                                           "model"),
                 dims=(1, 1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = None
        self._world = np.arange(int(np.prod(self._dims))).reshape(self._dims)

    def get_hybrid_group_names(self):
        return list(self._parallel_names)

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return int(self._world.size)

    def get_rank(self, **kwargs):
        coords = [kwargs[n] for n in self._parallel_names]
        return int(self._world[tuple(coords)])

    def get_coord(self, rank):
        coords = np.argwhere(self._world == rank)[0]
        return dict(zip(self._parallel_names, (int(c) for c in coords)))

    def get_axis_list(self, axis_name, index):
        axis = self._parallel_names.index(axis_name)
        taken = np.take(self._world, index, axis=axis)
        return [int(r) for r in taken.reshape(-1)]

    def get_comm_list(self, axis_name):
        axis = self._parallel_names.index(axis_name)
        moved = np.moveaxis(self._world, axis, -1).reshape(-1,
                                                           self._dims[axis])
        return [[int(r) for r in row] for row in moved]


class HybridCommunicateGroup:
    """Per-axis rank / size / group accessors (reference topology.py:189);
    this rank's coordinate under a group, 0 without one (module doc)."""

    def __init__(self, topology: CommunicateTopology):
        import torch.distributed as dist

        self._topo = topology
        world = dist.get_world_size() if dist.is_initialized() else 1
        live = world > 1
        if live and world != topology.world_size():
            dims = dict(zip(topology.get_hybrid_group_names(),
                            topology._dims))
            raise ValueError(
                f"a hybrid topology of {topology.world_size()} ranks "
                f"({dims}) in a job of {world}: the degrees must multiply "
                "to the job's world size")
        self._live = live
        self.global_rank = dist.get_rank() if live else 0
        self._coord = topology.get_coord(self.global_rank)
        self._dp_degree = topology.get_dim("data")
        self._pp_degree = topology.get_dim("pipe")
        self._sharding_degree = topology.get_dim("sharding")
        self._sep_degree = topology.get_dim("sep")
        self._mp_degree = topology.get_dim("model")
        names = topology.get_hybrid_group_names()
        self._mesh = ProcessMesh(
            shape=[topology.get_dim(n) for n in names],
            dim_names=[_AXIS_TO_MESH_NAME[n] for n in names])
        self._groups: Dict[str, Group] = {}
        if live:
            self._mesh.init_groups()
        for name, ax in _AXIS_TO_MESH_NAME.items():
            if live:
                ranks = next(row for row in topology.get_comm_list(name)
                             if self.global_rank in row)
                self._groups[ax] = Group(ranks=ranks, axis_name=ax,
                                         pg=self._mesh.group(ax))
            else:
                self._groups[ax] = Group(
                    ranks=list(range(topology.get_dim(name))), axis_name=ax)

    # -- mesh bridge --------------------------------------------------------
    @property
    def mesh(self) -> ProcessMesh:
        return self._mesh

    def topology(self):
        return self._topo

    @property
    def live(self) -> bool:
        """True when the groups are process groups of this job's ranks."""
        return self._live

    def get_parallel_mode(self):
        if self._pp_degree > 1:
            return ParallelMode.PIPELINE_PARALLEL
        if self._sharding_degree > 1:
            return ParallelMode.SHARDING_PARALLEL
        if self._mp_degree > 1:
            return ParallelMode.TENSOR_PARALLEL
        if self._sep_degree > 1:
            return ParallelMode.SEGMENT_PARALLEL
        return ParallelMode.DATA_PARALLEL

    def _src(self, ax: str) -> int:
        return self._groups[ax].ranks[0] if self._live else 0

    # -- per-axis accessors (reference API names) ---------------------------
    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_data_parallel_rank(self):
        return self._coord["data"]

    def get_data_parallel_group(self):
        return self._groups["dp"]

    def get_data_parallel_group_src_rank(self):
        return self._src("dp")

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_model_parallel_rank(self):
        return self._coord["model"]

    def get_model_parallel_group(self):
        return self._groups["mp"]

    def get_model_parallel_group_src_rank(self):
        return self._src("mp")

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_stage_id(self):
        return self._coord["pipe"]

    def get_pipe_parallel_group(self):
        return self._groups["pp"]

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sharding_parallel_rank(self):
        return self._coord["sharding"]

    def get_sharding_parallel_group(self):
        return self._groups["sharding"]

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    def get_sep_parallel_rank(self):
        return self._coord["sep"]

    def get_sep_parallel_group(self):
        return self._groups["sep"]

    def get_check_parallel_group(self, sharding=False):
        return self._groups["mp"]

    def get_rank_from_stage(self, stage_id, **kwargs):
        """The rank at pipeline stage ``stage_id`` with this rank's other
        coordinates (``kwargs`` override them)."""
        coord = dict(self._coord, pipe=stage_id)
        coord.update(kwargs)
        return self._topo.get_rank(**coord)


_hcg: Optional[HybridCommunicateGroup] = None


def _set_hcg(hcg: HybridCommunicateGroup):
    global _hcg
    _hcg = hcg


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _hcg
