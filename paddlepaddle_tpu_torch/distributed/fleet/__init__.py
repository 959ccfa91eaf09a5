"""fleet — the manual hybrid-parallel API (counterpart of
``paddlepaddle_tpu/distributed/fleet/__init__.py``; reference:
python/paddle/distributed/fleet/fleet.py:151,218 init / distributed_model /
distributed_optimizer).

``fleet.init`` builds the hybrid topology (dp x pp x sharding x sep x mp),
its :class:`HybridCommunicateGroup` and :class:`~..mesh.ProcessMesh`, and
sets that mesh (``set_mesh``), so the mpu layers take their model-parallel
group from it. One process is one rank here: under a process group the
worker accessors answer this rank, and the wrappers do what GSPMD does in
the reference: ``distributed_model`` averages gradients over the
data-parallel group (``DataParallel``) when ``dp > 1``, and
``distributed_optimizer`` makes a global-norm clip global over the ranks'
shards (``HybridParallelOptimizer``). With no group every answer is the
reference's one controller's. Activation recompute is :mod:`.recompute`.

``strategy.dgc`` needs ``DGCMomentumOptimizer`` (ROADMAP item 4, not
ported) and raises.
"""

from __future__ import annotations

from typing import Optional

from ...core.errors import not_ported
from ..mesh import ProcessMesh, set_mesh  # noqa: F401
from .random import get_rng_state_tracker, model_parallel_random_seed  # noqa: F401
from .recompute import recompute, recompute_sequential  # noqa: F401
from .topology import (  # noqa: F401
    CommunicateTopology,
    HybridCommunicateGroup,
    ParallelMode,
    _set_hcg,
    get_hybrid_communicate_group,
)
from .localsgd import LocalSGD  # noqa: F401
from . import meta_optimizers, meta_parallel, utils  # noqa: F401

_DEGREES = ("dp_degree", "pp_degree", "sharding_degree", "sep_degree",
            "mp_degree")


class DistributedStrategy:
    """Reference: fleet/base/distributed_strategy.py:284 (protobuf-backed
    there; a plain attribute bag here, the same knob names)."""

    def __init__(self):
        self.hybrid_configs = {
            "dp_degree": 1,
            "mp_degree": 1,
            "pp_degree": 1,
            "sharding_degree": 1,
            "sep_degree": 1,
        }
        self.amp = False
        self.amp_configs = {}
        self.recompute = False
        self.recompute_configs = {}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1}
        self.gradient_merge = False
        self.gradient_merge_configs = {}
        self.sharding = False
        self.sharding_configs = {}
        self.tensor_parallel = False
        self.tensor_parallel_configs = {}
        self.find_unused_parameters = False
        self.localsgd = False                 # wrap with fleet.LocalSGD
        self.localsgd_configs = {"k_steps": 1, "begin_step": 1}
        self.dgc = False                      # wrap Momentum with DGC
        self.dgc_configs = {"rampup_begin_step": 0, "rampup_step": 1,
                            "sparsity": [0.999]}

    def __repr__(self):
        return f"DistributedStrategy(hybrid_configs={self.hybrid_configs})"


def _rank_and_world():
    from ..env import get_rank, get_world_size

    return get_rank(), get_world_size()


class _Fleet:
    def __init__(self):
        self._strategy: Optional[DistributedStrategy] = None
        self._hcg: Optional[HybridCommunicateGroup] = None
        self._initialized = False

    def init(self, role_maker=None, is_collective=False, strategy=None,
             log_level="INFO"):
        """Build the topology from ``strategy.hybrid_configs`` and set its
        mesh. Under a process group whose degrees are all 1 the data axis
        takes the whole job, as Paddle's collective default does."""
        import torch.distributed as dist

        strategy = strategy or DistributedStrategy()
        self._strategy = strategy
        hc = strategy.hybrid_configs
        dims = [max(1, int(hc.get(k, 1))) for k in _DEGREES]
        if dist.is_initialized() and dims == [1] * 5:
            dims[0] = dist.get_world_size()
        topo = CommunicateTopology(
            hybrid_group_names=("data", "pipe", "sharding", "sep", "model"),
            dims=dims)
        self._hcg = HybridCommunicateGroup(topo)
        _set_hcg(self._hcg)
        set_mesh(self._hcg.mesh)
        self._initialized = True
        return self

    def get_hybrid_communicate_group(self):
        return self._hcg

    @property
    def worker_num(self):
        return self._hcg.topology().world_size() if self._hcg else 1

    def worker_index(self):
        """This rank (0 in a process with no group, as the reference)."""
        return _rank_and_world()[0]

    def is_first_worker(self):
        return self.worker_index() == 0

    def barrier_worker(self):
        from ..collective import barrier

        if _rank_and_world()[1] > 1:
            barrier()

    def distributed_model(self, model):
        """The model as it is, or, with ``dp > 1`` under a process group,
        wrapped to average its gradients over the data-parallel group (what
        the reference's GSPMD does for its batch-sharded step)."""
        hcg = self._hcg
        if hcg is None or not hcg.live or \
                hcg.get_data_parallel_world_size() == 1:
            return model
        from ..parallel import DataParallel

        return DataParallel(model, group=hcg.get_data_parallel_group())

    def distributed_optimizer(self, optimizer, strategy=None):
        """``strategy.localsgd`` wraps with :class:`LocalSGD`;
        ``strategy.dgc`` raises (item 4). Otherwise the optimizer itself in
        a process with no group, or a :class:`~.meta_optimizers.
        dygraph_optimizer.HybridParallelOptimizer` whose global-norm clip
        sums over the hybrid group's shards."""
        strategy = strategy or self._strategy
        if strategy is not None and getattr(strategy, "localsgd", False):
            cfg = getattr(strategy, "localsgd_configs", {}) or {}
            return LocalSGD(optimizer, k_steps=int(cfg.get("k_steps", 1)),
                            begin_step=int(cfg.get("begin_step", 1)))
        if strategy is not None and getattr(strategy, "dgc", False):
            raise not_ported("fleet.distributed_optimizer with strategy.dgc "
                             "(DGCMomentumOptimizer)", "item 4")
        if self._hcg is None or not self._hcg.live:
            return optimizer
        from .meta_optimizers.dygraph_optimizer import \
            HybridParallelOptimizer

        return HybridParallelOptimizer(optimizer, self._hcg, strategy)

    init_server = None
    run_server = None


fleet = _Fleet()

# module-level API mirroring `from paddle.distributed import fleet`
init = fleet.init
distributed_model = fleet.distributed_model
distributed_optimizer = fleet.distributed_optimizer
worker_index = fleet.worker_index
is_first_worker = fleet.is_first_worker
barrier_worker = fleet.barrier_worker

# reference fleet/__init__.py re-exports: role makers, util, generators
Fleet = _Fleet
from .base.role_maker import (  # noqa: E402,F401
    PaddleCloudRoleMaker,
    Role,
    UserDefinedRoleMaker,
)
from .data_generator import (  # noqa: E402,F401
    MultiSlotDataGenerator,
    MultiSlotStringDataGenerator,
)


class UtilBase:
    """fleet.UtilBase (reference fleet/base/util_factory.py:64): rank
    utilities over the job's default group."""

    def all_reduce(self, input, mode="sum", comm_world="worker"):
        import numpy as np
        import torch

        from ..collective import ReduceOp, all_reduce

        if mode not in ("sum", "min", "max"):
            raise ValueError(f"unknown all_reduce mode {mode}")
        if _rank_and_world()[1] <= 1:
            return np.asarray(input)
        t = torch.as_tensor(np.array(input))
        all_reduce(t, op={"sum": ReduceOp.SUM, "min": ReduceOp.MIN,
                          "max": ReduceOp.MAX}[mode])
        return t.numpy()

    def barrier(self, comm_world="worker"):
        from ..collective import barrier

        if _rank_and_world()[1] > 1:
            barrier()

    def all_gather(self, input, comm_world="worker"):
        from ..collective import all_gather_object

        if _rank_and_world()[1] <= 1:
            return [input]
        out = []
        all_gather_object(out, input)
        return out

    def get_file_shard(self, files):
        """Contiguous per-rank file split (reference get_file_shard:
        earlier ranks take the remainder)."""
        if not isinstance(files, list):
            raise TypeError("files should be a list of file need to be read.")
        trainer_id, trainers = _rank_and_world()
        trainers = max(trainers, 1)
        blocks = len(files) // trainers
        remainder = len(files) % trainers
        begin = 0
        for i in range(trainer_id):
            begin += blocks + (1 if i < remainder else 0)
        length = blocks + (1 if trainer_id < remainder else 0)
        return files[begin:begin + length]

    def print_on_rank(self, message, rank_id):
        if _rank_and_world()[0] == rank_id:
            print(message)


util = UtilBase()
_Fleet.util = util
