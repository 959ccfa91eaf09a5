"""Distributed execution of the port (counterpart of
``paddlepaddle_tpu/distributed``), SPMD over ``torch.distributed``: one
process per rank, each on one device, explicit collectives.

What is ported (A10): the process environment and launcher
(:mod:`.env`, :mod:`.launch`, ``spawn``), the TCP store (:mod:`.store`),
``ProcessMesh`` and placements, the collectives (eager, functional over
mesh axes, and Megatron's f/g pair; :mod:`.collective`,
:mod:`.communication`), host-side collectives over the store,
``DataParallel``, and the sharding plan (:mod:`.shard_plan`) that the
decode engine (tensor-parallel decode) and
:class:`~..parallel.sharded.ShardedTrainStep` (DP x TP x FSDP x EP x SP
training) run under. In a process with no group, the engine and the train
step start a plan's other ranks themselves (:mod:`.worker_ranks`;
functions reach them by value, :mod:`.ship`). :mod:`.sharding`
(``group_sharded_parallel``, the ZeRO levels), :mod:`.sharding_api` (dist
tensors over DTensor) and :mod:`.auto_parallel` (``parallelize``,
``DistModel``) sit on top. :mod:`.checkpoint` is the sharded checkpoint
(format v3, reshard-on-load); :mod:`.comm_task` and :class:`Watchdog`
attribute hangs; :mod:`.rpc` is control-plane RPC; :mod:`.fleet` is the
hybrid-parallel API (topology, ``distributed_optimizer``, LocalSGD, the
RNG tracker, recompute) and :mod:`.fleet.elastic` the elastic membership
that ``launch --nnodes lo:hi`` runs. :mod:`.compat` is the reference-parity
tail (object and single-tensor collectives, ``ParallelEnv``, the gloo
shims, ``spawn``) and :mod:`.auto_tuner` the parallel-config search
(``AutoTuner``). ``distributed.io`` waits for ROADMAP A11's static
``Program``.
"""

from .collective import (  # noqa: F401
    ReduceOp,
    all_gather,
    all_gather_object,
    all_reduce,
    all_to_all,
    barrier,
    broadcast,
    get_group,
    irecv,
    isend,
    new_group,
    recv,
    reduce,
    reduce_scatter,
    scatter,
    send,
)
from .env import (  # noqa: F401
    get_rank,
    get_world_size,
    init_parallel_env,
    is_initialized,
    parallel_device_count,
)
from . import checkpoint  # noqa: F401
from . import communication  # noqa: F401
from .communication import P2POp, batch_isend_irecv  # noqa: F401
from .checkpoint import load_state_dict, save_state_dict  # noqa: F401
from .compat import (  # noqa: F401
    CountFilterEntry,
    DistAttr,
    ReduceType,
    Strategy,
    dtensor_from_fn,
    shard_scaler,
    unshard_dtensor,
    InMemoryDataset,
    ParallelEnv,
    ParallelMode,
    ProbabilityEntry,
    QueueDataset,
    ShowClickEntry,
    alltoall,
    alltoall_single,
    broadcast_object_list,
    destroy_process_group,
    gather,
    get_backend,
    gloo_barrier,
    gloo_init_parallel_env,
    gloo_release,
    is_available,
    scatter_object_list,
    split,
    wait,
)
from . import launch  # noqa: F401
from . import rpc  # noqa: F401
from .auto_tuner import AutoTuner, TuneConfig  # noqa: F401
from .watchdog import Watchdog  # noqa: F401
from .launch import spawn  # noqa: F401
from .mesh import ProcessMesh, auto_mesh, get_mesh, set_mesh  # noqa: F401
from .shard_plan import (  # noqa: F401
    ShardingPlan,
    decode_plan,
    dp_tp_train_rules,
    mesh_from_spec,
    moe_train_rules,
    parse_mesh_spec,
    tp_decode_rules,
    train_plan,
)
from .parallel import DataParallel  # noqa: F401
from .placement import Partial, Placement, Replicate, Shard  # noqa: F401
from . import fleet  # noqa: F401
from .fleet.recompute import recompute, recompute_sequential  # noqa: F401
from . import sharding  # noqa: F401
from . import auto_parallel  # noqa: F401
from .auto_parallel import (  # noqa: F401
    ColWiseParallel,
    DistModel,
    RowWiseParallel,
    parallelize,
    shard_dataloader,
    to_static,
)
from .sharding_api import (  # noqa: F401
    ShardingStage1,
    ShardingStage2,
    ShardingStage3,
    dist_attr,
    reshard,
    shard_layer,
    shard_optimizer,
    shard_tensor,
)
