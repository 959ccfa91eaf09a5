"""Parallel layers of the port (counterpart of ``paddlepaddle_tpu/parallel``):
the MoE layer with its data- and expert-parallel forms and
``moe_sharding_rules`` (:mod:`.moe`), the Megatron tensor-parallel layers
(:mod:`.mpu`) and the sharded training step (:mod:`.sharded`, SPMD under
the launcher or single-process). The sequence-parallel layers and
pipelines are later A10 slices."""

from .mpu import (  # noqa: F401
    ColumnParallelLinear,
    ParallelCrossEntropy,
    RowParallelLinear,
    VocabParallelEmbedding,
    mark_placement,
)
from .sharded import (  # noqa: F401
    ShardedTrainStep,
    match_sharding_rules,
    param_shardings,
)
