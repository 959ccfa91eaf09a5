"""Parallel layers of the port (counterpart of ``paddlepaddle_tpu/parallel``):
the MoE layer with its data- and expert-parallel forms and
``moe_sharding_rules`` (:mod:`.moe`), the Megatron tensor-parallel layers
(:mod:`.mpu`), the sharded training step (:mod:`.sharded`, SPMD under
the launcher or single-process), the pipeline API (:mod:`.pipeline`), its
schedules (:mod:`.schedules`) and executor (:mod:`.pipeline_spmd`), and
the hybrid stages with their context-parallel branch (:mod:`.hybrid`),
and the Megatron sequence-parallel layers (:mod:`.mpu`)."""

from .mpu import (  # noqa: F401
    ColumnParallelLinear,
    ColumnSequenceParallelLinear,
    ParallelCrossEntropy,
    RowParallelLinear,
    RowSequenceParallelLinear,
    VocabParallelEmbedding,
    mark_placement,
)
from .pipeline_spmd import (  # noqa: F401
    spmd_pipeline,
    spmd_pipeline_interleaved,
    spmd_pipeline_train,
    stack_stage_params,
    stack_virtual_stage_params,
)
from .schedules import (  # noqa: F401
    PipelineSchedule,
    build_1f1b,
    build_gpipe,
    build_schedule,
)
from .sharded import (  # noqa: F401
    ShardedTrainStep,
    match_sharding_rules,
    param_shardings,
)
