"""fleet.meta_parallel namespace (counterpart of
``paddlepaddle_tpu/distributed/fleet/meta_parallel/__init__.py``): the
layer classes reference training scripts import from this path. They live
in ``parallel/`` (the mpu tensor-parallel layers, the pipeline's
``LayerDesc`` / ``PipelineLayer``) and ``fleet/random`` (the RNG
tracker)."""

from ....parallel.mpu import (  # noqa: F401
    ColumnParallelLinear,
    ParallelCrossEntropy,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from ....parallel.pipeline import (  # noqa: F401
    LayerDesc,
    PipelineLayer,
    SharedLayerDesc,
)
from ..random import get_rng_state_tracker, model_parallel_random_seed  # noqa: F401
