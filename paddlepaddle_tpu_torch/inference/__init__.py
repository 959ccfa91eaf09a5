"""Serving path of the port: paged KV bookkeeping, the continuous-batching
decode engine, the serving engine around it, and the fleet above it (the
router, remote replica processes, the C API listener and the fleet
controller).

The names the reference exposes here (``paddlepaddle_tpu/inference/
__init__.py:156-183``). ``Config``, ``create_predictor`` and
``PredictorPool`` wait for ``jit/save_load.py`` (ROADMAP A11).
"""

from .compile_plan import (  # noqa: F401
    BundleMismatchError,
    CompilePlan,
    prompt_buckets,
)
from .fleet import FleetController, FleetPolicy  # noqa: F401
from .robustness import (  # noqa: F401
    CircuitBreaker,
    CircuitOpenError,
    DeadlineExceededError,
    DeployError,
    EngineDrainingError,
    FleetUnavailableError,
    KVCapacityError,
    RequestCancelledError,
    RequestValidationError,
    ServerOverloadedError,
    ServingError,
)
from .remote_replica import (  # noqa: F401
    ProcessReplicaFactory,
    RemoteReplicaClient,
    ReplicaSupervisor,
)
from .router import ReplicaClient, ServingRouter  # noqa: F401
from .serving import GenerationResult, ServingEngine  # noqa: F401
from .speculative import SpeculativeDecoder  # noqa: F401
