"""Resilience of the port: deterministic fault injection at the runtime's
seams (:mod:`~.chaos`), on the replica wire (:mod:`~.netchaos`), retry
with backoff (:mod:`~.retry`), the preemption handler (:mod:`~.preemption`:
emergency callbacks, then the checkpoint writers drained) and checkpoint
integrity (:mod:`~.integrity`: CRC validation, newest-valid fallback and
``CheckpointManager``'s keep-last-K), the names the reference exposes here
(``paddlepaddle_tpu/resilience/__init__.py:30-56``).
"""

from . import chaos, integrity, netchaos, preemption, retry  # noqa: F401
from .chaos import ChaosError, chaos_point  # noqa: F401
from .integrity import (  # noqa: F401
    CheckpointCorruptionError,
    CheckpointManager,
    find_latest_valid_checkpoint,
    validate_checkpoint,
)
from .netchaos import NetChaosProxy, parse_netchaos  # noqa: F401
from .preemption import (  # noqa: F401
    RESTART_EXIT_CODE,
    PreemptionHandler,
    install_preemption_handler,
    preemption_requested,
    uninstall_preemption_handler,
)
# the ``retry`` decorator stays at ``resilience.retry.retry``: re-exporting
# it here would shadow the submodule
from .retry import RetryPolicy, call_with_retry  # noqa: F401

__all__ = [
    "chaos", "retry", "preemption", "integrity", "netchaos",
    "ChaosError", "chaos_point",
    "NetChaosProxy", "parse_netchaos",
    "RetryPolicy", "call_with_retry",
    "PreemptionHandler", "install_preemption_handler",
    "preemption_requested", "uninstall_preemption_handler",
    "RESTART_EXIT_CODE",
    "CheckpointCorruptionError", "CheckpointManager",
    "find_latest_valid_checkpoint", "validate_checkpoint",
]
