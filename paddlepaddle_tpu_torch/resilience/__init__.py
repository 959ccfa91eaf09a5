"""Resilience of the port: deterministic fault injection at the serving
seams (:mod:`~.chaos`), on the replica wire (:mod:`~.netchaos`), retry
with backoff (:mod:`~.retry`), and the preemption handler serving drains
through (:mod:`~.preemption`).

The names the reference exposes here (``paddlepaddle_tpu/resilience/
__init__.py:30-56``) but :mod:`integrity`, the checkpoint manager, which
waits for the distributed checkpoint it validates (ROADMAP A10).
"""

from . import chaos, netchaos, preemption, retry  # noqa: F401
from .chaos import ChaosError, chaos_point  # noqa: F401
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
    "chaos", "retry", "preemption", "netchaos",
    "ChaosError", "chaos_point",
    "NetChaosProxy", "parse_netchaos",
    "RetryPolicy", "call_with_retry",
    "PreemptionHandler", "install_preemption_handler",
    "preemption_requested", "uninstall_preemption_handler",
    "RESTART_EXIT_CODE",
]
