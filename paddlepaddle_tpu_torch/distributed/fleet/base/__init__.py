"""fleet.base namespace (counterpart of
``paddlepaddle_tpu/distributed/fleet/base/__init__.py``): role_maker and
the strategy re-export."""

from . import role_maker  # noqa: F401
from .. import DistributedStrategy  # noqa: F401
