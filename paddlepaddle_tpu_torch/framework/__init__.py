"""Framework-level utilities (counterpart of
``paddlepaddle_tpu/framework/__init__.py``): ``save`` / ``load`` and
``seed``."""

from ..core.random import seed  # noqa: F401
from .io_api import load, save  # noqa: F401
