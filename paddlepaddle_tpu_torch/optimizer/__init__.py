"""Optimizer subset of the port: the base class, ``Adam`` and ``AdamW``, and
the LR schedulers the Llama training recipe uses."""

from . import lr  # noqa: F401
from .optimizer import Optimizer  # noqa: F401
from .optimizers import Adam, AdamW  # noqa: F401
