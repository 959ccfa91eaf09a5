"""nn subset of the port: the layers the Llama serving path builds on."""

from . import functional  # noqa: F401
from .common import Embedding, Linear  # noqa: F401
from .norm import RMSNorm  # noqa: F401
