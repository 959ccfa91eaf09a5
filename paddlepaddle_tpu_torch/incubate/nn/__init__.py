"""incubate.nn subset of the port."""

from . import functional  # noqa: F401
