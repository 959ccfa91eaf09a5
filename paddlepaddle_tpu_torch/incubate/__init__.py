"""incubate subset of the port: the varlen attention entry
(:mod:`.nn.functional`)."""

from . import nn  # noqa: F401
