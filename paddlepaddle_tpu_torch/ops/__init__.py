"""Ops of the port; hand-written kernels live in :mod:`.kernels`."""
